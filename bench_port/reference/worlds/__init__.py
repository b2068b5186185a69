"""The ground-truth worlds the controllers are closed against, one control
cycle each, from the configuration file's ``world`` block: one module per
``kind`` (``bench_port/reference/worlds/<kind>.py``), found by the kind's
name, so a world is added by adding its module. A module has ``cycle(w, x,
u)`` (on the device, torch) and, where the kind has a host plant,
``host_cycle(w, x, u)`` (one state, NumPy, in the plant's arithmetic).

A state whose clock has reached ``sim-end`` is held.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def steps_per_cycle(w: dict) -> int:
    return math.ceil(w["control-period"] / w["timestep"] - 1e-9)


def kind(w: dict):
    """The module of world block `w`'s ``kind``."""
    return importlib.import_module(f"bench_port.reference.worlds.{w['kind']}")


def cycle(w: dict, x: torch.Tensor, u: torch.Tensor, clock: torch.Tensor | None = None):
    """One control cycle of world block `w`; states whose clock (the time
    before the cycle, float32) has reached ``sim-end`` are held."""
    new = kind(w).cycle(w, x, u)
    if clock is None:
        return new
    held = (clock >= np.float32(w["sim-end"]))[..., None]
    return torch.where(held, x, new)


def host_cycle(w: dict, x: np.ndarray, u: np.ndarray) -> np.ndarray:
    """One control cycle of the host plant of world block `w`."""
    return kind(w).host_cycle(w, x, u)
