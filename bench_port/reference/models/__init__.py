"""The rollout models and their costs, from the configuration file alone:
one module per ``family`` (``bench_port/reference/models/<family>.py``,
its class ``Model``), found by the family's name, so a configuration of a
new family is added by adding its module.

A model has ``A``, ``lam``, ``step(x, u)`` (one step of dt under the
effective action u) and ``state_cost(x)`` (the per-step state cost, counted
once more at the end). Σ⁻¹ is the identity (the configurations'
``inv-sigma`` default). States carry any leading axes; the goal broadcasts
over them.
"""

from __future__ import annotations

import importlib

import torch


def family(name: str):
    """The module of family `name`."""
    return importlib.import_module(f"bench_port.reference.models.{name}")


def model(cfg: dict, device, dtype=torch.float32):
    """The rollout model of the configuration file's ``family``."""
    for key, want in (("antithetic", False), ("noise-beta", 0.0), ("inv-sigma", "identity"),
                      ("clamp-action", True)):
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference covers {key} = {want!r} only, got {cfg[key]!r}")
    return family(cfg["family"]).Model(cfg, device, dtype)
