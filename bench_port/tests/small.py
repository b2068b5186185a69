"""A cell of the benchmark at a size a CPU test holds: the same files, the
rollouts, horizon, episode and fleet cut down."""

from __future__ import annotations

import dataclasses
import time

import torch

from bench_port import run


def cell(name: str, samples: int = 64, horizon: int = 12, cycles: int = 8,
         robots: int | None = None) -> run.Cell:
    c = run.load_cell(name)
    traffic = {**c.traffic, "samples": samples, "cycles": cycles}
    if robots is not None:
        traffic["robots"] = robots
    return dataclasses.replace(c, config={**c.config, "horizon": horizon}, traffic=traffic)


def execute(c: run.Cell, seed: int = 7, seconds: float = 0.0, traced: bool = False) -> dict:
    """One run of `c` on the CPU, past the look for a GPU."""
    torch.set_num_threads(1)
    return run.execute(c, seed, seconds, traced, torch.device("cpu"), time.perf_counter())
