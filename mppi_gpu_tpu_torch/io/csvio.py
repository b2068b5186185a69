"""CSV writers matching the reference's outputs.

Three writers in the reference (src/main.cu:32-156):
  * `to_csv_traj` — closed-loop trajectory: time, state, action per control step;
  * `to_csv2`     — per-step debug dump: per-rollout trajectories, noise,
                    weights, costs, plus the nominal sequences (consumed by the
                    NumPy oracle in scripts/plot_csv.py:77-109);
  * `to_csv`      — legacy sampled-trajectory dump (superseded by to_csv2).

Here: `write_traj_csv` ≙ to_csv_traj, `write_step_dump_csv` ≙ to_csv2 (same
information, tidy long format with named columns).
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np


def write_traj_csv(
    path: str | os.PathLike,
    times: Sequence[float],
    xs: np.ndarray,          # (N, s)
    us: np.ndarray,          # (N, a)
) -> None:
    xs = np.asarray(xs)
    us = np.asarray(us)
    s, a = xs.shape[1], us.shape[1]
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(
            ["time"]
            + [f"x[{i}]" for i in range(s)]
            + [f"u[{i}]" for i in range(a)]
        )
        for t, x, u in zip(times, xs, us):
            wr.writerow([f"{t:.6f}"] + [f"{v:.8g}" for v in x] + [f"{v:.8g}" for v in u])


def write_step_dump_csv(
    path: str | os.PathLike,
    xs: np.ndarray,       # (T+1, K, s) sampled rollout states
    eps: np.ndarray,      # (T, K, a) sampled noise
    u: np.ndarray,        # (T, a) updated nominal sequence
    u_prev: np.ndarray,   # (T, a) nominal sequence before the update
    weights: np.ndarray,  # (K,)
    costs: np.ndarray,    # (K,)
) -> None:
    """Per-solve debug dump (one row per (sample, step)) with everything the
    NumPy oracle needs to recompute the MPPI update independently."""
    xs, eps = np.asarray(xs), np.asarray(eps)
    u, u_prev = np.asarray(u), np.asarray(u_prev)
    weights, costs = np.asarray(weights), np.asarray(costs)
    Tp1, K, s = xs.shape
    a = eps.shape[2]
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(
            ["sample", "step"]
            + [f"x[{i}]" for i in range(s)]
            + [f"e[{i}]" for i in range(a)]
            + [f"u[{i}]" for i in range(a)]
            + [f"u_prev[{i}]" for i in range(a)]
            + ["w", "c"]
        )
        for k in range(K):
            for t in range(Tp1):
                row = [k, t] + [f"{v:.8g}" for v in xs[t, k]]
                row += [f"{v:.8g}" for v in (eps[t, k] if t < Tp1 - 1 else np.zeros(a))]
                row += [f"{v:.8g}" for v in (u[t] if t < Tp1 - 1 else np.zeros(a))]
                row += [f"{v:.8g}" for v in (u_prev[t] if t < Tp1 - 1 else np.zeros(a))]
                row += [f"{weights[k]:.8g}", f"{costs[k]:.8g}"]
                wr.writerow(row)


def read_csv_columns(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Load a CSV written by the functions above back into named arrays."""
    with open(path, newline="") as f:
        rd = csv.DictReader(f)
        rows = list(rd)
    if not rows:
        return {}
    return {
        k: np.array([float(r[k]) for r in rows], np.float64) for k in rows[0].keys()
    }
