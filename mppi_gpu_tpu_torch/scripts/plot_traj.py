#!/usr/bin/env python
"""Plot a closed-loop trajectory CSV — the analog of the reference's
scripts/plot_traj.py (columns written by mppi_gpu_tpu_torch.io.csvio.write_traj_csv
≙ reference to_csv_traj, src/main.cu:32-57).

    python mppi_gpu_tpu_torch/scripts/plot_traj.py traj.csv [-c configs/point_mass2d.yaml] [-o out.png]

Positions + velocities per axis over time, actions below; dashed lines mark
the config goal when a config is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from mppi_gpu_tpu_torch.io.csvio import read_csv_columns


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("csv", help="trajectory CSV (time, x[i], u[i])")
    p.add_argument("-c", "--config", default=None, help="YAML config (goal lines)")
    p.add_argument("-o", "--out", default=None, help="output PNG (default: <csv>.png)")
    args = p.parse_args(argv)

    cols = read_csv_columns(args.csv)
    t = cols["time"]
    s = sum(1 for k in cols if k.startswith("x["))
    a = sum(1 for k in cols if k.startswith("u["))
    xs = np.stack([cols[f"x[{i}]"] for i in range(s)], axis=1)
    us = np.stack([cols[f"u[{i}]"] for i in range(a)], axis=1)

    goal = None
    if args.config:
        from mppi_gpu_tpu_torch.config import load_config

        goal = np.asarray(load_config(args.config).goal)

    fig, (ax_q, ax_qd, ax_u) = plt.subplots(3, 1, figsize=(9, 9), sharex=True)
    for i in range(a):
        ax_q.plot(t, xs[:, i], label=f"q{i}")
        if goal is not None:
            ax_q.axhline(goal[i], ls="--", lw=0.8, color=f"C{i}", alpha=0.6)
        ax_qd.plot(t, xs[:, a + i], label=f"qd{i}")
        if goal is not None:
            ax_qd.axhline(goal[a + i], ls="--", lw=0.8, color=f"C{i}", alpha=0.6)
        ax_u.plot(t, us[:, i], label=f"u{i}")
    ax_q.set_ylabel("position")
    ax_qd.set_ylabel("velocity")
    ax_u.set_ylabel("action")
    ax_u.set_xlabel("time [s]")
    for ax in (ax_q, ax_qd, ax_u):
        ax.legend(loc="best", fontsize=8)
        ax.grid(alpha=0.3)
    fig.suptitle(os.path.basename(args.csv))
    out = args.out or args.csv + ".png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
