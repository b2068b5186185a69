#!/usr/bin/env python
"""Plot the model-vs-world mismatch CSV — the analog of the reference's
scripts/plot_miss.py over missmatch.csv (model_missmatch.cpp:102-121).
Columns: <q|qd><axis>_s (analytic model) and _w (ground-truth world).

    python mppi_gpu_tpu_torch/scripts/plot_miss.py missmatch.csv [-o out.png]
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
    p.add_argument("csv", help="missmatch CSV from python -m mppi_gpu_tpu_torch.miss")
    p.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)

    cols = read_csv_columns(args.csv)
    if "q0_s" in cols:
        pos_keys = sorted(
            (k[:-2] for k in cols if k.startswith("q") and not k.startswith("qd") and k.endswith("_s")),
            key=lambda k: int(k[1:]),
        )
        vel_keys = [f"qd{k[1:]}" for k in pos_keys]
    else:
        # generic x{i} layout (odd state dims — the quaternion quadrotor):
        # x0..x2 position, x7..x9 the paired linear velocities
        xs = sorted(
            (k[:-2] for k in cols if k.startswith("x") and k.endswith("_s")),
            key=lambda k: int(k[1:]),
        )
        pos_keys, vel_keys = xs[:3], xs[7:10]

    fig, (ax_q, ax_qd, ax_e) = plt.subplots(3, 1, figsize=(9, 9), sharex=True)
    for i, (pk, vk) in enumerate(zip(pos_keys, vel_keys)):
        ax_q.plot(cols[f"{pk}_s"], ls="--", color=f"C{i}", label=f"{pk} model")
        ax_q.plot(cols[f"{pk}_w"], color=f"C{i}", label=f"{pk} world")
        ax_qd.plot(cols[f"{vk}_s"], ls="--", color=f"C{i}", label=f"{vk} model")
        ax_qd.plot(cols[f"{vk}_w"], color=f"C{i}", label=f"{vk} world")
        ax_e.plot(
            np.abs(cols[f"{pk}_s"] - cols[f"{pk}_w"]), color=f"C{i}", label=f"|Δ{pk}|"
        )
    ax_q.set_ylabel("position")
    ax_qd.set_ylabel("velocity")
    ax_e.set_ylabel("|model − world|")
    ax_e.set_xlabel("open-loop step")
    for ax in (ax_q, ax_qd, ax_e):
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    fig.suptitle("model-plant mismatch (open loop, same inputs)")
    out = args.out or args.csv + ".png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
