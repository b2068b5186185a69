#!/usr/bin/env python
"""Verify + visualize a per-solve debug dump — the analog of the reference's
scripts/plot_csv.py, whose NumPy oracle (plot_csv.py:77-109) re-derives cost,
β, exp, η, weights and the next action sequence from the dumped data. The
reference left the GPU-vs-oracle diff commented out (plot_csv.py:116-131);
here the check is live and the script FAILS (exit 1) on disagreement.

    python mppi_gpu_tpu_torch/scripts/plot_csv.py step_00000.csv -c configs/point_mass2d.yaml [-o out.png]

Input: a CSV written by mppi_gpu_tpu_torch.io.csvio.write_step_dump_csv
(≙ reference to_csv2, src/main.cu:90-156): one row per (sample, step) with
x, ε, updated u, pre-update u_prev, per-sample weight w and cost c.
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

from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.io.csvio import read_csv_columns
from tests.oracle import oracle_rollout_costs, oracle_softmin_update


def load_dump(path: str):
    cols = read_csv_columns(path)
    s = sum(1 for k in cols if k.startswith("x["))
    a = sum(1 for k in cols if k.startswith("e["))
    samples = cols["sample"].astype(int)
    steps = cols["step"].astype(int)
    K, Tp1 = samples.max() + 1, steps.max() + 1
    T = Tp1 - 1

    def grid(prefix, n):
        out = np.zeros((Tp1, K, n))
        for i in range(n):
            out[steps, samples, i] = cols[f"{prefix}[{i}]"]
        return out

    xs = grid("x", s)                      # (T+1, K, s)
    eps = grid("e", a)[:T]                 # (T, K, a)
    u = grid("u", a)[:T, 0]                # (T, a) — identical across samples
    u_prev = grid("u_prev", a)[:T, 0]
    w = np.zeros(K)
    c = np.zeros(K)
    w[samples] = cols["w"]
    c[samples] = cols["c"]
    return xs, eps, u, u_prev, w, c


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("csv", help="per-step debug dump CSV")
    p.add_argument("-c", "--config", required=True, help="YAML config of the run")
    p.add_argument("-o", "--out", default=None, help="output PNG (default: <csv>.png)")
    p.add_argument("--rtol", type=float, default=1e-4)
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    xs, eps, u, u_prev, w_dump, c_dump = load_dump(args.csv)
    x0 = xs[0, 0]

    # --- oracle re-derivation (reference plot_csv.py:77-109, made a hard check)
    inv_s = np.ones(cfg.action_dim) if cfg.inv_sigma != "from-noise" else 1.0 / np.asarray(cfg.noise) ** 2
    S = oracle_rollout_costs(
        x0, u_prev, eps, cfg.dt, np.asarray(cfg.cost_w), np.asarray(cfg.goal),
        cfg.lambda_, inv_s,
    )
    U_new, _, _, wgt, beta, eta = oracle_softmin_update(
        S, eps, u_prev, cfg.lambda_,
        np.asarray(cfg.max_a) if cfg.clamp_action else None,
    )
    ok = True
    for name, got, want in (
        ("cost", c_dump, S),
        ("weights", w_dump, wgt),
        ("updated U", u, U_new),
    ):
        err = np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
            1.0, float(np.max(np.abs(want)))
        )
        status = "OK" if err < args.rtol else "MISMATCH"
        ok &= err < args.rtol
        print(f"oracle {name:10s}: max rel err {err:.2e}  [{status}]")
    print(f"beta={beta:.6g} eta={eta:.6g} (oracle)")

    # --- plots: sampled rollout fan + weight distribution + nominal update
    K = xs.shape[1]
    sel = np.linspace(0, K - 1, min(K, 64)).astype(int)
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    for k in sel:
        axes[0].plot(xs[:, k, 0], alpha=0.25, lw=0.7, color="C0")
    axes[0].set_title(f"sampled rollouts q0 (showing {len(sel)}/{K})")
    axes[0].set_xlabel("horizon step")
    axes[1].hist(w_dump, bins=50)
    axes[1].set_yscale("log")
    axes[1].set_title("softmin weights")
    for i in range(u.shape[1]):
        axes[2].plot(u_prev[:, i], ls="--", color=f"C{i}", alpha=0.6, label=f"u_prev[{i}]")
        axes[2].plot(u[:, i], color=f"C{i}", label=f"u_new[{i}]")
    axes[2].set_title("nominal sequence update")
    axes[2].legend(fontsize=7)
    for ax in axes:
        ax.grid(alpha=0.3)
    out = args.out or args.csv + ".png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"saved {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
