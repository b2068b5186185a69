"""How far the sharded device episode's quality strays from the solo one's
on the CPU: the steady-state goal distance (the mean over the episode's
last quarter, bench.quality_row's metric) of ``run_episode_jit`` on the
solo controller and on ``ShardedMPPIController`` over 1 and 4 virtual ranks
in both branches, point_mass3d at the flagship's K=10⁴, T=200 by default.
The ranks draw the solo stream between them, so the loops differ only in
the order of η's and ΔU's sums, which the loop amplifies.

    python tests/_sharded_quality_probe.py [--K 10000] [--T 200] [--seeds 1] [--workers 4]

One process per (variant, seed), ~8 minutes each at the defaults on one
CPU thread. Prints one line per run and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("solo", "1 one-pass", "1 two-kernel", "4 one-pass", "4 two-kernel")


def run(args: tuple) -> tuple:
    variant, seed, K, T = args
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from mppi_gpu_tpu_torch.config import load_config
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    cfg = load_config(os.path.join(ROOT, "configs", "point_mass3d.yaml")).replace(
        samples=K, horizon=T, seed=seed)
    if variant == "solo":
        ctrl = MPPIController(cfg, device="cpu")
    else:
        n, branch = variant.split()
        ctrl = ShardedMPPIController(cfg, mesh=virtual_mesh(int(n), "cpu"),
                                     onepass=branch == "one-pass")
    xs = run_episode_jit(ctrl).xs.astype(np.float64)
    d = np.linalg.norm(xs[:, :3] - np.asarray(cfg.goal[:3]), axis=1)
    return variant, seed, float(d[-max(len(d) // 4, 1):].mean())


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--K", type=int, default=10_000)
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--seeds", type=int, default=1, help="seeds from the config's (0)")
    p.add_argument("--workers", type=int, default=4)
    a = p.parse_args()
    jobs = [(v, s, a.K, a.T) for s in range(a.seeds) for v in VARIANTS]
    out: dict = {}
    with mp.get_context("spawn").Pool(a.workers) as pool:
        for variant, seed, steady in pool.imap_unordered(run, jobs):
            print(f"{variant} seed {seed}: steady {steady:.4f} m", flush=True)
            out.setdefault(variant, {})[seed] = steady
    print(json.dumps(out))


if __name__ == "__main__":
    main()
