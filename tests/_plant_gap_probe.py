"""How far a closed loop against a host plant (the native C++ twin or real
MuJoCo) parts from the same loop against the package's own world, in both
packages: ``run_closed_loop`` twice from one controller config and seed,
``world_backend=<plant>`` and the package's own world ("jax" in the JAX
package, "torch" in the port), and the largest |Δx| over the common steps, over all of them and over the
first EARLY cycles; and the spread of the own-world loops, the largest |Δx|
between the loops of two seeds (where two loops that have parted can be at
most).
The two loops draw the same noise; only the plants' f32 rounding (~1e-7 a
cycle) differs, and the feedback loop amplifies it. How fast it grows is a
property of the controller and the config, not of a port, so the port's
bars for these comparisons are set from the JAX package's own gap over
seeds 0-7 where a test file's fixed bound does not hold at a full config.
CPU only; imports both packages.

With `--whole` the loops run whole episodes and each one's steady-state
goal distance is printed too.

Run:  python tests/_plant_gap_probe.py [--cases lti-native,pendulum-native]
      [--seeds 8] [--workers 4] [--packages jax,torch] [--whole] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EARLY = 10  # the first cycles, before the loops' rounding has grown
# name → (config, overrides, plant, control steps)
CASES = {
    # tests/test_closed_loop.py's native case (small_cfg(K=128, T=20))
    "pm1d-small-native": ("point_mass1d", dict(samples=128, horizon=20), "native", 100),
    # tests/test_mujoco_xval.py's point-mass MuJoCo case
    "pm2d-small-mujoco": ("point_mass2d", dict(samples=256, horizon=20), "mujoco", 25),
    # chip_smoke.py phase 25 at the full configs
    "lti-native": ("point_mass2d", {}, "native", 100),
    "lti-mujoco": ("point_mass2d", {}, "mujoco", 100),
    "lti3d-native": ("point_mass3d", {}, "native", 100),
    "pendulum-native": ("pendulum", {}, "native", 100),
    "cartpole-native": ("cartpole", {}, "native", 100),
    "quadrotor-native": ("quadrotor", {}, "native", 100),
    "quadrotor3d-native": ("quadrotor3d", {}, "native", 100),
}


def _steady(xs, goal) -> float:
    """bench.quality_row's score: the mean distance of the positions to the
    goal over the last quarter of the states."""
    import numpy as np

    n = len(goal) // 2
    d = np.linalg.norm(np.asarray(xs)[:, :n] - np.asarray(goal[:n]), axis=1)
    return float(d[-max(len(d) // 4, 1):].mean())


def _gap(job: tuple[str, str, int, bool]) -> dict:
    pkg, case, seed, whole = job
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                       "intra_op_parallelism_threads=1")
    sys.path.insert(0, ROOT)
    import numpy as np

    name, over, plant, steps = CASES[case]
    max_steps = None if whole else steps
    cfg_path = os.path.join(ROOT, "configs", f"{name}.yaml")
    t0 = time.perf_counter()
    if pkg == "jax":
        from mppi_gpu_tpu.config import load_config
        from mppi_gpu_tpu.controller import MPPIController
        from mppi_gpu_tpu.runner import run_closed_loop

        cfg = load_config(cfg_path).replace(seed=seed, **over)
        runs = [run_closed_loop(MPPIController(cfg), world_backend=w, max_steps=max_steps)
                for w in ("jax", plant)]
    else:
        import torch

        torch.set_num_threads(1)
        from mppi_gpu_tpu_torch.config import load_config
        from mppi_gpu_tpu_torch.controller import MPPIController
        from mppi_gpu_tpu_torch.runner import run_closed_loop

        cfg = load_config(cfg_path).replace(seed=seed, **over)
        runs = [run_closed_loop(MPPIController(cfg, device="cpu"), world_backend=w,
                                max_steps=max_steps) for w in ("torch", plant)]
    n = min(steps + 1, *(len(r.xs) for r in runs))
    gap = np.abs(runs[0].xs[:n] - runs[1].xs[:n]).max(axis=1)
    return dict(package=pkg, case=case, seed=seed, max_gap=float(gap.max()),
                early_gap=float(gap[:EARLY + 1].max()), own=runs[0].xs[:steps + 1].tolist(),
                steady=[_steady(r.xs, cfg.goal) for r in runs] if whole else None,
                gap_at={int(k): float(gap[k]) for k in (10, 20, 50, 100) if k < n},
                seconds=round(time.perf_counter() - t0, 1))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--packages", default="jax,torch")
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--whole", action="store_true",
                   help="run whole episodes (the gaps still over the case's steps) and print "
                   "each loop's steady-state goal distance")
    p.add_argument("--out", default=None, help="write every run's row here (JSON)")
    args = p.parse_args(argv)
    import numpy as np

    cases = [c for c in args.cases.split(",") if c]
    pkgs = [k for k in args.packages.split(",") if k]
    jobs = [(k, c, s, args.whole) for c in cases for k in pkgs for s in range(args.seeds)]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        rows = pool.map(_gap, jobs, chunksize=1)
    for c in cases:
        for k in pkgs:
            mine = [r for r in rows if r["case"] == c and r["package"] == k]
            for key, what in (("max_gap", "all steps"), ("early_gap", f"first {EARLY} cycles")):
                gaps = [r[key] for r in mine]
                print(f"{c:20s} {k:5s} max gap over {what}, seeds 0-{args.seeds - 1}: "
                      f"{' '.join(f'{g:.3g}' for g in gaps)}  (max {max(gaps):.3g})")
            if args.whole:
                print(f"{c:20s} {k:5s} steady-state goal distance (own world, plant) by seed: "
                      + "; ".join(f"{r['seed']}: {r['steady'][0]:.4f}, {r['steady'][1]:.4f}"
                                  for r in mine))
            own = [np.asarray(r["own"]) for r in mine]
            spread = max(float(np.abs(a[:n] - b[:n]).max()) for i, a in enumerate(own)
                         for b in own[i + 1:] for n in [min(len(a), len(b))])
            print(f"{c:20s} {k:5s} spread of the own-world loops (largest |dx| between two "
                  f"seeds): {spread:.3g}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
