"""How often the JAX reference's closed loop meets each family's quality
tripwire across seeds: ``bench.quality_row(family, backend="scan",
seed=s)`` (the reference's whole-episode jit at the family's quality
config) for seeds first-seed … first-seed + seeds − 1, each episode's steady
state (mean of the last quarter) against ``bench.QUALITY_THRESHOLDS``. CPU
only; imports the JAX package and bench.py.

The tripwires were set at one fixed seed; a fleet runs one seed per robot,
so chip_smoke.py holds the port's share of robots under the bar (an R=64
fleet, phase 21) against the share this probe prints, as it holds the
obstacle episode's clearance (tests/_obstacle_noise_probe.py).

Run:  python tests/_quality_seed_probe.py [--families pendulum,arm] [--seeds 64]
      [--first-seed 0] [--workers 4] [--out FILE.json]
(~3-30 s per episode on one CPU core, by family.)
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("lti", "obstacle", "pendulum", "cartpole", "unicycle", "quadrotor", "arm",
            "quadrotor3d")


def _row(job: tuple[str, int]) -> dict:
    family, seed = job
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                       "intra_op_parallelism_threads=1")
    sys.path.insert(0, ROOT)
    import bench

    t0 = time.perf_counter()
    row = bench.quality_row(family, backend="scan", seed=seed)
    return dict(family=family, seed=seed, steady=row["steady"],
                under=row["steady"] < bench.QUALITY_THRESHOLDS[family],
                seconds=round(time.perf_counter() - t0, 1))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--seeds", type=int, default=64)
    p.add_argument("--first-seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--out", default=None, help="write every episode's row here (JSON)")
    args = p.parse_args(argv)
    families = [f for f in args.families.split(",") if f]
    jobs = [(f, s) for f in families for s in range(args.first_seed, args.first_seed + args.seeds)]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        rows = pool.map(_row, jobs, chunksize=1)
    for f in families:
        mine = [r for r in rows if r["family"] == f]
        steady = sorted(r["steady"] for r in mine)
        print(f"{f}: {sum(r['under'] for r in mine)} of {len(mine)} seeds under the bar; steady "
              f"min {steady[0]}, median {steady[len(steady) // 2]}, max {steady[-1]}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
