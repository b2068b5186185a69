"""How far the JAX package's own closed loops of one robot part when only
their rounding differs, at a config's full width (quadrotor3d by default),
over the first cycles; the reference figures against which the port's fleet
robots are read where the port's fleet runs another K1 body than its solo
robot (S bit-equal, ΔU to rounding). CPU only; imports the JAX package.

For seeds 0 … seeds − 1 of robots 0 … robots − 1 of an R-robot fleet:

* fleet vs solo: ``run_fleet_episode_jit`` (the scan fleet, vmap of the
  solve over robots, threefry erfinv sampler) against ``run_episode_jit`` of
  one robot under the fleet's key for it and the same sampler;
* host vs jit: ``run_closed_loop`` (one jitted solve per step, the world
  stepped apart) against ``run_episode_jit`` (the whole episode in one
  ``lax.scan``; XLA fuses it otherwise), one robot at the config's seed +
  robot, as tests/test_closed_loop.py holds them for a small point mass.

Prints the largest |Δx| over the states of the first `cycles` cycles.

Run:  python tests/_fleet_solo_probe.py [--config quadrotor3d] [--robots 4]
      [--fleet 8] [--cycles 12] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="quadrotor3d")
    p.add_argument("--robots", type=int, default=4)
    p.add_argument("--fleet", type=int, default=8)
    p.add_argument("--cycles", type=int, default=12)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import numpy as np

    from mppi_gpu_tpu.batched import BatchedMPPIController
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.runner import run_closed_loop, run_episode_jit, run_fleet_episode_jit

    cfg = load_config(os.path.join(ROOT, "configs", f"{args.config}.yaml"))
    n = args.cycles
    fleet = BatchedMPPIController(cfg, args.fleet, rollout_backend="scan")
    ep = run_fleet_episode_jit(fleet, num_steps=n)
    keys = fleet.init_keys()
    rows = []
    for r in range(args.robots):
        solo = MPPIController(cfg, rollout_backend="scan", sampler=fleet.sampler)
        one = run_episode_jit(solo, num_steps=n, base_key=keys[r])
        fs_gap = np.abs(np.asarray(ep.xs)[:, r] - one.xs).max(axis=1)
        seeded = cfg.replace(seed=cfg.seed + r)
        host = run_closed_loop(MPPIController(seeded, rollout_backend="scan"), max_steps=n)
        jit = run_episode_jit(MPPIController(seeded, rollout_backend="scan"), num_steps=n)
        m = min(len(host.xs), len(jit.xs))
        hj_gap = np.abs(host.xs[:m] - jit.xs[:m]).max(axis=1)
        rows.append(dict(robot=r, fleet_vs_solo=fs_gap.tolist(), host_vs_jit=hj_gap.tolist()))
        print(f"{args.config} robot {r}: fleet vs solo max |dx| over {n} cycles "
              f"{fs_gap.max():.3g} (after cycle 1 {fs_gap[1]:.3g}); host loop vs whole-episode "
              f"jit at seed {cfg.seed + r}: {hj_gap.max():.3g} (after cycle 1 {hj_gap[1]:.3g})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
