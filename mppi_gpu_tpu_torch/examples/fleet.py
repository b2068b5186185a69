"""Multi-robot fleet control: R independent point-mass robots, each with its
own goal on a circle of radius 0.8 m, all solved in one launch of the fused
kernels per control step (``BatchedMPPIController``; counterpart of the
repo's ``examples/fleet.py``).

Run:  python -m mppi_gpu_tpu_torch.examples.fleet [-n 8] [--steps 120] [--episode]
      (``--device cpu --rollout-backend eager`` runs it on the CPU)

The host loop steps the batched world after each fleet solve and checks the
episode's end on the host; ``--episode`` runs ``run_fleet_episode``, which
keeps the whole loop on the device (the counterpart of ``--jit``). Exits 0
when the robots' mean distance to their goals ends below 0.75 m.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mppi_gpu_tpu_torch.batched import BatchedMPPIController
from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.controller import BACKENDS
from mppi_gpu_tpu_torch.envs import PointMassWorld, world_params_for_config
from mppi_gpu_tpu_torch.runner import run_fleet_episode
from mppi_gpu_tpu_torch.utils.timing import SolveTimer

START_DISTANCE = 0.8  # every goal lies 0.8 m from the common start


def circle_goals(n_robots: int, state_dim: int) -> np.ndarray:
    """(R, s) goals on a circle of radius 0.8 m in the (x, y) plane, at rest."""
    ang = np.linspace(0, 2 * np.pi, n_robots, endpoint=False)
    goals = np.zeros((n_robots, state_dim), np.float32)
    goals[:, 0], goals[:, 1] = START_DISTANCE * np.cos(ang), START_DISTANCE * np.sin(ang)
    return goals


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m mppi_gpu_tpu_torch.examples.fleet")
    p.add_argument("-c", "--config", default="configs/point_mass2d.yaml")
    p.add_argument("-n", "--robots", type=int, default=8)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--rollout-backend", choices=BACKENDS, default="auto")
    p.add_argument("--episode", action="store_true",
                   help="run the whole fleet episode on the device (run_fleet_episode) "
                   "instead of the host loop")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    cfg = load_config(args.config)
    R = args.robots
    goals = circle_goals(R, cfg.state_dim)
    fleet = BatchedMPPIController(
        cfg, R, goals=torch.from_numpy(goals), device=device,
        rollout_backend=args.rollout_backend,
    )
    print(f"{R} robots, {cfg.env} K={cfg.samples} T={cfg.horizon}, "
          f"{fleet.rollout_backend} backend on {device}")

    if args.episode:
        t0 = time.perf_counter()
        res = run_fleet_episode(fleet, num_steps=args.steps)
        dt = time.perf_counter() - t0
        final = res.xs[-1]
        print(f"{R} robots x {args.steps} steps as one device episode in {dt:.2f} s")
    else:
        world = PointMassWorld(world_params_for_config(cfg), device=device)
        state = world.reset(R)
        Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
        timer = SolveTimer(device)
        t0 = time.perf_counter()
        for step in range(args.steps):
            with timer.measure():
                res = fleet.solve_batch_auto(state.x, Us, seeds, step)
            Us = res.u_next
            state, done = world.simulate(state, res.action)
            if done:
                break
        dt = time.perf_counter() - t0
        final = state.x.cpu().numpy()
        ms = timer.summary(split_first=True)
        print(f"{R} robots x {args.steps} steps in {dt:.2f} s "
              f"({dt / args.steps * 1e3:.2f} ms/fleet-step incl. world); fleet solve "
              f"{ms.get('mean_ms', float('nan')):.3f} ms mean (warm)")
    dist = np.linalg.norm(final[:, :2] - goals[:, :2], axis=1)
    for i in range(R):
        print(f"  robot {i}: goal ({goals[i, 0]:+.2f},{goals[i, 1]:+.2f})  "
              f"pos ({final[i, 0]:+.3f},{final[i, 1]:+.3f})  dist {dist[i]:.3f}")
    print(f"mean distance to goal: {dist.mean():.3f} m (started at {START_DISTANCE:.2f}; "
          f"the task needs a full ~500-step episode to converge)")
    return 0 if dist.mean() < START_DISTANCE - 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
