"""Learned-dynamics MPPI: a residual-MLP surrogate fitted on the true world's
transitions drops into the same solve (counterpart of the repo's
``examples/learn_dynamics.py``, with the same pipeline, sizes and printout).

1. collect transitions from the ground-truth point-mass world with random
   states and actions (a seeded ``torch.Generator``);
2. fit the residual MLP on the (x, u, x') pairs (full-batch Adam);
3. run the closed loop with the LEARNED model in the rollout (the eager
   backend: no fused family takes a learned model);
4. compare with the closed loop of the analytic model on the same episode.

Run:  python -m mppi_gpu_tpu_torch.examples.learn_dynamics [-c configs/point_mass2d.yaml]
      (``--device cpu`` runs it on the CPU)

Prints the fit's loss, its time per Adam step, and both controllers' final
distances to the goal; exits 0 when both closed loops ran.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.controller import MPPIController
from mppi_gpu_tpu_torch.envs.params import world_params_for_config
from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld
from mppi_gpu_tpu_torch.models.neural import fit_mlp_dynamics, init_mlp_dynamics
from mppi_gpu_tpu_torch.runner import run_closed_loop


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def collect_transitions(cfg, n: int, seed: int = 0, device: torch.device | str = "cpu"):
    """`n` transitions (x, u, x') at the controller's cadence: x' is the true
    world's state one model step (cfg.dt of sim time, u held) after x, from
    states and actions drawn uniformly over the reachable box (the JAX
    example's ranges; a random walk would oversample the joint limits)."""
    params = world_params_for_config(cfg)
    world = PointMassWorld(params, device)
    phys_steps = max(1, round(cfg.dt / params.timestep))
    g = torch.Generator().manual_seed(seed)
    a = cfg.action_dim
    q0 = _uniform(g, (n, a), -1.2, 1.2)
    qd0 = _uniform(g, (n, a), -1.5, 1.5)
    us = _uniform(g, (n, a), -1.0, 1.0).to(device)
    xs = torch.cat([q0, qd0], dim=-1).to(device)
    state = world.from_x(xs, params.timestep)
    for _ in range(phys_steps):  # raw physics steps: no episode clock
        state = world.physics_step(state, us)
    return xs, us, state.x


def fit(cfg, transitions, steps: int, device: torch.device | str):
    """The JAX example's surrogate (128, 128) fitted at lr 3e-3: (model,
    losses, seconds)."""
    mlp0 = init_mlp_dynamics(cfg.state_dim, cfg.action_dim, hidden=(128, 128),
                             generator=torch.Generator().manual_seed(1), device=device)
    t0 = time.perf_counter()
    mlp, losses = fit_mlp_dynamics(mlp0, transitions, lr=3e-3, steps=steps)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return mlp, losses, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m mppi_gpu_tpu_torch.examples.learn_dynamics")
    p.add_argument("-c", "--config", default="configs/point_mass2d.yaml")
    p.add_argument("--transitions", type=int, default=2000)
    p.add_argument("--fit-steps", type=int, default=800)
    p.add_argument("--episode-steps", type=int, default=120)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    cfg = load_config(args.config)

    print(f"collecting {args.transitions} transitions from the true world ...")
    transitions = collect_transitions(cfg, args.transitions, device=device)

    print("fitting residual MLP surrogate ...")
    mlp, losses, fit_s = fit(cfg, transitions, args.fit_steps, device)
    print(f"  loss {float(losses[0]):.5f} -> {float(losses[-1]):.6f}")
    print(f"  {args.fit_steps} Adam steps in {fit_s:.3f} s "
          f"({1e3 * fit_s / max(args.fit_steps, 1):.4f} ms per step) on {device}")

    goal = np.asarray(cfg.goal)[: cfg.action_dim]

    def final_err(res) -> float:
        return float(np.linalg.norm(res.final_state[: cfg.action_dim] - goal))

    print("closed loop with the ANALYTIC model ...")
    res_lti = run_closed_loop(MPPIController(cfg, device=device), max_steps=args.episode_steps)
    print(f"  final distance to goal: {final_err(res_lti):.4f} m")

    print("closed loop with the LEARNED model ...")
    ctrl_mlp = MPPIController(cfg, device=device, dynamics=mlp, rollout_backend="eager")
    res_mlp = run_closed_loop(ctrl_mlp, max_steps=args.episode_steps)
    print(f"  final distance to goal: {final_err(res_mlp):.4f} m")

    # the learned model was fitted on the true world, so it should be at
    # least competitive with the deliberately mismatched analytic model
    print("learned-model controller is "
          + ("BETTER" if final_err(res_mlp) <= final_err(res_lti) else "worse")
          + " than the analytic-model controller on this episode")
    return 0


if __name__ == "__main__":
    sys.exit(main())
