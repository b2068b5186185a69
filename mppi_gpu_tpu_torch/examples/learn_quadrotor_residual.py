"""Hybrid physics + learned dynamics for the 3-D quadrotor: keep the analytic
rigid-body model and learn the model-plant gap, the integrator's coarseness
(RK2 at the control period against the world's RK4 at 1/240 s) and the rotor
clamp the model ignores (counterpart of the repo's
``examples/learn_quadrotor_residual.py``, with the same pipeline, sizes and
exit rule).

1. collect transitions from the ground-truth world at the controller's
   cadence, near hover, with thrusts deep into the rotor clamp (a seeded
   ``torch.Generator``);
2. fit ``HybridResidualDynamics`` = analytic step + MLP residual, the
   quaternion slice renormalised, on three quarters of them;
3. compare the one-step prediction error on the held-out quarter: analytic
   against hybrid;
4. fly a closed-loop hover with the hybrid model in the rollout (the eager
   backend).

Run:  python -m mppi_gpu_tpu_torch.examples.learn_quadrotor_residual
      (``--device cpu`` runs it on the CPU)

Exits 0 when the hybrid's held-out RMSE is below the analytic model's and
the closed loop ends at a finite distance from the goal.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.controller import MPPIController
from mppi_gpu_tpu_torch.envs import make_world, params_for_config
from mppi_gpu_tpu_torch.models import dynamics_for_config
from mppi_gpu_tpu_torch.models.neural import (
    HybridResidualDynamics,
    MLPDynamics,
    fit_residual_dynamics,
    init_mlp_dynamics,
)
from mppi_gpu_tpu_torch.runner import run_closed_loop

HOVER = 7.848  # m·g for the default 0.8 kg body


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def collect_transitions(cfg, n: int, seed: int = 0, device: torch.device | str = "cpu"):
    """(x, u, x') at the controller's cadence: random near-hover states and
    wrench commands, each stepped through the true world's mix → clamp → RK4
    for one control period."""
    params = params_for_config(cfg)
    world = make_world(cfg, params, device)
    phys_steps = max(1, round(cfg.dt / params.timestep))
    g = torch.Generator().manual_seed(seed)
    p0 = _uniform(g, (n, 3), -1.0, 1.0)
    # a small random attitude: the quaternion (1, small vector), normalised
    q0 = torch.cat([torch.ones(n, 1), 0.15 * torch.randn(n, 3, generator=g)], dim=1)
    q0 = q0 / torch.linalg.norm(q0, dim=1, keepdim=True)
    v0 = _uniform(g, (n, 3), -1.0, 1.0)
    om0 = _uniform(g, (n, 3), -1.0, 1.0)
    xs = torch.cat([p0, q0, v0, om0], dim=1).to(device)
    # the excitation reaches well into the rotor clamp (low collective and
    # corner torques), where the model-plant gap lives
    us = torch.cat([
        HOVER + _uniform(g, (n, 1), -7.0, 5.0),
        _uniform(g, (n, 3), -1.0, 1.0) * torch.tensor(cfg.max_a[1:]),
    ], dim=1).to(device)
    state = world.from_x(xs, 0.0)
    for _ in range(phys_steps):
        state = world.physics_step(state, us)
    return xs, us, state.x


def rmse(pred: torch.Tensor, target: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(torch.sum((pred - target) ** 2, dim=-1))))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mppi_gpu_tpu_torch.examples.learn_quadrotor_residual")
    p.add_argument("--transitions", type=int, default=16384)
    p.add_argument("--fit-steps", type=int, default=4000)
    p.add_argument("--loop-steps", type=int, default=120)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    cfg = load_config("configs/quadrotor3d.yaml")
    base = dynamics_for_config(cfg, device)

    print(f"collecting {args.transitions} transitions from the true world ...")
    xs, us, xn = collect_transitions(cfg, args.transitions, device=device)
    n_tr = args.transitions * 3 // 4
    train = (xs[:n_tr], us[:n_tr], xn[:n_tr])
    held = (xs[n_tr:], us[n_tr:], xn[n_tr:])
    err_analytic = rmse(base.step(held[0], held[1]), held[2])

    print("fitting the residual net (analytic part frozen) ...")
    mlp = init_mlp_dynamics(cfg.state_dim, cfg.action_dim, hidden=(128, 128),
                            generator=torch.Generator().manual_seed(1), device=device)
    # standardise the net's inputs: hover thrust ~8 beside rates ~0.1 would
    # park the tanh layers in saturation from the first step
    inputs = torch.cat([train[0], train[1]], dim=1)
    mlp = MLPDynamics(mlp.weights, mlp.biases, mlp.residual_scale, torch.mean(inputs, dim=0),
                      1.0 / (torch.std(inputs, dim=0, correction=0) + 1e-6))
    hybrid = HybridResidualDynamics(base, mlp, unit_norm_slice=(3, 7))  # the quaternion stays unit
    t0 = time.perf_counter()
    hybrid, losses = fit_residual_dynamics(hybrid, train, lr=3e-3, steps=args.fit_steps,
                                           whiten=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    print(f"  loss {float(losses[0]):.6f} -> {float(losses[-1]):.7f}")
    print(f"  {args.fit_steps} Adam steps in {fit_s:.3f} s "
          f"({1e3 * fit_s / max(args.fit_steps, 1):.4f} ms per step) on {device}")

    err_hybrid = rmse(hybrid.step(held[0], held[1]), held[2])
    print(f"one-step prediction RMSE on {len(held[0])} held-out transitions:")
    print(f"  analytic model : {err_analytic:.5f}")
    print(f"  hybrid model   : {err_hybrid:.5f}  "
          f"({err_analytic / max(err_hybrid, 1e-12):.1f}x better)")

    print("closed-loop hover with the HYBRID model in the rollout ...")
    ctrl = MPPIController(cfg, device=device, dynamics=hybrid)  # no fused family: eager
    res = run_closed_loop(ctrl, max_steps=args.loop_steps)
    d = float(np.linalg.norm(res.xs[-1][:3] - np.asarray(cfg.goal[:3])))
    print(f"  distance to goal after {args.loop_steps} cycles: {d:.3f} m "
          f"({ctrl.rollout_backend} backend on {device})")
    return 0 if err_hybrid < err_analytic and np.isfinite(d) else 1


if __name__ == "__main__":
    sys.exit(main())
