"""Quadrotor waypoint tour: the planar birotor flies a sequence of waypoints
by re-targeting the hover cost mid-episode (counterpart of the repo's
``examples/quadrotor_waypoints.py``, with the same tour, reach rule and
exit criterion).

Run:  python -m mppi_gpu_tpu_torch.examples.quadrotor_waypoints [--steps 600] [-o wp.png]
      (``--device cpu`` runs the eager path on the CPU)

Every control step assigns a new ``QuadrotorHoverCost`` aiming at the
current waypoint, made of the current cost's own ``w``, ``lambda_`` and
``inv_s`` tensors: the controller sees that only the goal changed
(``ops/cost.only_goal_differs``), keeps its fused family's pack and passes
the new goal to the next solve. A waypoint counts as visited the first time
the quadrotor is within 0.25 m of it below 0.8 m/s; the tour then moves on.
Prints the waypoints visited, the final distance to the last one and the
largest tilt; exits 0 when all three were visited and the flight ends
within 0.4 m of the last. With ``-o`` it also draws a side view of the
flight with attitude ticks (needs matplotlib).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.controller import BACKENDS, MPPIController
from mppi_gpu_tpu_torch.envs import make_world
from mppi_gpu_tpu_torch.ops.cost import QuadrotorHoverCost

WAYPOINTS = ((0.0, 1.0), (1.2, 0.4), (-0.3, 0.2))  # visit in order, then hover
REACH = 0.25  # a waypoint is reached within this radius at low speed
FINAL_REACH = 0.4  # the flight's end, from the last waypoint


def fly(ctrl: MPPIController, world, steps: int) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """The tour: (states (N+1, 6), [(step, waypoint) of each first reach])."""
    ws = world.reset()
    U = ctrl.init_action_seq()
    xs, wp_idx, reached_at = [ws.x.numpy()], 0, []
    for step in range(steps):
        x = ws.x.numpy()
        wx, wz = WAYPOINTS[wp_idx]
        if (np.hypot(x[0] - wx, x[1] - wz) < REACH and np.hypot(x[3], x[4]) < 0.8
                and wp_idx not in {i for _, i in reached_at}):  # first reach only
            reached_at.append((step, wp_idx))
            if wp_idx < len(WAYPOINTS) - 1:
                wp_idx += 1
                wx, wz = WAYPOINTS[wp_idx]
        # re-target: a new cost whose only new field is the goal
        cost = ctrl.cost
        ctrl.cost = QuadrotorHoverCost(
            w=cost.w, lambda_=cost.lambda_, inv_s=cost.inv_s,
            goal=torch.tensor([wx, wz, 0.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                              device=ctrl.device),
        )
        res = ctrl.solve_auto(torch.from_numpy(x), U, step)
        U = res.u_next
        ws, done = world.simulate(ws, res.action.cpu())
        xs.append(ws.x.numpy())
        if done:
            break
    return np.asarray(xs), reached_at


def draw(out: str, xs: np.ndarray) -> bool:
    """The side view of the flight, or False (with a message naming the
    missing package) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"error: drawing {out} needs matplotlib, which is not installed", file=sys.stderr)
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(xs[:, 0], xs[:, 1], "-", color="C0", lw=1.2, label="flight path")
    arm = 0.17  # attitude ticks: the body segment every ~0.5 s
    for i in range(0, len(xs), 30):
        px, pz, th = xs[i, 0], xs[i, 1], xs[i, 2]
        dx, dz = arm * np.cos(th), -arm * np.sin(th)
        ax.plot([px - dx, px + dx], [pz - dz, pz + dz], "-", color="0.4", lw=2)
    ax.plot(*xs[0, :2], "o", color="C0", label="start")
    for j, (wx, wz) in enumerate(WAYPOINTS):
        ax.plot(wx, wz, "*", color="C2", ms=16)
        ax.annotate(f"wp{j}", (wx, wz), textcoords="offset points", xytext=(6, 6), fontsize=9)
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.set(xlabel="x (m)", ylabel="z (m)",
           title="Planar quadrotor flying a waypoint tour (MPPI, mixer space)")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    print(f"saved {out}")
    return True


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m mppi_gpu_tpu_torch.examples.quadrotor_waypoints")
    p.add_argument("-o", "--out", default=None, help="draw the flight into this image")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--rollout-backend", choices=BACKENDS, default="auto")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    cfg = load_config("configs/quadrotor.yaml")
    ctrl = MPPIController(cfg, device=device, rollout_backend=args.rollout_backend)
    xs, reached_at = fly(ctrl, make_world(cfg), args.steps)
    visited = {i for _, i in reached_at}
    final_d = float(np.linalg.norm(xs[-1][:2] - np.asarray(WAYPOINTS[-1])))
    print(f"{len(xs) - 1} steps, {ctrl.rollout_backend} backend on {device}")
    print(f"waypoints visited: {sorted(visited)} of {list(range(len(WAYPOINTS)))}")
    print(f"final distance to last waypoint: {final_d:.3f} m")
    print(f"max |tilt| over the flight: {np.abs(xs[:, 2]).max():.3f} rad")
    if args.out and not draw(args.out, xs):
        return 1
    return 0 if len(visited) == len(WAYPOINTS) and final_d < FINAL_REACH else 1


if __name__ == "__main__":
    sys.exit(main())
