"""3-D quadrotor waypoint flight: the quaternion rigid-body model flies a
three-waypoint tour by re-targeting the hover cost as it goes (counterpart
of the repo's ``examples/quadrotor3d_flight.py``, with the same tour
weights, waypoints, reach rule and exit criterion).

Run:  python -m mppi_gpu_tpu_torch.examples.quadrotor3d_flight [--steps 600] [-o flight.png]
      (``--device cpu`` runs the eager path on the CPU)

Each control step assigns ``with_goal(ctrl.cost, waypoint)`` to ``ctrl.cost``,
the hover cost aiming at the current waypoint; the controller sees that only
the goal changed, keeps its fused family's pack and passes the new goal to
the next solve, so the fused backend flies the cost assigned last. A
waypoint counts as visited the first time the quadrotor is within 0.3 m of
it below 0.8 m/s; the tour then moves on. Exits 0 when all three waypoints
were visited and the flight ends within 0.45 m of the last. With ``-o`` it
also draws the path in 3-D with attitude crosses (needs matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.controller import BACKENDS, MPPIController
from mppi_gpu_tpu_torch.envs import make_world
from mppi_gpu_tpu_torch.envs.quadrotor3d_world import quat_to_body_axes
from mppi_gpu_tpu_torch.ops.cost import with_goal

WAYPOINTS = ((-0.2, 0.1, 1.3), (0.8, 0.6, 0.8), (0.0, 0.4, 0.5))
REACH = 0.3  # a waypoint is reached within this radius at low speed
# the config's velocity weights are hover-conservative; the tour lightens them
# so that the legs transit at ~0.5 m/s
TOUR_W = (4.0, 4.0, 4.0, 10.0, 1.2, 1.2, 1.2, 0.5)


def fly(ctrl: MPPIController, world, steps: int) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """The tour: (states (N+1, 13), [(step, waypoint) of each first reach])."""
    f32 = dict(dtype=torch.float32, device=ctrl.device)
    ctrl.cost = dataclasses.replace(ctrl.cost, w=torch.tensor(TOUR_W, **f32))
    ws = world.reset()
    U = ctrl.init_action_seq()
    xs, wp_idx, reached_at = [ws.x.numpy()], 0, []
    for step in range(steps):
        x = ws.x.numpy()
        wp = WAYPOINTS[wp_idx]
        if (np.linalg.norm(x[0:3] - wp) < REACH and np.linalg.norm(x[7:10]) < 0.8
                and wp_idx not in {i for _, i in reached_at}):  # first reach only
            reached_at.append((step, wp_idx))
            if wp_idx < len(WAYPOINTS) - 1:
                wp_idx += 1
                wp = WAYPOINTS[wp_idx]
        goal = torch.zeros(13, **f32)
        goal[0:3] = torch.tensor(wp, **f32)
        ctrl.cost = with_goal(ctrl.cost, goal)
        res = ctrl.solve_auto(torch.from_numpy(x), U, step)
        U = res.u_next
        ws, done = world.simulate(ws, res.action.cpu())
        xs.append(ws.x.numpy())
        if done:
            break
    return np.asarray(xs), reached_at


def draw(out: str, xs: np.ndarray) -> bool:
    """The 3-D figure of the flight, or False (with a message naming the
    missing package) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"error: drawing {out} needs matplotlib, which is not installed", file=sys.stderr)
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7.5, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(xs[:, 0], xs[:, 1], xs[:, 2], "-", color="C0", lw=1.2, label="flight path")
    for i in range(0, len(xs), 30):  # attitude crosses every 0.5 s
        p = xs[i, 0:3]
        for b in quat_to_body_axes(xs[i, 3:7], 0.17):
            ax.plot(*[[p[d] - b[d], p[d] + b[d]] for d in range(3)], "-", color="0.4", lw=1.8)
    ax.plot([xs[0, 0]], [xs[0, 1]], [xs[0, 2]], "o", color="C0", label="start")
    for j, wp in enumerate(WAYPOINTS):
        ax.plot([wp[0]], [wp[1]], [wp[2]], "*", color="C2", ms=14)
        ax.text(wp[0], wp[1], wp[2] + 0.06, f"wp{j}", fontsize=9)
    ax.set(xlabel="x (m)", ylabel="y (m)", zlabel="z (m)",
           title="3-D quadrotor waypoint tour (MPPI, quaternion SE(3))")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    print(f"saved {out}")
    return True


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m mppi_gpu_tpu_torch.examples.quadrotor3d_flight")
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
    cfg = load_config("configs/quadrotor3d.yaml")
    ctrl = MPPIController(cfg, device=device, rollout_backend=args.rollout_backend)
    xs, reached_at = fly(ctrl, make_world(cfg), args.steps)
    visited = {i for _, i in reached_at}
    final_d = float(np.linalg.norm(xs[-1][0:3] - WAYPOINTS[-1]))
    tilt = 2.0 * (xs[:, 4] ** 2 + xs[:, 5] ** 2)
    print(f"{len(xs) - 1} steps, {ctrl.rollout_backend} backend on {device}")
    print(f"waypoints visited: {sorted(visited)} of {list(range(len(WAYPOINTS)))} "
          f"(steps {[s for s, _ in reached_at]})")
    print(f"final distance to last waypoint: {final_d:.3f} m")
    print(f"max tilt (1 - e_z . R e_z) over the flight: {tilt.max():.3f}")
    if args.out and not draw(args.out, xs):
        return 1
    return 0 if len(visited) == len(WAYPOINTS) and final_d < 0.45 else 1


if __name__ == "__main__":
    sys.exit(main())
