"""Obstacle navigation: the 2-D point mass reaches its goal past spherical
no-go zones placed on the direct path (cost.type 'obstacle'; counterpart of
the repo's ``examples/obstacle_nav.py``, with the same config edits,
obstacles and exit criterion).

Run:  python -m mppi_gpu_tpu_torch.examples.obstacle_nav [--steps 500] [-o obstacle_nav.png]
      (``--device cpu`` runs the eager path on the CPU)

Prints the least clearance of the closed-loop path beyond the obstacles'
radii and its final distance to the goal; exits 0 when the path stays clear
of every obstacle and ends within 0.8 m of the goal. With ``-o`` it also
draws the path, the obstacles and the goal from above (needs matplotlib).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.controller import BACKENDS, MPPIController
from mppi_gpu_tpu_torch.runner import run_closed_loop

OBSTACLES = ((0.45, 0.12, 0.18), (0.75, -0.18, 0.15))  # (cx, cy, r) on the way to (1, 0)


def min_clearance(xs: np.ndarray, obstacles) -> float:
    """The least distance of the positions of `xs` (N, s) beyond the
    obstacles' surfaces, each obstacle (centre..., radius); negative inside."""
    return min(
        float(np.min(np.linalg.norm(xs[:, :len(o) - 1] - np.asarray(o[:-1]), axis=1)) - o[-1])
        for o in obstacles
    )


def draw(out: str, q: np.ndarray, goal, obstacles) -> bool:
    """The top-down figure of path `q` (N, 2), or False (with a message naming
    the missing package) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"error: drawing {out} needs matplotlib, which is not installed", file=sys.stderr)
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for cx, cy, r in obstacles:
        ax.add_patch(plt.Circle((cx, cy), r, color="C3", alpha=0.35))
        ax.add_patch(plt.Circle((cx, cy), r, fill=False, color="C3", lw=1.5))
    ax.plot(q[:, 0], q[:, 1], "-", color="C0", lw=1.5, label="closed-loop path")
    ax.plot(*q[0], "o", color="C0", label="start")
    ax.plot(goal[0], goal[1], "*", color="C2", ms=16, label="goal")
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.legend(loc="best", fontsize=8)
    ax.set_title("MPPI navigating spherical no-go zones")
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    print(f"saved {out}")
    return True


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m mppi_gpu_tpu_torch.examples.obstacle_nav")
    p.add_argument("-o", "--out", default=None, help="draw the path into this image")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--rollout-backend", choices=BACKENDS, default="auto")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    cfg = load_config("configs/point_mass2d.yaml").replace(
        cost_type="obstacle", obstacles=OBSTACLES, obstacle_w=800.0,
        noise_beta=0.5,  # smoother exploration navigates gaps better
    )
    ctrl = MPPIController(cfg, device=device, rollout_backend=args.rollout_backend)
    res = run_closed_loop(ctrl, max_steps=args.steps)
    q = res.xs[:, :2]
    clear = min_clearance(res.xs, OBSTACLES)
    goal_d = float(np.linalg.norm(q[-1] - np.array(cfg.goal[:2])))
    print(f"{len(res.us)} steps, {ctrl.rollout_backend} backend on {device}")
    print(f"min clearance beyond obstacle radii: {clear:+.3f} m")
    print(f"final distance to goal: {goal_d:.3f} m")
    if args.out and not draw(args.out, q, cfg.goal, OBSTACLES):
        return 1
    return 0 if clear > 0 and goal_d < 0.8 else 1


if __name__ == "__main__":
    sys.exit(main())
