"""Model-mismatch harness (the port's counterpart of ``mppi_gpu_tpu.miss``,
the reference's `miss` executable, src/model_missmatch.cpp:123-155): drive
the SAME random open-loop control sequence through (a) the ground-truth
world and (b) the controller's internal model, and save the trajectories
side by side. The gap is the model-plant mismatch MPPI must absorb (the
point-mass model ignores damping, armature and gear and steps dt=0.1 per
horizon step, while the world advances 1/60 s per control cycle).

    python -m mppi_gpu_tpu_torch.miss -c configs/point_mass2d.yaml -o missmatch.csv \\
        [--world torch|native|mujoco] [--device cuda]

The world is a host plant (``envs.make_host_world``: the torch world on the
CPU, the native C++ twin or real MuJoCo), driven by raw physics steps; the
model rolls out on `--device`, which defaults to cuda and never falls back
to the CPU. The excitation is drawn with ``numpy.random.default_rng(seed)``
as in the JAX module, so both packages drive the same inputs. A point-mass
config goes to :func:`run_mismatch`; every other family, the arm and the
unicycle included, to :func:`run_mismatch_config`.
"""

from __future__ import annotations

import argparse
import csv
import sys
from dataclasses import dataclass

import numpy as np
import torch

from mppi_gpu_tpu_torch.envs import (
    WORLD_BACKENDS,
    PointMassWorld,
    TorchPlant,
    WorldParams,
    make_host_world,
    make_world,
    params_for_config,
)
from mppi_gpu_tpu_torch.envs.mujoco_world import MujocoPointMassWorld
from mppi_gpu_tpu_torch.envs.native import NativePointMassWorld
from mppi_gpu_tpu_torch.models import PointMassLTI, dynamics_for_config


@dataclass
class MismatchResult:
    traj_model: np.ndarray  # (n+1, s) the controller's model, open loop
    traj_world: np.ndarray  # (n+1, s) the ground-truth world, open loop
    us: np.ndarray          # (n, a)
    pos_dims: int = 0       # leading position dims; 0 = action_dim (the
                            # [q, qd] families); quadrotor3d sets 3

    @property
    def position_rmse(self) -> float:
        a = self.pos_dims or self.us.shape[1]
        d = self.traj_model[:, :a] - self.traj_world[:, :a]
        return float(np.sqrt((d**2).mean()))


def _world_rollout(plant, us: np.ndarray, phys_steps: int) -> np.ndarray:
    """`phys_steps` raw physics steps per input, NOT ``simulate()``: the
    episode clock would freeze the world after sim_end and a long excitation
    would compare the model against a frozen plant."""
    traj = np.empty((len(us) + 1, len(plant.get_x())), np.float32)
    traj[0] = plant.get_x()
    for t, u in enumerate(us):
        for _ in range(phys_steps):
            plant.step(u)
        traj[t + 1] = plant.get_x()
    return traj


def _model_rollout(dyn, x0: np.ndarray, us: np.ndarray, device) -> np.ndarray:
    """The model open loop at its own dt, one step per input, on `device`."""
    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    xs = [x]
    for u in torch.as_tensor(us, device=device):
        x = dyn.step(x, u)
        xs.append(x)
    return torch.stack(xs).cpu().numpy()


_POINT_MASS = {
    "torch": lambda p: TorchPlant(PointMassWorld(p)),
    "native": NativePointMassWorld,
    "mujoco": MujocoPointMassWorld,
}


def run_mismatch(
    n_axes: int,
    *,
    n_steps: int = 100,
    dt: float = 0.1,
    seed: int = 0,
    world_backend: str = "torch",
    device: torch.device | str = "cuda",
) -> MismatchResult:
    """The point mass of `n_axes` axes: N(0, 1) inputs, one control cycle of
    the world and one model step at `dt` per input."""
    rng = np.random.default_rng(seed)
    us = rng.standard_normal((n_steps, n_axes)).astype(np.float32)
    params = WorldParams(n_axes=n_axes)
    if world_backend not in _POINT_MASS:
        raise ValueError(f"unknown world backend '{world_backend}' ({'|'.join(WORLD_BACKENDS)})")
    traj_world = _world_rollout(_POINT_MASS[world_backend](params), us, params.steps_per_control)
    traj_model = _model_rollout(PointMassLTI.create(dt, n_axes, device),
                                np.zeros(2 * n_axes, np.float32), us, device)
    return MismatchResult(traj_model=traj_model, traj_world=traj_world, us=us)


def run_mismatch_config(
    cfg,
    *,
    n_steps: int = 100,
    seed: int = 0,
    world_backend: str = "torch",
    device: torch.device | str = "cuda",
) -> MismatchResult:
    """Model-vs-world mismatch for the families other than the point mass:
    the SAME random action sequence through the config's dynamics model (one
    step per input, at cfg.dt) and through the ground-truth world (raw
    physics steps covering cfg.dt of sim time per input). With the torch
    world, model and world share the ODE, so the gap isolates the
    integration-level mismatch (coarse RK2 against fine RK4); with
    `world_backend="mujoco"` the plant is the real engine, the measurement
    the reference's miss tool makes (model_missmatch.cpp:49-71, there for
    the point mass only). The unicycle has no native or MuJoCo plant, the
    arm no native one: those raise ValueError by name."""
    rng = np.random.default_rng(seed)
    a = cfg.action_dim
    # excitation around the nominal action (hover thrust for the quadrotors,
    # zero for the torque/force families), ±max_a/2
    us = (
        np.asarray(cfg.init_act, np.float32)
        + rng.standard_normal((n_steps, a)).astype(np.float32)
        * np.asarray(cfg.max_a, np.float32) * 0.5
    ).astype(np.float32)
    params = params_for_config(cfg)
    plant = make_host_world(cfg, params, world_backend)
    phys_steps = max(1, round(cfg.dt / params.timestep))
    x0 = make_world(cfg, params).reset().x.numpy()
    return MismatchResult(
        traj_model=_model_rollout(dynamics_for_config(cfg, device), x0, us, device),
        traj_world=_world_rollout(plant, us, phys_steps), us=us,
        pos_dims=3 if "quadrotor3d" in str(cfg.env) else 0,
    )


def save_mismatch_csv(path: str, res: MismatchResult) -> None:
    """Side-by-side CSV like the reference's missmatch.csv
    (model_missmatch.cpp:102-121; `_s` = simulated model, `_w` = world).
    The [q, qd] families get q{i}/qd{i} columns; odd state layouts (the
    13-dim quaternion quadrotor) get generic x{i} columns, which
    scripts/plot_miss.py also understands."""
    s = res.traj_model.shape[1]
    if s % 2 == 0:
        a = s // 2
        names = [f"q{i}" for i in range(a)] + [f"qd{i}" for i in range(a)]
    else:
        names = [f"x{i}" for i in range(s)]
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow([f"{n}_s" for n in names] + [f"{n}_w" for n in names])
        for xm, xw in zip(res.traj_model, res.traj_world):
            wr.writerow([f"{v:.8g}" for v in xm] + [f"{v:.8g}" for v in xw])


def main(argv: list[str] | None = None) -> int:
    from mppi_gpu_tpu_torch.config import load_config

    p = argparse.ArgumentParser(prog="mppi_gpu_tpu_torch.miss")
    p.add_argument("-c", "--config", default=None, help="YAML config (for dims/dt)")
    p.add_argument("-a", "--axes", type=int, default=2, help="axes if no config")
    p.add_argument("-n", "--steps", type=int, default=100)
    p.add_argument("-o", "--out", default="missmatch.csv")
    p.add_argument("--world", choices=WORLD_BACKENDS, default="torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="the model's torch device (default: cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2
    try:
        cfg = load_config(args.config) if args.config else None
        if cfg is not None and not isinstance(params_for_config(cfg), WorldParams):
            # every family but the point mass, the arm and the unicycle
            # included: the JAX module sends only the pendulum, the
            # cart-pole and the quadrotors here, and measures the others'
            # configs on the point mass
            res = run_mismatch_config(cfg, n_steps=args.steps, seed=args.seed,
                                      world_backend=args.world, device=device)
        else:
            n_axes, dt = (cfg.action_dim, cfg.dt) if cfg else (args.axes, 0.1)
            res = run_mismatch(n_axes, n_steps=args.steps, dt=dt, seed=args.seed,
                               world_backend=args.world, device=device)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    save_mismatch_csv(args.out, res)
    print(f"open-loop position RMSE (model vs world): {res.position_rmse:.4f} m")
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
