"""Ground-truth worlds for the closed loop: the torch point-mass, pendulum,
cart-pole, unicycle, planar-quadrotor, two-link-arm and 3-D quadrotor
worlds, picked from a config by :func:`make_world` (the counterpart of
``mppi_gpu_tpu.envs.make_jax_world``; the obstacle cost's point mass runs in
the point-mass world). Each world steps one robot or a fleet of R robots
(``reset(n_robots)``, ``from_x`` of an (R, s) state) on the host
(``simulate``) or on the device (``advance``, ``envs/base.py``).

The native C++ world and the MuJoCo plant are not ported yet (ROADMAP.md,
Open items §1 items 3 and 5).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.envs.arm_world import ArmParams, ArmState, ArmWorld
from mppi_gpu_tpu_torch.envs.cartpole_world import CartPoleParams, CartPoleState, CartPoleWorld
from mppi_gpu_tpu_torch.envs.params import WorldParams, world_params_for_config
from mppi_gpu_tpu_torch.envs.pendulum_world import PendulumParams, PendulumState, PendulumWorld
from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld, WorldState
from mppi_gpu_tpu_torch.envs.quadrotor3d_world import (
    Quadrotor3DParams,
    Quadrotor3DState,
    Quadrotor3DWorld,
)
from mppi_gpu_tpu_torch.envs.quadrotor_world import (
    QuadrotorParams,
    QuadrotorState,
    QuadrotorWorld,
)
from mppi_gpu_tpu_torch.envs.unicycle_world import UnicycleParams, UnicycleState, UnicycleWorld

# (substring of the config's env, its world's params), in the order of
# mppi_gpu_tpu.envs.params_for_config; anything else is the point-mass
# world. max-a[0] of the quadrotors bounds the collective F, the sum over
# their 4 (3-D) or 2 (planar) rotors, so each rotor's envelope is a quarter
# or a half of it.
_FAMILIES = (
    ("arm", lambda cfg: ArmParams(max_t1=cfg.max_a[0], max_t2=cfg.max_a[1])),
    ("unicycle", lambda cfg: UnicycleParams(max_v=cfg.max_a[0], max_w=cfg.max_a[1])),
    ("cartpole", lambda cfg: CartPoleParams(max_force=max(cfg.max_a))),
    ("pendulum", lambda cfg: PendulumParams(max_torque=max(cfg.max_a))),
    ("quadrotor3d", lambda cfg: Quadrotor3DParams(max_thrust=cfg.max_a[0] / 4.0)),
    ("quadrotor", lambda cfg: QuadrotorParams(max_thrust=cfg.max_a[0] / 2.0)),
)
# world params type → world
_WORLDS = {
    ArmParams: ArmWorld, UnicycleParams: UnicycleWorld, CartPoleParams: CartPoleWorld,
    PendulumParams: PendulumWorld, QuadrotorParams: QuadrotorWorld,
    Quadrotor3DParams: Quadrotor3DWorld,
}


def params_for_config(cfg):
    """The world family and its physical parameters from the config's `env`."""
    env = str(cfg.env)
    for family, params in _FAMILIES:
        if family in env:
            return params(cfg)
    return world_params_for_config(cfg)


def make_world(cfg, params=None, device: torch.device | str = "cpu"):
    """The ground-truth world for `params` (default: the config's), its
    states on `device`."""
    params = params if params is not None else params_for_config(cfg)
    return _WORLDS.get(type(params), PointMassWorld)(params, device)


__all__ = [
    "WorldParams", "world_params_for_config", "params_for_config", "make_world",
    "PointMassWorld", "WorldState", "PendulumParams", "PendulumState", "PendulumWorld",
    "CartPoleParams", "CartPoleState", "CartPoleWorld", "UnicycleParams", "UnicycleState",
    "UnicycleWorld", "QuadrotorParams", "QuadrotorState", "QuadrotorWorld", "ArmParams",
    "ArmState", "ArmWorld", "Quadrotor3DParams", "Quadrotor3DState", "Quadrotor3DWorld",
]
