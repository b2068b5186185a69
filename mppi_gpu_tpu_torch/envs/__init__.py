"""Ground-truth worlds for the closed loop: the torch point-mass, pendulum
and cart-pole worlds, picked from a config by :func:`make_world`.

The other families' worlds, the native C++ world and the MuJoCo plant are
not ported yet (ROADMAP.md, Open items §1 items 5, 6 and 10).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.envs.cartpole_world import CartPoleParams, CartPoleState, CartPoleWorld
from mppi_gpu_tpu_torch.envs.params import WorldParams, world_params_for_config
from mppi_gpu_tpu_torch.envs.pendulum_world import PendulumParams, PendulumState, PendulumWorld
from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld, WorldState

# (substring of the config's env, its world's params or None while
# unported), in the order of mppi_gpu_tpu.envs.params_for_config; anything
# else is the point-mass world
_FAMILIES = (
    ("arm", None),
    ("unicycle", None),
    ("cartpole", lambda cfg: CartPoleParams(max_force=max(cfg.max_a))),
    ("pendulum", lambda cfg: PendulumParams(max_torque=max(cfg.max_a))),
    ("quadrotor3d", None),
    ("quadrotor", None),
)


def params_for_config(cfg):
    """The world family and its physical parameters from the config's `env`."""
    env = str(cfg.env)
    for family, params in _FAMILIES:
        if family not in env:
            continue
        if params is None:
            raise NotImplementedError(
                f"the '{family}' world is not ported to mppi_gpu_tpu_torch yet "
                "(see ROADMAP.md, Open items §1 item 6)"
            )
        return params(cfg)
    return world_params_for_config(cfg)


def make_world(cfg, params=None, device: torch.device | str = "cpu"):
    """The ground-truth world for `params` (default: the config's)."""
    params = params if params is not None else params_for_config(cfg)
    if isinstance(params, CartPoleParams):
        return CartPoleWorld(params, device)
    if isinstance(params, PendulumParams):
        return PendulumWorld(params, device)
    return PointMassWorld(params, device)


__all__ = [
    "WorldParams", "world_params_for_config", "params_for_config", "make_world",
    "PointMassWorld", "WorldState", "PendulumParams", "PendulumState", "PendulumWorld",
    "CartPoleParams", "CartPoleState", "CartPoleWorld",
]
