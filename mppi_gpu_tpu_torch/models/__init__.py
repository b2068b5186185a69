"""Dynamics models usable inside the MPPI rollout.

The point-mass LTI, pendulum, cart-pole, unicycle, planar-quadrotor,
two-link-arm and 3-D quadrotor families are ported; the neural models are
still to port (ROADMAP.md, Open items §1 item 8).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.models.arm import TwoLinkArmDynamics
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.cartpole import CartPoleDynamics
from mppi_gpu_tpu_torch.models.pendulum import PendulumDynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_gpu_tpu_torch.models.quadrotor3d import Quadrotor3DDynamics
from mppi_gpu_tpu_torch.models.unicycle import UnicycleDynamics

# (substring of the config's env, model factory), in the order of
# mppi_gpu_tpu.models.dynamics_for_config ("quadrotor3d" before "quadrotor");
# anything else is LTI
_FAMILIES = (
    ("arm", TwoLinkArmDynamics.create),
    ("unicycle", UnicycleDynamics.create),
    ("cartpole", CartPoleDynamics.create),
    ("pendulum", PendulumDynamics.create),
    ("quadrotor3d", Quadrotor3DDynamics.create),
    ("quadrotor", QuadrotorDynamics.create),
)


def dynamics_for_config(cfg, device: torch.device | str) -> Dynamics:
    """Default rollout model for a config's env family."""
    env = str(cfg.env)
    for family, create in _FAMILIES:
        if family in env:
            return create(cfg.dt, device=device)
    return PointMassLTI.create(cfg.dt, cfg.action_dim, device)


__all__ = [
    "Dynamics", "PointMassLTI", "PendulumDynamics", "CartPoleDynamics", "UnicycleDynamics",
    "QuadrotorDynamics", "Quadrotor3DDynamics", "TwoLinkArmDynamics", "dynamics_for_config",
]
