"""Dynamics models usable inside the MPPI rollout.

The point-mass LTI, pendulum and cart-pole families are ported; the other
analytic families and the neural models are still to port (ROADMAP.md, Open
items §1).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.cartpole import CartPoleDynamics
from mppi_gpu_tpu_torch.models.pendulum import PendulumDynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI

# (substring of the config's env, model factory or None while unported), in
# the order of mppi_gpu_tpu.models.dynamics_for_config; anything else is LTI
_FAMILIES = (
    ("arm", None),
    ("unicycle", None),
    ("cartpole", CartPoleDynamics.create),
    ("pendulum", PendulumDynamics.create),
    ("quadrotor3d", None),
    ("quadrotor", None),
)


def dynamics_for_config(cfg, device: torch.device | str) -> Dynamics:
    """Default rollout model for a config's env family."""
    env = str(cfg.env)
    for family, create in _FAMILIES:
        if family not in env:
            continue
        if create is None:
            raise NotImplementedError(
                f"the '{family}' family is not ported to mppi_gpu_tpu_torch yet "
                "(see ROADMAP.md, Open items §1 item 6); the point-mass LTI, "
                "pendulum and cart-pole families run"
            )
        return create(cfg.dt, device=device)
    return PointMassLTI.create(cfg.dt, cfg.action_dim, device)


__all__ = [
    "Dynamics", "PointMassLTI", "PendulumDynamics", "CartPoleDynamics",
    "dynamics_for_config",
]
