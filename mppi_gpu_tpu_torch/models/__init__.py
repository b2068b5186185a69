"""Dynamics models usable inside the MPPI rollout.

Only the point-mass LTI family is ported so far; the other seven analytic
families and the neural models are still to port (ROADMAP.md, Open items §1).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI

_UNPORTED = ("arm", "unicycle", "cartpole", "pendulum", "quadrotor")


def dynamics_for_config(cfg, device: torch.device | str) -> Dynamics:
    """Default rollout model for a config's env family."""
    env = str(cfg.env)
    for family in _UNPORTED:
        if family in env:
            raise NotImplementedError(
                f"the '{family}' family is not ported to mppi_gpu_tpu_torch yet "
                "(see ROADMAP.md, Open items §1 item 6); only the point-mass "
                "LTI family runs"
            )
    return PointMassLTI.create(cfg.dt, cfg.action_dim, device)


__all__ = ["Dynamics", "PointMassLTI", "dynamics_for_config"]
