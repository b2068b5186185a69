"""Carry the JAX package's parameters across to the port.

The JAX package's models and costs, pulled out as numpy arrays, become the
port's models and costs, so that both packages compute with identical
float32 numbers (the tests use this).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.cartpole import CartPoleDynamics
from mppi_gpu_tpu_torch.models.pendulum import PendulumDynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.ops.cost import (
    CartPoleBalanceCost,
    Cost,
    PendulumSwingupCost,
    QuadraticCost,
)

# the numpy fields of each family's model and cost, keyed by the field of the
# model that tells the family apart
_FAMILIES = {
    "mass": (
        PendulumDynamics, ("dt", "mass", "length", "gravity", "damping"),
        PendulumSwingupCost, ("w_angle", "w_vel", "lambda_", "inv_s"),
    ),
    "cart_mass": (
        CartPoleDynamics, ("dt", "cart_mass", "pole_mass", "pole_length", "gravity"),
        CartPoleBalanceCost, ("w", "lambda_", "inv_s"),
    ),
}


def from_numpy(a, device: torch.device | str) -> torch.Tensor:
    """A float32 tensor on `device` from an array-like (state x, sequence U,
    noise ε, ...)."""
    return torch.as_tensor(np.array(a, np.float32), device=device)


def from_numpy_params(
    dyn: dict, cost: dict, device: torch.device | str, *, goals=None
) -> tuple[Dynamics, Cost]:
    """The port's model and cost from numpy arrays or scalars:

    * point-mass LTI: ``dyn = {"dt", "action_dim"}``, ``cost = {"w", "goal",
      "lambda_", "inv_s"}``; ``goals`` (R, s), such as the goal leaf of a JAX
      fleet's cost, replaces ``cost["goal"]`` with per-robot goals;
    * pendulum: ``dyn = {"dt", "mass", "length", "gravity", "damping"}``,
      ``cost = {"w_angle", "w_vel", "lambda_", "inv_s"}``;
    * cart-pole: ``dyn = {"dt", "cart_mass", "pole_mass", "pole_length",
      "gravity"}``, ``cost = {"w", "lambda_", "inv_s"}``.
    """
    for key, (model_cls, model_fields, cost_cls, cost_fields) in _FAMILIES.items():
        if key in dyn:
            if goals is not None:
                raise TypeError(f"{cost_cls.__name__} has no goal; goals= does not apply")
            return (
                model_cls(**{k: from_numpy(dyn[k], device) for k in model_fields}),
                cost_cls(**{k: from_numpy(cost[k], device) for k in cost_fields}),
            )
    model = PointMassLTI(dt=from_numpy(dyn["dt"], device), action_dim=int(dyn["action_dim"]))
    qc = QuadraticCost(
        w=from_numpy(cost["w"], device),
        goal=from_numpy(cost["goal"] if goals is None else goals, device),
        lambda_=from_numpy(cost["lambda_"], device),
        inv_s=from_numpy(cost["inv_s"], device),
    )
    return model, qc
