"""Carry the JAX package's parameters across to the port.

The JAX package's models and costs, pulled out as numpy arrays, become the
port's :class:`PointMassLTI` and :class:`QuadraticCost`, so that both
packages compute with identical float32 numbers (the tests use this).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.ops.cost import QuadraticCost


def from_numpy(a, device: torch.device | str) -> torch.Tensor:
    """A float32 tensor on `device` from an array-like (state x, sequence U,
    noise ε, ...)."""
    return torch.as_tensor(np.array(a, np.float32), device=device)


def from_numpy_params(
    dyn: dict, cost: dict, device: torch.device | str, *, goals=None
) -> tuple[PointMassLTI, QuadraticCost]:
    """``dyn = {"dt", "action_dim"}``, ``cost = {"w", "goal", "lambda_",
    "inv_s"}`` (numpy arrays or scalars) → the port's model and cost.
    ``goals`` (R, s), such as the goal leaf of a JAX fleet's cost
    (``BatchedMPPIController(..., goals=...).cost.goal``), replaces
    ``cost["goal"]`` with per-robot goals."""
    model = PointMassLTI(dt=from_numpy(dyn["dt"], device), action_dim=int(dyn["action_dim"]))
    qc = QuadraticCost(
        w=from_numpy(cost["w"], device),
        goal=from_numpy(cost["goal"] if goals is None else goals, device),
        lambda_=from_numpy(cost["lambda_"], device),
        inv_s=from_numpy(cost["inv_s"], device),
    )
    return model, qc
