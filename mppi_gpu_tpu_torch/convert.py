"""Carry the JAX package's parameters across to the port.

The JAX package's models and costs, pulled out as numpy arrays, become the
port's models and costs, so that both packages compute with identical
float32 numbers (the tests use this); so do its learned models, an
:class:`MLPDynamics` (:func:`mlp_from_numpy`) and a
:class:`HybridResidualDynamics` (:func:`hybrid_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_gpu_tpu_torch.models.arm import TwoLinkArmDynamics
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.cartpole import CartPoleDynamics
from mppi_gpu_tpu_torch.models.neural import HybridResidualDynamics, MLPDynamics
from mppi_gpu_tpu_torch.models.pendulum import PendulumDynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_gpu_tpu_torch.models.quadrotor3d import Quadrotor3DDynamics
from mppi_gpu_tpu_torch.models.unicycle import UnicycleDynamics
from mppi_gpu_tpu_torch.ops.cost import (
    ArmReachCost,
    CartPoleBalanceCost,
    Cost,
    ObstacleCost,
    PendulumSwingupCost,
    QuadraticCost,
    Quadrotor3DHoverCost,
    QuadrotorHoverCost,
    UnicycleWaypointCost,
    with_goal,
)

_GOAL_COST = ("w", "goal", "lambda_", "inv_s")
# the numpy fields of each family's model and cost, keyed by the set of the
# model's fields, which tells the families apart
_FAMILIES = {
    frozenset(("dt", "action_dim")): (PointMassLTI, QuadraticCost, _GOAL_COST),
    frozenset(("dt", "mass", "length", "gravity", "damping")): (
        PendulumDynamics, PendulumSwingupCost, ("w_angle", "w_vel", "lambda_", "inv_s"),
    ),
    frozenset(("dt", "cart_mass", "pole_mass", "pole_length", "gravity")): (
        CartPoleDynamics, CartPoleBalanceCost, ("w", "lambda_", "inv_s"),
    ),
    frozenset(("dt",)): (UnicycleDynamics, UnicycleWaypointCost, _GOAL_COST),
    frozenset(("dt", "mass", "inertia", "arm", "gravity")): (
        QuadrotorDynamics, QuadrotorHoverCost, _GOAL_COST,
    ),
    frozenset(("dt", "A", "B", "D", "G1", "G2", "damping", "max_rate", "l1", "l2")): (
        TwoLinkArmDynamics, ArmReachCost, _GOAL_COST + ("l1", "l2"),
    ),
    frozenset(("dt", "mass", "inertia", "gravity")): (
        Quadrotor3DDynamics, Quadrotor3DHoverCost, _GOAL_COST,
    ),
}
_OBSTACLE = ("centers", "radii", "penalty")


def from_numpy(a, device: torch.device | str) -> torch.Tensor:
    """A float32 tensor on `device` from an array-like (state x, sequence U,
    noise ε, ...)."""
    return torch.as_tensor(np.array(a, np.float32), device=device)


def from_numpy_params(
    dyn: dict, cost: dict, device: torch.device | str, *, goals=None
) -> tuple[Dynamics, Cost]:
    """The port's model and cost from numpy arrays or scalars; the keys of
    `dyn` name the family:

    * point-mass LTI: ``dyn = {"dt", "action_dim"}``, ``cost = {"w", "goal",
      "lambda_", "inv_s"}``;
    * pendulum: ``dyn = {"dt", "mass", "length", "gravity", "damping"}``,
      ``cost = {"w_angle", "w_vel", "lambda_", "inv_s"}``;
    * cart-pole: ``dyn = {"dt", "cart_mass", "pole_mass", "pole_length",
      "gravity"}``, ``cost = {"w", "lambda_", "inv_s"}``;
    * unicycle: ``dyn = {"dt"}``, ``cost = {"w", "goal", "lambda_", "inv_s"}``;
    * planar quadrotor: ``dyn = {"dt", "mass", "inertia", "arm", "gravity"}``,
      ``cost = {"w", "goal", "lambda_", "inv_s"}``;
    * two-link arm: ``dyn = {"dt", "A", "B", "D", "G1", "G2", "damping",
      "max_rate", "l1", "l2"}``, ``cost = {"w", "goal", "lambda_", "inv_s",
      "l1", "l2"}`` (the cost's own link lengths).

    For a cost with a goal, ``goals`` (R, s), such as the goal leaf of a JAX
    fleet's cost, replaces ``cost["goal"]`` with per-robot goals.
    """
    key = frozenset(dyn)
    if key not in _FAMILIES:
        raise ValueError(f"no family has the model fields {sorted(dyn)}")
    model_cls, cost_cls, cost_fields = _FAMILIES[key]
    if "base" in cost:
        _, base = from_numpy_params(dyn, cost["base"], device)
        out = ObstacleCost(base=base, **{k: from_numpy(cost[k], device) for k in _OBSTACLE})
    else:
        out = cost_cls(**{k: from_numpy(cost[k], device) for k in cost_fields})
    if goals is not None:
        if "goal" not in cost_fields:
            raise TypeError(f"{cost_cls.__name__} has no goal; goals= does not apply")
        out = with_goal(out, from_numpy(goals, device))
    return _model_from_numpy(model_cls, dyn, device), out


def _model_from_numpy(model_cls, dyn: dict, device) -> Dynamics:
    if model_cls is PointMassLTI:
        return PointMassLTI(dt=from_numpy(dyn["dt"], device), action_dim=int(dyn["action_dim"]))
    return model_cls(**{k: from_numpy(v, device) for k, v in dyn.items()})


def model_from_numpy(dyn: dict, device: torch.device | str) -> Dynamics:
    """The port's analytic model alone from numpy arrays or scalars, the
    keys of `dyn` naming the family as in :func:`from_numpy_params`."""
    key = frozenset(dyn)
    if key not in _FAMILIES:
        raise ValueError(f"no family has the model fields {sorted(dyn)}")
    return _model_from_numpy(_FAMILIES[key][0], dyn, device)


def mlp_from_numpy(mlp: dict, device: torch.device | str) -> MLPDynamics:
    """The port's :class:`MLPDynamics` from the JAX one's arrays: ``mlp =
    {"weights": [(in, out), ...], "biases": [(out,), ...], "residual_scale"}``
    and, where the JAX model standardises its inputs, ``"in_shift"`` and
    ``"in_scale"``."""
    shift, scale = mlp.get("in_shift"), mlp.get("in_scale")
    return MLPDynamics(
        [from_numpy(w, device) for w in mlp["weights"]],
        [from_numpy(b, device) for b in mlp["biases"]],
        from_numpy(mlp["residual_scale"], device),
        None if shift is None else from_numpy(shift, device),
        None if scale is None else from_numpy(scale, device),
    )


def hybrid_from_numpy(base: dict, mlp: dict, device: torch.device | str,
                      unit_norm_slice: tuple[int, int] | None = None) -> HybridResidualDynamics:
    """The port's :class:`HybridResidualDynamics`: the analytic model of the
    fields `base` (:func:`model_from_numpy`) and the net of `mlp`
    (:func:`mlp_from_numpy`)."""
    return HybridResidualDynamics(model_from_numpy(base, device), mlp_from_numpy(mlp, device),
                                  unit_norm_slice)
