"""Rollout cost functions (torch counterpart of ``mppi_gpu_tpu.ops.cost``).

:class:`QuadraticCost` matches the reference's `Cost` (src/cost.cu:42-64):

    step(x', u, ε)  = λ · Σ_i u_i · Σ⁻¹_ii · ε_i  +  Σ_j w_j (x'_j − g_j)²
    final(x)        =                              Σ_j w_j (x_j  − g_j)²

with ``x'`` the state after applying ``u + ε``. The rollout total is
``Σ_{t<T} step(x_{t+1}, u_t, ε_t) + final(x_T)``: the terminal state cost is
counted twice, kept for reference parity.

A fleet's per-robot goals ride the cost's ``goal`` field with a leading
robot axis R (:func:`batch_goals`, the counterpart of
``mppi_gpu_tpu.batched._batch_goals``); ``step`` and ``final`` then take
states of shape (R, K, s).

Only ``quadratic`` is ported; the other registered cost types of the JAX
package raise ``NotImplementedError`` (ROADMAP.md, Open items §1 item 6).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig


@runtime_checkable
class Cost(Protocol):
    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """(..., s), (a,) or (..., a), (..., a) → (...) per-sample step cost."""

    def final(self, x: torch.Tensor) -> torch.Tensor:
        """(..., s) → (...) terminal cost."""


@dataclass(frozen=True)
class QuadraticCost:
    w: torch.Tensor        # (s,) state-cost diagonal
    goal: torch.Tensor     # (s,), or (R, s) per robot of a fleet
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    def _goal(self) -> torch.Tensor:
        # per-robot goals (R, s) meet states (R, K, s)
        return self.goal if self.goal.dim() == 1 else self.goal[..., None, :]

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        ctrl = self.lambda_ * torch.sum(u * self.inv_s * eps, dim=-1)
        d = x_next - self._goal()
        return ctrl + torch.sum(d * self.w * d, dim=-1)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        d = x - self._goal()
        return torch.sum(d * self.w * d, dim=-1)


def batch_goals(cost: Cost, goals: torch.Tensor, n_robots: int) -> Cost:
    """``cost`` with the (R, s) per-robot ``goals`` on its ``goal`` field.
    Raises ``TypeError`` for a cost without a ``goal`` field (its target is
    built in) and ``ValueError`` for goals that are not (n_robots, s)."""
    if not (dataclasses.is_dataclass(cost)
            and any(f.name == "goal" for f in dataclasses.fields(cost))):
        raise TypeError(
            f"per-robot goals need a cost with a 'goal' field; "
            f"{type(cost).__name__} has none (its target is built in)"
        )
    shape = (n_robots, cost.goal.shape[-1])
    if tuple(goals.shape) != shape:
        raise ValueError(f"goals must be {shape}, got {tuple(goals.shape)}")
    return dataclasses.replace(cost, goal=goals)


CostFactory = Callable[[MPPIConfig, torch.device], Cost]
COST_REGISTRY: dict[str, CostFactory] = {}

# cost types the JAX package registers that this package does not port yet
_UNPORTED_COSTS = (
    "obstacle", "pendulum", "unicycle", "arm", "cartpole", "quadrotor", "quadrotor3d",
)


def register_cost(name: str) -> Callable[[CostFactory], CostFactory]:
    def deco(fn: CostFactory) -> CostFactory:
        COST_REGISTRY[name] = fn
        return fn

    return deco


@register_cost("quadratic")
def _make_quadratic(cfg: MPPIConfig, device: torch.device | str) -> QuadraticCost:
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / torch.tensor(cfg.noise, **f32) ** 2
    else:  # reference parity: Σ⁻¹ = I
        inv_s = torch.ones(cfg.action_dim, **f32)
    return QuadraticCost(
        w=torch.tensor(cfg.cost_w, **f32),
        goal=torch.tensor(cfg.goal, **f32),
        lambda_=torch.tensor(cfg.lambda_, **f32),
        inv_s=inv_s,
    )


def make_cost(cfg: MPPIConfig, device: torch.device | str) -> Cost:
    if cfg.cost_type in COST_REGISTRY:
        return COST_REGISTRY[cfg.cost_type](cfg, device)
    if cfg.cost_type in _UNPORTED_COSTS:
        raise NotImplementedError(
            f"cost.type '{cfg.cost_type}' is not ported to mppi_gpu_tpu_torch yet "
            "(see ROADMAP.md, Open items §1 item 6)"
        )
    raise ValueError(
        f"unknown cost.type '{cfg.cost_type}'; known: {sorted(COST_REGISTRY)}"
    )
