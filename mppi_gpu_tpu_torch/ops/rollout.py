"""Batched stochastic rollouts in the flat layout: state ``(K, s)``, noise
``(T, K, a)`` (torch counterpart of ``mppi_gpu_tpu.ops.rollout``).

The whole batch advances together, one Python step per horizon step. This is
the eager path and the plain version the fused CUDA solve is checked against
(``ops/fused_solve.py``).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.ops.cost import Cost


def rollout_costs(
    dyn: Dynamics,
    cost: Cost,
    x0: torch.Tensor,   # (s,) initial state shared by every rollout
    U: torch.Tensor,    # (T, a) nominal action sequence
    eps: torch.Tensor,  # (T, K, a) sampled action noise
) -> torch.Tensor:
    """Total cost per rollout: (K,)."""
    return rollout_trajectories(dyn, cost, x0, U, eps, keep_states=False)[0]


def rollout_trajectories(
    dyn: Dynamics,
    cost: Cost,
    x0: torch.Tensor,
    U: torch.Tensor,
    eps: torch.Tensor,
    *,
    keep_states: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Debug path: (costs (K,), xs (T+1, K, s)); ``xs`` is None without
    ``keep_states``."""
    T, K, _ = eps.shape
    x = x0.to(torch.float32).expand(K, x0.shape[-1])
    xs = [x] if keep_states else None
    cs = []
    for t in range(T):
        x = dyn.step(x, U[t] + eps[t])
        cs.append(cost.step(x, U[t], eps[t]))
        if keep_states:
            xs.append(x)
    S = torch.sum(torch.stack(cs), dim=0) + cost.final(x)
    return S, (torch.stack(xs) if keep_states else None)
