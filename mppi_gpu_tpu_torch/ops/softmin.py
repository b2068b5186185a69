"""Softmin weighting of rollout costs.

    β   = min_k S_k
    e_k = exp(−(S_k − β) / λ)
    η   = Σ_k e_k
    w_k = e_k / η

When every rollout cost is +inf, β − S = inf − inf = NaN propagates to the
weights and the action, so ``utils.guard.ControllerDiverged`` fires.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SoftminResult(NamedTuple):
    weights: torch.Tensor  # (K,)
    beta: torch.Tensor     # 0-dim
    eta: torch.Tensor      # 0-dim


def softmin_weights(costs: torch.Tensor, lambda_: torch.Tensor | float) -> SoftminResult:
    beta = torch.min(costs)
    e = torch.exp(-(costs - beta) / lambda_)
    eta = torch.sum(e)
    return SoftminResult(weights=e / eta, beta=beta, eta=eta)
