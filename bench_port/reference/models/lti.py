"""``lti``: the point mass on A independent axes, state [q, q̇], one step of
dt under the effective action u:  q' = q + dt q̇ + (dt²/2) u,  q̇' = q̇ + dt u.
Cost per step λ Σ_i U_i Σ⁻¹_ii ε_i + Σ_j w_j (x'_j − g_j)², and at the end
Σ_j w_j (x_j − g_j)² once more (the reference controller counts the final
state twice)."""

from __future__ import annotations

import torch


class Model:
    def __init__(self, cfg: dict, device, dtype) -> None:
        f = dict(dtype=dtype, device=device)
        self.A = int(cfg["action-dim"])
        self.dt = torch.tensor(float(cfg["dt"]), **f)
        self.w = torch.tensor(cfg["cost"]["w"], **f)
        self.goal = torch.tensor(cfg["goal"], **f)
        self.lam = float(cfg["lambda"])

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        a, dt = self.A, self.dt
        q, qd = x[..., :a], x[..., a:]
        return torch.cat([q + dt * qd + (0.5 * dt * dt) * u, qd + dt * u], dim=-1)

    def state_cost(self, x: torch.Tensor) -> torch.Tensor:
        d = x - self.goal
        return torch.sum(d * self.w * d, dim=-1)
