"""Analytic LTI point-mass (double-integrator) dynamics.

Per action dim ``i`` (state ``x = [q_0..q_{a-1}, qd_0..qd_{a-1}]``):

    q_i'  = q_i + dt * qd_i + (dt^2 / 2) * u_i
    qd_i' =            qd_i +  dt        * u_i

``u`` is the effective action (nominal + sampled noise). Same semantics as
``mppi_gpu_tpu.models.point_mass.PointMassLTI``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PointMassLTI:
    """Double integrator in ``action_dim`` independent axes."""

    dt: torch.Tensor  # 0-dim float32, on the solve's device
    action_dim: int

    @property
    def state_dim(self) -> int:
        return 2 * self.action_dim

    @staticmethod
    def create(dt: float, action_dim: int, device: torch.device | str) -> "PointMassLTI":
        return PointMassLTI(
            dt=torch.tensor(dt, dtype=torch.float32, device=device),
            action_dim=action_dim,
        )

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        a = self.action_dim
        q, qd = x[..., :a], x[..., a:]
        dt = self.dt
        q1 = q + dt * qd + (0.5 * dt * dt) * u
        qd1 = qd + dt * u
        return torch.cat([q1, qd1], dim=-1)
