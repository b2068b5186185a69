"""Two-link planar manipulator (torch counterpart of
``mppi_gpu_tpu.models.arm``).

State ``x = [q1, q2, qd1, qd2]`` (shoulder angle from the +x axis, elbow
angle relative to link 1, joint rates), action ``u = [τ1, τ2]`` (joint
torques). The manipulator equations ``M(q)·q̈ + C(q, q̇)·q̇ + φ(q) + b·q̇ = τ``
with the closed-form inverse of the 2×2 mass matrix:

    M = [A + 2B·c2   D + B·c2]      C·q̇ = [−B·s2·(2·q̇1·q̇2 + q̇2²)]
        [D + B·c2    D       ]            [ B·s2·q̇1²            ]
    φ = [G1·cos q1 + G2·cos(q1+q2), G2·cos(q1+q2)]

with the five constants A, B, D, G1, G2 computed once by :meth:`create`.
One RK2 (midpoint) step of ``dt`` per horizon step with the joint rates
saturated at ±max_rate after each stage. The saturation lets NaN through, as
``jnp.clip`` does, so a diverged rollout is NaN on every backend. Gravity
acts in the plane (−y). The ground-truth world (``envs/arm_world.py``)
integrates the same equations with RK4 at a finer timestep. The arithmetic
follows the JAX model's order (one divide for 1/det, then products), and the
fused solve kernel's arm step (``csrc/mppi_solve.cu``) follows this one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TwoLinkArmDynamics:
    dt: torch.Tensor        # 0-dim float32
    A: torch.Tensor         # I1 + I2 + m1·lc1² + m2·(l1² + lc2²)
    B: torch.Tensor         # m2·l1·lc2
    D: torch.Tensor         # I2 + m2·lc2²
    G1: torch.Tensor        # (m1·lc1 + m2·l1)·g
    G2: torch.Tensor        # m2·lc2·g
    damping: torch.Tensor   # viscous joint damping b
    max_rate: torch.Tensor  # joint-rate saturation (rad/s)
    l1: torch.Tensor        # link lengths (forward kinematics)
    l2: torch.Tensor
    state_dim: int = 4
    action_dim: int = 2

    @staticmethod
    def create(
        dt: float,
        m1: float = 1.0,
        m2: float = 1.0,
        l1: float = 0.5,
        l2: float = 0.5,
        damping: float = 0.05,
        gravity: float = 9.81,
        max_rate: float = 12.0,
        device: torch.device | str = "cpu",
    ) -> "TwoLinkArmDynamics":
        """The five constants in double precision, then rounded to float32,
        as the JAX model computes them."""
        lc1, lc2 = 0.5 * l1, 0.5 * l2
        i1, i2 = m1 * l1 * l1 / 12.0, m2 * l2 * l2 / 12.0

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return TwoLinkArmDynamics(
            dt=f32(dt),
            A=f32(i1 + i2 + m1 * lc1 * lc1 + m2 * (l1 * l1 + lc2 * lc2)),
            B=f32(m2 * l1 * lc2),
            D=f32(i2 + m2 * lc2 * lc2),
            G1=f32((m1 * lc1 + m2 * l1) * gravity),
            G2=f32(m2 * lc2 * gravity),
            damping=f32(damping),
            max_rate=f32(max_rate),
            l1=f32(l1),
            l2=f32(l2),
        )

    def _deriv(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        q1, q2 = x[..., 0], x[..., 1]
        qd1, qd2 = x[..., 2], x[..., 3]
        t1, t2 = u[..., 0], u[..., 1]
        s2, c2 = torch.sin(q2), torch.cos(q2)
        c1, c12 = torch.cos(q1), torch.cos(q1 + q2)
        d11 = self.A + 2.0 * self.B * c2
        d12 = self.D + self.B * c2
        # right-hand side τ − C·q̇ − φ − b·q̇
        hs = self.B * s2
        r1 = t1 + hs * (2.0 * qd1 * qd2 + qd2 * qd2) \
            - (self.G1 * c1 + self.G2 * c12) - self.damping * qd1
        r2 = t2 - hs * qd1 * qd1 - self.G2 * c12 - self.damping * qd2
        inv_det = 1.0 / (d11 * self.D - d12 * d12)
        qdd1 = (self.D * r1 - d12 * r2) * inv_det
        qdd2 = (d11 * r2 - d12 * r1) * inv_det
        return torch.stack([qd1, qd2, qdd1, qdd2], dim=-1)

    def _sat(self, x: torch.Tensor) -> torch.Tensor:
        """Joint-rate saturation (after each integration stage); NaN stays
        NaN."""
        qd = torch.minimum(torch.maximum(x[..., 2:], -self.max_rate), self.max_rate)
        return torch.cat([x[..., :2], qd], dim=-1)

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        h = self.dt
        x_m = self._sat(x + 0.5 * h * self._deriv(x, u))
        return self._sat(x + h * self._deriv(x_m, u))

    def end_effector(self, x: torch.Tensor) -> torch.Tensor:
        """Forward kinematics: the planar end-effector position (..., 2)."""
        q1, q12 = x[..., 0], x[..., 0] + x[..., 1]
        return torch.stack(
            [self.l1 * torch.cos(q1) + self.l2 * torch.cos(q12),
             self.l1 * torch.sin(q1) + self.l2 * torch.sin(q12)],
            dim=-1,
        )
