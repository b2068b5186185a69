"""Torque-limited pendulum (swing-up) dynamics (torch counterpart of
``mppi_gpu_tpu.models.pendulum``).

State ``x = [θ, θ̇]`` with θ measured from upright (θ = 0 balanced, θ = π
hanging down), action ``u`` = motor torque:

    θ̈ = (g / l) · sin θ  +  u / (m l²)  −  b · θ̇

integrated with one RK2 (midpoint) step of ``dt`` per horizon step; the
ground-truth world (``envs/pendulum_world.py``) integrates the same ODE with
RK4 at a finer timestep. The arithmetic follows the JAX model's order, and
the fused solve kernel's pendulum step (``csrc/mppi_solve.cu``) follows this
one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PendulumDynamics:
    dt: torch.Tensor       # 0-dim float32 integration step per horizon step
    mass: torch.Tensor     # m (kg)
    length: torch.Tensor   # l (m)
    gravity: torch.Tensor  # g (m/s²)
    damping: torch.Tensor  # b (1/s)
    state_dim: int = 2
    action_dim: int = 1

    @staticmethod
    def create(
        dt: float,
        mass: float = 1.0,
        length: float = 1.0,
        gravity: float = 9.81,
        damping: float = 0.1,
        device: torch.device | str = "cpu",
    ) -> "PendulumDynamics":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return PendulumDynamics(
            dt=f32(dt), mass=f32(mass), length=f32(length), gravity=f32(gravity),
            damping=f32(damping),
        )

    def accel(self, th: torch.Tensor, thd: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return (
            (self.gravity / self.length) * torch.sin(th)
            + u / (self.mass * self.length**2)
            - self.damping * thd
        )

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        th, thd = x[..., 0], x[..., 1]
        u0 = u[..., 0]
        h = self.dt
        # RK2 midpoint
        k1_th, k1_thd = thd, self.accel(th, thd, u0)
        th_m = th + 0.5 * h * k1_th
        thd_m = thd + 0.5 * h * k1_thd
        k2_th, k2_thd = thd_m, self.accel(th_m, thd_m, u0)
        return torch.stack([th + h * k2_th, thd + h * k2_thd], dim=-1)
