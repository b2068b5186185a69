"""Planar quadrotor (birotor) dynamics (torch counterpart of
``mppi_gpu_tpu.models.quadrotor``).

State ``x = [px, pz, θ, vx, vz, ω]``: planar position, tilt (θ = 0 level),
linear and angular velocity. Action ``u = [F, D]`` in mixer space: the
collective thrust F = f_left + f_right and the differential
D = f_left − f_right.

    ẍ = F·sin θ / m,   z̈ = F·cos θ / m − g,   θ̈ = r·D / I

(r the rotor arm half-length, I the body inertia). Hover is the nonzero
nominal action u = (m·g, 0). One RK2 (midpoint) step of ``dt`` per horizon
step, the command held over the step; the model is unclamped, the
ground-truth world (``envs/quadrotor_world.py``) mixes and clamps each rotor.
The arithmetic follows the JAX model's order (it divides by m and I), and the
fused solve kernel's quadrotor step (``csrc/mppi_solve.cu``) follows this
one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class QuadrotorDynamics:
    dt: torch.Tensor       # 0-dim float32
    mass: torch.Tensor     # m (kg)
    inertia: torch.Tensor  # I about the body y axis (kg·m²)
    arm: torch.Tensor      # r, rotor arm half-length (m)
    gravity: torch.Tensor  # g (m/s²)
    state_dim: int = 6
    action_dim: int = 2

    @staticmethod
    def create(
        dt: float,
        mass: float = 0.8,
        inertia: float = 0.005,
        arm: float = 0.17,
        gravity: float = 9.81,
        device: torch.device | str = "cpu",
    ) -> "QuadrotorDynamics":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return QuadrotorDynamics(
            dt=f32(dt), mass=f32(mass), inertia=f32(inertia), arm=f32(arm), gravity=f32(gravity),
        )

    def accels(self, th: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(ẍ, z̈, θ̈) for tilt `th` and mixer command `u = [F, D]`."""
        F, D = u[..., 0], u[..., 1]
        ax = F * torch.sin(th) / self.mass
        az = F * torch.cos(th) / self.mass - self.gravity
        al = self.arm * D / self.inertia
        return ax, az, al

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        px, pz, th = x[..., 0], x[..., 1], x[..., 2]
        vx, vz, om = x[..., 3], x[..., 4], x[..., 5]
        h = self.dt
        # RK2 midpoint
        ax1, az1, al1 = self.accels(th, u)
        th_m = th + 0.5 * h * om
        ax2, az2, al2 = self.accels(th_m, u)
        vx_m, vz_m, om_m = vx + 0.5 * h * ax1, vz + 0.5 * h * az1, om + 0.5 * h * al1
        return torch.stack(
            [px + h * vx_m, pz + h * vz_m, th + h * om_m, vx + h * ax2, vz + h * az2,
             om + h * al2],
            dim=-1,
        )
