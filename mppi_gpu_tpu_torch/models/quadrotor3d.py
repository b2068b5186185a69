"""Full 3-D quadrotor dynamics, a quaternion rigid body (torch counterpart of
``mppi_gpu_tpu.models.quadrotor3d``).

State ``x = [p(3), q(4), v(3), ω(3)]`` (13): world position, unit quaternion
body→world (w, x, y, z), world linear velocity, body angular velocity.
Action ``u = [F, τx, τy, τz]`` in mixer space: collective thrust along body
+z and body torques. With the diagonal inertia J = diag(Jx, Jy, Jz):

    ṗ = v,   v̇ = R(q)ẑ · F/m − g ẑ,   q̇ = ½ q ⊗ (0, ω),   ω̇ = J⁻¹ (τ − ω × Jω)

One RK2 (midpoint) step of ``dt`` per horizon step, the command held over
the step, and one quaternion renormalisation (``torch.rsqrt``) at the end of
the step, none at the midpoint. The model is unclamped; the ground-truth
world (``envs/quadrotor3d_world.py``) mixes and clamps each rotor. The
arithmetic follows the JAX model's order (it divides by m and by Jx, Jy, Jz)
with the quaternion's squared norm summed left to right, and the fused solve
kernel's 3-D quadrotor step (``csrc/mppi_solve.cu``) follows this one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Quadrotor3DDynamics:
    dt: torch.Tensor       # 0-dim float32
    mass: torch.Tensor     # m (kg)
    inertia: torch.Tensor  # (3,) diagonal of J (kg·m²)
    gravity: torch.Tensor  # g (m/s²)
    state_dim: int = 13
    action_dim: int = 4

    @staticmethod
    def create(
        dt: float,
        mass: float = 0.8,
        inertia: tuple[float, float, float] = (0.005, 0.005, 0.009),
        gravity: float = 9.81,
        device: torch.device | str = "cpu",
    ) -> "Quadrotor3DDynamics":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return Quadrotor3DDynamics(dt=f32(dt), mass=f32(mass), inertia=f32(inertia),
                                   gravity=f32(gravity))

    def derivs(self, q: torch.Tensor, v: torch.Tensor, om: torch.Tensor, u: torch.Tensor):
        """(q̇, v̇, ω̇); ṗ is v. `q` (..., 4) need not be unit (the midpoint's
        is not): the thrust direction then scales with |q|²."""
        qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        wx, wy, wz = om[..., 0], om[..., 1], om[..., 2]
        fm = u[..., 0] / self.mass
        acc = torch.stack([
            2.0 * (qx * qz + qw * qy) * fm,
            2.0 * (qy * qz - qw * qx) * fm,
            (1.0 - 2.0 * (qx * qx + qy * qy)) * fm - self.gravity,
        ], dim=-1)
        qdot = 0.5 * torch.stack([
            -(qx * wx + qy * wy + qz * wz),
            qw * wx + qy * wz - qz * wy,
            qw * wy + qz * wx - qx * wz,
            qw * wz + qx * wy - qy * wx,
        ], dim=-1)
        jx, jy, jz = self.inertia[0], self.inertia[1], self.inertia[2]
        omdot = torch.stack([
            (u[..., 1] - (jz - jy) * wy * wz) / jx,
            (u[..., 2] - (jx - jz) * wz * wx) / jy,
            (u[..., 3] - (jy - jx) * wx * wy) / jz,
        ], dim=-1)
        return qdot, acc, omdot

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p, q, v, om = x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13]
        h = self.dt
        # RK2 midpoint
        qd1, a1, wd1 = self.derivs(q, v, om, u)
        q_m = q + 0.5 * h * qd1
        v_m = v + 0.5 * h * a1
        om_m = om + 0.5 * h * wd1
        qd2, a2, wd2 = self.derivs(q_m, v_m, om_m, u)
        q_n = q + h * qd2
        n2 = q_n[..., 0] * q_n[..., 0] + q_n[..., 1] * q_n[..., 1]
        n2 = n2 + q_n[..., 2] * q_n[..., 2] + q_n[..., 3] * q_n[..., 3]
        q_n = q_n * torch.rsqrt(n2)[..., None]
        return torch.cat([p + h * v_m, q_n, v + h * a2, om + h * wd2], dim=-1)
