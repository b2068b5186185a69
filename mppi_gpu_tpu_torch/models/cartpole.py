"""Cart-pole dynamics (torch counterpart of ``mppi_gpu_tpu.models.cartpole``).

State ``x = [p, θ, ṗ, θ̇]`` with θ from upright, action ``u`` = horizontal
force on the cart. Frictionless cart-pole (pole pivoting on the cart):

    a   = (u + m_p l θ̇² sin θ) / (m_c + m_p)
    θ̈  = (g sin θ − cos θ · a) / (l (4/3 − m_p cos²θ / (m_c + m_p)))
    p̈  = a − m_p l θ̈ cos θ / (m_c + m_p)

integrated with one RK2 (midpoint) step of ``dt`` per horizon step; the
ground-truth world (``envs/cartpole_world.py``) uses RK4 at a finer
timestep. The arithmetic follows the JAX model's order, and the fused solve
kernel's cart-pole step (``csrc/mppi_solve.cu``) follows this one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CartPoleDynamics:
    dt: torch.Tensor           # 0-dim float32
    cart_mass: torch.Tensor
    pole_mass: torch.Tensor
    pole_length: torch.Tensor  # half-length l of the pole
    gravity: torch.Tensor
    state_dim: int = 4
    action_dim: int = 1

    @staticmethod
    def create(
        dt: float,
        cart_mass: float = 1.0,
        pole_mass: float = 0.1,
        pole_length: float = 0.5,
        gravity: float = 9.81,
        device: torch.device | str = "cpu",
    ) -> "CartPoleDynamics":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return CartPoleDynamics(
            dt=f32(dt), cart_mass=f32(cart_mass), pole_mass=f32(pole_mass),
            pole_length=f32(pole_length), gravity=f32(gravity),
        )

    def accel(self, th, thd, u) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (p̈, θ̈)."""
        mc, mp, l, g = self.cart_mass, self.pole_mass, self.pole_length, self.gravity
        total = mc + mp
        s, c = torch.sin(th), torch.cos(th)
        a = (u + mp * l * thd**2 * s) / total
        thdd = (g * s - c * a) / (l * (4.0 / 3.0 - mp * c**2 / total))
        pdd = a - mp * l * thdd * c / total
        return pdd, thdd

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p, th, pd, thd = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        u0 = u[..., 0]
        h = self.dt
        # RK2 midpoint
        pdd1, thdd1 = self.accel(th, thd, u0)
        th_m = th + 0.5 * h * thd
        thd_m = thd + 0.5 * h * thdd1
        pdd2, thdd2 = self.accel(th_m, thd_m, u0)
        pd_m = pd + 0.5 * h * pdd1
        return torch.stack(
            [p + h * pd_m, th + h * thd_m, pd + h * pdd2, thd + h * thdd2], dim=-1
        )
