"""Unicycle / differential-drive robot (torch counterpart of
``mppi_gpu_tpu.models.unicycle``).

State ``x = [px, py, θ]`` (planar pose), action ``u = [v, ω]`` (forward speed
and turn rate):

    ṗx = v·cos θ,   ṗy = v·sin θ,   θ̇ = ω

integrated with one RK2 (midpoint) step of ``dt`` per horizon step: the
heading advances to the midpoint angle first. The first family whose state
dimension (3) is not twice its action dimension. The ground-truth world
(``envs/unicycle_world.py``) integrates the same kinematics with RK4 at a
finer timestep. The arithmetic follows the JAX model's order, and the fused
solve kernel's unicycle step (``csrc/mppi_solve.cu``) follows this one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class UnicycleDynamics:
    dt: torch.Tensor  # 0-dim float32 integration step per horizon step
    state_dim: int = 3
    action_dim: int = 2

    @staticmethod
    def create(dt: float, device: torch.device | str = "cpu") -> "UnicycleDynamics":
        return UnicycleDynamics(dt=torch.tensor(dt, dtype=torch.float32, device=device))

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        px, py, th = x[..., 0], x[..., 1], x[..., 2]
        v, w = u[..., 0], u[..., 1]
        h = self.dt
        th_m = th + 0.5 * h * w  # midpoint heading
        return torch.stack(
            [px + h * v * torch.cos(th_m), py + h * v * torch.sin(th_m), th + h * w], dim=-1
        )
