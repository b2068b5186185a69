"""Ground-truth pendulum world in torch (counterpart of
``mppi_gpu_tpu.envs.pendulum_world``): the controller model's ODE
(``models/pendulum.py``) integrated with RK4 at a 10× finer timestep, with the
actuator clamp, four physics steps per control cycle of 1/60 s and 500
control cycles per episode. State is float32, time included, like the JAX
world. A fleet of R pendulums is one state whose θ and θ̇ are (R,), under one
shared clock or one clock per robot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.envs.base import ControlCadence, World, clock
from mppi_gpu_tpu_torch.ops.world_step import Reciprocal, kernel_world


@dataclass(frozen=True)
class PendulumParams(ControlCadence):
    mass: float = 1.0
    length: float = 1.0
    gravity: float = 9.81
    damping: float = 0.1
    max_torque: float = 2.0         # actuator clamp (underactuated: < m·g·l)
    timestep: float = 0.005         # physics dt (RK4)
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001
    init_theta: float = 3.14159265  # hanging down

    @property
    def state_dim(self) -> int:
        return 2


class PendulumState(NamedTuple):
    th: torch.Tensor    # 0-dim float32, or (R,) for a fleet
    thd: torch.Tensor
    time: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        """[θ, θ̇]: (2,), or (R, 2) for a fleet."""
        return torch.stack([self.th, self.thd], dim=-1)


@kernel_world
@dataclass(frozen=True)
class PendulumWorld(World):
    params: PendulumParams
    device: torch.device | str = "cpu"

    def kernel_params(self) -> tuple[str, dict[str, float]]:
        """K6's body and its parameters (csrc/world_step.cu, @pack
        pendulum), past the cadence."""
        p = self.params
        return "pendulum", dict(max_torque=p.max_torque, g_over_l=p.gravity / p.length,
                                inv_ml2=Reciprocal(p.mass * p.length**2), damping=p.damping)

    def _accel(self, th, thd, u):
        p = self.params
        return (
            (p.gravity / p.length) * torch.sin(th)
            + u / (p.mass * p.length**2)
            - p.damping * thd
        )

    def physics_step(self, s: PendulumState, u: torch.Tensor) -> PendulumState:
        p = self.params
        h = p.timestep
        u0 = torch.clamp(u[..., 0], -p.max_torque, p.max_torque)
        th, thd = s.th, s.thd
        k1t, k1v = thd, self._accel(th, thd, u0)
        k2t, k2v = thd + 0.5 * h * k1v, self._accel(th + 0.5 * h * k1t, thd + 0.5 * h * k1v, u0)
        k3t, k3v = thd + 0.5 * h * k2v, self._accel(th + 0.5 * h * k2t, thd + 0.5 * h * k2v, u0)
        k4t, k4v = thd + h * k3v, self._accel(th + h * k3t, thd + h * k3v, u0)
        return PendulumState(
            th=th + (h / 6.0) * (k1t + 2 * k2t + 2 * k3t + k4t),
            thd=thd + (h / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v),
            time=s.time + h,
        )

    def reset(self, n_robots: int | None = None) -> PendulumState:
        """Hanging down at rest, time = timestep; with `n_robots`, R pendulums
        so."""
        f32 = dict(dtype=torch.float32, device=self.device)
        p = self.params
        shape = () if n_robots is None else (n_robots,)
        return PendulumState(
            th=torch.full(shape, p.init_theta, **f32), thd=torch.zeros(shape, **f32),
            time=torch.tensor(p.timestep, **f32),
        )

    def from_x(self, x: torch.Tensor, time) -> PendulumState:
        """The state whose [θ, θ̇] is `x` ((2,) or (R, 2)) at `time`."""
        return PendulumState(th=x[..., 0], thd=x[..., 1], time=clock(time, x.device))
