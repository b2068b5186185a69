"""Ground-truth unicycle world in torch (counterpart of
``mppi_gpu_tpu.envs.unicycle_world``): the controller model's kinematics
(``models/unicycle.py``) integrated with RK4 at a 10× finer timestep, with
the commanded forward speed and turn rate clamped, four physics steps per
control cycle of 1/60 s and 500 control cycles per episode. State is
float32, time included, like the JAX world. A fleet of R unicycles is one
state whose pose is (R, 3), under one shared clock or one clock per robot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.envs.base import ControlCadence, World, clock
from mppi_gpu_tpu_torch.ops.world_step import kernel_world


@dataclass(frozen=True)
class UnicycleParams(ControlCadence):
    max_v: float = 1.5             # forward-speed clamp (m/s)
    max_w: float = 2.5             # turn-rate clamp (rad/s)
    timestep: float = 0.005        # physics dt (RK4)
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001
    init_pose: tuple = (0.0, 0.0, 0.0)

    @property
    def state_dim(self) -> int:
        return 3


class UnicycleState(NamedTuple):
    pose: torch.Tensor  # (3,) float32 = [px, py, θ], or (R, 3) for a fleet
    time: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        return self.pose


@kernel_world
@dataclass(frozen=True)
class UnicycleWorld(World):
    params: UnicycleParams
    device: torch.device | str = "cpu"

    def kernel_params(self) -> tuple[str, dict[str, float]]:
        """K6's body and its parameters (csrc/world_step.cu, @pack
        unicycle), past the cadence."""
        return "unicycle", dict(max_v=self.params.max_v, max_w=self.params.max_w)

    @staticmethod
    def _deriv(pose, v, w):
        th = pose[..., 2]
        return torch.stack([v * torch.cos(th), v * torch.sin(th), w.expand(th.shape)], dim=-1)

    def physics_step(self, s: UnicycleState, u: torch.Tensor) -> UnicycleState:
        p = self.params
        h = p.timestep
        v = torch.clamp(u[..., 0], -p.max_v, p.max_v)
        w = torch.clamp(u[..., 1], -p.max_w, p.max_w)
        y = s.pose
        k1 = self._deriv(y, v, w)
        k2 = self._deriv(y + 0.5 * h * k1, v, w)
        k3 = self._deriv(y + 0.5 * h * k2, v, w)
        k4 = self._deriv(y + h * k3, v, w)
        return UnicycleState(pose=y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), time=s.time + h)

    def reset(self, n_robots: int | None = None) -> UnicycleState:
        """At init_pose, time = timestep; with `n_robots`, R unicycles so."""
        f32 = dict(dtype=torch.float32, device=self.device)
        p = self.params
        pose = torch.tensor(p.init_pose, **f32)
        if n_robots is not None:
            pose = pose.expand(n_robots, -1).contiguous()
        return UnicycleState(pose=pose, time=torch.tensor(p.timestep, **f32))

    def from_x(self, x: torch.Tensor, time) -> UnicycleState:
        """The state whose [px, py, θ] is `x` ((3,) or (R, 3)) at `time`."""
        return UnicycleState(pose=x, time=clock(time, x.device))
