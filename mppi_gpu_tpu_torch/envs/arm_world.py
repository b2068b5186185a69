"""Ground-truth two-link-arm world in torch (counterpart of
``mppi_gpu_tpu.envs.arm_world``): the controller model's manipulator
equations (the world calls ``TwoLinkArmDynamics._deriv`` and ``_sat`` of
``models/arm.py``, so the constants cannot drift apart) integrated with RK4
at 5 ms, the joint rates saturated after each step, the commanded torques
clamped per joint, four physics steps per control cycle of 1/60 s and 500
control cycles per episode, starting from the arm hanging straight down.
State is float32, time included, like the JAX world. A fleet of R arms is
one state whose q is (R, 4), under one shared clock or one clock per robot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.envs.base import ControlCadence, World, clock
from mppi_gpu_tpu_torch.models.arm import TwoLinkArmDynamics


@dataclass(frozen=True)
class ArmParams(ControlCadence):
    max_t1: float = 10.0          # shoulder torque clamp (N·m)
    max_t2: float = 5.0           # elbow torque clamp (N·m)
    timestep: float = 0.005       # physics dt (RK4)
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001
    init_state: tuple = (-1.5707963, 0.0, 0.0, 0.0)  # hanging straight down
    # physical constants (TwoLinkArmDynamics.create's defaults)
    m1: float = 1.0
    m2: float = 1.0
    l1: float = 0.5
    l2: float = 0.5
    damping: float = 0.05
    gravity: float = 9.81
    max_rate: float = 12.0

    @property
    def state_dim(self) -> int:
        return 4


class ArmState(NamedTuple):
    q: torch.Tensor  # (4,) float32 = [q1, q2, q̇1, q̇2], or (R, 4) for a fleet
    time: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        return self.q


@dataclass(frozen=True)
class ArmWorld(World):
    params: ArmParams
    device: torch.device | str = "cpu"

    def __post_init__(self) -> None:
        # the model's dt is unused here: the world integrates with its own RK4
        p = self.params
        object.__setattr__(self, "_dyn", TwoLinkArmDynamics.create(
            p.timestep, m1=p.m1, m2=p.m2, l1=p.l1, l2=p.l2, damping=p.damping,
            gravity=p.gravity, max_rate=p.max_rate, device=self.device,
        ))

    def physics_step(self, s: ArmState, u: torch.Tensor) -> ArmState:
        p = self.params
        h = p.timestep
        u = torch.stack([
            torch.clamp(u[..., 0], -p.max_t1, p.max_t1),
            torch.clamp(u[..., 1], -p.max_t2, p.max_t2),
        ], dim=-1)
        y = s.q
        k1 = self._dyn._deriv(y, u)
        k2 = self._dyn._deriv(y + 0.5 * h * k1, u)
        k3 = self._dyn._deriv(y + 0.5 * h * k2, u)
        k4 = self._dyn._deriv(y + h * k3, u)
        return ArmState(
            q=self._dyn._sat(y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)), time=s.time + h
        )

    def reset(self, n_robots: int | None = None) -> ArmState:
        """Hanging straight down at rest, time = timestep; with `n_robots`, R
        arms so."""
        f32 = dict(dtype=torch.float32, device=self.device)
        p = self.params
        q = torch.tensor(p.init_state, **f32)
        if n_robots is not None:
            q = q.expand(n_robots, -1).contiguous()
        return ArmState(q=q, time=torch.tensor(p.timestep, **f32))

    def from_x(self, x: torch.Tensor, time) -> ArmState:
        """The state whose [q1, q2, q̇1, q̇2] is `x` ((4,) or (R, 4)) at
        `time`."""
        return ArmState(q=x, time=clock(time, x.device))
