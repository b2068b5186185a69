"""Ground-truth planar-quadrotor world in torch (counterpart of
``mppi_gpu_tpu.envs.quadrotor_world``): the controller model's ODE
(``models/quadrotor.py``) integrated with RK4 at 1/240 s, four physics steps
per control cycle of 1/60 s and 500 control cycles per episode. The world is
the mixer and the rotors: the command (F, D) becomes per-rotor thrusts
(F ± D)/2, each clamped to [0, max_thrust] (the model is unclamped). State
is float32, time included, like the JAX world. A fleet of R quadrotors is
one state whose six leaves are (R,), under one shared clock or one clock per
robot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.envs.base import ControlCadence, World, clock


@dataclass(frozen=True)
class QuadrotorParams(ControlCadence):
    mass: float = 0.8
    inertia: float = 0.005
    arm: float = 0.17
    gravity: float = 9.81
    max_thrust: float = 8.0         # per rotor (N); hover needs m·g/2 ≈ 3.9 N
    timestep: float = 1.0 / 240.0   # physics dt (RK4)
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001
    init_x: float = -1.0            # start offset; the goal is the config's
    init_z: float = 0.0

    @property
    def state_dim(self) -> int:
        return 6


class QuadrotorState(NamedTuple):
    px: torch.Tensor  # 0-dim float32, or (R,) for a fleet
    pz: torch.Tensor
    th: torch.Tensor
    vx: torch.Tensor
    vz: torch.Tensor
    om: torch.Tensor
    time: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        """[px, pz, θ, vx, vz, ω]: (6,), or (R, 6) for a fleet."""
        return torch.stack([self.px, self.pz, self.th, self.vx, self.vz, self.om], dim=-1)


@dataclass(frozen=True)
class QuadrotorWorld(World):
    params: QuadrotorParams
    device: torch.device | str = "cpu"

    def _accels(self, th, f1, f2):
        """Accelerations from the left (f1) and right (f2) rotor thrusts."""
        p = self.params
        f_tot = f1 + f2
        ax = f_tot * torch.sin(th) / p.mass
        az = f_tot * torch.cos(th) / p.mass - p.gravity
        al = p.arm * (f1 - f2) / p.inertia
        return ax, az, al

    def physics_step(self, s: QuadrotorState, u: torch.Tensor) -> QuadrotorState:
        p = self.params
        h = p.timestep
        F, D = u[..., 0], u[..., 1]
        u1 = torch.clamp(0.5 * (F + D), 0.0, p.max_thrust)
        u2 = torch.clamp(0.5 * (F - D), 0.0, p.max_thrust)

        def deriv(px, pz, th, vx, vz, om):
            return (vx, vz, om, *self._accels(th, u1, u2))

        y = (s.px, s.pz, s.th, s.vx, s.vz, s.om)
        k1 = deriv(*y)
        k2 = deriv(*(yi + 0.5 * h * ki for yi, ki in zip(y, k1)))
        k3 = deriv(*(yi + 0.5 * h * ki for yi, ki in zip(y, k2)))
        k4 = deriv(*(yi + h * ki for yi, ki in zip(y, k3)))
        px, pz, th, vx, vz, om = (
            yi + (h / 6.0) * (a + 2 * b + 2 * c + d)
            for yi, a, b, c, d in zip(y, k1, k2, k3, k4)
        )
        return QuadrotorState(px=px, pz=pz, th=th, vx=vx, vz=vz, om=om, time=s.time + h)

    def reset(self, n_robots: int | None = None) -> QuadrotorState:
        """At (init_x, init_z), level, at rest, time = timestep; with
        `n_robots`, R quadrotors so."""
        f32 = dict(dtype=torch.float32, device=self.device)
        p = self.params
        shape = () if n_robots is None else (n_robots,)
        z = torch.zeros(shape, **f32)
        return QuadrotorState(
            px=torch.full(shape, p.init_x, **f32), pz=torch.full(shape, p.init_z, **f32), th=z,
            vx=z, vz=z, om=z, time=torch.tensor(p.timestep, **f32),
        )

    def from_x(self, x: torch.Tensor, time) -> QuadrotorState:
        """The state whose [px, pz, θ, vx, vz, ω] is `x` ((6,) or (R, 6)) at
        `time`."""
        return QuadrotorState(*x.unbind(-1), time=clock(time, x.device))
