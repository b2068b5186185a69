"""Ground-truth 3-D quadrotor world in torch (counterpart of
``mppi_gpu_tpu.envs.quadrotor3d_world``): the controller model's rigid-body
ODE (``models/quadrotor3d.py``) behind the mixer and the rotors. The command
[F, τx, τy, τz] becomes four per-rotor thrusts ("+" configuration, arm r,
yaw drag coefficient κ), each clamped to [0, max_thrust], and the achieved
wrench is rebuilt from the clamped thrusts. RK4 at 1/240 s, four physics
steps per control cycle of 1/60 s, the quaternion renormalised once per
physics step. The model is unclamped and coarser (RK2 at the control
period): the deliberate model-plant gap. State is float32, time included,
like the JAX world. A fleet of R quadrotors is one state whose leaves carry a
leading robot axis, under one shared clock or one clock per robot; each
robot's quaternion is renormalised on its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mppi_gpu_tpu_torch.envs.base import ControlCadence, World, clock
from mppi_gpu_tpu_torch.ops.world_step import Reciprocal, kernel_world


@dataclass(frozen=True)
class Quadrotor3DParams(ControlCadence):
    mass: float = 0.8
    inertia: tuple[float, float, float] = (0.005, 0.005, 0.009)
    arm: float = 0.17              # rotor arm length r (m)
    kappa: float = 0.016           # rotor drag torque per thrust (m)
    gravity: float = 9.81
    max_thrust: float = 8.0        # per rotor (N); hover needs m·g/4 ≈ 2 N
    timestep: float = 1.0 / 240.0  # physics dt (RK4)
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001
    init_pos: tuple[float, float, float] = (-1.0, 0.0, 0.5)

    @property
    def state_dim(self) -> int:
        return 13


class Quadrotor3DState(NamedTuple):
    p: torch.Tensor   # (3,) world position, or (R, 3) for a fleet
    q: torch.Tensor   # (4,) unit quaternion body→world (w, x, y, z), or (R, 4)
    v: torch.Tensor   # (3,) world linear velocity, or (R, 3)
    om: torch.Tensor  # (3,) body angular velocity, or (R, 3)
    time: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        """[p, q, v, ω]: (13,), or (R, 13) for a fleet."""
        return torch.cat([self.p, self.q, self.v, self.om], dim=-1)


def mix_to_rotors(u: torch.Tensor, arm: float, kappa: float) -> torch.Tensor:
    """[F, τx, τy, τz] (..., 4) → (..., 4) per-rotor thrusts, "+" configuration (f1 front
    +x CCW, f2 left +y CW, f3 back −x CCW, f4 right −y CW)."""
    F, tx, ty, tz = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    qf, qx, qy, qz = F / 4.0, tx / (2.0 * arm), ty / (2.0 * arm), tz / (4.0 * kappa)
    return torch.stack([qf - qy + qz, qf + qx - qz, qf + qy + qz, qf - qx - qz], dim=-1)


def rotors_to_wrench(f: torch.Tensor, arm: float, kappa: float) -> torch.Tensor:
    """(..., 4) rotor thrusts → the achieved [F, τx, τy, τz] (the mixer's
    inverse)."""
    f1, f2, f3, f4 = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    return torch.stack(
        [f1 + f2 + f3 + f4, arm * (f2 - f4), arm * (f3 - f1), kappa * (f1 - f2 + f3 - f4)], dim=-1,
    )


def quat_to_body_axes(q, scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """World-frame body x̂ and ŷ (columns of R(q)) of `q` = (qw, qx, qy, qz),
    scaled by `scale`, as numpy arrays: the attitude crosses of a drawing."""
    qw, qx, qy, qz = (float(v) for v in q)
    bx = np.array([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy + qw * qz),
                   2 * (qx * qz - qw * qy)]) * scale
    by = np.array([2 * (qx * qy - qw * qz), 1 - 2 * (qx * qx + qz * qz),
                   2 * (qy * qz + qw * qx)]) * scale
    return bx, by


@kernel_world
@dataclass(frozen=True)
class Quadrotor3DWorld(World):
    params: Quadrotor3DParams
    device: torch.device | str = "cpu"

    def kernel_params(self) -> tuple[str, dict[str, float]]:
        """K6's body and its parameters (csrc/world_step.cu, @pack
        quadrotor3d), past the cadence."""
        p = self.params
        jx, jy, jz = p.inertia
        return "quadrotor3d", dict(
            max_thrust=p.max_thrust, inv_two_arm=Reciprocal(2.0 * p.arm),
            inv_four_kappa=Reciprocal(4.0 * p.kappa), arm=p.arm, kappa=p.kappa,
            inv_mass=Reciprocal(p.mass), gravity=p.gravity, jzy=jz - jy, jxz=jx - jz, jyx=jy - jx,
            inv_jx=Reciprocal(jx), inv_jy=Reciprocal(jy), inv_jz=Reciprocal(jz))

    def _derivs(self, q, om, wrench):
        """(q̇, v̇, ω̇): the model's rigid-body ODE on the achieved wrench."""
        p = self.params
        qw, qx, qy, qz = q.unbind(-1)
        wx, wy, wz = om.unbind(-1)
        fm = wrench[..., 0] / p.mass
        acc = torch.stack([
            2.0 * (qx * qz + qw * qy) * fm,
            2.0 * (qy * qz - qw * qx) * fm,
            (1.0 - 2.0 * (qx * qx + qy * qy)) * fm - p.gravity,
        ], dim=-1)
        qdot = 0.5 * torch.stack([
            -(qx * wx + qy * wy + qz * wz),
            qw * wx + qy * wz - qz * wy,
            qw * wy + qz * wx - qx * wz,
            qw * wz + qx * wy - qy * wx,
        ], dim=-1)
        jx, jy, jz = p.inertia
        omdot = torch.stack([
            (wrench[..., 1] - (jz - jy) * wy * wz) / jx,
            (wrench[..., 2] - (jx - jz) * wz * wx) / jy,
            (wrench[..., 3] - (jy - jx) * wx * wy) / jz,
        ], dim=-1)
        return qdot, acc, omdot

    def physics_step(self, s: Quadrotor3DState, u: torch.Tensor) -> Quadrotor3DState:
        p = self.params
        h = p.timestep
        f = torch.clamp(mix_to_rotors(u.to(torch.float32), p.arm, p.kappa), 0.0, p.max_thrust)
        wrench = rotors_to_wrench(f, p.arm, p.kappa)

        def deriv(y):
            _, q, v, om = y
            qd, a, wd = self._derivs(q, om, wrench)
            return v, qd, a, wd

        def add(y, k, c):
            return tuple(yi + c * ki for yi, ki in zip(y, k))

        y = (s.p, s.q, s.v, s.om)
        k1 = deriv(y)
        k2 = deriv(add(y, k1, 0.5 * h))
        k3 = deriv(add(y, k2, 0.5 * h))
        k4 = deriv(add(y, k3, h))
        pp, q, v, om = (
            yi + (h / 6.0) * (a + 2 * b + 2 * c + d) for yi, a, b, c, d in zip(y, k1, k2, k3, k4)
        )
        q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True))
        return Quadrotor3DState(p=pp, q=q, v=v, om=om, time=s.time + h)

    def reset(self, n_robots: int | None = None) -> Quadrotor3DState:
        """At init_pos, level, at rest, time = timestep; with `n_robots`, R
        quadrotors so."""
        f32 = dict(dtype=torch.float32, device=self.device)
        p = self.params
        x = torch.tensor(p.init_pos + (1.0,) + (0.0,) * 9, **f32)
        if n_robots is not None:
            x = x.expand(n_robots, -1).contiguous()
        return self.from_x(x, p.timestep)

    def from_x(self, x: torch.Tensor, time) -> Quadrotor3DState:
        """The state whose [p, q, v, ω] is `x` ((13,) or (R, 13)) at `time`."""
        return Quadrotor3DState(p=x[..., 0:3], q=x[..., 3:7], v=x[..., 7:10], om=x[..., 10:13],
                                time=clock(time, x.device))
