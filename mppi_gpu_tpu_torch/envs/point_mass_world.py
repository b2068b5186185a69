"""Ground-truth point-mass world in torch (counterpart of
``mppi_gpu_tpu.envs.point_mass_world``).

Per-axis linear ODE ``(m + armature)·q̈ = gear·clamp(u, ±1) − damping·q̇``
integrated with RK4 at the physics timestep (``envs/params.py`` derives the
constants from the reference XMLs), a hard joint-limit clamp with velocity
zeroing at the stop, and a control period of 1/60 s (two physics steps of
0.01 s). Deliberately different from the controller's LTI model: the
model-plant mismatch is part of the reference. State is float32, like the
JAX world, time included.

A fleet of R robots is one batched state: q and qd of shape (R, n_axes)
under one shared clock, as in the JAX fleet episode (``run_fleet_episode_jit``
broadcasts one reset state over the robots).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.envs.base import World, clock
from mppi_gpu_tpu_torch.envs.params import WorldParams


class WorldState(NamedTuple):
    q: torch.Tensor     # (n_axes,) positions, or (R, n_axes) for a fleet
    qd: torch.Tensor    # (n_axes,) velocities, or (R, n_axes)
    time: torch.Tensor  # 0-dim float32 sim time, shared by a fleet

    @property
    def x(self) -> torch.Tensor:
        """Concatenated [qpos, qvel] (the reference's get_x layout): (s,),
        or (R, s) for a fleet."""
        return torch.cat([self.q, self.qd], dim=-1)


@dataclass(frozen=True)
class PointMassWorld(World):
    params: WorldParams
    device: torch.device | str = "cpu"

    def _accel(self, qd: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p = self.params
        return (p.gear * u - p.damping * qd) / p.effective_mass

    def physics_step(self, state: WorldState, u: torch.Tensor) -> WorldState:
        """One RK4 step at `timestep`, ctrl clamped to ±ctrl_range."""
        p = self.params
        h = p.timestep
        u = torch.clamp(u, -p.ctrl_range, p.ctrl_range)
        q, qd = state.q, state.qd
        k1q, k1v = qd, self._accel(qd, u)
        k2q, k2v = qd + 0.5 * h * k1v, self._accel(qd + 0.5 * h * k1v, u)
        k3q, k3v = qd + 0.5 * h * k2v, self._accel(qd + 0.5 * h * k2v, u)
        k4q, k4v = qd + h * k3v, self._accel(qd + h * k3v, u)
        q_new = q + (h / 6.0) * (k1q + 2 * k2q + 2 * k3q + k4q)
        qd_new = qd + (h / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
        hit = torch.abs(q_new) > p.joint_range
        q_new = torch.clamp(q_new, -p.joint_range, p.joint_range)
        qd_new = torch.where(hit, torch.zeros_like(qd_new), qd_new)
        return WorldState(q=q_new, qd=qd_new, time=state.time + h)

    def reset(self, n_robots: int | None = None) -> WorldState:
        """At the origin, at rest, time = timestep (after the reference's
        warm-up step); with `n_robots`, R robots so."""
        shape = (self.params.n_axes,) if n_robots is None else (n_robots, self.params.n_axes)
        f32 = dict(dtype=torch.float32, device=self.device)
        return WorldState(
            q=torch.zeros(shape, **f32), qd=torch.zeros(shape, **f32),
            time=torch.tensor(self.params.timestep, **f32),
        )

    def from_x(self, x: torch.Tensor, time) -> WorldState:
        """The state whose [qpos, qvel] is `x` ((s,) or (R, s)) at `time`."""
        n = self.params.n_axes
        return WorldState(q=x[..., :n].contiguous(), qd=x[..., n:].contiguous(),
                          time=clock(time, x.device))
