"""What every ground-truth world shares: the reference's control cadence
(src/PointMassEnv.cpp:115-139) and the control cycle, on the host and on
the device."""

from __future__ import annotations

import math

import torch


class ControlCadence:
    """Mixed into a world's parameters, which have ``timestep`` (physics dt),
    ``control_period`` and ``sim_end`` (episode length in sim seconds)."""

    @property
    def steps_per_control(self) -> int:
        """Physics steps per control cycle: the reference loops `mj_step` while
        elapsed < 1/60 s (PointMassEnv.cpp:136-139) → ceil(period/timestep)."""
        return math.ceil(self.control_period / self.timestep - 1e-9)

    def num_control_steps(self) -> int:
        """Control cycles in one episode (the clock starts one physics step in,
        after the reference's warm-up step)."""
        per_cycle = self.steps_per_control * self.timestep
        return math.ceil((self.sim_end - self.timestep) / per_cycle)


def _hold(done: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`old` where `done`, else `new`; `done` is 0-dim or one flag per robot
    (R,) against a leaf of shape (R, ...)."""
    return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())), old, new)


class World:
    """Mixed into a world with ``params`` (a :class:`ControlCadence`) and
    ``physics_step(state, u)`` over a state NamedTuple that carries ``time``.
    Its leaves may carry a leading robot axis R, under one shared 0-dim clock
    or one clock per robot (R,)."""

    def simulate(self, state, u):
        """One control cycle on the host: hold `u` for steps_per_control
        physics steps. Returns (new_state, done); done (checked before
        stepping) leaves the state unchanged, as in the reference."""
        if bool(state.time >= self.params.sim_end):
            return state, True
        for _ in range(self.params.steps_per_control):
            state = self.physics_step(state, u)
        return state, False

    def advance(self, state, u: torch.Tensor):
        """:meth:`simulate` without the host's look at the clock: the end of
        the episode is decided on the device, where a state at or past
        `sim_end` is held (the JAX world's `simulate` under jit). One control
        cycle queues its work and never waits for the device, so it can be
        captured in a CUDA graph."""
        new = state
        for _ in range(self.params.steps_per_control):
            new = self.physics_step(new, u)
        done = state.time >= self.params.sim_end
        return type(state)(*(_hold(done, old, nxt) for old, nxt in zip(state, new)))


def clock(time, device) -> torch.Tensor:
    """`time` (a float or a tensor) as the float32 clock of a state on
    `device`."""
    return torch.as_tensor(time, dtype=torch.float32, device=device)
