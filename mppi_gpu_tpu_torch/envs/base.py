"""What every ground-truth world shares: the reference's control cadence
(src/PointMassEnv.cpp:115-139) and the host-side control cycle."""

from __future__ import annotations

import math


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


class HostWorld:
    """Mixed into a world with ``params`` (a :class:`ControlCadence`) and
    ``physics_step(state, u)`` over a state that carries ``time``."""

    def simulate(self, state, u):
        """One control cycle: hold `u` for steps_per_control physics steps.
        Returns (new_state, done); done (checked before stepping) leaves the
        state unchanged, as in the reference."""
        if bool(state.time >= self.params.sim_end):
            return state, True
        for _ in range(self.params.steps_per_control):
            state = self.physics_step(state, u)
        return state, False
