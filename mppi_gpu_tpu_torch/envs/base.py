"""What every ground-truth world shares: the reference's control cadence
(src/PointMassEnv.cpp:115-139) and the control cycle, on the host and on
the device."""

from __future__ import annotations

import math

import torch

from mppi_gpu_tpu_torch.ops import world_step


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


class World:
    """Mixed into a world with ``params`` (a :class:`ControlCadence`),
    ``device`` and ``physics_step(state, u)`` over a state NamedTuple that
    carries ``time``. Its leaves may carry a leading robot axis R, under one
    shared 0-dim clock or one clock per robot (R,).

    Both :meth:`simulate` and :meth:`advance` step through
    ``ops.world_step.advance``: a built-in world (its class declared with
    ``ops.world_step.kernel_world``) whose state lies on a CUDA device runs
    the whole control cycle as one launch of K6 (``csrc/world_step.cu``);
    on the CPU, and always for a subclass from user code, which has no
    kernel, the cycle is ``physics_step`` repeated as torch operations
    (``ops.world_step.plain_advance``). A built-in world packs its
    parameters once, on its device, when it is built."""

    def __post_init__(self) -> None:
        if world_step.has_kernel(self):
            kind, _ = world_step.pack_fields(self)
            packed = world_step.pack(self)
            object.__setattr__(self, "_kernel_kind", kind)
            object.__setattr__(self, "_packs", {packed.device: packed})

    def simulate(self, state, u):
        """One control cycle on the host: hold `u` for steps_per_control
        physics steps. Returns (new_state, done); done (checked before
        stepping) leaves the state unchanged, as in the reference."""
        if bool(state.time >= self.params.sim_end):
            return state, True
        return world_step.advance(self, state, u), False

    def advance(self, state, u: torch.Tensor):
        """:meth:`simulate` without the host's look at the clock: the end of
        the episode is decided on the device, where a state at or past
        `sim_end` is held (the JAX world's `simulate` under jit). One control
        cycle queues its work and never waits for the device, so it can be
        captured in a CUDA graph."""
        return world_step.advance(self, state, u)


def clock(time, device) -> torch.Tensor:
    """`time` (a float or a tensor) as the float32 clock of a state on
    `device`."""
    return torch.as_tensor(time, dtype=torch.float32, device=device)
