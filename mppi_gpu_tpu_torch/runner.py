"""The closed loop: controller vs the ground-truth world (torch
counterpart of ``mppi_gpu_tpu.runner.run_closed_loop``, the reference's main
loop, src/main.cu:326-374).

Measure state → solve → apply the first action to the world → repeat until
the episode ends, timing every solve like the reference's "Average
controller execution time" metric, with optional per-step debug dumps and
the divergence guard. The world is the config family's (``envs.make_world``:
point mass, with or without obstacles, pendulum, cart-pole, unicycle, planar
quadrotor, two-link arm or 3-D quadrotor) and runs on the CPU: its state is a
few floats and the host needs it every cycle anyway.

:func:`run_fleet_episode` runs R such loops at once on the controller's
device (counterpart of ``run_fleet_episode_jit``).

Not ported yet (ROADMAP.md): the live viewer, checkpoint/resume, the native
and MuJoCo worlds, and the single-robot whole-episode mode
(``run_episode_jit``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from mppi_gpu_tpu_torch.controller import MPPIController
from mppi_gpu_tpu_torch.envs import PointMassWorld, WorldParams, make_world, params_for_config
from mppi_gpu_tpu_torch.io.csvio import write_step_dump_csv, write_traj_csv
from mppi_gpu_tpu_torch.utils.guard import check_solve
from mppi_gpu_tpu_torch.utils.timing import SolveTimer


@dataclass
class EpisodeResult:
    times: np.ndarray        # (N,) sim time at each control step
    xs: np.ndarray           # (N+1, s) world states (x_0 .. x_N); (N+1, R, s) for a fleet
    us: np.ndarray           # (N, a) executed actions; (N, R, a) for a fleet
    solve_ms: dict[str, float] = field(default_factory=dict)

    @property
    def final_state(self) -> np.ndarray:
        return self.xs[-1]


def run_closed_loop(
    ctrl: MPPIController,
    *,
    world_backend: str = "torch",
    world_params=None,
    max_steps: int | None = None,
    traj_csv: str | os.PathLike | None = None,
    step_dump_every: int | None = None,
    step_dump_dir: str | os.PathLike | None = None,
    verbose: bool = False,
    checkpoint_path: str | os.PathLike | None = None,
    resume_from: str | os.PathLike | None = None,
    view: bool = False,
    validate: bool = True,
) -> EpisodeResult:
    """Interactive closed loop. Dump steps (every `step_dump_every` with a
    `step_dump_dir`) run ``solve_debug`` in place of the timed solve — the
    same stream, so the CSV documents the solve that drives the robot."""
    unported = {
        "world_backend": world_backend != "torch",
        "checkpoint_path": checkpoint_path is not None,
        "resume_from": resume_from is not None,
        "view": view,
    }
    for name, given in unported.items():
        if given:
            raise NotImplementedError(
                f"run_closed_loop({name}=...) is not ported to mppi_gpu_tpu_torch yet "
                "(see ROADMAP.md, Open items §1 items 4 and 6)"
            )
    params = world_params or params_for_config(ctrl.cfg)
    world = make_world(ctrl.cfg, params)
    state = world.reset()
    U = ctrl.init_action_seq()
    timer = SolveTimer(ctrl.device)
    xs = [state.x.numpy()]
    us: list[np.ndarray] = []
    times: list[float] = []
    limit = max_steps if max_steps is not None else params.num_control_steps() + 5
    step = 0
    while step < limit:
        x = torch.from_numpy(xs[-1])
        U_prev = U
        if step_dump_every and step_dump_dir and step % step_dump_every == 0:
            res, eps, traj = ctrl.solve_debug(x, U_prev, step)
            if eps is not None:  # None off a sharded solve's coordinator
                write_step_dump_csv(
                    os.path.join(step_dump_dir, f"step_{step:05d}.csv"),
                    traj.cpu().numpy(), eps.cpu().numpy(), res.info.u_seq.cpu().numpy(),
                    U_prev.cpu().numpy(), res.info.weights.cpu().numpy(),
                    res.info.costs.cpu().numpy(),
                )
            action = res.action.cpu().numpy()
        else:
            with timer.measure():
                res = ctrl.solve_auto(x, U, step)
                action = res.action.cpu().numpy()
        U = res.u_next
        if validate and not np.all(np.isfinite(action)):
            check_solve(step, action, res.info.cpu())
        state, done = world.simulate(state, torch.from_numpy(action))
        if done:
            break
        times.append(float(state.time))
        xs.append(state.x.numpy())
        us.append(action)
        if verbose:
            print(
                f"[{step:4d}] t={times[-1]:7.3f}  x={xs[-1]}  u={action}  "
                f"beta={float(res.info.beta):.4g} eta={float(res.info.eta):.4g}"
            )
        step += 1

    result = EpisodeResult(
        times=np.asarray(times),
        xs=np.asarray(xs),
        us=np.asarray(us) if us else np.zeros((0, ctrl.cfg.action_dim)),
        solve_ms=timer.summary(split_first=True),
    )
    if traj_csv is not None:
        write_traj_csv(traj_csv, result.times, result.xs[1:], result.us)
    return result


def run_fleet_episode(
    ctrl,  # BatchedMPPIController
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    xs0: torch.Tensor | np.ndarray | None = None,  # (R, s) per-robot initial states
) -> EpisodeResult:
    """R independent closed loops, one fleet solve and one batched world
    step per control cycle, for `num_steps` cycles (default: the episode's
    ``num_control_steps()``). The batched world lives on the controller's
    device and the loop never waits for it: no per-step copy to the host and
    no per-step look at the episode's end (past it the world holds its
    state, as the JAX fleet's scan does). Returns xs (N+1, R, s), us
    (N, R, a) and the robots' shared clock."""
    params = world_params or params_for_config(ctrl.cfg)
    if not isinstance(params, WorldParams):
        raise NotImplementedError(
            f"run_fleet_episode runs the batched point-mass world; a batched world "
            f"for env '{ctrl.cfg.env}' is not ported yet (see ROADMAP.md, Open items §1 item 1); "
            "its fleet solve runs (BatchedMPPIController)"
        )
    world = PointMassWorld(params, device=ctrl.device)
    n = num_steps if num_steps is not None else params.num_control_steps()
    R = ctrl.n_robots
    state = world.reset(R)
    if xs0 is not None:
        xs0 = torch.as_tensor(xs0, dtype=torch.float32, device=ctrl.device)
        if tuple(xs0.shape) != (R, ctrl.cfg.state_dim):
            raise ValueError(
                f"xs0 must be ({R}, {ctrl.cfg.state_dim}), got {tuple(xs0.shape)}"
            )
        state = world.from_x(xs0, state.time)
    Us, seeds = ctrl.init_action_seqs(), ctrl.init_seeds()
    xs, us, ts = [state.x], [], []
    for step in range(n):
        res = ctrl.solve_batch(xs[-1], Us, seeds, step)
        Us = res.u_next
        state = world.advance(state, res.action)
        xs.append(state.x)
        us.append(res.action)
        ts.append(state.time)
    empty = torch.zeros(0, R, ctrl.cfg.action_dim)
    return EpisodeResult(
        times=torch.stack(ts).cpu().numpy() if ts else np.zeros(0, np.float32),
        xs=torch.stack(xs).cpu().numpy(),
        us=(torch.stack(us) if us else empty).cpu().numpy(),
    )
