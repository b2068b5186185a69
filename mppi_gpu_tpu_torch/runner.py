"""The closed loop: controller vs the ground-truth world (torch
counterpart of ``mppi_gpu_tpu.runner.run_closed_loop``, the reference's main
loop, src/main.cu:326-374).

Measure state → solve → apply the first action to the world → repeat until
the episode ends, timing every solve like the reference's "Average
controller execution time" metric, with optional per-step debug dumps and
the divergence guard. The world runs on the CPU: its state is six floats and
the host needs it every cycle anyway.

Not ported yet (ROADMAP.md): the live viewer, checkpoint/resume, the native
and MuJoCo worlds, and the whole-episode mode (``run_episode_jit``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from mppi_gpu_tpu_torch.controller import MPPIController
from mppi_gpu_tpu_torch.envs import PointMassWorld, WorldParams, world_params_for_config
from mppi_gpu_tpu_torch.io.csvio import write_step_dump_csv, write_traj_csv
from mppi_gpu_tpu_torch.utils.guard import check_solve
from mppi_gpu_tpu_torch.utils.timing import SolveTimer


@dataclass
class EpisodeResult:
    times: np.ndarray        # (N,) sim time at each control step
    xs: np.ndarray           # (N+1, s) world states (x_0 .. x_N)
    us: np.ndarray           # (N, a) executed actions
    solve_ms: dict[str, float] = field(default_factory=dict)

    @property
    def final_state(self) -> np.ndarray:
        return self.xs[-1]


def run_closed_loop(
    ctrl: MPPIController,
    *,
    world_backend: str = "torch",
    world_params: WorldParams | None = None,
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
                "(see ROADMAP.md, Open items §1 item 5)"
            )
    params = world_params or world_params_for_config(ctrl.cfg)
    world = PointMassWorld(params)
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
