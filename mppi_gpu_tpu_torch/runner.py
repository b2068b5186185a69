"""The closed loop: controller vs the ground-truth world (torch counterpart of
``mppi_gpu_tpu.runner``, whose host loop is the reference's main loop,
src/main.cu:326-374).

Three entry points:

* :func:`run_closed_loop` — the host loop: measure state → solve → apply the
  first action to the world → repeat until the episode ends, timing every
  solve like the reference's "Average controller execution time" metric,
  with optional per-step debug dumps, checkpoint/resume and the divergence
  guard. The world is the config family's (``envs.make_world``: point mass,
  with or without obstacles, pendulum, cart-pole, unicycle, planar
  quadrotor, two-link arm or 3-D quadrotor) and runs on the CPU: its state is
  a few floats and the host needs it every cycle anyway.
* :func:`run_episode_jit` — the whole episode on the controller's device with
  no host round trip: one control cycle (every opt iteration of the solve,
  the world's ``advance``, the step into the histories) captured once as a
  CUDA graph and replayed once per cycle.
* :func:`run_fleet_episode` — the same for R robots: one fleet solve and one
  batched world step per cycle (counterpart of ``run_fleet_episode_jit``).

Not ported yet (ROADMAP.md, Open items §1 items 3 and 5): the live viewer
and the native and MuJoCo worlds.
"""

from __future__ import annotations

import gc
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from mppi_gpu_tpu_torch.controller import MPPIController
from mppi_gpu_tpu_torch.envs import WorldParams, make_world, params_for_config
from mppi_gpu_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
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
    checkpoint_every: int | None = None,
    resume_from: str | os.PathLike | None = None,
    view: bool = False,
    validate: bool = True,
) -> EpisodeResult:
    """Interactive closed loop. Dump steps (every `step_dump_every` with a
    `step_dump_dir`) run ``solve_debug`` in place of the timed solve — the
    same stream, so the CSV documents the solve that drives the robot.

    Checkpoint/resume (no reference analog): with `checkpoint_path` and
    `checkpoint_every`, the loop state (step, U, seed, world state) is
    written atomically every N steps; `resume_from` restores it and the run
    goes on bit for bit as the uninterrupted one (the noise of a step is a
    function of the seed and the absolute step). The checkpoint's seed must
    be the controller's (build it from the checkpoint's config). On resume
    the returned EpisodeResult covers only the resumed suffix."""
    unported = {"world_backend": world_backend != "torch", "view": view}
    for name, given in unported.items():
        if given:
            raise NotImplementedError(
                f"run_closed_loop({name}=...) is not ported to mppi_gpu_tpu_torch yet "
                "(see ROADMAP.md, Open items §1 items 3 and 5)"
            )
    params = world_params or params_for_config(ctrl.cfg)
    world = make_world(ctrl.cfg, params)
    state = world.reset()
    U = ctrl.init_action_seq()
    step = 0
    if resume_from is not None:
        ck = load_checkpoint(resume_from)
        if ck.seed != ctrl.cfg.seed:
            raise ValueError(
                f"checkpoint {resume_from} holds the stream of seed {ck.seed}, the controller "
                f"draws seed {ctrl.cfg.seed}: build the controller from the checkpoint's config"
            )
        U = torch.as_tensor(ck.U, dtype=torch.float32, device=ctrl.device)
        step = ck.step
        state = world.from_x(torch.from_numpy(ck.x), ck.time)
    timer = SolveTimer(ctrl.device)
    xs = [state.x.numpy()]
    us: list[np.ndarray] = []
    times: list[float] = []
    limit = max_steps if max_steps is not None else params.num_control_steps() + 5
    while step < limit:
        if checkpoint_path is not None and checkpoint_every and step % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, step=step, U=U.cpu().numpy(), seed=ctrl.cfg.seed,
                            x=xs[-1], time=float(state.time), cfg=ctrl.cfg)
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


# --------------------------------------------------------------------------
# the on-device episode


class EpisodeCycle:
    """One control cycle of an on-device episode over buffers that live as
    long as it does: the world state, the nominal sequence(s) U, the control
    step (a 0-dim int64 counter on the device) and the histories xs (N+1, ...),
    us (N, ...), ts (N,). :meth:`cycle` solves at the counter's step (every
    opt iteration), advances the world, writes x, u and the time at the
    counter's row and increments it, reading nothing from the device.

    On a CUDA device :meth:`run` captures the cycle once as a CUDA graph and
    replays it once per control cycle; ``capture=False`` runs the same cycle
    eagerly (the graph's yardstick, bit for bit). On the CPU it runs as a
    loop. A graph holds the raw addresses of every tensor it touches, so the
    cycle holds every object whose tensors it reads: the controller's pack,
    cost (with its goals), model, σ, λ and clamp, the world, the seeds and
    the buffers."""

    def __init__(self, ctrl, world, state0, U0: torch.Tensor, n: int, solve) -> None:
        dev = U0.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.world, self.solve = world, solve
        # σ, λ and the clamp reach the graph through the solve's tail; the
        # cost's and the model's tensors through the pack and the plain model
        self.held = (ctrl._family, ctrl.cost, ctrl.dynamics, ctrl.sigma, ctrl.lambda_,
                     ctrl.max_a)
        self.state = type(state0)(*(leaf.clone() for leaf in state0))
        self.U = U0.clone()
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        x0 = state0.x
        self.xs = torch.empty((n + 1, *x0.shape), **f32)
        self.us = torch.empty((n, *U0.shape[:-2], U0.shape[-1]), **f32)
        self.ts = torch.empty((n,), **f32)
        self.n = n
        self.graph = None

    def cycle(self) -> None:
        action, u_next = self.solve(self.state.x, self.U, self.step)
        new = self.world.advance(self.state, action)
        for buf, v in zip(self.state, new):
            buf.copy_(v)
        self.U.copy_(u_next)
        row = self.step.view(1)
        self.xs.index_copy_(0, row + 1, new.x.unsqueeze(0))
        self.us.index_copy_(0, row, action.unsqueeze(0))
        self.ts.index_copy_(0, row, new.time.reshape(1))
        self.step.add_(1)

    def _capture(self) -> None:
        """Warm one cycle up on a side stream (it builds the kernels, sets
        K1's shared-memory attribute and fills the allocator), then capture
        one cycle. A cycle that cannot be captured raises: nothing falls
        back to the eager loop. The capture runs no kernel, and its wrappers
        count none (``ops.fused_solve``): a replay's launches are seen only
        in a trace."""
        dev = self.U.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.cycle()
        torch.cuda.current_stream(dev).wait_stream(side)
        # a dropped controller and its cached cycle form a reference cycle,
        # which only the garbage collector frees: were it to free that
        # cycle's graph during this capture, the capture would fail
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.cycle()
        self.graph = graph

    def run(self, state0, U0: torch.Tensor, capture: bool = True) -> EpisodeResult:
        """The episode of `n` cycles from (state0, U0); histories read once,
        at the end, into arrays of its own (the next episode reuses the
        buffers)."""
        graphed = capture and self.U.device.type == "cuda" and self.n > 0
        if graphed and self.graph is None:
            self._capture()
        for buf, v in zip(self.state, state0):
            buf.copy_(v)
        self.U.copy_(U0)
        self.step.zero_()
        self.xs[0].copy_(state0.x)
        for _ in range(self.n):
            if graphed:
                self.graph.replay()
            else:
                self.cycle()
        host = dict(device="cpu", copy=True)
        return EpisodeResult(times=self.ts.to(**host).numpy(), xs=self.xs.to(**host).numpy(),
                             us=self.us.to(**host).numpy())


def cycle_key(ctrl, kind: str, params, R: int | None, state_shape, n: int, seed) -> tuple:
    """What a cached episode cycle depends on: the identity of every object
    whose tensors its graph reads (the pack, the cost, the model, σ, λ and
    the clamp; reassigning ``ctrl.cost`` or ``ctrl.dynamics`` makes a new
    key), the config, the backend, the world's parameters, R, the state's
    shape, the episode length and, for one robot, the seed its kernel takes
    by value."""
    return (kind, id(ctrl._family), id(ctrl.cost), id(ctrl.dynamics), id(ctrl.sigma),
            id(ctrl.lambda_), id(ctrl.max_a), ctrl.cfg, ctrl.rollout_backend, repr(params), R,
            tuple(state_shape), n, seed)


def _episode_cycle(ctrl, kind: str, key: tuple, build) -> EpisodeCycle:
    """The controller's cached cycle of `kind` ("single" or "fleet") if its
    key is `key`, else a new one from ``build()`` in its place (the old
    graph and buffers are freed), as the JAX package's ``_episode_cache``
    keeps its jitted episodes."""
    cache = ctrl.__dict__.setdefault("_episode_cycles", {})
    hit = cache.get(kind)
    if hit is None or hit[0] != key:
        cache[kind] = (key, build())
    return cache[kind][1]


def run_episode_jit(
    ctrl: MPPIController,
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    seed: int | None = None,
    x0: torch.Tensor | np.ndarray | None = None,
    capture: bool = True,
) -> EpisodeResult:
    """The whole episode on the controller's device, with no host round
    trip: the counterpart of the JAX package's whole-episode ``lax.scan``
    under jit. On a CUDA device one control cycle — the solve (every opt
    iteration: K1 + K2 and the tail), the world's ``advance`` and the write
    into the histories at the step a device counter holds — is captured once
    as a CUDA graph (:class:`EpisodeCycle`, cached per controller) and
    replayed `num_steps` times (default: the episode's
    ``num_control_steps()``); ``capture=False`` runs the same cycle eagerly.
    On the CPU the cycle runs as a loop. `seed` (default: the config's) and
    `x0` (default: the world's start) override the episode's noise stream and
    start state; the clock starts where the world's reset does. A new seed
    re-captures (the solo kernel takes it by value); a new x0 does not."""
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController

    if isinstance(ctrl, ShardedMPPIController):
        raise NotImplementedError(
            "run_episode_jit with a ShardedMPPIController is not ported yet "
            "(see ROADMAP.md, Open items §1 item 3); run_closed_loop drives it"
        )
    params = world_params or params_for_config(ctrl.cfg)
    world = make_world(ctrl.cfg, params, device=ctrl.device)
    n = num_steps if num_steps is not None else params.num_control_steps()
    seed = ctrl.cfg.seed if seed is None else int(seed)
    state0 = world.reset()
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=ctrl.device)
        if tuple(x0.shape) != (ctrl.cfg.state_dim,):
            raise ValueError(f"x0 must be ({ctrl.cfg.state_dim},), got {tuple(x0.shape)}")
        state0 = world.from_x(x0, state0.time)
    U0 = ctrl.init_action_seq()

    def solve(x, U, step):
        res = ctrl.solve(x, U, seed, step)
        return res.action, res.u_next

    key = cycle_key(ctrl, "single", params, None, state0.x.shape, n, seed)
    cyc = _episode_cycle(ctrl, "single", key, lambda: EpisodeCycle(ctrl, world, state0, U0, n, solve))
    return cyc.run(state0, U0, capture)


def run_fleet_episode(
    ctrl,  # BatchedMPPIController
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    xs0: torch.Tensor | np.ndarray | None = None,  # (R, s) per-robot initial states
    capture: bool = True,
) -> EpisodeResult:
    """R independent closed loops, one fleet solve and one batched world
    step per control cycle, for `num_steps` cycles (default: the episode's
    ``num_control_steps()``), through :func:`run_episode_jit`'s machinery: a
    captured CUDA graph of one cycle on a CUDA device (``capture=False``: the
    same cycle eagerly), a loop on the CPU. The world is the config family's,
    batched on the controller's device; past the episode's end it holds its
    state, as the JAX fleet's scan does. Robot r under seed
    ``ctrl.init_seeds()[r]`` from ``xs0[r]`` is :func:`run_episode_jit` of one
    robot with that seed, start and goal. Returns xs (N+1, R, s), us
    (N, R, a) and the robots' shared clock."""
    params = world_params or params_for_config(ctrl.cfg)
    world = make_world(ctrl.cfg, params, device=ctrl.device)
    n = num_steps if num_steps is not None else params.num_control_steps()
    R = ctrl.n_robots
    state0 = world.reset(R)
    if xs0 is not None:
        xs0 = torch.as_tensor(xs0, dtype=torch.float32, device=ctrl.device)
        if tuple(xs0.shape) != (R, ctrl.cfg.state_dim):
            raise ValueError(
                f"xs0 must be ({R}, {ctrl.cfg.state_dim}), got {tuple(xs0.shape)}"
            )
        state0 = world.from_x(xs0, state0.time)
    Us0 = ctrl.init_action_seqs()

    def build() -> EpisodeCycle:
        seeds = ctrl.init_seeds()

        def solve(xs, Us, step):
            res = ctrl.solve_batch(xs, Us, seeds, step)
            return res.action, res.u_next

        return EpisodeCycle(ctrl, world, state0, Us0, n, solve)

    key = cycle_key(ctrl, "fleet", params, R, state0.x.shape, n, None)
    return _episode_cycle(ctrl, "fleet", key, build).run(state0, Us0, capture)
