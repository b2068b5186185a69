"""The closed loop: controller vs the ground-truth world (torch counterpart of
``mppi_gpu_tpu.runner``, whose host loop is the reference's main loop,
src/main.cu:326-374).

Three entry points:

* :func:`run_closed_loop` — the host loop: measure state → solve → apply the
  first action to the world → repeat until the episode ends, timing every
  solve like the reference's "Average controller execution time" metric,
  with optional per-step debug dumps, checkpoint/resume and the divergence
  guard, and the live MuJoCo viewer. The plant is the config family's
  (point mass, with or without obstacles, pendulum, cart-pole, unicycle,
  planar quadrotor, two-link arm or 3-D quadrotor) on one of three backends
  (``envs.make_host_world``): the torch world on the CPU, the native C++
  twin or real MuJoCo. Each runs on the host: its state is a few floats and
  the host needs it every cycle anyway.
  On a CUDA device each solve replays the controller's solve graph
  (``graphs.SolveGraph``); ``capture=False`` launches it op by op.
* :func:`run_episode_jit` — the whole episode on the controller's device with
  no host round trip: one control cycle (every opt iteration of the solve,
  its last tail shifting U in place, then the world's step, the writes into
  the histories and the counter's advance: ``MPPIController.solve_in_place``
  with an ``ops.world_step.Advance``; on the fused backend on a CUDA device
  the last update's K2 runs the tail and the world's step as its epilogue,
  ``ops/combine_tail.py``) captured once as a CUDA graph and replayed once
  per cycle; for a sharded controller the ranks' collectives are captured
  in it.
* :func:`run_fleet_episode` — the same for R robots: one fleet solve and one
  batched world step per cycle (counterpart of ``run_fleet_episode_jit``),
  sharded or not.

The two device episodes step the torch world on the device and refuse a
host plant by name. Each is traced (``utils/timing``) as a span ``episode``
(its request the episode's ordinal within its cycle) whose parts are
``episode.prepare`` (the world, its reset, the start, U₀, the cycle's key
and lookup, and its ``graph.capture`` where the cycle is captured),
``episode.load`` (the copies into the cycle's buffers), ``episode.replay``
(the n cycles: replays, or the eager loop) and ``episode.read_back`` (the
histories to the host); the registry counts ``graph.capture.episode`` and
``graph.replay.episode`` (n a graphed episode).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mppi_gpu_tpu_torch import graphs
from mppi_gpu_tpu_torch.controller import MPPIController
from mppi_gpu_tpu_torch.envs import WorldParams, make_host_world, make_world, params_for_config
from mppi_gpu_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mppi_gpu_tpu_torch.io.csvio import write_step_dump_csv, write_traj_csv
from mppi_gpu_tpu_torch.ops import world_step
from mppi_gpu_tpu_torch.utils import timing
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


def _launch_viewer(world):
    """Open the live viewer over the real MuJoCo plant (the reference's GLFW
    window and mjv/mjr scene, src/PointMassEnv.cpp:65-92, 141-169; here
    ``mujoco.viewer`` supplies the window, the render loop and the camera).
    Needs the MuJoCo world and a display, and raises ConfigError otherwise.
    Module-level so tests can put a stub handle in its place."""
    from mppi_gpu_tpu_torch.config import ConfigError

    if not (hasattr(world, "m") and hasattr(world, "d")):
        raise ConfigError(
            "--view drives the live MuJoCo viewer and needs the real engine as the plant: "
            "add --world mujoco"
        )
    if sys.platform.startswith("linux") and not (
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
    ):
        # glfwInit on a headless host aborts the process rather than
        # raising, so it is never reached without a display
        raise ConfigError(
            "--view needs a display (no DISPLAY/WAYLAND_DISPLAY set). For headless replay, "
            "record with -t and use mppi_gpu_tpu_torch/scripts/animate.py"
        )
    try:
        import mujoco.viewer

        return mujoco.viewer.launch_passive(world.m, world.d)
    except Exception as e:  # noqa: BLE001 (GLFW/EGL init failures)
        raise ConfigError(
            f"could not open the live viewer (needs a working GL display): {e}. For headless "
            "replay, record with -t and use mppi_gpu_tpu_torch/scripts/animate.py"
        ) from e


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
    capture: bool = True,
) -> EpisodeResult:
    """Interactive closed loop against the plant of `world_backend`
    ("torch", "native" or "mujoco"; ``envs.make_host_world``). Dump steps
    (every `step_dump_every` with a `step_dump_dir`) run ``solve_debug`` in
    place of the timed solve — the same stream, so the CSV documents the
    solve that drives the robot.

    Checkpoint/resume (no reference analog): with `checkpoint_path` and
    `checkpoint_every`, the loop state (step, U, seed, world state) is
    written atomically every N steps; `resume_from` restores it (the plant
    through ``set_state``) and the run goes on bit for bit as the
    uninterrupted one (the noise of a step is a function of the seed and the
    absolute step). The checkpoint's seed must be the controller's (build it
    from the checkpoint's config). On resume the returned EpisodeResult
    covers only the resumed suffix.

    `view` opens the live MuJoCo viewer (:func:`_launch_viewer`) over the
    MuJoCo plant, syncs it every control cycle, paces the loop to real time
    and ends the episode when its window closes. `capture` goes to every
    timed solve (``MPPIController.solve``): a replayed CUDA graph on a CUDA
    device, op by op with False."""
    params = world_params or params_for_config(ctrl.cfg)
    world = make_host_world(ctrl.cfg, params, world_backend)
    viewer = _launch_viewer(world) if view else None
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
        world.set_state(ck.x, ck.time)
    timer = SolveTimer(ctrl.device)
    xs = [world.get_x()]
    us: list[np.ndarray] = []
    times: list[float] = []
    limit = max_steps if max_steps is not None else params.num_control_steps() + 5
    with contextlib.ExitStack() as stack:
        if viewer is not None:
            stack.callback(viewer.close)
        last_wall = None
        while step < limit:
            if checkpoint_path is not None and checkpoint_every and step % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, step=step, U=U.cpu().numpy(), seed=ctrl.cfg.seed,
                                x=xs[-1], time=world.time, cfg=ctrl.cfg)
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
                    res = ctrl.solve_auto(x, U, step, capture=capture)
                    action = res.action.cpu().numpy()
            U = res.u_next
            if validate and not np.all(np.isfinite(action)):
                check_solve(step, action, res.info.cpu())
            done = world.simulate(action)
            if viewer is not None:
                # a closed window ends the episode (the reference's
                # glfwWindowShouldClose, PointMassEnv.cpp:118)
                if not viewer.is_running():
                    break
                viewer.sync()
                # real-time pacing (the reference's usleep to the frame
                # time, PointMassEnv.cpp:150-161)
                now = time.perf_counter()
                if last_wall is not None and params.control_period > now - last_wall:
                    time.sleep(params.control_period - (now - last_wall))
                last_wall = time.perf_counter()
            if done:
                break
            times.append(world.time)
            xs.append(world.get_x())
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


def _device_world(fn: str, world_backend: str) -> None:
    """A device episode steps the torch world on the device: a host plant
    is refused by name."""
    if world_backend != "torch":
        raise ValueError(
            f"{fn} steps the torch world on the device; the {world_backend!r} world is a host "
            f"plant, which only run_closed_loop(world_backend={world_backend!r}) drives"
        )


# --------------------------------------------------------------------------
# the on-device episode


class EpisodeCycle:
    """One control cycle of an on-device episode over buffers that live as
    long as it does: the world state, its x (the solve's input, (s,) or
    (R, s)), the nominal sequence(s) U, the control step (a 0-dim int64
    counter on the device) and the histories xs (N+1, ...), us (N, ...), ts
    (N, ...) (one time per row, or per robot and row under per-robot
    clocks). :meth:`cycle` solves at the counter's step (every opt
    iteration; ``solve(x, U, step, advance)``, the controller's
    ``solve_in_place``, shifts U in place) and then, through the
    ``ops.world_step.Advance`` it is given, advances the world in the
    state's buffers, writes x, u and the time at the counter's row, the new
    x into the x buffer and increments the counter, reading nothing from the
    device. At one opt iteration a fused cycle on the card is two kernels,
    K1 and K2' (K2 with the tail and the world's step as its epilogue), and
    2·opt_iters at more; a world with no K6 body adds its own torch ops.

    On a CUDA device :meth:`run` captures the cycle once as a CUDA graph and
    replays it once per control cycle; ``capture=False`` runs the same cycle
    eagerly (the graph's yardstick, bit for bit). On the CPU it runs as a
    loop. A graph holds the raw addresses of every tensor it touches, so the
    cycle holds every object whose tensors it reads: the controller's pack,
    cost (with its goals), model, σ, λ, clamp and tickets, the world, the
    seeds and the buffers."""

    def __init__(self, ctrl, world, state0, U0: torch.Tensor, n: int, solve) -> None:
        dev = U0.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.world, self.solve = world, solve
        # σ, λ and the clamp reach the graph through the solve's tail; the
        # cost's and the model's tensors through the pack and the plain
        # model; K2's epilogue takes the controller's tickets
        self.held = (ctrl._family, ctrl.cost, ctrl.dynamics, ctrl.sigma, ctrl.lambda_,
                     ctrl.max_a, ctrl._tickets)
        self.state = type(state0)(*(leaf.clone(memory_format=torch.contiguous_format)
                                    for leaf in state0))
        x0 = state0.x
        self.x = x0.clone(memory_format=torch.contiguous_format)  # the solve's input; the world step writes it
        self.U = U0.clone(memory_format=torch.contiguous_format)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.xs = torch.empty((n + 1, *x0.shape), **f32)
        self.us = torch.empty((n, *U0.shape[:-2], U0.shape[-1]), **f32)
        self.ts = torch.empty((n, *state0.time.shape), **f32)
        self.n = n
        self.graph = None
        self.runs = 0  # episodes run, the ordinal of the next
        self.advance = world_step.Advance(world, self.state, self.xs, self.us, self.ts, self.x)

    def cycle(self) -> None:
        self.solve(self.x, self.U, self.step, self.advance)

    def _capture(self) -> None:
        """Warm one cycle up on a side stream, then capture one cycle
        (``graphs.capture``). A cycle that cannot be captured raises:
        nothing falls back to the eager loop. The capture runs no kernel,
        and its wrappers count none (``ops.fused_solve``): a replay's
        launches are seen only in a trace."""
        timing.count("graph.capture.episode")
        self.graph = graphs.capture(self.cycle, self.U.device)[0]

    def run(self, state0, U0: torch.Tensor, capture: bool = True) -> EpisodeResult:
        """The episode of `n` cycles from (state0, U0); histories read once,
        at the end, into arrays of its own (the next episode reuses the
        buffers). Its ordinal is the request of the span open around it
        (``episode``), its steps are parts of that span."""
        timing.tag(self.runs)
        self.runs += 1
        graphed = capture and self.U.device.type == "cuda" and self.n > 0
        if graphed and self.graph is None:
            self._capture()
        timing.part("episode.load")
        for buf, v in zip(self.state, state0):
            buf.copy_(v)
        self.x.copy_(state0.x)
        self.U.copy_(U0)
        self.step.zero_()
        self.xs[0].copy_(state0.x)
        timing.part("episode.replay")
        for _ in range(self.n):
            if graphed:
                self.graph.replay()
            else:
                self.cycle()
        if graphed:
            timing.count("graph.replay.episode", self.n)
        timing.part("episode.read_back")
        host = dict(device="cpu", copy=True)
        return EpisodeResult(times=self.ts.to(**host).numpy(), xs=self.xs.to(**host).numpy(),
                             us=self.us.to(**host).numpy())


def cycle_key(ctrl, kind: str, params, R: int | None, state_shape, n: int, seed) -> tuple:
    """What a cached episode cycle depends on: the identity of every object
    whose tensors its graph reads (the cost and the controller's solve
    identity, ``MPPIController._solve_identity``: the pack, the model, σ, λ,
    the clamp, the config, the backend, a sharded controller's mesh and
    branch; reassigning ``ctrl.cost`` or ``ctrl.dynamics`` makes a new key),
    the world's parameters, R, the state's shape, the episode length and,
    for one robot, the seed its kernel takes by value. Every rank of a
    process group builds the same key at the same episode, so the ranks
    capture their collectives together."""
    return (kind, id(ctrl.cost), *ctrl._solve_identity(), repr(params), R, tuple(state_shape), n,
            seed)


def _episode_cycle(ctrl, kind: str, key: tuple, build) -> EpisodeCycle:
    """The controller's cached cycle of `kind` ("single" or "fleet") if its
    key is `key`, else a new one from ``build()`` in its place
    (``graphs.cached``), as the JAX package's ``_episode_cache`` keeps its
    jitted episodes."""
    return graphs.cached(ctrl.__dict__.setdefault("_episode_cycles", {}), kind, key, build)


def run_episode_jit(
    ctrl: MPPIController,
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    seed: int | None = None,
    x0: torch.Tensor | np.ndarray | None = None,
    capture: bool = True,
    world_backend: str = "torch",
) -> EpisodeResult:
    """The whole episode on the controller's device, with no host round
    trip: the counterpart of the JAX package's whole-episode ``lax.scan``
    under jit. On a CUDA device one control cycle — the solve (every opt
    iteration: K1, then K2 with the tail, which shifts U in place, as its
    epilogue), the world's ``advance``, the writes into the histories at the
    step a device counter holds and the counter's advance (in the last
    update's K2 too, where the world has a K6 body) — is captured once
    as a CUDA graph (:class:`EpisodeCycle`, cached per controller) and
    replayed `num_steps` times (default: the episode's
    ``num_control_steps()``); ``capture=False`` runs the same cycle eagerly.
    On the CPU the cycle runs as a loop. `seed` (default: the config's) and
    `x0` (default: the world's start) override the episode's noise stream and
    start state; the clock starts where the world's reset does. A new seed
    re-captures (the solo kernel takes it by value); a new x0 does not. Any
    `world_backend` but "torch" (a host plant) raises ValueError.

    A ``ShardedMPPIController`` runs the same cycle around its sharded solve
    (the counterpart of ``mppi_gpu_tpu/runner.py:377``): every rank of its
    mesh calls this with the same arguments, captures its own cycle with its
    collectives in it (NCCL's; a virtual mesh's are plain reductions) and
    replays it; over gloo, on the CPU, the cycle is a loop."""
    _device_world("run_episode_jit", world_backend)
    with timing.span("episode"):
        timing.part("episode.prepare")
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

        def solve(x, U, step, advance):
            return ctrl.solve_in_place(x, U, seed, step, advance)

        key = cycle_key(ctrl, "single", params, None, state0.x.shape, n, seed)
        cyc = _episode_cycle(ctrl, "single", key,
                             lambda: EpisodeCycle(ctrl, world, state0, U0, n, solve))
        return cyc.run(state0, U0, capture)


def run_fleet_episode(
    ctrl,  # BatchedMPPIController
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    xs0: torch.Tensor | np.ndarray | None = None,  # (R, s) per-robot initial states
    capture: bool = True,
    world_backend: str = "torch",
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
    (N, R, a) and the robots' shared clock. Any `world_backend` but "torch"
    (a host plant) raises ValueError."""
    _device_world("run_fleet_episode", world_backend)
    with timing.span("episode"):
        timing.part("episode.prepare")
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

            def solve(xs, Us, step, advance):
                return ctrl.solve_in_place(xs, Us, seeds, step, advance)

            return EpisodeCycle(ctrl, world, state0, Us0, n, solve)

        key = cycle_key(ctrl, "fleet", params, R, state0.x.shape, n, None)
        return _episode_cycle(ctrl, "fleet", key, build).run(state0, Us0, capture)
