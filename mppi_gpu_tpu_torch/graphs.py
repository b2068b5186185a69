"""CUDA graphs of the port: the counterpart of the JAX package's ``jax.jit``.

PyTorch launches every op from the host. A solve is 10-1000 launches, and
in the closed loop the card waits on them. A CUDA graph records them once
and replays them in one launch. Two kinds of graph use the one capture here
(:func:`capture`):

* the host loop's solve (:class:`SolveGraph`, the counterpart of the jitted
  ``MPPIController._solve``, ``mppi_gpu_tpu/controller.py:607``): captured
  once per controller and key (:func:`solve_key`), replayed by every
  ``solve`` on a CUDA device;
* the device episode's control cycle (``runner.EpisodeCycle``).

A graph holds the raw addresses of every tensor it reads and writes. So its
inputs are copied into buffers it owns before each replay, its outputs are
copied out of its own after, and it holds every object whose tensors it
reads (the controller's pack, cost, model, σ, λ and clamp). A capture that
fails raises: nothing goes back to launching op by op. Collectives of a
process group (NCCL) are captured with the rest; every rank must capture the
same sequence of them, so a key holds only what every rank shares.

The host loop's solve is traced here (``utils/timing``): a span ``solve`` (its
request the step, where it is an int) whose parts are ``solve.key`` (the key
and the cache lookup, a capture on a miss), ``solve.load`` (the copies in),
``solve.replay`` and ``solve.read_out`` (the copy out, split and viewed);
``graph.capture`` around every capture. The registry counts
``graph.capture.solve`` and ``graph.replay.solve``.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from mppi_gpu_tpu_torch.controller import SolveInfo, SolveResult
from mppi_gpu_tpu_torch.ops.cost import goal_of, goal_free_key, with_goal
from mppi_gpu_tpu_torch.utils import timing


def capture(fn, device: torch.device):
    """Run `fn` once on a side stream of `device` (the warm-up: it builds and
    loads the kernels, sets K1's shared-memory attribute, meets NCCL once
    and fills the allocator), then capture one more call of it on that
    stream as a CUDA graph, with `device` current throughout. Returns
    ``(graph, the warm-up's output, the captured call's output)``; the
    captured output lives in the graph's memory and is rewritten by each
    replay. The capture launches nothing, so the kernels' wrappers count
    none of its launches (``ops.fused_solve``): a replay's launches are seen
    only in a trace.

    The garbage collector is off during the capture: a dropped controller
    and its cached graph form a reference cycle that only the collector
    frees, and freeing a graph while another is being captured makes the
    capture fail. Other threads' CUDA calls (NCCL's watchdog queries its
    events) are left alone (``capture_error_mode="thread_local"``). The
    whole of it is the span ``graph.capture``."""
    with timing.span("graph.capture"), torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = fn()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                static = fn()
        finally:
            if was_enabled:
                gc.enable()
        cur.wait_stream(side)
        if isinstance(warm, torch.Tensor):  # made on the side stream, read on the current one
            warm.record_stream(cur)
    return graph, warm, static


def cached(cache: dict, kind: str, key: tuple, build):
    """The cache's entry of `kind` if its key is `key`, else a new one from
    ``build()`` in its place (the old graph and buffers are then freed), as
    the JAX package keeps one jitted program per static signature."""
    hit = cache.get(kind)
    if hit is None or hit[0] != key:
        cache[kind] = (key, build())
    return cache[kind][1]


def replays(device: torch.device, capture: bool) -> bool:
    """Whether ``solve`` replays its graph: asked to, on a CUDA device, and
    not while the stream is capturing another graph (a device episode's
    cycle), which must record the solve's own launches instead."""
    return capture and device.type == "cuda" and not torch.cuda.is_current_stream_capturing()


def solve_key(ctrl, x, U, seed) -> tuple:
    """What a solve graph depends on: the controller's solve identity
    (``MPPIController._solve_identity``: the pack, the model, σ, λ, the clamp,
    the config, the backend, a mesh's branch), the cost but its goal
    (``ops/cost.goal_free_key``; the goal is an input), the shapes of x, U
    and the goal, and the seed where the kernel takes it by value (one
    robot's int; a fleet's (R,) seeds are an input)."""
    goal = goal_of(ctrl.cost)
    return (goal_free_key(ctrl.cost), *ctrl._solve_identity(), tuple(x.shape), tuple(U.shape),
            None if goal is None else tuple(goal.shape),
            ("seeds", tuple(seed.shape)) if isinstance(seed, torch.Tensor) else int(seed))


class SolveGraph:
    """One controller's ``solve`` as a CUDA graph over buffers it owns: x,
    U, the step (a 0-dim int64, which K1 and K5 read by address and the
    eager noise as a tensor), a fleet's seeds and the cost's goal, at which
    the solve aims a copy of the cost. Built at the first call, which copies
    that call's inputs in, runs the solve once on a side stream (the warm-up
    of :func:`capture`, whose launches count as any op-by-op solve's) and
    captures it; that call returns the warm-up's result. Each later call
    copies its inputs in, replays the graph (its launches are seen only in a
    trace) and returns a copy of the outputs, which outlives the next call."""

    def __init__(self, ctrl, x, U, seed, step) -> None:
        dev = ctrl.device
        goal = goal_of(ctrl.cost)
        self.ctrl = ctrl
        self.x = torch.empty(x.shape, dtype=torch.float32, device=dev)
        self.U = torch.empty(U.shape, dtype=torch.float32, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.seed = seed.clone() if isinstance(seed, torch.Tensor) else int(seed)
        self.goal = None if goal is None else torch.empty_like(goal)
        self.cost = ctrl.cost if goal is None else with_goal(ctrl.cost, self.goal)
        self.held = (ctrl._family, ctrl.cost, ctrl.dynamics, ctrl.sigma, ctrl.lambda_, ctrl.max_a)
        self.shapes: list[torch.Size] = []
        self._load(x, U, seed, step, goal)
        timing.count("graph.capture.solve")
        self.graph, self.first, self.out = capture(self._run, dev)

    @contextlib.contextmanager
    def _aimed(self):
        """The controller's cost aimed at the goal buffer while the solve
        runs (its ``_cost`` swapped, not assigned: nothing is re-packed)."""
        ctrl = self.ctrl
        own, ctrl._cost = ctrl._cost, self.cost
        try:
            yield
        finally:
            ctrl._cost = own

    def _run(self) -> torch.Tensor:
        """The solve on the buffers, its leaves packed into one flat tensor."""
        with self._aimed():
            res = self.ctrl.solve(self.x, self.U, self.seed, self.step, capture=False)
        leaves = [res.action, res.u_next, *res.info]
        self.shapes = [v.shape for v in leaves]
        return torch.cat([v.reshape(-1) for v in leaves])

    def _load(self, x, U, seed, step, goal) -> None:
        self.x.copy_(x)
        self.U.copy_(U)
        if isinstance(step, torch.Tensor):
            self.step.copy_(step)
        else:
            self.step.fill_(step)
        if isinstance(self.seed, torch.Tensor):
            self.seed.copy_(seed)
        if self.goal is not None:
            self.goal.copy_(goal)

    def __call__(self, x, U, seed, step) -> SolveResult:
        if self.first is not None:  # the first call: the warm-up ran its inputs
            flat, self.first = self.first, None
        else:
            timing.part("solve.load")
            self._load(x, U, seed, step, goal_of(self.ctrl.cost))
            timing.part("solve.replay")
            self.graph.replay()
            timing.count("graph.replay.solve")
            flat = self.out
        timing.part("solve.read_out")
        parts = flat.clone().split([s.numel() for s in self.shapes])
        leaves = [p.view(s) for p, s in zip(parts, self.shapes)]
        return SolveResult(leaves[0], leaves[1], SolveInfo(*leaves[2:]))


def graphed_solve(ctrl, x, U, seed, step):
    """``ctrl.solve(x, U, seed, step)`` through the controller's solve graph
    (one per controller, rebuilt when :func:`solve_key` changes); the span
    ``solve``, for the step where it is an int."""
    with timing.span("solve", step if isinstance(step, int) else None):
        timing.part("solve.key")
        key = solve_key(ctrl, x, U, seed)
        cache = ctrl.__dict__.setdefault("_solve_graphs", {})
        graph = cached(cache, "solve", key, lambda: SolveGraph(ctrl, x, U, seed, step))
        return graph(x, U, seed, step)
