"""K6 ``world_advance``: one control cycle of a ground-truth world for R
robots in one launch (``csrc/world_step.cu``), its plain version and the
dispatch between them.

* :func:`advance` — what ``World.advance`` and ``World.simulate``
  (``envs/base.py``) step through: for a built-in world (a class declared
  with :func:`kernel_world`) whose state lies on a CUDA device, one launch of
  K6 into new state buffers; on the CPU, the plain version; a ``World``
  subclass from user code has no kernel and always runs its own torch
  operations (the choice is made by the world's class, never by trying).
* :func:`advance_into` — the device episode's step (``runner.EpisodeCycle``):
  the cycle written into the state's own buffers, x_new, u and the new time
  into the histories at the row a 0-dim int64 device counter holds
  (xs[step + 1], us[step], ts[step]), x_new into the cycle's x buffer, and
  the counter advanced, all in the one launch on a CUDA device.
* :func:`plain_advance_into` — :func:`advance_into`'s plain version.
* :func:`advance_after` — :func:`advance_into` of an :class:`Advance`, the
  episode's world step after a solve that did not run it in K2's epilogue.
* :func:`world_args` — the checked arguments of a world's cycle, which K6
  and K2's epilogue take alike.
* :func:`plain_advance` — K6's plain version: ``physics_step``
  ``steps_per_control`` times, then a robot whose clock was at or past
  ``sim_end`` before the cycle keeps its old state (one shared 0-dim clock
  or one per robot (R,)).
* :func:`identities` — the world bodies' two float substitutions (the
  correctly rounded reciprocal for 1/x, one ``sincosf`` for sinf and cosf of
  one argument) held bit for bit over all 2³² float inputs on the card.
* :func:`pack` — a world's parameters as K6 reads them: the four numbers of
  its cadence (timestep, 0.5·timestep, timestep/6, sim_end) and the world's
  own (``kernel_params`` of its class), each a double rounded to float32 as
  torch rounds a Python scalar, a divisor as the reciprocal torch's CUDA
  division multiplies by (``ops/_rounding.scalar_reciprocal``); a world
  packs them once, on its device, when it is built, so a captured graph
  holds their address.

A CUDA state, action or history of another dtype, shape or layout raises, as
does a failed or refused launch: nothing falls back to the plain version on
the card. Each launch that runs counts once under its world's kind
(:func:`launch_counts`); a launch recorded by a CUDA graph capture runs
nothing and counts nothing, and a graph's replays are seen only in a trace.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.ops import _rounding
from mppi_gpu_tpu_torch.ops.fused_solve import _launch
from mppi_gpu_tpu_torch.utils import timing

# the world bodies of csrc/world_step.cu: kind → (C id (WorldId), the shape of
# each state leaf after the robot axis, action dim, the pack's line there)
WORLDS = {
    "point_mass1": (0, ((1,), (1,)), 1, "point_mass"),
    "point_mass2": (1, ((2,), (2,)), 2, "point_mass"),
    "point_mass3": (2, ((3,), (3,)), 3, "point_mass"),
    "pendulum": (3, ((), ()), 1, "pendulum"),
    "cartpole": (4, ((),) * 4, 1, "cartpole"),
    "unicycle": (5, ((3,),), 2, "unicycle"),
    "quadrotor": (6, ((),) * 6, 2, "quadrotor"),
    "quadrotor3d": (7, ((3,), (4,), (3,), (3,)), 4, "quadrotor3d"),
    "arm": (8, ((4,),), 2, "arm"),
}
MAX_LEAVES = 6      # kMaxLeaves
MAX_ROBOTS = 65535  # the C entry's bound on R
# :func:`world_args` for no world: the tail alone in K2' and K9 (id −1)
NO_WORLD_ARGS = (-1, None, None, 0, None, None, 0, None, 0, 0, None, None, None, 0, None, None)

_KERNEL_WORLDS: set[type] = set()
# launches of K6 that ran, by world kind (``utils/timing``'s ``launch.world_advance.<kind>``)
_LAUNCHES = timing.Counters("launch.world_advance", WORLDS)
_CHECKED: set[str] = set()


def kernel_world(cls: type) -> type:
    """Class decorator: `cls` (exactly, not its subclasses) steps through
    K6 on a CUDA device. It defines ``kernel_params(self) -> (kind, {name:
    value})``, the body of :data:`WORLDS` and its parameters in the order of
    that body's ``@pack`` line in csrc/world_step.cu, past the cadence; a
    field the world's torch ops divide by is given as its divisor, wrapped in
    :class:`Reciprocal`."""
    _KERNEL_WORLDS.add(cls)
    return cls


def has_kernel(world) -> bool:
    return type(world) in _KERNEL_WORLDS


class Reciprocal(NamedTuple):
    """A packed field that is the reciprocal of `divisor`: the world's torch
    ops divide by the Python float `divisor`, which torch's CUDA division
    computes as a product with ``_rounding.scalar_reciprocal(divisor)``."""

    divisor: float


def pack_fields(world) -> tuple[str, dict[str, float]]:
    """(kind, every packed field by name in order) of a built-in world; a
    :class:`Reciprocal` of its ``kernel_params`` packed as the float32 factor
    torch's CUDA division multiplies by."""
    p = world.params
    h = p.timestep
    kind, own = world.kernel_params()
    own = {k: _rounding.scalar_reciprocal(v.divisor) if isinstance(v, Reciprocal) else v
           for k, v in own.items()}
    return kind, {"timestep": h, "half_step": 0.5 * h, "sixth_step": h / 6.0,
                  "sim_end": p.sim_end, **own}


def pack(world, device=None) -> torch.Tensor:
    """The world's packed parameters, float32 on `device` (default: the
    world's)."""
    _, fields = pack_fields(world)
    return torch.tensor(list(fields.values()), dtype=torch.float32,
                        device=world.device if device is None else device)


def _hold(done: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`old` where `done`, else `new`; `done` is 0-dim or one flag per robot
    (R,) against a leaf of shape (R, ...)."""
    return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())), old, new)


def plain_advance(world, state, u: torch.Tensor):
    """K6's plain version: steps_per_control physics steps under the held
    `u`, a state at or past sim_end held (the JAX world's ``simulate`` under
    jit); torch operations queued on the state's device, nothing read back."""
    new = state
    for _ in range(world.params.steps_per_control):
        new = world.physics_step(new, u)
    done = state.time >= world.params.sim_end
    return type(state)(*(_hold(done, old, nxt) for old, nxt in zip(state, new)))


def _on_cuda(tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"a world's state and action are spread over {sorted(map(str, devices))}")
    return devices.pop().type == "cuda"


def advance(world, state, u: torch.Tensor):
    """One control cycle of `world` from `state` under the held action `u`
    ((a,), or (R, a) for R robots): the new state, in new tensors. K6 for a
    built-in world on a CUDA device (its state made contiguous), else
    :func:`plain_advance` (a world from user code: its own ``physics_step``)."""
    if not has_kernel(world) or not _on_cuda((*state, u)):
        return plain_advance(world, state, u)
    state = type(state)(*(leaf.contiguous() for leaf in state))
    out = type(state)(*(torch.empty_like(leaf) for leaf in state))
    _launch_world(world, state, u, out)
    return out


def advance_into(world, state, u: torch.Tensor, xs: torch.Tensor, us: torch.Tensor,
                 ts: torch.Tensor, step: torch.Tensor, x: torch.Tensor) -> None:
    """One control cycle written into `state`'s own leaves, then xs[step + 1]
    = the new x, us[step] = u, ts[step] = the new clock, at the row the 0-dim
    int64 `step` holds on the device, the new x into `x` ((s,) or (R, s), the
    next solve's input), and the counter advanced by one after those
    writes. One launch of K6 on a CUDA device (every buffer contiguous
    float32 but `u`, whose robots may be strided, as a fleet's action, a
    column of its sequences, is), else :func:`advance`, the copies and the
    add."""
    if has_kernel(world) and _on_cuda((*state, u, xs, us, ts, step, x)):
        _launch_world(world, state, u, state, (xs, us, ts, step, x))
        return
    plain_advance_into(world, state, u, xs, us, ts, step, x)


def plain_advance_into(world, state, u: torch.Tensor, xs: torch.Tensor, us: torch.Tensor,
                       ts: torch.Tensor, step: torch.Tensor, x: torch.Tensor) -> None:
    """:func:`advance_into`'s plain version, torch operations on any device:
    :func:`plain_advance`, the copies into the state and the histories at the
    counter's row, and the counter's add."""
    new = plain_advance(world, state, u)
    for buf, v in zip(state, new):
        buf.copy_(v)
    row = step.view(1)
    xs.index_copy_(0, row + 1, new.x.unsqueeze(0))
    us.index_copy_(0, row, u.unsqueeze(0))
    ts.index_copy_(0, row, new.time.unsqueeze(0))
    x.copy_(new.x)
    step.add_(1)


class Advance(NamedTuple):
    """The device episode's world step after its solve (``runner.EpisodeCycle``):
    the world, its state (stepped in its own buffers), the histories xs, us,
    ts and the x buffer the next solve reads; the counter is the solve's
    step. K2's epilogue runs it in the cycle's last update where the world
    has a K6 body (``ops/combine_tail.py``); elsewhere :func:`advance_after`
    does, after the solve."""

    world: object
    state: tuple
    xs: torch.Tensor
    us: torch.Tensor
    ts: torch.Tensor
    x: torch.Tensor


def advance_after(advance: Advance | None, u: torch.Tensor, step: torch.Tensor) -> None:
    """:func:`advance_into` of `advance` under the action `u` at the counter
    `step`; nothing without `advance`."""
    if advance is not None:
        advance_into(advance.world, advance.state, u, advance.xs, advance.us, advance.ts, step,
                     advance.x)


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...], contiguous: bool = True) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"K6: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"K6: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"K6: {name} must be contiguous")


def _check_layout(lib, kind: str, n_params: int) -> None:
    """The C side's leaf widths, pack length and action dim of `kind`
    against this module's (once per kind and process)."""
    if kind in _CHECKED:
        return
    wid, shapes, A, _ = WORLDS[kind]
    widths, length, a = (ctypes.c_int * MAX_LEAVES)(), ctypes.c_int(), ctypes.c_int()
    n = lib.mppi_world_layout(wid, widths, ctypes.byref(length), ctypes.byref(a))
    want = [math.prod(s) for s in shapes]
    got = (list(widths)[:max(n, 0)], length.value, a.value)
    if got != (want, n_params, A):
        raise RuntimeError(f"K6's {kind} body is built for (leaf widths, pack length, action dim) "
                           f"{got}, the wrapper packs {(want, n_params, A)}")
    _CHECKED.add(kind)


def world_args(world, state, out, R: int, lead: tuple[int, ...], hist=None) -> tuple:
    """Check a built-in world's state, new state `out` (which may be `state`:
    in place) and, with `hist` = (xs, us, ts, step, x), the episode's buffers
    for R robots (`lead` = (R,) for a fleet, () for one robot); return the
    arguments that K6's C entry and K2's epilogue take for them, in their
    order: the world's id, the leaves in and out and their count, the clock
    in and out, whether it is one per robot, the pack and its length, the
    physics steps per cycle, xs, us, ts, the history rows, the counter and
    the x buffer (null pointers without `hist`). Loads the library and
    checks the world's layout against it."""
    kind = world._kernel_kind
    wid, shapes, A, _ = WORLDS[kind]
    leaves, time = tuple(state)[:-1], state.time
    if len(leaves) != len(shapes):
        raise ValueError(f"K6: a {kind} state has {len(shapes)} leaves and a clock, got {len(state)}")
    if not 1 <= R <= MAX_ROBOTS:
        raise ValueError(f"K6 steps 1 <= R <= {MAX_ROBOTS} robots, got {R}")
    for i, (leaf, o, s) in enumerate(zip(leaves, tuple(out)[:-1], shapes)):
        _check(f"state leaf {i}", leaf, lead + s)
        _check(f"new state leaf {i}", o, lead + s)
    per_robot = time.dim() > 0
    _check("clock", time, lead if per_robot else ())
    _check("new clock", out.time, time.shape)
    params = world._packs.get(time.device)
    if params is None:
        params = world._packs.setdefault(time.device, pack(world, time.device))
    xs = us = ts = step = x = None
    if hist is not None:
        xs, us, ts, step, x = hist
        n = us.shape[0]
        S = sum(math.prod(s) for s in shapes)
        _check("xs", xs, (n + 1, *lead, S))
        _check("us", us, (n, *lead, A))
        _check("ts", ts, (n, *time.shape))
        if step.dtype != torch.int64 or step.dim() != 0:
            raise TypeError(f"K6: the step is a 0-dim int64 tensor, got {step.dtype} "
                            f"{tuple(step.shape)}")
        _check("x", x, (*lead, S))
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    _check_layout(_build.load_library(), kind, params.numel())
    ptrs = ctypes.c_void_p * MAX_LEAVES

    def ptr(t):
        return None if t is None else t.data_ptr()

    return (wid, ptrs(*(t.data_ptr() for t in leaves)),
            ptrs(*(t.data_ptr() for t in tuple(out)[:-1])), len(leaves), time.data_ptr(),
            out.time.data_ptr(), int(per_robot), params.data_ptr(), params.numel(),
            world.params.steps_per_control, ptr(xs), ptr(us), ptr(ts),
            us.shape[0] if us is not None else 0, ptr(step), ptr(x))


def _launch_world(world, state, u, out, hist=None) -> None:
    """Check the inputs and launch K6 from `state` into `out` (which may be
    `state`: in place), with `hist` = (xs, us, ts, step, x) the episode's
    writes: the histories, the new x and the counter's advance."""
    kind = world._kernel_kind
    A = WORLDS[kind][2]
    lead = tuple(u.shape[:-1])
    if len(lead) > 1 or u.shape[-1:] != (A,):
        raise ValueError(f"K6: the {kind} action is ({A},) or (R, {A}), got {tuple(u.shape)}")
    R = lead[0] if lead else 1
    _check("u", u, lead + (A,), contiguous=False)
    # each robot's A actions side by side, the robots u_stride floats apart
    u_stride = u.stride(0) if R > 1 else A
    if (A > 1 and u.stride(-1) != 1) or u_stride < A:
        raise ValueError(f"K6: u's {A} actions of a robot must be side by side and the robots "
                         f"apart, got strides {u.stride()}")
    (wid, ins, outs, n_leaves, t_in, t_out, per_robot, params, n_params, steps, xs, us, ts, n_hist,
     step, x) = world_args(world, state, out, R, lead, hist)
    from mppi_gpu_tpu_torch.ops import _build

    if _launch(
        "world_advance", _build.load_library().mppi_world_advance, state.time.device, wid, ins,
        outs, n_leaves, t_in, t_out, per_robot, u.data_ptr(), u_stride, A, params, n_params, R,
        steps, xs, us, ts, n_hist, step, x, int(hist is not None),
    ):
        _LAUNCHES[kind] += 1


# the substitutions of csrc/world_step.cuh, in mppi_world_identities' order:
# name → what the world bodies compute in place of what
IDENTITIES = {"rcp": "__frcp_rn(x) for __fdiv_rn(1, x)",
              "sin": "sincosf's sine for sinf(x)",
              "cos": "sincosf's cosine for cosf(x)"}


def identities(device: torch.device | str = "cuda") -> dict[str, tuple[int, int | None]]:
    """Every float32 input, all 2³² bit patterns, through the world bodies'
    substitutions on the CUDA device `device`: for each of :data:`IDENTITIES`,
    the number of inputs whose result differs in bits from the expression it
    replaces, and the smallest such bit pattern (None where none differs)."""
    from mppi_gpu_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the identities run on a CUDA device, not {device}")
    counts = torch.zeros(len(IDENTITIES), dtype=torch.int64, device=device)
    first = torch.full((len(IDENTITIES),), -1, dtype=torch.int32, device=device)  # 0xffffffff
    _launch("world_identities", _build.load_library().mppi_world_identities, device,
            counts.data_ptr(), first.data_ptr())
    n, f = counts.tolist(), [v & 0xFFFFFFFF for v in first.tolist()]
    return {k: (n[i], f[i] if n[i] else None) for i, k in enumerate(IDENTITIES)}


def reset_launch_counts() -> None:
    _LAUNCHES.update(dict.fromkeys(_LAUNCHES, 0))


def launch_counts() -> dict[str, int]:
    """K6's launches that ran since the last reset, by world kind."""
    return dict(_LAUNCHES)
