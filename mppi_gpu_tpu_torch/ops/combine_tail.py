"""K2' ``combine_tail``: K2's fold with the solve's tail (K7's row body) as
its epilogue and, in the device episode's last update, the world's control
cycle (K6's per-robot body) (``csrc/combine_tail.cu``), its plain version
and the dispatch between them.

* :func:`combine_tail` — what the fused backend runs after K1 in an inner
  opt iteration (``ITERATE``: the updated sequence alone) and in the device
  episode's last update (``CYCLE``: the action and the sequence shifted over
  U in place, then, with an :class:`~mppi_gpu_tpu_torch.ops.world_step.Advance`,
  the world's cycle at the solve's step). On a CUDA device one launch of
  K2': a world with a K6 body steps in it, a world from user code (no body)
  after it through ``world_step.advance_after``. On CPU tensors the plain
  version.
* :func:`combine_tail_reference` — K2' plain version: K2's, K7's and K6's
  plain versions in that order (``world_step.plain_advance_into``).

The launch takes a ticket buffer of R + 1 int32 zeros that the controller
holds (``MPPIController._tickets``); the kernel leaves it zero. The choice is
made by the tensors' device, never by trying: a CUDA input of another
dtype, shape or layout raises, as does a failed or refused launch, and
nothing falls back to K2, K7 and K6 or to the plain version on the card.
Each launch that runs counts once (:func:`launch_counts`); a launch recorded
by a CUDA graph capture runs nothing and counts nothing, and a graph's
replays are seen only in a trace.
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.ops import fused_solve as fs
from mppi_gpu_tpu_torch.ops import solve_tail as st
from mppi_gpu_tpu_torch.ops import world_step as ws
from mppi_gpu_tpu_torch.utils import timing

# the tails K2' computes: an inner iteration's and the device episode's cycle
FORMS = (st.ITERATE, st.CYCLE)

# launches of K2' that ran (``utils/timing``'s ``launch.combine_tail``)
_LAUNCHES = timing.Counters("launch", ("combine_tail",))


def combine_tail_reference(partials, lam_softmin: float, U, max_a, clamp: bool, outputs,
                           into=None, step=None, advance=None):
    """K2' plain version: (β, η, ΔU, the tail's outputs) of K2's and K7's
    plain versions, then the world's cycle of `advance` under the action as
    torch operations, on any device."""
    T, A = U.shape[-2:]
    combine = fs.fleet_softmin_combine_reference if U.dim() == 3 else fs.softmin_combine_reference
    beta, eta, dU = combine(partials, lam_softmin, T, A)
    tail = st.solve_tail_reference(U, dU, max_a, clamp, outputs, into=into)
    if advance is not None:
        ws.plain_advance_into(advance.world, advance.state, tail.action, advance.xs, advance.us,
                              advance.ts, step, advance.x)
    return beta, eta, dU, tail


def _check_call(partials, U, outputs, into, step, advance) -> tuple[int, tuple[int, ...]]:
    """The robots and the lead shape of a call; raises on what K2' does not
    compute."""
    if tuple(outputs) not in FORMS:
        raise ValueError(f"K2' computes the tails {FORMS}, not {tuple(outputs)}")
    if into is not None and "u_next" not in outputs:
        raise ValueError("K2': `into` receives u_next, which was not asked for")
    if advance is not None and "action" not in outputs:
        raise ValueError("K2' steps the world under the cycle's action, which was not asked for")
    if advance is not None and not isinstance(step, torch.Tensor):
        raise TypeError("K2' steps the world at the counter a 0-dim int64 tensor holds")
    if U.dim() not in (2, 3):
        raise ValueError(f"K2': U is (T, A) or (R, T, A), got {tuple(U.shape)}")
    lead = tuple(U.shape[:-2])
    if partials.dim() != U.dim():
        raise ValueError(f"K2': partials are (nb, 2 + T·A) or (R, nb, 2 + T·A) beside U "
                         f"{tuple(U.shape)}, got {tuple(partials.shape)}")
    return (lead[0] if lead else 1), lead


def combine_tail(partials: torch.Tensor, lam_softmin: float, U: torch.Tensor,
                 max_a: torch.Tensor, clamp: bool, outputs, tickets: torch.Tensor,
                 into: torch.Tensor | None = None, step=None, advance=None):
    """K2 on one robot's (nb, 2 + T·A) or a fleet's (R, nb, 2 + T·A)
    partials, then the tail of `outputs` (one of :data:`FORMS`) on U (T, A)
    or (R, T, A) and ΔU, u_next written into `into` when given (U itself:
    in place), then with `advance` the world's cycle under the action at the
    counter `step`. Returns (β, η, ΔU, the tail's outputs). On CUDA tensors
    one launch of K2' with `tickets` (R + 1 int32 zeros), else
    :func:`combine_tail_reference`."""
    R, lead = _check_call(partials, U, outputs, into, step, advance)
    tensors = [partials, U, max_a] + ([] if into is None else [into])
    if advance is not None:
        tensors += [*advance.state, advance.xs, advance.us, advance.ts, advance.x, step]
    if not fs._on_cuda(*tensors):
        return combine_tail_reference(partials, lam_softmin, U, max_a, clamp, outputs, into, step,
                                      advance)
    out = _launch_combine_tail(partials, lam_softmin, U, max_a, clamp, outputs, tickets, into,
                               step, advance, R, lead)
    if advance is not None and not ws.has_kernel(advance.world):
        ws.advance_after(advance, out[3].action, step)  # a user world's own torch ops
    return out


def _launch_combine_tail(partials, lam, U, max_a, clamp, outputs, tickets, into, step, advance, R,
                         lead, one_block=None):
    """Check the CUDA inputs, allocate the outputs and launch K2' in the
    rule's form (:func:`~mppi_gpu_tpu_torch.ops.fused_solve.combine_one_block`),
    unless `one_block` forces one."""
    T, A = U.shape[-2:]
    fs._check_fleet(R)
    if T * A > st.MAX_ROW:
        raise ValueError(f"K2' stages a robot's sequence in one block's shared memory, at most "
                         f"{st.MAX_ROW} floats (227 KB); got T·A = {T * A}")
    nb = partials.shape[-2]
    one_block = fs._combine_form(nb, T * A, one_block, 4 * T * A)
    fs._check("partials", partials, (*lead, nb, 2 + T * A))
    st._check("U", U, U.shape)
    st._check("max_a", max_a, (A,))
    if into is not None:
        st._check("into", into, U.shape)
    if tickets.dtype != torch.int32 or tuple(tickets.shape) != (R + 1,) \
            or not tickets.is_contiguous() or tickets.device != U.device:
        raise ValueError(f"K2' takes its tickets as R + 1 = {R + 1} contiguous int32 on "
                         f"{U.device}, got {tickets.dtype} {tuple(tickets.shape)} on "
                         f"{tickets.device}")
    f32 = dict(dtype=torch.float32, device=U.device)
    beta_eta = torch.empty(*lead, 2, **f32)
    dU = torch.empty(U.shape, **f32)
    u_seq = torch.empty(U.shape, **f32) if "u_seq" in outputs else None
    u_next = action = None
    if "u_next" in outputs:
        u_next = into if into is not None else torch.empty(U.shape, **f32)
        action = torch.empty((*lead, A), **f32)
    world = ws.NO_WORLD_ARGS
    if advance is not None and ws.has_kernel(advance.world):
        kind = advance.world._kernel_kind
        if ws.WORLDS[kind][2] != A:
            raise ValueError(f"K2': the {kind} world takes {ws.WORLDS[kind][2]} actions, the "
                             f"solve gives {A}")
        world = ws.world_args(advance.world, advance.state, advance.state, R, lead,
                              (advance.xs, advance.us, advance.ts, step, advance.x))
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    def ptr(t):
        return None if t is None else t.data_ptr()

    if fs._launch(
        "combine_tail", _build.load_library().mppi_combine_tail, U.device, partials.data_ptr(), R,
        nb, T, A, float(lam), beta_eta.data_ptr(), dU.data_ptr(), U.data_ptr(), max_a.data_ptr(),
        int(clamp), ptr(u_seq), ptr(u_next), ptr(action), tickets.data_ptr(), *world,
        int(one_block),
    ):
        _LAUNCHES["combine_tail"] += 1
    tail = st.Tail(u_seq=u_seq, u_next=u_next, action=action, weights=None)
    return beta_eta[..., 0], beta_eta[..., 1], dU, tail


def reset_launch_counts() -> None:
    _LAUNCHES["combine_tail"] = 0


def launch_counts() -> dict[str, int]:
    """K2' launches that ran since the last reset."""
    return dict(_LAUNCHES)
