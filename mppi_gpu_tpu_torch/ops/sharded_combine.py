"""K8 ``sharded_scale`` and K9 ``sharded_tail``: the one-pass sharded
combine's kernel between its two all-reduces and the sharded controller's
tail after them; K10 ``softmin_min`` and K11 ``softmin_eta``: the two-kernel
branch's softmin, one kernel before each of its collectives
(``csrc/sharded_combine.cu``); their plain versions and the dispatch
between them.

* :func:`sharded_scale` (K8) — the local ranks' rows [β_d, η_d, ΔŨ_d]
  (n, 2 + T·A), K2's unnormalized output, and β after the MIN collective →
  (n, 1 + T·A) = f_d·[η_d, ΔŨ_d] with f_d = exp((β − β_d)/λ), 0 where
  f_d = 0, which the SUM collective then adds over the ranks.
* :func:`sharded_tail` (K9) — one robot's tail on ΔU = Σ/η (``divide``,
  from that sum [η, Σ]) or on a given ΔU (the two-kernel branch): U + ΔU,
  the clamp, and the outputs asked for, as K7 computes them
  (``ops/solve_tail.py``), the softmin weights over K among them; then,
  with an :class:`~mppi_gpu_tpu_torch.ops.world_step.Advance`, the world's
  cycle at the counter `step`, as K2''s epilogue runs it. A world from user
  code (no K6 body) steps after the launch in its own torch ops.
* :func:`softmin_min` (K10) — β_d = min of each local rank's row of S
  (n, K/n), ``torch.amin``'s, before the MIN collective.
* :func:`softmin_eta` (K11) — η_d = Σ_k exp(−(S_k − β)/λ) of each row
  against β after the MIN, before the SUM collective, summed in one fixed
  order (:func:`eta_sum`); K5's softmin form (``fused_solve.weighted_update``)
  then forms the weights e_k/η after it.
* :func:`sharded_scale_reference`, :func:`sharded_tail_reference` — their
  plain versions: the torch operations of ``parallel/sharded.onepass_combine``
  between the collectives, the division, ``solve_tail_reference`` and the
  world's plain cycle, in their order; :func:`softmin_min_reference`,
  :func:`softmin_eta_reference` — K10's and K11's, those of
  ``parallel/sharded.softmin_across``.

The choice is made by the tensors' device, never by trying: a CUDA input of
another dtype, shape or layout raises, as does a failed or refused launch,
and nothing falls back to the torch combine, K7 and K6, or to the plain
version on the card. Each launch that runs counts once
(:func:`launch_counts`); a launch recorded by a CUDA graph capture runs
nothing and counts nothing, and a graph's replays are seen only in a trace.
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.ops import _rounding
from mppi_gpu_tpu_torch.ops import fused_solve as fs
from mppi_gpu_tpu_torch.ops import solve_tail as st
from mppi_gpu_tpu_torch.ops import world_step as ws
from mppi_gpu_tpu_torch.utils import timing

MAX_RANKS = 65535  # K8's, K10's and K11's grid axis y is the local rank (kMaxRanks)
# K11's fixed order: each ROW_CHUNK-entry chunk of a row is summed by
# ROW_LANES lanes, lane l taking entries l, l + ROW_LANES, … of the chunk in
# that order, then by a halving tree (lane l + lane l + h, h = ROW_LANES/2
# … 1); the chunks' sums are added in chunk order. K10 and K11 run a block
# per chunk (kRowChunk, kRowLanes)
ROW_CHUNK, ROW_LANES = 4096, 1024
# the most chunks of a row that K10 and K11 reduce in one thread-block
# cluster (kMaxCluster, Hopper's portable cluster size); a longer row takes
# scratch and a ticket
MAX_CLUSTER = 8

# launches of K8-K11 that ran (``utils/timing``'s ``launch.<kernel>``)
_LAUNCHES = timing.Counters("launch",
                            ("sharded_scale", "sharded_tail", "softmin_min", "softmin_eta"))


def row_chunks(k_loc: int) -> int:
    """The chunks of a row of k_loc entries: K10's and K11's blocks per row."""
    return -(-k_loc // ROW_CHUNK)


def row_form(k_loc: int) -> tuple[str, int]:
    """K10's and K11's form for a row of k_loc entries, with its chunks C:
    "block" (C = 1, one block), "cluster" (2 ≤ C ≤ MAX_CLUSTER, one
    thread-block cluster of the row's C blocks) or "ticket" (a block per
    chunk, scratch and a ticket per row), as ``csrc/sharded_combine.cu``
    picks it."""
    C = row_chunks(k_loc)
    return ("block" if C == 1 else "cluster" if C <= MAX_CLUSTER else "ticket"), C


def eta_sum(e: torch.Tensor) -> torch.Tensor:
    """The sum of each row of e (n, k) in K11's fixed order, in elementwise
    torch adds over a zero-padded view: (n,). On the card these adds round
    as K11's do, so the two agree bit for bit."""
    n, k = e.shape
    C = row_chunks(k)
    x = torch.nn.functional.pad(e, (0, C * ROW_CHUNK - k))
    x = x.view(n, C, ROW_CHUNK // ROW_LANES, ROW_LANES)  # [row, chunk, entry of the lane, lane]
    s = x[:, :, 0]
    for j in range(1, x.shape[2]):
        s = s + x[:, :, j]
    h = ROW_LANES // 2
    while h:
        s = s[..., :h] + s[..., h:]
        h //= 2
    total = s[:, 0, 0]
    for c in range(1, C):
        total = total + s[:, c, 0]
    return total


def softmin_min_reference(S: torch.Tensor) -> torch.Tensor:
    """K10's plain version: the min of each row of S, ``torch.amin``."""
    return torch.amin(S, 1)


def softmin_eta_reference(S: torch.Tensor, beta: torch.Tensor, lam: float) -> torch.Tensor:
    """K11's plain version: Σ exp(−(S − β)/λ) over each row of S in K11's
    order (:func:`eta_sum`)."""
    return eta_sum(torch.exp(-(S - beta) / lam))


def _check_rows(S: torch.Tensor, tickets) -> tuple[int, int]:
    """(n, K/n) of the local ranks' costs S, checked for K10 and K11."""
    if S.dim() != 2 or S.shape[1] < 1:
        raise ValueError(f"K10/K11: S is (n, K/n), got {tuple(S.shape)}")
    n = S.shape[0]
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"K10/K11 take 1 <= n <= {MAX_RANKS} rows, got {n}")
    st._check("S", S, S.shape)
    if tickets is not None and (tickets.dtype != torch.int32 or tuple(tickets.shape) != (n,)
                                or not tickets.is_contiguous()):
        raise ValueError(f"K10/K11: tickets are ({n},) contiguous int32 zeros")
    return S.shape


def _row_scratch(S: torch.Tensor, tickets):
    """K10's and K11's scratch (n, C) and tickets (n,) for rows in the
    ticket form, C > MAX_CLUSTER chunks (the caller's tickets, else new
    zeros), else (None, None): a block or a cluster needs neither."""
    n, k_loc = S.shape
    form, C = row_form(k_loc)
    if form != "ticket":
        return None, None
    if tickets is None:
        tickets = torch.zeros(n, dtype=torch.int32, device=S.device)
    return torch.empty(n, C, dtype=torch.float32, device=S.device), tickets


def softmin_min(S: torch.Tensor, tickets: torch.Tensor | None = None) -> torch.Tensor:
    """β_d (n,): the min of each local rank's row of its costs S (n, K/n),
    as ``torch.amin`` (+inf where a rank's rollouts all cost +inf, NaN where
    a NaN is present). One launch of K10 on a CUDA tensor in the rows'
    :func:`row_form`, with `tickets` ((n,) int32 zeros, the controller's;
    new ones if None) in the ticket form (unused in the others); else
    :func:`softmin_min_reference`."""
    n, k_loc = _check_rows(S, tickets)
    if not fs._on_cuda(S, *([] if tickets is None else [tickets])):
        return softmin_min_reference(S)
    beta_d = torch.empty(n, dtype=torch.float32, device=S.device)
    scratch, tickets = _row_scratch(S, tickets)
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    if fs._launch("softmin_min", _build.load_library().mppi_softmin_min, S.device, S.data_ptr(),
                  n, k_loc, beta_d.data_ptr(), _ptr(scratch), _ptr(tickets)):
        _LAUNCHES["softmin_min"] += 1
    return beta_d


def softmin_eta(S: torch.Tensor, beta: torch.Tensor, lam: float,
                tickets: torch.Tensor | None = None) -> torch.Tensor:
    """η_d (n,) = Σ_k exp(−(S_k − β)/λ) over each local rank's row of S
    (n, K/n) against β (a 0-dim tensor, the MIN collective's result) at λ
    (a Python float), summed in K11's fixed order (:func:`eta_sum`). One
    launch of K11 on CUDA tensors (the division by λ a product with
    float32(1/λ), as torch's on the card), with `tickets` as
    :func:`softmin_min`'s; else :func:`softmin_eta_reference`."""
    n, k_loc = _check_rows(S, tickets)
    st._check("beta", beta, ())
    if not fs._on_cuda(S, beta, *([] if tickets is None else [tickets])):
        return softmin_eta_reference(S, beta, lam)
    eta_d = torch.empty(n, dtype=torch.float32, device=S.device)
    scratch, tickets = _row_scratch(S, tickets)
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    if fs._launch("softmin_eta", _build.load_library().mppi_softmin_eta, S.device, S.data_ptr(),
                  n, k_loc, beta.data_ptr(), _rounding.scalar_reciprocal(lam), eta_d.data_ptr(),
                  _ptr(scratch), _ptr(tickets)):
        _LAUNCHES["softmin_eta"] += 1
    return eta_d


def _ptr(t):
    return None if t is None else t.data_ptr()


def sharded_scale_reference(rows: torch.Tensor, beta: torch.Tensor, lam: float) -> torch.Tensor:
    """K8's plain version: f_d = exp((β − β_d)/λ) over the rows' β_d, then
    f_d·[η_d, ΔŨ_d], 0 where f_d == 0 (torch operations, on any device)."""
    f = torch.exp((beta - rows[:, 0]) / lam)[:, None]
    return torch.where(f == 0, 0.0, f * rows[:, 1:])


def sharded_scale(rows: torch.Tensor, beta: torch.Tensor, lam: float) -> torch.Tensor:
    """The local ranks' rows (n, 2 + T·A) scaled by their f_d against β (a
    0-dim tensor, the MIN collective's result) at λ (a Python float):
    (n, 1 + T·A). One launch of K8 on CUDA tensors, else
    :func:`sharded_scale_reference`."""
    if rows.dim() != 2 or rows.shape[1] < 3:
        raise ValueError(f"K8: rows are (n, 2 + T·A), got {tuple(rows.shape)}")
    n, TA = rows.shape[0], rows.shape[1] - 2
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"K8 takes 1 <= n <= {MAX_RANKS} rows, got {n}")
    st._check("rows", rows, rows.shape)
    st._check("beta", beta, ())
    if not fs._on_cuda(rows, beta):
        return sharded_scale_reference(rows, beta, lam)
    out = torch.empty(n, 1 + TA, dtype=torch.float32, device=rows.device)
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    if fs._launch("sharded_scale", _build.load_library().mppi_sharded_scale, rows.device,
                  rows.data_ptr(), n, TA, beta.data_ptr(), _rounding.scalar_reciprocal(lam),
                  out.data_ptr()):
        _LAUNCHES["sharded_scale"] += 1
    return out


def sharded_tail_reference(U, dU, max_a, clamp: bool, outputs=st.OUTPUTS, softmin=None,
                           into=None, *, divide: bool = False, step=None, advance=None):
    """K9's plain version: ΔU = dU[1:]/dU[0] shaped as U with `divide`, else
    dU; ``solve_tail_reference``; then the world's plain cycle of `advance`
    under the action at the counter `step`. Returns (ΔU, the tail's
    outputs)."""
    if divide:
        dU = (dU[1:] / dU[0]).view(U.shape)
    tail = st.solve_tail_reference(U, dU, max_a, clamp, outputs, softmin, into)
    if advance is not None:
        ws.plain_advance_into(advance.world, advance.state, tail.action, advance.xs, advance.us,
                              advance.ts, step, advance.x)
    return dU, tail


def sharded_tail(U: torch.Tensor, dU: torch.Tensor, max_a: torch.Tensor, clamp: bool,
                 outputs=st.OUTPUTS, softmin=None, into: torch.Tensor | None = None, *,
                 divide: bool = False, keep_dU: bool = False, step=None, advance=None,
                 tickets: torch.Tensor | None = None):
    """One robot's tail: U (T, A), with `divide` dU the sum (1 + T·A,) =
    [η, Σ] and ΔU = Σ/η, else dU = ΔU (T, A); the outputs named in `outputs`
    (of ``solve_tail.OUTPUTS``), the weights from `softmin` = (S (K,), β, η
    0-dim, λ a Python float), u_next written into `into` when given (U
    itself: in place); then with `advance` the world's cycle under the
    action at the counter `step` (a 0-dim int64). Returns (ΔU, the tail's
    outputs); on the card ΔU is written (and returned) only with `keep_dU`
    or without `divide` (the given dU), else None. On CUDA tensors one
    launch of K9, with `tickets` (2 int32 zeros, the controller's) where a
    world steps in it; else :func:`sharded_tail_reference`."""
    unknown = set(outputs) - set(st.OUTPUTS)
    if unknown:
        raise ValueError(f"K9 writes {st.OUTPUTS}, not {sorted(unknown)}")
    if into is not None and "u_next" not in outputs:
        raise ValueError("K9: `into` receives u_next, which was not asked for")
    if ("weights" in outputs) != (softmin is not None):
        raise ValueError("K9: the weights are computed from `softmin` = (S, β, η, λ), given "
                         "exactly when they are asked for")
    if advance is not None and "action" not in outputs:
        raise ValueError("K9 steps the world under the action, which was not asked for")
    if advance is not None and not isinstance(step, torch.Tensor):
        raise TypeError("K9 steps the world at the counter a 0-dim int64 tensor holds")
    if U.dim() != 2:
        raise ValueError(f"K9: U is one robot's (T, A), got {tuple(U.shape)}")
    tensors = [U, dU, max_a] + ([] if into is None else [into])
    if softmin is not None:
        tensors += list(softmin[:3])
    if advance is not None:
        tensors += [*advance.state, advance.xs, advance.us, advance.ts, advance.x, step]
    if not fs._on_cuda(*tensors):
        return sharded_tail_reference(U, dU, max_a, clamp, outputs, softmin, into, divide=divide,
                                      step=step, advance=advance)
    out = _launch_tail(U, dU, max_a, clamp, outputs, softmin, into, divide, keep_dU, step,
                       advance, tickets)
    if advance is not None and not ws.has_kernel(advance.world):
        ws.advance_after(advance, out[1].action, step)  # a user world's own torch ops
    return out


def _launch_tail(U, dU, max_a, clamp, outputs, softmin, into, divide, keep_dU, step, advance,
                 tickets):
    """Check the CUDA inputs, allocate the outputs asked for and launch K9."""
    T, A = U.shape
    if T < 1 or A < 1:
        raise ValueError(f"K9: need T >= 1 and A >= 1, got {(T, A)}")
    if T * A > st.MAX_ROW:
        raise ValueError(f"K9 stages the sequence in one block's shared memory, at most "
                         f"{st.MAX_ROW} floats (227 KB); got T·A = {T * A}")
    st._check("U", U, U.shape)
    st._check("dU", dU, (1 + T * A,) if divide else U.shape)
    st._check("max_a", max_a, (A,))
    f32 = dict(dtype=torch.float32, device=U.device)
    if into is not None:
        st._check("into", into, U.shape)
    u_seq = torch.empty(U.shape, **f32) if "u_seq" in outputs else None
    u_next = None
    if "u_next" in outputs:
        u_next = into if into is not None else torch.empty(U.shape, **f32)
    action = torch.empty(A, **f32) if "action" in outputs else None
    dU_out = torch.empty(U.shape, **f32) if divide and keep_dU else None
    weights = S = beta = eta = None
    K, inv_lam = 0, 0.0
    if softmin is not None:
        S, beta, eta, lam = softmin
        K = S.shape[-1]
        if K < 1:
            raise ValueError("K9: the weights need K >= 1")
        st._check("S", S, (K,))
        st._check("beta", beta, (), contiguous=False)
        st._check("eta", eta, (), contiguous=False)
        inv_lam = _rounding.scalar_reciprocal(lam)
        weights = torch.empty(K, **f32)
    world = ws.NO_WORLD_ARGS
    if advance is not None and ws.has_kernel(advance.world):
        kind = advance.world._kernel_kind
        if ws.WORLDS[kind][2] != A:
            raise ValueError(f"K9: the {kind} world takes {ws.WORLDS[kind][2]} actions, the "
                             f"solve gives {A}")
        if tickets is None or tickets.dtype != torch.int32 or tuple(tickets.shape) != (2,) \
                or not tickets.is_contiguous() or tickets.device != U.device:
            raise ValueError(f"K9 steps the world with a ticket: 2 contiguous int32 on {U.device}")
        world = ws.world_args(advance.world, advance.state, advance.state, 1, (),
                              (advance.xs, advance.us, advance.ts, step, advance.x))
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    if fs._launch(
        "sharded_tail", _build.load_library().mppi_sharded_tail, U.device, U.data_ptr(),
        dU.data_ptr(), int(divide), max_a.data_ptr(), int(clamp), _ptr(u_seq), _ptr(u_next),
        _ptr(action), _ptr(dU_out), _ptr(S), _ptr(beta), _ptr(eta), inv_lam, _ptr(weights), T,
        A, K, _ptr(tickets), *world,
    ):
        _LAUNCHES["sharded_tail"] += 1
    tail = st.Tail(u_seq=u_seq, u_next=u_next, action=action, weights=weights)
    return (dU_out if divide else dU), tail


def reset_launch_counts() -> None:
    _LAUNCHES.update(dict.fromkeys(_LAUNCHES, 0))


def launch_counts() -> dict[str, int]:
    """K8's, K9's, K10's and K11's launches that ran since the last reset."""
    return dict(_LAUNCHES)
