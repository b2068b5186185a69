"""K7 ``solve_tail``: the tail of one MPPI update for R robots in one launch
(``csrc/solve_tail.cu``), its plain version and the dispatch between them.

* :func:`solve_tail` — what the controller's tail (``controller._finish``,
  ``_finish_fused``) runs: u_new = U + ΔU, clamped to ±max_a, and from it
  only the outputs the caller asks for: the updated sequence ``u_seq``
  (u_new), the shifted sequence ``u_next`` (u_new[t + 1], the last action
  repeated; optionally written over a given buffer, which may be U itself),
  the ``action`` u_new[0] and the softmin ``weights`` exp(−(S − β)/λ)/η
  over K. On a CUDA device one launch of K7; on the CPU the plain version.
* :func:`solve_tail_reference` — K7's plain version: the torch operations
  the tail ran before K7, in their order.

The choice is made by the tensors' device, never by trying: a CUDA input of
another dtype, shape or layout raises, as does a failed or refused launch,
and nothing falls back to the plain version on the card. Each launch that
runs counts once (:func:`launch_counts`); a launch recorded by a CUDA graph
capture runs nothing and counts nothing, and a graph's replays are seen only
in a trace.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.ops import _rounding
from mppi_gpu_tpu_torch.ops.fused_solve import _launch
from mppi_gpu_tpu_torch.utils import timing

MAX_ROW = 232448 // 4  # floats of one robot's sequence K7 stages in shared memory (kMaxRowBytes)
MAX_ROBOTS = 65535     # the C entry's bound on R
OUTPUTS = ("u_seq", "u_next", "action", "weights")
# the tails without the weights: an inner iteration of iterated MPPI keeps
# only the updated sequence; the device episode's cycle reads the action and
# the shifted sequence (as XLA drops the rest of the jitted episode's solve)
ITERATE = ("u_seq",)
CYCLE = ("u_next", "action")

# launches of K7 that ran (``utils/timing``'s ``launch.solve_tail``)
_LAUNCHES = timing.Counters("launch", ("solve_tail",))


class Tail(NamedTuple):
    """The tail's outputs, None where not asked for; a leading robot axis
    passes through."""

    u_seq: torch.Tensor | None    # (..., T, A) u_new
    u_next: torch.Tensor | None   # (..., T, A) u_new shifted, the last action repeated
    action: torch.Tensor | None   # (..., A) u_new[0]
    weights: torch.Tensor | None  # (..., K) exp(−(S − β)/λ)/η


def shift_action_seq(u_seq: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift with repeated last action along the horizon
    axis of a (T, a) or fleet (R, T, a) sequence (reference `shift_act`,
    src/point_mass.cu:805-824)."""
    return torch.cat([u_seq[..., 1:, :], u_seq[..., -1:, :]], dim=-2)


def softmin_of(S: torch.Tensor, beta: torch.Tensor, eta: torch.Tensor, lambda_: float) -> torch.Tensor:
    """The softmin weights exp(−(S − β)/λ)/η with β, η of shape () or (R,)
    against S of (K,) or (R, K), λ a Python float, as torch ops."""
    b, e = (beta, eta) if beta.dim() == 0 else (beta[:, None], eta[:, None])
    return torch.exp(-(S - b) / lambda_) / e


def solve_tail_reference(U, dU, max_a, clamp: bool, outputs=OUTPUTS, softmin=None,
                         into: torch.Tensor | None = None) -> Tail:
    """K7's plain version: the outputs of `outputs`, the weights from
    `softmin` = (S, β, η, λ); ``u_next`` copied into `into` when given (and
    `into` returned as it)."""
    u_new = U + dU
    if clamp:
        u_new = torch.clamp(u_new, -max_a, max_a)
    u_next = None
    if "u_next" in outputs:
        u_next = shift_action_seq(u_new)
        if into is not None:
            u_next = into.copy_(u_next)
    return Tail(u_seq=u_new if "u_seq" in outputs else None, u_next=u_next,
                action=u_new[..., 0, :] if "action" in outputs else None,
                weights=softmin_of(*softmin) if "weights" in outputs else None)


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...], contiguous: bool = True) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"K7: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"K7: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"K7: {name} must be contiguous")


def _on_cuda(tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the solve's tail has inputs on {sorted(map(str, devices))}")
    return devices.pop().type == "cuda"


def solve_tail(U: torch.Tensor, dU: torch.Tensor, max_a: torch.Tensor, clamp: bool,
               outputs=OUTPUTS, softmin=None, into: torch.Tensor | None = None) -> Tail:
    """The tail of one update: U, ΔU (T, A) or (R, T, A), max_a (A,); the
    outputs named in `outputs` (of :data:`OUTPUTS`), the weights from
    `softmin` = (S (K,) or (R, K), β, η of shape () or (R,), λ a Python
    float), ``u_next`` written into `into` when given (U's shape; it may be U
    itself, shifted in place). On CUDA tensors one launch of K7, else
    :func:`solve_tail_reference`."""
    unknown = set(outputs) - set(OUTPUTS)
    if unknown:
        raise ValueError(f"K7 writes {OUTPUTS}, not {sorted(unknown)}")
    if into is not None and "u_next" not in outputs:
        raise ValueError("K7: `into` receives u_next, which was not asked for")
    if ("weights" in outputs) != (softmin is not None):
        raise ValueError("K7: the weights are computed from `softmin` = (S, β, η, λ), given "
                         "exactly when they are asked for")
    tensors = [U, dU, max_a] + ([] if into is None else [into])
    if softmin is not None:
        tensors += list(softmin[:3])
    if not _on_cuda(tensors):
        return solve_tail_reference(U, dU, max_a, clamp, outputs, softmin, into)
    return _launch_tail(U, dU, max_a, clamp, outputs, softmin, into)


def _launch_tail(U, dU, max_a, clamp, outputs, softmin, into) -> Tail:
    """Check the CUDA inputs, allocate the outputs asked for and launch K7."""
    if U.dim() not in (2, 3):
        raise ValueError(f"K7: U is (T, A) or (R, T, A), got {tuple(U.shape)}")
    lead, (T, A) = tuple(U.shape[:-2]), tuple(U.shape[-2:])
    R = lead[0] if lead else 1
    if not 1 <= R <= MAX_ROBOTS:
        raise ValueError(f"K7 takes 1 <= R <= {MAX_ROBOTS} robots, got {R}")
    if T < 1 or A < 1:
        raise ValueError(f"K7: need T >= 1 and A >= 1, got {(T, A)}")
    if T * A > MAX_ROW:
        raise ValueError(f"K7 stages a robot's sequence in one block's shared memory, at most "
                         f"{MAX_ROW} floats (227 KB); got T·A = {T * A}")
    _check("U", U, U.shape)
    _check("dU", dU, U.shape)
    _check("max_a", max_a, (A,))
    f32 = dict(dtype=torch.float32, device=U.device)
    if into is not None:
        _check("into", into, U.shape)
    u_seq = torch.empty(U.shape, **f32) if "u_seq" in outputs else None
    u_next = None
    if "u_next" in outputs:
        u_next = into if into is not None else torch.empty(U.shape, **f32)
    action = torch.empty((*lead, A), **f32) if "action" in outputs else None
    weights = S = beta = eta = None
    b_stride = e_stride = K = 0
    inv_lam = 0.0
    if softmin is not None:
        S, beta, eta, lam = softmin
        K = S.shape[-1]
        _check("S", S, (*lead, K))
        for name, v in (("beta", beta), ("eta", eta)):
            _check(name, v, lead, contiguous=False)
        if K < 1:
            raise ValueError("K7: the weights need K >= 1")
        b_stride, e_stride = (beta.stride(0), eta.stride(0)) if lead else (0, 0)
        inv_lam = _rounding.scalar_reciprocal(lam)
        weights = torch.empty(S.shape, **f32)
    from mppi_gpu_tpu_torch.ops import _build  # built at the first launch, not at import

    lib = _build.load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    if _launch(
        "solve_tail", lib.mppi_solve_tail, U.device, U.data_ptr(), dU.data_ptr(),
        max_a.data_ptr(), int(clamp), ptr(u_seq), ptr(u_next), ptr(action), ptr(S), ptr(beta),
        b_stride, ptr(eta), e_stride, inv_lam, ptr(weights), R, T, A, K,
    ):
        _LAUNCHES["solve_tail"] += 1
    return Tail(u_seq=u_seq, u_next=u_next, action=action, weights=weights)


def reset_launch_counts() -> None:
    _LAUNCHES["solve_tail"] = 0


def launch_counts() -> dict[str, int]:
    """K7's launches that ran since the last reset."""
    return dict(_LAUNCHES)
