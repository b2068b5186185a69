"""Failure detection for the control loop.

The reference's only failure handling is print-and-exit macros around CUDA
API calls (reference include/mppi_utils.hpp:14-25) — launch failures, not
numerical ones. On TPU the runtime is memory-safe, so the failure mode that
actually matters is *numerical divergence*: NaN/Inf in the solve (exploding
surrogate dynamics, degenerate cost weights, λ→0 underflow). The guard checks
the per-step solve result on the host — the action is already fetched each
cycle, so the check is free — and raises with enough diagnostics (β, η,
weight mass, offending values) to identify which phase went bad.
"""

from __future__ import annotations

import numpy as np


class ControllerDiverged(RuntimeError):
    """The MPPI solve produced non-finite output."""

    def __init__(self, step: int, detail: str) -> None:
        super().__init__(
            f"MPPI solve diverged at control step {step}: {detail}. "
            "Typical causes: unstable/learned dynamics blowing up over the "
            "horizon, cost weights or lambda producing overflow, or a "
            "non-finite world state feeding back into the solve."
        )
        self.step = step
        self.detail = detail


def check_solve(step: int, action: np.ndarray, info) -> None:
    """Raise :class:`ControllerDiverged` if the solve output is non-finite.

    `info` is a controller SolveInfo (or None to check the action only).
    """
    action = np.asarray(action)
    if np.all(np.isfinite(action)):
        return
    detail = f"action={action.tolist()}"
    if info is not None:
        beta = float(np.asarray(info.beta))
        eta = float(np.asarray(info.eta))
        costs = np.asarray(info.costs)
        n_bad = int(np.size(costs) - np.sum(np.isfinite(costs)))
        detail += (
            f", beta={beta}, eta={eta}, non-finite rollout costs: "
            f"{n_bad}/{costs.size}"
        )
    raise ControllerDiverged(step, detail)
