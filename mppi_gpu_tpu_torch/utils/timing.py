"""Per-solve timing — the reference's "Average controller execution time"
metric (src/main.cu:222-224, 329-332, 376-379) plus percentiles — the
timing of any call (:func:`time_fn`) and an optional ``torch.profiler``
trace.

On a CUDA device a sample is the time between two CUDA events recorded on
the current stream around the solve, read after the end event completes; on
the CPU it is ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


@dataclass
class SolveTimer:
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    samples_ms: list[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            self.samples_ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            yield
            self.samples_ms.append((time.perf_counter() - t0) * 1e3)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.samples_ms)) if self.samples_ms else float("nan")

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(self.samples_ms, q)) if self.samples_ms else float("nan")

    def summary(self, *, split_first: bool = False) -> dict[str, float]:
        """Timing summary. With `split_first` the first sample (which
        includes building and loading the kernels) is reported as `first_ms`
        and left out of the statistics."""
        samples = self.samples_ms
        out: dict[str, float] = {}
        if split_first and len(samples) >= 2:
            out["first_ms"] = samples[0]
            samples = samples[1:]
        if not samples:
            return out
        sub = SolveTimer(self.device, samples)
        out.update(n=len(samples), mean_ms=sub.mean_ms, p50_ms=sub.percentile_ms(50),
                   p95_ms=sub.percentile_ms(95), min_ms=sub.percentile_ms(0))
        return out


def time_fn(fn: Callable[..., Any], *args: Any, iters: int = 20, warmup: int = 3,
            **kwargs: Any) -> dict[str, float]:
    """Time `fn(*args, **kwargs)`: `warmup` calls (kernel builds, graph
    captures), then `iters` timed calls, each a sample of :class:`SolveTimer`
    on the device of the first tensor among the arguments and the warm-up's
    result: CUDA events around the call, read once the call's work on the
    card is done, on a CUDA device; the host clock on the CPU."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    tensors = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
    timer = SolveTimer(tensors[0].device if tensors else torch.device("cpu"))
    for _ in range(iters):
        with timer.measure():
            fn(*args, **kwargs)
    return timer.summary()


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional ``torch.profiler`` trace of the block, written into `logdir`
    as a Chrome trace (the counterpart of the JAX package's
    ``jax.profiler`` hook; the reference has no profiler). The CPU's
    activity always, the card's too when CUDA is available. A `None` logdir
    is a no-op."""
    if logdir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
