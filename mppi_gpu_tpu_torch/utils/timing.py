"""Per-solve timing — the reference's "Average controller execution time"
metric (src/main.cu:222-224, 329-332, 376-379) plus percentiles — and an
optional ``torch.profiler`` trace.

On a CUDA device a sample is the time between two CUDA events recorded on
the current stream around the solve, read after the end event completes; on
the CPU it is ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


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
        out.update(
            n=len(samples),
            mean_ms=float(np.mean(samples)),
            p50_ms=float(np.percentile(samples, 50)),
            p95_ms=float(np.percentile(samples, 95)),
            min_ms=float(np.min(samples)),
        )
        return out


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
