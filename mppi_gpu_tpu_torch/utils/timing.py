"""The port's timing and tracing, in one module:

* :class:`SolveTimer`: per-solve timing, the reference's "Average controller
  execution time" metric (src/main.cu:222-224, 329-332, 376-379) plus
  percentiles. On a CUDA device a sample is the time between two CUDA events
  recorded on the current stream around the solve, read after the end event
  completes; on the CPU it is ``time.perf_counter``.
* Spans (:func:`span`): named host intervals at the port's layer boundaries
  (the host loop's ``solve`` in ``graphs``, the device ``episode`` in
  ``runner``, ``graph.capture``, ``setup.library``), off by default
  (:func:`enable`, :func:`disable`), kept in memory and handed out by
  :func:`drain`; a span's sequential steps on a hot path are its parts
  (:func:`part`). Each has its name, its start and end in integer
  nanoseconds on ``time.time_ns``'s clock, the one ``torch.profiler`` stamps
  its records with (``prof.profiler.kineto_results.trace_start_ns()`` plus a
  record's offset), the index of its parent and the request it belongs to
  (the host loop's step, an episode's ordinal within its cycle). Off, a span
  is one check of a module flag that returns a shared no-op object: no
  allocation, no clock read. The spans of one thread nest; they are not
  meant to be opened from two threads at once.
* Counters (:func:`count`, :class:`Counters`): one registry of named counts,
  always on. The kernels' launch counts of ``ops/*`` are views of it
  (``launch.<kernel>...``), as are the graphs' replays and captures
  (``graph.replay.{solve,episode}``, ``graph.capture.{solve,episode}``: a
  replay counts once, whatever it launches) and the libraries built and
  loaded (``library.build``, ``library.load``).
* :func:`profiler_trace`: an optional ``torch.profiler`` trace of a block,
  the CLI's ``--profile DIR``, with the spans of the block in the same
  Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Any, NamedTuple

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


# --------------------------------------------------------------------------
# spans


class Span(NamedTuple):
    """One recorded span. `parent` is the index of its parent among the
    spans drained with it (-1 for none); `end_ns` is None if it was still
    open when drained; `request` is its own or, where it gave none, its
    parent's."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    request: Any


_ON = False
_RECORDS: list[list] = []  # [name, start_ns, end_ns, parent index, request, a part?]
_OPEN: list[int] = []      # indices of the open spans and parts, innermost last
_DRAINS = 0                # a span opened before the last drain closes no part


class _Off:
    """The span of tracing off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "i", "drains")

    def __init__(self, rec: list, i: int) -> None:
        self.rec, self.i, self.drains = rec, i, _DRAINS

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        now = time.time_ns()
        self.rec[2] = now
        if self.drains == _DRAINS:
            while _OPEN and _OPEN[-1] != self.i:  # its part still open
                _RECORDS[_OPEN.pop()][2] = now
            if _OPEN:
                _OPEN.pop()
        return None


def span(name: str, request: Any = None):
    """A context manager around one span of `name`, a child of the innermost
    open span, for `request` (None: its parent's). Records only while
    tracing is on (:func:`enable`)."""
    if not _ON:
        return _OFF
    i = len(_RECORDS)
    rec = [name, time.time_ns(), None, _OPEN[-1] if _OPEN else -1, request, False]
    _RECORDS.append(rec)
    _OPEN.append(i)
    return _Open(rec, i)


def part(name: str) -> None:
    """Close the innermost open span's open part, if it has one, and open
    its part `name`: a child span that lasts until its next part or its own
    end. The sequential steps of a hot path (the host loop's solve) are
    parts, since a part with tracing off is one flag check and no
    ``with``."""
    if not _ON:
        return
    now = time.time_ns()
    if _OPEN and _RECORDS[_OPEN[-1]][5]:
        _RECORDS[_OPEN.pop()][2] = now
    _OPEN.append(len(_RECORDS))
    _RECORDS.append([name, now, None, _OPEN[-2] if len(_OPEN) > 1 else -1, None, True])


def tag(request: Any) -> None:
    """Give the innermost open span that is not a part `request`, once it is
    known inside it (an episode's ordinal, found in its cycle); its children
    that gave none take it."""
    if _ON:
        for i in reversed(_OPEN):
            if not _RECORDS[i][5]:
                _RECORDS[i][4] = request
                return


def enable() -> None:
    """Record spans from now on."""
    global _ON
    _ON = True


def disable() -> None:
    """Stop recording spans; those recorded stay until :func:`drain`."""
    global _ON
    _ON = False


def drain() -> list[Span]:
    """The spans recorded since the last drain, in the order they opened,
    and forget them. A span still open is handed out without its end, and
    spans opened after this have no parent."""
    global _RECORDS, _DRAINS
    recs, _RECORDS = _RECORDS, []
    _OPEN.clear()
    _DRAINS += 1
    out: list[Span] = []
    for name, start, end, parent, request, _ in recs:
        if request is None and parent >= 0:
            request = out[parent].request
        out.append(Span(name, start, end, parent, request))
    return out


# --------------------------------------------------------------------------
# counters

_COUNTS: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add `n` to the registry's count `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts(prefix: str = "") -> dict[str, int]:
    """A copy of the registry's counts whose names start with `prefix`."""
    return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}


class Counters(MutableMapping):
    """The registry's counts ``<prefix>.<key>`` as a mapping of key → count:
    a module's launch counts, keyed as the module keys them (a kernel, a
    world kind, a family, a block width). A key set that is not yet there is
    added; none is deleted."""

    def __init__(self, prefix: str, keys) -> None:
        self.prefix = prefix
        self._names: dict[Any, str] = {}
        for k in keys:
            self[k] = 0

    def __getitem__(self, key) -> int:
        return _COUNTS[self._names[key]]

    def __setitem__(self, key, value: int) -> None:
        name = self._names.get(key)
        if name is None:
            name = self._names[key] = f"{self.prefix}.{key}"
        _COUNTS[name] = value

    def __delitem__(self, key) -> None:
        raise TypeError("a counter is reset, not deleted")

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)


# --------------------------------------------------------------------------
# the profiler


def _chrome_events(spans: list[Span], base_ns: int = 0) -> list[dict]:
    """`spans` as Chrome trace events ("X") on the clock of a profiler's
    Chrome trace whose ``baseTimeNanoseconds`` is `base_ns`, in µs; a span
    still open is left out."""
    pid, tid = os.getpid(), threading.get_native_id()
    return [{"ph": "X", "cat": "port_span", "name": s.name, "pid": pid, "tid": tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"parent": s.parent, "request": repr(s.request)}}
            for s in spans if s.end_ns is not None]


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional ``torch.profiler`` trace of the block, written into `logdir`
    as a Chrome trace (the counterpart of the JAX package's
    ``jax.profiler`` hook; the reference has no profiler). The CPU's
    activity always, the card's too when CUDA is available, and the port's
    spans of the block (:func:`span`; recorded for the block, drained at its
    end) as events of category ``port_span`` on the profiler's clock. A
    `None` logdir is a no-op."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _ON
    with profile(activities=activities) as prof:
        enable()
        try:
            yield
        finally:
            if not was:
                disable()
    spans = drain()
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(_chrome_events(spans, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
