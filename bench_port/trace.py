"""Reading a torch.profiler window: the device's records between two marker
kernels, its busy time as the union of their intervals, and the idle gaps
by what the host was doing.

The arithmetic follows chip_smoke.py's readers (``device_records``,
``replay_trace``): the profiler drops records at a window's edges, so the
traced work sits between two ``torch.cuda._sleep`` markers (record
``spin_kernel``), with work before the first and after the second, and only
the records between the markers are read. Busy time here is the union of
the records' intervals, not their sum, so two overlapping records count
once.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

MARKER = "spin_kernel"
TOP = 10            # entries of each breakdown list
ATTRIBUTED = 4000   # the longest gaps attributed to a host activity one by one


@dataclass
class Trace:
    span_s: float                              # first marker's end to the second's start
    busy_s: float                              # union of the device records in the span
    records: list[tuple[str, float, float]]    # (name, start µs, duration µs)
    idle_gaps: list[tuple[str, float]]         # (host activity, seconds), longest first


def kernel_name(name: str) -> str:
    """A record's name without its argument list and return type."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0][:96]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: list[tuple[float, float]], t0: float, t1: float) -> list[tuple[float, float]]:
    """The idle intervals of [t0, t1] outside the disjoint sorted `busy`."""
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def _enclosing(events: list[tuple[float, float, str]], starts: list[float], t: float,
               back: int) -> str | None:
    """The latest-starting of the last `back` events (start, end, name), sorted
    by start, that is open at time t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - back), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def host_activity(spans, span_starts, ops, op_starts, t: float) -> str:
    """What the host was doing at time t: the benchmark's span open then
    (`spans`, its own records) and the innermost host operation open then
    (`ops`), each a list of (start, end, name) sorted by start."""
    parts = [p for p in (_enclosing(spans, span_starts, t, 4),
                         _enclosing(ops, op_starts, t, 64)) if p]
    return "/".join(parts) if parts else "host outside any traced call"


def read(prof) -> Trace:
    """The window of a finished profiler `prof` between its two markers."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("bench."):  # a span's own record on the device's timeline
                dev.append((e.name, r.start, r.end))
        elif e.device_type == DeviceType.CPU:
            cpu.append((r.start, r.end, e.name))
    marks = sorted((a, b) for name, a, b in dev if MARKER in name)
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker records, not 2")
    t0, t1 = marks[0][1], marks[1][0]
    inside = [(n, a, b) for n, a, b in dev if MARKER not in n and a >= t0 and b <= t1]
    busy = union([(a, b) for _, a, b in inside])
    idle = sorted(gaps(busy, t0, t1), key=lambda g: g[0] - g[1])
    cpu.sort()
    spans = [c for c in cpu if c[2].startswith("bench.")]
    ops = [c for c in cpu if not c[2].startswith("bench.")]
    span_starts, op_starts = [c[0] for c in spans], [c[0] for c in ops]
    by: dict[str, float] = {}
    for a, b in idle[:ATTRIBUTED]:
        key = host_activity(spans, span_starts, ops, op_starts, 0.5 * (a + b))
        by[key] = by.get(key, 0.0) + (b - a) * 1e-6
    rest = sum(b - a for a, b in idle[ATTRIBUTED:]) * 1e-6
    if rest:
        by[f"shorter gaps than the {ATTRIBUTED} longest"] = rest
    return Trace(span_s=(t1 - t0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 records=[(kernel_name(n), a, b - a) for n, a, b in inside],
                 idle_gaps=sorted(by.items(), key=lambda kv: -kv[1])[:TOP])


def device_ops(trace: Trace) -> list[tuple[str, float]]:
    """Device seconds by record name, the largest first."""
    by: dict[str, float] = {}
    for name, _, d in trace.records:
        by[name] = by.get(name, 0.0) + d * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]


def device_us(trace: Trace, pattern: str) -> tuple[int, float]:
    """(records, device µs) of the records whose name matches `pattern`."""
    rx = re.compile(pattern)
    hits = [d for name, _, d in trace.records if rx.search(name)]
    return len(hits), sum(hits)
