"""The port's own spans and counters (``mppi_gpu_tpu_torch.utils.timing``) read
against the device's trace, on one clock:

    python3 -m bench_port.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a GPU. It builds and warms the cell's driver
with the port's spans on (the set-up's spans), runs the window untraced for
``min(seconds, run.TRACE_SECONDS)``, again with the port's spans on and no
profiler, then under torch.profiler with CUDA activity alone (no host
operation recorded) and the port's spans on, between two
``torch.cuda._sleep`` markers as ``bench_port.trace`` reads them, and prints
one JSON line: the metrics of :data:`METRICS` that apply to the cell (their
readers under ``bench_port/metrics/``), the traced window's counter deltas
(``program_counters``), the µs per cycle of the three windows (the cost of
the spans, and of the profiler), each span's mean and self µs in the two
windows with spans, and the closure of the idle split against the window.

The spans are stamped with ``time.time_ns``, the clock torch.profiler stamps
its records with: a record's time is the profiler's
``kineto_results.trace_start_ns()`` plus its offset. :func:`read` puts the
device's records and the host's CUDA runtime records (``cudaGraphLaunch``)
on that clock. The harness's ``--trace 1`` run does not run this window:
that takes an edit to ``bench_port/run.py`` (PERF.md, Open questions).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from dataclasses import dataclass, field

from bench_port import run as harness
from bench_port.trace import MARKER, gaps, union

EPISODE_CELLS = ["pm3d.episode_k1e4", "q3d.fleet_r64", "q3d.episode_r1"]
HOSTLOOP_CELLS = ["pm3d.hostloop_k1e5"]
ALL_CELLS = EPISODE_CELLS + HOSTLOOP_CELLS
# the entries a ``per_layer`` list would take (``BENCHMARK.json``'s form)
METRICS = [
    {"name": "idle_us.between_episodes", "unit": "us", "better": "lower",
     "source": "device_trace", "layer": "the closed loops: device episode (runner)",
     "moves": "cycle_ms", "workloads": EPISODE_CELLS},
    {"name": "idle_us.in_episode", "unit": "us", "better": "lower", "source": "device_trace",
     "layer": "device: graph replay", "moves": "cycle_ms", "workloads": EPISODE_CELLS},
    {"name": "solve_host_us", "unit": "us", "better": "lower", "source": "program_span",
     "layer": "host loop: graphs.SolveGraph and the loop", "moves": "step_ms",
     "workloads": HOSTLOOP_CELLS},
    {"name": "idle_us.in_solve", "unit": "us", "better": "lower", "source": "device_trace",
     "layer": "host loop: graphs.SolveGraph and the loop", "moves": "step_ms",
     "workloads": HOSTLOOP_CELLS},
    {"name": "idle_us.out_of_solve", "unit": "us", "better": "lower", "source": "device_trace",
     "layer": "host loop: graphs.SolveGraph and the loop", "moves": "step_ms",
     "workloads": HOSTLOOP_CELLS},
    {"name": "setup_program_s", "unit": "s", "better": "lower", "source": "program_span",
     "layer": "set-up", "moves": "setup_s", "workloads": ALL_CELLS},
]
# the registry's counts a window reports, with every other one that moved
COUNTERS = ("graph.replay.solve", "graph.replay.episode", "graph.capture.solve",
            "graph.capture.episode", "library.build", "library.load")


@dataclass
class DeviceTrace:
    """A profiler window between its two markers, on the spans' clock (ns)."""

    t0_ns: int                                   # the first marker's end
    t1_ns: int                                   # the second marker's start
    records: list[tuple[str, int, int]]          # device records (name, start, end), by start
    runtime: list[tuple[str, int, int]] = field(default_factory=list)  # host CUDA runtime calls

    def idle(self) -> list[tuple[int, int]]:
        """The device's idle intervals in the window: outside the union of
        its records."""
        return gaps(union([(a, b) for _, a, b in self.records]), self.t0_ns, self.t1_ns)

    def busy_ns(self) -> int:
        return sum(b - a for a, b in union([(a, b) for _, a, b in self.records]))


@dataclass
class SpanRun(harness.Run):
    """``bench_port.run.Run`` with what the span readers read: the traced
    window (its cycles), its device trace, its spans and the set-up's
    spans."""

    span_window: object = None
    span_trace: DeviceTrace | None = None
    spans: list = field(default_factory=list)
    setup_spans: list = field(default_factory=list)


def _trace_start_ns(prof) -> int:
    kr = prof.profiler.kineto_results
    if hasattr(kr, "trace_start_ns"):
        return int(kr.trace_start_ns())
    return int(kr.trace_start_us()) * 1000


def read(prof) -> DeviceTrace:
    """The records of a finished profiler `prof` between its two markers:
    the device's (kernels, copies) and the host's CUDA runtime calls, each
    ``(name, start ns, end ns)`` on ``time.time_ns``'s clock."""
    from torch.autograd import DeviceType

    base = _trace_start_ns(prof)
    dev, host = [], []
    for e in prof.events():
        r = e.time_range
        rec = (e.name, base + round(r.start * 1e3), base + round(r.end * 1e3))
        (dev if e.device_type == DeviceType.CUDA else host).append(rec)
    marks = sorted((a, b) for name, a, b in dev if MARKER in name)
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker records, not 2")
    t0, t1 = marks[0][1], marks[1][0]

    def inside(recs):
        return sorted((r for r in recs if MARKER not in r[0] and r[1] >= t0 and r[2] <= t1),
                      key=lambda r: r[1])

    return DeviceTrace(t0, t1, inside(dev), inside(host))


def overlap(intervals: list[tuple[int, int]], cover: list[tuple[int, int]]) -> int:
    """Total length of `intervals` inside the union of `cover`."""
    cov = union(cover)
    starts = [a for a, _ in cov]
    total = 0
    for a, b in intervals:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(cov) and cov[i][0] < b:
            total += max(0, min(b, cov[i][1]) - max(a, cov[i][0]))
            i += 1
    return total


def episode_extents(spans: list, trace: DeviceTrace) -> list[tuple[int, int]]:
    """Each episode's device extent, its first record's start to its last
    record's end: its records are those that start after its
    ``episode.replay`` span opens and end before its ``episode.read_back``
    span closes (the two children of one ``episode``)."""
    replay = {s.parent: s for s in spans if s.name == "episode.replay"}
    starts = [a for _, a, _ in trace.records]
    out = []
    for s in spans:
        if s.name != "episode.read_back" or s.parent not in replay or s.end_ns is None:
            continue
        lo = bisect.bisect_left(starts, replay[s.parent].start_ns)
        hi = bisect.bisect_right(starts, s.end_ns)
        mine = [(a, b) for _, a, b in trace.records[lo:hi] if b <= s.end_ns]
        if mine:
            out.append((mine[0][0], max(b for _, b in mine)))
    return out


def episode_idle_ns(spans: list, trace: DeviceTrace) -> tuple[int, int]:
    """(idle between episodes, idle within them) of the window, in ns."""
    idle = trace.idle()
    within = overlap(idle, episode_extents(spans, trace))
    return sum(b - a for a, b in idle) - within, within


def solve_idle_ns(spans: list, trace: DeviceTrace) -> tuple[int, int]:
    """(idle while the host is inside ``solve``, idle outside it), in ns."""
    idle = trace.idle()
    inside = overlap(idle, [(s.start_ns, s.end_ns) for s in spans
                            if s.name == "solve" and s.end_ns is not None])
    return inside, sum(b - a for a, b in idle) - inside


def top_level_s(spans: list) -> float:
    """Seconds covered by the spans that have no parent."""
    return sum(b - a for a, b in union([(s.start_ns, s.end_ns) for s in spans
                                         if s.parent < 0 and s.end_ns is not None])) * 1e-9


def window(driver, seconds: float, cuda: bool = True):
    """The driver's window under torch.profiler with CUDA activity alone and
    the port's spans on, between two markers, with a warm-up before and
    after it inside the profiler (whose records are dropped at its edges).
    Returns (window, device trace, its spans, the registry's deltas); off a
    GPU no profiler runs and the trace is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mppi_gpu_tpu_torch.utils import timing

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mark = (lambda: torch.cuda._sleep(1000)) if cuda else (lambda: None)
    timing.drain()
    traced = profile(activities=[ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext()
    with traced as prof:
        driver.warm()
        sync()
        before = timing.counts()
        timing.enable()
        try:
            w = driver.window(seconds, mark, False)
        finally:
            timing.disable()
        after = timing.counts()
        driver.warm()
        sync()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in {*after, *COUNTERS}}
    counters = {k: v for k, v in sorted(moved.items()) if v or k in COUNTERS}
    return w, read(prof) if cuda else None, timing.drain(), counters


def span_table(spans: list) -> dict:
    """Per span name: how many, their mean µs and their mean self µs (less
    their children's)."""
    ns = [s.end_ns - s.start_ns if s.end_ns is not None else 0 for s in spans]
    kids = [0] * len(spans)
    for s, d in zip(spans, ns):
        if s.parent >= 0:
            kids[s.parent] += d
    by: dict[str, list] = {}
    for s, d, k in zip(spans, ns, kids):
        row = by.setdefault(s.name, [0, 0, 0])
        row[0], row[1], row[2] = row[0] + 1, row[1] + d, row[2] + d - k
    return {name: {"n": n, "mean_us": t / n / 1e3, "self_us": own / n / 1e3}
            for name, (n, t, own) in by.items()}


def closure(run: SpanRun) -> dict | None:
    """The idle split, plus the busy time, per cycle against the window's
    µs per cycle (its host wall time, and the trace's span)."""
    t, w = run.span_trace, run.span_window
    if t is None or not w.cycles:
        return None
    kind = "episode" if any(s.name == "episode" for s in run.spans) else "solve"
    a, b = (episode_idle_ns if kind == "episode" else solve_idle_ns)(run.spans, t)
    parts_us = (a + b + t.busy_ns()) / w.cycles / 1e3
    return {"idle_and_busy_us": parts_us, "window_us": w.wall_s * 1e6 / w.cycles,
            "trace_us": (t.t1_ns - t.t0_ns) / w.cycles / 1e3}


def execute(cell: harness.Cell, seed: int, seconds: float, device, started: float) -> dict:
    import torch

    from bench_port import drive
    from mppi_gpu_tpu_torch.utils import timing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    timing.enable()
    driver = drive.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, device)
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
    timing.disable()
    setup_s = time.perf_counter() - started
    setup_spans = timing.drain()
    span_s = min(seconds, harness.TRACE_SECONDS)
    plain = driver.window(span_s, lambda: None, False)
    timing.enable()
    bare = driver.window(span_s, lambda: None, False)
    timing.disable()
    bare_spans = timing.drain()
    w, tr, spans, counters = window(driver, span_s, cuda)
    driver.close()
    r = SpanRun(setup_s=setup_s, window=w, trace=None, untraced=plain, k1_launch=None,
                cycle_work=None, span_window=w, span_trace=tr, spans=spans,
                setup_spans=setup_spans)
    mine = [m for m in METRICS if cell.name in m["workloads"]]
    runtime = {}
    for name, _, _ in tr.runtime if tr is not None else ():
        runtime[name] = runtime.get(name, 0) + 1
    return {"metrics": harness.read_metrics(mine, r), "program_counters": counters,
            "cycles": w.cycles,
            "on_cost": {"untraced_us": plain.wall_s * 1e6 / plain.cycles,
                        "spans_us": bare.wall_s * 1e6 / bare.cycles,
                        "traced_us": w.wall_s * 1e6 / w.cycles},
            "span_us": {"traced": span_table(spans), "spans_only": span_table(bare_spans)},
            "closure": closure(r), "setup_s": setup_s, "runtime_records": runtime,
            "device": torch.cuda.get_device_name(device) if cuda else device.type}


def main(argv=None) -> int:
    started = time.perf_counter() - harness.process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_port()
    device = harness.require_chips(cell.chips)
    print(json.dumps(execute(cell, args.seed, args.seconds, device, started)))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
