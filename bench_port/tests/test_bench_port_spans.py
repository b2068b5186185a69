"""The readers of the port's own spans (``bench_port/spans.py`` and the six
metrics it lists) on synthetic spans and device records: the idle split
between and within episodes, inside and outside ``solve``, the host time
in ``solve``, the set-up's top-level spans, None where the spans or the
trace are absent (a parent without the port's spans), and the records of a
profiler put on the spans' clock."""

from __future__ import annotations

import importlib
import re

import pytest

from bench_port import drive, run, spans
from mppi_gpu_tpu_torch.utils.timing import Span

US = 1000  # ns


def _span(name, start, end, parent=-1, request=None):
    return Span(name, start * US, end * US, parent, request)


def _records(*intervals):
    return [("k", a * US, b * US) for a, b in intervals]


def _run(spans_=(), trace=None, cycles=10, setup=()):
    return spans.SpanRun(setup_s=1.0, window=None, trace=None, untraced=None, k1_launch=None,
                         cycle_work=None, span_window=drive.Window(wall_s=2e-3, cycles=cycles),
                         span_trace=trace, spans=list(spans_), setup_spans=list(setup))


def _read(name, r):
    return importlib.import_module(f"bench_port.metrics.{name.replace('.', '_')}").read(r)


def _episodes():
    """Two episodes: a copy in before the first's replays (outside it), its
    kernels and its read-back's copy; the second's kernels and copy."""
    sp = []
    for e, base in enumerate((0, 1000)):
        i = len(sp)
        sp += [_span("episode", base, base + 1000, -1, e),
               _span("episode.prepare", base + 10, base + 50, i),
               _span("episode.load", base + 50, base + 60, i),
               _span("episode.replay", base + 60, base + 500, i),
               _span("episode.read_back", base + 500, base + 1000, i)]
    recs = _records((55, 58), (100, 200), (220, 300), (300, 400), (600, 610),
                    (1100, 1200), (1250, 1300), (1600, 1610))
    return sp, spans.DeviceTrace(0, 2000 * US, recs)


def test_idle_splits_between_and_within_episodes():
    sp, tr = _episodes()
    assert spans.episode_extents(sp, tr) == [(100 * US, 610 * US), (1100 * US, 1610 * US)]
    # within: 200-220, 400-600, 1200-1250, 1300-1600; between: 0-55, 58-100, 610-1100, 1610-2000
    assert spans.episode_idle_ns(sp, tr) == (977 * US, 570 * US)
    r = _run(sp, tr, cycles=10)
    assert _read("idle_us.between_episodes", r) == pytest.approx(97.7)
    assert _read("idle_us.in_episode", r) == pytest.approx(57.0)
    for name in ("solve_host_us", "idle_us.in_solve", "idle_us.out_of_solve"):
        assert _read(name, r) is None  # no solve span in an episode cell
    c = spans.closure(r)
    assert c["idle_and_busy_us"] == pytest.approx(c["trace_us"]) == pytest.approx(200.0)
    assert c["window_us"] == pytest.approx(200.0)


def test_idle_splits_inside_and_outside_solve():
    sp = [_span("solve", 0, 300, -1, 0), _span("solve.replay", 50, 60, 0),
          _span("solve", 1000, 1300, -1, 1)]
    recs = _records((100, 250), (250, 700), (1100, 1200), (1200, 1800))
    tr = spans.DeviceTrace(0, 2000 * US, recs)
    assert spans.solve_idle_ns(sp, tr) == (200 * US, 500 * US)
    r = _run(sp, tr, cycles=2)
    assert _read("idle_us.in_solve", r) == pytest.approx(100.0)
    assert _read("idle_us.out_of_solve", r) == pytest.approx(250.0)
    assert _read("solve_host_us", r) == pytest.approx(300.0)
    assert _read("idle_us.between_episodes", r) is None and _read("idle_us.in_episode", r) is None
    c = spans.closure(r)
    assert c["idle_and_busy_us"] == pytest.approx(c["trace_us"]) == pytest.approx(1000.0)


def test_setup_reads_the_top_level_spans_once():
    setup = [_span("setup.library", 0, 2e6), _span("setup.library.build", 1e5, 1.9e6, 0),
             _span("episode", 3e6, 4e6), _span("graph.capture", 3.1e6, 3.5e6, 2),
             _span("solve", 3.9e6, 4.5e6)]
    assert _read("setup_program_s", _run(setup=setup)) == pytest.approx(3.5)


def test_readers_find_nothing_without_the_port_spans():
    parent = run.Run(setup_s=1.0, window=drive.Window(cycles=4), trace=None, untraced=None,
                     k1_launch=None, cycle_work=None)
    sp, tr = _episodes()
    for m in spans.METRICS:
        assert _read(m["name"], parent) is None
        assert _read(m["name"], _run()) is None
    assert _read("idle_us.in_episode", _run(sp, None)) is None
    assert spans.closure(_run(sp, None)) is None


def test_overlap_counts_a_cover_once():
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25), (8, 12)]) == 5 + 5
    assert spans.overlap([(0, 10)], []) == 0


class _Event:
    def __init__(self, name, cuda, start_us, end_us):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("R", (), {"start": start_us, "end": end_us})()


class _Prof:
    def __init__(self, events, base_ns):
        self._events = events
        kr = type("K", (), {"trace_start_ns": lambda self: base_ns})()
        self.profiler = type("P", (), {"kineto_results": kr})()

    def events(self):
        return self._events


def test_read_puts_the_records_on_the_spans_clock():
    base = 1_700_000_000_000_000_000
    prof = _Prof([_Event("spin_kernel", True, 1.0, 2.0), _Event("k1", True, 3.5, 4.25),
                  _Event("cudaGraphLaunch", False, 3.0, 3.2), _Event("late", True, 9.0, 11.0),
                  _Event("spin_kernel", True, 10.0, 12.0)], base)
    tr = spans.read(prof)
    assert (tr.t0_ns, tr.t1_ns) == (base + 2000, base + 10000)
    assert tr.records == [("k1", base + 3500, base + 4250)]
    assert tr.runtime == [("cudaGraphLaunch", base + 3000, base + 3200)]
    with pytest.raises(RuntimeError, match="marker"):
        spans.read(_Prof(prof._events[1:], base))


@pytest.mark.parametrize("metric", spans.METRICS, ids=lambda m: m["name"])
def test_listed_metrics_keep_the_benchmarks_form(metric):
    """Each entry as ``BENCHMARK.json``'s ``per_layer`` would take it: its
    reader, names and units of the contract, its cells reporting what it
    moves."""
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", metric["name"])
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"]) and metric["better"] == "lower"
    assert metric["source"] in ("device_trace", "program_span")
    assert 1 <= len(metric["layer"]) <= 200
    assert callable(importlib.import_module(
        f"bench_port.metrics.{metric['name'].replace('.', '_')}").read)
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in run.load_cell(cell).end_to_end}
