"""The port's spans and counters (``mppi_gpu_tpu_torch/utils/timing.py``) on
the CPU:

- a span's record: its name, its parent's index, its request (its own, a
  tag, or its parent's), its start and end; ``drain`` handing them out once;
- tracing off: nothing recorded, one shared object for every span;
- the registry: each module's launch counts a view of it, with the keys
  and numbers its dict had, reset and isolated as the tests isolate them;
- the spans and counts of the device episode's loop on the CPU (no graph:
  no capture, no replay counted), of the host loop's graphed solve with its
  capture stubbed (the key, the copies in, the replay, the copy out; one
  capture, a replay counted per later call), of ``graphs.capture`` with
  torch's CUDA calls stubbed, and of a library's load that builds or finds
  it built (the native worlds, built by g++ into a directory of the test);
- ``profiler_trace``: the spans in the one Chrome trace, on the profiler's
  clock.

Tests marked ``gpu`` show on the card that a span encloses the device record
of the work it launched and waited for, on the profiler's clock, and that
the host loop's and the episode's spans enclose their ``cudaGraphLaunch``
records; they skip without a CUDA device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu_torch import graphs  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.envs import native  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, combine_tail, fused_solve, sharded_combine  # noqa: E402
from mppi_gpu_tpu_torch.ops import solve_tail, world_step  # noqa: E402
from mppi_gpu_tpu_torch.runner import (  # noqa: E402
    run_closed_loop,
    run_episode_jit,
    run_fleet_episode,
)
from mppi_gpu_tpu_torch.utils import timing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each module's launch counts as its dict keyed them before the registry
LAUNCH_KEYS = {
    fused_solve: ("solve_partials", "softmin_combine", "noise_dump", "rollout_costs",
                  "weighted_update"),
    solve_tail: ("solve_tail",),
    combine_tail: ("combine_tail",),
    sharded_combine: ("sharded_scale", "sharded_tail", "softmin_min", "softmin_eta"),
    world_step: tuple(world_step.WORLDS),
}


def _config(name: str = "point_mass2d", K: int = 64, T: int = 8):
    return load_config(os.path.join(ROOT, "configs", f"{name}.yaml")).replace(samples=K, horizon=T)


@pytest.fixture
def tracing():
    """Spans on for the test, drained before and after it."""
    timing.drain()
    timing.enable()
    yield
    timing.disable()
    timing.drain()


def _tree(spans) -> list[tuple[str, str | None]]:
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


# ---------------------------------------------------------------------------
# spans


def test_span_records_nesting_parents_and_requests(tracing):
    with timing.span("a", request=7):
        with timing.span("a.b"):
            with timing.span("a.b.c", request=8):
                pass
        with timing.span("a.d"):
            pass
    with timing.span("e"):
        timing.tag("late")
        with timing.span("e.f"):
            pass
    got = timing.drain()
    assert _tree(got) == [("a", None), ("a.b", "a"), ("a.b.c", "a.b"), ("a.d", "a"),
                          ("e", None), ("e.f", "e")]
    assert [s.parent for s in got] == [-1, 0, 1, 0, -1, 4]
    assert [s.request for s in got] == [7, 7, 8, 7, "late", "late"]
    for s in got:
        parent = got[s.parent] if s.parent >= 0 else None
        assert isinstance(s.start_ns, int) and s.start_ns <= s.end_ns
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert got[1].end_ns <= got[3].start_ns and got[3].end_ns <= got[4].start_ns


def test_parts_follow_one_another_and_close_with_their_span(tracing):
    """A part closes at the next part or at its span's end; a span opened in
    a part is the part's child; a part off a span has no parent."""
    with timing.span("s", request=1):
        timing.part("s.a")
        with timing.span("inner"):
            pass
        timing.part("s.b")
    timing.part("loose")
    timing.part("loose.next")
    got = timing.drain()
    assert _tree(got) == [("s", None), ("s.a", "s"), ("inner", "s.a"), ("s.b", "s"),
                          ("loose", None), ("loose.next", None)]
    assert [s.request for s in got[:4]] == [1] * 4
    assert got[1].end_ns == got[3].start_ns and got[3].end_ns == got[0].end_ns
    assert got[2].end_ns <= got[1].end_ns and got[4].end_ns == got[5].start_ns
    assert got[5].end_ns is None  # open when drained


def test_drain_hands_each_span_out_once(tracing):
    with timing.span("one"):
        pass
    assert [s.name for s in timing.drain()] == ["one"]
    assert timing.drain() == []
    with timing.span("open"):
        held = timing.drain()
        with timing.span("after"):
            pass
    assert [(s.name, s.end_ns) for s in held] == [("open", None)]
    assert [(s.name, s.parent) for s in timing.drain()] == [("after", -1)]


def test_an_exception_closes_its_spans(tracing):
    with pytest.raises(ValueError), timing.span("outer"), timing.span("inner"):
        raise ValueError("out")
    with timing.span("next"):
        pass
    assert [(s.name, s.parent, s.end_ns is not None) for s in timing.drain()] == [
        ("outer", -1, True), ("inner", 0, True), ("next", -1, True)]


def test_off_records_nothing_and_shares_one_object():
    timing.drain()
    first = timing.span("a", request=1)
    with first, timing.span("b") as second:
        timing.tag(3)
        timing.part("c")
    assert first is second is timing.span("c")
    assert timing.drain() == []
    timing.enable()
    timing.disable()
    with timing.span("still off"):
        pass
    assert timing.drain() == []


# ---------------------------------------------------------------------------
# counters


@pytest.mark.parametrize("module", list(LAUNCH_KEYS), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launch_counts_are_views_of_the_registry(module, monkeypatch):
    """Each module's ``_LAUNCHES`` keeps its dict's keys and numbers, and
    its counts live in the registry under ``launch.``."""
    keys = LAUNCH_KEYS[module]
    module.reset_launch_counts()
    assert module.launch_counts() == dict.fromkeys(keys, 0)
    module._LAUNCHES[keys[-1]] += 2
    module._LAUNCHES[keys[0]] += 1
    got = module.launch_counts()
    assert got == {**dict.fromkeys(keys, 0), keys[0]: got[keys[0]], keys[-1]: got[keys[-1]]}
    assert got[keys[-1]] == 2 + (keys[0] == keys[-1])
    names = {k: n for k, n in timing.counts("launch").items() if n and k.rsplit(".", 1)[1] in keys}
    assert sum(names.values()) == 3
    # the tests' isolation: a copy in the view's place takes the counts
    monkeypatch.setattr(module, "_LAUNCHES", dict(module._LAUNCHES))
    module._LAUNCHES[keys[0]] += 5
    monkeypatch.undo()
    assert module.launch_counts() == got
    module.reset_launch_counts()
    assert module.launch_counts() == dict.fromkeys(keys, 0)
    assert not any(timing.counts(f"launch.{k}").get(f"launch.{k}") for k in keys)


def test_family_and_width_counts_are_views_too():
    fs = fused_solve
    fs.reset_launch_counts()
    by_family = fs._FAMILY_LAUNCHES["solve_partials"]
    by_family["bicycle"] = by_family.get("bicycle", 0) + 1  # a family registered later
    fs._WIDTH_LAUNCHES["rollout_costs"][fs.BLOCK] += 1
    assert fs.family_launch_counts()["bicycle"] == 1 and fs.family_launch_counts()["lti"] == 0
    assert fs.width_launch_counts("rollout_costs") == {fs.SLAB_WIDTH: 0, fs.BLOCK: 1}
    assert timing.counts("launch.solve_partials.family.bicycle") == {
        "launch.solve_partials.family.bicycle": 1}
    assert timing.counts(f"launch.rollout_costs.width.{fs.BLOCK}") == {
        f"launch.rollout_costs.width.{fs.BLOCK}": 1}
    fs.reset_launch_counts()
    assert fs.family_launch_counts()["bicycle"] == 0 and sum(fs.width_launch_counts().values()) == 0
    with pytest.raises(TypeError):
        del by_family["bicycle"]


def test_count_adds_to_a_name():
    before = timing.counts("test.only").get("test.only", 0)
    timing.count("test.only")
    timing.count("test.only", 4)
    assert timing.counts("test.only") == {"test.only": before + 5}


# ---------------------------------------------------------------------------
# the port's spans and counts


@pytest.mark.parametrize("fleet", [False, True])
def test_cpu_episode_records_its_spans_and_counts_no_graph(fleet, tracing):
    """Two episodes of one cycle's cache on the CPU: each an ``episode``
    span, its request the ordinal, around prepare, load, the cycles and the
    read-back; nothing captured, no replay counted."""
    cfg = _config()
    before = timing.counts("graph.")
    if fleet:
        ctrl = BatchedMPPIController(cfg, 2, device="cpu")
        for _ in range(2):
            run_fleet_episode(ctrl, num_steps=3)
    else:
        ctrl = MPPIController(cfg, device="cpu")
        for _ in range(2):
            run_episode_jit(ctrl, num_steps=3)
    got = timing.drain()
    one = [("episode", None), ("episode.prepare", "episode"), ("episode.load", "episode"),
           ("episode.replay", "episode"), ("episode.read_back", "episode")]
    assert _tree(got) == one * 2
    assert [s.request for s in got] == [0] * 5 + [1] * 5
    assert got[3].end_ns - got[3].start_ns > got[2].end_ns - got[2].start_ns
    assert timing.counts("graph.") == before


def _stub_capture(fn, device):
    """``graphs.capture`` on the CPU: the warm-up, one more call as the
    captured output, and a replay that runs the function again into it."""
    warm, out = fn(), fn()

    class Graph:
        def replay(self) -> None:
            out.copy_(fn())

    return Graph(), warm, out


def test_graphed_solve_spans_and_counts_with_the_capture_stubbed(monkeypatch, tracing):
    """Three steps of the host loop's graphed solve: the first builds the
    graph (one capture counted; the warm-up's result, no replay), the later
    two replay it (one replay each); every step a ``solve`` span for its
    step, the key, the copies in, the replay and the copy out its parts.
    The op-by-op solve records and counts nothing."""
    monkeypatch.setattr(graphs, "capture", _stub_capture)
    monkeypatch.setattr(graphs, "replays", lambda device, capture: capture)
    before = timing.counts("graph.")
    ctrl = MPPIController(_config(), device="cpu")
    run_closed_loop(ctrl, max_steps=3)
    got = timing.drain()
    first = [("solve", None), ("solve.key", "solve"), ("solve.read_out", "solve")]
    later = [("solve", None), ("solve.key", "solve"), ("solve.load", "solve"),
             ("solve.replay", "solve"), ("solve.read_out", "solve")]
    assert _tree(got) == first + later * 2
    assert [s.request for s in got] == [0] * 3 + [1] * 5 + [2] * 5
    after = timing.counts("graph.")
    assert after.get("graph.capture.solve", 0) - before.get("graph.capture.solve", 0) == 1
    assert after.get("graph.replay.solve", 0) - before.get("graph.replay.solve", 0) == 2
    assert after.get("graph.replay.episode") == before.get("graph.replay.episode")
    # op by op (``capture=False``): no span, nothing counted
    run_closed_loop(ctrl, max_steps=2, capture=False)
    assert timing.drain() == [] and timing.counts("graph.") == after


def test_capture_is_a_span(monkeypatch, tracing):
    """``graphs.capture`` with torch's CUDA calls stubbed: one
    ``graph.capture`` span around the warm-up and the captured call."""
    class Stream:
        def __init__(self, device=None) -> None:
            pass

        def wait_stream(self, other) -> None:
            pass

    @contextlib.contextmanager
    def nothing(*args, **kwargs):
        yield

    monkeypatch.setattr(torch.cuda, "device", nothing)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream(d))
    monkeypatch.setattr(torch.cuda, "stream", nothing)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", nothing)

    def fn():
        with timing.span("work"):
            return 1

    graphs.capture(fn, torch.device("cuda", 0))
    assert _tree(timing.drain()) == [("graph.capture", None), ("work", "graph.capture"),
                                     ("work", "graph.capture")]
    assert gc.isenabled()


def test_setup_library_marks_a_build_or_a_load(tmp_path, monkeypatch, tracing):
    """The native worlds' library into an empty build directory: a
    ``setup.library`` span with a ``setup.library.build`` child, one build
    and one load counted; loaded again, the span alone and a load."""
    if not native.native_available():
        pytest.skip("no C++ toolchain for the native worlds")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIBRARIES", {})
    timing.drain()
    before = timing.counts("library.")
    native.load_library()
    built = timing.counts("library.")
    monkeypatch.setattr(native, "_LIBRARIES", {})
    native.load_library()
    again = timing.counts("library.")
    assert _tree(timing.drain()) == [("setup.library", None),
                                     ("setup.library.build", "setup.library"),
                                     ("setup.library", None)]
    assert built.get("library.build", 0) - before.get("library.build", 0) == 1
    assert [n.get("library.load", 0) for n in (before, built, again)] == [
        before.get("library.load", 0) + i for i in range(3)]
    assert again.get("library.build") == built.get("library.build")


def test_profiler_trace_writes_the_spans_on_its_clock(tmp_path):
    """``profiler_trace`` around a CPU episode: the one Chrome trace holds
    the episode's spans (category ``port_span``), and the episode's span
    encloses every operator the profiler recorded in the block, on the
    trace's clock. Spans are off again after the block."""
    logdir = tmp_path / "trace"
    ctrl = MPPIController(_config(), device="cpu")
    run_episode_jit(ctrl, num_steps=2)  # built and cached outside the block
    timing.drain()
    with timing.profiler_trace(str(logdir)):
        run_episode_jit(ctrl, num_steps=2)
    assert timing.span("a") is timing.span("b") and timing.drain() == []
    files = list(logdir.iterdir())
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "port_span"}
    assert set(spans) == {"episode", "episode.prepare", "episode.load", "episode.replay",
                          "episode.read_back"}
    ep = spans["episode"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(ep["ts"] <= e["ts"] and e["ts"] + e["dur"] <= ep["ts"] + ep["dur"]
                       for e in ops)
    assert spans["episode.replay"]["args"]["parent"] >= 0


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's device records come from the card")
    return "cuda"


def _records(prof):
    """Every record of a finished profiler as (name, on the device, start ns,
    end ns) on ``time.time_ns``'s clock."""
    from torch.autograd import DeviceType

    base = prof.profiler.kineto_results.trace_start_ns()
    return [(e.name, e.device_type == DeviceType.CUDA, base + round(e.time_range.start * 1e3),
             base + round(e.time_range.end * 1e3)) for e in prof.events()]


@pytest.mark.gpu
def test_a_span_encloses_its_kernel_on_the_profiler_clock(cuda):
    """20 spans, each around a ``torch.cuda._sleep`` and a synchronize,
    under torch.profiler with CUDA activity alone: each span's start is
    before its kernel's device record starts and its end after the record
    ends. The margins are printed (run with ``-s``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    timing.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timing.enable()
        try:
            for _ in range(20):
                with timing.span("sleep"):
                    torch.cuda._sleep(200_000)
                    torch.cuda.synchronize()
        finally:
            timing.disable()
    spans = timing.drain()
    kernels = sorted((a, b) for name, dev, a, b in _records(prof) if dev and "spin" in name)
    assert len(spans) == len(kernels) == 20
    lead = [a - s.start_ns for s, (a, b) in zip(spans, kernels)]
    lag = [s.end_ns - b for s, (a, b) in zip(spans, kernels)]
    print(f"span start before its kernel: {min(lead)}-{max(lead)} ns; "
          f"span end after it: {min(lag)}-{max(lag)} ns")
    assert min(lead) > 0 and min(lag) > 0


@pytest.mark.gpu
def test_profile_trace_holds_the_spans_on_the_card(cuda, tmp_path):
    """``profiler_trace`` around the host loop on the card: in the one
    Chrome trace every ``cudaGraphLaunch`` runtime event lies inside a
    ``solve.replay`` span's event, on the trace's clock."""
    ctrl = MPPIController(_config(K=1024, T=20), device=cuda)
    run_closed_loop(ctrl, max_steps=2)
    with timing.profiler_trace(str(tmp_path)):
        run_closed_loop(ctrl, max_steps=4)
    (path,) = list(tmp_path.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    replays = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "port_span" and e["name"] == "solve.replay"]
    launches = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == "cudaGraphLaunch"]
    assert len(replays) == len(launches) == 4
    assert all(any(a <= c and d <= b for a, b in replays) for c, d in launches)


@pytest.mark.gpu
def test_host_loop_and_episode_spans_enclose_their_graph_launches(cuda):
    """The host loop's graphed solve and a device episode on the card, under
    torch.profiler with CUDA activity alone: every ``cudaGraphLaunch``
    runtime record lies inside a ``solve.replay`` (host loop) or the
    ``episode.replay`` span (episode), and each replay span holds one
    (solve) or the episode's n (episode)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _config(K=1024, T=20)
    ctrl = MPPIController(cfg, device=cuda)
    run_closed_loop(ctrl, max_steps=3)
    run_episode_jit(ctrl, num_steps=10)
    torch.cuda.synchronize()
    timing.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timing.enable()
        try:
            run_closed_loop(ctrl, max_steps=5)
            run_episode_jit(ctrl, num_steps=10)
        finally:
            timing.disable()
        torch.cuda.synchronize()
    spans = timing.drain()
    launches = [(a, b) for name, dev, a, b in _records(prof)
                if not dev and name == "cudaGraphLaunch"]
    held = {"solve.replay": [], "episode.replay": []}
    for s in spans:
        if s.name in held:
            held[s.name].append(sum(s.start_ns <= a and b <= s.end_ns for a, b in launches))
    assert held == {"solve.replay": [1] * 5, "episode.replay": [10]}
    assert len(launches) == 15
