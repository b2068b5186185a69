"""The counting functions against counts done by hand, and the arithmetic of
the readings: a tail of every step, a busy time that is a union."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import drive, run, trace, work
from bench_port.metrics import (
    cycle_mfu,
    host_us_per_step,
    idle_pct,
    k1_roofline,
    nccl_us,
    sharded_combine_us,
    step_ms_p95,
)

PEAK = work.PEAKS["sms"] * work.PEAKS["boost_hz"]


def test_lti_counts_by_hand():
    # A = 3, s = 6. Draw: Philox 10 × (2 wide multiplies + 2 XOR3) + 1 add + 4
    # shifts = 45 int; 4 conversions; sfu log1p, sqrt twice, cos, sin, cos =
    # 7; fp32 2 pairs × (2 scalings, −2·, 2π·) = 8, r·cos/sin 3, σ· 3 = 14.
    # Step 3 × (add, 3 FMA) = 12; cost 3 FMA + 1 mul, 6 × (sub, mul, FMA), 1 add = 23.
    c = work.k1_launch("lti", 1, 1, 1, 3, 6)
    assert (c["int"], c["cvt"], c["sfu"]) == (45, 4, 7)
    assert c["fp32"] == 14 + 12 + 23 + 19  # + the final cost once more (18 + 1)
    assert c["bytes"] == 4 * (3 + 6 + 1)


def test_quadrotor3d_counts_by_hand():
    # A = 4: two whole pairs: 8 sfu + the step's rsqrt; fp32 draw 2 × 4 + 4 + 4 = 16.
    c = work.k1_launch("quadrotor3d", 2, 3, 5, 4, 13)
    n = 2 * 3
    derivs = 2 + 12 + 16 + 9
    step = 4 + 2 * derivs + 10 + 4 + 4 + 4 + 9 + 31
    assert c["fp32"] == n * 5 * (16 + step) + n * 26
    assert (c["int"], c["sfu"], c["cvt"]) == (n * 5 * 45, n * 5 * 9, n * 5 * 4)


def test_bound_takes_the_slowest_class():
    c = work.k1_launch("lti", 1, 10_000, 200, 3, 6)
    least, cls = work.bound(c)
    assert cls == "issue"
    per = c["fp32"] + c["int"] + c["sfu"] + c["cvt"]
    assert least == pytest.approx(per / (PEAK * 128))


def test_union_counts_overlaps_once_and_idle_is_its_complement():
    busy = trace.union([(0, 4), (2, 6), (10, 12), (11, 11.5)])
    assert busy == [(0, 6), (10, 12)]
    assert trace.gaps(busy, -1, 20) == [(-1, 0), (6, 10), (12, 20)]
    t = trace.Trace(span_s=20e-6, busy_s=8e-6, records=[], idle_gaps=[])
    r = run.Run(setup_s=1.0, window=drive.Window(cycles=4), trace=t,
                untraced=drive.Window(wall_s=10e-6, cycles=2), k1_launch=None,
                cycle_work=work.k1_launch("lti", 1, 100, 10, 3, 6))
    assert idle_pct.read(r) == pytest.approx(60.0)
    assert host_us_per_step.read(r) is None  # not a host loop
    r.window.latencies_s = [1e-3] * 4
    assert host_us_per_step.read(r) == pytest.approx(5.0 - 2.0)
    least, _ = work.bound(r.cycle_work)
    assert cycle_mfu.read(r) == pytest.approx(100 * least * 4 / 20e-6)


def test_k1_roofline_reads_only_k1_records():
    c = work.k1_launch("lti", 1, 10_000, 200, 3, 6)
    least, _ = work.bound(c)
    rec = [("slab_partials_kernel<Lti<3> >", 0.0, 60.0), ("combine_tail_kernel<PointMass3>", 60, 7),
           ("solve_partials_kernel<Lti<3> >", 70.0, 70.0)]
    t = trace.Trace(span_s=1e-3, busy_s=1e-4, records=rec, idle_gaps=[])
    r = run.Run(setup_s=1.0, window=drive.Window(cycles=2), trace=t, untraced=None, k1_launch=c,
                cycle_work=c)
    assert k1_roofline.read(r) == pytest.approx(100 * least * 2 / 130e-6)
    r.trace = trace.Trace(span_s=1e-3, busy_s=0, records=rec[1:2], idle_gaps=[])
    assert k1_roofline.read(r) is None


def test_step_p95_is_the_tail_of_every_step():
    lat = list(np.linspace(1e-3, 2e-3, 1001))
    r = run.Run(setup_s=0, window=drive.Window(cycles=1001, latencies_s=lat), trace=None,
                untraced=None, k1_launch=None, cycle_work=None)
    assert step_ms_p95.read(r) == pytest.approx(1.95)
    assert step_ms_p95.read(run.Run(0, drive.Window(), None, None, None, None)) is None


def test_idle_gaps_go_to_what_the_host_was_doing():
    spans = [(0.0, 100.0, "bench.solve"), (100.0, 150.0, "bench.plant")]
    ops = [(1.0, 90.0, "aten::copy_"), (10.0, 30.0, "cudaGraphLaunch")]
    ops += [(31.0 + i, 31.5 + i, "aten::view") for i in range(50)]  # many short ones after
    args = (spans, [a for a, _, _ in spans], ops, [a for a, _, _ in ops])
    assert trace.host_activity(*args, 20.0) == "bench.solve/cudaGraphLaunch"
    assert trace.host_activity(*args, 60.8) == "bench.solve/aten::copy_"
    assert trace.host_activity(*args, 120.0) == "bench.plant"
    assert trace.host_activity(*args, 200.0) == "host outside any traced call"


def test_the_exchange_and_the_sharded_combine_read_their_records():
    recs = [("ncclDevKernel_AllReduce_Min_f32_RING_LL", 0.0, 3.0),
            ("ncclKernel_AllReduce_RING_LL_Sum_float", 4.0, 5.0),
            ("softmin_combine_kernel", 10.0, 1.5), ("sharded_scale_kernel", 12.0, 1.0),
            ("sharded_tail_kernel<world::PointMass<3>, true>", 14.0, 2.5),
            ("solve_partials_kernel<Lti<3>, 3, false, true>", 20.0, 100.0),
            ("softmin_min_kernel<false>", 130.0, 1.0)]
    t = trace.Trace(span_s=1e-3, busy_s=1e-4, records=recs, idle_gaps=[])
    r = run.Run(setup_s=1.0, window=drive.Window(cycles=2), trace=t, untraced=None,
                k1_launch=None, cycle_work=None)
    assert nccl_us.read(r) == pytest.approx(4.0)
    assert sharded_combine_us.read(r) == pytest.approx(2.5)
    r.trace = trace.Trace(span_s=1e-3, busy_s=1e-4, records=recs[5:], idle_gaps=[])
    assert nccl_us.read(r) is None and sharded_combine_us.read(r) is None
