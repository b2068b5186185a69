"""Run one cell of ``BENCHMARK.json`` once on the GPU:

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names its configuration
(``bench_port/configs/<config>.json``), its traffic
(``bench_port/traffic/<traffic>.json``) and has its own file
(``bench_port/cells/<cell>.json``: what the check samples and each number's
limit); each metric has its reader (``bench_port/metrics/<name>.py``, a dot
in the name an underscore). So a cell or a metric is added by adding files
and entries.

A run draws its inputs from the seed, builds the cell's controller, warms
it up (set-up, ``setup_s``), drives the port for ``--seconds`` (with
``--trace 1`` under torch.profiler, for at most ``TRACE_SECONDS``), reads
the device's peak memory, frees the port's state, has the reference judge
what the window produced (``bench_port.check``), and prints one JSON line
last on stdout; each number compared, beside its limit, goes last on stderr
and last in the line. A cell across chips (traffic ``sharded_episode``)
runs its ranks as processes of their own, one GPU each
(``bench_port.ranks``): this process is rank 0 on ``cuda:0``, which times
the window, has its trace read and keeps what the check judges; the peak
memory is the fullest chip's, and the device's busy and traced seconds are
averaged over the chips, each rank tracing the same window. Without CUDA,
or with fewer GPUs than the cell asks for, or where the port is not this
checkout's, it exits non-zero and prints no result; so it does if ``jax``,
``jaxlib``, ``flax`` or the JAX package was loaded, in any rank.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
import traceback
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mppi_gpu_tpu")
TRACE_SECONDS = 3.0


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock of it)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: every cell it lists, or every
    cell where it lists none (``setup_s``; a per-layer metric lists its)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """Cell `name` of the benchmark at `root`, its files and its metrics."""
    bench = _json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = root / "bench_port"
    return Cell(name=name, chips=int(w["chips"]), config=_json(root / cfg["file"]),
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                check=_json(here / "cells" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def require_chips(n: int):
    """The first GPU, or exit 2 without a result when fewer than `n`."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: the cell needs {n} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def require_port(root: Path = ROOT) -> None:
    """The port must be this checkout's, not one installed elsewhere."""
    try:
        import mppi_gpu_tpu_torch
    except ImportError as e:
        print(f"bench_port: the port is not in this checkout ({e})", file=sys.stderr)
        raise SystemExit(2) from e
    if Path(mppi_gpu_tpu_torch.__file__).resolve().parents[1] != root:
        print(f"bench_port: the port at {mppi_gpu_tpu_torch.__file__} is not this checkout's",
              file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window: object
    trace: object
    untraced: object    # with a trace, the same work's window untraced just before
    k1_launch: object   # counted work of one K1 launch
    cycle_work: object  # counted work of one control cycle


def counted_work(cell: Cell):
    """(one K1 launch, one control cycle) of counted work on one chip: a
    sharded cell's rank rolls out ``samples`` / ``ranks``."""
    from bench_port import work

    c, t = cell.config, cell.traffic
    R, K = int(t.get("robots", 1)), int(t["samples"]) // int(t.get("ranks", 1))
    T, A, s = int(c["horizon"]), int(c["action-dim"]), int(c["state-dim"])
    k1 = work.k1_launch(c["family"], R, K, T, A, s)
    return k1, Counter({k: v * int(c.get("opt-iters", 1)) for k, v in k1.items()})


def distinct_episodes(rng, n: int, pool: int, want: int) -> list[int]:
    """Up to `want` of a window's `n` episodes, drawn by `rng`, no two from
    the same start state: episode i starts from the pool's entry at i mod
    `pool` under the same noise seed, so two that share it are the same
    episode (``bench_port.drive.draw``)."""
    pick: dict[int, int] = {}
    for i in rng.permutation(n):
        pick.setdefault(int(i) % pool, int(i))
        if len(pick) == want:
            break
    return sorted(pick.values())


def judge(cell: Cell, driver, window, seed: int, device) -> dict[str, float]:
    """The gaps of a sample, drawn from the seed, of what the window
    produced: host-loop steps, or every robot of sampled episodes, each
    from a start state of its own."""
    import numpy as np

    from bench_port import check

    rng = np.random.default_rng([seed, 1])
    cfg = {**cell.config, "samples": int(cell.traffic["samples"])}
    if cell.traffic["kind"] == "hostloop":
        recs = window.records
        pick = sorted(rng.choice(len(recs), size=min(len(recs), cell.check["steps"]), replace=False))
        return check.hostloop_gaps(cfg, driver.noise_seed, [recs[i] for i in pick], device)
    R = int(cell.traffic.get("robots", 1))
    pick = distinct_episodes(rng, len(window.episodes), int(cell.traffic["pool"]),
                             int(cell.check["episodes"]))
    xs, us, clocks = [], [], []
    for i in pick:
        x, u, ts = window.episodes[i]
        xs.append(x.reshape(x.shape[0], R, -1))
        us.append(u.reshape(u.shape[0], R, -1))
        c = np.concatenate([[driver.t0], ts.reshape(ts.shape[0], -1)[:-1, 0]])
        clocks.append(np.repeat(c[:, None].astype(np.float32), R, axis=1))
    seeds = check.robot_seeds(driver.noise_seed, R).repeat(len(pick))
    gaps, world = check.episode_gaps(cfg, seeds, np.concatenate(xs, 1), np.concatenate(us, 1),
                                     np.concatenate(clocks, 1), int(cell.check["cycles"]), device)
    return check.episode_reading(cell.check, gaps, world)


def read_metrics(metrics: list, run: Run) -> dict:
    out = {}
    for m in metrics:
        module = m["name"].replace(".", "_")
        v = importlib.import_module(f"bench_port.metrics.{module}").read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device, started: float) -> dict:
    """One run of `cell` on `device`; `started` is the process's start on the
    clock of ``time.perf_counter``. Returns the result's fields."""
    import torch

    from bench_port import drive, trace, work

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = drive.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, device)
    try:
        driver.warm()
        sync()
        setup_s = time.perf_counter() - started
        tr, prof, plain = None, None, None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            plain = driver.window(min(seconds, TRACE_SECONDS), lambda: None, False)
            mark = (lambda: torch.cuda._sleep(1000)) if cuda else (lambda: None)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                    driver.traced():
                driver.warm()
                sync()
                window = driver.window(min(seconds, TRACE_SECONDS), mark, True)
                driver.warm()
                sync()
        else:
            window = driver.window(seconds, lambda: None, False)
        sync()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if prof is not None and cuda:
            tr = trace.read(prof)
        del prof
        driver.close()
    except BaseException:
        driver.abort()
        raise
    # the fullest chip's peak; the device's busy and traced seconds averaged over the chips
    peak = max([peak] + [r["peak"] for r in driver.reports])
    spans = [] if tr is None else [(tr.busy_s, tr.span_s)]
    spans += [s for r in driver.reports for s in r["traces"]]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = judge(cell, driver, window, seed, device)
    k1, cycle = counted_work(cell)
    run = Run(setup_s=setup_s, window=window, trace=tr, untraced=plain, k1_launch=k1,
              cycle_work=cycle)
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end, run)
    limits = cell.check["limits"]
    checked = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = window.failed == 0 and all(v["value"] <= v["limit"] for v in checked.values())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": window.cycles, "failed": window.failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = sum(b for b, _ in spans) / len(spans)
        dev["window_s"] = sum(w for _, w in spans) / len(spans)
        out["breakdown"] = {"device_ops": [list(x) for x in trace.device_ops(tr)],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
        least, cls = work.bound(k1)
        out["bound_by"] = {"k1_roofline": cls, "k1_least_us": least * 1e6}
    out["check"] = checked
    return out


def main(argv=None) -> int:
    started = time.perf_counter() - process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    require_port()
    device = require_chips(cell.chips)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device, started)
    leaked = forbidden_modules()
    if leaked:
        print(f"bench_port: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as e:
        if e.code is not None and not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException:
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # no teardown: a cell's NCCL group is left to the process's end (bench_port.ranks)
    os._exit(rc)
