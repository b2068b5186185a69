"""The benchmark's files: BENCHMARK.json keeps to its contract, every cell,
configuration, traffic and metric it names has its file, and a cell is
added by adding files and entries alone."""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import run, work
from bench_port.reference import models, worlds
from bench_port.tests import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
TWO_KERNEL = "pm3d.sharded1_twokernel"
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and BENCH["paths"] == ["bench_port"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_has_its_reader(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    mod = importlib.import_module(f"bench_port.metrics.{metric['name'].replace('.', '_')}")
    assert callable(mod.read)
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for cell in metric["workloads"]:  # each cell it lists reports what it moves
            assert metric["moves"] in {m["name"] for m in run.load_cell(cell).end_to_end}
    if "_roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_names_known_files(name):
    cell = run.load_cell(name)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.traffic["kind"] in ("episode", "hostloop", "sharded_episode")
    assert set(cell.check["limits"]) <= {"action_gap", "sequence_gap", "world_gap"}
    c = cell.config
    assert models.family(c["family"]).Model and worlds.kind(c["world"]).cycle
    assert importlib.import_module(f"bench_port.work.{c['family']}")
    if cell.traffic["kind"] != "hostloop":  # judged episodes start from distinct states
        assert 0 < cell.check["episodes"] <= cell.traffic["pool"]
        assert 0 < cell.check["quantile"] <= 1 and cell.check["cycles"] > 0
    else:
        assert cell.check["steps"] > 0
    assert len(cell.traffic["start"]) == len(cell.traffic["spread"]) == c["state-dim"]
    assert work.bound(run.counted_work(cell)[1])[0] > 0


SHARDED = [n for n in CELLS if run.load_cell(n).traffic["kind"] == "sharded_episode"]


@pytest.mark.parametrize("name", SHARDED)
def test_a_sharded_cell_has_a_rank_per_chip(name):
    cell = run.load_cell(name)
    t = cell.traffic
    assert t["ranks"] == cell.chips and t["samples"] % t["ranks"] == 0
    assert t.get("robots", 1) == 1 and isinstance(t["onepass"], bool)


@pytest.mark.parametrize("name", CELLS)
def test_counted_work_is_one_chip_s(name):
    """A cell's counted K1 launch is its traffic's rollouts, a sharded cell's
    its rank's share; the cycle's, that times the updates a cycle."""
    cell = run.load_cell(name)
    c, t = cell.config, cell.traffic
    K = t["samples"] // t.get("ranks", 1)
    k1 = work.k1_launch(c["family"], t.get("robots", 1), K, c["horizon"], c["action-dim"],
                        c["state-dim"])
    assert run.counted_work(cell) == (k1, {k: v * c.get("opt-iters", 1) for k, v in k1.items()})


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_yaml_as_run(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    from mppi_gpu_tpu_torch.config import config_from_mapping, load_config

    port = config_from_mapping(cfg)
    yaml = load_config(ROOT / "configs" / f"{cfg['env']}.yaml")
    changed = {f for f in ("samples", "horizon") if getattr(port, f) != getattr(yaml, f)}
    assert changed == set(config["reduced"])
    assert port.replace(samples=yaml.samples, horizon=yaml.horizon) == yaml


def _add_cell(root: Path, bench: dict, name: str, config: str, traffic: dict, like: str):
    """Cell `name` of `config` under `traffic` on one chip, its check as cell
    `like`'s, reported by every metric that `like` reports."""
    bench["workloads"].append({"name": name, "config": config, "traffic": name.replace(".", "_"),
                               "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    here = root / "bench_port"
    (here / "traffic" / f"{name.replace('.', '_')}.json").write_text(json.dumps(traffic))
    (here / "cells" / f"{name}.json").write_text((here / "cells" / f"{like}.json").read_text())


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    here = tmp_path / "bench_port"
    traffic = json.loads((here / "traffic" / "pm3d_episode_k1e4.json").read_text())
    _add_cell(tmp_path, bench, "pm3d.episode_k2e4", "point_mass3d_t200",
              {**traffic, "samples": 20000}, "pm3d.episode_k1e4")
    sharded = json.loads((here / "traffic" / "pm3d_sharded4_k4e5.json").read_text())
    _add_cell(tmp_path, bench, TWO_KERNEL, "point_mass3d_t200",
              {**sharded, "ranks": 1, "onepass": False, "samples": 100000}, "pm3d.sharded4_k4e5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.load_cell("pm3d.episode_k2e4", tmp_path)
    assert cell.traffic["samples"] == 20000
    assert {m["name"] for m in cell.end_to_end} == {"cycle_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"k1_roofline", "k2e_us", "idle_pct", "cycle_mfu"}
    cell = run.load_cell(TWO_KERNEL, tmp_path)
    assert (cell.chips, cell.traffic["ranks"], cell.traffic["onepass"]) == (1, 1, False)
    assert {m["name"] for m in cell.end_to_end} == {"cycle_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"k1_roofline", "idle_pct", "cycle_mfu",
                                                   "nccl_us", "sharded_combine_us"}
    assert run.counted_work(cell)[0] == work.k1_launch("lti", 1, 100000, 200, 3, 6)
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_two_kernel_cell_added_by_files_runs_correct(tmp_path):
    """The sharded kind's two-kernel branch on a world of one rank, a cell
    added as the test above adds it, at a size a CPU test holds."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = tmp_path / "bench_port"
    sharded = json.loads((here / "traffic" / "pm3d_sharded4_k4e5.json").read_text())
    _add_cell(tmp_path, bench, TWO_KERNEL, "point_mass3d_t200",
              {**sharded, "ranks": 1, "onepass": False}, "pm3d.sharded4_k4e5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.load_cell(TWO_KERNEL, tmp_path)
    small_cell = dataclasses.replace(cell, config={**cell.config, "horizon": 12},
                                     traffic={**cell.traffic, "samples": 64, "cycles": 8})
    out = small.execute(small_cell, seconds=0.5)
    assert out["correct"] and out["device"]["count"] == 1, out["check"]


NEW_FAMILY = """
from bench_port.reference.models.lti import Model as Lti


class Model(Lti):
    pass
"""
NEW_WORLD = "from bench_port.reference.worlds.point_mass import cycle, host_cycle  # noqa: F401\n"
NEW_WORK = "from bench_port.work.lti import rollout, step  # noqa: F401\n"
USE_IT = """
import json, torch
from pathlib import Path
from bench_port import run, work
from bench_port.reference import mppi, worlds
cell = run.load_cell("twin.episode", Path.cwd())
cfg = {**cell.config, "samples": 16, "horizon": 4}
solver = mppi.Solver(cfg, torch.tensor([3]), "cpu")
x = torch.zeros(1, 6)
a, U = solver.cycle(x, solver.init_U(), 0)
print(json.dumps({"model": type(solver.model).__module__, "action": list(a.shape),
                  "world": list(worlds.cycle(cfg["world"], x, a).shape),
                  "work": work.bound(run.counted_work(cell)[1])[0] > 0}))
"""


def test_a_configuration_of_a_new_family_is_added_by_files_alone(tmp_path):
    """A configuration whose family and world the reference does not have
    yet comes with the reference's model, its world and its counted work,
    each a file of its own; no file that is there changes."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*") if p.is_file()}
    here = tmp_path / "bench_port"
    (here / "reference" / "models" / "twin_lti.py").write_text(NEW_FAMILY)
    (here / "reference" / "worlds" / "twin_point_mass.py").write_text(NEW_WORLD)
    (here / "work" / "twin_lti.py").write_text(NEW_WORK)
    cfg = json.loads((here / "configs" / "point_mass3d_t200.json").read_text())
    cfg = {**cfg, "family": "twin_lti", "world": {**cfg["world"], "kind": "twin_point_mass"}}
    (here / "configs" / "twin.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "twin", "source": "a test", "file": "bench_port/configs/twin.json",
                             "reduced": [], "why": "a new family"})
    traffic = json.loads((here / "traffic" / "pm3d_episode_k1e4.json").read_text())
    _add_cell(tmp_path, bench, "twin.episode", "twin", traffic, "pm3d.episode_k1e4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", USE_IT], cwd=tmp_path, capture_output=True,
                         text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"model": "bench_port.reference.models.twin_lti", "action": [1, 3],
                   "world": [1, 6], "work": True}
    assert all(p.read_bytes() == b for p, b in before.items())
