"""``correct`` at a size a CPU test holds: a sound run of each cell is
correct; the same run with the timed path broken underneath is not, for
each fault the cells can have; the control (the reference in bfloat16 in
the program's place) reads above every cell's limits. Besides the faults
of the whole timed path, a fault in every other episode and one in a
quarter of a fleet's robots read not correct, since every robot of the
judged episodes is judged. A cell across chips has
an exchange between its ranks to leave out: that fault, and the others in
every rank, are test_bench_port_sharded.py's. Without a GPU, or without the
port beside it, the command prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import control
from bench_port.tests import small

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"pm3d.episode_k1e4": {}, "q3d.episode_r1": {}, "q3d.fleet_r64": dict(robots=8),
         "pm3d.hostloop_k1e5": dict(samples=256, cycles=20)}


def _run(name: str) -> dict:
    return small.execute(small.cell(name, **SIZES[name]), seconds=0.5)


@pytest.mark.parametrize("name", SIZES)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check" and out["attempted"] > 0


def _unchanged_update(monkeypatch):
    """Each update's step returns the sequence unchanged (ΔU dropped)."""
    from mppi_gpu_tpu_torch.ops import solve_tail

    orig = solve_tail.solve_tail_reference
    monkeypatch.setattr(solve_tail, "solve_tail_reference",
                        lambda U, dU, *a, **k: orig(U, torch.zeros_like(dU), *a, **k))


def _unchanged_world(monkeypatch):
    """The world's step returns its state unchanged."""
    from mppi_gpu_tpu_torch.envs import native
    from mppi_gpu_tpu_torch.ops import world_step

    monkeypatch.setattr(world_step, "plain_advance", lambda world, state, u: state)
    monkeypatch.setattr(native.NativePointMassWorld, "simulate", lambda self, u: False)


def _half_batch(monkeypatch):
    """The softmin over the first half of the rollouts, the mean over them."""
    from mppi_gpu_tpu_torch import controller
    from mppi_gpu_tpu_torch.ops.softmin import softmin_weights

    def half(costs, lambda_):
        sm = softmin_weights(costs, lambda_)
        w = sm.weights.clone()
        w[w.shape[0] // 2:] = 0
        return sm._replace(weights=w / w.sum())

    monkeypatch.setattr(controller, "softmin_weights", half)


def _altered_action(monkeypatch):
    """The action altered where the tail produces it."""
    from mppi_gpu_tpu_torch.ops import solve_tail

    orig = solve_tail.solve_tail_reference

    def altered(*a, **k):
        tail = orig(*a, **k)
        return tail if tail.action is None else tail._replace(action=tail.action * 1.05 + 0.05)

    monkeypatch.setattr(solve_tail, "solve_tail_reference", altered)


FAULTS = {"unchanged_update": _unchanged_update, "unchanged_world": _unchanged_world,
          "half_batch": _half_batch, "altered_action": _altered_action}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", SIZES)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(name)
    assert not out["correct"], out["check"]


def _quarter_of_the_fleet(monkeypatch):
    """The last quarter of the fleet's robots draw under wrong seeds."""
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController

    orig = BatchedMPPIController.init_seeds

    def wrong(self):
        seeds = orig(self).clone()
        seeds[3 * self.n_robots // 4:] += 1
        return seeds

    monkeypatch.setattr(BatchedMPPIController, "init_seeds", wrong)


def _every_other_episode(monkeypatch):
    """Every other episode (device or host loop) draws under a wrong seed."""
    from mppi_gpu_tpu_torch import runner
    from mppi_gpu_tpu_torch.controller import MPPIController

    episodes = [0]
    for name in ("run_episode_jit", "run_fleet_episode"):
        def wrapped(ctrl, *a, _orig=getattr(runner, name), **k):
            episodes[0] += 1
            if episodes[0] % 2:
                return _orig(ctrl, *a, **k)
            solve = ctrl.solve_in_place
            ctrl.solve_in_place = lambda x, U, seed, step, adv: solve(x, U, seed + 1, step, adv)
            try:
                return _orig(ctrl, *a, **k)
            finally:
                del ctrl.solve_in_place

        monkeypatch.setattr(runner, name, wrapped)

    def solve_auto(self, x, U, step, *, capture=True):
        episodes[0] += int(step) == 0
        return self.solve(x, U, self.cfg.seed + episodes[0] % 2, step, capture=capture)

    monkeypatch.setattr(MPPIController, "solve_auto", solve_auto)


@pytest.mark.parametrize("name", SIZES)
def test_a_fault_in_every_other_episode_is_not_correct(name, monkeypatch):
    _every_other_episode(monkeypatch)
    out = _run(name)
    assert not out["correct"], out["check"]


def test_a_fault_in_a_quarter_of_the_fleet_is_not_correct(monkeypatch):
    _quarter_of_the_fleet(monkeypatch)
    out = _run("q3d.fleet_r64")
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", SIZES)
def test_the_control_fails(name):
    torch.set_num_threads(1)
    got = control.readings(small.cell(name, **SIZES[name]), 5, torch.device("cpu"))
    limits = small.cell(name).check["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_no_result_without_a_gpu_or_without_the_port(tmp_path):
    cmd = [sys.executable, "-m", "bench_port.run", "--workload", "pm3d.episode_k1e4",
           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
