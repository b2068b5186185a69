"""The ``sharded_episode`` kind at a size a CPU test holds, its ranks gloo
processes on the CPU (``bench_port.ranks``): its episodes are the solo
controller's at the same K to the order of the sums; a sound run reads
correct; the same run with the timed path broken in every rank reads not
correct, for each fault the cell can have, the exchange between the ranks
left out among them; the control fails; a rank that raises or is killed
ends the run non-zero within the ranks' join timeout, with no result, and
leaves no process behind."""

from __future__ import annotations

import dataclasses
import functools
import os
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import control, drive, ranks
from bench_port.tests import small
from bench_port.tests import test_bench_port_correct as correct

ROOT = Path(__file__).resolve().parents[2]
NAME = "pm3d.sharded4_k4e5"
CPU = torch.device("cpu")
# tests/test_torch_graphs.py's bounds of the sharded episode against the solo
# one: each cycle's S is the solo S bit for bit, but η and ΔU are f32 sums
# over the ranks' partial sums, in another order, which the loop feeds back
SOLO_TOL = dict(states=2e-6, actions=3e-5)


def _exchange_left_out(monkeypatch):
    """Every collective returns the rank's own entry: each rank's softmin
    and update over its own rollouts alone."""
    from mppi_gpu_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(Mesh, "all_reduce", lambda self, t, op, keep=False: t[0])


def _half_batch(monkeypatch):
    """Each rank's softmin and update over the first half of its rollouts."""
    from mppi_gpu_tpu_torch.parallel import sharded

    orig = sharded._eager_core
    monkeypatch.setattr(sharded, "_eager_core", lambda dyn, cost, x0, U, eps, lam: orig(
        dyn, cost, x0, U, eps[:, :eps.shape[1] // 2], lam))


FAULTS = {"exchange_left_out": _exchange_left_out, "half_batch": _half_batch,
          "unchanged_update": correct._unchanged_update,
          "unchanged_world": correct._unchanged_world,
          "altered_action": correct._altered_action}


class _Patch:
    """monkeypatch's setattr in a rank, a process that ends with the run."""

    setattr = staticmethod(setattr)


def _faulty_rank(fault: str, *args) -> None:
    FAULTS[fault](_Patch)
    ranks.rank_main(*args)


def _failing_rank(at: int, how: str, rank: int, *args) -> None:
    """Rank 2 raises, or is killed, at its `at`-th episode."""
    from mppi_gpu_tpu_torch import runner

    orig, calls = runner.run_episode_jit, [0]

    def episode(*a, **k):
        calls[0] += 1
        if rank == 2 and calls[0] == at:
            if how == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise RuntimeError(f"rank {rank} fails at its episode {at}")
        return orig(*a, **k)

    runner.run_episode_jit = episode
    ranks.rank_main(rank, *args)


def _cell(**traffic):
    c = small.cell(NAME)
    return dataclasses.replace(c, traffic={**c.traffic, **traffic})


@pytest.mark.parametrize("n", [2, 4])
def test_the_ranks_run_the_solo_episodes(n):
    torch.set_num_threads(1)
    c = _cell(ranks=n)
    sharded = drive.ShardedEpisodes(c.config, c.traffic, 11, CPU)
    try:
        sharded.warm()
        got = [sharded.window(0.0, lambda: None, False) for _ in range(2)]
        sharded.close()
    except BaseException:
        sharded.abort()
        raise
    solo = drive.Episodes(c.config, {**c.traffic, "kind": "episode"}, 11, CPU)
    want = [solo.window(0.0, lambda: None, False) for _ in range(2)]
    assert [r["rank"] for r in sharded.reports] == list(range(1, n))
    for g, w in zip(got, want):
        (xs, us, ts), (xs_w, us_w, ts_w) = g.episodes[0], w.episodes[0]
        np.testing.assert_allclose(xs, xs_w, rtol=0, atol=SOLO_TOL["states"])
        np.testing.assert_allclose(us, us_w, rtol=0, atol=SOLO_TOL["actions"])
        np.testing.assert_array_equal(ts, ts_w)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_a_sound_sharded_run_is_correct(traced):
    out = small.execute(small.cell(NAME), seconds=0.5, traced=traced)
    assert out["correct"], out["check"]
    assert out["device"]["count"] == 4 and out["attempted"] > 0 and list(out)[-1] == "check"


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_every_rank_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    monkeypatch.setattr(drive.ShardedEpisodes, "entry",
                        staticmethod(functools.partial(_faulty_rank, fault)))
    out = small.execute(small.cell(NAME), seconds=0.5)
    assert not out["correct"], out["check"]


def test_the_control_fails_the_sharded_cell():
    torch.set_num_threads(1)
    got = control.readings(small.cell(NAME), 5, CPU)
    limits = small.cell(NAME).check["limits"]
    assert any(got[k] > limits[k] for k in limits), got


FAIL_A_RANK = """
import functools, json, sys
from bench_port import drive
from bench_port.tests import small, test_bench_port_sharded as t
drive.ShardedEpisodes.entry = staticmethod(functools.partial(t._failing_rank, int(sys.argv[1]),
                                                             sys.argv[2]))
print(json.dumps(small.execute(small.cell(t.NAME), seconds=1.0)))
"""


def _marked(mark: str) -> list[int]:
    """The processes whose environment holds `mark`."""
    found = []
    for p in Path("/proc").iterdir():
        try:
            if p.name.isdigit() and mark.encode() in (p / "environ").read_bytes():
                found.append(int(p.name))
        except OSError:
            pass
    return found


@pytest.mark.parametrize("at,how", [(1, "raise"), (3, "raise"), (3, "kill")],
                         ids=["raises_in_set_up", "raises_in_the_window", "killed_in_the_window"])
def test_a_failing_rank_ends_the_run_without_a_result(at, how):
    mark = f"BENCH_PORT_TEST_MARK={uuid.uuid4().hex}"
    env = {**os.environ, mark.split("=")[0]: mark.split("=")[1],
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", FAIL_A_RANK, str(at), how], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=ranks.JOIN_S + 60)
    assert out.returncode != 0 and not out.stdout.strip(), out.stdout
    assert f"fails at its episode {at}" in out.stderr or how == "kill", out.stderr[-2000:]
    assert time.monotonic() - t0 < ranks.JOIN_S
    deadline = time.monotonic() + 10
    while _marked(mark) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not _marked(mark)
