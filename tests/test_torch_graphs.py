"""The port's counterparts of the JAX package's ``jax.jit``, on the CPU: the
sharded device episode and the host loop's solve as one graph
(``mppi_gpu_tpu_torch/graphs.py``).

- ``run_episode_jit`` on a ``ShardedMPPIController`` (virtual meshes of 2
  and 4 ranks, both branches; a gloo group of 2 processes) against
  ``run_closed_loop`` driving the same controller, bit for bit, and against
  the solo episode within a stated tolerance; against the JAX package's
  sharded ``run_episode_jit`` on the closed loop's quality;
- K5's plain path with the step as a tensor, bit-equal to the int;
- the solve graph (``graphs.SolveGraph``) with its capture stubbed on the
  CPU (a replay runs the solve again on the graph's buffers): equal to the
  op-by-op solve for one robot, a fleet and a sharded controller; its key,
  which a cost or model reassignment changes and a goal re-aim does not,
  with the re-aimed goal reaching the solve; its results outliving the next
  call; the nesting rule (no replay while the stream captures) with
  ``torch.cuda.is_current_stream_capturing`` stubbed; ``capture`` passed
  through ``run_closed_loop``; ``graphs.capture`` on the controller's
  device and a stream of it, with torch's CUDA calls stubbed;
- the CLI's ``--sharded --jit-episode`` and ``entry``/``dryrun_multichip``.

Sizes are small (K ≤ 256, T ≤ 12, ≤ 12 cycles; the JAX comparison runs the
point_mass3d episode at K=256). Tests marked ``gpu`` hold the replayed
graphs to the op-by-op solve on the card through chip_smoke's checks and
skip without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.parallel import ShardedMPPIController as JaxShardedController  # noqa: E402
from mppi_gpu_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mppi_gpu_tpu.runner import run_episode_jit as jax_run_episode_jit  # noqa: E402
from mppi_gpu_tpu_torch import cli, graphs  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.entry import dryrun_multichip, entry  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import philox  # noqa: E402
from mppi_gpu_tpu_torch.ops.cost import goal_of, with_goal  # noqa: E402
from mppi_gpu_tpu_torch.parallel import ShardedFleetController, ShardedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh  # noqa: E402
from mppi_gpu_tpu_torch.runner import run_closed_loop, run_episode_jit  # noqa: E402

from test_torch_sharded import _spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the sharded episode against the solo one: each cycle's S is the solo S bit
# for bit, but η and ΔU are f32 sums taken over the ranks' partial sums, in
# another order, and the loop feeds that rounding back. Over 12 cycles at
# K=256, T=12 the point mass and the pendulum parted by at most 4.2e-7 in
# their states and 6.5e-6 in their actions (2 and 4 ranks, both branches);
# the bounds allow a few times that
SOLO_TOL = dict(states=2e-6, actions=3e-5)
LTI_QUALITY_THRESHOLD_M = 0.35  # bench.QUALITY_THRESHOLDS["lti"]


def _config(name: str, K: int = 256, T: int = 12):
    return load_config(os.path.join(ROOT, "configs", f"{name}.yaml")).replace(samples=K, horizon=T)


def _leaves(res) -> list:
    return [res.action, res.u_next, *res.info]


def _assert_same(a, b, label: str = "") -> None:
    for name, x, y in zip(("action", "u_next", "costs", "beta", "eta", "weights", "u_seq"),
                          _leaves(a), _leaves(b)):
        assert torch.equal(x, y), f"{label}: {name} differs"


# ---------------------------------------------------------------------------
# the sharded device episode


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "two-kernel"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["point_mass2d", "pendulum"])
def test_sharded_episode_equals_its_host_loop(name, n, onepass):
    """``run_episode_jit`` on a ``ShardedMPPIController`` over n virtual
    ranks (the cycle as a loop on the CPU: the step a 0-dim tensor, the
    world's ``advance``) against ``run_closed_loop`` driving the same
    controller (int steps, the host's ``simulate``) over 12 cycles: states,
    actions and clocks bit for bit (the JAX package holds its two modes to
    1e-5, tests/test_episode_modes.py)."""
    ctrl = ShardedMPPIController(_config(name), mesh=virtual_mesh(n, "cpu"), onepass=onepass)
    ep = run_episode_jit(ctrl, num_steps=12)
    host = run_closed_loop(ctrl, max_steps=12)
    assert ep.xs.shape == (13, ctrl.cfg.state_dim)
    np.testing.assert_array_equal(ep.xs, host.xs)
    np.testing.assert_array_equal(ep.us, host.us)
    np.testing.assert_array_equal(ep.times, host.times)


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "two-kernel"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["point_mass2d", "pendulum"])
def test_sharded_episode_is_the_solo_episode_to_rounding(name, n, onepass):
    """The sharded episode against the solo ``run_episode_jit`` at the same
    seed over 12 cycles, within SOLO_TOL (the ranks draw the solo stream
    between them, so only the order of η's and ΔU's sums differs)."""
    cfg = _config(name)
    solo = run_episode_jit(MPPIController(cfg, device="cpu"), num_steps=12)
    ep = run_episode_jit(ShardedMPPIController(cfg, mesh=virtual_mesh(n, "cpu"), onepass=onepass),
                         num_steps=12)
    np.testing.assert_allclose(ep.xs, solo.xs, rtol=0, atol=SOLO_TOL["states"])
    np.testing.assert_allclose(ep.us, solo.us, rtol=0, atol=SOLO_TOL["actions"])


def test_sharded_episode_over_a_gloo_group(tmp_path):
    """Two gloo processes, each a rank of ``ShardedMPPIController``: in both
    branches each rank's ``run_episode_jit`` equals its ``run_closed_loop``
    and the other rank's bit for bit, and equals the episode on
    ``virtual_mesh(2)`` (a sum or min of two values is the same in either
    order)."""
    cfg = _config("point_mass2d", K=128, T=8)
    ranks = _spawn(str(tmp_path / "episode"), 2, [("episode", dict(cfg=cfg, num_steps=8))])
    for onepass in (True, False):
        virt = run_episode_jit(ShardedMPPIController(cfg, mesh=virtual_mesh(2, "cpu"),
                                                     onepass=onepass), num_steps=8)
        for (got,) in ranks:
            g = got[onepass]
            np.testing.assert_array_equal(g["xs"], g["host_xs"])
            np.testing.assert_array_equal(g["us"], g["host_us"])
            np.testing.assert_array_equal(g["xs"], virt.xs)
            np.testing.assert_array_equal(g["us"], virt.us)
            np.testing.assert_array_equal(g["times"], virt.times)


def test_chip_smoke_group_episode_runs_on_gloo():
    """chip_smoke's two-rank episode (``group_run(episode=True)``, run on
    the card where it has two GPUs) over two spawned gloo ranks: on each
    rank, both branches, the episode equals its ``capture=False`` run, and
    the ranks agree."""
    import chip_smoke

    cfg = _config("point_mass2d", K=128, T=8)
    ranks = chip_smoke.group_run(cfg, 2, backend="gloo", device="cpu", episode=True)
    for onepass in (True, False):
        for r in ranks:
            xs, us, exs, eus = r[onepass]
            np.testing.assert_array_equal(xs, exs)
            np.testing.assert_array_equal(us, eus)
            np.testing.assert_array_equal(xs, ranks[0][onepass][0])


@pytest.fixture(scope="module")
def jax_pm3d_steady():
    """The JAX package's sharded whole-episode jit at point_mass3d, K=256,
    over a 2-device mesh: its steady-state goal distance (the mean over the
    episode's last quarter, bench.quality_row's metric)."""
    cfg = load_jax_config(os.path.join(ROOT, "configs", "point_mass3d.yaml")).replace(samples=256)
    ep = jax_run_episode_jit(JaxShardedController(cfg, mesh=jax_make_mesh(2)))
    return _steady(np.asarray(ep.xs), cfg.goal)


def _steady(xs: np.ndarray, goal) -> float:
    d = np.linalg.norm(np.asarray(xs, np.float64)[:, :3] - np.asarray(goal[:3]), axis=1)
    return float(d[-max(len(d) // 4, 1):].mean())


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "two-kernel"])
def test_sharded_episode_quality_against_the_jax_package(jax_pm3d_steady, onepass):
    """The port's sharded episode and the JAX package's, point_mass3d at
    K=256 over 2 ranks, the whole 500-cycle episode: both end under the
    0.35 m tripwire (bench.QUALITY_THRESHOLDS["lti"]). Their noise streams
    differ by design (the port draws counter-based Philox, ROADMAP
    "Replay"), so the loops are held on quality; the per-cycle math is held
    on injected noise by test_torch_sharded's
    test_sharded_matches_the_jax_sharded_solve."""
    cfg = _config("point_mass3d", K=256, T=50)
    ep = run_episode_jit(ShardedMPPIController(cfg, mesh=virtual_mesh(2, "cpu"), onepass=onepass))
    assert len(ep.us) == 500
    assert jax_pm3d_steady < LTI_QUALITY_THRESHOLD_M
    assert _steady(ep.xs, cfg.goal) < LTI_QUALITY_THRESHOLD_M


def test_sharded_fleet_episode_on_a_virtual_mesh():
    """``run_fleet_episode`` on a ``ShardedFleetController`` over 2 virtual
    ranks equals the unsharded fleet's bit for bit (robots are whole on a
    rank: nothing is summed across ranks)."""
    from mppi_gpu_tpu_torch.runner import run_fleet_episode

    cfg = _config("point_mass2d", K=64, T=8)
    got = run_fleet_episode(ShardedFleetController(cfg, 4, mesh=virtual_mesh(2, "cpu")),
                            num_steps=6)
    want = run_fleet_episode(BatchedMPPIController(cfg, 4, device="cpu"), num_steps=6)
    for k in ("xs", "us", "times"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("diffs,want", [
    ([0.0] * 32, (0, 0, 1.0)),                    # bit-equal episodes: no evidence
    ([0.1] * 24 + [-0.1] * 8, (24, 32, 0.003500)),  # worse at 24 of 32: refused at 1 %
    ([0.1] * 23 + [-0.1] * 9, (23, 32, 0.010031)),  # worse at 23 of 32: passes at 1 %
    ([0.0] * 4 + [-0.2] * 28, (0, 28, 1.0)),
], ids=["equal", "24of32", "23of32", "better"])
def test_chip_smoke_sign_test_pairs_the_seeds(diffs, want):
    """chip_smoke's quality gate of the sharded episode on the card: a
    one-sided sign test over the per-seed differences from the solo episode,
    seeds whose episodes end equally far dropped (exact binomial tail)."""
    import chip_smoke

    k, n, p = chip_smoke.sign_test_worse(diffs)
    assert (k, n) == want[:2] and p == pytest.approx(want[2], abs=1e-6)


# ---------------------------------------------------------------------------
# K5 with the step by address


@pytest.mark.parametrize("anti,ou", [(False, 0.0), (True, 0.0), (False, 0.5)],
                         ids=["iid", "antithetic", "ou0.5"])
def test_weighted_update_takes_a_step_tensor(anti, ou):
    """``weighted_update`` on CPU tensors with the step a 0-dim int64 tensor
    equals the int step's bit for bit, in every noise mode (on the card K5
    reads the tensor's address, chip_smoke phase 26)."""
    sigma, K, T = torch.tensor([0.3, 0.5, 0.2]), 256, 10
    w = torch.softmax(torch.linspace(-2.0, 1.0, K), 0)
    by_int = fs.weighted_update(sigma, w, T, K, 7, 2**32 + 5, 1, anti, ou, k0=64)
    by_tensor = fs.weighted_update(sigma, w, T, K, 7, torch.tensor(2**32 + 5), 1, anti, ou, k0=64)
    assert torch.equal(by_int, by_tensor)
    with pytest.raises(TypeError, match="0-dim int64"):
        fs.weighted_update(sigma, w, T, K, 7, torch.tensor([5]), 1, anti, ou)


# ---------------------------------------------------------------------------
# the solve graph on the CPU, its capture stubbed


class _ReplayStub:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured
    function again and writes its output into the captured output, as a
    replay rewrites the graph's memory from the buffers it reads."""

    def __init__(self, fn, out) -> None:
        self.fn, self.out = fn, out

    def replay(self) -> None:
        self.out.copy_(self.fn())


@pytest.fixture
def stub_graphs(monkeypatch):
    """``graphs.capture`` without CUDA (the warm-up, then one more call as
    the captured output, replayed by :class:`_ReplayStub`) and
    ``graphs.replays`` true wherever a graph is asked for, so that ``solve``
    on the CPU goes through ``graphs.SolveGraph``: its key, its buffers and
    its copies out."""
    def capture(fn, device):
        warm = fn()
        out = fn()
        return _ReplayStub(fn, out), warm, out

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "replays", lambda device, capture: capture)


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", ["point_mass2d", "pendulum", "quadrotor3d"])
def test_graphed_solve_path_equals_the_op_by_op_solve(name, backend, stub_graphs):
    """The solve graph (the inputs copied into its buffers, the step a
    tensor, the cost aimed at the goal buffer, the outputs copied out)
    against ``solve(capture=False)``, three steps fed forward, every leaf
    bit for bit (chip_smoke.check_graphed_solve)."""
    import chip_smoke

    cfg = _config(name, K=128, T=8).replace(opt_iters=2)
    ctrl = MPPIController(cfg, device="cpu")
    ctrl.rollout_backend = backend
    x = torch.full((cfg.state_dim,), 0.05)
    if name == "quadrotor3d":
        x[3:7] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    assert chip_smoke.check_graphed_solve(name, ctrl, x, ctrl.init_action_seq(), cfg.seed) == 1


def test_graphed_fleet_and_sharded_solves(stub_graphs):
    """The same for an R=3 fleet (its seeds and goals are buffers of the
    graph) and for a sharded controller in both branches on 2 virtual
    ranks: one graph each, every leaf bit for bit."""
    import chip_smoke

    cfg = _config("point_mass2d", K=128, T=8)
    fleet = BatchedMPPIController(cfg, 3, device="cpu")
    xs = torch.tensor([[0.1, 0.0, 0.0, 0.0], [0.0, 0.2, 0.0, 0.0], [-0.1, 0.1, 0.0, 0.0]])
    assert chip_smoke.check_graphed_solve("fleet", fleet, xs, fleet.init_action_seqs(),
                                          fleet.init_seeds()) == 1
    for onepass in (True, False):
        ctrl = ShardedMPPIController(cfg, mesh=virtual_mesh(2, "cpu"), onepass=onepass)
        assert chip_smoke.check_graphed_solve(f"sharded {onepass=}", ctrl, xs[0],
                                              ctrl.init_action_seq(), cfg.seed) == 1


def test_solve_key_follows_the_cost_and_model_not_the_goal(stub_graphs):
    """The solve graph's key: a goal re-aim (``with_goal``) keeps it and the
    cached graph, and the re-aimed goal reaches the solve (equal to a fresh
    controller's with that cost); re-tuning the cost's weights, reassigning
    the model, another shape or another solo seed change it, and the next
    call builds a new graph."""
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = MPPIController(cfg, device="cpu")
    x, U = torch.tensor([0.1, 0.0, 0.0, 0.2]), ctrl.init_action_seq()
    key = graphs.solve_key(ctrl, x, U, cfg.seed)
    graphs.graphed_solve(ctrl, x, U, cfg.seed, 0)
    built = ctrl._solve_graphs["solve"][1]
    goal = goal_of(ctrl.cost).clone()
    goal[:2] = torch.tensor([0.5, -0.4])
    ctrl.cost = with_goal(ctrl.cost, goal)
    assert graphs.solve_key(ctrl, x, U, cfg.seed) == key
    got = graphs.graphed_solve(ctrl, x, U, cfg.seed, 1)
    assert ctrl._solve_graphs["solve"][1] is built
    fresh = MPPIController(cfg, device="cpu", cost=ctrl.cost)
    _assert_same(got, fresh.solve(x, U, cfg.seed, 1), "re-aimed")
    assert not torch.equal(got.action, MPPIController(cfg, device="cpu").solve(x, U, cfg.seed, 1).action)
    import dataclasses

    ctrl.cost = dataclasses.replace(ctrl.cost, w=ctrl.cost.w * 2.0)
    assert graphs.solve_key(ctrl, x, U, cfg.seed) != key
    graphs.graphed_solve(ctrl, x, U, cfg.seed, 1)
    assert ctrl._solve_graphs["solve"][1] is not built
    key = graphs.solve_key(ctrl, x, U, cfg.seed)
    ctrl.dynamics = dataclasses.replace(ctrl.dynamics)
    assert graphs.solve_key(ctrl, x, U, cfg.seed) != key
    key = graphs.solve_key(ctrl, x, U, cfg.seed)
    assert graphs.solve_key(ctrl, x, U, cfg.seed + 1) != key
    assert graphs.solve_key(ctrl, x, U[:4], cfg.seed) != key


def test_fleet_goal_re_aim_reaches_the_graphed_solve(stub_graphs):
    """A fleet re-aimed at new per-robot goals every call keeps one graph,
    whose goal buffer takes the new goals (as the fleet example re-aims)."""
    cfg = _config("point_mass2d", K=64, T=8)
    fleet = BatchedMPPIController(cfg, 2, device="cpu")
    xs, Us, seeds = torch.zeros(2, 4), fleet.init_action_seqs(), fleet.init_seeds()
    for step in range(3):
        goals = torch.tensor([[0.5, 0.1 * step, 0.0, 0.0], [-0.3, 0.2, 0.0, 0.0]])
        fleet.cost = with_goal(fleet.cost, goals)
        got = graphs.graphed_solve(fleet, xs, Us, seeds, step)
        want = fleet.solve(xs, Us, seeds, step, capture=False)
        _assert_same(got, want, f"step {step}")
    assert len(fleet._solve_graphs) == 1


def test_a_graphed_result_outlives_the_next_call(stub_graphs):
    """A result is copied out of the graph's outputs: the next call (another
    start, the same graph) leaves it as it was."""
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = MPPIController(cfg, device="cpu")
    U = ctrl.init_action_seq()
    first = graphs.graphed_solve(ctrl, torch.zeros(4), U, cfg.seed, 0)
    kept = copy.deepcopy(first)
    graphs.graphed_solve(ctrl, torch.full((4,), 0.3), U, cfg.seed, 0)
    _assert_same(first, kept)


@pytest.mark.parametrize("capturing", [False, True])
def test_no_replay_while_the_stream_captures(monkeypatch, capturing):
    """The nesting rule: ``solve`` replays its graph on a CUDA device unless
    asked not to or while the stream is capturing another graph (a device
    episode's cycle), where it launches its ops for that capture to record;
    never on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.replays(cuda, True) is (not capturing)
    assert not graphs.replays(cuda, False) and not graphs.replays(cpu, True)


def test_capture_goes_through_the_loops(monkeypatch):
    """``run_closed_loop(capture=...)`` hands its keyword to every timed
    solve, and a device episode's cycle asks for none (its own capture
    records the solve): with every solve that asks for a graph refused, the
    episode and the loop with ``capture=False`` run and the loop with
    ``capture=True`` reaches the refusal."""
    monkeypatch.setattr(graphs, "replays", lambda device, capture: capture)

    def refuse(*a, **k):
        raise RuntimeError("a graph was asked for")

    monkeypatch.setattr(graphs, "graphed_solve", refuse)
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = MPPIController(cfg, device="cpu")
    run_episode_jit(ctrl, num_steps=2)
    run_closed_loop(ctrl, max_steps=2, capture=False)
    with pytest.raises(RuntimeError, match="a graph was asked for"):
        run_closed_loop(ctrl, max_steps=2)


def test_capture_runs_on_a_stream_of_the_given_device(monkeypatch):
    """``graphs.capture(fn, cuda:1)`` while cuda:0 is current: the warm-up
    and the captured call run with cuda:1 current, and the graph captures
    on the side stream made on cuda:1 (not torch's default capture stream,
    which is made on whichever device was current at the first capture),
    leaving other threads' CUDA calls alone; it returns the warm-up's output
    and the captured call's, and the garbage collector is on again after.
    torch's CUDA calls are stubbed."""
    current, captures = ["cuda:0"], []

    class Stream:
        def __init__(self, device=None) -> None:
            self.device = str(device)

        def wait_stream(self, other) -> None:
            pass

    @contextlib.contextmanager
    def device(d):
        old, current[0] = current[0], str(d)
        try:
            yield
        finally:
            current[0] = old

    @contextlib.contextmanager
    def on_stream(s):
        yield

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global"):
        captures.append((stream.device, current[0], capture_error_mode, gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream(d))
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    calls = []

    def fn():
        calls.append(current[0])
        return len(calls)

    _, warm, static = graphs.capture(fn, torch.device("cuda", 1))
    assert (warm, static) == (1, 2) and calls == ["cuda:1", "cuda:1"]
    assert captures == [("cuda:1", "cuda:1", "thread_local", False)]
    assert current[0] == "cuda:0" and gc.isenabled()


# ---------------------------------------------------------------------------
# the CLI and the harness entry points


def test_cli_sharded_jit_episode_on_the_cpu(capsys, tmp_path, monkeypatch):
    """``--sharded --jit-episode --device cpu``: the sharded device episode
    on a world of one, exit 0, its trajectory the same episode's."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg_path = tmp_path / "pm2.yaml"
    text = open(os.path.join(ROOT, "configs", "point_mass2d.yaml")).read()
    cfg_path.write_text(text.replace("samples: 3000", "samples: 128").replace("horizon: 50",
                                                                             "horizon: 8"))
    traj = tmp_path / "traj.csv"
    rc = cli.main(["-c", str(cfg_path), "--device", "cpu", "--sharded", "--jit-episode",
                   "--max-steps", "6", "-t", str(traj)])
    out = capsys.readouterr().out
    assert rc == 0 and "episode finished: 6 control steps" in out
    want = run_episode_jit(ShardedMPPIController(load_config(str(cfg_path)),
                                                 mesh=virtual_mesh(1, "cpu")), num_steps=6)
    rows = np.loadtxt(traj, delimiter=",", skiprows=1)
    np.testing.assert_allclose(rows[:, 1:5], want.xs[1:], rtol=1e-6, atol=1e-7)


def test_entry_and_dryrun_multichip_on_the_cpu(capsys):
    """``entry(device="cpu")`` gives (fn, args) whose fn is the flagship's
    solve at a tiny K (the solo controller's action and u_next);
    ``dryrun_multichip(4)`` runs both branches over four virtual ranks."""
    fn, args = entry(device="cpu", K=128, T=8)
    action, u_next = fn(*args)
    assert action.shape == (3,) and u_next.shape == (8, 3)
    from mppi_gpu_tpu_torch.entry import flagship_config

    want = MPPIController(flagship_config(128, 8), device="cpu").solve_auto(*args)
    assert torch.equal(action, want.action) and torch.equal(u_next, want.u_next)
    dryrun_multichip(4, device="cpu", K=256)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK [one-pass]: 4 ranks (virtual)" in out
    assert "dryrun_multichip OK [two-kernel]" in out


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
def test_graphed_solve_equals_op_by_op_on_the_card(cuda):
    """On the card ``solve`` replays a captured graph: every leaf bit-equal
    to the op-by-op solve, one capture, for a solo robot, a fleet and the
    sharded controller in both branches on 2 virtual ranks."""
    import chip_smoke

    cfg = _config("point_mass2d", K=1024, T=20)
    ctrl = MPPIController(cfg, device=cuda)
    x = torch.full((4,), 0.05, device=cuda)
    assert chip_smoke.check_graphed_solve("solo", ctrl, x, ctrl.init_action_seq(), cfg.seed) == 1
    fleet = BatchedMPPIController(cfg, 4, device=cuda)
    xs = x.expand(4, -1).contiguous()
    assert chip_smoke.check_graphed_solve("fleet", fleet, xs, fleet.init_action_seqs(),
                                          fleet.init_seeds()) == 1
    for onepass in (True, False):
        sh = ShardedMPPIController(cfg, mesh=virtual_mesh(2, cuda), onepass=onepass)
        assert chip_smoke.check_graphed_solve("sharded", sh, x, sh.init_action_seq(), cfg.seed) == 1


@pytest.mark.gpu
def test_weighted_update_step_pointer_on_the_card(cuda):
    """K5 by pointer and by value: S, ΔU and K5's partials bit-equal in
    every noise mode (chip_smoke.check_weighted_update_step_pointer)."""
    import chip_smoke

    chip_smoke.check_weighted_update_step_pointer(3, 2048, 20)


@pytest.mark.gpu
def test_sharded_episode_graph_on_the_card(cuda):
    """The sharded graph episode on 2 virtual ranks, both branches, bit-equal
    to its eager cycle on the card."""
    cfg = _config("point_mass2d", K=1024, T=20)
    for onepass in (True, False):
        ctrl = ShardedMPPIController(cfg, mesh=virtual_mesh(2, cuda), onepass=onepass)
        graph = run_episode_jit(ctrl, num_steps=20)
        eager = run_episode_jit(ctrl, num_steps=20, capture=False)
        np.testing.assert_array_equal(graph.xs, eager.xs)
        np.testing.assert_array_equal(graph.us, eager.us)


def test_fleet_seed_tensor_is_an_input_not_a_key(stub_graphs):
    """A fleet's (R,) seeds are copied into the graph's buffer: other seeds
    of the same shape keep the key, and reach the solve."""
    cfg = _config("point_mass2d", K=64, T=8)
    fleet = BatchedMPPIController(cfg, 2, device="cpu")
    xs, Us = torch.zeros(2, 4), fleet.init_action_seqs()
    a, b = fleet.init_seeds(), philox.fleet_seeds(cfg.seed + 1, 2)
    assert graphs.solve_key(fleet, xs, Us, a) == graphs.solve_key(fleet, xs, Us, b)
    graphs.graphed_solve(fleet, xs, Us, a, 0)
    got = graphs.graphed_solve(fleet, xs, Us, b, 0)
    _assert_same(got, fleet.solve(xs, Us, b, 0, capture=False))
    assert len(fleet._solve_graphs) == 1
