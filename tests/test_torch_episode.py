"""The on-device episode and the rest of the closed loop on the CPU: the
noise stream and the solves with the control step (and the fleet's seeds)
as device tensors, bit-equal to the int forms; ``run_episode_jit`` against
the host loop and ``run_fleet_episode`` robot by robot against solo
episodes, for every family; the episode cycle's cache and what re-captures
it; K1's launcher passing the step by address; checkpoint/resume against the
uninterrupted run and the JAX package's config; ``profiler_trace``; and the
CLI's ``--jit-episode``, ``--checkpoint``/``--resume`` and ``--profile``.

Sizes are small (K ≤ 256, T ≤ 20, ≤ 12 cycles, R ≤ 4). On the CPU the
episode's cycle runs as a loop of the same torch ops as the host loop's, so
every comparison here is exact (torch.equal / assert_array_equal); the
card's graph is held to the same cycle run eagerly there, and to the host
loop within a tolerance, by chip_smoke.py.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world  # noqa: E402
from mppi_gpu_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, philox  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import world_step as ws  # noqa: E402
from mppi_gpu_tpu_torch.ops.cost import goal_of, with_goal  # noqa: E402
from mppi_gpu_tpu_torch.runner import (  # noqa: E402
    cycle_key,
    run_closed_loop,
    run_episode_jit,
    run_fleet_episode,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "mppi-config-test.yaml")
# a config of every family: the point mass with the quadratic and with the
# obstacle cost (examples/obstacle_nav.py's), and the six others
FAMILY_CONFIGS = ("point_mass2d", "obstacle2d", "pendulum", "cartpole", "unicycle", "quadrotor",
                  "arm", "quadrotor3d")


def _config(name: str, K: int = 64, T: int = 8):
    if name == "obstacle2d":
        from mppi_gpu_tpu_torch.examples.obstacle_nav import OBSTACLES

        cfg = load_config(os.path.join(ROOT, "configs", "point_mass2d.yaml")).replace(
            cost_type="obstacle", obstacles=OBSTACLES, obstacle_w=800.0, noise_beta=0.5)
    else:
        cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    return cfg.replace(samples=K, horizon=T)


def _ctrl(cfg, backend: str, cls=MPPIController, *args, **kw):
    """A CPU controller on `backend`: ``fused`` on CPU tensors runs the
    kernels' plain versions."""
    ctrl = cls(cfg, *args, device="cpu", **kw)
    ctrl.rollout_backend = backend
    return ctrl


# ---------------------------------------------------------------------------
# the step (and the seed) as a device tensor


@pytest.mark.parametrize("seed,step", [(7, 0), (-5, 3), (2**63 - 3, 2**32 + 5), (12345, 10**12)])
def test_tensor_step_and_seed_draw_the_int_stream(seed, step):
    """``philox_words`` and ``sample_eps`` with the step and the seed as 0-dim
    int64 tensors give the int forms' words and ε bit for bit (iid,
    antithetic and OU)."""
    sigma = torch.tensor([0.3, 0.2, 0.1])
    s_t, k_t = torch.tensor(seed), torch.tensor(step)
    assert torch.equal(philox.philox_words(seed, step, 2, 5, 9, "cpu"),
                       philox.philox_words(s_t, k_t, 2, 5, 9, "cpu"))
    for anti, ou in ((False, 0.0), (True, 0.0), (False, 0.6)):
        want = philox.sample_eps(seed, step, 1, 6, 40, sigma, antithetic=anti, ou_beta=ou)
        assert torch.equal(philox.sample_eps(seed, k_t, 1, 6, 40, sigma, antithetic=anti,
                                             ou_beta=ou), want)
        assert torch.equal(philox.sample_eps(s_t, k_t, 1, 6, 40, sigma, antithetic=anti,
                                             ou_beta=ou), want)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_solves_take_the_step_as_a_tensor(backend):
    """A solo solve (two opt iterations) and a fleet solve with the step as a
    0-dim int64 tensor equal the int step's, bit for bit, on both backends."""
    cfg = _config("pendulum", K=96, T=10)
    ctrl = _ctrl(cfg, backend)
    x, U = torch.tensor([2.5, 0.3]), ctrl.init_action_seq()
    a, b = ctrl.solve(x, U, 11, 4), ctrl.solve(x, U, 11, torch.tensor(4))
    assert torch.equal(a.action, b.action) and torch.equal(a.info.costs, b.info.costs)
    fleet = _ctrl(cfg, backend, BatchedMPPIController, 3)
    xs = torch.tensor([[2.5, 0.3], [3.0, -0.2], [1.0, 0.0]])
    Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
    a, b = fleet.solve_batch(xs, Us, seeds, 4), fleet.solve_batch(xs, Us, seeds, torch.tensor(4))
    assert torch.equal(a.action, b.action) and torch.equal(a.info.costs, b.info.costs)


def _stub_k1(monkeypatch):
    """CPU tensors taken for CUDA ones and K1's and K2's C entries recorded;
    the stubbed launches count in copies of the launch counts."""
    monkeypatch.setattr(fs, "_LAUNCHES", dict(fs._LAUNCHES))
    monkeypatch.setattr(fs, "_FAMILY_LAUNCHES", {k: dict(v) for k, v in fs._FAMILY_LAUNCHES.items()})
    monkeypatch.setattr(fs, "_WIDTH_LAUNCHES", {k: dict(v) for k, v in fs._WIDTH_LAUNCHES.items()})
    calls = {"solve_partials": [], "softmin_combine": []}
    lib = types.SimpleNamespace(mppi_solve_residency=lambda *a: 0, **{
        f"mppi_{k}": (lambda k: lambda *a: calls[k].append(a) or 0)(k) for k in calls})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


def test_k1_launcher_passes_a_tensor_step_by_address(monkeypatch):
    """Device-free: K1's entry gets ``step_ptr`` = the step tensor's address
    and 0 for the by-value step word when the step is a tensor, and a null
    ``step_ptr`` with the step's low word by value when it is an int; for
    the solo solve, the fleet's (with its seeds by address too) and K4; a
    step tensor of another dtype or shape raises."""
    calls = _stub_k1(monkeypatch)
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = MPPIController(cfg, device="cpu")
    fam, goal = ctrl._family, goal_of(ctrl.cost)
    x, U = torch.zeros(4), ctrl.init_action_seq()
    step = torch.tensor(9)
    # the entry's arguments: keys [5], step_ptr [6], the by-value step word [19]
    fs.family_solve_partials(fam, x, U, goal, 1.0, 64, 7, step, 0, False, 0.0)
    fs.family_solve_partials(fam, x, U, goal, 1.0, 64, 7, 2**32 + 9, 0, False, 0.0)
    (by_ptr, by_value) = calls["solve_partials"]
    assert by_ptr[5] is None and by_ptr[6] == step.data_ptr() and by_ptr[19] == 0
    assert by_value[6] is None and by_value[19] == 9
    seeds = philox.fleet_seeds(7, 3)
    xs, Us, goals = torch.zeros(3, 4), U.expand(3, -1, -1).contiguous(), goal.expand(3, -1).contiguous()
    fs.fleet_family_solve_partials(fam, xs, Us, goals, 1.0, 64, seeds, step, 1, False, 0.0)
    fs.fleet_rollout_costs(fam, xs, Us, goals, 64, seeds, step, 1, False, 0.0)
    for args in calls["solve_partials"][2:]:
        assert args[5] == seeds.data_ptr() and args[6] == step.data_ptr() and args[19] == 0
    assert calls["solve_partials"][3][9] is None  # K4: no partials
    for bad in (torch.tensor(9, dtype=torch.int32), torch.tensor([9])):
        with pytest.raises(TypeError, match="0-dim int64"):
            fs.family_solve_partials(fam, x, U, goal, 1.0, 64, 7, bad, 0, False, 0.0)
    assert len(calls["solve_partials"]) == 4


@pytest.mark.parametrize("capturing", [False, True])
def test_only_a_launch_that_runs_is_counted(monkeypatch, capturing):
    """Device-free: a wrapper counts its launch (by kernel, family and
    width) when the kernel runs; while the stream captures a CUDA graph the
    C entry is still called (the graph records the launch) but nothing is
    counted, since the capture runs nothing and its replays are not the
    wrapper's launches."""
    calls = _stub_k1(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    cfg = _config("pendulum", K=64, T=8)
    fam = MPPIController(cfg, device="cpu")._family
    x, U = torch.tensor([3.0, 0.0]), torch.zeros(8, 1)
    before = (fs.launch_counts(), fs.family_launch_counts(), fs.width_launch_counts())
    _, partials = fs.family_solve_partials(fam, x, U, None, 1.0, 64, 7, torch.tensor(0), 0, False,
                                           0.0)
    fs.softmin_combine(partials, 1.0, 8, 1)
    assert len(calls["solve_partials"]) == 1 and len(calls["softmin_combine"]) == 1
    added = 0 if capturing else 1
    counts = fs.launch_counts()
    assert counts["solve_partials"] == before[0]["solve_partials"] + added
    assert counts["softmin_combine"] == before[0]["softmin_combine"] + added
    assert fs.family_launch_counts()["pendulum"] == before[1]["pendulum"] + added
    assert sum(fs.width_launch_counts().values()) == sum(before[2].values()) + added


# ---------------------------------------------------------------------------
# run_episode_jit and run_fleet_episode


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", ["mppi-config-test", "quadrotor3d"])
def test_episode_jit_equals_the_host_loop(name, backend):
    """``run_episode_jit`` on the CPU (the cycle as a loop: the step a 0-dim
    tensor, the world's ``advance``) against ``run_closed_loop`` (int steps,
    the host's ``simulate``) over 12 cycles: states, actions and clocks
    bit for bit (tests/test_episode_modes.py holds the JAX package's two
    modes to the same, within its recompilation tolerance)."""
    cfg = load_config(CFG) if name == "mppi-config-test" else _config(name, K=128, T=12)
    host = run_closed_loop(_ctrl(cfg, backend), max_steps=12)
    dev = run_episode_jit(_ctrl(cfg, backend), num_steps=12)
    assert dev.xs.shape == (13, cfg.state_dim) and dev.us.shape == (12, cfg.action_dim)
    np.testing.assert_array_equal(dev.us, host.us)
    np.testing.assert_array_equal(dev.xs, host.xs)
    np.testing.assert_array_equal(dev.times, host.times)


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", FAMILY_CONFIGS)
def test_fleet_robot_is_its_solo_episode(name, backend):
    """Robot r of ``run_fleet_episode`` (R = 3, per-robot starts and, for a
    cost with a goal, goals) equals ``run_episode_jit`` of one robot with
    its seed, start and goal, bit for bit, for every family."""
    cfg = _config(name)
    rng = np.random.default_rng(5)
    xs0 = rng.uniform(-0.3, 0.3, (3, cfg.state_dim)).astype(np.float32)
    if name == "quadrotor3d":
        xs0[:, 3:7] = [1.0, 0.0, 0.0, 0.0]
    goal = goal_of(MPPIController(cfg, device="cpu").cost)
    goals = None
    if goal is not None:
        goals = goal.expand(3, -1).clone()
        goals[:, :2] += torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32))
    fleet = _ctrl(cfg, backend, BatchedMPPIController, 3, goals=goals)
    ep = run_fleet_episode(fleet, num_steps=5, xs0=xs0)
    assert ep.xs.shape == (6, 3, cfg.state_dim) and ep.us.shape == (5, 3, cfg.action_dim)
    for r, seed in enumerate(fleet.init_seeds().tolist()):
        solo = _ctrl(cfg, backend, cost=fleet._robot_cost(r))
        one = run_episode_jit(solo, num_steps=5, seed=seed, x0=xs0[r])
        np.testing.assert_array_equal(ep.xs[:, r], one.xs)
        np.testing.assert_array_equal(ep.us[:, r], one.us)
        np.testing.assert_array_equal(ep.times, one.times)


def test_episode_cycle_is_cached_and_reassignment_recaptures():
    """The cycle is cached per controller: a second episode reuses it (a new
    start does not re-build it). Reassigning ``ctrl.cost`` (here re-aimed
    with ``with_goal``, which keeps the pack) or ``ctrl.dynamics`` changes
    the cache key, and the next episode is built anew: it equals a fresh
    controller's with that cost, and differs from the old goal's."""
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = MPPIController(cfg, device="cpu")
    first = run_episode_jit(ctrl, num_steps=4)
    cyc = ctrl._episode_cycles["single"][1]
    run_episode_jit(ctrl, num_steps=4, x0=torch.full((4,), 0.1))
    assert ctrl._episode_cycles["single"][1] is cyc
    key = lambda: cycle_key(ctrl, "single", None, None, (4,), 4, cfg.seed)  # noqa: E731
    before = key()
    goal = goal_of(ctrl.cost).clone()
    goal[:2] = torch.tensor([0.5, -0.4])
    ctrl.cost = with_goal(ctrl.cost, goal)
    assert key() != before
    moved = run_episode_jit(ctrl, num_steps=4)
    assert ctrl._episode_cycles["single"][1] is not cyc
    want = run_episode_jit(MPPIController(cfg, device="cpu", cost=ctrl.cost), num_steps=4)
    np.testing.assert_array_equal(moved.xs, want.xs)
    assert not np.array_equal(moved.us, first.us)
    after_cost = key()
    ctrl.dynamics = dataclasses.replace(ctrl.dynamics)
    assert key() != after_cost


def test_an_episode_result_outlives_the_next_episode():
    """An episode's arrays are its own: a second episode on the same
    controller (a cache hit, from another start) leaves the first result as
    it was, for one robot and for a fleet."""
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = MPPIController(cfg, device="cpu")
    first = run_episode_jit(ctrl, num_steps=4)
    kept = copy.deepcopy(first)
    second = run_episode_jit(ctrl, num_steps=4, x0=torch.full((4,), 0.1))
    assert not np.array_equal(second.xs, kept.xs)
    for f in ("xs", "us", "times"):
        np.testing.assert_array_equal(getattr(first, f), getattr(kept, f))
    fleet = BatchedMPPIController(cfg, 2, device="cpu")
    first = run_fleet_episode(fleet, num_steps=4)
    kept = copy.deepcopy(first)
    run_fleet_episode(fleet, num_steps=4, xs0=np.full((2, 4), 0.1, np.float32))
    for f in ("xs", "us", "times"):
        np.testing.assert_array_equal(getattr(first, f), getattr(kept, f))


# ---------------------------------------------------------------------------
# the cycle's world step inside the solve (K2's epilogue on the card)


def _advance(world, state, U, n: int):
    """Fresh copies of an episode's buffers for `state` and U: the state,
    U, the histories of n rows, the x buffer, the counter at row 1."""
    state = type(state)(*(leaf.clone() for leaf in state))
    lead, f32 = tuple(U.shape[:-2]), dict(dtype=torch.float32)
    adv = ws.Advance(world, state, torch.zeros(n + 1, *lead, state.x.shape[-1], **f32),
                     torch.zeros(n, *lead, U.shape[-1], **f32),
                     torch.zeros(n, *state.time.shape, **f32), state.x.clone())
    return adv, U.clone(), torch.tensor(1)


@pytest.mark.parametrize("opt_iters", [1, 2])
@pytest.mark.parametrize("fleet", [False, True], ids=["solo", "fleet"])
@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", ["cartpole", "quadrotor3d"])
def test_solve_in_place_with_advance_is_solve_then_advance_into(name, backend, fleet, opt_iters):
    """On the CPU, ``solve_in_place(..., advance)`` over three cycles equals
    the parent's cycle, ``solve_in_place`` and then ``advance_into`` under
    its action, bit for bit: the actions, U shifted in place, the world's
    state, the histories, the x buffer and the counter."""
    cfg = _config(name).replace(opt_iters=opt_iters)
    world = make_world(cfg)
    ctrl = (_ctrl(cfg, backend, BatchedMPPIController, 3) if fleet else _ctrl(cfg, backend))
    seed = ctrl.init_seeds() if fleet else 7
    U0 = ctrl.init_action_seqs() if fleet else ctrl.init_action_seq()
    state0 = world.reset(3 if fleet else None)
    new, U_new, step_new = _advance(world, state0, U0, 4)
    old, U_old, step_old = _advance(world, state0, U0, 4)
    for _ in range(3):
        a = ctrl.solve_in_place(new.x, U_new, seed, step_new, new)
        b = ctrl.solve_in_place(old.x, U_old, seed, step_old)
        ws.advance_into(world, old.state, b, old.xs, old.us, old.ts, step_old, old.x)
        assert torch.equal(a, b)
    for x, y in zip((*new.state, new.xs, new.us, new.ts, new.x, U_new, step_new),
                    (*old.state, old.xs, old.us, old.ts, old.x, U_old, step_old)):
        assert torch.equal(x, y)
    assert int(step_new) == 4 and new.xs[2:].any()


# one ε for every cycle and update of both packages' episodes; the states
# and actions of the two part by the two libraries' roundings (exp, sums
# over K, the worlds' sin/cos) and the loop feeds them back over 6 cycles:
# at most 1.5e-5 (the pendulum's action at two opt iterations, λ = 0.2)
JAX_EPISODE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("opt_iters", [1, 2])
@pytest.mark.parametrize("name", ["point_mass2d", "pendulum"])
def test_device_episode_matches_the_jax_jitted_episode(monkeypatch, name, opt_iters):
    """The port's ``run_episode_jit`` on the CPU (the eager backend, the
    cycle's world step through ``solve_in_place``'s ``Advance``) against the
    JAX package's jitted ``run_episode_jit`` (its scan backend, flat layout)
    over 6 cycles at K = 64, T = 8, both drawing the same ε (numpy seed) in
    every update in place of their noise streams: states, actions and
    clocks within JAX_EPISODE_TOL."""
    import jax.numpy as jnp

    import mppi_gpu_tpu.controller as jax_controller
    from mppi_gpu_tpu.config import load_config as load_jax_config
    from mppi_gpu_tpu.runner import run_episode_jit as jax_run_episode_jit

    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    cfg = load_config(path).replace(samples=64, horizon=8, opt_iters=opt_iters)
    jcfg = dataclasses.replace(load_jax_config(path), samples=64, horizon=8, opt_iters=opt_iters)
    eps = (np.random.default_rng(3).normal(size=(8, 64, cfg.action_dim))
           * np.asarray(cfg.noise)).astype(np.float32)
    monkeypatch.setenv("MPPI_SCAN_LAYOUT", "flat")
    monkeypatch.setattr(jax_controller, "sample_noise", lambda *a, **k: jnp.asarray(eps))
    monkeypatch.setattr(MPPIController, "_eps", lambda self, seed, step, it: torch.from_numpy(eps))
    got = run_episode_jit(_ctrl(cfg, "eager"), num_steps=6)
    want = jax_run_episode_jit(jax_controller.MPPIController(jcfg, rollout_backend="scan"),
                               num_steps=6)
    np.testing.assert_allclose(got.us, np.asarray(want.us), **JAX_EPISODE_TOL)
    np.testing.assert_allclose(got.xs, np.asarray(want.xs), **JAX_EPISODE_TOL)
    np.testing.assert_allclose(got.times, np.asarray(want.times), **JAX_EPISODE_TOL)


# ---------------------------------------------------------------------------
# checkpoint / resume


def test_checkpoint_roundtrip(tmp_path):
    cfg = load_config(CFG)
    path = tmp_path / "ck.npz"
    U = np.arange(cfg.horizon * cfg.action_dim, dtype=np.float32).reshape(
        cfg.horizon, cfg.action_dim)
    save_checkpoint(path, step=7, U=U, seed=-123, x=np.ones(cfg.state_dim), time=1.25, cfg=cfg)
    ck = load_checkpoint(path)
    assert ck.step == 7 and ck.time == 1.25 and ck.seed == -123
    np.testing.assert_array_equal(ck.U, U)
    assert ck.cfg == cfg
    assert not os.path.exists(f"{path}.tmp.npz")


def test_checkpoint_nested_config_stays_hashable_and_loads_into_jax(tmp_path):
    """Obstacle configs carry nested tuples; the json round trip restores
    them as tuples all the way down (MPPIConfig promises hashability), and
    the port's cfg_json loads into the JAX package's MPPIConfig field for
    field."""
    import json

    from mppi_gpu_tpu.config import MPPIConfig as JaxConfig

    cfg = load_config(CFG).replace(
        cost_type="obstacle", obstacles=((0.1, 0.2, 0.05), (0.3, 0.4, 0.1)))
    path = tmp_path / "ck.npz"
    save_checkpoint(path, step=1, U=np.zeros((cfg.horizon, cfg.action_dim)), seed=0,
                    x=np.zeros(cfg.state_dim), time=0.1, cfg=cfg)
    ck = load_checkpoint(path)
    assert ck.cfg == cfg
    hash(ck.cfg)  # must not raise
    with np.load(path) as z:
        raw = json.loads(bytes(z["cfg_json"]).decode())
    jcfg = JaxConfig(**{k: tuple(map(lambda v: tuple(v) if isinstance(v, list) else v, v))
                        if isinstance(v, list) else v for k, v in raw.items()})
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", ["mppi-config-test", "quadrotor3d"])
def test_resume_matches_uninterrupted_run(tmp_path, name, backend):
    """A run that writes a checkpoint every 6 steps, resumed from it (step 6)
    with a fresh controller: the resumed steps equal the uninterrupted
    run's bit for bit. A checkpoint of another seed raises."""
    cfg = load_config(CFG) if name == "mppi-config-test" else _config(name, K=128, T=12)
    ck = tmp_path / "ck.npz"
    full = run_closed_loop(_ctrl(cfg, backend), max_steps=10, checkpoint_path=ck,
                           checkpoint_every=6)
    assert load_checkpoint(ck).step == 6
    resumed = run_closed_loop(_ctrl(cfg, backend), max_steps=10, resume_from=ck)
    assert len(resumed.us) == 4
    np.testing.assert_array_equal(resumed.us, full.us[6:])
    np.testing.assert_array_equal(resumed.xs, full.xs[6:])
    np.testing.assert_array_equal(resumed.times, full.times[6:])
    with pytest.raises(ValueError, match="seed"):
        run_closed_loop(_ctrl(cfg.replace(seed=cfg.seed + 1), backend), max_steps=10,
                        resume_from=ck)


# ---------------------------------------------------------------------------
# profiler and CLI


def test_profiler_trace_writes_files(tmp_path):
    from mppi_gpu_tpu_torch.utils.timing import profiler_trace

    logdir = str(tmp_path / "trace")
    with profiler_trace(logdir):
        run_closed_loop(MPPIController(load_config(CFG), device="cpu"), max_steps=2)
    found = [os.path.join(r, f) for r, _, fs_ in os.walk(logdir) for f in fs_]
    assert found and all(os.path.getsize(f) > 0 for f in found)
    with profiler_trace(None):
        pass


def test_cli_jit_episode_checkpoint_resume_and_profile(tmp_path, capsys):
    """The CLI on the CPU: ``--jit-episode`` writes the episode's trajectory,
    equal to the host loop's; ``--checkpoint``/``--checkpoint-every`` then
    ``--resume`` continue the host loop's run bit for bit; ``--profile``
    writes a trace; host-loop options with ``--jit-episode`` are refused."""
    from mppi_gpu_tpu_torch import cli
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns

    base = ["-c", CFG, "--device", "cpu", "--max-steps", "9"]
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("jit", "host", "resumed")}
    ck = str(tmp_path / "ck.npz")
    assert cli.main([*base, "--jit-episode", "-t", paths["jit"]]) == 0
    assert "device episode on cpu" in capsys.readouterr().out
    assert cli.main([*base, "-t", paths["host"], "--checkpoint", ck, "--checkpoint-every", "4",
                     "--profile", str(tmp_path / "prof")]) == 0
    assert "profiler trace written" in capsys.readouterr().out
    assert os.listdir(tmp_path / "prof")
    assert cli.main([*base, "-t", paths["resumed"], "--resume", ck]) == 0
    assert "episode finished: 1 control steps" in capsys.readouterr().out
    jit, host, resumed = (read_csv_columns(paths[k]) for k in ("jit", "host", "resumed"))
    for col in host:
        np.testing.assert_array_equal(jit[col], host[col])
        np.testing.assert_array_equal(resumed[col], host[col][-1:])
    assert cli.main([*base, "--jit-episode", "--resume", ck]) == 2
    assert "--jit-episode" in capsys.readouterr().err
