"""The port's fleet (``batched.BatchedMPPIController``, the fleet kernels'
plain versions, ``runner.run_fleet_episode``, the fleet example) against the
JAX package's fleet kernels, run as tests/test_batched.py runs them
(``pallas-interpret``, testmode pseudo-noise): the row-packed one-pass
kernel, the two-pass kernel and the planar kernel, each robot's ε taken from
the kernels' host twin of that noise under the robot's key. Also: a fleet
robot is bit-equal to the single-robot solve with its seed and goal, the
batched tail and world leave single-robot results unchanged, and a short
fleet episode is R single-robot closed loops. Tests marked `gpu` run the
fleet kernels themselves through chip_smoke's checks and skip without a
CUDA device.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.batched import BatchedMPPIController as JaxBatched  # noqa: E402
from mppi_gpu_tpu.config import MPPIConfig as JaxConfig  # noqa: E402
from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import MPPIConfig, load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController, _finish, _finish_fused  # noqa: E402
from mppi_gpu_tpu_torch.convert import from_numpy_params  # noqa: E402
from mppi_gpu_tpu_torch.envs import PointMassWorld, WorldParams  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import philox  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG2 = os.path.join(ROOT, "configs", "point_mass2d.yaml")
# tests/test_batched.py's tolerance for the fleet kernels against their reference
TOL = dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# against the JAX fleet kernels (interpret mode, testmode noise)


def _planar_cfg(cls, R, K, T, A):
    """tests/test_batched.py::test_fleet_pallas_planar_matches_oracle's config."""
    return cls(
        env="t", samples=K, state_dim=2 * A, action_dim=A, horizon=T, dt=0.1,
        lambda_=1.0, noise=(0.25,) * A, init_act=(0.0,) * A, max_a=(1.0,) * A,
        goal=(1.0,) * A + (0.0,) * A, cost_type="quadratic",
        cost_w=(1.0,) * A + (0.5,) * A,
    )


def _against_jax_fleet(jcfg, tcfg, R, *, onepass, planar):
    """One fleet solve of the JAX fleet kernel (pallas-interpret, testmode)
    and of the port on the same per-robot ε, goals, states and sequences."""
    A, K = jcfg.action_dim, jcfg.samples
    rng = np.random.default_rng(R)
    goals = np.concatenate(
        [rng.uniform(-1.0, 1.0, (R, A)), np.zeros((R, A))], 1
    ).astype(np.float32)
    xs = (0.2 * rng.standard_normal((R, 2 * A))).astype(np.float32)
    ctrl_b = JaxBatched(
        jcfg, R, goals=jnp.asarray(goals), rollout_backend="pallas-interpret", testmode=True
    )
    Us, keys = ctrl_b.init_action_seqs(), ctrl_b.init_keys()
    res_j = ctrl_b.solve_batch(jnp.asarray(xs), Us, keys)
    fam = pr.family_for(ctrl_b.dynamics, ctrl_b.cost)
    plan = pr.make_plan(
        K, jcfg.horizon, A, jcfg.antithetic, jcfg.noise_beta, testmode=True, family=fam,
        extra=pr._plan_extra(pr.FAMILIES[fam], ctrl_b.cost),
    )
    assert (plan.onepass, plan.planar) == (onepass, planar)
    twin = pr.planar_fake_noise_tensor if planar else pr.fake_noise_tensor
    eps = np.stack([
        np.asarray(twin(plan, ctrl_b.sigma, ou_beta=jcfg.noise_beta, key=keys[r]))[:, :K]
        for r in range(R)
    ])
    c = ctrl_b.cost
    dyn, cost = from_numpy_params(
        dict(dt=np.float32(jcfg.dt), action_dim=A),
        {k: np.asarray(getattr(c, k)) for k in ("w", "goal", "lambda_", "inv_s")},
        "cpu", goals=np.asarray(c.goal),
    )
    for backend in ("eager", "fused"):
        fleet = BatchedMPPIController(tcfg, R, device="cpu", dynamics=dyn, cost=cost)
        # `fused` needs a CUDA device; on CPU tensors its wrappers run the
        # plain fleet versions, so the backend is switched by hand
        fleet.rollout_backend = backend
        res_t = fleet.solve_batch_with_eps(
            torch.as_tensor(xs), torch.as_tensor(np.array(Us)), torch.as_tensor(eps)
        )
        for name, got, want in (("u_next", res_t.u_next, res_j.u_next),
                                ("action", res_t.action, res_j.action),
                                ("costs", res_t.info.costs, res_j.info.costs)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{backend} {name}")
    assert fs.launch_counts() == {"solve_partials": 0, "softmin_combine": 0, "noise_dump": 0}


def test_fleet_onepass_kernel_per_robot_goals():
    """TPU kernel #9, `_fleet_onepass_solve_kernel` (A=2, row-packed)."""
    kw = dict(samples=300, horizon=15, opt_iters=1)
    _against_jax_fleet(load_jax_config(CFG2).replace(**kw), load_config(CFG2).replace(**kw), 2,
                       onepass=True, planar=False)


def test_fleet_two_pass_kernel(monkeypatch):
    """TPU kernel #10, `_fleet_fused_solve_kernel`: the plan's one-pass
    switch (pallas_rollout.make_plan reads MPPI_PALLAS_ONEPASS) turned off."""
    monkeypatch.setenv("MPPI_PALLAS_ONEPASS", "0")
    kw = dict(samples=300, horizon=15, opt_iters=1)
    _against_jax_fleet(load_jax_config(CFG2).replace(**kw), load_config(CFG2).replace(**kw), 2,
                       onepass=False, planar=False)


def test_fleet_planar_kernel():
    """TPU kernel #11, `_planar_fleet_onepass_kernel` (A=3, planar), at
    tests/test_batched.py's shape."""
    R, K, T, A = 3, 260, 9, 3
    _against_jax_fleet(_planar_cfg(JaxConfig, R, K, T, A), _planar_cfg(MPPIConfig, R, K, T, A), R,
                       onepass=True, planar=True)


# ---------------------------------------------------------------------------
# decomposability: a fleet robot is its single-robot solve


def _goals(R, s, seed=0):
    rng = np.random.default_rng(seed)
    g = np.zeros((R, s), np.float32)
    g[:, : s // 2] = rng.uniform(-1.0, 1.0, (R, s // 2))
    return torch.from_numpy(g)


def _solo(cfg, goal, seed=None):
    ctrl = MPPIController(cfg if seed is None else cfg.replace(seed=seed), device="cpu")
    ctrl.cost = dataclasses.replace(ctrl.cost, goal=goal)
    return ctrl


@pytest.mark.parametrize("opt_iters,antithetic,ou", [(1, False, 0.0), (2, True, 0.4)])
def test_eager_fleet_robot_equals_single_robot_solve(opt_iters, antithetic, ou):
    cfg = load_config(CFG2).replace(samples=256, horizon=12, opt_iters=opt_iters,
                                    antithetic=antithetic, noise_beta=ou)
    R = 3
    goals = _goals(R, 4)
    fleet = BatchedMPPIController(cfg, R, goals=goals, device="cpu")
    assert fleet.rollout_backend == "eager"
    xs = 0.1 * torch.randn(R, 4, generator=torch.Generator().manual_seed(0))
    Us = fleet.init_action_seqs() + 0.05
    seeds = fleet.init_seeds()
    res = fleet.solve_batch(xs, Us, seeds, 5)
    assert res.action.shape == (R, 2) and res.u_next.shape == (R, 12, 2)
    assert res.info.costs.shape == res.info.weights.shape == (R, 256)
    assert res.info.beta.shape == res.info.eta.shape == (R,)
    for r, seed in enumerate(seeds.tolist()):
        solo = _solo(cfg, goals[r]).solve(xs[r], Us[r], seed, 5)
        assert torch.equal(res.action[r], solo.action)
        assert torch.equal(res.u_next[r], solo.u_next)
        for a, b in zip(res.info, solo.info):
            assert torch.equal(a[r], b)


def test_fleet_wrappers_are_robot_by_robot_single_solves():
    """Philox mode, per-robot seeds: the fleet wrappers' plain versions give
    each robot the single-robot wrappers' results, bit for bit."""
    A, R, K, T = 3, 3, 200, 7
    rng = np.random.default_rng(2)
    f = lambda *shape: torch.as_tensor(rng.uniform(-0.5, 0.5, shape).astype(np.float32))  # noqa: E731
    xs, Us, goals = f(R, 2 * A), f(R, T, A), f(R, 2 * A)
    sigma, inv_s, w = torch.full((A,), 0.25), torch.ones(A), torch.arange(1.0, 2 * A + 1)
    seeds = philox.fleet_seeds(9, R)
    fleet = fs.fleet_fused_solve(xs, Us, sigma, inv_s, w, goals, 1.0, 0.9, 0.1, K, seeds, 2, 1,
                                 True, 0.3)
    for r, seed in enumerate(seeds.tolist()):
        solo = fs.fused_solve(xs[r], Us[r], sigma, inv_s, w, goals[r], 1.0, 0.9, 0.1, K, seed,
                              2, 1, True, 0.3)
        for a, b in zip(fleet, solo):
            assert torch.equal(a[r], b)
    # one int seed is every robot's seed
    shared = fs.fleet_fused_solve(xs, Us, sigma, inv_s, w, goals, 1.0, 0.9, 0.1, K, 5, 2, 1,
                                  False, 0.0)
    solo = fs.fused_solve(xs[1], Us[1], sigma, inv_s, w, goals[1], 1.0, 0.9, 0.1, K, 5, 2, 1,
                          False, 0.0)
    assert torch.equal(shared[0][1], solo[0]) and torch.equal(shared[3][1], solo[3])


def test_fleet_seeds():
    seeds = philox.fleet_seeds(42, 6)
    assert seeds.dtype == torch.int64 and seeds.shape == (6,)
    assert len(set(seeds.tolist()) | {42}) == 7
    assert torch.equal(philox.fleet_seeds(42, 3), seeds[:3])  # robot r's seed ignores R
    assert not torch.equal(philox.fleet_seeds(43, 6), seeds)
    w = philox.philox4x32(tuple(torch.tensor([v]) for v in (4, 2**32 - 1, 0, 0)), (42, 0))
    assert int(seeds[4]) & (2**64 - 1) == int(w[1]) << 32 | int(w[0])
    # robot r draws the single-robot stream of its seed
    sigma = torch.tensor([0.3, 0.2])
    eps = fs.noise_dump(sigma, 4, 10, int(seeds[2]), 1, 0, False, 0.0)
    assert torch.equal(eps, philox.sample_eps(int(seeds[2]), 1, 0, 4, 10, sigma))
    with pytest.raises(ValueError):
        philox.fleet_seeds(0, 0)


def test_per_robot_goals_steer_apart():
    """tests/test_batched.py::test_per_robot_goals_steer_apart on the port."""
    cfg = load_config(os.path.join(ROOT, "configs", "point_mass1d.yaml")).replace(samples=256, horizon=20)
    fleet = BatchedMPPIController(cfg, 2, goals=torch.tensor([[1.0, 0.0], [-1.0, 0.0]]), device="cpu")
    res = fleet.solve_batch(torch.zeros(2, 2), fleet.init_action_seqs(), fleet.init_seeds())
    assert float(res.action[0, 0]) > 0.05
    assert float(res.action[1, 0]) < -0.05


def test_goals_and_backend_are_checked():
    from mppi_gpu_tpu_torch.ops.cost import batch_goals

    cfg = load_config(CFG2).replace(samples=64, horizon=5)
    for bad in (torch.zeros(3, 4), torch.zeros(2, 3), torch.zeros(4)):
        with pytest.raises(ValueError, match="goals must be"):
            BatchedMPPIController(cfg, 2, goals=bad, device="cpu")

    @dataclasses.dataclass(frozen=True)
    class TargetBuiltIn:  # a cost whose target is part of its formula
        w: torch.Tensor

    with pytest.raises(TypeError, match="goal"):
        batch_goals(TargetBuiltIn(torch.ones(4)), torch.zeros(2, 4), 2)
    with pytest.raises(ValueError, match="CUDA device"):
        BatchedMPPIController(cfg, 2, device="cpu", rollout_backend="fused")
    with pytest.raises(ValueError, match="n_robots"):
        BatchedMPPIController(cfg, 0, device="cpu")
    fleet = BatchedMPPIController(cfg, 2, device="cpu")
    assert torch.equal(fleet.cost.goal, torch.tensor([[1.0, 0, 0, 0]] * 2))
    with pytest.raises(ValueError, match="per-robot seeds"):
        fleet.solve_auto(torch.zeros(2, 4), fleet.init_action_seqs(), 0)


def test_fleet_wrappers_reject_bad_inputs():
    A, R, K, T = 2, 2, 50, 4
    args = [torch.zeros(R, 2 * A), torch.zeros(R, T, A), torch.ones(A), torch.ones(A),
            torch.ones(2 * A), torch.zeros(R, 2 * A), 1.0, 1.0, 0.1, K,
            torch.zeros(R, dtype=torch.int64), 0, 0, False, 0.0]
    fs.fleet_fused_solve(*args)
    for i, bad, err in ((0, torch.zeros(R + 1, 2 * A), ValueError),
                        (5, torch.zeros(2 * A), ValueError),
                        (10, torch.zeros(R, dtype=torch.int32), TypeError),
                        (10, torch.zeros(R + 1, dtype=torch.int64), ValueError),
                        (1, torch.zeros(T, A), ValueError)):
        with pytest.raises(err):
            fs.fleet_fused_solve(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="R <= 65535"):
        fs.fleet_solve_partials(*args[:1], torch.zeros(fs.MAX_ROBOTS + 1, 1, 1), *args[2:])
    with pytest.raises(ValueError, match="eps"):
        fs.fleet_fused_solve(*args, eps=torch.zeros(T, K, A))
    with pytest.raises(ValueError, match=r"\(R, nb"):
        fs.fleet_softmin_combine(torch.zeros(3, 2 + T * A), 1.0, T, A)


def test_quadratic_cost_broadcasts_per_robot_goals():
    from mppi_gpu_tpu_torch.ops.cost import QuadraticCost

    R, K, s = 3, 5, 4
    g = torch.Generator().manual_seed(1)
    goals, x = torch.randn(R, s, generator=g), torch.randn(R, K, s, generator=g)
    u, eps = torch.randn(R, 1, 2, generator=g), torch.randn(R, K, 2, generator=g)
    cost = QuadraticCost(torch.arange(1.0, s + 1), goals, torch.tensor(0.7), torch.tensor([1.0, 0.5]))
    step, final = cost.step(x, u, eps), cost.final(x)
    assert step.shape == final.shape == (R, K)
    for r in range(R):
        c_r = dataclasses.replace(cost, goal=goals[r])
        assert torch.equal(step[r], c_r.step(x[r], u[r], eps[r]))
        assert torch.equal(final[r], c_r.final(x[r]))


# ---------------------------------------------------------------------------
# the batched tail and world leave single-robot results unchanged


def test_batched_tail_is_the_single_robot_tail():
    from mppi_gpu_tpu_torch.controller import shift_action_seq

    g = torch.Generator().manual_seed(3)
    R, T, A, K = 3, 6, 2, 40
    U, dU = torch.randn(R, T, A, generator=g), torch.randn(R, T, A, generator=g)
    S = 10 * torch.rand(R, K, generator=g)
    beta, eta = S.min(1).values, torch.rand(R, generator=g) + 1.0
    max_a = torch.full((A,), 0.9)
    batch = _finish_fused(U, dU, S, beta, eta, 1.3, max_a, True)
    for r in range(R):
        # the single-robot tail, written out
        w = torch.exp(-(S[r] - beta[r]) / 1.3) / eta[r]
        u_new = torch.clamp(U[r] + dU[r], -max_a, max_a)
        assert torch.equal(shift_action_seq(U[r]), torch.cat([U[r][1:], U[r][-1:]], dim=0))
        solo = _finish_fused(U[r], dU[r], S[r], beta[r], eta[r], 1.3, max_a, True)
        want = _finish(U[r], dU[r], S[r], beta[r], eta[r], w, max_a, True)
        for got in (solo, batch):
            pick = (lambda v: v) if got is solo else (lambda v: v[r])  # noqa: E731
            assert torch.equal(pick(got.action), u_new[0])
            assert torch.equal(pick(got.u_next), torch.cat([u_new[1:], u_new[-1:]], dim=0))
            assert torch.equal(pick(got.info.weights), want.info.weights)
            assert torch.equal(pick(got.info.u_seq), u_new)


def test_batched_world_is_the_single_robot_world():
    """R robots in one batched state step exactly like R single worlds, up
    to the held state after the episode's end, which the device-side
    `advance` decides as `simulate` does on the host."""
    params = WorldParams(n_axes=2)
    world = PointMassWorld(params)
    R = 3
    g = torch.Generator().manual_seed(4)
    batch = world.reset(R)
    assert batch.x.shape == (R, 4) and batch.time.shape == ()
    singles = [world.reset() for _ in range(R)]
    assert torch.equal(singles[0].x, torch.cat([singles[0].q, singles[0].qd]))
    n = params.num_control_steps()
    for step in range(n + 2):
        u = 2.0 * torch.rand(R, 2, generator=g) - 1.0
        batch = world.advance(batch, u)
        for r in range(R):
            singles[r], done = world.simulate(singles[r], u[r])
            assert done == (step >= n)
            assert torch.equal(batch.x[r], singles[r].x)
        assert torch.equal(batch.time, singles[0].time)


def test_fleet_episode_is_single_robot_closed_loops():
    """10 steps of run_fleet_episode on the CPU against R single-robot closed
    loops (`run_closed_loop`), robot r under its seed and goal: every robot
    draws the same noise stream, so the trajectories agree exactly."""
    from mppi_gpu_tpu_torch.runner import run_closed_loop, run_fleet_episode

    cfg = load_config(CFG2).replace(samples=128, horizon=10)
    R = 3
    goals = _goals(R, 4, seed=5)
    fleet = BatchedMPPIController(cfg, R, goals=goals, device="cpu")
    ep = run_fleet_episode(fleet, num_steps=10)
    assert ep.xs.shape == (11, R, 4) and ep.us.shape == (10, R, 2) and ep.times.shape == (10,)
    for r, seed in enumerate(fleet.init_seeds().tolist()):
        solo = run_closed_loop(_solo(cfg, goals[r], seed), max_steps=10)
        np.testing.assert_array_equal(ep.xs[:, r], solo.xs)
        np.testing.assert_array_equal(ep.us[:, r], solo.us)
        np.testing.assert_array_equal(ep.times, solo.times)
    xs0 = np.full((R, 4), 0.1, np.float32)
    ep0 = run_fleet_episode(fleet, num_steps=1, xs0=xs0)
    np.testing.assert_array_equal(ep0.xs[0], xs0)
    with pytest.raises(ValueError, match="xs0"):
        run_fleet_episode(fleet, num_steps=1, xs0=np.zeros((R, 3)))


@pytest.mark.parametrize("mode", [[], ["--episode"]], ids=["host-loop", "episode"])
def test_fleet_example_on_the_cpu(tmp_path, capsys, mode):
    from mppi_gpu_tpu_torch.examples import fleet as example

    # a small, lightly damped point_mass2d, so that 25 steps move the robots
    # past the example's bar
    text = (open(CFG2).read().replace("samples: 3000", "samples: 128")
            .replace("horizon: 50", "horizon: 15").replace("    - 50\n    - 50", "    - 1\n    - 1"))
    cfg = tmp_path / "fleet.yaml"
    cfg.write_text(text)
    rc = example.main(["-c", str(cfg), "-n", "3", "--steps", "25", "--device", "cpu",
                       "--rollout-backend", "eager", *mode])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "3 robots" in out and "eager backend on cpu" in out and "mean distance to goal" in out


def test_fleet_modules_import_no_jax():
    code = (
        "import sys\n"
        "import mppi_gpu_tpu_torch.batched, mppi_gpu_tpu_torch.runner\n"
        "import mppi_gpu_tpu_torch.examples.fleet\n"
        "from mppi_gpu_tpu_torch.runner import run_fleet_episode\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mppi_gpu_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'mppi_gpu_tpu_torch.ops._build' not in sys.modules\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_chip_smoke_fleet_checks_run_on_the_cpu():
    """chip_smoke.py's fleet checks on CPU tensors: the plain fleet against
    itself, the float64 oracle and the single-robot plain solves."""
    import chip_smoke

    chip_smoke.check_fleet_injected(2, 2, 150, 8, device="cpu")
    chip_smoke.check_fleet_philox(3, 2, 150, 6, antithetic=True, ou_beta=0.5, device="cpu")
    chip_smoke.check_fleet_diverged(K=150, T=6, device="cpu")


# ---------------------------------------------------------------------------
# on the card: the fleet kernels themselves, through chip_smoke's checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("A,R,K,T", [(2, 3, 300, 12), (3, 4, 1000, 50)])
def test_gpu_fleet_injected_eps_matches_plain_and_oracle(cuda, A, R, K, T):
    import chip_smoke

    chip_smoke.check_fleet_injected(A, R, K, T, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("antithetic,ou_beta", [(False, 0.0), (True, 0.5)])
def test_gpu_fleet_robots_equal_their_solo_launches(cuda, antithetic, ou_beta):
    import chip_smoke

    chip_smoke.check_fleet_philox(3, 4, 1000, 50, antithetic=antithetic, ou_beta=ou_beta,
                                  device=cuda)


@pytest.mark.gpu
def test_gpu_fleet_diverged_robot(cuda):
    import chip_smoke

    chip_smoke.check_fleet_diverged(device=cuda)
