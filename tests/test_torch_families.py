"""The port's pendulum and cart-pole families against the JAX package: the
models and costs, the eager solve, the fused solve's plain version against
the JAX one-pass Pallas kernel run as tests/test_pallas.py runs it
(testmode pseudo-noise, interpret mode), config dispatch, the worlds, a
closed loop on the same ε, a fleet, and diverging rollouts. Inputs are made
from numpy seeds; each tolerance is stated where it is used. Tests marked
`gpu` run K1's family instances through chip_smoke's checks and skip without
a CUDA device.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.controller import MPPIController as JaxController  # noqa: E402
from mppi_gpu_tpu.controller import mppi_solve_deterministic as jax_solve_det  # noqa: E402
from mppi_gpu_tpu.envs import make_jax_world  # noqa: E402
from mppi_gpu_tpu.models import CartPoleDynamics as JaxCartPole  # noqa: E402
from mppi_gpu_tpu.models import PendulumDynamics as JaxPendulum  # noqa: E402
from mppi_gpu_tpu.models import dynamics_for_config as jax_dynamics_for_config  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu.ops.cost import CartPoleBalanceCost as JaxCartPoleCost  # noqa: E402
from mppi_gpu_tpu.ops.cost import PendulumSwingupCost as JaxPendulumCost  # noqa: E402
from mppi_gpu_tpu.ops.cost import make_cost as jax_make_cost  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController, mppi_solve_deterministic  # noqa: E402
from mppi_gpu_tpu_torch.convert import from_numpy, from_numpy_params  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world  # noqa: E402
from mppi_gpu_tpu_torch.ops import families  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("pendulum", "cartpole")
MODEL_FIELDS = {
    "pendulum": ("dt", "mass", "length", "gravity", "damping"),
    "cartpole": ("dt", "cart_mass", "pole_mass", "pole_length", "gravity"),
}
COST_FIELDS = {"pendulum": ("w_angle", "w_vel", "lambda_", "inv_s"),
               "cartpole": ("w", "lambda_", "inv_s")}
# tests/test_pallas.py's tolerances for the family kernels against the scan path
S_TOL = dict(rtol=3e-5)
DU_TOL = dict(rtol=2e-4, atol=1e-6)


def _cfg_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def _setup(name: str):
    """tests/test_pallas.py::_setup_pendulum / _setup_cartpole: the JAX model
    and cost, and the port's carried across as numpy."""
    if name == "pendulum":
        jdyn = JaxPendulum.create(0.05, mass=1.2, length=0.9, damping=0.15)
        jcost = JaxPendulumCost(w_angle=jnp.float32(4.0), w_vel=jnp.float32(0.2),
                                lambda_=jnp.float32(0.8), inv_s=jnp.full((1,), 1.3))
        x0, sigma, T, freq, amp = [np.pi - 0.3, 0.4], 0.8, 12, 0.2, 0.3
    else:
        jdyn = JaxCartPole.create(0.04, cart_mass=1.1, pole_mass=0.12, pole_length=0.45,
                                  gravity=9.81)
        jcost = JaxCartPoleCost(w=jnp.asarray([0.5, 8.0, 0.1, 0.4]), lambda_=jnp.float32(0.9),
                                inv_s=jnp.full((1,), 1.1))
        x0, sigma, T, freq, amp = [0.1, 0.25, -0.05, 0.3], 1.5, 10, 0.3, 0.4
    tdyn, tcost = from_numpy_params(
        {k: np.asarray(getattr(jdyn, k)) for k in MODEL_FIELDS[name]},
        {k: np.asarray(getattr(jcost, k)) for k in COST_FIELDS[name]}, "cpu",
    )
    U = (amp * np.sin(freq * np.arange(T, dtype=np.float32))).reshape(T, 1).astype(np.float32)
    return (jdyn, jcost), (tdyn, tcost), np.asarray(x0, np.float32), U, np.float32(sigma)


# ---------------------------------------------------------------------------
# (a) models and costs


@pytest.mark.parametrize("name", FAMILIES)
def test_model_and_cost_match_jax(name):
    """Random states, actions and noise through step, accel, cost.step and
    cost.final of both packages. rtol 2e-6, atol 1e-6: a few f32 ops, the
    trig of XLA and of torch apart by an ulp."""
    (jdyn, jcost), (tdyn, tcost), *_ = _setup(name)
    rng = np.random.default_rng(5)
    S = tdyn.state_dim
    x = (rng.standard_normal((256, S)) * 2.0).astype(np.float32)
    u = (rng.standard_normal((256, 1)) * 3.0).astype(np.float32)
    U = rng.standard_normal(1).astype(np.float32)
    eps = rng.standard_normal((256, 1)).astype(np.float32)
    tol = dict(rtol=2e-6, atol=1e-6)
    assert (tdyn.state_dim, tdyn.action_dim) == (jdyn.state_dim, jdyn.action_dim)
    np.testing.assert_allclose(tdyn.step(from_numpy(x, "cpu"), from_numpy(u, "cpu")).numpy(),
                               np.asarray(jdyn.step(jnp.asarray(x), jnp.asarray(u))), **tol)
    th, thd = (from_numpy(x[:, i], "cpu") for i in ((0, 1) if name == "pendulum" else (1, 3)))
    t_acc = tdyn.accel(th, thd, from_numpy(u[:, 0], "cpu"))
    j_acc = jdyn.accel(jnp.asarray(th.numpy()), jnp.asarray(thd.numpy()), jnp.asarray(u[:, 0]))
    for got, want in zip(*((t_acc, j_acc) if name == "cartpole" else ((t_acc,), (j_acc,)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(
        tcost.step(from_numpy(x, "cpu"), from_numpy(U, "cpu"), from_numpy(eps, "cpu")).numpy(),
        np.asarray(jcost.step(jnp.asarray(x), jnp.asarray(U), jnp.asarray(eps))), **tol)
    np.testing.assert_allclose(tcost.final(from_numpy(x, "cpu")).numpy(),
                               np.asarray(jcost.final(jnp.asarray(x))), **tol)


# ---------------------------------------------------------------------------
# (b) the eager solve


@pytest.mark.parametrize("name", FAMILIES)
def test_deterministic_solve_matches_jax_scan(name):
    """mppi_solve_deterministic of both packages on the same ε at K=300:
    S at test_pallas's rtol 3e-5, the update and the action at 1e-4 / 1e-6
    (the softmin amplifies S's f32 differences)."""
    (jdyn, jcost), (tdyn, tcost), x0, U, sigma = _setup(name)
    K, T = 300, U.shape[0]
    eps = (sigma * np.random.default_rng(1).standard_normal((T, K, 1))).astype(np.float32)
    max_a = np.float32([2.0])
    rj = jax_solve_det(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps),
                       jnp.float32(0.8), jnp.asarray(max_a))
    rt = mppi_solve_deterministic(tdyn, tcost, torch.as_tensor(x0), torch.as_tensor(U),
                                  torch.as_tensor(eps), 0.8, torch.as_tensor(max_a))
    np.testing.assert_allclose(rt.info.costs.numpy(), np.asarray(rj.info.costs), **S_TOL)
    np.testing.assert_allclose(rt.info.u_seq.numpy(), np.asarray(rj.info.u_seq), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.action.numpy(), np.asarray(rj.action), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the fused solve's plain version against the JAX one-pass kernel


@pytest.mark.parametrize("ou,anti", [(0.0, False), (0.55, False), (0.0, True)],
                         ids=["iid", "ou", "antithetic"])
@pytest.mark.parametrize("name", FAMILIES)
def test_plain_version_matches_pallas_family_kernel(name, ou, anti):
    """TPU kernel #1 on the family, `_onepass_solve_kernel` with
    `_PendulumFamily` / `_CartPoleFamily`: K1's plain version fed the
    kernel's own ε (its host twin, fake_noise_tensor) gives its S and ΔU at
    test_pallas.py's tolerances."""
    (jdyn, jcost), _, x0, U, sigma = _setup(name)
    K, T = 300, U.shape[0]
    key, lam = jax.random.key(9), 0.8
    plan = pr.make_plan(K, T, 1, antithetic=anti, ou_beta=ou, testmode=True, family=name)
    assert plan.onepass and not plan.planar
    eps = np.asarray(pr.fake_noise_tensor(plan, jnp.full((1,), sigma), ou_beta=ou, key=key))[:, :K]
    S_j, dU_j = pr.pallas_fused_solve_core(
        jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), key, jnp.full((1,), sigma),
        jnp.float32(lam), K=K, antithetic=anti, ou_beta=ou, testmode=True, interpret=True,
    )
    _, (tdyn, tcost), *_ = _setup(name)
    fam = families.family_for(tdyn, tcost, torch.full((1,), float(sigma)))
    assert fam.name == name
    S, beta, eta, dU = fs.family_fused_solve(
        fam, torch.as_tensor(x0), torch.as_tensor(U), None, lam, K, 0, 0, 0, False, 0.0,
        eps=torch.as_tensor(np.ascontiguousarray(eps)),
    )
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j)[:K], **S_TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_j), **DU_TOL)
    np.testing.assert_allclose(float(beta), float(np.asarray(S_j)[:K].min()), **S_TOL)
    assert fs.launch_counts() == {"solve_partials": 0, "softmin_combine": 0, "noise_dump": 0,
                                 "rollout_costs": 0,
                                 "weighted_update": 0}


def test_family_dispatch():
    """tests/test_pallas.py::test_family_dispatch on the port: the exact
    pair picks its family, a mismatched pair is not fusable; the pack holds
    σ, Σ⁻¹ and the family's parameters computed in float32."""
    _, (pdyn, pcost), *_ = _setup("pendulum")
    _, (cdyn, ccost), *_ = _setup("cartpole")
    sigma = torch.ones(1)
    fam = families.family_for(pdyn, pcost, sigma)
    assert (fam.name, fam.fid, fam.state_dim, fam.has_goal) == ("pendulum", 1, 2, False)
    g_l = pdyn.gravity / pdyn.length
    assert torch.equal(fam.params, torch.stack([
        sigma[0], pcost.inv_s[0], pcost.w_angle, pcost.w_vel, g_l, pdyn.mass * pdyn.length**2,
        pdyn.damping]))
    fam = families.family_for(cdyn, ccost, sigma)
    assert (fam.name, fam.fid, fam.state_dim, fam.params.shape) == ("cartpole", 2, 4, (11,))
    with pytest.raises(ValueError, match="params must have shape"):
        fs.family_fused_solve(dataclasses.replace(fam, params=fam.params[:9]), torch.zeros(4),
                              torch.zeros(4, 1), None, 1.0, 16, 0, 0, 0, False, 0.0)
    for dyn, cost in ((pdyn, ccost), (cdyn, pcost)):
        assert not families.is_fusable(dyn, cost)
        with pytest.raises(TypeError, match="fused solve covers"):
            families.family_for(dyn, cost, sigma)
    with pytest.raises(TypeError, match="no goal"):
        fs.family_fused_solve(families.family_for(pdyn, pcost, sigma), torch.zeros(2),
                              torch.zeros(4, 1), torch.zeros(2), 1.0, 16, 0, 0, 0, False, 0.0)


# ---------------------------------------------------------------------------
# (d) config dispatch and the CLI


@pytest.mark.parametrize("name", FAMILIES)
def test_config_builds_the_family_in_both_packages(name):
    """configs/<name>.yaml builds the matching model and cost with equal
    float32 fields in both packages; `auto` is eager on the CPU and `fused`
    there raises."""
    tcfg, jcfg = load_config(_cfg_path(name)), load_jax_config(_cfg_path(name))
    ctrl = MPPIController(tcfg, device="cpu", rollout_backend="auto")
    jdyn, jcost = jax_dynamics_for_config(jcfg), jax_make_cost(jcfg)
    assert type(ctrl.dynamics).__name__ == type(jdyn).__name__
    assert type(ctrl.cost).__name__ == type(jcost).__name__
    for obj, jobj in ((ctrl.dynamics, jdyn), (ctrl.cost, jcost)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            want = np.asarray(getattr(jobj, f.name))
            assert np.array_equal(v.numpy() if isinstance(v, torch.Tensor) else v, want), f.name
    assert ctrl.rollout_backend == "eager" and ctrl._family.name == name
    with pytest.raises(ValueError, match="CUDA device"):
        MPPIController(tcfg, device="cpu", rollout_backend="fused")
    with pytest.raises(ValueError, match="cost.w"):
        from mppi_gpu_tpu_torch.ops.cost import make_cost

        make_cost(tcfg.replace(cost_w=(1.0,) * 3), "cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_cli_runs_the_family_on_the_cpu(capsys, tmp_path, name):
    """The CLI on the config (its K cut to 256 in a copy) on the eager path,
    with a trajectory and step dumps; without a card `--device cuda` exits 2."""
    from mppi_gpu_tpu_torch import cli

    text = open(_cfg_path(name)).read()
    assert "samples: 1024" in text
    cfg_path = tmp_path / f"{name}.yaml"
    cfg_path.write_text(text.replace("samples: 1024", "samples: 256"))
    traj = tmp_path / "traj.csv"
    rc = cli.main(["-c", str(cfg_path), "--device", "cpu", "--max-steps", "3", "-t", str(traj),
                   "-s", str(tmp_path / "dump"), "--dump-every", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "episode finished: 3 control steps" in out
    assert len(traj.read_text().splitlines()) == 4
    assert sorted(p.name for p in (tmp_path / "dump").iterdir()) == ["step_00000.csv", "step_00002.csv"]
    if not torch.cuda.is_available():
        assert cli.main(["-c", _cfg_path(name), "--max-steps", "1"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# (e) the worlds


@pytest.mark.parametrize("name", FAMILIES)
def test_world_matches_jax_world(name):
    """The same actions, past the actuator clamp, through both worlds
    open-loop for 120 control cycles (480 RK4 steps); the cart-pole is
    pushed into its track stop first. Each cycle from the same state agrees
    to rtol 1e-6 / atol 1e-6 (measured 1.2e-7: XLA's and torch's float32
    trig apart by an ulp); the open-loop trajectories to atol 1e-4, since
    the swinging pole carries those ulps apart (measured 1.9e-5 for the
    cart-pole after 120 cycles); the clocks to rel 1e-5 (four float32 adds of
    the timestep per cycle in the port, as numpy's float32 gives; the jitted
    JAX clock lands 1e-6 relative apart after 420 steps). The episode ends
    after num_control_steps() = 500 cycles in both."""
    cfg, jcfg = load_config(_cfg_path(name)), load_jax_config(_cfg_path(name))
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    rng = np.random.default_rng(3)
    limit = cfg.max_a[0]
    at_stop = False
    for n in range(120):
        u = rng.uniform(-1.5 * limit, 1.5 * limit, 1).astype(np.float32)
        if name == "cartpole" and n < 60:
            u[0] = 1.5 * limit  # drive the cart into +track_limit
        one, _ = jsim(jworld.from_x(jnp.asarray(ts.x.numpy()), float(ts.time)), jnp.asarray(u))
        ts, tdone = tworld.simulate(ts, torch.as_tensor(u))
        js, jdone = jsim(js, jnp.asarray(u))
        assert tdone == bool(jdone) is False
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(one.x), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-4)
        assert float(ts.time) == pytest.approx(float(js.time), rel=1e-5)
        at_stop |= name == "cartpole" and float(ts.p) == float(np.float32(tworld.params.track_limit))
    assert at_stop is (name == "cartpole")
    n_steps = tworld.params.num_control_steps()
    assert n_steps == jworld.params.num_control_steps() == 500
    assert tworld.params.steps_per_control == 4
    end = torch.tensor(tworld.params.timestep * (1 + 4 * n_steps))
    assert tworld.simulate(tworld.from_x(ts.x, end), torch.zeros(1))[1] is True
    assert bool(jsim(jworld.from_x(js.x, float(end)), jnp.zeros(1))[1]) is True


# ---------------------------------------------------------------------------
# (f) a closed loop


@pytest.mark.parametrize("name", FAMILIES)
def test_closed_loop_matches_jax_on_the_same_eps(name):
    """20 control steps at K=256, T=20 from the world's start: both
    controllers fed the same numpy ε each step, each driving its own world.

    Each step both packages also solve from the same state and sequence (the
    port's): their actions agree to 5e-4·σ. S agrees to 2e-7 relative (the
    trig of XLA and of torch apart by an ulp, sums in another order), and
    the softmin at λ = 0.2 and S ≈ 335 (the pendulum) turns ΔS ≈ 7e-5 into
    weights 4e-4 apart (measured: 9.4e-5 in the pendulum's action, 2e-5 in
    the cart-pole's). The two closed loops feed those differences back
    through their plants; the cart-pole's unstable upright amplifies them
    (measured by step 20: 4e-4 in state, 1.1e-2 in action), so the loops are
    held to atol 2e-3 in state and 1e-2·σ in action."""
    K, T, steps = 256, 20, 20
    cfg = load_config(_cfg_path(name)).replace(samples=K, horizon=T)
    jcfg = load_jax_config(_cfg_path(name)).replace(samples=K, horizon=T)
    tctrl, jctrl = MPPIController(cfg, device="cpu"), JaxController(jcfg, rollout_backend="scan")
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    tU, jU = tctrl.init_action_seq(), jctrl.init_action_seq()
    sigma = cfg.noise[0]
    rng = np.random.default_rng(0)
    for _ in range(steps):
        eps = (sigma * rng.standard_normal((T, K, 1))).astype(np.float32)
        rt = tctrl.solve_with_eps(ts.x, tU, torch.as_tensor(eps))
        same = jctrl.solve_with_eps(jnp.asarray(ts.x.numpy()), jnp.asarray(tU.numpy()),
                                    jnp.asarray(eps))
        np.testing.assert_allclose(rt.action.numpy(), np.asarray(same.action), rtol=0,
                                   atol=5e-4 * sigma)
        np.testing.assert_allclose(rt.u_next.numpy(), np.asarray(same.u_next), rtol=0,
                                   atol=5e-4 * sigma)
        rj = jctrl.solve_with_eps(js.x, jU, jnp.asarray(eps))
        np.testing.assert_allclose(rt.action.numpy(), np.asarray(rj.action), rtol=0,
                                   atol=1e-2 * sigma)
        tU, jU = rt.u_next, rj.u_next
        ts, _ = tworld.simulate(ts, rt.action)
        js, _ = jsim(js, rj.action)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=2e-3)
    assert float(np.abs(rt.action.numpy()).max()) > 0.1  # the controller acted


# ---------------------------------------------------------------------------
# (g) a fleet


def test_pendulum_fleet_robots_are_solo_solves():
    """A fleet of 3 pendulums (no goals): robot r's solve is the single-robot
    solve under its seed, bit for bit, on the eager backend and through the
    fused solve's plain version; goals= raises TypeError, as in JAX; the
    batched world for the fleet episode is not ported and says so."""
    from mppi_gpu_tpu_torch.runner import run_fleet_episode

    cfg = load_config(_cfg_path("pendulum")).replace(samples=200, horizon=15)
    R = 3
    xs = torch.as_tensor(np.random.default_rng(2).uniform(-3, 3, (R, 2)).astype(np.float32))
    solo = MPPIController(cfg, device="cpu")
    for backend in ("eager", "fused"):
        fleet = BatchedMPPIController(cfg, R, device="cpu")
        fleet.rollout_backend = backend  # `fused` on CPU tensors runs the plain fleet
        solo.rollout_backend = backend
        Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
        res = fleet.solve_batch(xs, Us, seeds, 4)
        for r, seed in enumerate(seeds.tolist()):
            want = solo.solve(xs[r], Us[r], seed, 4)
            assert torch.equal(res.action[r], want.action), (backend, r)
            assert torch.equal(res.u_next[r], want.u_next), (backend, r)
            assert torch.equal(res.info.costs[r], want.info.costs), (backend, r)
    with pytest.raises(TypeError, match="goal"):
        BatchedMPPIController(cfg, R, device="cpu", goals=torch.zeros(R, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_fleet_episode(fleet, num_steps=1)


# ---------------------------------------------------------------------------
# (h) diverging rollouts


def test_extreme_cartpole_state_eager_and_plain_agree():
    """From test_pallas.py's extreme state (θ̇ = 40) the rollouts spin fast
    and stay finite: the eager solve and K1's plain version give the same S
    and action. From θ̇ = 1e4 every rollout overflows into inf − inf: S and
    β are NaN on both paths, the action is NaN and the guard fires."""
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    cfg = load_config(_cfg_path("cartpole")).replace(samples=256, horizon=30)
    ctrl = MPPIController(cfg, device="cpu")
    U = torch.zeros(30, 1)
    for x, finite in ((torch.tensor([0.0, 3.0, 0.0, 40.0]), True),
                      (torch.tensor([0.0, 0.0, 0.0, 1e4]), False)):
        eps = ctrl._eps(2, 0, 0)
        res = ctrl.solve_with_eps(x, U, eps)
        S, beta, eta, dU = fs.family_fused_solve(ctrl._family, x, U, None, cfg.lambda_, 256,
                                                 0, 0, 0, False, 0.0, eps=eps)
        np.testing.assert_array_equal(S.numpy(), res.info.costs.numpy())  # NaN == NaN here
        assert bool(torch.isfinite(S).all()) is finite
        if finite:
            np.testing.assert_allclose(float(beta), float(res.info.beta), rtol=0)
            np.testing.assert_allclose(dU.numpy(), (res.info.u_seq - U).numpy(), rtol=1e-5, atol=1e-6)
            continue
        assert torch.isnan(S).all() and torch.isnan(beta) and torch.isnan(res.info.beta)
        assert torch.isnan(dU).all() and torch.isnan(res.action).all()
        with pytest.raises(ControllerDiverged):
            check_solve(0, res.action.numpy(), res.info)


# ---------------------------------------------------------------------------
# chip_smoke's family checks: a rehearsal on the CPU, and on the card


@pytest.mark.parametrize("name,edit", [("cartpole", dict(pole_mass=0.35)),
                                       ("point_mass3d", dict(dt=0.05))])
def test_pack_follows_a_reassigned_model(name, edit):
    """The stale-pack repair for the model: after ``ctrl.dynamics =
    dataclasses.replace(ctrl.dynamics, ...)`` the controller's pack is a
    fresh family_for pack of the new model and the cost (its parameters,
    dt and the plain version's model), and the fused solve's plain version
    (K1 + K2's, on CPU tensors) equals the eager solve with the new model on
    the same ε, S bit for bit; a model no family fuses leaves no pack on the
    eager backend and raises, changing nothing, on the fused one."""
    cfg = load_config(_cfg_path(name)).replace(samples=200, horizon=8)
    ctrl = MPPIController(cfg, device="cpu")
    old = ctrl._family
    new = dataclasses.replace(ctrl.dynamics, **{k: torch.tensor(v) for k, v in edit.items()})
    ctrl.dynamics = new
    fresh = families.family_for(new, ctrl.cost, ctrl.sigma)
    assert ctrl.dynamics is new and ctrl._family.dynamics is new
    assert torch.equal(ctrl._family.params, fresh.params) and ctrl._family.dt == fresh.dt
    assert not (torch.equal(ctrl._family.params, old.params) and ctrl._family.dt == old.dt)
    x, U = torch.full((cfg.state_dim,), 0.1), ctrl.init_action_seq()
    eps = ctrl._eps(1, 0, 0)
    eager = ctrl.solve_with_eps(x, U, eps)
    S, beta, eta, dU = fs.family_fused_solve(ctrl._family, x, U, None if name == "cartpole" else ctrl.cost.goal,
                                             cfg.lambda_, cfg.samples, 0, 0, 0, False, 0.0, eps=eps)
    assert torch.equal(S, eager.info.costs)
    u_new = torch.clamp(U + dU, -ctrl.max_a, ctrl.max_a)
    np.testing.assert_allclose(u_new.numpy(), eager.info.u_seq.numpy(), rtol=1e-5, atol=1e-6)
    from mppi_gpu_tpu_torch.models import PendulumDynamics

    ctrl.dynamics = PendulumDynamics.create(0.05)  # with this cost: no family
    assert ctrl._family is None
    ctrl.dynamics = new
    ctrl.rollout_backend = "fused"  # on CPU tensors: K1 + K2's plain versions
    with pytest.raises(ValueError, match="fused backend covers"):
        ctrl.dynamics = PendulumDynamics.create(0.05)
    assert ctrl.dynamics is new and ctrl._family.dynamics is new


def test_chip_smoke_family_checks_run_on_the_cpu():
    """chip_smoke.py's phase-11 checks on CPU tensors compare the plain
    versions with themselves and with the float64 plain version: a
    rehearsal of the script's logic that needs no card."""
    import chip_smoke

    for name in FAMILIES:
        e = chip_smoke.check_family_injected(name, 300, 20, device="cpu")
        assert e["S_rel_max"] < 1e-5
        chip_smoke.check_family_philox(name, 300, 20, antithetic=True, ou_beta=0.55, device="cpu")
        chip_smoke.check_family_fleet(name, 3, 300, 20, device="cpu")
    chip_smoke.check_family_diverged(device="cpu")
    assert fs.launch_counts() == {"solve_partials": 0, "softmin_combine": 0, "noise_dump": 0,
                                 "rollout_costs": 0,
                                 "weighted_update": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_gpu_family_injected_and_philox(cuda, name):
    import chip_smoke

    chip_smoke.check_family_injected(name, 1000, 40, device=cuda)
    chip_smoke.check_family_philox(name, 1000, 40, antithetic=True, ou_beta=0.55, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_gpu_family_fleet(cuda, name):
    import chip_smoke

    chip_smoke.check_family_fleet(name, 4, 1000, 40, device=cuda)


@pytest.mark.gpu
def test_gpu_family_diverged(cuda):
    import chip_smoke

    chip_smoke.check_family_diverged(device=cuda)
