"""The port's coupled A=2 families (unicycle, planar quadrotor, two-link arm)
and the costs-only sweep against the JAX package: the models and costs, the
parameter carry-over, config dispatch, the eager solve, the fused solve's
and the costs-only sweep's plain versions against the JAX state-planar
Pallas kernels run as tests/test_unicycle.py runs them (testmode
pseudo-noise, interpret mode), the arm's cost link lengths and NaN
saturation, the worlds, a closed loop on the same ε, and a fleet with
per-robot goals. Inputs are made from numpy seeds; each tolerance is stated
where it is used. Tests marked `gpu` run K1's new instances and K4 through
chip_smoke's checks and skip without a CUDA device.
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
from mppi_gpu_tpu.models import QuadrotorDynamics as JaxQuadrotor  # noqa: E402
from mppi_gpu_tpu.models import TwoLinkArmDynamics as JaxArm  # noqa: E402
from mppi_gpu_tpu.models import UnicycleDynamics as JaxUnicycle  # noqa: E402
from mppi_gpu_tpu.models import dynamics_for_config as jax_dynamics_for_config  # noqa: E402
from mppi_gpu_tpu.ops import cost as jc  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import (  # noqa: E402
    MPPIController,
    mppi_solve_deterministic,
    resolve_backend,
)
from mppi_gpu_tpu_torch.convert import from_numpy, from_numpy_params  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world, params_for_config  # noqa: E402
from mppi_gpu_tpu_torch.models import dynamics_for_config  # noqa: E402
from mppi_gpu_tpu_torch.ops import families  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops.cost import make_cost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("unicycle", "quadrotor", "arm")
MODEL_FIELDS = {
    "unicycle": ("dt",),
    "quadrotor": ("dt", "mass", "inertia", "arm", "gravity"),
    "arm": ("dt", "A", "B", "D", "G1", "G2", "damping", "max_rate", "l1", "l2"),
}
GOAL_COST = ("w", "goal", "lambda_", "inv_s")
COST_FIELDS = {"unicycle": GOAL_COST, "quadrotor": GOAL_COST, "arm": GOAL_COST + ("l1", "l2")}
# tests/test_unicycle.py's tolerances for the planar kernel against the scan
# path (:136, :144): the TPU side steps with Taylor-δ trig, so float32
# rounding stands between the two
S_TOL = dict(rtol=3e-5)
DU_TOL = dict(rtol=2e-4, atol=1e-6)
# closed loops on the same ε: (action atol in units of σ, state atol)
LOOP_TOL = {"unicycle": (2e-3, 2e-5), "quadrotor": (5e-3, 5e-4), "arm": (1e-1, 2e-2)}
ZERO_LAUNCHES = {"solve_partials": 0, "softmin_combine": 0, "noise_dump": 0, "rollout_costs": 0,
                 "weighted_update": 0}


def _cfg_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def _setup(name: str):
    """The JAX model and cost at the config's widths (tests/test_unicycle.py
    ::_setup_unicycle for the unicycle; the arm's cost with link lengths
    other than its model's), the port's carried across as numpy, a start, a
    live nominal sequence (T, 2) about the config's init-act, and σ."""
    if name == "unicycle":
        jdyn = JaxUnicycle.create(0.05)
        jcost = jc.UnicycleWaypointCost(
            w=jnp.asarray([4.0, 1.0]), goal=jnp.asarray([2.0, 1.0, 0.0]),
            lambda_=jnp.float32(0.3), inv_s=jnp.asarray([1.0, 0.6]))
        x0, sigma, u0 = [0.1, -0.2, 0.4], [0.6, 1.0], [0.8, 0.0]
    elif name == "quadrotor":
        jdyn = JaxQuadrotor.create(1 / 60)
        jcost = jc.QuadrotorHoverCost(
            w=jnp.asarray([4.0, 4.0, 10.0, 1.5, 1.5, 2.0]),
            goal=jnp.asarray([1.0, 0.5, 0.0, 0.0, 0.0, 0.0]), lambda_=jnp.float32(0.1),
            inv_s=jnp.asarray([1.0, 44.0]))
        x0, sigma, u0 = [-0.9, 0.1, 0.05, 0.2, -0.1, 0.3], [1.0, 0.15], [7.848, 0.0]
    else:
        jdyn = JaxArm.create(1 / 60)
        jcost = jc.ArmReachCost(
            w=jnp.asarray([20.0, 0.05]), goal=jnp.asarray([0.55, 0.35, 0.0, 0.0]),
            lambda_=jnp.float32(0.1), inv_s=jnp.asarray([0.25, 1.0]), l1=0.45, l2=0.6)
        x0, sigma, u0 = [-1.4, 0.3, 0.5, -0.4], [2.0, 1.0], [0.0, 0.0]
    tdyn, tcost = from_numpy_params(
        {k: np.asarray(getattr(jdyn, k)) for k in MODEL_FIELDS[name]},
        {k: np.asarray(getattr(jcost, k)) for k in COST_FIELDS[name]}, "cpu",
    )
    T = 12
    t = np.arange(T, dtype=np.float32)[:, None]
    U = (np.float32(u0) + 0.3 * np.float32(sigma) * np.sin(0.3 * t + np.arange(2))).astype(np.float32)
    return (jdyn, jcost), (tdyn, tcost), np.float32(x0), U, np.float32(sigma)


# ---------------------------------------------------------------------------
# (a) models, costs and the carry-over


@pytest.mark.parametrize("name", FAMILIES)
def test_model_and_cost_match_jax(name):
    """Random states, actions and noise through step, cost.step and
    cost.final of both packages (and the quadrotor's accels, the arm's
    end_effector). rtol 3e-6, atol 2e-6: a few f32 ops; XLA's and torch's
    trig (and the unicycle's rsqrt) apart by an ulp, which the arm's 1/det
    can grow to a few."""
    (jdyn, jcost), (tdyn, tcost), *_ = _setup(name)
    rng = np.random.default_rng(5)
    S = tdyn.state_dim
    x = (rng.standard_normal((256, S)) * 2.0).astype(np.float32)
    u = (rng.standard_normal((256, 2)) * 3.0).astype(np.float32)
    U = rng.standard_normal(2).astype(np.float32)
    eps = rng.standard_normal((256, 2)).astype(np.float32)
    tol = dict(rtol=3e-6, atol=2e-6)
    assert (tdyn.state_dim, tdyn.action_dim) == (jdyn.state_dim, jdyn.action_dim)
    tx, jx = from_numpy(x, "cpu"), jnp.asarray(x)
    np.testing.assert_allclose(tdyn.step(tx, from_numpy(u, "cpu")).numpy(),
                               np.asarray(jdyn.step(jx, jnp.asarray(u))), **tol)
    np.testing.assert_allclose(
        tcost.step(tx, from_numpy(U, "cpu"), from_numpy(eps, "cpu")).numpy(),
        np.asarray(jcost.step(jx, jnp.asarray(U), jnp.asarray(eps))), **tol)
    np.testing.assert_allclose(tcost.final(tx).numpy(), np.asarray(jcost.final(jx)), **tol)
    if name == "quadrotor":
        for got, want in zip(tdyn.accels(tx[:, 2], from_numpy(u, "cpu")),
                             jdyn.accels(jx[:, 2], jnp.asarray(u))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    if name == "arm":
        np.testing.assert_allclose(tdyn.end_effector(tx).numpy(),
                                   np.asarray(jdyn.end_effector(jx)), **tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_from_numpy_params_round_trips(name):
    """Every field of the JAX model and cost arrives as an equal float32
    tensor (the JAX arm cost's link lengths are Python floats, which it
    computes with in float32); goals= swaps in per-robot goals; a field set
    no family has raises."""
    (jdyn, jcost), (tdyn, tcost), *_ = _setup(name)
    for obj, jobj, names in ((tdyn, jdyn, MODEL_FIELDS[name]), (tcost, jcost, COST_FIELDS[name])):
        for f in names:
            v, want = getattr(obj, f), np.asarray(getattr(jobj, f), np.float32)
            assert v.dtype == torch.float32 and np.array_equal(v.numpy(), want), f
    goals = np.arange(2 * tdyn.state_dim, dtype=np.float32).reshape(2, -1)
    _, fleet_cost = from_numpy_params(
        {k: np.asarray(getattr(jdyn, k)) for k in MODEL_FIELDS[name]},
        {k: np.asarray(getattr(jcost, k)) for k in COST_FIELDS[name]}, "cpu", goals=goals)
    assert np.array_equal(fleet_cost.goal.numpy(), goals)
    with pytest.raises(ValueError, match="no family"):
        from_numpy_params({"dt": 0.1, "mass": 1.0}, {}, "cpu")


# ---------------------------------------------------------------------------
# (b) config dispatch


@pytest.mark.parametrize("name", FAMILIES)
def test_config_builds_the_family_in_both_packages(name):
    """configs/<name>.yaml builds the matching model, cost and world with
    equal float32 fields in both packages; the pair is the fused family;
    `auto` is eager on the CPU and fused on a CUDA device; `fused` on the
    CPU raises; a cost.w of the wrong length raises."""
    tcfg, jcfg = load_config(_cfg_path(name)), load_jax_config(_cfg_path(name))
    ctrl = MPPIController(tcfg, device="cpu", rollout_backend="auto")
    jdyn, jcost = jax_dynamics_for_config(jcfg), jc.make_cost(jcfg)
    assert type(ctrl.dynamics).__name__ == type(jdyn).__name__
    assert type(ctrl.cost).__name__ == type(jcost).__name__
    for obj, jobj in ((ctrl.dynamics, jdyn), (ctrl.cost, jcost)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            want = np.asarray(getattr(jobj, f.name))
            assert np.array_equal(v.numpy() if isinstance(v, torch.Tensor) else v, want), f.name
    fam = ctrl._family
    assert ctrl.rollout_backend == "eager" and fam.name == name and fam.has_goal
    assert fam.fid == families.FAMILY_ID[name] and fam.params.shape == (fam.n_params,)
    assert resolve_backend("auto", torch.device("cuda"), ctrl.dynamics, ctrl.cost) == "fused"
    with pytest.raises(ValueError, match="CUDA device"):
        MPPIController(tcfg, device="cpu", rollout_backend="fused")
    with pytest.raises(ValueError, match="cost.w"):
        make_cost(tcfg.replace(cost_w=(1.0,) * 3), "cpu")
    tparams, jparams = params_for_config(tcfg), make_jax_world(jcfg).params
    for f in dataclasses.fields(tparams):
        assert getattr(tparams, f.name) == getattr(jparams, f.name), f.name
    assert type(make_world(tcfg)).__name__ == type(make_jax_world(jcfg)).__name__
    assert families.family_name(dynamics_for_config(tcfg, "cpu"), make_cost(tcfg, "cpu")) == name
    assert type(ctrl.dynamics).__name__ in families.covered()


def test_pack_and_mismatched_pairs():
    """The pack holds σ, Σ⁻¹ and each family's parameters in float32 from the
    model's and the cost's own tensors (the arm's link lengths from its
    cost); a family with a goal raises without one; mismatched pairs are
    not fusable; configs/quadrotor3d.yaml, the last family ported, builds its
    own fused pair, the quadrotor3d family."""
    setups = {n: _setup(n)[1] for n in FAMILIES}
    sigma = torch.tensor([0.5, 0.25])
    udyn, ucost = setups["unicycle"]
    qdyn, qcost = setups["quadrotor"]
    adyn, acost = setups["arm"]
    for (dyn, cost), part in (
        ((udyn, ucost), [ucost.w]),
        ((qdyn, qcost), [qcost.w, qdyn.mass, qdyn.inertia, qdyn.arm, qdyn.gravity]),
        ((adyn, acost), [acost.w, adyn.A, adyn.B, adyn.D, adyn.G1, adyn.G2, adyn.damping,
                         adyn.max_rate, acost.l1, acost.l2]),
    ):
        fam = families.family_for(dyn, cost, sigma)
        assert torch.equal(fam.params, torch.cat([t.reshape(-1) for t in [sigma, cost.inv_s] + part]))
        assert fam.state_dim == dyn.state_dim and fam.n_params == fam.params.numel()
        with pytest.raises(ValueError, match="aims at a goal"):
            fs.family_fused_solve(fam, torch.zeros(dyn.state_dim), torch.zeros(4, 2), None, 1.0,
                                  16, 0, 0, 0, False, 0.0)
        with pytest.raises(ValueError, match="goal must have shape"):
            fs.family_fused_solve(fam, torch.zeros(dyn.state_dim), torch.zeros(4, 2),
                                  torch.zeros(2), 1.0, 16, 0, 0, 0, False, 0.0)
    assert not acost.l1 == adyn.l1  # the setup's arm aims with other link lengths
    for dyn, cost in ((udyn, qcost), (qdyn, acost), (adyn, ucost)):
        assert not families.is_fusable(dyn, cost)
        with pytest.raises(TypeError, match="fused solve covers"):
            families.family_for(dyn, cost, sigma)
    cfg = load_config(_cfg_path("quadrotor3d"))
    assert families.family_name(dynamics_for_config(cfg, "cpu"), make_cost(cfg, "cpu")) == "quadrotor3d"
    assert params_for_config(cfg).state_dim == 13


# ---------------------------------------------------------------------------
# (c) the eager solve and the fused solve's plain version


@pytest.mark.parametrize("name", FAMILIES)
def test_deterministic_solve_matches_jax_scan(name):
    """mppi_solve_deterministic of both packages on the same ε at K=300: S at
    the planar kernel's rtol 3e-5, the update and the action at 1e-4 / 1e-6
    (the softmin amplifies S's f32 differences)."""
    (jdyn, jcost), (tdyn, tcost), x0, U, sigma = _setup(name)
    K, T = 300, U.shape[0]
    eps = (sigma * np.random.default_rng(1).standard_normal((T, K, 2))).astype(np.float32)
    max_a = np.float32([16.0, 3.0])
    rj = jax_solve_det(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps),
                       jnp.float32(0.7), jnp.asarray(max_a))
    rt = mppi_solve_deterministic(tdyn, tcost, torch.as_tensor(x0), torch.as_tensor(U),
                                  torch.as_tensor(eps), 0.7, torch.as_tensor(max_a))
    np.testing.assert_allclose(rt.info.costs.numpy(), np.asarray(rj.info.costs), **S_TOL)
    np.testing.assert_allclose(rt.info.u_seq.numpy(), np.asarray(rj.info.u_seq), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.action.numpy(), np.asarray(rj.action), rtol=1e-4, atol=1e-6)


def _planar(name, ou, anti, K=300):
    """TPU kernel #2 (`_planar_onepass_kernel`) and #8 (`_planar_costs_kernel`)
    on the family in interpret mode, and the planar testmode ε they consumed
    (planar_fake_noise_tensor, their host twin)."""
    (jdyn, jcost), (tdyn, tcost), x0, U, sigma = _setup(name)
    key, lam = jax.random.key(9), 0.7
    plan = pr.make_plan(K, U.shape[0], 2, antithetic=anti, ou_beta=ou, testmode=True, family=name)
    assert plan.planar  # COUPLED_PLANAR_FAMILIES always take the planar plan
    eps = np.asarray(pr.planar_fake_noise_tensor(plan, jnp.asarray(sigma), ou_beta=ou, key=key))
    args = (jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), key, jnp.asarray(sigma))
    S_j, dU_j = pr.pallas_fused_solve_core(*args, jnp.float32(lam), K=K, antithetic=anti,
                                           ou_beta=ou, testmode=True, interpret=True)
    fam = families.family_for(tdyn, tcost, torch.as_tensor(sigma))
    inputs = (fam, torch.as_tensor(x0), torch.as_tensor(U), tcost.goal)
    return args, (S_j, dU_j), fam, inputs, torch.as_tensor(np.ascontiguousarray(eps[:, :K])), lam


@pytest.mark.parametrize("ou,anti", [(0.0, False), (0.8, False), (0.0, True)],
                         ids=["iid", "ou", "antithetic"])
@pytest.mark.parametrize("name", FAMILIES)
def test_plain_version_matches_pallas_planar_kernel(name, ou, anti):
    """TPU kernel #2 on the family: K1's plain version fed the kernel's own ε
    gives its S at tests/test_unicycle.py's rtol 3e-5, and its per-block
    partials folded by K2's plain version give the kernel's ΔU from the
    kernel's S at rtol 2e-4, atol 1e-6 (as tests/test_unicycle.py holds the
    kernel's ΔU to the update on its own S: the S apart by f32 rounding,
    divided by λ, would move the weights by more); nothing is launched on
    CPU tensors."""
    _, (S_j, dU_j), fam, inputs, eps, lam = _planar(name, ou, anti)
    K = eps.shape[1]
    S, beta, eta, dU = fs.family_fused_solve(*inputs, lam, K, 0, 0, 0, False, 0.0, eps=eps)
    S_j = torch.as_tensor(np.asarray(S_j)[:K])
    np.testing.assert_allclose(S.numpy(), S_j.numpy(), **S_TOL)
    np.testing.assert_allclose(float(beta), float(S_j.min()), **S_TOL)
    _, _, dU_on_S_j = fs.softmin_combine(fs.block_partials(S_j, eps, lam), lam, *inputs[2].shape)
    np.testing.assert_allclose(dU_on_S_j.numpy(), np.asarray(dU_j), **DU_TOL)
    assert fs.launch_counts() == ZERO_LAUNCHES


@pytest.mark.parametrize("name", FAMILIES)
def test_costs_only_plain_version_matches_pallas_planar_costs(name):
    """TPU kernel #8 (`pallas_planar_rollout_costs`) on the family: the
    costs-only sweep's plain version on the same ε gives its S at rtol
    3e-5, and equals the plain K1's S bit for bit (the sweep is K1's first
    pass), in the fleet form too."""
    args, _, fam, inputs, eps, lam = _planar(name, 0.8, False)
    K = eps.shape[1]
    S_j = pr.pallas_planar_rollout_costs(*args, K=K, ou_beta=0.8, testmode=True, interpret=True)
    S = fs.fused_rollout_costs(*inputs, K, 0, 0, 0, False, 0.0, eps=eps)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j)[:K], **S_TOL)
    S1, _ = fs.family_solve_partials(*inputs, lam, K, 0, 0, 0, False, 0.0, eps=eps)
    assert torch.equal(S, S1)
    fam, x0, U, goal = inputs
    xs, Us, goals = x0.expand(2, -1), U.expand(2, -1, -1), goal.expand(2, -1)
    fleet = fs.fleet_rollout_costs(fam, xs.contiguous(), Us.contiguous(), goals.contiguous(), K,
                                   torch.tensor([3, 4]), 1, 0, True, 0.8)
    for r, seed in enumerate((3, 4)):
        assert torch.equal(fleet[r], fs.fused_rollout_costs(*inputs, K, seed, 1, 0, True, 0.8))
    assert fs.launch_counts() == ZERO_LAUNCHES


def test_arm_uses_the_cost_link_lengths():
    """tests/test_arm.py::test_arm_fused_uses_cost_link_lengths on the port:
    with cost link lengths other than the model's, K1's plain version
    follows the cost's (it equals the eager solve), and moving them moves
    S."""
    _, (tdyn, tcost), x0, U, sigma = _setup("arm")
    assert float(tcost.l1) != float(tdyn.l1) and float(tcost.l2) != float(tdyn.l2)
    K, T = 200, U.shape[0]
    eps = torch.as_tensor((sigma * np.random.default_rng(4).standard_normal((T, K, 2))).astype(np.float32))
    x0, U = torch.as_tensor(x0), torch.as_tensor(U)
    fam = families.family_for(tdyn, tcost, torch.as_tensor(sigma))
    assert fam.params[-2:].tolist() == [float(tcost.l1), float(tcost.l2)]
    S = fs.fused_rollout_costs(fam, x0, U, tcost.goal, K, 0, 0, 0, False, 0.0, eps=eps)
    res = mppi_solve_deterministic(tdyn, tcost, x0, U, eps, 0.1, torch.tensor([14.0, 7.0]))
    assert torch.equal(S, res.info.costs)
    same = dataclasses.replace(tcost, l1=tdyn.l1, l2=tdyn.l2)
    S_dyn = fs.fused_rollout_costs(families.family_for(tdyn, same, torch.as_tensor(sigma)), x0, U,
                                   tcost.goal, K, 0, 0, 0, False, 0.0, eps=eps)
    assert float((S - S_dyn).abs().min()) > 1e-3


def test_arm_nan_saturation_and_guard():
    """The arm's rate saturation keeps NaN (torch.clamp does; fminf/fmaxf in
    the kernel would not). From rates of 1e20 at q2 = 0, B·sin q2·q̇² is
    0·inf = NaN: every rollout costs NaN on the eager path and in K1's plain
    version alike, β and the action are NaN and the guard fires."""
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    _, (tdyn, _), *_ = _setup("arm")
    x = torch.tensor([[0.5, 0.1, float("nan"), 30.0], [0.0, 0.0, -40.0, 1.0]])
    out = tdyn._sat(x)
    assert torch.isnan(out[0, 2]) and out[0, 3] == tdyn.max_rate and out[1, 2] == -tdyn.max_rate
    cfg = load_config(_cfg_path("arm")).replace(samples=256, horizon=20)
    ctrl = MPPIController(cfg, device="cpu")
    x0, U = torch.tensor([0.0, 0.0, 1e20, 1e20]), ctrl.init_action_seq()
    eps = ctrl._eps(2, 0, 0)
    res = ctrl.solve_with_eps(x0, U, eps)
    S, beta, eta, dU = fs.family_fused_solve(ctrl._family, x0, U, ctrl.cost.goal, cfg.lambda_, 256,
                                             0, 0, 0, False, 0.0, eps=eps)
    assert torch.isnan(S).all() and torch.isnan(res.info.costs).all()
    assert torch.isnan(beta) and torch.isnan(res.info.beta) and torch.isnan(res.action).all()
    with pytest.raises(ControllerDiverged):
        check_solve(0, res.action.numpy(), res.info)
    import chip_smoke

    assert "ControllerDiverged" in chip_smoke.check_coupled_diverged("arm", device="cpu")


# ---------------------------------------------------------------------------
# (d) the worlds and a closed loop


@pytest.mark.parametrize("name", FAMILIES)
def test_world_matches_jax_world(name):
    """The same actions, past the actuator clamps (and the quadrotor's rotor
    envelope), through both worlds open-loop for 60 control cycles (240 RK4
    steps). Each cycle from the same state agrees to rtol 1e-6 / atol 2e-6
    (XLA's and torch's float32 trig apart by an ulp); the open-loop
    trajectories to atol 2e-4 (the ulps carried along); the clocks to rel
    1e-5. Both episodes end after num_control_steps() cycles."""
    cfg, jcfg = load_config(_cfg_path(name)), load_jax_config(_cfg_path(name))
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    rng = np.random.default_rng(3)
    limit = np.float32(cfg.max_a)
    for _ in range(60):
        u = (np.float32(cfg.init_act) + rng.uniform(-1.5, 1.5, 2) * limit).astype(np.float32)
        one, _ = jsim(jworld.from_x(jnp.asarray(ts.x.numpy()), float(ts.time)), jnp.asarray(u))
        ts, tdone = tworld.simulate(ts, torch.as_tensor(u))
        js, jdone = jsim(js, jnp.asarray(u))
        assert tdone == bool(jdone) is False
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(one.x), rtol=1e-6, atol=2e-6)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=2e-4)
        assert float(ts.time) == pytest.approx(float(js.time), rel=1e-5)
    n_steps = tworld.params.num_control_steps()
    assert n_steps == jworld.params.num_control_steps()
    end = torch.tensor(tworld.params.timestep * (1 + tworld.params.steps_per_control * n_steps))
    assert tworld.simulate(tworld.from_x(ts.x, end), torch.zeros(2))[1] is True


@pytest.mark.parametrize("name", FAMILIES)
def test_closed_loop_matches_jax_on_the_same_eps(name):
    """10 control steps at K=256, T=20 from the world's start: both
    controllers (the arm with its two updates per step) fed the same numpy
    ε each update, each driving its own world. Each update both also solve
    from the same state and sequence: their sequences agree to 1e-3·σ (S
    apart by ulps, turned into weight differences by the sharp softmin,
    λ = 0.1; measured 5.8e-4 for the arm). The loops feed those differences
    back through their plants, held to LOOP_TOL (action in units of σ,
    state): measured 4.8e-6 / 1.3e-7 for the unicycle, 7.3e-4 / 5.7e-5 for
    the quadrotor, 7.1e-2 / 7.7e-3 for the arm, which lifts its 1.8 kg from
    hanging with ~8 N·m, two updates per step, its S ≈ 2·10³."""
    K, T, steps = 256, 20, 10
    cfg = load_config(_cfg_path(name)).replace(samples=K, horizon=T)
    jcfg = load_jax_config(_cfg_path(name)).replace(samples=K, horizon=T)
    tctrl, jctrl = MPPIController(cfg, device="cpu"), JaxController(jcfg, rollout_backend="scan")
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    tU, jU = tctrl.init_action_seq(), jctrl.init_action_seq()
    sigma = np.float32(cfg.noise)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        for it in range(cfg.opt_iters):
            eps = (sigma * rng.standard_normal((T, K, 2))).astype(np.float32)
            rt = tctrl.solve_with_eps(ts.x, tU, torch.as_tensor(eps))
            same = jctrl.solve_with_eps(jnp.asarray(ts.x.numpy()), jnp.asarray(tU.numpy()),
                                        jnp.asarray(eps))
            np.testing.assert_allclose(rt.info.u_seq.numpy(), np.asarray(same.info.u_seq), rtol=0,
                                       atol=1e-3 * sigma.max())
            rj = jctrl.solve_with_eps(js.x, jU, jnp.asarray(eps))
            if it < cfg.opt_iters - 1:
                tU, jU = rt.info.u_seq, rj.info.u_seq
        np.testing.assert_allclose(rt.action.numpy(), np.asarray(rj.action), rtol=0,
                                   atol=LOOP_TOL[name][0] * sigma.max())
        tU, jU = rt.u_next, rj.u_next
        ts, _ = tworld.simulate(ts, rt.action)
        js, _ = jsim(js, rj.action)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=LOOP_TOL[name][1])
    assert float(np.abs(rt.action.numpy() - np.float32(cfg.init_act)).max()) > 0.1  # it acted


@pytest.mark.parametrize("name", FAMILIES)
def test_cli_runs_the_family_on_the_cpu(capsys, tmp_path, name):
    """The CLI on the config (K cut to 128 in a copy) on the eager path,
    with a trajectory and a step dump; without a card `--device cuda`
    exits 2 (no silent fallback)."""
    from mppi_gpu_tpu_torch import cli

    text = open(_cfg_path(name)).read()
    assert "samples: 1024" in text
    cfg_path = tmp_path / f"{name}.yaml"
    cfg_path.write_text(text.replace("samples: 1024", "samples: 128"))
    traj = tmp_path / "traj.csv"
    rc = cli.main(["-c", str(cfg_path), "--device", "cpu", "--max-steps", "2", "-t", str(traj),
                   "-s", str(tmp_path / "dump"), "--dump-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "episode finished: 2 control steps" in out
    assert len(traj.read_text().splitlines()) == 3
    assert len(list((tmp_path / "dump").iterdir())) == 2
    if not torch.cuda.is_available():
        assert cli.main(["-c", _cfg_path(name), "--max-steps", "1"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# (e) a fleet with per-robot goals


@pytest.mark.parametrize("name", FAMILIES)
def test_fleet_robots_with_goals_are_solo_solves(name):
    """A fleet of 3 robots with distinct goals: robot r's solve is the
    single-robot solve under its seed and goal, bit for bit, on the eager
    backend and through the fused solve's plain version; the per-robot
    costs broadcast over (R, K, s) states as robot by robot; the fleet
    episode's batched world is not ported and says so."""
    from mppi_gpu_tpu_torch.runner import run_fleet_episode

    cfg = load_config(_cfg_path(name)).replace(samples=160, horizon=10)
    R, S = 3, cfg.state_dim
    rng = np.random.default_rng(2)
    goals = np.tile(np.float32(cfg.goal), (R, 1))
    goals[:, :2] += rng.uniform(-0.5, 0.5, (R, 2)).astype(np.float32)
    xs = torch.as_tensor(rng.uniform(-0.5, 0.5, (R, S)).astype(np.float32))
    goals = torch.as_tensor(goals)
    for backend in ("eager", "fused"):
        fleet = BatchedMPPIController(cfg, R, device="cpu", goals=goals)
        fleet.rollout_backend = backend  # `fused` on CPU tensors runs the plain fleet
        Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
        res = fleet.solve_batch(xs, Us, seeds, 4)
        for r, seed in enumerate(seeds.tolist()):
            solo = MPPIController(cfg, device="cpu", cost=fleet._robot_cost(r))
            solo.rollout_backend = backend
            want = solo.solve(xs[r], Us[r], seed, 4)
            assert torch.equal(res.action[r], want.action), (backend, r)
            assert torch.equal(res.info.costs[r], want.info.costs), (backend, r)
    states = torch.as_tensor(rng.standard_normal((R, 5, S)).astype(np.float32))
    batched = fleet.cost.final(states)
    for r in range(R):
        assert torch.allclose(batched[r], fleet._robot_cost(r).final(states[r]), rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_fleet_episode(fleet, num_steps=1)


# ---------------------------------------------------------------------------
# chip_smoke's checks: a rehearsal on the CPU, and on the card


def test_chip_smoke_coupled_checks_run_on_the_cpu():
    """chip_smoke.py's phase-13 and phase-15 checks on CPU tensors compare
    the plain versions with themselves and with the float64 plain version:
    a rehearsal of the script's logic that needs no card; and its SASS loop
    counter on a synthetic loop with a slow path branched around."""
    import chip_smoke

    for name in FAMILIES:
        e = chip_smoke.check_family_injected(name, 200, 15, device="cpu")
        assert e["S_rel_max"] < 1e-5
        chip_smoke.check_family_philox(name, 200, 15, antithetic=True, ou_beta=0.8, device="cpu")
        chip_smoke.check_family_fleet(name, 3, 200, 15, device="cpu")
        chip_smoke.check_coupled_diverged(name, device="cpu")
        chip_smoke.check_costs_only(name, 200, 15, device="cpu")
    chip_smoke.check_costs_only("lti", 200, 15, A=3, device="cpu")
    assert fs.launch_counts() == ZERO_LAUNCHES
    sass = "\n".join([
        "Function : k",
        "/*0000*/ MOV R1, c[0x0][0x28] ;",
        "/*0010*/ IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ ;",   # loop head, Philox round
        "/*0020*/ @!P0 BRA 0x60 ;",                           # skips the slow path
        "/*0030*/ IMAD.WIDE.U32 R4, R5, R6, RZ ;",
        "/*0040*/ @P1 BRA 0x30 ;",                            # slow path's own loop
        "/*0050*/ NOP ;",
        "/*0060*/ FADD R7, R7, R8 ;",
        "/*0070*/ @P2 BRA 0x10 ;",                            # back to the loop head
        "/*0080*/ EXIT ;",
    ])
    assert chip_smoke.philox_loop_steps(chip_smoke.sass_functions(sass)["k"]) == [4.0]


def test_chip_smoke_solve_bound_counts_one_noise_draw():
    """K1's bound counts the costs-only pass (K4's loop) plus the ΔU
    reduction, 11·A instructions per step, and not K1's second noise draw;
    K4's is its loop alone. Checked on made-up per-step counts, with the
    clock set so that one instruction per lane is one millisecond."""
    import chip_smoke

    A, K, T = 3, 1000, 20
    fam = fs.lti_family(torch.ones(A), torch.ones(A), torch.ones(2 * A), 0.1, 1.0)
    steps = {"rollout_costs<lti,A=3,inj=0>": [100.0], "solve_partials<lti,A=3,inj=0>": [101.0, 90.0]}
    lanes = chip_smoke.H100_SMS * chip_smoke.H100_LANES
    clock_mhz = 1e-3 / lanes  # instructions / (lanes · clock) in s = instructions ms
    k1, by = chip_smoke.solve_bound(steps, fam, K, T, clock_mhz)
    assert by == "operations" and k1 == pytest.approx((100 + 11 * A) * T * K)
    k4, _ = chip_smoke.solve_bound(steps, fam, K, T, clock_mhz, pass2=False)
    assert k4 == pytest.approx(100 * T * K)
    k1_fleet, _ = chip_smoke.solve_bound(steps, fam, K, T, clock_mhz, R=8)
    assert k1_fleet == pytest.approx(8 * k1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_gpu_coupled_family(cuda, name):
    import chip_smoke

    chip_smoke.check_family_injected(name, 1000, 40, device=cuda)
    chip_smoke.check_family_philox(name, 1000, 40, antithetic=True, ou_beta=0.8, device=cuda)
    chip_smoke.check_family_fleet(name, 4, 1000, 40, device=cuda)
    chip_smoke.check_coupled_diverged(name, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("lti", "pendulum", "cartpole") + FAMILIES)
def test_gpu_costs_only(cuda, name):
    import chip_smoke

    chip_smoke.check_costs_only(name, 1000, 40, A=3 if name == "lti" else None, device=cuda)
