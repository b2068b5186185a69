"""The port's last two fused families, the point mass with the obstacle cost
(lti-obstacle) and the 3-D quadrotor (A=4, 13 states), against the JAX
package: the models and costs, the parameter carry-over, config dispatch,
the eager solve, the fused solve's and the costs-only sweep's plain versions
against the JAX Pallas kernels run as tests/test_pallas.py runs them
(testmode pseudo-noise, interpret mode, row-packed and state-planar), fleets
with per-robot goals, the 3-D quadrotor's world, closed loops on the same ε,
and the controller's pack following a reassigned cost. Inputs are made from
numpy seeds; each tolerance is stated where it is used. Tests marked `gpu`
run K1's new instances through chip_smoke's checks and skip without a CUDA
device.

The obstacle indicator is a step function: a position within an ulp of a
sphere's surface could count as inside in one package and outside in the
other, and move S by the penalty. Every comparison against JAX here first
states that no visited position lies that close (:func:`_clear_of_surfaces`).
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
from mppi_gpu_tpu.envs import quadrotor3d_world as jw  # noqa: E402
from mppi_gpu_tpu.models import PointMassLTI as JaxPointMass  # noqa: E402
from mppi_gpu_tpu.models import Quadrotor3DDynamics as JaxQuadrotor3D  # noqa: E402
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
from mppi_gpu_tpu_torch.envs import quadrotor3d_world as tw  # noqa: E402
from mppi_gpu_tpu_torch.models import dynamics_for_config  # noqa: E402
from mppi_gpu_tpu_torch.ops import families  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops.cost import (  # noqa: E402
    ObstacleCost,
    QuadraticCost,
    goal_of,
    make_cost,
    with_goal,
)
from mppi_gpu_tpu_torch.ops.rollout import rollout_trajectories  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("lti-obstacle", "quadrotor3d")
GOAL_COST = ("w", "goal", "lambda_", "inv_s")
# examples/obstacle_nav.py's obstacles and config edits on point_mass2d
OBSTACLES = ((0.45, 0.12, 0.18), (0.75, -0.18, 0.15))
OBSTACLE_EDITS = dict(cost_type="obstacle", obstacles=OBSTACLES, obstacle_w=800.0, noise_beta=0.5)
# tests/test_pallas.py's tolerances for the kernels against the scan path:
# S at rtol 3e-5 (lti-obstacle, :830) and 5e-5 (quadrotor3d, :570), ΔU at
# rtol 2e-4, atol 1e-6
S_TOL = {"lti-obstacle": dict(rtol=3e-5), "quadrotor3d": dict(rtol=5e-5)}
DU_TOL = dict(rtol=2e-4, atol=1e-6)
ZERO_LAUNCHES = {"solve_partials": 0, "softmin_combine": 0, "noise_dump": 0, "rollout_costs": 0,
                 "weighted_update": 0}


def _cfg_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def _obstacle_cfgs():
    """The obstacle config of examples/obstacle_nav.py in both packages."""
    edits = OBSTACLE_EDITS
    return (load_config(_cfg_path("point_mass2d")).replace(**edits),
            load_jax_config(_cfg_path("point_mass2d")).replace(**edits))


def _setup(name: str, A: int = 2, T: int = 12):
    """The JAX model and cost (tests/test_pallas.py::_setup_obstacle's layout,
    M = 3 obstacles of which the first sits just ahead of the start, and
    ::_setup_quadrotor3d), the port's carried across as numpy, a start, a
    live nominal sequence (T, A) and σ."""
    t = np.arange(T, dtype=np.float32)
    if name == "lti-obstacle":
        jdyn = JaxPointMass.create(0.1, A)
        base = jc.QuadraticCost(
            w=jnp.asarray([1.0] * A + [5.0] * A), goal=jnp.asarray([1.0, 0.5, 0.75][:A] + [0.0] * A),
            lambda_=jnp.float32(1.0), inv_s=jnp.ones(A))
        x0 = np.float32([0.05, -0.1, 0.02][:A] + [0.1, 0.0, -0.1][:A])
        centers = np.linspace(-0.5, 0.8, 3 * A, dtype=np.float32).reshape(3, A)
        centers[0] = x0[:A] + 0.05
        jcost = jc.ObstacleCost(base=base, centers=jnp.asarray(centers),
                                radii=jnp.asarray([0.15, 0.275, 0.4]), penalty=jnp.float32(50.0))
        U = (0.3 * np.sin(0.2 * t[:, None] + np.arange(A))).astype(np.float32)
        sigma = np.full(A, 0.6, np.float32)  # wide, so that rollouts cross the obstacles
        dyn = {"dt": np.asarray(jdyn.dt), "action_dim": A}
        cost = {"base": {k: np.asarray(getattr(base, k)) for k in GOAL_COST},
                **{k: np.asarray(getattr(jcost, k)) for k in ("centers", "radii", "penalty")}}
    else:
        jdyn = JaxQuadrotor3D.create(0.02, mass=0.75, inertia=(0.004, 0.005, 0.008), gravity=9.81)
        goal = np.zeros(13, np.float32)
        goal[:3] = (0.8, -0.3, 0.5)
        goal[7:10] = (0.1, 0.0, -0.05)
        jcost = jc.Quadrotor3DHoverCost(
            w=jnp.asarray([3.0, 3.0, 5.0, 8.0, 0.4, 0.4, 0.6, 0.2]), goal=jnp.asarray(goal),
            lambda_=jnp.float32(0.3), inv_s=jnp.asarray([1.0, 4.0, 4.0, 9.0]))
        q0 = np.float32([0.97, 0.12, -0.08, 0.18])
        q0 /= np.linalg.norm(q0)
        x0 = np.concatenate([[-0.5, 0.2, 0.1], q0, [0.2, -0.1, 0.3], [0.4, -0.2, 0.1]]).astype(np.float32)
        U = np.stack([0.75 * 9.81 + 0.5 * np.sin(0.3 * t), 0.05 * np.cos(0.4 * t),
                      0.05 * np.sin(0.5 * t), 0.01 * np.cos(0.7 * t)], 1).astype(np.float32)
        sigma = np.float32([1.0, 0.05, 0.05, 0.01])
        dyn = {k: np.asarray(getattr(jdyn, k)) for k in ("dt", "mass", "inertia", "gravity")}
        cost = {k: np.asarray(getattr(jcost, k)) for k in GOAL_COST}
    tdyn, tcost = from_numpy_params(dyn, cost, "cpu")
    return (jdyn, jcost), (tdyn, tcost), (dyn, cost), x0, U, sigma


def _clear_of_surfaces(tdyn, tcost, x0, U, eps) -> float:
    """The least |d² − r²| / r² over every position the rollouts of (x0, U,
    ε) visit and every obstacle, asserted ≥ 1e-4: no visited position lies
    near enough a surface for float32 rounding to flip its indicator between
    the packages. Returns it."""
    _, xs = rollout_trajectories(tdyn, tcost, torch.as_tensor(x0), torch.as_tensor(U),
                                 torch.as_tensor(np.array(eps)))
    q = xs[..., :tcost.centers.shape[1]].double()
    d2 = ((q[..., None, :] - tcost.centers.double()) ** 2).sum(-1)
    r2 = tcost.radii.double() ** 2
    margin = float(((d2 - r2).abs() / r2).min())
    assert margin >= 1e-4, f"a visited position lies within {margin:.2e}·r² of a surface"
    return margin


# ---------------------------------------------------------------------------
# (a) models, costs and the carry-over


def test_quadrotor3d_model_matches_jax():
    """Random states (quaternions of any norm) and actions through step and
    derivs of both packages: rtol 3e-6, atol 2e-6 (a few float32 ops;
    XLA's rsqrt and torch's CPU 1/sqrt apart by an ulp). A unit quaternion
    stays unit to 1e-6."""
    (jdyn, _), (tdyn, _), *_ = _setup("quadrotor3d")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 13)).astype(np.float32)
    u = (rng.standard_normal((256, 4)) * [3.0, 0.1, 0.1, 0.02] + [7.0, 0, 0, 0]).astype(np.float32)
    tol = dict(rtol=3e-6, atol=2e-6)
    assert (tdyn.state_dim, tdyn.action_dim) == (13, 4)
    tx, jx = from_numpy(x, "cpu"), jnp.asarray(x)
    np.testing.assert_allclose(tdyn.step(tx, from_numpy(u, "cpu")).numpy(),
                               np.asarray(jdyn.step(jx, jnp.asarray(u))), **tol)
    for got, want in zip(tdyn.derivs(tx[:, 3:7], tx[:, 7:10], tx[:, 10:13], from_numpy(u, "cpu")),
                         jdyn.derivs(jx[:, 3:7], jx[:, 7:10], jx[:, 10:13], jnp.asarray(u))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    x1 = tdyn.step(tx, from_numpy(u, "cpu"))
    np.testing.assert_allclose((x1[:, 3:7] ** 2).sum(1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", FAMILIES)
def test_cost_matches_jax(name):
    """Random states, actions and noise through cost.step and cost.final of
    both packages at rtol 3e-6, atol 2e-6. The obstacle cost's positions are
    drawn about the obstacles, clear of their surfaces by 1e-3·r² at least,
    so that both packages count the same obstacles, and some inside: the
    penalty fires."""
    (_, jcost), (tdyn, tcost), *_ = _setup(name)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((512, tdyn.state_dim)) * 0.5).astype(np.float32)
    if name == "lti-obstacle":
        c, r2 = np.asarray(tcost.centers), np.asarray(tcost.radii) ** 2
        d2 = ((x[:, None, :2] - c) ** 2).sum(-1)
        x = x[(np.abs(d2 - r2) / r2 > 1e-3).all(1)]
        assert (d2 < r2).any()
    u = rng.standard_normal(tdyn.action_dim).astype(np.float32)
    eps = rng.standard_normal((len(x), tdyn.action_dim)).astype(np.float32)
    tol = dict(rtol=3e-6, atol=2e-6)
    tx, jx = from_numpy(x, "cpu"), jnp.asarray(x)
    got = tcost.step(tx, from_numpy(u, "cpu"), from_numpy(eps, "cpu")).numpy()
    np.testing.assert_allclose(got, np.asarray(jcost.step(jx, jnp.asarray(u), jnp.asarray(eps))), **tol)
    np.testing.assert_allclose(tcost.final(tx).numpy(), np.asarray(jcost.final(jx)), **tol)
    if name == "lti-obstacle":
        fired = tcost.final(tx) - tcost.base.final(tx)
        assert set(np.unique(fired.numpy()).tolist()) >= {0.0, 50.0}
        assert tcost.lambda_ is tcost.base.lambda_ and tcost.inv_s is tcost.base.inv_s


@pytest.mark.parametrize("name", FAMILIES)
def test_from_numpy_params_round_trips(name):
    """Every field of the JAX model and cost (the obstacle cost's nested base
    included) arrives as an equal float32 tensor; goals= swaps in per-robot
    goals, onto the obstacle cost's base."""
    (jdyn, jcost), (tdyn, tcost), (dyn, cost), *_ = _setup(name)
    pairs = [(tcost, jcost)] + ([(tcost.base, jcost.base)] if name == "lti-obstacle" else [])
    for obj, jobj in [(tdyn, jdyn)] + pairs:
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                want = np.asarray(getattr(jobj, f.name), np.float32)
                assert v.dtype == torch.float32 and np.array_equal(v.numpy(), want), f.name
    goals = np.arange(2 * tdyn.state_dim, dtype=np.float32).reshape(2, -1)
    _, fleet_cost = from_numpy_params(dyn, cost, "cpu", goals=goals)
    assert np.array_equal(goal_of(fleet_cost).numpy(), goals)
    assert type(fleet_cost) is type(tcost)


# ---------------------------------------------------------------------------
# (b) config dispatch, the pack and the goal accessors


def test_quadrotor3d_config_builds_the_family_in_both_packages():
    """configs/quadrotor3d.yaml builds the matching model, cost and world
    (parameters equal field by field) in both packages; "quadrotor3d" is
    matched before "quadrotor"; the pair is the fused family; `auto` is eager
    on the CPU and fused on a CUDA device; a cost.w of the wrong length
    raises with the JAX package's message."""
    tcfg, jcfg = load_config(_cfg_path("quadrotor3d")), load_jax_config(_cfg_path("quadrotor3d"))
    ctrl = MPPIController(tcfg, device="cpu")
    jdyn, jcost = jax_dynamics_for_config(jcfg), jc.make_cost(jcfg)
    assert type(ctrl.dynamics).__name__ == type(jdyn).__name__ == "Quadrotor3DDynamics"
    assert type(ctrl.cost).__name__ == type(jcost).__name__ == "Quadrotor3DHoverCost"
    for obj, jobj in ((ctrl.dynamics, jdyn), (ctrl.cost, jcost)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            assert np.array_equal(v.numpy() if isinstance(v, torch.Tensor) else v,
                                  np.asarray(getattr(jobj, f.name))), f.name
    fam = ctrl._family
    assert ctrl.rollout_backend == "eager" and fam.name == "quadrotor3d" and fam.has_goal
    assert fam.fid == 7 and fam.params.shape == (fam.n_params,) == (24,)
    assert resolve_backend("auto", torch.device("cuda"), ctrl.dynamics, ctrl.cost) == "fused"
    with pytest.raises(ValueError, match=r"quadrotor3d cost needs cost.w = \[w_px, w_py"):
        make_cost(tcfg.replace(cost_w=(1.0,) * 6), "cpu")
    tparams, jparams = params_for_config(tcfg), make_jax_world(jcfg).params
    for f in dataclasses.fields(tparams):
        assert getattr(tparams, f.name) == getattr(jparams, f.name), f.name
    assert tparams.max_thrust == 8.0
    assert type(make_world(tcfg)).__name__ == type(make_jax_world(jcfg)).__name__
    planar = load_config(_cfg_path("quadrotor"))
    assert type(dynamics_for_config(planar, "cpu")).__name__ == "QuadrotorDynamics"


def test_obstacle_config_builds_the_family():
    """The obstacle config as examples/obstacle_nav.py and bench.py build it:
    the cost equals the JAX one field by field (base included), the pair is
    the lti-obstacle family at A = 2 and A = 3, the world is the point
    mass's; a config without obstacles, or with obstacles of the wrong
    width, raises with the JAX package's messages."""
    tcfg, jcfg = _obstacle_cfgs()
    tcost, jcost = make_cost(tcfg, "cpu"), jc.make_cost(jcfg)
    assert isinstance(tcost, ObstacleCost) and isinstance(tcost.base, QuadraticCost)
    for obj, jobj in ((tcost, jcost), (tcost.base, jcost.base)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                assert np.array_equal(v.numpy(), np.asarray(getattr(jobj, f.name))), f.name
    ctrl = MPPIController(tcfg, device="cpu")
    assert ctrl._family.name == "lti-obstacle" and ctrl._family.fid == 6
    assert ctrl._family.n_params == 4 * 2 + 2 + 2 * 3 == ctrl._family.params.numel()
    assert type(make_world(tcfg)).__name__ == "PointMassWorld"
    cfg3 = load_config(_cfg_path("point_mass3d")).replace(
        cost_type="obstacle", obstacles=((0.5, 0.25, 0.4, 0.26), (0.2, 0.4, 0.1, 0.21)))
    assert families.family_name(dynamics_for_config(cfg3, "cpu"), make_cost(cfg3, "cpu")) == "lti-obstacle"
    with pytest.raises(ValueError, match="needs cost.obstacles"):
        make_cost(tcfg.replace(obstacles=()), "cpu")
    with pytest.raises(ValueError, match="each obstacle needs 2 center coords"):
        make_cost(tcfg.replace(obstacles=((0.1, 0.2, 0.3, 0.4),)), "cpu")


def test_pack_goal_accessors_and_mismatched_pairs():
    """The packs: lti-obstacle [σ, Σ⁻¹, w, penalty, M, centres, r²] with r²
    the eager cost's float32 radii², quadrotor3d [σ, Σ⁻¹, w, m, Jx, Jy, Jz,
    Jz − Jy, Jx − Jz, Jy − Jx, g]. goal_of / with_goal reach the obstacle
    cost's goal through its base. Not fusable: an obstacle cost on a base
    that is not the quadratic cost or with centres of another width, and
    mixed pairs. FAMILY_NAMES holds all eight JAX family names."""
    _, (odyn, ocost), *_ = _setup("lti-obstacle")
    _, (qdyn, qcost), *_ = _setup("quadrotor3d")
    sig2, sig4 = torch.tensor([0.6, 0.6]), torch.tensor([1.0, 0.05, 0.05, 0.01])
    fam = families.family_for(odyn, ocost, sig2)
    want = [sig2, ocost.inv_s, ocost.base.w, ocost.penalty, torch.tensor(3.0), ocost.centers,
            ocost.radii * ocost.radii]
    assert torch.equal(fam.params, torch.cat([t.reshape(-1) for t in want]))
    assert fam.state_dim == 4 and fam.n_params == fam.params.numel() == 4 * 2 + 2 + 3 * 3
    fam = families.family_for(qdyn, qcost, sig4)
    J = qdyn.inertia
    want = [sig4, qcost.inv_s, qcost.w, qdyn.mass, J, J[2] - J[1], J[0] - J[2], J[1] - J[0],
            qdyn.gravity]
    assert torch.equal(fam.params, torch.cat([t.reshape(-1) for t in want]))
    assert fam.state_dim == 13 and fam.n_params == 24
    g = torch.arange(4.0)
    assert goal_of(ocost) is ocost.base.goal and torch.equal(goal_of(with_goal(ocost, g)), g)
    assert with_goal(ocost, g).centers is ocost.centers
    with pytest.raises(TypeError, match="'goal' field"):
        with_goal(_pendulum()[1], g)
    not_quadratic = dataclasses.replace(ocost, base=dataclasses.replace(qcost, goal=g))
    wide = dataclasses.replace(ocost, centers=torch.zeros(3, 3))
    for dyn, cost in ((odyn, not_quadratic), (odyn, wide), (qdyn, ocost), (odyn, qcost),
                      (qdyn, ocost.base)):
        assert not families.is_fusable(dyn, cost)
        with pytest.raises(TypeError, match="fused solve covers"):
            families.family_for(dyn, cost, sig2)
    assert set(families.FAMILY_NAMES) == set(pr.FAMILIES)


def _pendulum():
    cfg = load_config(_cfg_path("pendulum"))
    return dynamics_for_config(cfg, "cpu"), make_cost(cfg, "cpu")


# ---------------------------------------------------------------------------
# (c) the eager solve and the fused solve's plain version


@pytest.mark.parametrize("name", FAMILIES)
def test_deterministic_solve_matches_jax_scan(name):
    """mppi_solve_deterministic of both packages on the same ε at K=300 (the
    obstacles' surfaces clear of every visited position): S at the
    kernels' rtol, the update and the action at 1e-4 / 1e-6."""
    (jdyn, jcost), (tdyn, tcost), _, x0, U, sigma = _setup(name)
    K, T, A = 300, U.shape[0], U.shape[1]
    # seed 4: its rollouts stay clear of the surfaces (seed 1's do not)
    eps = (sigma * np.random.default_rng(4).standard_normal((T, K, A))).astype(np.float32)
    if name == "lti-obstacle":
        _clear_of_surfaces(tdyn, tcost, x0, U, eps)
    max_a = np.float32([16.0, 3.0, 3.0, 1.0][:A])
    rj = jax_solve_det(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps),
                       jnp.float32(0.7), jnp.asarray(max_a))
    rt = mppi_solve_deterministic(tdyn, tcost, torch.as_tensor(x0), torch.as_tensor(U),
                                  torch.as_tensor(eps), 0.7, torch.as_tensor(max_a))
    np.testing.assert_allclose(rt.info.costs.numpy(), np.asarray(rj.info.costs), **S_TOL[name])
    np.testing.assert_allclose(rt.info.u_seq.numpy(), np.asarray(rj.info.u_seq), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.action.numpy(), np.asarray(rj.action), rtol=1e-4, atol=1e-6)


# (family, A, layout, ou, antithetic): the obstacle at A = 2 takes the TPU's
# row-packed plan, at A = 3 the state-planar one (tests/test_pallas.py:852);
# the 3-D quadrotor's solve is always planar, its kernel #6 row-packed
# (tests/test_pallas.py:556-605)
KERNEL_CASES = [
    ("lti-obstacle", 2, "rows", 0.0, False), ("lti-obstacle", 3, "planar", 0.0, False),
    ("quadrotor3d", 4, "planar", 0.0, False), ("quadrotor3d", 4, "planar", 0.5, True),
]


def _pallas(name, A, layout, ou, anti, K=300, T=10):
    """TPU kernel #1 (`_onepass_solve_kernel`, row-packed) or #2
    (`_planar_onepass_kernel`) on the family in interpret mode, the testmode
    ε it consumed (fake_noise_tensor / planar_fake_noise_tensor), and the
    port's family on the same inputs."""
    (jdyn, jcost), (tdyn, tcost), _, x0, U, sigma = _setup(name, A, T)
    key, lam = jax.random.key(13), 0.9
    M = int(jcost.centers.shape[0]) if name == "lti-obstacle" else 0
    plan = pr.make_plan(K, T, A, antithetic=anti, ou_beta=ou, testmode=True, family=name, extra=M)
    assert plan.planar == (layout == "planar")
    noise = pr.planar_fake_noise_tensor if plan.planar else pr.fake_noise_tensor
    eps = np.ascontiguousarray(np.array(noise(plan, jnp.asarray(sigma), ou_beta=ou, key=key))[:, :K])
    args = (jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), key, jnp.asarray(sigma))
    S_j, dU_j = pr.pallas_fused_solve_core(*args, jnp.float32(lam), K=K, antithetic=anti,
                                           ou_beta=ou, testmode=True, interpret=True)
    fam = families.family_for(tdyn, tcost, torch.as_tensor(sigma))
    inputs = (fam, torch.as_tensor(x0), torch.as_tensor(U), goal_of(tcost))
    if name == "lti-obstacle":
        _clear_of_surfaces(tdyn, tcost, x0, U, eps)
        S_base = rollout_trajectories(tdyn, tcost.base, *inputs[1:3], torch.as_tensor(eps))[0]
        S_pen = rollout_trajectories(tdyn, tcost, *inputs[1:3], torch.as_tensor(eps))[0]
        assert float((S_pen - S_base).max()) >= 50.0  # the penalty fires: not vacuous
    return args, (np.array(S_j)[:K], dU_j), fam, inputs, torch.as_tensor(eps), lam


@pytest.mark.parametrize("name,A,layout,ou,anti", KERNEL_CASES,
                         ids=[f"{c[0]}-A{c[1]}-{c[2]}-ou{c[3]}-anti{int(c[4])}" for c in KERNEL_CASES])
def test_plain_version_matches_pallas_kernel(name, A, layout, ou, anti):
    """The TPU one-pass kernel on the family: K1's plain version fed the
    kernel's own ε gives its S at the kernels' rtol, and its per-block
    partials folded by K2's plain version give the kernel's ΔU from the
    kernel's S at rtol 2e-4, atol 1e-6; nothing is launched on CPU
    tensors."""
    _, (S_j, dU_j), fam, inputs, eps, lam = _pallas(name, A, layout, ou, anti)
    K = eps.shape[1]
    S, beta, eta, dU = fs.family_fused_solve(*inputs, lam, K, 0, 0, 0, False, 0.0, eps=eps)
    np.testing.assert_allclose(S.numpy(), S_j, **S_TOL[name])
    np.testing.assert_allclose(float(beta), float(S_j.min()), **S_TOL[name])
    _, _, dU_on_S_j = fs.softmin_combine(fs.block_partials(torch.as_tensor(S_j), eps, lam), lam,
                                         *inputs[2].shape)
    np.testing.assert_allclose(dU_on_S_j.numpy(), np.asarray(dU_j), **DU_TOL)
    assert fs.launch_counts() == ZERO_LAUNCHES


@pytest.mark.parametrize("name,A,layout", [("lti-obstacle", 2, "rows"), ("lti-obstacle", 3, "planar"),
                                           ("quadrotor3d", 4, "rows"), ("quadrotor3d", 4, "planar")])
def test_costs_only_plain_version_matches_pallas_costs(name, A, layout):
    """TPU kernel #6 (`pallas_rollout_costs`, row-packed) or #8
    (`pallas_planar_rollout_costs`) on the family: the costs-only sweep's
    plain version on the same ε gives its S at the kernels' rtol and equals
    the plain K1's S bit for bit, in the fleet form too."""
    (jdyn, jcost), (tdyn, tcost), _, x0, U, sigma = _setup(name, A, 10)
    K, key = 300, jax.random.key(9)
    M = int(jcost.centers.shape[0]) if name == "lti-obstacle" else 0
    plan = pr.make_plan(K, 10, A, ou_beta=0.5, testmode=True, family=name, extra=M)
    args = (jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), key, jnp.asarray(sigma))
    if layout == "rows":
        S_j = pr.pallas_rollout_costs(*args, K=K, ou_beta=0.5, testmode=True, interpret=True)
        noise = pr.fake_noise_tensor
    else:
        assert plan.planar
        S_j = pr.pallas_planar_rollout_costs(*args, K=K, ou_beta=0.5, testmode=True, interpret=True)
        noise = pr.planar_fake_noise_tensor
    eps = np.ascontiguousarray(np.array(noise(plan, jnp.asarray(sigma), ou_beta=0.5, key=key))[:, :K])
    if name == "lti-obstacle":
        _clear_of_surfaces(tdyn, tcost, x0, U, eps)
    fam = families.family_for(tdyn, tcost, torch.as_tensor(sigma))
    inputs = (fam, torch.as_tensor(x0), torch.as_tensor(U), goal_of(tcost))
    eps = torch.as_tensor(eps)
    S = fs.fused_rollout_costs(*inputs, K, 0, 0, 0, False, 0.0, eps=eps)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j)[:K], **S_TOL[name])
    S1, _ = fs.family_solve_partials(*inputs, 0.9, K, 0, 0, 0, False, 0.0, eps=eps)
    assert torch.equal(S, S1)
    fam, x0, U, goal = inputs
    xs, Us, goals = x0.expand(2, -1), U.expand(2, -1, -1), goal.expand(2, -1)
    fleet = fs.fleet_rollout_costs(fam, xs.contiguous(), Us.contiguous(), goals.contiguous(), K,
                                   torch.tensor([3, 4]), 1, 0, True, 0.8)
    for r, seed in enumerate((3, 4)):
        assert torch.equal(fleet[r], fs.fused_rollout_costs(*inputs, K, seed, 1, 0, True, 0.8))
    assert fs.launch_counts() == ZERO_LAUNCHES


def test_quadrotor3d_collapsed_quaternion_diverges_and_guard_fires():
    """A zero quaternion stays zero (q̇ = ½ q ⊗ ω), so the renormalisation
    takes rsqrt(0) = inf and the state turns NaN: every rollout costs NaN on
    the eager path and in K1's plain version alike, β and the action are NaN
    and the guard fires; chip_smoke's check does the same on the card."""
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    cfg = load_config(_cfg_path("quadrotor3d")).replace(samples=256, horizon=10)
    ctrl = MPPIController(cfg, device="cpu")
    x0 = torch.zeros(13)
    U = ctrl.init_action_seq()
    eps = ctrl._eps(2, 0, 0)
    res = ctrl.solve_with_eps(x0, U, eps)
    S, beta, _, _ = fs.family_fused_solve(ctrl._family, x0, U, goal_of(ctrl.cost), cfg.lambda_, 256,
                                          0, 0, 0, False, 0.0, eps=eps)
    assert torch.isnan(S).all() and torch.isnan(res.info.costs).all()
    assert torch.isnan(beta) and torch.isnan(res.action).all()
    with pytest.raises(ControllerDiverged):
        check_solve(0, res.action.numpy(), res.info)


# ---------------------------------------------------------------------------
# (d) fleets, the stale pack


@pytest.mark.parametrize("name", FAMILIES)
def test_fleet_robots_with_goals_are_solo_solves(name):
    """A fleet of 3 robots with distinct goals (the obstacle cost's on its
    base): robot r's solve is the single-robot solve under its seed and goal,
    bit for bit, on the eager backend and through the fused solve's plain
    version; the per-robot costs broadcast over (R, K, s) states as robot by
    robot."""
    cfg = _obstacle_cfgs()[0] if name == "lti-obstacle" else load_config(_cfg_path(name))
    cfg = cfg.replace(samples=160, horizon=8)
    R, S = 3, cfg.state_dim
    rng = np.random.default_rng(2)
    goals = np.tile(np.float32(cfg.goal), (R, 1))
    goals[:, :2] += rng.uniform(-0.5, 0.5, (R, 2)).astype(np.float32)
    xs = np.zeros((R, S), np.float32)
    xs[:, :3] = rng.uniform(-0.3, 0.3, (R, 3))
    if name == "quadrotor3d":
        xs[:, 3] = 1.0  # level
    xs, goals = torch.as_tensor(xs), torch.as_tensor(goals)
    for backend in ("eager", "fused"):
        fleet = BatchedMPPIController(cfg, R, device="cpu", goals=goals)
        assert type(fleet.cost) is type(make_cost(cfg, "cpu")) and torch.equal(goal_of(fleet.cost), goals)
        fleet.rollout_backend = backend  # `fused` on CPU tensors runs the plain fleet
        Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
        res = fleet.solve_batch(xs, Us, seeds, 4)
        for r, seed in enumerate(seeds.tolist()):
            solo = MPPIController(cfg, device="cpu", cost=fleet._robot_cost(r))
            assert torch.equal(goal_of(solo.cost), goals[r])
            solo.rollout_backend = backend
            want = solo.solve(xs[r], Us[r], seed, 4)
            assert torch.equal(res.action[r], want.action), (backend, r)
            assert torch.equal(res.info.costs[r], want.info.costs), (backend, r)
    states = torch.as_tensor(rng.standard_normal((R, 5, S)).astype(np.float32))
    batched = fleet.cost.final(states)
    for r in range(R):
        assert torch.allclose(batched[r], fleet._robot_cost(r).final(states[r]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", FAMILIES)
def test_pack_follows_a_reassigned_cost(name):
    """The stale-pack repair: after ``ctrl.cost = dataclasses.replace(
    ctrl.cost, w=...)`` (the obstacle cost's weights on its base, and its
    penalty) the controller's pack equals a fresh family_for pack of the new
    cost, and the fused solve's plain version follows the new weights
    exactly as the eager solve does; a new goal alone keeps working; on the
    fused backend a cost the family cannot fuse raises."""
    cfg = (_obstacle_cfgs()[0] if name == "lti-obstacle" else load_config(_cfg_path(name)))
    cfg = cfg.replace(samples=200, horizon=8)
    ctrl = MPPIController(cfg, device="cpu")
    old = ctrl._family.params.clone()
    if name == "lti-obstacle":
        new = dataclasses.replace(ctrl.cost, base=dataclasses.replace(ctrl.cost.base, w=ctrl.cost.base.w * 3.0),
                                  penalty=ctrl.cost.penalty * 2.0)
    else:
        new = dataclasses.replace(ctrl.cost, w=torch.tensor([4.0, 4.0, 4.0, 10.0, 1.2, 1.2, 1.2, 0.5]))
    ctrl.cost = new
    fresh = families.family_for(ctrl.dynamics, new, ctrl.sigma)
    assert ctrl.cost is new and torch.equal(ctrl._family.params, fresh.params)
    assert not torch.equal(ctrl._family.params, old)
    x, U = torch.zeros(cfg.state_dim), ctrl.init_action_seq()
    if name == "quadrotor3d":
        x[3] = 1.0
    eps = ctrl._eps(1, 0, 0)
    eager = ctrl.solve_with_eps(x, U, eps)
    ctrl.rollout_backend = "fused"  # on CPU tensors: K1 + K2's plain versions
    fused = ctrl.solve_with_eps(x, U, eps)
    assert torch.equal(fused.info.costs, eager.info.costs)
    np.testing.assert_allclose(fused.action.numpy(), eager.action.numpy(), rtol=1e-5, atol=1e-6)
    goal = torch.full((cfg.state_dim,), 0.25)
    ctrl.cost = with_goal(ctrl.cost, goal)
    assert torch.equal(ctrl._family.params, fresh.params) and goal_of(ctrl.cost) is goal
    with pytest.raises(ValueError, match="fused backend covers"):
        ctrl.cost = _pendulum()[1]
    assert ctrl.cost.__class__ is new.__class__


@pytest.mark.parametrize("name", FAMILIES)
def test_goal_only_reassignment_keeps_the_pack(name, monkeypatch):
    """``ctrl.cost = with_goal(ctrl.cost, g)`` (the flight example's
    re-target every step; the obstacle cost's goal lives on its base) keeps
    the pack: no ``family_for`` call, so no read of dt and λ from the device.
    The fused path's inputs are then the kept pack and the new goal, and its
    plain version solves exactly as a fresh pack of the new cost does; a
    cost whose other fields are equal but not the same objects, or whose
    weights changed, is packed anew."""
    real, calls = families.family_for, []
    monkeypatch.setattr(families, "family_for", lambda *a: calls.append(a) or real(*a))
    cfg = (_obstacle_cfgs()[0] if name == "lti-obstacle" else load_config(_cfg_path(name)))
    cfg = cfg.replace(samples=200, horizon=8)
    ctrl = MPPIController(cfg, device="cpu")
    assert len(calls) == 1
    pack, old = ctrl._family.params, ctrl.cost
    goal = torch.full((cfg.state_dim,), 0.25)
    ctrl.cost = with_goal(ctrl.cost, goal)
    assert len(calls) == 1 and ctrl._family.params is pack and ctrl._family.cost is ctrl.cost
    assert goal_of(ctrl.cost) is goal and not torch.equal(goal_of(old), goal)
    fresh = real(ctrl.dynamics, ctrl.cost, ctrl.sigma)
    assert torch.equal(fresh.params, pack)
    x, U = torch.zeros(cfg.state_dim), ctrl.init_action_seq()
    if name == "quadrotor3d":
        x[3] = 1.0
    eps = ctrl._eps(3, 0, 0)
    ctrl.rollout_backend = "fused"  # on CPU tensors: K1 + K2's plain versions
    got = ctrl.solve_with_eps(x, U, eps)
    want = fs.family_fused_solve(fresh, x, U, goal, cfg.lambda_, 200, 0, 0, 0, False, 0.0, eps=eps)
    for a, b in zip((got.info.costs, got.info.beta, got.info.eta), want[:3]):
        assert torch.equal(a, b)
    ctrl.rollout_backend = "eager"
    assert torch.equal(ctrl.solve_with_eps(x, U, eps).info.costs, got.info.costs)
    twin = dataclasses.replace(ctrl.cost, **{
        f.name: (v.clone() if isinstance(v := getattr(ctrl.cost, f.name), torch.Tensor)
                 else dataclasses.replace(v))
        for f in dataclasses.fields(ctrl.cost) if f.name != "goal"})
    ctrl.cost = twin
    assert len(calls) == 2
    ctrl.cost = with_goal(twin, goal + 0.5)
    assert len(calls) == 2
    ctrl.cost = old
    assert len(calls) == 3 and torch.equal(ctrl._family.params, pack)


# ---------------------------------------------------------------------------
# (e) the 3-D quadrotor's world, the closed loops


def test_quadrotor3d_world_matches_jax_world():
    """The same actions, past the rotor envelope, through both worlds
    open-loop for 200 physics steps (50 control cycles): each cycle from the
    same state agrees to rtol 1e-6 / atol 2e-6, the open-loop trajectories
    to atol 2e-4, the clocks to rel 1e-5; both episodes end after
    num_control_steps() cycles. The mixer round trip inverts exactly
    (tests/test_quadrotor3d.py:46, rtol 1e-4 / atol 1e-5) and the rotor
    clamp redistributes an over-envelope yaw into collective (:108)."""
    cfg, jcfg = load_config(_cfg_path("quadrotor3d")), load_jax_config(_cfg_path("quadrotor3d"))
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    rng = np.random.default_rng(3)
    limit = np.float32(cfg.max_a)
    steps = 200 // tworld.params.steps_per_control
    for _ in range(steps):
        u = (np.float32(cfg.init_act) + rng.uniform(-0.4, 0.4, 4) * limit).astype(np.float32)
        one, _ = jsim(jworld.from_x(jnp.asarray(ts.x.numpy()), float(ts.time)), jnp.asarray(u))
        ts, tdone = tworld.simulate(ts, torch.as_tensor(u))
        js, jdone = jsim(js, jnp.asarray(u))
        assert tdone == bool(jdone) is False
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(one.x), rtol=1e-6, atol=2e-6)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=2e-4)
        assert float(ts.time) == pytest.approx(float(js.time), rel=1e-5)
    assert float(np.abs(ts.x.numpy()[3:7] - [1, 0, 0, 0]).max()) > 0.01  # it tumbled
    n_steps = tworld.params.num_control_steps()
    assert n_steps == jworld.params.num_control_steps()
    end = torch.tensor(tworld.params.timestep * (1 + tworld.params.steps_per_control * n_steps))
    assert tworld.simulate(tworld.from_x(ts.x, end), torch.zeros(4))[1] is True
    p = tworld.params
    u = from_numpy(rng.normal(size=(5, 4)), "cpu")
    back = tw.rotors_to_wrench(tw.mix_to_rotors(u, p.arm, p.kappa), p.arm, p.kappa)
    np.testing.assert_allclose(back.numpy(), u.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.mix_to_rotors(u, p.arm, p.kappa).numpy(),
                               np.asarray(jw.mix_to_rotors(jnp.asarray(u.numpy()), p.arm, p.kappa)),
                               rtol=1e-6, atol=1e-6)
    f = torch.clamp(tw.mix_to_rotors(torch.tensor([4.0, 0.0, 0.0, 0.5]), p.arm, p.kappa), 0.0,
                    p.max_thrust)
    achieved = tw.rotors_to_wrench(f, p.arm, p.kappa)
    assert float(achieved[0]) > 5.0 and float(achieved[3]) < 0.5
    s = tworld.reset()
    for _ in range(10):
        s = tworld.physics_step(s, torch.tensor([-10.0, 0.0, 0.0, 0.0]))
    assert float(s.v[2]) < 0.0 and torch.allclose(s.q, torch.tensor([1.0, 0, 0, 0]), atol=1e-6)
    for a, b in zip(tw.quat_to_body_axes(ts.x[3:7], 0.17), jw.quat_to_body_axes(np.asarray(js.q), 0.17)):
        np.testing.assert_allclose(a, b, atol=2e-4)


# closed loops on the same ε: (action atol in units of σ, state atol)
LOOP_TOL = {"lti-obstacle": (1e-3, 1e-5), "quadrotor3d": (5e-3, 5e-4)}


@pytest.mark.parametrize("name", FAMILIES)
def test_closed_loop_matches_jax_on_the_same_eps(name):
    """10 control steps at K=256, T=20 from the world's start: both
    controllers (the 3-D quadrotor with its two updates per step) fed the
    same numpy ε each update, each driving its own world. From the same state
    and sequence they agree to 1e-3·σ each update; the loops feed their
    differences back through the plants, held to LOOP_TOL (action in units
    of σ, state)."""
    K, T, steps = 256, 20, 10
    if name == "lti-obstacle":
        cfg, jcfg = (c.replace(samples=K, horizon=T) for c in _obstacle_cfgs())
    else:
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
            eps = (sigma * rng.standard_normal((T, K, cfg.action_dim))).astype(np.float32)
            if name == "lti-obstacle":
                _clear_of_surfaces(tctrl.dynamics, tctrl.cost, ts.x.numpy(), tU.numpy(), eps)
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
    assert float(np.abs(rt.action.numpy() - np.float32(cfg.init_act)).max()) > 0.01  # it acted


def test_cli_and_examples_run_on_the_cpu(capsys, tmp_path):
    """The CLI on configs/quadrotor3d.yaml (K cut to 128 in a copy) on the
    eager path; the two ported examples for a few steps on the CPU, the
    flight example drawing its figure where matplotlib is installed; without
    a card `--device cuda` exits 2 (no silent fallback)."""
    from mppi_gpu_tpu_torch import cli
    from mppi_gpu_tpu_torch.examples import obstacle_nav, quadrotor3d_flight

    text = open(_cfg_path("quadrotor3d")).read()
    assert "samples: 2048" in text
    cfg_path = tmp_path / "quadrotor3d.yaml"
    cfg_path.write_text(text.replace("samples: 2048", "samples: 128"))
    rc = cli.main(["-c", str(cfg_path), "--device", "cpu", "--max-steps", "2"])
    assert rc == 0 and "episode finished: 2 control steps" in capsys.readouterr().out
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        assert obstacle_nav.main(["--device", "cpu", "--steps", "3"]) == 1  # far from the goal yet
        out = capsys.readouterr().out
        assert "3 steps, eager backend on cpu" in out and "min clearance" in out
        png = tmp_path / "flight.png"
        quadrotor3d_flight.main(["--device", "cpu", "--steps", "2", "-o", str(png)])
        out = capsys.readouterr().out
        assert "2 steps, eager backend on cpu" in out and "waypoints visited: []" in out
        try:
            import matplotlib  # noqa: F401
            assert png.exists()
        except ImportError:
            assert "needs matplotlib" in capsys.readouterr().err
        if not torch.cuda.is_available():
            assert obstacle_nav.main(["--steps", "1"]) == 2
            assert quadrotor3d_flight.main(["--steps", "1"]) == 2
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# chip_smoke's checks: a rehearsal on the CPU, and on the card


def test_chip_smoke_checks_run_on_the_cpu():
    """chip_smoke.py's phase-16 and phase-15 checks on CPU tensors compare
    the plain versions with themselves and with the float64 plain version:
    a rehearsal of the script's logic that needs no card; the kernel names
    of the new instances parse from their mangled names."""
    import chip_smoke

    for name in chip_smoke.LAST:
        e = chip_smoke.check_family_injected(name, 200, 12, device="cpu")
        assert e["S_rel_max"] < 1e-5
        chip_smoke.check_family_philox(name, 200, 12, antithetic=True, ou_beta=0.5, device="cpu")
        chip_smoke.check_family_fleet(name, 3, 200, 12, device="cpu")
        assert "+inf" in chip_smoke.check_coupled_diverged(name, device="cpu")
        chip_smoke.check_costs_only(name, 200, 12, device="cpu")
    assert fs.launch_counts() == ZERO_LAUNCHES
    key = chip_smoke.kernel_key
    assert key("_ZN12_GLOBAL__N_121solve_partials_kernelINS_11LtiObstacleILi3EEELi3ELb0ELb1EEEvPKfS5_"
               ) == "solve_partials<lti-obstacle,A=3,inj=0>"
    assert key("_ZN12_GLOBAL__N_121solve_partials_kernelINS_11Quadrotor3DELi4ELb1ELb0EEEvPKfS4_"
               ) == "rollout_costs<quadrotor3d,A=4,inj=1>"
    assert key("_ZN12_GLOBAL__N_121solve_partials_kernelINS_3LtiILi2EEELi2ELb0ELb1EEEvPKf"
               ) == "solve_partials<lti,A=2,inj=0>"


def test_chip_smoke_obstacle_gate_and_bound():
    """The obstacle quality gate's one-sided Fisher exact test equals
    scipy's (to 1e-12) and sits where chip_smoke.py says, against the
    reference's 43 of 64: 29 of 64 pass, 28 fail. The bound's obstacle loop
    is read from a hand-made SASS listing: a Philox loop (one round constant)
    with an obstacle loop of 8 instructions and 2 compares nested in it, and
    a math slow path's loop (no compare) beside it, gives 4 per obstacle."""
    import chip_smoke
    from scipy.stats import fisher_exact

    for k in (8, 28, 29, 40, 64):
        want = fisher_exact([[k, 64 - k], [43, 21]], alternative="less").pvalue
        assert abs(chip_smoke.fisher_below(k, 64, 43, 64) - want) < 1e-12
    gate = chip_smoke.OBSTACLE_REF_CLEAR, chip_smoke.OBSTACLE_SEEDS
    assert chip_smoke.fisher_below(29, 64, *gate) > chip_smoke.OBSTACLE_ALPHA
    assert chip_smoke.fisher_below(28, 64, *gate) <= chip_smoke.OBSTACLE_ALPHA
    body = ["IMAD R1, R2, -0x2daee0ad, RZ", "FADD R3, R4, R5",
            "LDG.E R6, [R7]", "FADD R8, R6, R3", "FSETP.GEU.AND P1, PT, R8, R9, PT",
            "LDG.E R6, [R7+0x4]", "FADD R8, R6, R3", "@P1 FSETP.GEU.AND P2, PT, R8, R9, PT",
            "IADD3 R10, R10, 0x1, RZ", "@P0 BRA 0x20",
            "IMAD.WIDE R11, R12, R13", "@P3 BRA 0xa0", "NOP", "@!P2 BRA 0x0", "EXIT"]
    instrs = [(16 * i, ins) for i, ins in enumerate(body)]
    assert chip_smoke.obstacle_loop_step(instrs) == 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("obstacle2d", "obstacle3d", "quadrotor3d"))
def test_gpu_last_families(cuda, name):
    import chip_smoke

    chip_smoke.check_family_injected(name, 1000, 40, device=cuda)
    chip_smoke.check_family_philox(name, 1000, 40, antithetic=True, ou_beta=0.5, device=cuda)
    chip_smoke.check_family_fleet(name, 4, 1000, 40, device=cuda)
    chip_smoke.check_coupled_diverged(name, device=cuda)
    chip_smoke.check_costs_only(name, 1000, 40, device=cuda)


@pytest.mark.gpu
def test_gpu_reassigned_cost(cuda):
    import chip_smoke

    chip_smoke.check_reassigned_cost(device=cuda)
