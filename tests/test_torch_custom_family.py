"""A fused family registered from user code on the port: the kinematic
bicycle of ``mppi_gpu_tpu_torch/examples/custom_family.py`` against the JAX
package's ``examples/custom_family.py`` (loaded by path, as
tests/test_custom_family.py loads it): the registration protocol and its
errors, one case per JAX case; backend dispatch; the eager solve on injected
ε against the JAX ``mppi_solve_deterministic``; K1's plain version for the
family at both block widths against the eager solve; the pack and the goal
kept in it; the per-family library's generated source, its hash and a build
without ``nvcc``; the fleet; the example's closed loop. Inputs are made with
numpy from seeds; each tolerance is stated where it is used. Tests marked
`gpu` run chip_smoke's bicycle checks on the card and skip without one.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.controller import mppi_solve_deterministic as jax_solve_det  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import (  # noqa: E402
    MPPIController,
    mppi_solve_deterministic,
    resolve_backend,
)
from mppi_gpu_tpu_torch.examples import custom_family as ex  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, families  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops.cost import with_goal  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_example():
    """The JAX package's examples/custom_family.py, loaded by path (it
    registers its own bicycle with the JAX package); the JAX registry is
    left as it was found."""
    before = pr.FAMILIES.get("bicycle-demo")
    path = os.path.join(ROOT, "examples", "custom_family.py")
    spec = importlib.util.spec_from_file_location("jax_custom_family", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_custom_family"] = mod  # dataclasses resolve annotations through it
    spec.loader.exec_module(mod)
    yield mod
    if before is None:
        pr.unregister_family("bicycle-demo")
    else:
        pr.FAMILIES["bicycle-demo"] = before
    sys.modules.pop("jax_custom_family", None)


def _setup(jax_example, T=11, K=260, seed=0):
    """tests/test_custom_family.py::_setup's model, cost (v_ref 0.8, Σ⁻¹
    (1, 0.7)), start and sequence in both packages, σ, and ε (T, K, 2) from
    a numpy seed."""
    jdyn = jax_example.BicycleDynamics.create(0.05)
    jcost = jax_example.BicycleWaypointCost(
        w=jnp.asarray([2.0, 0.3]), goal=jnp.asarray([3.0, 1.5]), v_ref=jnp.float32(0.8),
        lambda_=jnp.float32(0.4), inv_s=jnp.asarray([1.0, 0.7]))
    f32 = dict(dtype=torch.float32)
    tdyn = ex.BicycleDynamics.create(0.05)
    tcost = ex.BicycleWaypointCost(
        w=torch.tensor([2.0, 0.3], **f32), goal=torch.tensor([3.0, 1.5], **f32),
        v_ref=torch.tensor(0.8, **f32), lambda_=torch.tensor(0.4, **f32),
        inv_s=torch.tensor([1.0, 0.7], **f32))
    x0 = np.float32([0.1, -0.2, 0.3, 0.5])
    t = np.arange(T, dtype=np.float32)
    U = np.stack([0.5 + 0.3 * np.sin(0.3 * t), 0.2 * np.cos(0.5 * t)], axis=1).astype(np.float32)
    sigma = np.float32([0.8, 0.5])
    eps = (np.random.default_rng(seed).standard_normal((T, K, 2)) * sigma).astype(np.float32)
    return (jdyn, jcost), (tdyn, tcost), x0, U, sigma, eps


# ---------------------------------------------------------------------------
# (a) registration, dispatch, the pack


def test_registration_validates_protocol():
    """tests/test_custom_family.py::test_registration_validates_protocol's
    cases: a class missing the protocol, one without its struct's name (the
    port's counterpart of a missing NP: the kernel cannot be instantiated),
    and a built-in name, on register and on unregister."""

    class MissingBits:
        name = "broken"

    with pytest.raises(TypeError, match="lacks required attribute"):
        families.register_family(MissingBits)

    class NoStruct:
        name = "broken"
        supports = staticmethod(lambda d, c: False)
        pack = staticmethod(lambda d, c: [])
        cuda_source = "struct Broken {};"

    with pytest.raises(TypeError, match="cuda_struct"):
        families.register_family(NoStruct)

    class StealsBuiltin(NoStruct):
        name = "lti"
        cuda_struct = "Broken"

    with pytest.raises(ValueError, match="built-in"):
        families.register_family(StealsBuiltin)
    with pytest.raises(ValueError, match="built-in"):
        families.unregister_family("lti")
    assert "broken" not in families.covered()


def test_reregistration_replaces_user_family():
    """The example module executed again (a new class object, the same
    name) replaces the family without an error."""
    path = os.path.join(ROOT, "mppi_gpu_tpu_torch", "examples", "custom_family.py")
    spec = importlib.util.spec_from_file_location("custom_family_again", path)
    again = importlib.util.module_from_spec(spec)
    sys.modules["custom_family_again"] = again
    try:
        spec.loader.exec_module(again)
        assert families._USER_FAMILIES["bicycle-demo"] is again.BicycleFamily
        assert again.BicycleFamily is not ex.BicycleFamily
    finally:
        families.register_family(ex.BicycleFamily)  # the imported module's, for the other tests
        sys.modules.pop("custom_family_again", None)
    assert families._USER_FAMILIES["bicycle-demo"] is ex.BicycleFamily


def test_dispatch_selects_registered_family(jax_example):
    """The registered pair is the family "bicycle-demo" (after the
    built-ins); ``auto`` resolves it to ``fused`` on a CUDA device and to
    ``eager`` on the CPU, as the JAX package's to pallas / scan; ``fused``
    on the CPU raises. Unregistered, the pair is not fusable."""
    _, (dyn, cost), *_ = _setup(jax_example)
    assert families.family_name(dyn, cost) == "bicycle-demo"
    assert "bicycle-demo (registered)" in families.covered()
    assert resolve_backend("auto", torch.device("cuda"), dyn, cost) == "fused"
    assert resolve_backend("auto", torch.device("cpu"), dyn, cost) == "eager"
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_backend("fused", torch.device("cpu"), dyn, cost)
    families.unregister_family("bicycle-demo")
    try:
        assert not families.is_fusable(dyn, cost)
        assert resolve_backend("auto", torch.device("cuda"), dyn, cost) == "eager"
    finally:
        families.register_family(ex.BicycleFamily)


def test_pack_keeps_the_goal_and_a_reaimed_cost_repacks(jax_example):
    """The pack: [σ, Σ⁻¹, w_pos, w_vel, gx, gy, v_ref, L, c], no FamilyId,
    no per-call goal (K1's plain version refuses one). The controller
    re-packs when the cost is only re-aimed (its goal is in the pack), where
    a built-in family with a per-call goal keeps its pack."""
    _, (dyn, cost), *_ = _setup(jax_example)
    sigma = torch.tensor([0.8, 0.5])
    fam = families.family_for(dyn, cost, sigma)
    assert (fam.fid, fam.user, fam.state_dim, fam.action_dim) == (None, ex.BicycleFamily, 4, 2)
    assert not fam.has_goal and fam.n_params == 11
    np.testing.assert_array_equal(
        fam.params.numpy(), np.float32([0.8, 0.5, 1.0, 0.7, 2.0, 0.3, 3.0, 1.5, 0.8, 0.5, 0.3]))
    x0, U = torch.zeros(4), torch.zeros(6, 2)
    with pytest.raises(TypeError, match="no goal"):
        fs.family_solve_partials(fam, x0, U, torch.zeros(4), 0.4, 64, 7, 0, 0, False, 0.0)
    ctrl, _ = ex.make_controller(64, horizon=6, device="cpu")
    old = ctrl._family
    ctrl.cost = with_goal(ctrl.cost, torch.tensor([-1.0, 2.0]))
    assert ctrl._family is not old
    np.testing.assert_array_equal(ctrl._family.params[6:8].numpy(), [-1.0, 2.0])
    quad = MPPIController(load_config(os.path.join(ROOT, "configs", "quadrotor.yaml")),
                          device="cpu")
    old = quad._family
    quad.cost = with_goal(quad.cost, torch.zeros(6))
    assert quad._family.params is old.params


def test_block_width_takes_the_least_crossover_for_a_user_family():
    """A user family's name is not in SLAB_MAX_ROLLOUTS: its blocks are the
    least crossover's, as for no family at all."""
    least = min(fs.SLAB_MAX_ROLLOUTS.values())
    for R, K in ((1, 1024), (1, least), (1, least + 1), (8, 3000)):
        assert fs.block_width(R, K, 40, 2, "bicycle-demo") == fs.block_width(R, K, 40, 2)


# ---------------------------------------------------------------------------
# (b) the solve against the JAX package, and K1's plain version


def test_eager_solve_matches_jax(jax_example):
    """The port's eager solve on injected ε against the JAX example's pair
    through the JAX ``mppi_solve_deterministic``: S within rtol 1e-5 (both
    sum in float32 in the same order; the trig of XLA and torch apart by an
    ulp), β, η within 1e-5 and 1e-4; the updated sequence, action and u_next
    within tests/test_unicycle.py's ΔU tolerance, rtol 2e-4 and atol 1e-6
    (the softmin at λ = 0.6 turns S's ulps into ~1e-5 of a weight)."""
    (jdyn, jcost), (tdyn, tcost), x0, U, sigma, eps = _setup(jax_example)
    max_a = np.float32([2.0, 0.6])
    want = jax_solve_det(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps),
                         jnp.float32(0.6), jnp.asarray(max_a))
    got = mppi_solve_deterministic(tdyn, tcost, torch.as_tensor(x0), torch.as_tensor(U),
                                   torch.as_tensor(eps), 0.6, torch.as_tensor(max_a))
    np.testing.assert_allclose(got.info.costs.numpy(), np.asarray(want.info.costs), rtol=1e-5)
    np.testing.assert_allclose(float(got.info.beta), float(want.info.beta), rtol=1e-5)
    np.testing.assert_allclose(float(got.info.eta), float(want.info.eta), rtol=1e-4)
    for a, b in ((got.info.u_seq, want.info.u_seq), (got.action, want.action),
                 (got.u_next, want.u_next)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("width", (fs.SLAB_WIDTH, fs.BLOCK))
def test_plain_k1_matches_the_eager_solve(jax_example, width):
    """K1's plain version for the family (the eager model and cost through
    ``block_partials`` at the width of either body) and K2's: S and β equal
    the eager solve's exactly (the same rollout), η and ΔU within float32
    rounding of their per-block sums (rtol 1e-5, ΔU atol 1e-6); its costs
    against the JAX example's rollout too (rtol 1e-5)."""
    (jdyn, jcost), (tdyn, tcost), x0, U, sigma, eps = _setup(jax_example)
    fam = families.family_for(tdyn, tcost, torch.as_tensor(sigma))
    args = (fam, torch.as_tensor(x0), torch.as_tensor(U), None, 0.6, eps.shape[1], 0, 0, 0,
            False, 0.0)
    S, beta, eta, dU = fs.family_fused_solve_reference(*args, eps=torch.as_tensor(eps),
                                                       width=width)
    ref = mppi_solve_deterministic(tdyn, tcost, torch.as_tensor(x0), torch.as_tensor(U),
                                   torch.as_tensor(eps), 0.6, torch.ones(2) * 1e9, clamp=False)
    assert torch.equal(S, ref.info.costs) and torch.equal(beta, ref.info.beta)
    np.testing.assert_allclose(float(eta), float(ref.info.eta), rtol=1e-5)
    np.testing.assert_allclose(dU.numpy(), (ref.info.u_seq - torch.as_tensor(U)).numpy(),
                               rtol=1e-5, atol=1e-6)
    from mppi_gpu_tpu.ops.rollout import rollout_costs as jax_rollout_costs

    want = jax_rollout_costs(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps))
    np.testing.assert_allclose(S.numpy(), np.asarray(want), rtol=1e-5)
    partials = fs.family_solve_partials(*args, eps=torch.as_tensor(eps))[1]  # the CPU wrapper
    assert partials.shape == (-(-eps.shape[1] // fs.block_width(1, eps.shape[1], 11, 2,
                                                                "bicycle-demo")), 2 + 11 * 2)


def test_philox_solve_replays_through_the_dump():
    """On the CPU the wrappers run the plain versions: the Philox-mode solve
    of the family equals the injected-ε solve of ``noise_dump``'s stream bit
    for bit (iid, antithetic, OU), and K4's plain S is K1's."""
    p = ex.bicycle_config(128, 9)
    dyn, cost = ex.bicycle_pair(p)
    fam = families.family_for(dyn, cost, torch.tensor(p.noise))
    x0, U = torch.tensor([0.1, -0.2, 0.3, 0.5]), torch.full((9, 2), 0.2)
    for anti, ou in ((False, 0.0), (True, 0.0), (False, 0.5)):
        args = (fam, x0, U, None, 0.4, 128, 7, 3, 1, anti, ou)
        live = fs.family_fused_solve(*args)
        eps = fs.noise_dump(fam.sigma, 9, 128, 7, 3, 1, anti, ou)
        for a, b in zip(live, fs.family_fused_solve(*args, eps=eps)):
            assert torch.equal(a, b)
        assert torch.equal(fs.fused_rollout_costs(fam, x0, U, None, 128, 7, 3, 1, anti, ou),
                           live[0])


# ---------------------------------------------------------------------------
# (c) the family's library: source, hash, build


def test_family_source_and_hash():
    """The generated unit includes the header, holds the struct and the C
    entries at the given A; the library's name changes with the struct's
    source, its name, A and the header, and with nothing else."""
    src, name = ex.BicycleFamily.cuda_source, ex.BicycleFamily.cuda_struct
    unit = _build.family_source(src, name, 2)
    assert unit.index('#include "mppi_solve.cuh"') < unit.index("struct Bicycle")
    for piece in ("int mppi_family_solve_partials(", "launch_mode<Bicycle, 2, true>",
                  "launch_mode<Bicycle, 2, false>", "return Bicycle::kS;",
                  "A != 2 ||"):
        assert piece in unit
    path = _build.family_library_path(src, name, 2)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libfamily_")
    assert path == _build.family_library_path(src, name, 2)
    others = {_build.family_library_path(src + "\n// edited", name, 2),
              _build.family_library_path(src.replace("Bicycle", "Bike"), "Bike", 2),
              _build.family_library_path(src, name, 3)}
    assert path not in others and len(others) == 3
    with pytest.raises(ValueError, match="identifier"):
        _build.family_source(src, "not a name", 2)


def test_headers_enter_both_hashes(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` renames the built-in library and every
    family library, so no stale build is reused."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    lib = _build.library_path()
    fam = _build.family_library_path("struct X;", "X", 1)
    (src / "mppi_solve.cuh").write_text((src / "mppi_solve.cuh").read_text() + "\n// edited\n")
    assert _build.library_path() != lib
    assert _build.family_library_path("struct X;", "X", 1) != fam


def test_build_without_nvcc_raises_and_builds_nothing(tmp_path, monkeypatch):
    """Without ``nvcc`` a family's library does not build: the build raises,
    nothing is written, nothing is loaded (there is no fallback)."""
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the toolkit is installed at /usr/local/cuda")
    loaded = dict(_build._FAMILY_LIBRARIES)
    src, name = ex.BicycleFamily.cuda_source, ex.BicycleFamily.cuda_struct
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_family_library(src, name, 2)
    assert not (tmp_path / "build").exists() and _build._FAMILY_LIBRARIES == loaded


def test_a_struct_that_disagrees_with_its_model_raises(jax_example, monkeypatch):
    """Device-free: a library whose struct's kS or kGoal is not the family's
    state dimension or ``has_goal`` is refused before any launch."""
    _, (dyn, cost), *_ = _setup(jax_example)
    fam = families.family_for(dyn, cost, torch.tensor([0.8, 0.5]))
    lib = types.SimpleNamespace(family_struct=(4, False))
    monkeypatch.setattr(_build, "load_family_library", lambda *a: lib)
    assert fs._family_library(fam) is lib
    for info in ((5, False), (4, True)):
        lib.family_struct = info
        with pytest.raises(ValueError, match="kS="):
            fs._family_library(fam)


# ---------------------------------------------------------------------------
# (d) the fleet and the closed loop


def test_fleet_shares_the_packed_goal():
    """A bicycle fleet on the CPU: no per-robot goals (the goal is in the
    pack, ``goals=`` raises), robot r's solve its single-robot solve under
    its seed, bit for bit; the plain fleet K1 equals robot-by-robot plain
    K1."""
    cfg = ex.bicycle_config(64, 6)
    dyn, cost = ex.bicycle_pair(cfg)
    with pytest.raises(TypeError, match="in its pack"):
        BatchedMPPIController(cfg, 3, device="cpu", dynamics=dyn, cost=cost,
                              goals=torch.zeros(3, 4))
    fleet = BatchedMPPIController(cfg, 3, device="cpu", dynamics=dyn, cost=cost)
    assert fleet.cost is cost
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.uniform(-0.3, 0.3, (3, 4)).astype(np.float32))
    Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
    res = fleet.solve_batch(xs, Us, seeds, 2)
    ctrl, _ = ex.make_controller(64, horizon=6, device="cpu")
    for r, seed in enumerate(seeds.tolist()):
        solo = ctrl.solve(xs[r], Us[r], seed, 2)
        assert torch.equal(res.action[r], solo.action)
        assert torch.equal(res.info.costs[r], solo.info.costs)
    fam = fleet._family
    S, part = fs.fleet_family_solve_partials(fam, xs, Us, None, 0.4, 64, seeds, 2, 0, False, 0.0)
    for r, seed in enumerate(seeds.tolist()):
        S_r, part_r = fs.family_solve_partials(fam, xs[r], Us[r], None, 0.4, 64, seed, 2, 0,
                                               False, 0.0)
        assert torch.equal(S[r], S_r) and torch.equal(part[r], part_r)


def test_example_reaches_the_waypoint_on_the_cpu(capsys):
    """The example's closed loop on the eager backend at the JAX smoke
    test's size (512 samples, 90 steps): it reaches the waypoint."""
    rc = ex.main(["--steps", "90", "--samples", "512", "--backend", "eager", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "backend resolved: eager" in out and rc == 0, out


# ---------------------------------------------------------------------------
# (e) on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
def test_gpu_bicycle_solve_kernel(cuda):
    """K1 on the bicycle's own library (and K2, K3): injected ε, Philox with
    exact replay, a fleet, diverging rollouts."""
    import chip_smoke

    chip_smoke.check_family_injected("bicycle", 1000, 40, device=cuda)
    chip_smoke.check_family_philox("bicycle", 1000, 40, antithetic=True, ou_beta=0.5, device=cuda)
    chip_smoke.check_family_fleet("bicycle", 4, 1000, 40, device=cuda)
    chip_smoke.check_bicycle_diverged(device=cuda)


@pytest.mark.gpu
def test_gpu_bicycle_costs_only_kernel(cuda):
    """K4 on the bicycle's own library: S bit-equal to K1's, its fleet."""
    import chip_smoke

    chip_smoke.check_costs_only("bicycle", 1000, 40, device=cuda)
    chip_smoke.check_costs_only("bicycle", 1000, 40, antithetic=True, ou_beta=0.5, device=cuda)
