"""ops/fused_solve.py — the module that holds the CUDA solve kernels.

On the CPU the wrappers run their plain versions; these are held against
the JAX package's one-pass Pallas kernels run as its own tests run them
(testmode pseudo-noise, interpret mode): the row-packed kernel (A=2) and the
planar kernel (A=3). The port's "normals → ε" step is held against the
kernels' host twin of that noise. Tests marked `gpu` run the kernels
themselves through chip_smoke's checks and skip without a CUDA device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.models.point_mass import PointMassLTI as JaxLTI  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu.ops.cost import QuadraticCost as JaxQuadratic  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import philox  # noqa: E402

# tests/test_pallas.py's tolerances for the same kernels against the scan path
S_TOL = dict(rtol=3e-5)
DU_TOL = dict(rtol=2e-4, atol=1e-6)


def _setup(A, T):
    """tests/test_pallas.py::_setup, as numpy."""
    return dict(
        w=np.arange(1.0, 2 * A + 1.0, dtype=np.float32),
        goal=np.linspace(-1.0, 1.0, 2 * A).astype(np.float32),
        lambda_=np.float32(1.2),
        inv_s=np.full(A, 0.8, np.float32),
        x0=np.linspace(0.1, -0.1, 2 * A).astype(np.float32),
        U=(0.1 * np.cos(np.arange(T * A, dtype=np.float32))).reshape(T, A).astype(np.float32),
        sigma=np.full(A, 0.25, np.float32),
    )


def _port_args(p, K, lam_softmin, eps=None, *, seed=0, step=0, it=0, antithetic=False, ou_beta=0.0):
    t = {k: torch.as_tensor(v) for k, v in p.items() if k != "lambda_"}
    return (
        t["x0"], t["U"], t["sigma"], t["inv_s"], t["w"], t["goal"], float(p["lambda_"]),
        lam_softmin, 0.1, K, seed, step, it, antithetic, ou_beta,
        None if eps is None else torch.as_tensor(np.ascontiguousarray(eps)),
    )


@pytest.mark.parametrize(
    "A,K,T,planar", [(2, 300, 12, False), (3, 530, 11, True)], ids=["rowpacked", "planar"]
)
def test_plain_version_matches_pallas_onepass_kernel(A, K, T, planar):
    p = _setup(A, T)
    key, lam = jax.random.key(21), jnp.float32(0.9)
    plan = pr.make_plan(K, T, A, testmode=True)
    assert plan.planar == planar and plan.onepass
    twin = pr.planar_fake_noise_tensor if planar else pr.fake_noise_tensor
    eps = np.asarray(twin(plan, jnp.asarray(p["sigma"]), key=key))[:, :K]
    dyn = JaxLTI.create(0.1, A)
    cost = JaxQuadratic(**{k: jnp.asarray(p[k]) for k in ("w", "goal", "lambda_", "inv_s")})
    S_j, dU_j = pr.pallas_fused_solve_core(
        dyn, cost, jnp.asarray(p["x0"]), jnp.asarray(p["U"]), key, jnp.asarray(p["sigma"]),
        lam, K=K, testmode=True, interpret=True,
    )
    S, beta, eta, dU = fs.fused_solve(*_port_args(p, K, 0.9, eps))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j)[:K], **S_TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_j), **DU_TOL)
    np.testing.assert_allclose(float(beta), float(np.asarray(S_j)[:K].min()), rtol=3e-5)
    assert fs.launch_counts() == {"solve_partials": 0, "softmin_combine": 0, "noise_dump": 0,
                                 "rollout_costs": 0,
                                 "weighted_update": 0}


@pytest.mark.parametrize("antithetic,ou_beta", [(False, 0.55), (True, 0.0), (True, 0.55)])
def test_normals_to_eps_matches_kernel_noise_twin(antithetic, ou_beta):
    """OU recursion, σ scale and antithetic mirror against fake_noise_tensor,
    fed its own σ=1, β=0 tensor as the normals. The twin orders mirror pairs
    as adjacent ranks (2m, 2m+1); the port mirrors the second half."""
    A, K, T = 2, 300, 9
    sigma = np.array([0.25, 0.4], np.float32)
    key = jax.random.key(3)
    plan = pr.make_plan(K, T, A, antithetic=antithetic, ou_beta=ou_beta, testmode=True)
    normals = np.asarray(pr.fake_noise_tensor(plan, 1.0, 0.0, key=key))
    want = np.asarray(pr.fake_noise_tensor(plan, jnp.asarray(sigma), ou_beta, key=key))
    if antithetic:
        Kh = K // 2
        normals = normals[:, 0::2][:, :Kh]
        want = np.concatenate([want[:, 0::2][:, :Kh], want[:, 1::2][:, :Kh]], axis=1)
    got = philox.normals_to_eps(
        torch.tensor(normals), torch.as_tensor(sigma),
        antithetic=antithetic, ou_beta=ou_beta,
    )
    np.testing.assert_allclose(got.numpy()[:, : want.shape[1]], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("antithetic,ou_beta,K", [(False, 0.0, 300), (True, 0.5, 1000)])
def test_block_partials_equal_the_global_softmin(antithetic, ou_beta, K):
    """Philox mode: the per-block partials folded by the combine give the
    eager path's global softmin on the same stream (K not a multiple of the
    block: the pad takes no part)."""
    from mppi_gpu_tpu_torch.controller import sample_noise, solve_from_costs
    from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
    from mppi_gpu_tpu_torch.ops.cost import QuadraticCost
    from mppi_gpu_tpu_torch.ops.rollout import rollout_costs

    A, T = 3, 15
    p = _setup(A, T)
    args = _port_args(p, K, 1.1, seed=5, step=2, it=1, antithetic=antithetic, ou_beta=ou_beta)
    S, beta, eta, dU = fs.fused_solve(*args)
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    eps = sample_noise(5, 2, 1, T, K, t["sigma"], antithetic=antithetic, ou_beta=ou_beta)
    S_e = rollout_costs(PointMassLTI(torch.tensor(0.1), A),
                        QuadraticCost(t["w"], t["goal"], t["lambda_"], t["inv_s"]),
                        t["x0"], t["U"], eps)
    res = solve_from_costs(S_e, eps, t["U"], 1.1, torch.full((A,), 1e9), clamp=False)
    assert torch.equal(S, S_e)
    assert float(beta) == float(res.info.beta)
    np.testing.assert_allclose(float(eta), float(res.info.eta), rtol=1e-5)
    np.testing.assert_allclose(dU.numpy(), (res.info.u_seq - t["U"]).numpy(), rtol=1e-4, atol=1e-6)


def test_diverged_block_and_all_diverged():
    """A block whose rollouts all cost +inf (block 1 at the width the rule
    picks) gets weight 0 and leaves the others' solve intact; when every
    rollout diverges β = +inf and the result is NaN (the guard's signal),
    never a finite action."""
    A, K, T = 2, 300, 10
    W = fs.block_width(1, K, T, A, "lti")
    p = _setup(A, T)
    rng = np.random.default_rng(0)
    eps = (0.25 * rng.standard_normal((T, K, A))).astype(np.float32)
    ref = fs.fused_solve(*_port_args(p, K, 1.0, eps))
    eps_bad = eps.copy()
    eps_bad[:, W:2 * W] = 1e30
    S, beta, eta, dU = fs.fused_solve(*_port_args(p, K, 1.0, eps_bad))
    assert torch.isinf(S[W:2 * W]).all()
    keep = np.r_[0:W, 2 * W:K]
    assert torch.equal(S[keep], ref[0][keep])
    w_ok = torch.exp(-(ref[0][keep] - ref[1]) / 1.0)
    eta_keep = w_ok.sum()
    dU_keep = torch.einsum("tka,k->ta", torch.as_tensor(eps[:, keep]), w_ok / eta_keep)
    np.testing.assert_allclose(float(eta), float(eta_keep), rtol=1e-5)
    np.testing.assert_allclose(dU.numpy(), dU_keep.numpy(), rtol=1e-4, atol=1e-6)

    p_div = dict(p, w=np.full(2 * A, 1e38, np.float32))
    S, beta, eta, dU = fs.fused_solve(*_port_args(p_div, K, 1.0, eps))
    assert torch.isinf(S).all() and float(beta) == float("inf")
    assert torch.isnan(eta) and torch.isnan(dU).all()


def test_wrappers_reject_bad_inputs():
    p = _setup(2, 6)
    args = list(_port_args(p, 50, 1.0))
    with pytest.raises(TypeError, match="float32"):
        fs.fused_solve(*[a.double() if i == 1 else a for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="shape"):
        fs.fused_solve(*[a[:1] if i == 2 else a for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="contiguous"):
        U = torch.as_tensor(p["U"]).t().contiguous().t()
        fs.fused_solve(*[U if i == 1 else a for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fs.fused_solve(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
    with pytest.raises(ValueError, match="even K"):
        fs.fused_solve(*args[:9], 51, *args[10:13], True, *args[14:])
    p5 = _setup(5, 6)
    with pytest.raises(ValueError, match="A <= 4"):
        fs.fused_solve(*_port_args(p5, 50, 1.0))
    with pytest.raises(ValueError, match="A <= 4"):
        fs.noise_dump(torch.ones(5), 6, 50, 0, 0, 0, False, 0.0)


def test_noise_dump_on_cpu_is_the_philox_stream():
    sigma = torch.tensor([0.25, 0.5, 0.1])
    eps, words = fs.noise_dump(sigma, 7, 40, 3, 4, 1, True, 0.3, words=True)
    assert torch.equal(eps, philox.sample_eps(3, 4, 1, 7, 40, sigma, antithetic=True, ou_beta=0.3))
    assert torch.equal(words, philox.philox_words(3, 4, 1, 7, 20, "cpu"))
    assert fs.launch_counts()["noise_dump"] == 0


def test_backend_resolution():
    from mppi_gpu_tpu_torch.config import load_config
    from mppi_gpu_tpu_torch.controller import MPPIController, resolve_backend

    cfg = load_config("configs/point_mass3d.yaml").replace(samples=64, horizon=5)
    ctrl = MPPIController(cfg, device="cpu", rollout_backend="auto")
    assert ctrl.rollout_backend == "eager"
    with pytest.raises(ValueError, match="CUDA device"):
        MPPIController(cfg, device="cpu", rollout_backend="fused")
    with pytest.raises(ValueError, match="unknown"):
        resolve_backend("pallas", torch.device("cpu"), ctrl.dynamics, ctrl.cost)
    assert resolve_backend("auto", torch.device("cuda"), ctrl.dynamics, ctrl.cost) == "fused"


def test_chip_smoke_checks_run_on_the_cpu():
    """chip_smoke.py's checks on CPU tensors compare the plain versions with
    themselves and with the float64 oracle: a rehearsal of the script's logic
    that needs no card."""
    import chip_smoke

    chip_smoke.check_injected(2, 300, 12, device="cpu")
    chip_smoke.check_kernels(3, 200, 10, antithetic=True, ou_beta=0.5, device="cpu")
    assert chip_smoke.check_dump_replay(3, 200, 10, device="cpu")["eps_bit_identical"]
    chip_smoke.check_edge_cases(device="cpu")


# ---------------------------------------------------------------------------
# on the card: the kernels themselves, through chip_smoke's checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("A,K,T", [(2, 300, 12), (3, 1000, 50)])
def test_gpu_injected_eps_matches_plain_and_oracle(cuda, A, K, T):
    import chip_smoke

    chip_smoke.check_injected(A, K, T, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("antithetic,ou_beta", [(False, 0.0), (True, 0.0), (False, 0.5)])
def test_gpu_kernels_dump_and_replay(cuda, antithetic, ou_beta):
    import chip_smoke

    chip_smoke.check_kernels(3, 1000, 50, antithetic=antithetic, ou_beta=ou_beta, device=cuda)
    chip_smoke.check_dump_replay(3, 1000, 50, antithetic=antithetic, ou_beta=ou_beta, device=cuda)


@pytest.mark.gpu
def test_gpu_edge_cases(cuda):
    import chip_smoke

    chip_smoke.check_edge_cases(device=cuda)
