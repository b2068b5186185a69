"""The port's eager solve against the JAX package's mppi_solve_deterministic
and the float64 oracle (tests/oracle.py) on the same numpy ε, including
iterated MPPI (opt_iters=2) with injected ε per iteration."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.controller import mppi_solve_deterministic as jax_solve  # noqa: E402
from mppi_gpu_tpu.models.point_mass import PointMassLTI as JaxLTI  # noqa: E402
from mppi_gpu_tpu.ops.cost import QuadraticCost as JaxQuadratic  # noqa: E402
from mppi_gpu_tpu_torch import controller as C  # noqa: E402
from mppi_gpu_tpu_torch.convert import from_numpy, from_numpy_params  # noqa: E402
from tests.oracle import oracle_solve  # noqa: E402

# f32 vs f32 (JAX) and f32 vs float64 (oracle). S sums T f32 step costs; the
# weights amplify an S error δ by δ/λ; η and ΔU are sums of weighted terms.
TOL_JAX = dict(
    costs=dict(rtol=1e-5), beta=dict(rtol=1e-5), eta=dict(rtol=1e-4),
    weights=dict(rtol=1e-4, atol=1e-9), u_seq=dict(rtol=1e-5, atol=5e-6),
)
TOL_ORACLE = dict(S=dict(rtol=2e-5), beta=dict(rtol=2e-5), eta=dict(rtol=2e-4),
                  w=dict(rtol=2e-4, atol=1e-9), u=dict(rtol=1e-5, atol=5e-6))


def _problem(A, K, T, seed=0):
    rng = np.random.default_rng(seed)
    p = dict(
        w=np.arange(1.0, 2 * A + 1.0, dtype=np.float32),
        goal=np.linspace(-1.0, 1.0, 2 * A).astype(np.float32),
        lambda_=np.float32(1.2),
        inv_s=np.full(A, 0.8, np.float32),
    )
    x0 = np.linspace(0.1, -0.1, 2 * A).astype(np.float32)
    U = (0.1 * np.cos(np.arange(T * A))).reshape(T, A).astype(np.float32)
    eps = lambda: (0.25 * rng.standard_normal((T, K, A))).astype(np.float32)  # noqa: E731
    jdyn = JaxLTI.create(0.1, A)
    jcost = JaxQuadratic(**{k: jnp.asarray(v) for k, v in p.items()})
    tdyn, tcost = from_numpy_params(dict(dt=np.float32(0.1), action_dim=A), p, "cpu")
    return p, x0, U, eps, (jdyn, jcost), (tdyn, tcost)


def _compare(res_t, res_j):
    for field in ("costs", "beta", "eta", "weights", "u_seq"):
        np.testing.assert_allclose(
            getattr(res_t.info, field).numpy(), np.asarray(getattr(res_j.info, field)),
            **TOL_JAX[field], err_msg=field,
        )
    for field in ("action", "u_next"):
        np.testing.assert_allclose(
            getattr(res_t, field).numpy(), np.asarray(getattr(res_j, field)),
            **TOL_JAX["u_seq"], err_msg=field,
        )


@pytest.mark.parametrize("A,K,T", [(2, 300, 12), (3, 513, 20)])
def test_deterministic_solve_matches_jax_and_oracle(A, K, T):
    p, x0, U, eps_fn, (jdyn, jcost), (tdyn, tcost) = _problem(A, K, T)
    eps = eps_fn()
    max_a = np.full(A, 0.3, np.float32)  # active clamp
    res_j = jax_solve(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps),
                      jnp.float32(1.2), jnp.asarray(max_a))
    res_t = C.mppi_solve_deterministic(
        tdyn, tcost, from_numpy(x0, "cpu"), from_numpy(U, "cpu"), from_numpy(eps, "cpu"),
        tcost.lambda_, from_numpy(max_a, "cpu"),
    )
    _compare(res_t, res_j)

    S_o, U_new_o, action_o, shift_o, w_o, beta_o, eta_o = oracle_solve(
        x0, U, eps, 0.1, p["w"].astype(np.float64), p["goal"].astype(np.float64),
        1.2, p["inv_s"].astype(np.float64), max_a=max_a,
    )
    np.testing.assert_allclose(res_t.info.costs.numpy(), S_o, **TOL_ORACLE["S"])
    np.testing.assert_allclose(float(res_t.info.beta), beta_o, **TOL_ORACLE["beta"])
    np.testing.assert_allclose(float(res_t.info.eta), eta_o, **TOL_ORACLE["eta"])
    np.testing.assert_allclose(res_t.info.weights.numpy(), w_o, **TOL_ORACLE["w"])
    np.testing.assert_allclose(res_t.info.u_seq.numpy(), U_new_o, **TOL_ORACLE["u"])
    np.testing.assert_allclose(res_t.action.numpy(), action_o, **TOL_ORACLE["u"])
    np.testing.assert_allclose(res_t.u_next.numpy(), shift_o, **TOL_ORACLE["u"])


@pytest.mark.parametrize("antithetic,ou_beta", [(False, 0.0), (True, 0.5)])
def test_opt_iters_two_matches_jax_on_the_same_eps(antithetic, ou_beta):
    """Iterated MPPI: iteration j draws counter word it = j; two JAX
    deterministic solves on those ε (the first's updated, unshifted sequence
    feeding the second) give the port's result."""
    A, K, T = 2, 300, 12
    p, x0, U, _, (jdyn, jcost), (tdyn, tcost) = _problem(A, K, T)
    sigma, max_a = torch.full((A,), 0.25), torch.ones(A)
    res_t = C.mppi_solve(
        tdyn, tcost, from_numpy(x0, "cpu"), from_numpy(U, "cpu"), seed=4, step=9,
        sigma=sigma, lambda_=1.2, max_a=max_a, K=K, antithetic=antithetic,
        ou_beta=ou_beta, opt_iters=2,
    )
    Uj = jnp.asarray(U)
    for j in range(2):
        eps = C.sample_noise(4, 9, j, T, K, sigma, antithetic=antithetic, ou_beta=ou_beta)
        res_j = jax_solve(jdyn, jcost, jnp.asarray(x0), Uj, jnp.asarray(eps.numpy()),
                          jnp.float32(1.2), jnp.ones(A))
        Uj = res_j.info.u_seq
    _compare(res_t, res_j)


def test_controller_iterates_like_mppi_solve():
    from mppi_gpu_tpu_torch.config import load_config

    cfg = load_config("configs/point_mass2d.yaml").replace(
        samples=256, horizon=10, opt_iters=2, antithetic=True, noise_beta=0.3
    )
    ctrl = C.MPPIController(cfg, device="cpu")
    assert ctrl.rollout_backend == "eager"
    x = torch.tensor([0.1, -0.1, 0.0, 0.2])
    U = ctrl.init_action_seq()
    res = ctrl.solve_auto(x, U, 5)
    ref = C.mppi_solve(
        ctrl.dynamics, ctrl.cost, x, U, seed=cfg.seed, step=5, sigma=ctrl.sigma,
        lambda_=cfg.lambda_, max_a=ctrl.max_a, K=256, antithetic=True, ou_beta=0.3,
        opt_iters=2,
    )
    for a, b in zip(res, ref):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(res.info.costs, ref.info.costs)
    # the debug solve documents the same final iteration
    dbg, eps, xs = ctrl.solve_debug(x, U, 5)
    assert torch.equal(dbg.action, res.action)
    assert eps.shape == (10, 256, 2) and xs.shape == (11, 256, 4)
    assert torch.equal(xs[0], x.expand(256, 4))


@pytest.mark.parametrize("antithetic,opt_iters", [(False, 1), (True, 2)])
def test_controller_fused_path_on_cpu_tensors(antithetic, opt_iters):
    """The controller's fused path (kernels in Philox and injected-ε mode,
    then the torch tail), run on CPU tensors where the kernel wrappers take
    their plain versions, gives the eager path's results. `auto` never picks
    `fused` on the CPU, so the backend is switched by hand."""
    from mppi_gpu_tpu_torch.config import load_config

    cfg = load_config("configs/point_mass3d.yaml").replace(
        samples=300, horizon=12, antithetic=antithetic, opt_iters=opt_iters
    )
    eager = C.MPPIController(cfg, device="cpu")
    fused = C.MPPIController(cfg, device="cpu")
    fused.rollout_backend = "fused"
    x = torch.tensor([0.1, -0.2, 0.05, 0.0, 0.1, 0.0])
    U = 0.1 * torch.ones(12, 3)
    for a, b in ((fused.solve_auto(x, U, 4), eager.solve_auto(x, U, 4)),
                 (fused.solve_with_eps(x, U, eager._eps(0, 1, 0)),
                  eager.solve_with_eps(x, U, eager._eps(0, 1, 0)))):
        # opt_iters=2: the first update differs in the last bits (block
        # partials vs one global sum), so the second iteration's costs do too
        np.testing.assert_allclose(a.info.costs.numpy(), b.info.costs.numpy(), rtol=1e-6)
        np.testing.assert_allclose(a.info.weights.numpy(), b.info.weights.numpy(), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(a.u_next.numpy(), b.u_next.numpy(), rtol=1e-5, atol=1e-6)
    res, eps, xs = fused.solve_debug(x, U, 4)
    np.testing.assert_allclose(res.info.costs.numpy(), eager.solve_auto(x, U, 4).info.costs.numpy(),
                               rtol=1e-6)
    assert eps.shape == (12, 300, 3) and xs.shape == (13, 300, 6)
