"""PointMassLTI and QuadraticCost of the port against the JAX package, on
identical float32 parameters carried across by convert.from_numpy_params."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.models.point_mass import PointMassLTI as JaxLTI  # noqa: E402
from mppi_gpu_tpu.ops.cost import QuadraticCost as JaxQuadratic  # noqa: E402
from mppi_gpu_tpu_torch.convert import from_numpy, from_numpy_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 results of a few ops; atol covers the cost's λ·u·Σ⁻¹·ε term cancelling
TOL = dict(rtol=1e-6, atol=1e-6)


def _params(A: int, rng: np.random.Generator):
    dyn = dict(dt=np.float32(0.1), action_dim=A)
    cost = dict(
        w=rng.uniform(0.5, 5.0, 2 * A).astype(np.float32),
        goal=rng.uniform(-1, 1, 2 * A).astype(np.float32),
        lambda_=np.float32(1.3),
        inv_s=rng.uniform(0.5, 2.0, A).astype(np.float32),
    )
    jdyn = JaxLTI.create(0.1, A)
    jcost = JaxQuadratic(**{k: jnp.asarray(v) for k, v in cost.items()})
    return (jdyn, jcost), from_numpy_params(dyn, cost, "cpu")


@pytest.mark.parametrize("A", [1, 2, 3])
def test_step_and_costs_match_jax(A):
    rng = np.random.default_rng(A)
    (jdyn, jcost), (tdyn, tcost) = _params(A, rng)
    x = rng.standard_normal((64, 2 * A)).astype(np.float32)
    u = rng.standard_normal((64, A)).astype(np.float32)
    U = rng.standard_normal(A).astype(np.float32)
    eps = (0.25 * rng.standard_normal((64, A))).astype(np.float32)

    nx = np.asarray(jdyn.step(jnp.asarray(x), jnp.asarray(u)))
    tx = tdyn.step(from_numpy(x, "cpu"), from_numpy(u, "cpu")).numpy()
    assert tdyn.state_dim == 2 * A
    np.testing.assert_allclose(tx, nx, **TOL)

    js = np.asarray(jcost.step(jnp.asarray(x), jnp.asarray(U), jnp.asarray(eps)))
    ts = tcost.step(from_numpy(x, "cpu"), from_numpy(U, "cpu"), from_numpy(eps, "cpu")).numpy()
    np.testing.assert_allclose(ts, js, **TOL)
    jf = np.asarray(jcost.final(jnp.asarray(x)))
    np.testing.assert_allclose(tcost.final(from_numpy(x, "cpu")).numpy(), jf, **TOL)


@pytest.mark.parametrize("name,inv_sigma", [
    ("point_mass1d", "identity"), ("point_mass2d", "identity"), ("point_mass3d", "from-noise"),
])
def test_config_factories_match_jax(name, inv_sigma):
    from mppi_gpu_tpu.config import load_config as load_jax
    from mppi_gpu_tpu.models import dynamics_for_config as jax_dyn
    from mppi_gpu_tpu.ops.cost import make_cost as jax_cost
    from mppi_gpu_tpu_torch.config import load_config
    from mppi_gpu_tpu_torch.models import dynamics_for_config
    from mppi_gpu_tpu_torch.ops.cost import make_cost

    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    cfg = load_config(path).replace(inv_sigma=inv_sigma)
    jcfg = load_jax(path).replace(inv_sigma=inv_sigma)
    dyn, cost = dynamics_for_config(cfg, "cpu"), make_cost(cfg, "cpu")
    jd, jc = jax_dyn(jcfg), jax_cost(jcfg)
    assert dyn.action_dim == jd.action_dim and dyn.state_dim == jd.state_dim
    assert float(dyn.dt) == float(jd.dt)
    for f in ("w", "goal", "lambda_", "inv_s"):
        np.testing.assert_array_equal(getattr(cost, f).numpy(), np.asarray(getattr(jc, f)))
