"""The port's learned models (``mppi_gpu_tpu_torch/models/neural.py``)
against the JAX package's (``mppi_gpu_tpu/models/neural.py``): ``step`` of
both models through ``convert.py`` (with and without input
standardisation, the 3-D quadrotor's quaternion slice renormalised), 20
Adam steps of both fits from the same weights on the same data (loss
history and final weights), the cosine schedule against optax's; then
tests/test_neural.py's five behaviours on the port at small sizes, and the
learned model in the controller (no autograd graph in a solve, the device
episode on the CPU). Inputs are made with numpy from seeds; each tolerance
is stated where it is used. The `gpu`-marked test runs chip_smoke's learned
model checks on the card and skips without one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.models.neural import HybridResidualDynamics as JaxHybrid  # noqa: E402
from mppi_gpu_tpu.models.neural import fit_mlp_dynamics as jax_fit_mlp  # noqa: E402
from mppi_gpu_tpu.models.neural import fit_residual_dynamics as jax_fit_residual  # noqa: E402
from mppi_gpu_tpu.models.neural import init_mlp_dynamics as jax_init  # noqa: E402
from mppi_gpu_tpu.models.quadrotor3d import Quadrotor3DDynamics as JaxQ3D  # noqa: E402
from mppi_gpu_tpu_torch.config import MPPIConfig, load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.convert import hybrid_from_numpy, mlp_from_numpy  # noqa: E402
from mppi_gpu_tpu_torch.models import dynamics_for_config  # noqa: E402
from mppi_gpu_tpu_torch.models.neural import (  # noqa: E402
    HybridResidualDynamics,
    MLPDynamics,
    cosine_decay,
    fit_mlp_dynamics,
    fit_residual_dynamics,
    init_mlp_dynamics,
)
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI  # noqa: E402
from mppi_gpu_tpu_torch.models.quadrotor3d import Quadrotor3DDynamics  # noqa: E402
from mppi_gpu_tpu_torch.runner import run_closed_loop, run_episode_jit  # noqa: E402

Q3D_FIELDS = ("dt", "mass", "inertia", "gravity")


def _numpy_mlp(m) -> dict:
    """A JAX MLPDynamics as the numpy dict of ``convert.mlp_from_numpy``."""
    d = dict(weights=[np.asarray(w) for w in m.weights], biases=[np.asarray(b) for b in m.biases],
             residual_scale=np.asarray(m.residual_scale))
    if m.in_shift is not None:
        d.update(in_shift=np.asarray(m.in_shift), in_scale=np.asarray(m.in_scale))
    return d


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def _mlp_case(rng, standardise: bool):
    """A JAX MLP (2 states, 1 action, hidden (16, 16)) with a live output
    layer (the init's is zero), optionally standardising its inputs, and
    transitions of a damped linear map."""
    m = jax_init(jax.random.key(2), 2, 1, hidden=(16, 16))
    m = dataclasses.replace(m, weights=m.weights[:-1] + (
        jnp.asarray(0.1 * rng.standard_normal((16, 2)), jnp.float32),))
    if standardise:
        m = dataclasses.replace(m, in_shift=jnp.asarray(rng.uniform(-0.5, 0.5, 3), jnp.float32),
                                in_scale=jnp.asarray(rng.uniform(0.5, 2.0, 3), jnp.float32))
    xs = rng.standard_normal((256, 2)).astype(np.float32)
    us = rng.standard_normal((256, 1)).astype(np.float32)
    xn = (xs + 0.1 * np.concatenate([xs[:, 1:], us], 1)).astype(np.float32)
    return m, (xs, us, xn)


def _hybrid_case(rng):
    """A JAX hybrid 3-D quadrotor (hidden (16,), inputs standardised, the
    quaternion slice renormalised), near-hover states and wrenches, and next
    states off the analytic model by noise."""
    base = JaxQ3D.create(1 / 60)
    x = np.zeros((128, 13), np.float32)
    x[:, 3] = 1.0
    x += 0.1 * rng.standard_normal((128, 13)).astype(np.float32)
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    u = np.concatenate([7.8 + rng.standard_normal((128, 1)), 0.1 * rng.standard_normal((128, 3))],
                       1).astype(np.float32)
    xn = (np.asarray(base.step(jnp.asarray(x), jnp.asarray(u)))
          + 0.01 * rng.standard_normal((128, 13))).astype(np.float32)
    inputs = np.concatenate([x, u], 1)
    mlp = dataclasses.replace(
        jax_init(jax.random.key(1), 13, 4, hidden=(16,)),
        in_shift=jnp.asarray(inputs.mean(0)), in_scale=jnp.asarray(1.0 / (inputs.std(0) + 1e-6)))
    # a live output layer, so the correction is not zero
    mlp = dataclasses.replace(mlp, weights=mlp.weights[:-1] + (
        jnp.asarray(0.01 * rng.standard_normal((16, 13)), jnp.float32),))
    jh = JaxHybrid(base=base, mlp=mlp, unit_norm_slice=(3, 7))
    th = hybrid_from_numpy({k: np.asarray(getattr(base, k)) for k in Q3D_FIELDS}, _numpy_mlp(mlp),
                           "cpu", (3, 7))
    return jh, th, (x, u, xn)


# ---------------------------------------------------------------------------
# (a) against the JAX package


@pytest.mark.parametrize("standardise", (False, True), ids=("raw", "standardised"))
def test_mlp_step_matches_jax(standardise):
    """MLPDynamics.step on a batch, on one state and on (K, s) states under
    one action (the rollout's broadcast): within 1e-6 of the JAX model's
    (three float32 products summed in another order, and tanh)."""
    rng = np.random.default_rng(0)
    m, (xs, us, _) = _mlp_case(rng, standardise)
    tm = mlp_from_numpy(_numpy_mlp(m), "cpu")
    assert (tm.state_dim, tm.action_dim, tm.n_layers) == (2, 1, 3)
    for x, u in ((xs, us), (xs[0], us[0]), (xs[:7], us[0])):
        np.testing.assert_allclose(tm.step(_t(x), _t(u)).numpy(),
                                   np.asarray(m.step(jnp.asarray(x), jnp.asarray(u))),
                                   rtol=1e-6, atol=1e-6)


def test_hybrid_step_matches_jax():
    """HybridResidualDynamics.step of the 3-D quadrotor with its quaternion
    renormalised after the correction: within 1e-6 of the JAX model's (the
    analytic step as in tests/test_torch_obstacle_q3d.py, and XLA's rsqrt
    against torch's), the quaternion unit to 1e-6."""
    jh, th, (x, u, _) = _hybrid_case(np.random.default_rng(1))
    got = th.step(_t(x), _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(jh.step(jnp.asarray(x), jnp.asarray(u))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.sum(got[:, 3:7] ** 2, 1).numpy(), 1.0, atol=1e-6)
    assert th.state_dim == 13 and th.action_dim == 4 and th.dt is th.base.dt


@pytest.mark.parametrize("kind", ("mlp", "mlp-standardised", "hybrid", "hybrid-whitened"))
def test_fits_match_jax(kind):
    """20 full-batch Adam steps at lr 3e-3 from the same weights on the same
    transitions: the loss history within rtol 1e-4 and every weight and bias
    within 5e-6 of the JAX fit's (optax's and torch's Adam agree in exact
    arithmetic; float32 rounding of the gradients moves an element by
    ~4e-7 after 20 steps, where one sign flip of an Adam step would move it
    by ~6e-3)."""
    rng = np.random.default_rng(2)
    if kind.startswith("mlp"):
        m, data = _mlp_case(rng, standardise=kind.endswith("standardised"))
        jm, jl = jax_fit_mlp(m, tuple(map(jnp.asarray, data)), lr=3e-3, steps=20)
        tm, tl = fit_mlp_dynamics(mlp_from_numpy(_numpy_mlp(m), "cpu"), tuple(map(_t, data)),
                                  lr=3e-3, steps=20)
        pairs = zip(jm.weights + jm.biases, tm.weights + tm.biases)
    else:
        jh, th, data = _hybrid_case(rng)
        whiten = kind.endswith("whitened")
        jm, jl = jax_fit_residual(jh, tuple(map(jnp.asarray, data)), lr=3e-3, steps=20,
                                  whiten=whiten)
        tm, tl = fit_residual_dynamics(th, tuple(map(_t, data)), lr=3e-3, steps=20,
                                       whiten=whiten)
        pairs = zip(jm.mlp.weights + jm.mlp.biases, tm.mlp.weights + tm.mlp.biases)
        assert tm.base is th.base and tm.unit_norm_slice == (3, 7)
    assert tl.shape == (20,) and not tl.requires_grad
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for a, b in pairs:
        assert not b.requires_grad
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=5e-6)


def test_cosine_decay_is_optax():
    """The LambdaLR multiplier against optax.cosine_decay_schedule(1, 20) at
    updates 0-24 (past the end it stays 0), within 1e-6."""
    import optax

    sched = optax.cosine_decay_schedule(1.0, 20)
    f = cosine_decay(20)
    np.testing.assert_allclose([f(n) for n in range(25)],
                               [float(sched(n)) for n in range(25)], atol=1e-6)


# ---------------------------------------------------------------------------
# (b) tests/test_neural.py's five behaviours, on the port


def test_fresh_mlp_is_identity():
    m = init_mlp_dynamics(2, 1, generator=torch.Generator().manual_seed(0))
    x, u = torch.tensor([[0.3, -0.2]]), torch.tensor([[0.5]])
    np.testing.assert_allclose(m.step(x, u).numpy(), x.numpy(), atol=1e-7)
    assert all(w.shape == s for w, s in zip(m.weights, ((3, 128), (128, 128), (128, 2))))
    assert not list(m.parameters())  # buffers: a solve builds no autograd graph


def _fit_lti(n: int, scale: float, seed: int):
    """The surrogate (hidden (64, 64), 400 steps at lr 3e-3) fitted on n
    transitions of the 1-D point mass from scale·N(0, 1) states and
    actions."""
    dyn = PointMassLTI.create(0.1, 1, "cpu")
    rng = np.random.default_rng(seed)
    xs = _t(scale * rng.standard_normal((n, 2)))
    us = _t(scale * rng.standard_normal((n, 1)))
    m0 = init_mlp_dynamics(2, 1, hidden=(64, 64), generator=torch.Generator().manual_seed(seed + 1))
    m, losses = fit_mlp_dynamics(m0, (xs, us, dyn.step(xs, us)), lr=3e-3, steps=400)
    return dyn, m, losses, xs, us


def test_mlp_learns_lti_dynamics():
    """The JAX test's bars (the last loss under 5 % of the first, one-step
    error under 0.05) at 1024 transitions and 400 steps of a (64, 64) net
    in place of 4096, 800."""
    dyn, m, losses, xs, us = _fit_lti(1024, 1.0, 1)
    assert float(losses[-1]) < float(losses[0]) * 0.05
    err = float(torch.abs(m.step(xs[:100], us[:100]) - dyn.step(xs[:100], us[:100])).max())
    assert err < 0.05, f"max one-step error {err}"


def test_mppi_with_mlp_dynamics_runs_and_steers():
    """MPPI over the learned model solves the control problem against the
    true point mass: the JAX test's controller (K=128, T=15) and bar (within
    0.25 of x = 1 after 60 steps), the model fitted on 2048 transitions."""
    cfg = MPPIConfig(
        env="t", samples=128, state_dim=2, action_dim=1, horizon=15, dt=0.1, lambda_=1.0,
        noise=(0.25,), init_act=(0.0,), max_a=(1.0,), goal=(1.0, 0.0), cost_type="quadratic",
        cost_w=(1.0, 0.5),
    )
    lti, m, *_ = _fit_lti(2048, 2.0, 3)
    ctrl = MPPIController(cfg, device="cpu", dynamics=m)
    assert ctrl.rollout_backend == "eager" and ctrl._family is None
    x, U = torch.zeros(2), ctrl.init_action_seq()
    for step in range(60):
        res = ctrl.solve_auto(x, U, step)
        assert not res.action.requires_grad
        x, U = lti.step(x, res.action), res.u_next
    assert abs(float(x[0]) - 1.0) < 0.25, f"final state {x}"


def test_hybrid_residual_untrained_equals_analytic():
    """A zero-init net: the hybrid is the analytic model (the quaternion
    renormalisation a no-op on a unit quaternion), within 1e-6."""
    base = Quadrotor3DDynamics.create(1 / 60)
    mlp = init_mlp_dynamics(13, 4, hidden=(32,), generator=torch.Generator().manual_seed(0))
    mlp = MLPDynamics(mlp.weights, mlp.biases, 1.0, torch.zeros(17), torch.ones(17))
    h = HybridResidualDynamics(base, mlp, unit_norm_slice=(3, 7))
    x = torch.zeros(13)
    x[3], x[7], x[11] = 1.0, 0.4, 0.3
    u = torch.tensor([7.0, 0.05, -0.03, 0.01])
    np.testing.assert_allclose(h.step(x, u).numpy(), base.step(x, u).numpy(), atol=1e-6)


def test_hybrid_residual_learns_rotor_clamp():
    """The hybrid fit closes the 3-D quadrotor's model-plant gap (almost all
    of it the rotor clamp) on held-out transitions of the port's own world
    (examples/learn_quadrotor_residual.collect_transitions): the JAX test's
    bar, held-out RMSE under 0.6 of the analytic model's, and the
    quaternion unit to 1e-5. 4096 transitions and 600 steps of a (64, 64)
    net: at the JAX test's 2048 the held-out ratio is a matter of the draw
    (0.55 on the JAX package's own, 0.65 on this world's; the two fits on
    one draw and one init agree, test_fits_match_jax)."""
    from mppi_gpu_tpu_torch.examples.learn_quadrotor_residual import collect_transitions, rmse

    cfg = load_config("configs/quadrotor3d.yaml")
    base = dynamics_for_config(cfg, "cpu")
    xs, us, xn = collect_transitions(cfg, 4096)
    train, held = (xs[:3072], us[:3072], xn[:3072]), (xs[3072:], us[3072:], xn[3072:])
    inputs = torch.cat([train[0], train[1]], 1)
    mlp = init_mlp_dynamics(13, 4, hidden=(64, 64), generator=torch.Generator().manual_seed(1))
    mlp = MLPDynamics(mlp.weights, mlp.biases, 1.0, inputs.mean(0),
                      1.0 / (inputs.std(0, correction=0) + 1e-6))
    h, losses = fit_residual_dynamics(HybridResidualDynamics(base, mlp, (3, 7)), train, lr=3e-3,
                                      steps=600, whiten=False)
    assert float(losses[-1]) < float(losses[0])
    e_base, e_hyb = rmse(base.step(held[0], held[1]), held[2]), rmse(h.step(held[0], held[1]),
                                                                      held[2])
    assert e_hyb < 0.6 * e_base, (e_base, e_hyb)
    qn = torch.sum(h.step(held[0], held[1])[:, 3:7] ** 2, dim=1)
    np.testing.assert_allclose(qn.numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# (c) the learned model in the closed loop


def test_learned_controller_episode_on_the_cpu_is_the_host_loop():
    """On the CPU ``run_episode_jit`` of a controller over a learned model
    runs its cycle as a loop: equal to ``run_closed_loop`` bit for bit, as
    for the analytic models (tests/test_torch_episode.py)."""
    cfg = load_config("configs/point_mass2d.yaml").replace(samples=64, horizon=8)
    _, m, *_ = _fit_lti_2d()
    ctrl = MPPIController(cfg, device="cpu", dynamics=m)
    host = run_closed_loop(ctrl, max_steps=6)
    dev = run_episode_jit(ctrl, num_steps=6)
    np.testing.assert_array_equal(dev.xs, host.xs)
    np.testing.assert_array_equal(dev.us, host.us)


def _fit_lti_2d():
    """A small surrogate of the 2-D point mass (hidden (16, 16), 30 steps):
    its weights only need to be live."""
    dyn = PointMassLTI.create(0.1, 2, "cpu")
    rng = np.random.default_rng(5)
    xs, us = _t(rng.standard_normal((256, 4))), _t(rng.standard_normal((256, 2)))
    m0 = init_mlp_dynamics(4, 2, hidden=(16, 16), generator=torch.Generator().manual_seed(6))
    m, _ = fit_mlp_dynamics(m0, (xs, us, dyn.step(xs, us)), lr=3e-3, steps=30)
    return dyn, m


# ---------------------------------------------------------------------------
# (d) on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_gpu_learned_models(cuda):
    import chip_smoke

    chip_smoke.check_learned_episode(steps=10, fit_steps=50, device=cuda)
