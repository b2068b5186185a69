"""K5's rows and K3's dump on the CPU: the parts of the two kernels that
spread their draws over (rollout, step) which Python can reach.

- ``fused_solve.weighted_update_partials``, the plain twin of K5's rows
  (``DRAW_GROUP`` draws each, the OU filter run once on a row's sums),
  folded by K2's plain ``normalize`` 0 version, against TPU kernel #7
  (``pallas_weighted_update``) run as tests/test_pallas.py runs it
  (testmode pseudo-noise, interpret mode), iid, antithetic and OU;
- the OU-after-sum identity of K5's OU route against Σ_k w_k ε_k of the
  stream ``ops/philox.sample_eps`` draws, at ragged K and T;
- the wrapper: K5's row count and shared-memory check, and the C entries'
  arguments (device-free, with the entries stubbed).

Every tolerance is 1e-5 of Σ_k |w_k ε_k[t, a]|, the sum of magnitudes of
each entry's terms: float32 sums of K terms in two orders, and the OU
recursion rounded on sums in place of each rollout's ε; chip_smoke.py holds
the kernels to the same on the card.
"""

from __future__ import annotations

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.models import PointMassLTI as JaxPointMass  # noqa: E402
from mppi_gpu_tpu.ops import cost as jc  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu.ops.softmin import softmin_weights as jax_softmin  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, philox  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402


def _fold(part: torch.Tensor, T: int, A: int) -> torch.Tensor:
    """K2's plain fold of K5's rows: f_b = 1, no division by η."""
    return fs.softmin_combine_reference(part, 1.0, T, A, normalize=False)[2]


def _assert_within(got, want, eps, w) -> None:
    """|got − want| ≤ 1e-5·Σ_k |w_k ε_k[t, a]| entry by entry."""
    tol = 1e-5 * np.einsum("tka,k->ta", np.abs(np.asarray(eps, np.float64)),
                           np.abs(np.asarray(w, np.float64)))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= tol).all(), f"max abs err {err.max():.3g}, {(err > tol).sum()} entries beyond"


@pytest.mark.parametrize("A,K,T,anti,ou", [(2, 300, 12, False, 0.0), (3, 514, 9, True, 0.0),
                                           (2, 300, 12, False, 0.5), (3, 514, 9, True, 0.5)])
def test_weighted_update_rows_fold_to_the_pallas_kernel(A, K, T, anti, ou):
    """K5's rows in the Philox mode, on the normals of the TPU kernel's
    testmode noise (its host twin at σ = 1 without OU; under antithetic
    each rank's mirror is the rank whose normals are its negation, put in
    K5's layout, draws then mirrors), folded, against
    ``pallas_weighted_update`` with the softmin weights of
    ``pallas_rollout_costs``'s S."""
    dyn = JaxPointMass.create(0.1, A)
    cost = jc.QuadraticCost(w=jnp.asarray([1.0] * A + [5.0] * A),
                            goal=jnp.asarray([1.0, 0.5, 0.75][:A] + [0.0] * A),
                            lambda_=jnp.float32(1.0), inv_s=jnp.ones(A))
    x0 = jnp.asarray([0.1, -0.2, 0.05][:A] + [0.0] * A, jnp.float32)
    U = 0.2 * jnp.sin(0.3 * jnp.arange(T * A, dtype=jnp.float32)).reshape(T, A)
    sigma = jnp.full((A,), 0.4)
    key = jax.random.key(5)
    plan = pr.make_plan(K, T, A, antithetic=anti, ou_beta=ou, testmode=True)
    S = pr.pallas_rollout_costs(dyn, cost, x0, U, key, sigma, K=K, antithetic=anti, ou_beta=ou,
                                interpret=True, testmode=True)
    w = jax_softmin(S[:K], cost.lambda_).weights
    dU_j = pr.pallas_weighted_update(dyn, cost, x0, U, key, sigma,
                                     jnp.zeros((plan.Kpad,)).at[:K].set(w), K=K, antithetic=anti,
                                     ou_beta=ou, interpret=True, testmode=True)
    nu = np.asarray(pr.fake_noise_tensor(plan, jnp.ones(A), key=key))[:, :K]
    eps = np.asarray(pr.fake_noise_tensor(plan, sigma, ou_beta=ou, key=key))[:, :K]
    w_t = torch.tensor(np.asarray(w))
    draws = np.arange(K)
    if anti:  # K5's layout: the draws, then their mirrors (each rank's negation) in draw order
        flat = nu.transpose(1, 0, 2).reshape(K, -1)
        mirror = [int(np.flatnonzero((flat == -flat[r]).all(1))[0]) for r in range(K)]
        first = [r for r in range(K) if r < mirror[r]]
        assert len(first) == K // 2
        draws = np.array(first + [mirror[r] for r in first])
    K_draw = K // 2 if anti else K
    part = fs.weighted_update_partials(w_t[draws], torch.tensor(nu[:, draws[:K_draw]]),
                                       torch.tensor(np.asarray(sigma)), anti, ou)
    assert part.shape == (fs.weighted_update_rows(T, K, A, anti), 2 + T * A)
    assert not part[:, :2].any()  # β_b = η_b = 0: K2 sums the rows
    _assert_within(_fold(part, T, A).numpy(), np.asarray(dU_j), eps, w_t.numpy())


@pytest.mark.parametrize("A,K,T,anti,ou,k0", [
    (3, 131, 13, False, 0.0, 0), (3, 131, 13, False, 0.5, 0), (2, 262, 13, True, 0.0, 0),
    (2, 262, 13, True, 0.5, 393), (4, 64, 40, False, 0.8, 0), (1, 65, 7, False, 0.5, 7),
])
def test_ou_after_sum_is_the_weighted_stream(A, K, T, anti, ou, k0):
    """Route (b): Σ w̃·n over a row's draws, then the OU recursion once on
    the row's sums, then σ, folded over the rows, is Σ_k w_k ε_k of the
    stream ``sample_eps`` draws from k0 on, for K not a multiple of the row
    (K_draw = 131 odd under antithetic). Injected ε through the same rows is
    the same sum."""
    gen = torch.Generator().manual_seed(K + A)
    sigma = 0.2 + torch.rand(A, generator=gen)
    w = torch.rand(K, generator=gen)
    w /= w.sum()
    eps = philox.sample_eps(4, 9, 1, T, K, sigma, antithetic=anti, ou_beta=ou, k0=k0)
    K_draw = K // 2 if anti else K
    nu = philox.box_muller(philox.philox_words(4, 9, 1, T, K_draw, "cpu", k0), A)
    want = fs.weighted_update_reference(w, eps)
    _assert_within(_fold(fs.weighted_update_partials(w, nu, sigma, anti, ou), T, A), want, eps, w)
    injected = fs.weighted_update_partials(w, eps)
    assert injected.shape[0] == -(-K // fs.DRAW_GROUP)
    _assert_within(_fold(injected, T, A), want, eps, w)


def test_one_hot_and_zero_weights_are_exact():
    """A one-hot w at the last rollout (the edge of the last row; a mirror
    under antithetic) gives that rollout's ε exactly, in every mode; zero
    weights give zero."""
    A, K, T = 3, 130, 11
    sigma = torch.tensor([0.3, 0.5, 0.2])
    for anti, ou in ((False, 0.0), (True, 0.0), (False, 0.5), (True, 0.5)):
        eps = philox.sample_eps(2, 3, 0, T, K, sigma, antithetic=anti, ou_beta=ou)
        nu = philox.box_muller(philox.philox_words(2, 3, 0, T, K // 2 if anti else K, "cpu"), A)
        w = torch.zeros(K)
        assert not _fold(fs.weighted_update_partials(w, nu, sigma, anti, ou), T, A).any()
        w[K - 1] = 1.0
        assert torch.equal(_fold(fs.weighted_update_partials(w, nu, sigma, anti, ou), T, A),
                           eps[:, K - 1])


@pytest.mark.parametrize("T,K,A,fold,nb", [(200, 10_000, 3, False, 157), (200, 10_000, 3, True, 79),
                                           (50, 3000, 2, False, 47), (8, 64, 1, False, 1),
                                           (8, 65, 1, False, 2), (8, 130, 4, True, 2)])
def test_weighted_update_rows(T, K, A, fold, nb):
    assert fs.weighted_update_rows(T, K, A, fold) == nb


def test_weighted_update_shared_memory_check():
    """K5 keeps one (T, A) float block of sums in shared memory: T·A·4 bytes
    up to the budget, refused past it."""
    top = fs._SMEM_BYTES // 4
    assert fs.weighted_update_rows(top // 3, 64, 3, False) == 1
    with pytest.raises(ValueError, match="shared-memory budget"):
        fs.weighted_update_rows(top // 3 + 1, 64, 3, False)


def _stub_cuda(monkeypatch, status=0):
    """CPU tensors taken for CUDA ones, the C entries recorded; the stubbed
    launches count in a copy of the launch counts, so that none leaks into
    the process's counts that other tests read."""
    monkeypatch.setattr(fs, "_LAUNCHES", dict(fs._LAUNCHES))
    calls = {"weighted_update": [], "softmin_combine": [], "noise_dump": []}
    lib = types.SimpleNamespace(**{
        f"mppi_{k}": (lambda k: lambda *a: calls[k].append(a) or status)(k) for k in calls})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


def test_weighted_update_launch_sizes_the_rows(monkeypatch):
    """Device-free: the wrapper sizes K5's partials at ceil(n / 64) rows (n
    the draws: K/2 with the antithetic mirrors folded in, in the Philox mode
    only), K2 folds that many, and T·A past the shared memory raises before
    any launch."""
    calls = _stub_cuda(monkeypatch)
    sigma, K, T = torch.tensor([0.3, 0.5, 0.2]), 1000, 20
    w = torch.full((K,), 1.0 / K)
    fs.reset_launch_counts()
    for anti, eps, nb in ((False, None, 16), (True, None, 8),
                          (True, torch.zeros(T, K, 3), 16)):
        fs.weighted_update(sigma, w, T, K, 7, 3, 0, anti and eps is None, 0.0, eps=eps)
        assert calls["weighted_update"][-1][12] == int(anti and eps is None)  # the fold flag
        assert calls["softmin_combine"][-1][2] == nb and calls["softmin_combine"][-1][5] == 0
    assert fs.launch_counts()["weighted_update"] == 3
    with pytest.raises(ValueError, match="shared-memory budget"):
        fs.weighted_update(sigma, torch.ones(4), fs._SMEM_BYTES, 4, 7, 3, 0, False, 0.0)
    assert len(calls["weighted_update"]) == 3


def test_noise_dump_launch_raises_when_refused(monkeypatch):
    """Device-free: K3's entry gets K, T, A and the draw offset; a refused
    launch raises and nothing runs in its place."""
    calls = _stub_cuda(monkeypatch, status=9)
    with pytest.raises(RuntimeError, match="noise_dump failed to launch: cudaError_t 9"):
        fs.noise_dump(torch.tensor([0.3, 0.5]), 6, 40, 7, 3, 0, True, 0.5, words=True, k0=80)
    (args,) = calls["noise_dump"]
    assert args[3:6] == (40, 6, 2) and args[10:12] == (80, 1)


@pytest.mark.parametrize("anti", [False, True])
def test_chip_smoke_draw_bounds_count_the_function(monkeypatch, anti):
    """K5's and K3's bounds read the pinned per-step count of K1's former
    per-rollout second pass (one draw, its shaping and an 11·A reduction),
    less that reduction: K5 adds one multiply-add w·ε per action, K3 its
    stores (the mirror's too, and four words when written). Checked on a
    made-up count, with the clock set so that one instruction per lane is
    one millisecond."""
    import chip_smoke

    A, K, T = 3, 1000, 20
    monkeypatch.setitem(chip_smoke.DRAW_LOOP_STEP, A, 90.0)
    lanes = chip_smoke.H100_SMS * chip_smoke.H100_LANES
    clock_mhz = 1e-3 / lanes
    draws = K // 2 if anti else K
    k5, by = chip_smoke.weighted_update_bound(K, T, A, clock_mhz, antithetic=anti)
    assert by == "operations" and k5 == pytest.approx((90 - 11 * A + A) * T * draws)
    k3, _ = chip_smoke.noise_dump_bound(K, T, A, clock_mhz, antithetic=anti, words=True)
    assert k3 == pytest.approx((90 - 11 * A + A * (2 if anti else 1) + 4) * T * draws)
