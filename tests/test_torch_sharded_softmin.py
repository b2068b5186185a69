"""The two-kernel sharded softmin on the CPU: K10 ``softmin_min`` and K11
``softmin_eta`` (``ops/sharded_combine.py``, their kernels in
``csrc/sharded_combine.cu``), one kernel before each collective of the
two-kernel branch, and K5's softmin form (``fused_solve.weighted_update`` on
(S, β, η, λ)), which forms the weights in its prologue.

- their plain version, ``parallel/sharded.softmin_across`` (η_d summed in
  K11's fixed order), against the JAX ``softmin_weights`` with an axis name
  under ``shard_map`` on n CPU devices, over 1, 2 and 4 ranks, K/n on the
  boundaries of K11's 4096-entry chunk, a rank at +inf, every rank so and a
  rank whose e_k underflow, five λ: β exact, η and the weights within 1e-6
  relative;
- its η_d against a float64 sum of the same e_k, within the bound of its
  summation order, and ``eta_sum`` against the order written out index by
  index in numpy;
- K5's softmin form equal to its w form on torch's weights, with ``out``;
- the two-kernel sharded solve on virtual meshes of 2 and 4 ranks on the
  fused backend (every wrapper its plain version) bit-equal to the eager
  backend, and within tolerance of the JAX sharded solve on its ε;
- K10's and K11's row forms (``row_form``: a block, a cluster of 2-8
  blocks, a ticket) and the dispatch with the C entries stubbed: scratch
  and tickets for rows of more than eight blocks alone, a failed launch
  raising;
- chip_smoke.py's phase-27 check of K10, K11 and K5's softmin form on CPU
  tensors, its kernel names and its kernels per two-kernel cycle; (marked
  `gpu`, skipped without a card) the same check on the card.

Inputs come from numpy seeds; sizes are small.
"""

from __future__ import annotations

import contextlib
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import PartitionSpec as P  # noqa: E402

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.controller import sample_noise as jax_sample_noise  # noqa: E402
from mppi_gpu_tpu.ops.softmin import softmin_weights as jax_softmin_weights  # noqa: E402
from mppi_gpu_tpu.parallel import ShardedMPPIController as JaxShardedController  # noqa: E402
from mppi_gpu_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, _rounding  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import sharded_combine as sc  # noqa: E402
from mppi_gpu_tpu_torch.parallel import ShardedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh  # noqa: E402
from mppi_gpu_tpu_torch.parallel.sharded import softmin_across  # noqa: E402

try:  # jax >= 0.6 exposes shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PM2 = os.path.join(ROOT, "configs", "point_mass2d.yaml")
# K/n on the boundaries of K11's chunk, and the point_mass2d shape's 3000
K_LOCS = (1, 7, 4095, 4096, 4097, 3000)
# λ = 1.1, 1.7 and 0.064: where 1.0f/λ and float32(1/λ) are two floats
LAMS = (1.0, 1.1, 1.7, 0.064, 1e9)
CASES = ("finite", "inf rank", "every rank inf", "underflow")
# against the JAX softmin: η and the weights are float32 sums and quotients
# of float32 exps in another order and by another exp
JAX_RTOL = 1e-6
# the sharded solve against the JAX one on the same ε: the tolerances of
# tests/test_torch_sharded.py (action and u_next rtol 1e-4 atol 1e-6, S rtol
# 1e-5, β rtol 1e-6, η rtol 1e-5)
U_TOL = dict(rtol=1e-4, atol=1e-6)
U32 = 2.0 ** -24  # float32's unit roundoff


def _S(n: int, k_loc: int, lam: float, case: str, seed: int = 0) -> torch.Tensor:
    """chip_smoke.py's costs of K10 and K11 on the CPU: (n, k_loc) from a
    numpy seed, `case` one of CASES (or "nan")."""
    import chip_smoke

    return chip_smoke.softmin_inputs(n, k_loc, lam, case, "cpu", seed)


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: NaN where the other is NaN, with its payload."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@functools.lru_cache(maxsize=None)
def _jax_softmin(n: int):
    """The JAX softmin_weights with an axis name, under shard_map over n CPU
    devices, each holding one rank's row of S: (w (n·K/n,), β, η)."""
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])

    def one_rank(S, lam):
        return tuple(jax_softmin_weights(S.reshape(-1), lam, axis_name="r"))

    return jax.jit(shard_map(one_rank, mesh=mesh, in_specs=(P("r"), P()),
                             out_specs=(P("r"), P(), P())))


# ---------------------------------------------------------------------------
# the plain version against the JAX softmin


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k_loc", K_LOCS)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_softmin_across_matches_the_jax_softmin(n, k_loc, case, lam):
    """``softmin_across`` on n virtual ranks (its η_d in K11's order) against
    the JAX ``softmin_weights`` with pmin and psum over n devices, on the
    same S: β exact, η and every weight within JAX_RTOL; +inf at every rank
    gives β +inf and η, w NaN on both; a rank at +inf or underflowing
    weighs 0 on both."""
    S = _S(n, k_loc, lam, case, seed=n * 100 + k_loc)
    beta, eta, w = softmin_across(S, lam, virtual_mesh(n, "cpu").all_reduce)
    jw, jbeta, jeta = _jax_softmin(n)(jnp.asarray(S.numpy()), jnp.float32(lam))
    assert float(beta) == float(jbeta)
    np.testing.assert_allclose(float(eta), float(jeta), rtol=JAX_RTOL)
    np.testing.assert_allclose(w.reshape(-1).numpy(), np.asarray(jw), rtol=JAX_RTOL, atol=0)
    if case == "every rank inf":
        assert beta == float("inf") and torch.isnan(eta) and torch.isnan(w).all()
    elif case == "inf rank" and n > 1:
        assert (w[-1] == 0).all() and torch.isfinite(w).all()
    elif case == "underflow" and n > 1:
        assert (w[0] == 0).all()


# ---------------------------------------------------------------------------
# K11's order


def _depth(k: int) -> int:
    """The additions on the longest path of K11's order for a row of k: 3 in
    a lane, 10 in the lanes' tree, one per further chunk."""
    return 3 + 10 + sc.row_chunks(k) - 1


@pytest.mark.parametrize("k_loc", K_LOCS + (8193, 20_000))
def test_eta_is_within_its_order_bound_of_the_float64_sum(k_loc):
    """Each η_d of ``softmin_eta_reference`` against the float64 sum of the
    same float32 e_k: |η_d − Σ e| ≤ d·u·Σ e (d the additions on the longest
    path of the order, u = 2⁻²⁴, with 1 % for the products of (1 + u)): the
    bound of a sum of non-negative terms in a fixed tree of that depth."""
    S = _S(3, k_loc, 1.1, "finite", seed=k_loc)
    beta = S.amin()
    eta = sc.softmin_eta_reference(S, beta, 1.1)
    e = torch.exp(-(S - beta) / 1.1).double()
    exact = e.sum(1)
    bound = 1.01 * _depth(k_loc) * U32 * exact
    assert ((eta.double() - exact).abs() <= bound).all()


def _numpy_order(e: np.ndarray) -> np.ndarray:
    """K11's order written out index by index in numpy float32: lane l of
    chunk c adds entries c·4096 + l + 1024·j, j = 0-3, in order (0 past the
    row); the lanes' halving tree; the chunks in order."""
    n, k = e.shape
    out = np.empty(n, np.float32)
    for d in range(n):
        total = None
        for c in range(-(-k // 4096)):
            lane = np.zeros(1024, np.float32)
            for j in range(4):
                idx = c * 4096 + np.arange(1024) + 1024 * j
                x = np.where(idx < k, e[d, np.minimum(idx, k - 1)], np.float32(0))
                lane = x if j == 0 else (lane + x).astype(np.float32)
            h = 512
            while h:
                lane = (lane[:h] + lane[h:2 * h]).astype(np.float32)
                h //= 2
            total = lane[0] if total is None else np.float32(total + lane[0])
        out[d] = total
    return out


@pytest.mark.parametrize("k_loc", K_LOCS + (8193,))
def test_eta_sum_is_the_documented_order(k_loc):
    """``eta_sum`` (torch views and adds) gives the bits of K11's order
    written out index by index in numpy, on rows whose sums depend on it."""
    rng = np.random.default_rng(k_loc)
    e = np.exp(-rng.uniform(0.0, 12.0, (2, k_loc))).astype(np.float32)
    got = sc.eta_sum(torch.from_numpy(e))
    assert np.array_equal(got.numpy().view(np.int32), _numpy_order(e).view(np.int32))


@pytest.mark.parametrize("case", ["inf rank", "every rank inf", "nan"])
def test_softmin_min_is_torch_amin(case):
    """K10's plain version is ``torch.amin`` over each row: +inf where a
    rank's rollouts all cost +inf, NaN where a NaN is present."""
    S = _S(4, 4097, 1.1, case)
    beta_d = sc.softmin_min(S)
    assert _bits(beta_d, torch.amin(S, 1))
    if case == "every rank inf":
        assert (beta_d == float("inf")).all()
    if case == "nan":
        assert torch.isnan(beta_d[0]) and not torch.isnan(beta_d[1:]).any()
    eta = sc.softmin_eta(S, beta_d.amin(), 1.1)
    assert torch.isnan(eta).any() == (case != "inf rank")


# ---------------------------------------------------------------------------
# K5's softmin form


@pytest.mark.parametrize("mode", ["iid", "antithetic", "ou", "injected"])
def test_softmin_form_is_the_w_form_on_torch_weights(mode):
    """``weighted_update`` on (S, β, η, λ) on CPU tensors equals it on the
    weights exp(−(S − β)/λ)/η as torch computes them (``softmin_weights_of``),
    bit for bit, and written into `out` (T·A,) it returns a view of it."""
    sigma, K, T, lam = torch.tensor([0.3, 0.5]), 64, 6, 1.7
    S = _S(1, K, lam, "finite")[0]
    beta = S.amin()
    eta = sc.softmin_eta(S[None], beta, lam)[0]
    anti, ou = mode == "antithetic", 0.5 if mode == "ou" else 0.0
    eps = 0.3 * torch.randn(T, K, 2, generator=torch.Generator().manual_seed(1)) \
        if mode == "injected" else None
    args = (T, K, 9, 2, 1, anti, ou)
    want = fs.weighted_update(sigma, fs.softmin_weights_of((S, beta, eta, lam)), *args, eps=eps,
                              k0=64)
    got = fs.weighted_update(sigma, (S, beta, eta, lam), *args, eps=eps, k0=64)
    assert _bits(got, want)
    rows = torch.zeros(2, T * 2)
    into = fs.weighted_update(sigma, (S, beta, eta, lam), *args, eps=eps, k0=64, out=rows[1])
    assert _bits(rows[1].view(T, 2), want) and into.data_ptr() == rows[1].data_ptr()
    assert (rows[0] == 0).all()


def test_softmin_form_refuses_what_it_cannot_take():
    sigma, K, T = torch.tensor([0.3, 0.5]), 64, 6
    S = _S(1, K, 1.0, "finite")[0]
    beta, eta = S.amin(), torch.tensor(3.0)
    with pytest.raises(ValueError, match="S must have shape"):
        fs.weighted_update(sigma, (S[:-1], beta, eta, 1.0), T, K, 9, 2, 1, False, 0.0)
    with pytest.raises(ValueError, match="beta must have shape"):
        fs.weighted_update(sigma, (S, beta[None], eta, 1.0), T, K, 9, 2, 1, False, 0.0)
    with pytest.raises(TypeError, match="eta must be float32"):
        fs.weighted_update(sigma, (S, beta, eta.double(), 1.0), T, K, 9, 2, 1, False, 0.0)
    with pytest.raises(ValueError, match="out must have shape"):
        fs.weighted_update(sigma, (S, beta, eta, 1.0), T, K, 9, 2, 1, False, 0.0,
                           out=torch.zeros(T * 2 + 1))


# ---------------------------------------------------------------------------
# the two-kernel sharded solve on the fused backend


def _controllers(cfg, n: int):
    """The fused and the eager backend's two-kernel controllers on n virtual
    ranks."""
    out = []
    for backend in ("fused", "eager"):
        c = ShardedMPPIController(cfg, mesh=virtual_mesh(n, "cpu"), onepass=False)
        c.rollout_backend = backend
        out.append(c)
    return out


@pytest.mark.parametrize("mode", ["iid", "antithetic", "ou"])
@pytest.mark.parametrize("n", [2, 4])
def test_fused_two_kernel_solve_equals_the_eager_backend(n, mode):
    """The fused backend's two-kernel solve on CPU tensors (K4 into the
    ranks' rows, K10, the MIN, K11, the SUM, K5's softmin form and K2 into
    the ranks' rows of ΔU, the SUM, K9: every wrapper its plain version) on
    n virtual ranks equals the eager backend's (``softmin_across``, Σ w ε,
    the controller's tail) on the same Philox stream, every output bit for
    bit, over two control steps (K/n a multiple of 32: the eager rollout's
    order of summation)."""
    extra = {"iid": {}, "antithetic": dict(antithetic=True), "ou": dict(noise_beta=0.5)}[mode]
    cfg = load_config(PM2).replace(samples=64 * n, horizon=8, lambda_=1.1, **extra)
    fused, eager = _controllers(cfg, n)
    x, U = torch.tensor([0.2, -0.1, 0.05, 0.0]), fused.init_action_seq() + 0.05
    for step in range(2):
        a = fused.solve(x, U, 5, step)
        b = eager.solve(x, U, 5, step)
        for got, want in zip([a.action, a.u_next, *a.info], [b.action, b.u_next, *b.info]):
            assert _bits(got, want)
        U = a.u_next


@pytest.mark.parametrize("n", [2, 4])
def test_fused_two_kernel_solve_matches_the_jax_sharded_solve(n):
    """The fused backend's two-kernel solve on CPU tensors on n virtual
    ranks, on the JAX sharded solve's per-shard ε (its fold_in keys), equals
    the eager backend's bit for bit and the JAX sharded solve (its scan
    backend: softmin_weights with pmin and psum, then Σ w ε and a psum, the
    two-kernel branch's semantics) within U_TOL (action, u_next), β rtol
    1e-6, η rtol 1e-5, the costs rtol 1e-5 and the weights rtol 1e-4."""
    K, T = 64, 8
    cfg = load_config(PM2).replace(samples=K, horizon=T)
    rng = np.random.default_rng(11)
    x = rng.normal(size=4).astype(np.float32)
    U = (rng.normal(size=(T, 2)) * 0.1).astype(np.float32)
    jcfg = load_jax_config(PM2).replace(samples=K, horizon=T)
    key = jax.random.key(5)
    jres = JaxShardedController(jcfg, mesh=jax_make_mesh(n), rollout_backend="scan").solve(
        jnp.asarray(x), jnp.asarray(U), key)
    sigma = jnp.asarray(jcfg.noise, jnp.float32)
    eps = np.concatenate([np.asarray(jax_sample_noise(jax.random.fold_in(key, d), T, K // n, 2,
                                                      sigma)) for d in range(n)], axis=1)
    fused, eager = _controllers(cfg, n)
    got = fused.solve_with_eps(torch.as_tensor(x), torch.as_tensor(U), torch.as_tensor(eps))
    want = eager.solve_with_eps(torch.as_tensor(x), torch.as_tensor(U), torch.as_tensor(eps))
    for a, b in zip([got.action, got.u_next, *got.info], [want.action, want.u_next, *want.info]):
        assert _bits(a, b)
    np.testing.assert_allclose(got.action.numpy(), np.asarray(jres.action), **U_TOL)
    np.testing.assert_allclose(got.u_next.numpy(), np.asarray(jres.u_next), **U_TOL)
    np.testing.assert_allclose(float(got.info.beta), float(jres.info.beta), rtol=1e-6)
    np.testing.assert_allclose(float(got.info.eta), float(jres.info.eta), rtol=1e-5)
    np.testing.assert_allclose(got.info.costs.numpy(), np.asarray(jres.info.costs), rtol=1e-5)
    np.testing.assert_allclose(got.info.weights.numpy(), np.asarray(jres.info.weights),
                               rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the dispatch to K10 and K11, the C entries stubbed


def _stub(monkeypatch, rc: int = 0):
    """CPU tensors taken for CUDA ones, K10's and K11's entries recorded
    (returning `rc`), the launches counted in a copy of the counts."""
    monkeypatch.setattr(sc, "_LAUNCHES", dict(sc._LAUNCHES))
    calls = {"softmin_min": [], "softmin_eta": []}

    def entry(kernel):
        def call(*args):
            calls[kernel].append(args)
            return rc
        return call

    lib = types.SimpleNamespace(mppi_softmin_min=entry("softmin_min"),
                                mppi_softmin_eta=entry("softmin_eta"))
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


MIN_ARGS = ("S", "n", "k_loc", "beta_d", "scratch", "tickets", "stream")
ETA_ARGS = ("S", "n", "k_loc", "beta", "inv_lam", "eta_d", "scratch", "tickets", "stream")


@pytest.mark.parametrize("k_loc, form", [(1, "block"), (4096, "block"), (4097, "cluster"),
                                         (10_000, "cluster"), (32_768, "cluster"),
                                         (32_769, "ticket"), (1_000_000, "ticket")])
def test_row_form_follows_the_row_chunks(k_loc, form):
    """K10's and K11's form for a row of k_loc entries: one block for one
    chunk, one cluster for 2-8 chunks, a ticket past eight; C is
    ``row_chunks``."""
    assert sc.row_form(k_loc) == (form, sc.row_chunks(k_loc))
    assert sc.row_chunks(k_loc) == -(-k_loc // 4096)


@pytest.mark.parametrize("k_loc", [4096, 4097, 10_000, 32_768, 32_769])
def test_rows_of_more_than_one_block_get_scratch_and_tickets(monkeypatch, k_loc):
    """Device-free: a row of at most 4096 rollouts is one block and a row of
    2-8 chunks one cluster, and K10 and K11 get no scratch and no tickets; a
    row of more than eight chunks gets scratch for its C chunks' values per
    row and the caller's tickets, or new zero tickets; K11 gets
    float32(1/λ); each launch counts once."""
    calls = _stub(monkeypatch)
    n = 3
    S = _S(n, k_loc, 1.7, "finite")
    mine = torch.zeros(n, dtype=torch.int32)
    sc.softmin_min(S, mine)
    sc.softmin_eta(S, S.amin(), 1.7)
    (m,), (e,) = ([dict(zip(names, c)) for c in calls[k]]
                  for k, names in (("softmin_min", MIN_ARGS), ("softmin_eta", ETA_ARGS)))
    assert m["S"] == e["S"] == S.data_ptr() and m["n"] == e["n"] == n
    assert m["k_loc"] == e["k_loc"] == k_loc
    assert e["inv_lam"] == _rounding.scalar_reciprocal(1.7)
    if k_loc <= sc.MAX_CLUSTER * sc.ROW_CHUNK:
        assert m["scratch"] is m["tickets"] is e["scratch"] is e["tickets"] is None
    else:
        assert m["tickets"] == mine.data_ptr() and e["tickets"] not in (None, mine.data_ptr())
        assert m["scratch"] is not None and e["scratch"] is not None
    assert sc.launch_counts()["softmin_min"] == sc.launch_counts()["softmin_eta"] == 1


def test_failed_launch_or_bad_input_raises(monkeypatch):
    """A non-zero return of K10's or K11's entry raises (nothing falls back
    to the plain version); so do costs that are not (n, K/n), float64 costs,
    a β that is not 0-dim and tickets of another shape or type."""
    _stub(monkeypatch, rc=700)
    S = _S(2, 64, 1.0, "finite")
    with pytest.raises(RuntimeError, match="softmin_min failed to launch: cudaError_t 700"):
        sc.softmin_min(S)
    with pytest.raises(RuntimeError, match="softmin_eta failed to launch"):
        sc.softmin_eta(S, S.amin(), 1.0)
    assert sc.launch_counts()["softmin_min"] == sc.launch_counts()["softmin_eta"] == 0
    with pytest.raises(ValueError, match="S is"):
        sc.softmin_min(S.reshape(-1))
    with pytest.raises(TypeError, match="float32"):
        sc.softmin_min(S.double())
    with pytest.raises(ValueError, match="beta"):
        sc.softmin_eta(S, S.amin()[None], 1.0)
    with pytest.raises(ValueError, match="tickets"):
        sc.softmin_min(S, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="tickets"):
        sc.softmin_eta(S, S.amin(), 1.0, torch.zeros(2))


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 27 on CPU tensors, its names and counts


def test_chip_smoke_softmin_check_runs_on_the_cpu():
    """chip_smoke.py's check of K10, K11 and K5's softmin form on CPU
    tensors, where both sides are plain: every case agrees bit for bit (the
    NaN case by where its NaNs are) and nothing launches."""
    import chip_smoke

    got = chip_smoke.check_sharded_softmin(device="cpu", ranks=(1, 4), k_locs=(7, 4097),
                                           lams=(1.1, 0.064), large=None)
    assert got == {"bit_equal": True, "max_abs_err": 0.0, "cases": 2 * 2 * 2 * 5,
                   "launches": {"softmin_min": 0, "softmin_eta": 0, "weighted_update": 0}}


def test_chip_smoke_names_the_softmin_kernels():
    """chip_smoke.py's kernel names (``--sass-diff``, ptxas lines) name K10,
    K11 and K5's softmin form by A and mode; the kernels per two-kernel
    sharded graph cycle: K4, K5 and K2 per local rank, K10, K11 and K9, and
    the three reductions of a virtual mesh, per update; the records per
    update the traces hold."""
    import chip_smoke

    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_118softmin_min_kernelEPKfiPfS2_Pi") == "softmin_min"
    assert chip_smoke.kernel_key(
        "_ZN12_GLOBAL__N_118softmin_eta_kernelEPKfiS1_fPfS2_Pi") == "softmin_eta"
    for c in (0, 1):  # the kernels' forms: a block or a ticket, a cluster
        assert chip_smoke.kernel_key(f"_ZN12_GLOBAL__N_118softmin_min_kernelILb{c}EEEvPKfiPfS3_Pi") \
            == f"softmin_min<cluster={c}>"
        assert chip_smoke.kernel_key(
            f"_ZN12_GLOBAL__N_118softmin_eta_kernelILb{c}EEEvPKfiS2_fPfS3_Pi") \
            == f"softmin_eta<cluster={c}>"
    assert chip_smoke.kernel_key(
        "_ZN12_GLOBAL__N_121softmin_update_kernelILi3ELb0EEEvPKfS2_S2_S2_fS2_PfiNS_11NoiseParamsEPKx"
    ) == "softmin_update<A=3,inj=0>"
    assert chip_smoke.kernel_key(
        "_ZN12_GLOBAL__N_122weighted_update_kernelILi2ELb1EEEvPKfS2_S2_PfiNS_11NoiseParamsEPKx"
    ) == "weighted_update<A=2,inj=1>"
    one, four = virtual_mesh(1, "cpu"), virtual_mesh(4, "cpu")
    assert chip_smoke.sharded_cycle_kernels(one, 1, onepass=False) == 6
    assert chip_smoke.sharded_cycle_kernels(four, 1, onepass=False) == 18
    assert chip_smoke.sharded_cycle_kernels(four, 2, onepass=False) == 36
    assert chip_smoke.sharded_per_update(four, False) == {
        "solve_partials": 4, "softmin_combine": 4, "weighted_update": 0, "softmin_update": 4,
        "softmin_min": 1, "softmin_eta": 1, "sharded_scale": 0, "sharded_tail": 1}
    assert chip_smoke.sharded_per_update(four, False, softmin_kernels=False)["weighted_update"] == 4


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_softmin_kernels_on_the_card():
    """On the card: K10, K11 and K5's softmin form against their plain
    version bit for bit over 1, 2 and 4 ranks, K/n in each row form (a
    block, clusters of 2-8 blocks, a ticket past eight), λ and every case
    (chip_smoke.py --sharded-combine runs them all, and K/n = 10⁶)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K10 and K11 have no CPU mode")
    import chip_smoke

    got = chip_smoke.check_sharded_softmin(
        ranks=(1, 2, 4), k_locs=(7, 4097, 8192, 10_000, 16_384, 32_768, 32_769), lams=(1.1,))
    assert got["bit_equal"] and got["launches"]["softmin_eta"] == got["cases"]
