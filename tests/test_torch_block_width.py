"""K1's two bodies and the rule that picks one: ``ops/fused_solve.block_width``.

The slab body (32 rollouts per block) and the per-rollout body (128) give the
same S bit for bit and partials over blocks of their width; the plain
``block_partials`` takes the same width. On the CPU the wrappers run the
plain versions; these are held against the JAX package's one-pass Pallas
kernel in interpret mode (testmode pseudo-noise, as tests/test_torch_fused.py
runs it) at both widths, and against the eager global softmin. The kernels
themselves run on the card in chip_smoke.py (both bodies at one shape, S
``torch.equal``).
"""

from __future__ import annotations

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.models.point_mass import PointMassLTI as JaxLTI  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu.ops.cost import QuadraticCost as JaxQuadratic  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops.families import FAMILY_NAMES  # noqa: E402

# tests/test_pallas.py's tolerances for the same kernel against the scan path
S_TOL = dict(rtol=3e-5)
DU_TOL = dict(rtol=2e-4, atol=1e-6)
WIDTHS = (fs.SLAB_WIDTH, fs.BLOCK)


@pytest.fixture(autouse=True)
def _no_counted_launches():
    """Launch counts are module state that other test files read as zero."""
    yield
    fs.reset_launch_counts()


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


def _force_width(monkeypatch, width):
    """Every caller of the rule gets `width`: the plain versions then run
    over blocks of `width` rollouts, as the kernel body of that width does."""
    monkeypatch.setattr(fs, "block_width", lambda *args: width)


# ---------------------------------------------------------------------------
# (a) the rule


@pytest.mark.parametrize("R,K,T,A", [
    (1, 1024, 60, 1), (1, 2048, 60, 4), (1, 3000, 50, 2), (1, 10_000, 200, 3),
    (8, 3000, 50, 2), (1, 100_000, 200, 3), (64, 10_000, 200, 3), (1, 100_000, 1000, 3),
    (1, 10_000, 1800, 4), (1, 3001, 50, 2), (1, 20_000, 200, 3), (1, 20_001, 200, 3),
    (8, 1024, 40, 1), (8, 2048, 60, 4),
])
def test_block_width_is_a_pure_function_within_the_slab(R, K, T, A):
    """For every family (and None, the least crossover) the rule returns one
    of the two widths, the same for the same arguments, and the slab width
    only where R·K is at most the family's crossover and the slab fits in a
    block's shared memory; the same R·K gives the same width."""
    assert set(fs.SLAB_MAX_ROLLOUTS) == set(FAMILY_NAMES)
    slab_fits = fs.slab_bytes(T, A) <= fs._SMEM_BYTES
    for name in FAMILY_NAMES + (None,):
        w = fs.block_width(R, K, T, A, name)
        assert w in WIDTHS and w == fs.block_width(R, K, T, A, name)
        assert w == fs.block_width(1, R * K, T, A, name) == fs.block_width(R * K, 1, T, A, name)
        limit = fs.SLAB_MAX_ROLLOUTS[name] if name else min(fs.SLAB_MAX_ROLLOUTS.values())
        assert (w == fs.SLAB_WIDTH) == (R * K <= limit and slab_fits)


def test_slab_bytes_is_the_kernels_layout():
    """One 8-byte mbarrier per 7-step chunk, then U (T·A), the 32 softmin
    weights and the (T, A, 32) slab, in floats: 76.8 KB of slab at T=200,
    A=3, 102.4 KB at A=4; T=1000, A=3 does not fit in 227 KB."""
    assert fs.slab_bytes(200, 3) == 8 * 29 + 4 * (600 + 32 + 32 * 600)
    assert 32 * 200 * 3 * 4 == 76_800 and 32 * 200 * 4 * 4 == 102_400
    assert fs.slab_bytes(200, 4) <= fs._SMEM_BYTES < fs.slab_bytes(1000, 3)


# ---------------------------------------------------------------------------
# (b) the plain version at both widths against the JAX kernel


@functools.lru_cache(maxsize=None)
def _jax_onepass(A, K, T, antithetic=False, ou_beta=0.0):
    """pallas_fused_solve_core in interpret mode (testmode noise): its ε
    (the kernel's host twin, in rollout-rank order), S and ΔU."""
    p = _setup(A, T)
    key = jax.random.key(21)
    plan = pr.make_plan(K, T, A, antithetic=antithetic, ou_beta=ou_beta, testmode=True)
    twin = pr.planar_fake_noise_tensor if plan.planar else pr.fake_noise_tensor
    eps = np.asarray(twin(plan, jnp.asarray(p["sigma"]), ou_beta, key=key))[:, :K]
    cost = JaxQuadratic(**{k: jnp.asarray(p[k]) for k in ("w", "goal", "lambda_", "inv_s")})
    S_j, dU_j = pr.pallas_fused_solve_core(
        JaxLTI.create(0.1, A), cost, jnp.asarray(p["x0"]), jnp.asarray(p["U"]), key,
        jnp.asarray(p["sigma"]), jnp.float32(0.9), K=K, antithetic=antithetic, ou_beta=ou_beta,
        testmode=True, interpret=True,
    )
    return p, eps, np.asarray(S_j)[:K], np.asarray(dU_j)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("A,K,T,antithetic,ou_beta", [
    (2, 300, 12, False, 0.0), (3, 530, 11, False, 0.0),
    (3, 300, 7, False, 0.0), (3, 266, 8, True, 0.0), (3, 300, 9, False, 0.5),
    (3, 300, 17, False, 0.0), (3, 266, 17, True, 0.0), (3, 300, 17, False, 0.5),
], ids=["rowpacked", "planar", "T7", "T8-antithetic-odd-draws", "T9-ou", "T17", "T17-antithetic",
        "T17-ou"])
def test_block_partials_at_each_width_match_pallas_onepass_kernel(A, K, T, antithetic, ou_beta,
                                                                  width):
    """The plain K1 (eager rollout + block_partials over blocks of `width`)
    folded by the plain K2 gives the JAX package's one-pass kernel's S, β
    and ΔU within test_pallas's tolerances, at the slab width and at 128:
    short horizons, K past the block (the pad takes no part), antithetic
    pairs with an odd number of draws (266 rollouts, 133 draws) and OU
    noise; the partials have ceil(K / width) rows."""
    p, eps, S_j, dU_j = _jax_onepass(A, K, T, antithetic, ou_beta)
    args = _port_args(p, K, 0.9, eps)
    fam = fs.lti_family(*args[2:5], 0.1, float(p["lambda_"]))
    S, part = fs.family_solve_partials_reference(fam, args[0], args[1], args[5], 0.9, K, 0, 0, 0,
                                                 False, 0.0, args[-1], width=width)
    assert part.shape == (-(-K // width), 2 + T * A)
    beta, eta, dU = fs.softmin_combine_reference(part, 0.9, T, A)
    np.testing.assert_allclose(S.numpy(), S_j, **S_TOL)
    np.testing.assert_allclose(dU.numpy(), dU_j, **DU_TOL)
    np.testing.assert_allclose(float(beta), float(S_j.min()), rtol=3e-5)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("antithetic,ou_beta,K", [(False, 0.0, 300), (True, 0.5, 1000)])
def test_block_partials_equal_the_global_softmin_at_each_width(monkeypatch, antithetic, ou_beta,
                                                                K, width):
    """Philox mode through the wrapper's plain path at a forced width: the
    partials folded by the combine give the eager path's global softmin on
    the same stream (K not a multiple of either width: the pad takes no
    part), S bit for bit."""
    from mppi_gpu_tpu_torch.controller import sample_noise, solve_from_costs
    from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
    from mppi_gpu_tpu_torch.ops.cost import QuadraticCost
    from mppi_gpu_tpu_torch.ops.rollout import rollout_costs

    _force_width(monkeypatch, width)
    A, T = 3, 15
    p = _setup(A, T)
    args = _port_args(p, K, 1.1, seed=5, step=2, it=1, antithetic=antithetic, ou_beta=ou_beta)
    _, part = fs.lti_solve_partials(*args)
    assert part.shape[0] == -(-K // width)
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


@pytest.mark.parametrize("width", WIDTHS)
def test_diverged_block_and_all_diverged_at_each_width(monkeypatch, width):
    """Block 1 of `width` rollouts driven to +inf gets weight 0 and leaves
    the others' solve intact; when every rollout diverges β = +inf and the
    result is NaN, never a finite action."""
    _force_width(monkeypatch, width)
    A, K, T = 2, 300, 10
    p = _setup(A, T)
    rng = np.random.default_rng(0)
    eps = (0.25 * rng.standard_normal((T, K, A))).astype(np.float32)
    ref = fs.fused_solve(*_port_args(p, K, 1.0, eps))
    eps_bad = eps.copy()
    eps_bad[:, width:2 * width] = 1e30
    S, beta, eta, dU = fs.fused_solve(*_port_args(p, K, 1.0, eps_bad))
    assert torch.isinf(S[width:2 * width]).all()
    keep = np.r_[0:width, 2 * width:K]
    assert torch.equal(S[keep], ref[0][keep])
    w_ok = torch.exp(-(ref[0][keep] - ref[1]) / 1.0)
    dU_keep = torch.einsum("tka,k->ta", torch.as_tensor(eps[:, keep]), w_ok / w_ok.sum())
    np.testing.assert_allclose(float(eta), float(w_ok.sum()), rtol=1e-5)
    np.testing.assert_allclose(dU.numpy(), dU_keep.numpy(), rtol=1e-4, atol=1e-6)
    p_div = dict(p, w=np.full(2 * A, 1e38, np.float32))
    S, beta, eta, dU = fs.fused_solve(*_port_args(p_div, K, 1.0, eps))
    assert torch.isinf(S).all() and float(beta) == float("inf")
    assert torch.isnan(eta) and torch.isnan(dU).all()


# ---------------------------------------------------------------------------
# (c) fleets across the crossover


def _fleet(R, K, T, A=2):
    p = _setup(A, T)
    rng = np.random.default_rng(R)
    xs = torch.as_tensor(np.tile(p["x0"], (R, 1)) + rng.uniform(-0.1, 0.1, (R, 2 * A)).astype(np.float32))
    Us = torch.as_tensor(np.tile(p["U"], (R, 1, 1)))
    goals = torch.as_tensor(np.tile(p["goal"], (R, 1)))
    fam = fs.lti_family(torch.as_tensor(p["sigma"]), torch.as_tensor(p["inv_s"]),
                        torch.as_tensor(p["w"]), 0.1, float(p["lambda_"]))
    return fam, xs, Us, goals


def test_fleet_past_the_crossover_and_its_slices(monkeypatch):
    """A fleet whose R·K passes the crossover runs the per-rollout width
    where each robot alone would run the slab's: its S and β are the solo
    solves' bit for bit, its ΔU to rounding; a slice of the fleet (a rank of
    the sharded fleet) given the fleet's size runs the fleet's width, and
    its robots equal the whole fleet's bit for bit."""
    R, K, T = 4, 200, 6
    monkeypatch.setitem(fs.SLAB_MAX_ROLLOUTS, "lti", 2 * K)
    fam, xs, Us, goals = _fleet(R, K, T)
    seeds = torch.arange(R, dtype=torch.int64) + 11
    args = (0.9, K, seeds, 3, 1, False, 0.0)
    assert fs.block_width(R, K, T, 2, "lti") == fs.BLOCK
    assert fs.block_width(1, K, T, 2, "lti") == fs.SLAB_WIDTH
    _, part = fs.fleet_family_solve_partials(fam, xs, Us, goals, *args)
    assert part.shape[1] == -(-K // fs.BLOCK)
    fleet = fs.fleet_family_fused_solve(fam, xs, Us, goals, *args)
    for r in range(R):
        solo = fs.family_fused_solve(fam, xs[r], Us[r], goals[r], 0.9, K, int(seeds[r]), 3, 1,
                                     False, 0.0)
        assert torch.equal(fleet[0][r], solo[0]) and torch.equal(fleet[1][r], solo[1])
        np.testing.assert_allclose(fleet[3][r].numpy(), solo[3].numpy(), rtol=1e-5, atol=1e-7)
    sl = slice(2, 4)
    alone = fs.fleet_family_solve_partials(fam, xs[sl], Us[sl], goals[sl], 0.9, K, seeds[sl], 3, 1,
                                           False, 0.0)[1]
    assert alone.shape[1] == -(-K // fs.SLAB_WIDTH)
    part_of = fs.fleet_family_fused_solve(fam, xs[sl], Us[sl], goals[sl], 0.9, K, seeds[sl], 3, 1,
                                          False, 0.0, n_robots=R)
    for got, want in zip(part_of, fleet):
        assert torch.equal(got, want[sl])


# ---------------------------------------------------------------------------
# (d) the launcher: the width reaches the C entry, no fallback


def test_launcher_passes_the_width_and_never_falls_back(monkeypatch):
    """Device-free, with the C entry stubbed: the launcher passes the rule's
    width (or the forced one) to ``mppi_solve_partials`` as its last argument
    before the stream and sizes the partials by it, counts the launch under
    its width; a width neither body has is refused before any launch, and a
    launch the entry refuses raises, with nothing run in its place."""
    calls, status = [], [0]
    lib = types.SimpleNamespace(mppi_solve_partials=lambda *a: calls.append(a) or status[0])
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    A, K, T = 3, 1000, 20
    p = _setup(A, T)
    args = _port_args(p, K, 1.0)
    fam = fs.lti_family(*args[2:5], 0.1, 1.0)
    run = functools.partial(fs._launch_solve_partials, fam, args[0], args[1], args[5], 1.0, K, 7,
                            3, 0, False, 0.0, None, 1, ())
    fs.reset_launch_counts()
    S, part = run()
    assert calls[-1][-2:] == (fs.block_width(1, K, T, A, "lti"), 5)
    assert part.shape == (-(-K // fs.SLAB_WIDTH), 2 + T * A)
    S, part = run(width=fs.BLOCK)
    assert calls[-1][-2] == fs.BLOCK and part.shape[0] == -(-K // fs.BLOCK)
    assert fs.width_launch_counts() == {fs.SLAB_WIDTH: 1, fs.BLOCK: 1}
    with pytest.raises(ValueError, match="blocks of 32 or 128"):
        run(width=64)
    status[0] = 98
    with pytest.raises(RuntimeError, match="solve_partials<lti> failed to launch: cudaError_t 98"):
        run()
    assert len(calls) == 3 and fs.launch_counts()["solve_partials"] == 2
