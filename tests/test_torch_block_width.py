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
import ctypes
import functools
import re
import types
from pathlib import Path

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
HEADER = Path(fs.__file__).resolve().parents[1] / "csrc" / "mppi_solve.cuh"


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


RULE_CASES = [
    (1, 1024, 60, 1), (1, 2048, 60, 4), (1, 3000, 50, 2), (1, 10_000, 200, 3),
    (8, 3000, 50, 2), (1, 100_000, 200, 3), (64, 10_000, 200, 3), (1, 100_000, 1000, 3),
    (1, 10_000, 1800, 4), (1, 3001, 50, 2), (1, 20_000, 200, 3), (1, 20_001, 200, 3),
    (8, 1024, 40, 1), (8, 2048, 60, 4),
]


@pytest.mark.parametrize("R,K,T,A", RULE_CASES)
def test_block_width_is_a_pure_function_within_the_slab(R, K, T, A):
    """For every family (and None, the least crossover) the rule returns one
    of the two widths, the same for the same arguments, and the slab width
    only where R·K is at most the family's crossover and the horizon is
    within the rule's limit (``slab_horizon_fits``); the same R·K gives the
    same width."""
    assert set(fs.SLAB_MAX_ROLLOUTS) == set(FAMILY_NAMES)
    slab_fits = fs.slab_horizon_fits(T, A)
    for name in FAMILY_NAMES + (None,):
        w = fs.block_width(R, K, T, A, name)
        assert w in WIDTHS and w == fs.block_width(R, K, T, A, name)
        assert w == fs.block_width(1, R * K, T, A, name) == fs.block_width(R * K, 1, T, A, name)
        limit = fs.SLAB_MAX_ROLLOUTS[name] if name else min(fs.SLAB_MAX_ROLLOUTS.values())
        assert (w == fs.SLAB_WIDTH) == (R * K <= limit and slab_fits)


@pytest.mark.parametrize("R,K,T,A", RULE_CASES)
def test_block_width_keeps_the_former_slab_limit(R, K, T, A):
    """The ring took the slab body's shared memory off the horizon, but the
    rule still picks what it picked when the slab held the whole horizon:
    the horizon limit is that layout's shared memory, one 8-byte mbarrier
    per 7-step chunk, U, 32 weights and the (T, A, 32) slab, within 227 KB
    less 1 KB."""
    former = 8 * -(-T // 7) + 4 * ((32 + 1) * T * A + 32) <= 232448 - 1024
    assert fs.slab_horizon_fits(T, A) == former
    for name in FAMILY_NAMES + (None,):
        limit = fs.SLAB_MAX_ROLLOUTS[name] if name else min(fs.SLAB_MAX_ROLLOUTS.values())
        assert fs.block_width(R, K, T, A, name) == (32 if R * K <= limit and former else 128)


def _constexpr(name: str) -> int:
    """The value of ``constexpr int name = ...;`` in csrc/mppi_solve.cuh,
    its expression evaluated over the header's earlier integer constants."""
    env: dict[str, int] = {}
    for n, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", HEADER.read_text()):
        env[n] = eval(expr.replace("/", "//"), {}, dict(env))
        if n == name:
            return env[n]
    raise KeyError(name)


def test_slab_bytes_is_the_kernels_layout():
    """A full and an empty 8-byte mbarrier per slot of the ring, then U
    (T·A), the second pass's 32 slot weights, 32 slot draws, 32 places and
    a count per warp (8), and the ring of 7-step chunks of A × 32 floats, in
    floats.
    The ring holds every chunk of the horizon where a third of an SM's 228 KB
    (less the runtime's 1 KB a block) holds them, else as many as it holds,
    at least four: 27 of the flagship's 29 (74 KB of 76.8), all 8 of
    point_mass2d's and all 9 of the 3-D quadrotor's, 23 at T=1000. The
    host's constants are the header's."""
    for host, header in ((fs.SLAB_WIDTH, "kSlabRollouts"), (fs.SLAB_THREADS, "kSlabThreads"),
                         (fs.SLAB_RING, "kRing"), (fs._SLAB_CHUNK, "kChunk"),
                         (fs.SLAB_MIN_BLOCKS, "kSlabMinBlocks"),
                         (fs.SLAB_LEAN_STATE, "kSlabLeanState"), (fs._SM_SMEM, "kSmSmem"),
                         (fs._SM_BLOCK_SMEM, "kSmBlockSmem")):
        assert host == _constexpr(header), header
    assert _constexpr("kRingCells") == 4 * 7 * 32
    assert [fs.slab_ring(T, A) for T, A in ((200, 3), (50, 2), (60, 4), (1000, 3), (7, 1))] == [
        27, 8, 9, 23, 4]
    assert fs.slab_bytes(200, 3) == 16 * 27 + 4 * (600 + 3 * 32 + 8 + 27 * 7 * 32 * 3) == 75_824
    for A in range(1, 5):
        for T in (1, 7, 50, 200, 1000, 5000):
            ring = fs.slab_ring(T, A)
            assert ring == max(4, min(-(-T // 7), ring)) and ring >= 4
            assert fs.slab_bytes(T, A) - 16 * ring - 4 * ring * 7 * 32 * A == 4 * (T * A + 104)
            if ring < -(-T // 7) and ring > 4:  # one more slot would pass a third of the SM
                assert fs.slab_bytes(T, A) + 16 + 4 * 7 * 32 * A > 233472 // 3 - 1024
            assert fs.slab_bytes(T, A) <= 233472 // 3 - 1024 or ring == 4


@pytest.mark.parametrize("A", [1, 2, 3, 4])
def test_slab_body_runs_the_flagship_in_one_wave(A):
    """The residency model at the header's constants: the launch bounds
    leave each of the slab body's 256 threads 65536 / (256 · 3) → 80
    registers (a family of at most 8 states), at which an SM holds 3 blocks,
    and the ring leaves shared memory for 3 at every horizon the rule gives
    the slab body, so the flagship's ⌈10⁴ / 32⌉ = 313 blocks take one wave
    on 132 SMs. The former layout's 79 560 B at T=200, A=3 held 2 blocks at
    128 registers: two waves."""
    threads, per_sm = _constexpr("kSlabThreads"), _constexpr("kSlabMinBlocks")
    registers = 65536 // (threads * per_sm) // 8 * 8
    assert registers == 80
    T = max(t for t in range(1, 2000) if fs.slab_horizon_fits(t, A))
    for t in (1, 200, T):
        assert fs.resident_blocks(threads, registers, fs.slab_bytes(t, A)) == per_sm
    nb = -(-10_000 // fs.SLAB_WIDTH)
    assert nb == 313 and fs.waves(nb, per_sm) == 1
    assert fs.resident_blocks(256, 128, 8 * 29 + 4 * (33 * 600 + 32)) == 2
    assert fs.waves(nb, 2) == 2 and fs.waves(264, 2) == 1 and fs.waves(265, 2) == 2


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


def _slab_rows_as_the_kernel_sums(S, eps, lam):
    """ΔŨ_b of blocks of 32 rollouts as csrc/mppi_solve.cuh's ``weigh_rows``
    sums them at 32 slots, one float32 operation at a time: the rollouts
    whose weight is not 0 packed into slots in rollout order, each cell
    e·ε, and each row summed by G = 1 (n ≤ 16) or 2 lanes, lane l adding
    slots l, l + 2G, … and l + G, l + 3G, … in two running sums from 0, the
    second added to the first, then the lanes' sums added. Returns the rows
    and each block's n."""
    f32 = np.float32
    T, K, A = eps.shape
    rows, counts = [], []
    for b in range(-(-K // 32)):
        Sb = torch.as_tensor(S[32 * b:32 * b + 32])
        beta = Sb.min()  # e_k as block_partials forms it: the order is what is held here
        e = torch.zeros(32) if beta == np.inf else torch.exp(-(Sb - beta) / lam)
        e = [f32(w) for w in e.numpy()]
        slots = [j for j, w in enumerate(e) if w != 0]
        n, G = len(slots), 1 if len(slots) <= 16 else 2
        row = np.zeros(T * A, np.float32)
        for r in range(T * A if n else 0):
            t, a = divmod(r, A)
            c = [f32(e[j] * eps[t, 32 * b + j, a]) for j in slots]
            lanes = []
            for lane in range(G):
                total, odd, i = f32(0.0), f32(0.0), lane
                while i + G < n:
                    total, odd, i = f32(total + c[i]), f32(odd + c[i + G]), i + 2 * G
                if i < n:
                    total = f32(total + c[i])
                lanes.append(f32(total + odd))
            row[r] = lanes[0] if G == 1 else f32(lanes[0] + lanes[1])
        rows.append(row)
        counts.append(n)
    return np.stack(rows), counts


@pytest.mark.parametrize("A,K,T,antithetic,ou_beta", [
    (2, 300, 12, False, 0.0), (3, 530, 11, False, 0.0),
    (3, 300, 7, False, 0.0), (3, 266, 8, True, 0.0), (3, 300, 9, False, 0.5),
    (3, 300, 17, False, 0.0), (3, 266, 17, True, 0.0), (3, 300, 17, False, 0.5),
], ids=["rowpacked", "planar", "T7", "T8-antithetic-odd-draws", "T9-ou", "T17", "T17-antithetic",
        "T17-ou"])
def test_slab_partials_sum_in_the_kernels_order(A, K, T, antithetic, ou_beta):
    """At the slab width, block_partials' ΔŨ_b are the slab body's sums bit
    for bit: the weighing rollouts' products e·ε added in ``weigh_rows``'
    order (:func:`_slab_rows_as_the_kernel_sums`) on the JAX one-pass
    kernel's cases, at its λ, where most of a block weighs (two lanes a
    row), and at a λ where few do (one lane); S and β_b as at width 128."""
    p, eps, _, _ = _jax_onepass(A, K, T, antithetic, ou_beta)
    args = _port_args(p, K, 0.9, eps)
    fam = fs.lti_family(*args[2:5], 0.1, float(p["lambda_"]))
    S, _ = fs.family_solve_partials_reference(fam, args[0], args[1], args[5], 0.9, K, 0, 0, 0,
                                              False, 0.0, args[-1], width=fs.SLAB_WIDTH)
    lanes = set()
    for lam in (0.9, 0.002):
        part = fs.block_partials(S, args[-1], lam, fs.SLAB_WIDTH)
        want, n = _slab_rows_as_the_kernel_sums(S.numpy(), np.asarray(eps), lam)
        assert np.array_equal(part[:, 2:].numpy(), want)
        assert torch.equal(part[:, 0], torch.stack([b.min() for b in S.split(32)]))
        lanes |= {1 if m <= 16 else 2 for m in n}
    assert lanes == {1, 2}


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
    """Device-free, with the C entries stubbed: the launcher passes the rule's
    width (or the forced one) to ``mppi_solve_partials`` as its last argument
    before the stream and sizes the partials by it, counts the launch under
    its width and under the waves of its grid, from the residency that
    ``mppi_solve_residency`` reports once per instance (3 blocks per SM on
    132 SMs here); a width neither body has is refused before any launch,
    and a launch the entry refuses raises, with nothing run in its place
    and nothing counted."""
    calls, status, queries = [], [0], []

    def residency(fid, goal, eps, T, A, pass2, width, out, stream):
        queries.append((fid, T, A, pass2, width))
        (ctypes.c_int * 2).from_address(out)[:] = [3, 132]
        return 0

    lib = types.SimpleNamespace(mppi_solve_partials=lambda *a: calls.append(a) or status[0],
                                mppi_solve_residency=residency)
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
    run()
    fid = FAMILY_NAMES.index("lti")
    assert queries == [(fid, T, A, 1, fs.SLAB_WIDTH), (fid, T, A, 1, fs.BLOCK)]
    assert fs.wave_launch_counts() == {1: 3} and fs.wave_launch_counts("rollout_costs") == {}
    Kw = 132 * 3 * fs.SLAB_WIDTH + 1  # one block past a wave
    fs._launch_solve_partials(fam, args[0], args[1], args[5], 1.0, Kw, 7, 3, 0, False, 0.0, None,
                              1, (), width=fs.SLAB_WIDTH)
    assert fs.wave_launch_counts() == {1: 3, 2: 1} and len(queries) == 2
    with pytest.raises(ValueError, match="blocks of 32 or 128"):
        run(width=64)
    status[0] = 98
    with pytest.raises(RuntimeError, match="solve_partials<lti> failed to launch: cudaError_t 98"):
        run()
    assert len(calls) == 5 and fs.launch_counts()["solve_partials"] == 4
    assert fs.wave_launch_counts() == {1: 3, 2: 1}
