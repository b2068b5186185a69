"""K8 ``sharded_scale`` and K9 ``sharded_tail`` on the CPU
(``ops/sharded_combine.py``, their kernels in ``csrc/sharded_combine.cu``):
the one-pass sharded combine's kernel between its two all-reduces and the
sharded controller's tail (the division by η, the tail, the world's step)
after them.

- their plain versions against the torch combine they replace
  (``parallel/sharded.onepass_combine``, ``solve_tail_reference``, the plain
  world loop), bit for bit, over 1, 2 and 4 local ranks, T·A from 12 to
  600, λ where 1.0f/λ and float32(1/λ) agree and where they do not, a rank
  whose rollouts all cost +inf, every rank so, and an f_d that underflows;
  and at the rows on each boundary of K9's row block (T·A 1 to 58112);
- the port's sharded solve on the new path (the fused backend's branch on
  CPU tensors, whose wrappers run their plain versions) on virtual meshes
  of 2 and 4 ranks against the JAX ``sharded_mppi_solve`` on the same
  injected ε, as tests/test_torch_sharded.py holds the eager path;
- ``Mesh.all_reduce`` over a one-entry axis: the entry itself, on the CPU
  and in a gloo group of one, in place unless the caller keeps its input;
- the dispatch with the C entries stubbed (no card needed): the fused
  sharded solve and episode bound for CUDA launch K1, K2 into the ranks'
  rows, K8 and K9, and never the torch combine, K7 or K6;
- chip_smoke.py's checks of phase 27 on CPU tensors (the boundary rows,
  every world body at three horizons), its digests, its kernel names, and
  (marked `gpu`, skipped without a card) K8 and K9 against their plain
  versions on the card.

Inputs come from numpy seeds; sizes are small (K ≤ 256, T ≤ 200, a few
cycles).
"""

from __future__ import annotations

import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.controller import sample_noise as jax_sample_noise  # noqa: E402
from mppi_gpu_tpu.parallel import ShardedMPPIController as JaxShardedController  # noqa: E402
from mppi_gpu_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import CYCLE, FULL  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, _rounding  # noqa: E402
from mppi_gpu_tpu_torch.ops import combine_tail as ct  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import sharded_combine as sc  # noqa: E402
from mppi_gpu_tpu_torch.ops import solve_tail as st  # noqa: E402
from mppi_gpu_tpu_torch.ops import world_step as ws  # noqa: E402
from mppi_gpu_tpu_torch.parallel import ShardedMPPIController, init_multihost, make_mesh  # noqa: E402
from mppi_gpu_tpu_torch.parallel import sharded as shd  # noqa: E402
from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh  # noqa: E402
from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PM2 = os.path.join(ROOT, "configs", "point_mass2d.yaml")
# the sharded solve against the JAX one on the same ε: tests/test_torch_sharded.py's
U_TOL = dict(rtol=1e-4, atol=1e-6)
# λ = 1.1, 1.7 and 0.064: where 1.0f/λ and float32(1/λ) are two floats
LAMS = (1.0, 1.1, 1.7, 0.064, 1e9)
# a rank whose rollouts all cost +inf (its η_d and ΔŨ_d NaN), every rank so,
# and a rank whose f_d = exp(−150) underflows to 0
CASES = ("finite", "inf rank", "every rank inf", "underflow")


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: NaN where the other is NaN, with its payload."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _rows(n: int, T: int, A: int, lam: float, case: str, seed: int = 0):
    """chip_smoke.py's inputs of K8 and K9 on the CPU: the local ranks' rows
    [β_d, η_d, ΔŨ_d] (n, 2 + T·A) from a numpy seed, their costs S flat,
    U (T, A) and max_a (A,); `case` one of CASES."""
    import chip_smoke

    rows, S, U, max_a = chip_smoke.sharded_inputs(n, T, A, lam, case, "cpu", seed)
    return rows, S.reshape(-1), U, max_a


def _advance(A: int, n: int = 4):
    """An ``Advance`` of the point-mass world of A axes from its start,
    histories of n rows, and the counter at 0."""
    cfg = load_config(os.path.join(ROOT, "configs", f"point_mass{A}d.yaml"))
    world = make_world(cfg)
    state = world.reset()
    state = type(state)(*(leaf.clone(memory_format=torch.contiguous_format) for leaf in state))
    adv = ws.Advance(world, state, torch.zeros(n + 1, 2 * A), torch.zeros(n, A), torch.zeros(n),
                     state.x.clone())
    return adv, torch.zeros((), dtype=torch.int64)


# ---------------------------------------------------------------------------
# the plain K8 and K9 against the torch combine


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("T,A", [(6, 2), (50, 2), (200, 3)], ids=["TA12", "TA100", "TA600"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_plain_scale_and_tail_equal_the_torch_combine(n, T, A, lam, case):
    """On n virtual ranks (the MIN and the SUM their reductions): the plain
    K8 then the plain K9 (the division, ``solve_tail_reference``, the plain
    world loop) give β, η, ΔU, every output with the weights, and in the
    cycle's form U shifted in place and the world's state, histories, x and
    counter, bit for bit as ``onepass_combine`` + ``solve_tail_reference``
    + the plain world loop do; with every rank +inf, β is +inf and η, ΔU
    NaN, as on one GPU; a rank at +inf or an underflowing f_d adds
    nothing."""
    rows, S, U, max_a = _rows(n, T, A, lam, case, seed=n * 1000 + T)
    reduce = virtual_mesh(n, "cpu").all_reduce
    beta = reduce(rows[:, 0], "min", keep=True)
    sums = reduce(sc.sharded_scale(rows, beta, lam), "sum")
    dU, full = sc.sharded_tail(U, sums, max_a, True, FULL, (S, beta, sums[0], lam), divide=True)
    b_t, e_t, dU_t = shd.onepass_combine(rows[:, 0].contiguous(), rows[:, 1].contiguous(),
                                         rows[:, 2:].reshape(n, T, A), lam, reduce)
    want = st.solve_tail_reference(U, dU_t, max_a, True, FULL, (S, b_t, e_t, lam))
    for got, exp in [(beta, b_t), (sums[0], e_t), (dU, dU_t)] + [
            (getattr(full, k), getattr(want, k)) for k in FULL]:
        assert _bits(got, exp)
    if case == "every rank inf":
        assert beta == float("inf") and torch.isnan(sums[0]) and torch.isnan(dU).all()
    elif case == "inf rank" and n > 1:
        assert torch.isfinite(dU).all() and torch.isfinite(sums).all()
    adv, step = _advance(A)
    adv_t, step_t = _advance(A)
    U_c, U_t = U.clone(), U.clone()
    _, cyc = sc.sharded_tail(U_c, sums, max_a, True, CYCLE, into=U_c, divide=True, step=step,
                             advance=adv)
    tail = st.solve_tail_reference(U_t, dU_t, max_a, True, CYCLE, into=U_t)
    ws.plain_advance_into(adv_t.world, adv_t.state, tail.action, adv_t.xs, adv_t.us, adv_t.ts,
                          step_t, adv_t.x)
    assert _bits(U_c, U_t) and _bits(cyc.action, tail.action)
    for a, b in zip([*adv.state, adv.xs, adv.us, adv.ts, adv.x, step],
                    [*adv_t.state, adv_t.xs, adv_t.us, adv_t.ts, adv_t.x, step_t]):
        assert torch.equal(a, b) if a.dtype == torch.int64 else _bits(a, b)
    assert int(step) == 1


def _world_advance(A: int, n: int = 4):
    """An ``Advance`` of a world of A actions (the point mass of A axes, the
    3-D quadrotor for A = 4) from its start, histories of n rows, and the
    counter at 0."""
    if A < 4:
        return _advance(A, n)
    world = _world_of_kind("quadrotor3d")
    state = world.reset()
    state = type(state)(*(leaf.clone(memory_format=torch.contiguous_format) for leaf in state))
    S = state.x.shape[-1]
    adv = ws.Advance(world, state, torch.zeros(n + 1, S), torch.zeros(n, A), torch.zeros(n),
                     state.x.clone())
    return adv, torch.zeros((), dtype=torch.int64)


def _edge_shapes():
    import chip_smoke

    return chip_smoke.SHARDED_EDGE_SHAPES


@pytest.mark.parametrize("divide", [True, False], ids=["divide", "given-dU"])
@pytest.mark.parametrize("T,A", _edge_shapes(), ids=[f"TA{T * A}" for T, A in _edge_shapes()])
def test_plain_tail_at_the_row_block_boundaries(T, A, divide):
    """At the rows on each boundary of K9's row block (T·A 1, 31-33,
    255-257, 1023-1025, 2049, past 48 KB and the largest, 58112): the plain
    K9 gives ΔU, every output with the weights, and in the cycle's form U
    shifted in place and the world's state, histories, x and counter (a
    world of A actions), bit for bit as the torch combine (with `divide`),
    K7's plain tail and K6's plain step do, one after the other."""
    n = 2
    rows, S, U, max_a = _rows(n, T, A, 1.1, "finite", seed=T * A)
    reduce = virtual_mesh(n, "cpu").all_reduce
    beta = reduce(rows[:, 0], "min", keep=True)
    sums = reduce(sc.sharded_scale(rows, beta, 1.1), "sum")
    b_t, e_t, dU_t = shd.onepass_combine(rows[:, 0].contiguous(), rows[:, 1].contiguous(),
                                         rows[:, 2:].reshape(n, T, A), 1.1, reduce)
    dU_in = sums if divide else dU_t
    softmin = (S, b_t, e_t, 1.1)
    dU, full = sc.sharded_tail(U, dU_in, max_a, True, FULL, softmin, divide=divide)
    want = st.solve_tail_reference(U, dU_t, max_a, True, FULL, softmin)
    assert _bits(dU, dU_t)
    for k in FULL:
        assert _bits(getattr(full, k), getattr(want, k))
    adv, step = _world_advance(A)
    adv_t, step_t = _world_advance(A)
    U_c, U_t = U.clone(), U.clone()
    for cycle in range(2):
        _, cyc = sc.sharded_tail(U_c, dU_in, max_a, True, CYCLE, into=U_c, divide=divide,
                                 step=step, advance=adv)
        tail = st.solve_tail_reference(U_t, dU_t, max_a, True, CYCLE, into=U_t)
        ws.plain_advance_into(adv_t.world, adv_t.state, tail.action, adv_t.xs, adv_t.us, adv_t.ts,
                              step_t, adv_t.x)
        assert _bits(U_c, U_t) and _bits(cyc.action, tail.action)
        for a, b in zip([*adv.state, adv.xs, adv.us, adv.ts, adv.x, step],
                        [*adv_t.state, adv_t.xs, adv_t.us, adv_t.ts, adv_t.x, step_t]):
            assert torch.equal(a, b) if a.dtype == torch.int64 else _bits(a, b)
        assert int(step) == cycle + 1


@pytest.mark.parametrize("divide", [True, False], ids=["divide", "given-dU"])
def test_plain_tail_keeps_dU_and_refuses_what_it_cannot_compute(divide):
    """The plain K9 returns ΔU (Σ/η with `divide`, else the given ΔU) and
    the outputs asked for, None for the others; it refuses the weights
    without (S, β, η, λ), `into` without u_next, a world step without the
    action or without a counter tensor."""
    rows, S, U, max_a = _rows(2, 5, 2, 1.1, "finite")
    sums = rows[0, 1:].clone() if divide else rows[0, 2:].reshape(5, 2).clone()
    dU, tail = sc.sharded_tail(U, sums, max_a, False, ("u_seq",), divide=divide)
    assert _bits(dU, sums[1:].view(5, 2) / sums[0] if divide else sums)
    assert _bits(tail.u_seq, U + dU) and tail.u_next is None and tail.weights is None
    with pytest.raises(ValueError, match="weights"):
        sc.sharded_tail(U, sums, max_a, True, FULL, divide=divide)
    with pytest.raises(ValueError, match="into"):
        sc.sharded_tail(U, sums, max_a, True, ("u_seq",), into=U, divide=divide)
    adv, step = _advance(2)
    with pytest.raises(ValueError, match="action"):
        sc.sharded_tail(U, sums, max_a, True, ("u_seq",), divide=divide, step=step, advance=adv)
    with pytest.raises(TypeError, match="counter"):
        sc.sharded_tail(U, sums, max_a, True, CYCLE, divide=divide, step=0, advance=adv)
    with pytest.raises(ValueError, match="one robot"):
        sc.sharded_tail(U[None], sums, max_a, True, CYCLE, divide=divide)


# ---------------------------------------------------------------------------
# the new path against the JAX sharded solve


@pytest.mark.parametrize("onepass", [True, False], ids=["one-pass", "two-kernel"])
@pytest.mark.parametrize("n", [2, 4])
def test_new_path_matches_the_jax_sharded_solve(n, onepass):
    """The fused backend's sharded solve on CPU tensors (K1, K2 into the
    ranks' rows, the MIN, K8, the SUM, K9; the two-kernel branch's K4, K5
    and K9, every wrapper its plain version) on a virtual mesh of n ranks,
    on the JAX sharded solve's per-shard ε (its fold_in keys, as
    tests/test_torch_sharded.py rebuilds them): action and u_next within
    U_TOL, β rtol 1e-6, η rtol 1e-5 and each rank's costs its slice of the
    JAX costs within rtol 1e-5."""
    K, T = 64, 8
    cfg = load_config(PM2).replace(samples=K, horizon=T)
    rng = np.random.default_rng(3)
    x = rng.normal(size=4).astype(np.float32)
    U = (rng.normal(size=(T, 2)) * 0.1).astype(np.float32)
    jcfg = load_jax_config(PM2).replace(samples=K, horizon=T)
    key = jax.random.key(7)
    jres = JaxShardedController(jcfg, mesh=jax_make_mesh(n), rollout_backend="scan").solve(
        jnp.asarray(x), jnp.asarray(U), key)
    sigma = jnp.asarray(jcfg.noise, jnp.float32)
    eps = np.concatenate([np.asarray(jax_sample_noise(jax.random.fold_in(key, d), T, K // n, 2,
                                                      sigma)) for d in range(n)], axis=1)
    ctrl = ShardedMPPIController(cfg, mesh=virtual_mesh(n, "cpu"), onepass=onepass)
    ctrl.rollout_backend = "fused"
    got = ctrl.solve_with_eps(torch.as_tensor(x), torch.as_tensor(U), torch.as_tensor(eps))
    np.testing.assert_allclose(got.action.numpy(), np.asarray(jres.action), **U_TOL)
    np.testing.assert_allclose(got.u_next.numpy(), np.asarray(jres.u_next), **U_TOL)
    np.testing.assert_allclose(float(got.info.beta), float(jres.info.beta), rtol=1e-6)
    np.testing.assert_allclose(float(got.info.eta), float(jres.info.eta), rtol=1e-5)
    np.testing.assert_allclose(got.info.costs.numpy(), np.asarray(jres.info.costs), rtol=1e-5)
    np.testing.assert_allclose(got.info.weights.numpy(), np.asarray(jres.info.weights),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("onepass", [True, False], ids=["one-pass", "two-kernel"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_new_path_equals_the_torch_combine_cycle(n, onepass):
    """On CPU tensors the new path (K8 and K9's plain versions) and the
    torch combine forced (``_torch_combine``: ``onepass_combine``, K7's and
    K6's plain versions) give the same solve, every output bit for bit, and
    the same episode (chip_smoke.py's check, which on the card holds the
    kernels to it)."""
    import chip_smoke

    got = chip_smoke.check_sharded_episode_combine("point_mass2d", virtual_mesh(n, "cpu"), onepass,
                                                   device="cpu", steps=3)
    assert got["episode_cycles"] == 3 and got["launches"] == {"new": {}, "old": {}}


# ---------------------------------------------------------------------------
# Mesh.all_reduce over one entry


@pytest.mark.parametrize("op", ["min", "sum"])
def test_one_entry_all_reduce_is_the_entry_on_a_virtual_mesh(op):
    """A virtual mesh of one: the reduction over the one-entry axis is the
    entry, a view of it (no kernel), equal to what ``amin(0)``/``sum(0)``
    gave, inf and NaN included; ``keep`` changes nothing without a
    collective."""
    t = torch.tensor([[3.0, -1.5, float("inf"), float("nan"), 0.25]])
    want = t.amin(0) if op == "min" else t.sum(0)
    mesh = virtual_mesh(1, "cpu")
    for keep in (False, True):
        got = mesh.all_reduce(t, op, keep=keep)
        assert _bits(got, want) and got.data_ptr() == t.data_ptr()


def test_one_entry_all_reduce_in_a_gloo_group_of_one(tmp_path):
    """A real rank in a gloo group of one: the collective runs in place on
    the entry, in the input's own storage (the result a view of it), with
    the values ``amin(0)``/``sum(0)`` gave; with ``keep`` on a copy, the
    input untouched. The one-pass solve on that rank (the new path's plain
    versions) is the virtual mesh of one's, bit for bit."""
    init_multihost("file://" + str(tmp_path / "init"), 1, 0, backend="gloo")
    try:
        mesh = make_mesh("cpu")
        assert mesh.grouped and mesh.size == 1
        for op in ("min", "sum"):
            t = torch.tensor([[3.0, -1.5, float("inf"), float("nan"), 0.25]])
            before = t.clone()
            want = before.amin(0) if op == "min" else before.sum(0)
            kept = mesh.all_reduce(t, op, keep=True)
            assert _bits(kept, want) and kept.data_ptr() != t.data_ptr() and _bits(t, before)
            got = mesh.all_reduce(t, op)
            assert _bits(got, want) and got.data_ptr() == t.data_ptr()
        cfg = load_config(PM2).replace(samples=128, horizon=8)
        x, results = torch.tensor([0.2, -0.1, 0.05, 0.0]), []
        for m in (mesh, virtual_mesh(1, "cpu")):
            ctrl = ShardedMPPIController(cfg, mesh=m)
            ctrl.rollout_backend = "fused"
            res = ctrl.solve(x, ctrl.init_action_seq(), 3, 2)
            results.append([res.action, res.u_next, *res.info])
        assert all(_bits(a, b) for a, b in zip(*results))
    finally:
        shutdown_multihost()


# ---------------------------------------------------------------------------
# the dispatch to K8 and K9, the C entries stubbed


def _world_of_kind(kind: str):
    name = {"point_mass1": "point_mass1d", "point_mass2": "point_mass2d",
            "point_mass3": "point_mass3d"}.get(kind, kind)
    return make_world(load_config(os.path.join(ROOT, "configs", f"{name}.yaml")))


def _stub(monkeypatch, rc: int = 0, failing: str = "sharded_scale"):
    """CPU tensors taken for CUDA ones, every C entry recorded (returning
    `rc` for the kernel `failing`; K6's layout the source's), the launches
    counted in copies of the counts, and ``onepass_combine`` made to
    raise."""
    for mod in (fs, st, ct, sc):
        monkeypatch.setattr(mod, "_LAUNCHES", dict(mod._LAUNCHES))
    monkeypatch.setattr(ws, "_LAUNCHES", dict(ws._LAUNCHES))
    monkeypatch.setattr(ws, "_CHECKED", set())
    monkeypatch.setattr(fs, "_FAMILY_LAUNCHES", {k: dict(v) for k, v in fs._FAMILY_LAUNCHES.items()})
    monkeypatch.setattr(fs, "_WIDTH_LAUNCHES", {k: dict(v) for k, v in fs._WIDTH_LAUNCHES.items()})
    calls = {k: [] for k in ("solve_partials", "softmin_combine", "weighted_update", "solve_tail",
                             "combine_tail", "world_advance", "sharded_scale", "sharded_tail",
                             "softmin_min", "softmin_eta")}

    def entry(kernel):
        def call(*args):
            calls[kernel].append(args)
            return rc if kernel == failing else 0
        return call

    def layout(wid, widths, n_params, a):
        kind = next(k for k, v in ws.WORLDS.items() if v[0] == wid)
        _, shapes, A, _ = ws.WORLDS[kind]
        for i, shape in enumerate(shapes):
            widths[i] = int(np.prod(shape))
        n_params._obj.value = ws.pack(_world_of_kind(kind)).numel()
        a._obj.value = A
        return len(shapes)

    def combine(*args, **kwargs):
        raise AssertionError("the fused sharded path ran onepass_combine")

    lib = types.SimpleNamespace(mppi_world_layout=layout, mppi_solve_residency=lambda *a: 0,
                                **{f"mppi_{k}": entry(k) for k in calls})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(st, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ws, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(shd, "onepass_combine", combine)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


# the C entries' arguments, by name (csrc/sharded_combine.cu; K2's in mppi_solve.cu)
SCALE_ARGS = ("rows", "n", "TA", "beta", "inv_lam", "out", "stream")
TAIL_ARGS = ("U", "dU", "divide", "max_a", "clamp", "u_seq", "u_next", "action", "dU_out", "S",
             "beta", "eta", "inv_lam", "weights", "T", "A", "K", "tickets", "world")
COMBINE_ARGS = ("partials", "R", "nb", "TA", "lam", "normalize", "beta_eta", "dU", "stream")
UPDATE_ARGS = ("sigma", "w", "eps", "partials", "K", "T", "A", "key0", "key1", "step", "it", "k0",
               "antithetic", "ou_beta", "ou_c", "step_ptr", "S", "beta", "eta", "inv_lam", "stream")
MIN_ARGS = ("S", "n", "k_loc", "beta_d", "scratch", "tickets", "stream")
ETA_ARGS = ("S", "n", "k_loc", "beta", "inv_lam", "eta_d", "scratch", "tickets", "stream")


@pytest.mark.parametrize("onepass", [True, False], ids=["one-pass", "two-kernel"])
@pytest.mark.parametrize("n", [1, 4])
def test_fused_sharded_path_on_cuda_launches_k8_and_k9(monkeypatch, n, onepass):
    """Device-free: the fused sharded solve bound for CUDA (``solve`` every
    output, then ``solve_in_place`` with the point mass's ``Advance``, the
    episode's cycle) launches per update K1 (or K4 and K5) and K2 once per
    local rank, K8 once (one-pass), or K10 and K11 once (two-kernel), and
    K9 once, and never ``onepass_combine``, K7, K6 or K2'. Both branches
    write each rank's S into its row of one buffer (K1 or K4). One-pass: K2,
    unnormalized, writes each rank's [β_d, η_d, ΔŨ_d] into its row of one
    (n, 2 + T·A) buffer, which K8 reads. Two-kernel: K10 and K11 read that
    S buffer (n rows of K/n) and K11 takes K10's β, after the MIN; K5 runs
    in its softmin form (no w: each rank's row of S, β, η after the SUM and
    float32(1/λ)); K2 folds each rank's K5 rows into its row of one
    (n, T·A) buffer. K9 divides (the two-kernel branch's does not),
    computes the weights with float32(1/λ) for ``solve``, writes the
    shifted sequence over U in the cycle and steps the world there, with
    the controller's tickets."""
    calls = _stub(monkeypatch)
    T = 8
    cfg = load_config(PM2).replace(samples=32 * n, horizon=T, lambda_=1.1)
    ctrl = ShardedMPPIController(cfg, mesh=virtual_mesh(n, "cpu"), onepass=onepass)
    ctrl.rollout_backend = "fused"
    x, U = torch.zeros(4), ctrl.init_action_seq()
    ctrl.solve(x, U, 7, torch.tensor(2), capture=False)
    adv, step = _advance(2)
    ctrl.solve_in_place(x, U, 7, step, adv)
    assert not (calls["solve_tail"] or calls["world_advance"] or calls["combine_tail"])
    assert len(calls["solve_partials"]) == len(calls["softmin_combine"]) == 2 * n
    assert len(calls["weighted_update"]) == (0 if onepass else 2 * n)
    assert len(calls["sharded_scale"]) == (2 if onepass else 0)
    tails = [dict(zip(TAIL_ARGS, c)) for c in calls["sharded_tail"]]
    assert len(tails) == 2 and all(t["divide"] == int(onepass) for t in tails)
    full, cyc = tails
    assert full["weights"] is not None and full["K"] == cfg.samples and full["world"] == -1
    assert full["inv_lam"] == _rounding.scalar_reciprocal(1.1)
    assert cyc["weights"] is None and cyc["u_next"] == U.data_ptr() and cyc["world"] == 1
    assert cyc["tickets"] == ctrl._tickets.data_ptr() and cyc["divide"] == int(onepass)
    assert sc.launch_counts() == {"sharded_scale": 2 if onepass else 0, "sharded_tail": 2,
                                  "softmin_min": 0 if onepass else 2,
                                  "softmin_eta": 0 if onepass else 2}
    S_ptrs = [c[8] for c in calls["solve_partials"]]  # S, the entry's 9th argument
    for update in (S_ptrs[:n], S_ptrs[n:]):
        assert update == [update[0] + 4 * d * 32 for d in range(n)]
    if not onepass:
        mins = [dict(zip(MIN_ARGS, c)) for c in calls["softmin_min"]]
        etas = [dict(zip(ETA_ARGS, c)) for c in calls["softmin_eta"]]
        assert [m["S"] for m in mins] == [e["S"] for e in etas] == S_ptrs[::n]
        assert all(m["n"] == e["n"] == n and m["k_loc"] == e["k_loc"] == 32
                   for m, e in zip(mins, etas))
        assert all(e["inv_lam"] == _rounding.scalar_reciprocal(1.1) for e in etas)
        # one row of 32 rollouts is one block: no scratch, no ticket
        assert all(c["scratch"] is None and c["tickets"] is None for c in mins + etas)
        if n == 1:  # the MIN of one local entry is K10's β_d itself
            assert [e["beta"] for e in etas] == [m["beta_d"] for m in mins]
        updates = [dict(zip(UPDATE_ARGS, c)) for c in calls["weighted_update"]]
        assert all(u["w"] is None and u["inv_lam"] == _rounding.scalar_reciprocal(1.1)
                   for u in updates)
        assert [u["S"] for u in updates] == S_ptrs
        for i, e in enumerate(etas):
            assert all(u["beta"] == e["beta"] for u in updates[i * n:(i + 1) * n])
            if n == 1:  # the SUM of one local entry is K11's η_d itself
                assert updates[i]["eta"] == e["eta_d"]
        combines = [dict(zip(COMBINE_ARGS, c)) for c in calls["softmin_combine"]]
        for update in (combines[:n], combines[n:]):
            rows = update[0]["dU"]
            assert [c["dU"] for c in update] == [rows + 4 * d * T * 2 for d in range(n)]
            assert all(c["normalize"] == 0 for c in update)
        # one local rank's SUM is its row itself (no kernel): K9 reads it
        assert all((t["dU"] == c[0]["dU"]) == (n == 1)
                   for t, c in zip(tails, (combines[:n], combines[n:])))
    if onepass:
        combines = [dict(zip(COMBINE_ARGS, c)) for c in calls["softmin_combine"]]
        row = 4 * (2 + T * 2)
        for update in (combines[:n], combines[n:]):
            rows = update[0]["beta_eta"]
            assert [c["beta_eta"] for c in update] == [rows + d * row for d in range(n)]
            assert all(c["dU"] == c["beta_eta"] + 8 and c["normalize"] == 0 for c in update)
        scales = [dict(zip(SCALE_ARGS, c)) for c in calls["sharded_scale"]]
        assert [s["rows"] for s in scales] == [combines[0]["beta_eta"], combines[n]["beta_eta"]]
        assert all(s["n"] == n and s["TA"] == T * 2 for s in scales)
        # one local rank's SUM is its row itself (no kernel); four ranks' a new sum
        assert all((t["dU"] == s["out"]) == (n == 1) for t, s in zip(tails, scales))


def test_failed_or_refused_launch_raises(monkeypatch):
    """A non-zero return of K8's or K9's entry raises (nothing falls back to
    the torch combine or the plain versions); so do rows without a ΔŨ
    column, a float64 row, a β that is not 0-dim, a ΔU sum of another
    length, and a world step without the controller's tickets."""
    calls = _stub(monkeypatch, rc=700)
    rows, S, U, max_a = _rows(2, 4, 2, 1.0, "finite")
    beta = rows[:, 0].amin(0)
    with pytest.raises(RuntimeError, match="sharded_scale failed to launch: cudaError_t 700"):
        sc.sharded_scale(rows, beta, 1.0)
    assert len(calls["sharded_scale"]) == 1 and sc.launch_counts()["sharded_scale"] == 0
    with pytest.raises(ValueError, match="rows"):
        sc.sharded_scale(rows[:, :2].contiguous(), beta, 1.0)
    with pytest.raises(TypeError, match="float32"):
        sc.sharded_scale(rows.double(), beta, 1.0)
    with pytest.raises(ValueError, match="beta"):
        sc.sharded_scale(rows, beta[None], 1.0)
    with pytest.raises(ValueError, match="dU"):
        sc.sharded_tail(U, rows[0, 2:].contiguous(), max_a, True, CYCLE, divide=True)
    adv, step = _advance(2)
    with pytest.raises(ValueError, match="ticket"):
        sc.sharded_tail(U, rows[0, 1:].contiguous(), max_a, True, CYCLE, divide=True, step=step,
                        advance=adv)
    _stub(monkeypatch, rc=700, failing="sharded_tail")
    with pytest.raises(RuntimeError, match="sharded_tail failed to launch"):
        sc.sharded_tail(U, rows[0, 1:].contiguous(), max_a, True, CYCLE, divide=True)


@pytest.mark.parametrize("capturing", [False, True])
def test_only_a_launch_that_runs_is_counted(monkeypatch, capturing):
    """While the stream captures a CUDA graph the entries are called (the
    graph records the launches) but nothing is counted."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    rows, S, U, max_a = _rows(2, 4, 2, 1.0, "finite")
    sc.sharded_scale(rows, rows[:, 0].amin(0), 1.0)
    sc.sharded_tail(U, rows[0, 1:].contiguous(), max_a, True, CYCLE, divide=True)
    sc.softmin_min(S.view(2, -1))
    sc.softmin_eta(S.view(2, -1), rows[:, 0].amin(0), 1.0)
    assert all(len(calls[k]) == 1 for k in sc.launch_counts())
    assert sc.launch_counts() == dict.fromkeys(
        ("sharded_scale", "sharded_tail", "softmin_min", "softmin_eta"), 0 if capturing else 1)


def test_a_world_without_a_body_steps_after_k9(monkeypatch):
    """A world from user code (no K6 body) steps after K9, in its own torch
    ops: K9 gets no world (id −1), and the plain cycle runs on its action."""
    from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld

    class UserWorld(PointMassWorld):
        pass

    calls = _stub(monkeypatch)
    seen = []
    monkeypatch.setattr(ws, "advance_after", lambda adv, u, step: seen.append((adv, u, step)))
    adv, step = _advance(2)
    adv = adv._replace(world=UserWorld(adv.world.params))
    rows, S, U, max_a = _rows(1, 4, 2, 1.0, "finite")
    _, tail = sc.sharded_tail(U, rows[0, 1:].contiguous(), max_a, True, CYCLE, into=U, divide=True,
                              step=step, advance=adv)
    (args,) = calls["sharded_tail"]
    assert dict(zip(TAIL_ARGS, args))["world"] == -1
    assert seen == [(adv, tail.action, step)]


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 27 on CPU tensors, and its kernel names


def test_chip_smoke_sharded_combine_check_runs_on_the_cpu():
    """chip_smoke.py's K8/K9 check on CPU tensors, where both sides are the
    plain versions: every case agrees bit for bit and nothing launches."""
    import chip_smoke

    got = chip_smoke.check_sharded_combine(device="cpu", ranks=(1, 4), shapes=((6, 2), (200, 3)),
                                           lams=(1.1, 0.064))
    assert got == {"bit_equal": True, "max_abs_err": 0.0, "cases": 32,
                   "launches": {"sharded_scale": 0, "sharded_tail": 0}}


def test_chip_smoke_sharded_edge_check_runs_on_the_cpu():
    """chip_smoke.py's K8/K9 check over the rows on the boundaries of K9's
    row block (SHARDED_EDGE_SHAPES, one and four ranks), on CPU tensors:
    every case agrees bit for bit and nothing launches."""
    import chip_smoke

    got = chip_smoke.check_sharded_combine(device="cpu", ranks=chip_smoke.SHARDED_EDGE_RANKS,
                                           shapes=chip_smoke.SHARDED_EDGE_SHAPES,
                                           lams=chip_smoke.SHARDED_EDGE_LAMS,
                                           cases=chip_smoke.SHARDED_EDGE_CASES)
    assert got == {"bit_equal": True, "max_abs_err": 0.0, "cases": 52,
                   "launches": {"sharded_scale": 0, "sharded_tail": 0}}


@pytest.mark.parametrize("name", ["point_mass1d", "point_mass2d", "point_mass3d", "pendulum",
                                  "cartpole", "unicycle", "quadrotor", "quadrotor3d", "arm"])
def test_chip_smoke_sharded_tail_world_check_runs_on_the_cpu(name):
    """chip_smoke.py's check of K9's world step against the plain cycle and
    K7 + K6, on CPU tensors (every side plain), for every world body at
    each of its horizons (the config's, T = 1 and a row of two passes):
    bit-equal over its chained cycles."""
    import chip_smoke

    assert chip_smoke.check_sharded_tail_world(name, device="cpu")


def test_chip_smoke_sharded_digests_run_on_the_cpu():
    """chip_smoke.py's digests of K8's and K9's outputs (``--time-commit``),
    on CPU tensors: one per shape, rank count and case and one per world
    body and horizon, the same on a second run."""
    import chip_smoke

    got = chip_smoke.sharded_digests("cpu")
    shapes = chip_smoke.SHARDED_SHAPES + chip_smoke.SHARDED_EDGE_SHAPES
    assert len(got) == 2 * len(shapes) * 2 + 9 * len(chip_smoke.SHARDED_WORLD_HORIZONS)
    assert got == chip_smoke.sharded_digests("cpu")


def test_chip_smoke_names_the_sharded_kernels():
    """chip_smoke.py's kernel names (``--sass-diff``, ptxas lines) tell K9's
    instances apart by world body and division, and name K8; the kernels per
    one-pass sharded graph cycle: K1 and K2 per local rank, K8 and K9, and
    the two reductions of a virtual mesh."""
    import chip_smoke

    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_120sharded_scale_kernelEPKfS1_fiPf") == "sharded_scale"
    assert chip_smoke.kernel_key(
        "_ZN12_GLOBAL__N_119sharded_tail_kernelINS_5world9PointMassILi3EEELb1EEEvNS_15ShardedTailArgsE"
    ) == "sharded_tail<PointMass3,divide=1>"
    assert chip_smoke.kernel_key(
        "_ZN12_GLOBAL__N_119sharded_tail_kernelINS_7NoWorldELb0EEEvNS_15ShardedTailArgsE"
    ) == "sharded_tail<NoWorld,divide=0>"
    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_117solve_tail_kernelENS_8TailArgsE") == "solve_tail"
    assert chip_smoke.sharded_cycle_kernels(virtual_mesh(1, "cpu"), 1) == 4
    assert chip_smoke.sharded_cycle_kernels(virtual_mesh(4, "cpu"), 1) == 12
    assert chip_smoke.sharded_cycle_kernels(virtual_mesh(4, "cpu"), 2) == 24


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_sharded_kernels_on_the_card():
    """On the card: K8 and K9 against their plain versions and the torch
    combine, bit for bit, at a few shapes and at the rows on the boundaries
    of K9's row block (chip_smoke.py --sharded-combine runs every case);
    K9's world step for the point mass and the 3-D quadrotor at three
    horizons; the sharded episode on four virtual ranks equal to the
    torch-combine cycle in both branches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 and K9 have no CPU mode")
    import chip_smoke

    got = chip_smoke.check_sharded_combine(ranks=(1, 4), shapes=((6, 2), (200, 3)))
    assert got["bit_equal"] and got["launches"]["sharded_tail"] == 3 * got["cases"]
    got = chip_smoke.check_sharded_combine(ranks=(1, 4), shapes=chip_smoke.SHARDED_EDGE_SHAPES,
                                           lams=(1.1,), cases=("finite", "inf rank"))
    assert got["bit_equal"] and got["launches"]["sharded_tail"] == 3 * got["cases"]
    assert chip_smoke.check_sharded_tail_world("point_mass3d")
    assert chip_smoke.check_sharded_tail_world("quadrotor3d")
    for onepass in (True, False):
        chip_smoke.check_sharded_episode_combine("point_mass2d", virtual_mesh(4, "cuda"), onepass,
                                                 steps=20)
