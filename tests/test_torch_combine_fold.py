"""K2's fold in its two forms (``csrc/softmin_combine.cuh``): one block per
robot where the robot's partials fit, and 32-column tiles. K2 always folds
in tiles; K2''s form is a function of (nb, T·A) alone
(``fused_solve.combine_one_block``), and both forms give the same floats on
the card; there ``chip_smoke.py --combine`` holds K2 and K2' to their plain
versions and K2' in each form to K2 + K7 + K6 bit for bit. Here, without a card: the rule, the
launchers with the library stubbed (what they pass, what they refuse),
chip_smoke's checks on CPU tensors, and the port's fused solve against the
JAX package's one-pass Pallas kernel in interpret mode at a shape on each
side of the crossover.

Inputs come from numpy seeds; sizes are small except the tiled side's
solve (K = 10⁴, T = 200, a few seconds).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
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
from mppi_gpu_tpu_torch.controller import ITERATE  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build  # noqa: E402
from mppi_gpu_tpu_torch.ops import combine_tail as ct  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# the check's shapes (chip_smoke.COMBINE_NBS, T·A of COMBINE_SHAPES)
NBS = (1, 7, 32, 94, 313, 782)
TAS = (1, 31, 33, 100, 600)
# the C entries' arguments, by name (csrc/mppi_solve.cu, mppi_softmin_combine)
COMBINE_ARGS = ("partials", "R", "nb", "TA", "lam", "normalize", "beta_eta", "dU", "stream")
# tests/test_torch_fused.py's tolerances (those of tests/test_pallas.py)
S_TOL = dict(rtol=3e-5)
DU_TOL = dict(rtol=2e-4, atol=1e-6)


def _stub(monkeypatch):
    """CPU tensors taken for CUDA ones and K2's and K2''s C entries
    recorded; the stubbed launches count in copies of the launch counts."""
    monkeypatch.setattr(fs, "_LAUNCHES", dict(fs._LAUNCHES))
    monkeypatch.setattr(ct, "_LAUNCHES", dict(ct._LAUNCHES))
    calls = {"softmin_combine": [], "combine_tail": []}

    def entry(kernel):
        def call(*args):
            calls[kernel].append(args)
            return 0
        return call

    lib = types.SimpleNamespace(**{f"mppi_{k}": entry(k) for k in calls})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


def _inputs(R, nb: int, T: int, A: int, seed: int = 0):
    """partials (…, nb, 2 + T·A), U (…, T, A), max_a (A,) from a numpy seed."""
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    return (torch.from_numpy(rng.uniform(0.0, 2.0, lead + (nb, 2 + T * A)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1.5, 1.5, lead + (T, A)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.3, 1.2, A).astype(np.float32)))


# ---------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("TA", TAS)
@pytest.mark.parametrize("nb", NBS)
def test_form_is_a_function_of_the_shapes(nb, TA):
    """One block where the robot's nb·(2 + T·A) floats are at most
    COMBINE_ONE_BLOCK_FLOATS, its T·A columns at most
    COMBINE_ONE_BLOCK_COLUMNS, and the block's shared memory holds them and
    K2''s row; then a smaller nb or T·A is one block too. The tiled form's
    shared memory fits every nb the launchers take (its staged rows shrink
    to what fits)."""
    one = fs.combine_one_block(nb, TA)
    fits = max(fs.combine_smem(nb, TA, True), 4 * TA) <= fs._SMEM_BYTES
    assert one == (nb * (2 + TA) <= fs.COMBINE_ONE_BLOCK_FLOATS
                   and TA <= fs.COMBINE_ONE_BLOCK_COLUMNS and fits)
    if one:
        assert fs.combine_one_block(max(nb - 1, 1), TA) and fs.combine_one_block(nb, max(TA - 1, 1))
    assert fs.combine_smem(nb, TA, False) <= fs._SMEM_BYTES
    assert fs.combine_one_block(nb, TA) == fs.combine_one_block(nb, TA)  # no state


def test_tiles_stage_every_row_until_shared_memory_runs_out():
    """The tiled form stages each lane's ⌈nb/8⌉ rows while they fit beside
    f_b and the warps' sums, and past that as many as fit; the largest nb
    the launchers take still fits."""
    top = fs._SMEM_BYTES // 4 - fs._COMBINE_SMEM_FLOATS
    for nb in (1, 313, 782, 1700):
        assert fs.combine_smem(nb, 600, False) == 4 * (nb + 256 + 256 * -(-nb // 8))
    for nb in (5000, top):
        assert fs.combine_smem(nb, 600, False) < 4 * (nb + 256 + 256 * -(-nb // 8))
        assert fs.combine_smem(nb, 600, False) <= fs._SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        fs._combine_form(top + 1, 600, None)


def _c_formula(src: str, name: str) -> str:
    """The C expression that `name` (a function of softmin_combine.cuh, or
    tile_staged's `room`) returns, as Python: casts dropped, / as //."""
    if name == "room":
        expr = re.search(r"const int room = (.*?);", src).group(1)
    else:
        expr = re.search(name + r"\(.*?\) \{\s*return (.*?);", src, re.S).group(1)
    return expr.replace("(size_t)", "").replace("/", "//")


def test_kernel_source_takes_the_launchers_shared_memory():
    """The kernels' bound on shared memory is the launchers' (fused_solve's
    _SMEM_BYTES), their block's threads and warps fused_solve's, and
    fused_solve.combine_smem the C formulas of each form's shared floats
    (tile_staged, tile_smem_floats, block_smem_floats) at every shape of
    the check; both units refuse a form whose shared memory exceeds a
    block's, and only K2' takes a form."""
    csrc = os.path.join(ROOT, "mppi_gpu_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "softmin_combine.cuh")).read()
    m = re.search(r"kCombineSmemFloats = \((\d+) - (\d+)\) / 4;", src)
    assert m and int(m.group(1)) - int(m.group(2)) == fs._SMEM_BYTES
    head = open(os.path.join(csrc, "mppi_solve.cuh")).read()
    assert f"kCombineThreads = {fs._COMBINE_THREADS};" in head
    assert "kCombineWarps = kCombineThreads / 32;" in head
    assert fs._COMBINE_WARPS == fs._COMBINE_THREADS // 32
    assert "combine_one_block" in src
    names = dict(kCombineSmemFloats=fs._SMEM_BYTES // 4, kCombineThreads=fs._COMBINE_THREADS,
                 kCombineWarps=fs._COMBINE_WARPS)
    for nb in NBS + (1700, 5000, fs._SMEM_BYTES // 4 - fs._COMBINE_SMEM_FLOATS):
        per = -(-nb // fs._COMBINE_WARPS)
        room = eval(_c_formula(src, "room"), {}, dict(names, nb=nb))
        staged = 0 if room < 0 else min(per, room)
        tile = eval(_c_formula(src, "tile_smem_floats"), {"tile_staged": lambda nb: staged},
                    dict(names, nb=nb))
        assert 4 * tile == fs.combine_smem(nb, 600, False)
        for TA in TAS:
            block = eval(_c_formula(src, "block_smem_floats"), {}, dict(names, nb=nb, TA=TA))
            assert 4 * block == fs.combine_smem(nb, TA, True)
    for name in ("mppi_solve.cu", "combine_tail.cu"):
        unit = open(os.path.join(csrc, name)).read()
        assert "kCombineSmemFloats * sizeof(float)" in unit
        assert ("one_block" in unit) == (name == "combine_tail.cu")


# ---------------------------------------------------------------------------
# the launchers, the library stubbed


@pytest.mark.parametrize("R,nb,T,A", [(None, 10, 12, 2), (None, 313, 200, 3), (4, 94, 50, 2),
                                      (8, 94, 200, 3), (None, 1, 1, 1)])
def test_k2_and_k2e_launch_in_the_same_form(monkeypatch, R, nb, T, A):
    """K2 (solo or fleet) and K2' (an inner iteration's tail) on the same
    partials each launch once with the partials, R, nb, T·A and λ: K2, which
    takes no form (its grid is the tiles), with new β η and ΔU buffers and
    the stream; K2' with the rule's form; each launch counts once."""
    calls = _stub(monkeypatch)
    partials, U, max_a = _inputs(R, nb, T, A)
    rows = 1 if R is None else R
    if R is None:
        beta, eta, dU = fs.softmin_combine(partials, 1.1, T, A)
    else:
        beta, eta, dU = fs.fleet_softmin_combine(partials, 1.1, T, A)
    tickets = torch.zeros(rows + 1, dtype=torch.int32)
    ct.combine_tail(partials, 1.1, U, max_a, True, ITERATE, tickets)
    (k2,), (k2e,) = calls["softmin_combine"], calls["combine_tail"]
    a = dict(zip(COMBINE_ARGS, k2))
    want = int(fs.combine_one_block(nb, T * A))
    assert (a["partials"], a["R"], a["nb"], a["TA"], a["lam"], a["normalize"]) == (
        partials.data_ptr(), rows, nb, T * A, 1.1, 1)
    assert len(k2) == len(COMBINE_ARGS)
    assert (a["beta_eta"], a["dU"], a["stream"]) == (beta.data_ptr(), dU.data_ptr(), 5)
    assert eta.data_ptr() == beta.data_ptr() + 4
    assert k2e[-2] == want and k2e[:6] == (partials.data_ptr(), rows, nb, T, A, 1.1)
    assert fs.launch_counts()["softmin_combine"] == 1 and ct.launch_counts()["combine_tail"] == 1


@pytest.mark.parametrize("form", [False, True])
def test_a_forced_form_is_passed(monkeypatch, form):
    """chip_smoke's forced forms reach K2''s C entry as given, where the
    form's shared memory holds the robot, whether forced through the
    launcher's argument or through the rule (``chip_smoke.k2e_form``, the
    episode's path); K2 launches as always."""
    calls = _stub(monkeypatch)
    partials, U, max_a = _inputs(None, 32, 50, 2)
    tickets = torch.zeros(2, dtype=torch.int32)
    fs.softmin_combine(partials, 1.0, 50, 2)
    ct._launch_combine_tail(partials, 1.0, U, max_a, True, ITERATE, tickets, None, None, None, 1,
                            (), one_block=form)
    with chip_smoke.k2e_form(form) as asked:
        ct.combine_tail(partials, 1.0, U, max_a, True, ITERATE, tickets)
    assert asked == [(32, 100)] and fs.combine_one_block(32, 100)
    assert [c[-2] for c in calls["combine_tail"]] == [int(form)] * 2
    assert len(calls["softmin_combine"][0]) == len(COMBINE_ARGS)


def test_launchers_refuse_what_they_cannot_compute(monkeypatch):
    """Before any launch: more partials than the tiled form's shared memory
    holds, a forced one-block form of K2' whose partials do not fit one
    block, and no rows at all; nothing is called or counted."""
    calls = _stub(monkeypatch)
    big = fs._SMEM_BYTES // 4 - fs._COMBINE_SMEM_FLOATS + 1
    with pytest.raises(ValueError, match="shared memory"):
        fs.softmin_combine(torch.zeros(big, 3), 1.0, 1, 1)
    partials, U, max_a = _inputs(None, 313, 200, 3)
    assert not fs.combine_one_block(313, 600)
    with pytest.raises(ValueError, match="one-block"):
        ct._launch_combine_tail(partials, 1.0, U, max_a, True, ITERATE,
                                torch.zeros(2, dtype=torch.int32), None, None, None, 1, (),
                                one_block=True)
    with pytest.raises(ValueError, match="shared memory"):
        fs._combine_form(0, 600, None)
    assert not calls["softmin_combine"] and not calls["combine_tail"]
    assert fs.launch_counts()["softmin_combine"] == 0 and ct.launch_counts()["combine_tail"] == 0


# ---------------------------------------------------------------------------
# chip_smoke's checks on CPU tensors


@pytest.mark.parametrize("case", chip_smoke.COMBINE_CASES)
def test_chip_smoke_partials(case):
    """The check's partials: spread β_b, η_b, ΔŨ_b = η_b · noise; one row at
    +inf (η_b = 0, ΔŨ_b = 0) or every row, from a seed."""
    p = chip_smoke.combine_partials(3, 7, 11, 3, case)
    assert p.shape == (3, 7, 35) and p.dtype == np.float32
    inf = np.isinf(p[..., 0])
    assert inf.sum() == {"finite": 0, "inf block": 3, "every rollout inf": 21}[case]
    assert (p[inf][:, 1:] == 0).all() and np.isfinite(p[~inf]).all()
    np.testing.assert_array_equal(p, chip_smoke.combine_partials(3, 7, 11, 3, case))


@pytest.mark.parametrize("R", [None, 3], ids=["solo", "fleet"])
def test_chip_smoke_form_checks_run_on_the_cpu(R):
    """chip_smoke's check of the forms on CPU tensors (the plain versions,
    one form): every case over a few shapes, λ and both infinite cases."""
    out = chip_smoke.check_combine_forms("cpu", nbs=(1, 7, 32), shapes=((1, 1), (11, 3), (50, 2)),
                                         lams=(1.1, 0.064, 1e9), robots=(R,))
    assert out["cases"] == 3 * 3 * 3 * 3 and out["both_forms"] == 0
    assert out["k2_err"] == 0.0 and out["k2e_err"] == 0.0


def test_chip_smoke_cycle_check_runs_on_the_cpu():
    """K2' of the cycle's form with the point mass's world step against
    K2 + K7 + K6 on CPU tensors (the plain versions: bit-equal)."""
    for R, A in ((None, 1), (4, 2), (3, 3)):
        parts, U, max_a, world, state = chip_smoke.combine_case_inputs(R, 9, 5, A, "finite", "cpu")
        assert chip_smoke.k2e_four_kernels(parts, 1.1, U, max_a, False, world, state,
                                           "cpu")["bit_equal"]


def test_digests_and_their_comparison(tmp_path, capsys):
    """``digest`` changes with a bit, a dtype or a shape; ``--same-digests``
    passes equal runs and names the key that differs."""
    a = torch.arange(6, dtype=torch.float32)
    assert chip_smoke.digest(a) == chip_smoke.digest(a.clone()) == chip_smoke.digest(a.numpy())
    b = a.clone()
    b[3] = float(np.nextafter(np.float32(3), np.float32(4)))
    assert len({chip_smoke.digest(x) for x in (a, b, a.double(), a.view(2, 3))}) == 4
    runs = []
    for i, d in enumerate(({"x": "1", "y": "2"}, {"x": "1", "y": "2"}, {"x": "1", "y": "3"})):
        path = tmp_path / f"run{i}.log"
        path.write_text("noise\n" + json.dumps({"root": ".", "digest": d}) + "\n")
        runs.append(str(path))
    assert chip_smoke.same_digests(runs[:2]) == 0
    assert chip_smoke.same_digests(runs) == 1
    assert "['y']" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the fused solve against the JAX package's one-pass kernel


@pytest.mark.parametrize("K,T,A,one_block", [(300, 12, 2, True), (10_000, 200, 3, False)],
                         ids=["one-block", "tiles"])
def test_fused_solve_matches_pallas_on_each_side_of_the_crossover(K, T, A, one_block):
    """The port's fused solve on the CPU (K1's and K2's plain versions) at
    a shape whose K2' fold the rule gives one block and at the flagship's,
    which it gives tiles, against the JAX package's one-pass kernel in
    interpret mode (testmode noise, fed to both): S within 3e-5, ΔU within
    2e-4 and 1e-6 (tests/test_pallas.py's tolerances for the same kernels),
    β within 3e-5."""
    width = fs.block_width(1, K, T, A, "lti")
    assert fs.combine_one_block(-(-K // width), T * A) == one_block
    rng = np.random.default_rng(K)
    w = np.arange(1.0, 2 * A + 1.0, dtype=np.float32)
    goal = np.linspace(-1.0, 1.0, 2 * A).astype(np.float32)
    inv_s, sigma = np.full(A, 0.8, np.float32), np.full(A, 0.25, np.float32)
    x0 = np.linspace(0.1, -0.1, 2 * A).astype(np.float32)
    U = (0.1 * rng.standard_normal((T, A))).astype(np.float32)
    lam_cost, lam = np.float32(1.2), 0.9
    key = jax.random.key(21)
    plan = pr.make_plan(K, T, A, testmode=True)
    assert plan.onepass
    twin = pr.planar_fake_noise_tensor if plan.planar else pr.fake_noise_tensor
    eps = np.asarray(twin(plan, jnp.asarray(sigma), key=key))[:, :K]
    cost = JaxQuadratic(w=jnp.asarray(w), goal=jnp.asarray(goal), lambda_=jnp.asarray(lam_cost),
                        inv_s=jnp.asarray(inv_s))
    S_j, dU_j = pr.pallas_fused_solve_core(
        JaxLTI.create(0.1, A), cost, jnp.asarray(x0), jnp.asarray(U), key, jnp.asarray(sigma),
        jnp.float32(lam), K=K, testmode=True, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in dict(x0=x0, U=U, sigma=sigma, inv_s=inv_s, w=w,
                                                goal=goal).items()}
    S, beta, eta, dU = fs.fused_solve(t["x0"], t["U"], t["sigma"], t["inv_s"], t["w"], t["goal"],
                                      float(lam_cost), lam, 0.1, K, 0, 0, 0, False, 0.0,
                                      torch.as_tensor(np.ascontiguousarray(eps)))
    S_j = np.asarray(S_j)[:K]
    np.testing.assert_allclose(S.numpy(), S_j, **S_TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_j), **DU_TOL)
    np.testing.assert_allclose(float(beta), float(S_j.min()), rtol=3e-5)
