"""K1's per-rollout body (``ops/fused_solve.BLOCK`` rollouts per block).

Its second pass takes the horizon in chunks of eight steps when every
rollout of a block weighs (more for fewer), draws and weighs the chunk's
noise into a shared-memory slab of ``fused_solve.DELTA_CELLS`` floats per
action and sums each (step, action) row from there into the block's partial
row. Here, on the CPU, the host's shared-memory size is held to the kernel's
layout, the launcher to that size, and chip_smoke.py's readers of the body
(its SASS loop walker, the share of rollouts that weigh) to made-up inputs.
The plain partials at width 128 are held against the JAX package's one-pass
kernel in tests/test_torch_block_width.py. The kernel itself runs on the
card in chip_smoke.py: against those plain partials and the replay of K3's
dump bit for bit, at the problems' own λ, at a λ where about half of each
block weighs and at λ = 1e9, where every rollout does.
"""

from __future__ import annotations

import contextlib
import functools
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu_torch.ops import _build  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402

HEADER = Path(fs.__file__).resolve().parents[1] / "csrc" / "mppi_solve.cuh"
CHUNK = 8  # steps per chunk of the second pass when every rollout of a block weighs


@pytest.fixture(autouse=True)
def _no_counted_launches():
    """Launch counts are module state that other test files read as zero."""
    yield
    fs.reset_launch_counts()


def _constexpr(name: str) -> int:
    """The value of ``constexpr int name = ...;`` in csrc/mppi_solve.cuh,
    its expression evaluated over the header's earlier integer constants."""
    env: dict[str, int] = {}
    for n, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", HEADER.read_text()):
        # the expression, in integers, over the constants defined before it
        env[n] = eval(expr.replace("/", "//"), {}, dict(env))
        if n == name:
            return env[n]
    raise KeyError(name)


# ---------------------------------------------------------------------------
# (a) shared memory: the host's size is the kernel's layout


def test_host_constants_mirror_the_kernel():
    """BLOCK and DELTA_CELLS are kBlock and kDeltaCells of the header, and
    the slab holds eight steps of a block whose every rollout weighs, its
    rows of 128 slots padded to 136 floats."""
    assert _constexpr("kBlock") == fs.BLOCK == 128
    assert _constexpr("kDeltaCells") == fs.DELTA_CELLS == CHUNK * (fs.BLOCK + 8)


@pytest.mark.parametrize("A", [1, 2, 3, 4])
@pytest.mark.parametrize("T", [200, 1000])
def test_rollout_bytes_is_the_kernels_layout(T, A):
    """K4's block holds U (T·A floats); K1's also the 128 slot weights and
    draws, one count per warp and the slab of DELTA_CELLS floats per action,
    whatever T: at T=1000 every A fits, where the design it replaced, five
    (T, A) buffers, did not at A=4."""
    assert fs.rollout_bytes(T, A, pass2=False) == 4 * T * A
    assert fs.rollout_bytes(T, A) == 4 * (T * A + 2 * 128 + 4 + fs.DELTA_CELLS * A)
    assert fs.rollout_bytes(T + 1, A) - fs.rollout_bytes(T, A) == 4 * A
    assert fs.rollout_bytes(T, A) <= fs._SMEM_BYTES


def _stub_library(monkeypatch):
    """A C entry that records its calls and launches nothing."""
    calls = []
    lib = types.SimpleNamespace(mppi_solve_partials=lambda *a: calls.append(a) or 0,
                                mppi_solve_residency=lambda *a: 0)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


@pytest.mark.parametrize("T,A,fits", [(5000, 3, True), (14_000, 4, False)])
def test_launcher_sizes_the_per_rollout_body_by_rollout_bytes(monkeypatch, T, A, fits):
    """Device-free, with the C entry stubbed: K1 at width 128 launches at
    T=5000, A=3 (60 KB of U and 13 KB of slab; the replaced design's
    300 KB did not fit), and a U that leaves no room for the slab is refused
    before any launch."""
    calls = _stub_library(monkeypatch)
    sigma, inv_s = torch.full((A,), 0.25), torch.ones(A)
    fam = fs.lti_family(sigma, inv_s, torch.ones(2 * A), 0.1, 1.0)
    x0, goal, U = torch.zeros(2 * A), torch.zeros(2 * A), torch.zeros(T, A)
    run = functools.partial(fs._launch_solve_partials, fam, x0, U, goal, 1.0, 256, 7, 3, 0,
                            False, 0.0, None, 1, (), width=fs.BLOCK)
    assert (fs.rollout_bytes(T, A) <= fs._SMEM_BYTES) == fits
    if fits:
        S, part = run()
        assert calls[-1][-2] == fs.BLOCK and part.shape == (2, 2 + T * A)
    else:
        with pytest.raises(ValueError, match="shared-memory budget"):
            run()
        assert not calls


# ---------------------------------------------------------------------------
# (b) chip_smoke's SASS walker reads the second pass's draw loop


@pytest.mark.parametrize("mults", [32, 46])
def test_loop_counter_reads_the_draw_loop_inside_the_chunk_loop(mults):
    """The second pass nests its draw loop (two Philox blocks per iteration)
    in the loop over chunks, beside the summing loop: the walker counts the
    draw loop alone, per draw, and not the chunk loop around it; two back
    edges to one head (a `continue`) are one loop. Made-up SASS, as
    tests/test_torch_sharded.py's loop-counter test writes it."""
    import chip_smoke

    ins = ["MOV R1, c[0x0][0x28]", "FADD R9, R9, R8"]          # 0x00; 0x10 chunk head
    head = 16 * len(ins)                                       # draw loop head
    ins += ["IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ"] * mults
    ins += [f"@P4 BRA 0x{head:x}", "STS [R5], R2", f"@P1 BRA 0x{head:x}"]
    ins += ["BAR.SYNC.DEFER_BLOCKING 0x0"]
    sum_head = 16 * len(ins)
    ins += ["LDS R6, [R7]", "FADD R8, R8, R6", f"@P3 BRA 0x{sum_head:x}", "@P2 BRA 0x10", "EXIT"]
    sass = "\n".join(["Function : k"] + [f"/*{16 * i:04x}*/ {s} ;" for i, s in enumerate(ins)])
    steps = chip_smoke.philox_loop_steps(chip_smoke.sass_functions(sass)["k"])
    assert steps == [(mults + 3) / 2]


def test_weighing_share_counts_the_weights_not_zero():
    """chip_smoke.weighing_share: the share of rollouts whose float32 weight
    in their block, exp(−(S_k − β_b)/λ) with β_b the block's least S, is not
    0 (the rollouts the second pass draws again); an all-+inf block weighs
    nothing, nor does the pad of the last block; a fleet's robots are
    blocked apart."""
    import chip_smoke

    K = 300
    S = torch.full((K,), 500.0)
    S[[0, 5, 130, 131]] = 1.0
    S[256:] = float("inf")
    assert chip_smoke.weighing_share(S, 1.0, fs.BLOCK) == pytest.approx(4 / K)
    assert chip_smoke.weighing_share(S, 1e9, fs.BLOCK) == pytest.approx(256 / K)
    S2 = torch.stack([S, torch.full((K,), 7.0)])
    assert chip_smoke.weighing_share(S2, 1.0, fs.BLOCK) == pytest.approx((4 + K) / (2 * K))


@pytest.mark.parametrize("width", [fs.SLAB_WIDTH, fs.BLOCK])
def test_middle_lam_weighs_about_half_of_each_block(width):
    """chip_smoke.middle_lam on spread costs (a +inf rollout among them):
    about half of the rollouts weigh at it, all at λ = 1e9."""
    import chip_smoke

    gen = torch.Generator().manual_seed(3)
    S = 100.0 + 40.0 * torch.rand(1000, generator=gen)
    S[17] = float("inf")
    lam = chip_smoke.middle_lam(S, width)
    assert 0.4 < chip_smoke.weighing_share(S, lam, width) < 0.75
    assert chip_smoke.weighing_share(S, 1e9, width) == pytest.approx(999 / 1000)


@pytest.mark.parametrize("lam", ["mid", 1e9])
@pytest.mark.parametrize("antithetic,ou_beta", [(False, 0.0), (True, 0.5)])
def test_dump_replay_at_the_weighing_lambdas_on_the_cpu(lam, antithetic, ou_beta):
    """chip_smoke.check_dump_replay at the λ of its weighing cases, on the
    CPU (the plain version): the replay is exact, the λ is the one asked
    for, and at λ = 1e9 every rollout weighs."""
    import chip_smoke

    d = chip_smoke.check_dump_replay(3, 300, 11, antithetic=antithetic, ou_beta=ou_beta,
                                     lams=(None, lam), device="cpu")
    assert d["eps_bit_identical"] and d["widths"] == [None]
    (own, _), (got, share) = d["replays"]
    assert own == 1.0  # the problem's λ
    if lam == "mid":
        assert 0.2 < share < 0.9
    else:
        assert got == 1e9 and share == 1.0
