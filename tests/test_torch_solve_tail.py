"""K7 ``solve_tail`` on the CPU (``ops/solve_tail.py``, its kernel in
``csrc/solve_tail.cu``): the plain tail against the JAX package's tail
arithmetic (``mppi_gpu_tpu/controller.py``: u_new = U + dU, ``jnp.clip``,
``shift_action_seq`` and the softmin weights), the in-place form against the
out-of-place one, the controller's partial tails (an inner opt iteration,
the device episode's cycle) against ``solve``'s full result, the device
episodes against the cycle their parent ran (the full solve, then U copied
and the counter incremented apart), the dispatch to K7 with its C entry
stubbed (so no card is needed), and chip_smoke.py's K7 check on CPU
tensors.

Inputs come from numpy seeds; sizes are small (R ≤ 4, T ≤ 50, K ≤ 96, a few
cycles). The kernel itself runs only on the card, where ``chip_smoke.py
--episode`` holds it against the plain tail bit for bit.
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

from mppi_gpu_tpu.controller import shift_action_seq as jax_shift_action_seq  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import CYCLE, FULL, ITERATE, MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world, params_for_config  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import solve_tail as st  # noqa: E402
from mppi_gpu_tpu_torch.parallel import ShardedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh  # noqa: E402
from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the weights go through exp: the two packages' exp on the CPU may part by a
# rounding or two; and XLA on the CPU flushes a subnormal result to zero where
# torch keeps it, so a weight under float32's least normal number may be 0 in
# one and not in the other
WEIGHTS_RTOL, WEIGHTS_ATOL = 1e-6, float(np.finfo(np.float32).tiny)


def _inputs(R, T: int, A: int, K: int, nan: bool, seed: int = 0):
    """U, ΔU, max_a, S, β, η, λ as numpy float32 from a seed; U past the
    bounds in places; with `nan`, a NaN in ΔU and one rollout's cost +inf."""
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    U = rng.uniform(-1.5, 1.5, lead + (T, A)).astype(np.float32)
    dU = rng.normal(0.0, 0.5, lead + (T, A)).astype(np.float32)
    max_a = rng.uniform(0.3, 1.2, A).astype(np.float32)
    S = rng.uniform(0.0, 50.0, lead + (K,)).astype(np.float32)
    if nan:
        dU[..., T // 2, 0] = np.nan
        S[..., K // 3] = np.inf
    beta = S.min(-1)
    lam = float(rng.choice([0.1, 0.3, 1.0, 1.5]))
    eta = np.exp(-(S.astype(np.float64) - beta[..., None]) / lam).sum(-1).astype(np.float32)
    return U, dU, max_a, S, beta, eta, lam


def _jax_tail(U, dU, max_a, S, beta, eta, lam, clamp: bool):
    """The JAX package's tail: ``solve_from_costs``'s u_new, clip, action
    and shift (mppi_gpu_tpu/controller.py:261-268, :236-239), robot by robot
    for a fleet, and ``pallas_solve``'s weights (:504)."""
    u_new = jnp.asarray(U) + jnp.asarray(dU)
    if clamp:
        u_new = jnp.clip(u_new, -jnp.asarray(max_a), jnp.asarray(max_a))
    shift = jax_shift_action_seq if U.ndim == 2 else jax.vmap(jax_shift_action_seq)
    b, e = (beta, eta) if U.ndim == 2 else (beta[:, None], eta[:, None])
    w = jnp.exp(-(jnp.asarray(S) - jnp.asarray(b)) / jnp.float32(lam)) / jnp.asarray(e)
    return {"u_seq": np.asarray(u_new), "u_next": np.asarray(shift(u_new)),
            "action": np.asarray(u_new[..., 0, :]), "weights": np.asarray(w)}


def _torch(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


# ---------------------------------------------------------------------------
# the plain tail against the JAX package's


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
@pytest.mark.parametrize("R", [None, 3], ids=["solo", "fleet"])
@pytest.mark.parametrize("T", [1, 2, 50])
@pytest.mark.parametrize("A", [1, 2, 3, 4])
def test_plain_tail_matches_the_jax_tail(A, T, R, clamp, nan):
    """``solve_tail`` on CPU tensors against the JAX tail on the same
    numpy-seeded inputs: u_seq, u_next and action bit for bit (one add and a
    min/max, each rounded once; NaN where the JAX tail has NaN), the weights
    within WEIGHTS_RTOL (and WEIGHTS_ATOL for subnormals)."""
    U, dU, max_a, S, beta, eta, lam = _inputs(R, T, A, 40, nan, seed=A * 100 + T)
    want = _jax_tail(U, dU, max_a, S, beta, eta, lam, clamp)
    tU, tdU, tmax, tS, tb, te = _torch(U, dU, max_a, S, beta, eta)
    got = st.solve_tail(tU, tdU, tmax, clamp, FULL, (tS, tb, te, lam))
    for name in ("u_seq", "u_next", "action"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    np.testing.assert_allclose(got.weights.numpy(), want["weights"], rtol=WEIGHTS_RTOL,
                               atol=WEIGHTS_ATOL)
    if nan:
        assert np.isnan(got.u_seq[..., T // 2, 0].numpy()).all()
        assert (got.weights[..., 40 // 3] == 0).all()


@pytest.mark.parametrize("R", [None, 4], ids=["solo", "fleet"])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
def test_in_place_equals_out_of_place(R, clamp):
    """The cycle's form (the action, and u_next written over U itself) and
    the iteration's (u_seq alone) equal the full tail's outputs bit for bit,
    and leave the outputs not asked for None."""
    U, dU, max_a, S, beta, eta, lam = _inputs(R, 20, 3, 16, True, seed=9)
    tU, tdU, tmax, tS, tb, te = _torch(U, dU, max_a, S, beta, eta)
    full = st.solve_tail(tU, tdU, tmax, clamp, FULL, (tS, tb, te, lam))
    inplace = tU.clone()
    cyc = st.solve_tail(inplace, tdU, tmax, clamp, CYCLE, into=inplace)
    assert cyc.u_next is inplace and cyc.u_seq is None and cyc.weights is None
    assert torch.equal(inplace.nan_to_num(7.0), full.u_next.nan_to_num(7.0))
    assert torch.equal(cyc.action.nan_to_num(7.0), full.action.nan_to_num(7.0))
    seq = st.solve_tail(tU, tdU, tmax, clamp, ITERATE)
    assert seq.u_next is None and seq.action is None and seq.weights is None
    assert torch.equal(seq.u_seq.nan_to_num(7.0), full.u_seq.nan_to_num(7.0))
    assert torch.equal(tU, torch.from_numpy(U))  # out of place leaves U alone


def test_tail_refuses_what_it_cannot_compute():
    """An unknown output, the weights without (S, β, η, λ) or (S, β, η, λ)
    without the weights, and `into` without u_next raise on any device."""
    U, dU, max_a = torch.zeros(4, 2), torch.zeros(4, 2), torch.ones(2)
    softmin = (torch.zeros(8), torch.tensor(0.0), torch.tensor(1.0), 1.0)
    with pytest.raises(ValueError, match="not"):
        st.solve_tail(U, dU, max_a, True, ("u_seq", "costs"))
    with pytest.raises(ValueError, match="softmin"):
        st.solve_tail(U, dU, max_a, True, FULL)
    with pytest.raises(ValueError, match="softmin"):
        st.solve_tail(U, dU, max_a, True, CYCLE, softmin)
    with pytest.raises(ValueError, match="into"):
        st.solve_tail(U, dU, max_a, True, ITERATE, into=U)


# ---------------------------------------------------------------------------
# the controller's partial tails against solve's full result


def _config(name: str, K: int = 96, T: int = 10, opt_iters: int = 2):
    cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    return cfg.replace(samples=K, horizon=T, opt_iters=opt_iters)


def _controllers(cfg, backend: str):
    """A solo, a fleet and a sharded (2 virtual ranks) controller on the CPU
    on `backend` (``fused`` on CPU tensors runs the kernels' plain versions)."""
    out = [MPPIController(cfg, device="cpu"), BatchedMPPIController(cfg, 3, device="cpu"),
           ShardedMPPIController(cfg, mesh=virtual_mesh(2, "cpu"))]
    for ctrl in out:
        ctrl.rollout_backend = backend
    return out


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", ["point_mass2d", "pendulum"])
def test_partial_tails_equal_the_full_solve(name, backend):
    """On the CPU, at two opt iterations, for a solo robot, a fleet and a
    sharded controller: ``_iterate``'s sequence is the first update's u_seq
    of the full solve, and the episode's ``solve_in_place`` returns the full
    solve's action and leaves its u_next in U, bit for bit."""
    cfg = _config(name)
    for ctrl in _controllers(cfg, backend):
        fleet = isinstance(ctrl, BatchedMPPIController)
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.uniform(-0.3, 0.3, ((3,) if fleet else ()) + (cfg.state_dim,))
                             .astype(np.float32))
        U = ctrl.init_action_seqs() if fleet else ctrl.init_action_seq()
        seed = ctrl.init_seeds() if fleet else 7
        step = torch.tensor(4)
        full = ctrl.solve(x, U, seed, step, capture=False)
        first = ctrl._solve_once(x, U, seed, step, 0)
        assert torch.equal(ctrl._iterate(x, U, seed, step), first.info.u_seq)
        inner = ctrl._solve_once(x, first.info.u_seq, seed, step, 1)
        assert torch.equal(inner.info.u_seq, full.info.u_seq)
        U_cycle = U.clone()
        action = ctrl.solve_in_place(x, U_cycle, seed, step)
        assert torch.equal(action, full.action) and torch.equal(U_cycle, full.u_next)
        for leaf in full.info:
            assert leaf is not None


# ---------------------------------------------------------------------------
# the device episodes against their parent's cycle


def _parent_cycle_episode(ctrl, world, state0, U0, n: int, solve):
    """The episode as the cycle before K7 ran it, written out: the full
    solve at the counter's step on the state's x (its leaves joined anew),
    the world step and the history writes, then U copied from the solve's
    u_next and the counter incremented."""
    state = type(state0)(*(leaf.clone() for leaf in state0))
    U, step = U0.clone(), torch.zeros((), dtype=torch.int64)
    x0 = state0.x
    xs = torch.empty((n + 1, *x0.shape))
    us = torch.empty((n, *U0.shape[:-2], U0.shape[-1]))
    ts = torch.empty((n, *state0.time.shape))
    xs[0].copy_(x0)
    for _ in range(n):
        res = solve(state.x, U, step)
        new = world.advance(state, res.action)
        for buf, v in zip(state, new):
            buf.copy_(v)
        xs[step + 1], us[step], ts[step] = new.x, res.action, new.time
        U.copy_(res.u_next)
        step.add_(1)
    return xs.numpy(), us.numpy(), ts.numpy()


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("name", ["point_mass2d", "pendulum"])
def test_episodes_equal_their_parent_cycle(name, backend):
    """``run_episode_jit`` and ``run_fleet_episode`` on the CPU at two opt
    iterations (the cycle's tail in place, K6's x buffer and counter) give
    the episode of the cycle they replaced bit for bit, over 6 cycles."""
    cfg = _config(name, K=64, T=8)
    n = 6
    params = params_for_config(cfg)
    ctrl, fleet, _ = _controllers(cfg, backend)
    world = make_world(cfg, params)
    got = run_episode_jit(ctrl, num_steps=n)
    want = _parent_cycle_episode(
        ctrl, world, world.reset(), ctrl.init_action_seq(), n,
        lambda x, U, step: ctrl.solve(x, U, cfg.seed, step, capture=False))
    for a, b in zip((got.xs, got.us, got.times), want):
        np.testing.assert_array_equal(a, b)
    got = run_fleet_episode(fleet, num_steps=n)
    seeds = fleet.init_seeds()
    want = _parent_cycle_episode(
        fleet, world, world.reset(3), fleet.init_action_seqs(), n,
        lambda x, U, step: fleet.solve_batch(x, U, seeds, step, capture=False))
    for a, b in zip((got.xs, got.us, got.times), want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the dispatch to K7, its C entry stubbed


def _stub(monkeypatch, rc: int = 0):
    """CPU tensors taken for CUDA ones and K1's, K2's and K7's C entries
    recorded (returning `rc` for K7); the stubbed launches count in copies of
    the launch counts."""
    monkeypatch.setattr(st, "_LAUNCHES", dict(st._LAUNCHES))
    monkeypatch.setattr(fs, "_LAUNCHES", dict(fs._LAUNCHES))
    monkeypatch.setattr(fs, "_FAMILY_LAUNCHES", {k: dict(v) for k, v in fs._FAMILY_LAUNCHES.items()})
    monkeypatch.setattr(fs, "_WIDTH_LAUNCHES", {k: dict(v) for k, v in fs._WIDTH_LAUNCHES.items()})
    calls = {"solve_partials": [], "softmin_combine": [], "solve_tail": []}

    def entry(kernel):
        def call(*args):
            calls[kernel].append(args)
            return rc if kernel == "solve_tail" else 0
        return call

    lib = types.SimpleNamespace(**{f"mppi_{k}": entry(k) for k in calls})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(st, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


# the C entry's arguments, by name (csrc/solve_tail.cu, mppi_solve_tail)
ENTRY_ARGS = ("U", "dU", "max_a", "clamp", "u_seq", "u_next", "action", "S", "beta", "beta_stride",
              "eta", "eta_stride", "inv_lam", "weights", "R", "T", "A", "K", "stream")


@pytest.mark.parametrize("R", [None, 4], ids=["solo", "fleet"])
def test_cuda_bound_tail_passes_its_buffers(monkeypatch, R):
    """Device-free: a CUDA-bound tail calls K7's entry once per call with
    U, ΔU and max_a by address, the clamp flag, each output asked for by the
    address of a new buffer (u_next's `into`'s, in place: U's) and a null
    pointer for each not asked for, S, β and η by address with β's and η's
    robot strides (views of K2's (…, 2) output), the float32 reciprocal of
    λ, R, T, A and K; each launch counts once."""
    calls = _stub(monkeypatch)
    U, dU, max_a, S, beta, eta, lam = _inputs(R, 6, 2, 16, False)
    tU, tdU, tmax, tS = _torch(U, dU, max_a, S)
    be = torch.from_numpy(np.stack([beta, eta], -1))
    softmin = (tS, be[..., 0], be[..., 1], lam)
    full = st.solve_tail(tU, tdU, tmax, True, FULL, softmin)
    cyc = st.solve_tail(tU, tdU, tmax, False, CYCLE, into=tU)
    assert len(calls["solve_tail"]) == 2 and st.launch_counts()["solve_tail"] == 2
    a, b = (dict(zip(ENTRY_ARGS, c)) for c in calls["solve_tail"])
    rows = 1 if R is None else R
    for args in (a, b):
        assert (args["U"], args["dU"], args["max_a"]) == (tU.data_ptr(), tdU.data_ptr(),
                                                          tmax.data_ptr())
        assert (args["R"], args["T"], args["A"], args["stream"]) == (rows, 6, 2, 5)
    assert a["clamp"] == 1 and b["clamp"] == 0
    assert (a["u_seq"], a["u_next"], a["action"], a["weights"]) == (
        full.u_seq.data_ptr(), full.u_next.data_ptr(), full.action.data_ptr(),
        full.weights.data_ptr())
    assert a["u_next"] != tU.data_ptr() and full.action.shape == U.shape[:-2] + (2,)
    assert (a["S"], a["beta"], a["eta"], a["K"]) == (tS.data_ptr(), be[..., 0].data_ptr(),
                                                     be[..., 1].data_ptr(), 16)
    assert (a["beta_stride"], a["eta_stride"]) == ((0, 0) if R is None else (2, 2))
    assert a["inv_lam"] == float(np.float32(1.0) / np.float32(lam))
    assert (b["u_seq"], b["u_next"], b["action"], b["weights"], b["S"], b["K"]) == (
        None, tU.data_ptr(), cyc.action.data_ptr(), None, None, 0)
    assert cyc.u_next is tU


def test_failed_or_refused_launch_raises(monkeypatch):
    """A non-zero return of the entry raises (no fallback to the plain
    tail); so do a float64 ΔU, a non-contiguous U, a max_a of another
    width, a row past one block's shared memory, and β of another shape,
    before any launch."""
    calls = _stub(monkeypatch, rc=700)
    U, dU, max_a = torch.zeros(5, 2), torch.zeros(5, 2), torch.ones(2)
    with pytest.raises(RuntimeError, match="solve_tail failed to launch: cudaError_t 700"):
        st.solve_tail(U, dU, max_a, True, ITERATE)
    assert len(calls["solve_tail"]) == 1 and st.launch_counts()["solve_tail"] == 0
    with pytest.raises(TypeError, match="float32"):
        st.solve_tail(U, dU.double(), max_a, True, ITERATE)
    with pytest.raises(ValueError, match="contiguous"):
        st.solve_tail(torch.zeros(2, 5).t(), dU, max_a, True, ITERATE)
    with pytest.raises(ValueError, match="max_a"):
        st.solve_tail(U, dU, torch.ones(3), True, ITERATE)
    T = st.MAX_ROW // 2 + 1
    with pytest.raises(ValueError, match="shared memory"):
        st.solve_tail(torch.zeros(T, 2), torch.zeros(T, 2), max_a, True, ITERATE)
    softmin = (torch.zeros(8), torch.zeros(1), torch.tensor(1.0), 1.0)
    with pytest.raises(ValueError, match="beta"):
        st.solve_tail(U, dU, max_a, True, FULL, softmin)
    assert len(calls["solve_tail"]) == 1


@pytest.mark.parametrize("capturing", [False, True])
def test_only_a_launch_that_runs_is_counted(monkeypatch, capturing):
    """While the stream captures a CUDA graph the entry is called (the graph
    records the launch) but nothing is counted."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    st.solve_tail(torch.zeros(5, 2), torch.zeros(5, 2), torch.ones(2), True, ITERATE)
    assert len(calls["solve_tail"]) == 1
    assert st.launch_counts()["solve_tail"] == (0 if capturing else 1)


# the torch ops of the tail before K7: U + ΔU, the clamp, the shift's cat, and
# the weights' sub, neg, division and exp
TAIL_OPS = ("add", "clamp", "cat", "sub", "neg", "div", "exp", "mul")


@pytest.mark.parametrize("fleet", [False, True], ids=["solo", "fleet"])
def test_fused_solve_on_cuda_runs_no_torch_tail(monkeypatch, fleet):
    """Device-free: the fused solve bound for CUDA (K1 and K2 stubbed too)
    at two opt iterations runs no torch op of the old tail: each update
    ends in one launch of K7, the inner one asking for u_seq alone, the last
    for every output and the weights (``solve``) or for the action and U
    shifted in place (``solve_in_place``, the episode's)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = _stub(monkeypatch)
    cfg = _config("point_mass2d", K=64, T=8)
    ctrl = (BatchedMPPIController(cfg, 3, device="cpu") if fleet
            else MPPIController(cfg, device="cpu"))
    ctrl.rollout_backend = "fused"
    x = torch.zeros((3, 4) if fleet else (4,))
    U = ctrl.init_action_seqs() if fleet else ctrl.init_action_seq()
    seed = ctrl.init_seeds() if fleet else 7
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__.rstrip("_"))
            return func(*args, **(kwargs or {}))

    with Record():
        ctrl.solve(x, U, seed, torch.tensor(2), capture=False)
        ctrl.solve_in_place(x, U, seed, torch.tensor(3))
    assert not set(ops) & set(TAIL_OPS), sorted(set(ops))
    tails = [dict(zip(ENTRY_ARGS, c)) for c in calls["solve_tail"]]
    assert len(tails) == 4 and len(calls["solve_partials"]) == len(calls["softmin_combine"]) == 4
    asked = [tuple(k for k in ("u_seq", "u_next", "action", "weights") if t[k] is not None)
             for t in tails]
    assert asked == [("u_seq",), FULL, ("u_seq",), ("u_next", "action")]
    assert tails[3]["u_next"] == U.data_ptr() and tails[3]["U"] != U.data_ptr()


# ---------------------------------------------------------------------------
# chip_smoke.py's K7 check


def test_chip_smoke_tail_check_runs_on_the_cpu():
    """chip_smoke.py's K7 check on CPU tensors, where both sides are the
    plain tail: every mode of a few shapes agrees bit for bit and no launch
    is counted."""
    import chip_smoke

    got = chip_smoke.check_solve_tail(device="cpu", shapes=((None, 1, 3, 50), (4, 20, 2, 64)))
    assert got == {"max_abs_err": 0.0, "weights_max_abs_err": 0.0, "bit_equal": True,
                   "launches": 0, "cases": 6}


def test_chip_smoke_closed_loop_shares_runs_on_the_cpu():
    """chip_smoke.py's weighing shares of a closed loop drive
    ``runner.EpisodeCycle`` with a solve of their own (the full fleet solve,
    its costs kept, U shifted in place): on the CPU, a whole point_mass3d
    episode of an R=2 fleet at K=64 gives a share in [0, 1] at each mark."""
    import chip_smoke

    got = chip_smoke.closed_loop_shares("point_mass3d", 2, 64, device="cpu")
    assert (got["R"], got["K"], got["family"]) == (2, 64, "lti")
    assert all(0.0 <= got[k] <= 1.0 for k in ("first", "middle", "last"))


@pytest.mark.gpu
def test_tail_kernel_on_the_card():
    """On the card: K7 against its plain version, bit for bit, at small
    shapes of every mode (chip_smoke.py runs every shape of TAIL_SHAPES)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    import chip_smoke

    got = chip_smoke.check_solve_tail(device="cuda", shapes=((None, 1, 3, 50), (8, 200, 4, 3000)))
    assert got["bit_equal"] and got["launches"] == 3 * got["cases"]
