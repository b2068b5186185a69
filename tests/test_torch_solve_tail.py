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
from mppi_gpu_tpu_torch.ops import _build, _rounding  # noqa: E402
from mppi_gpu_tpu_torch.ops import combine_tail as ct  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import solve_tail as st  # noqa: E402
from mppi_gpu_tpu_torch.ops import world_step as ws  # noqa: E402
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
@pytest.mark.parametrize("T", [1, 2, 50, 256, 341, 1025])
@pytest.mark.parametrize("A", [1, 2, 3, 4])
def test_plain_tail_matches_the_jax_tail(A, T, R, clamp, nan):
    """``solve_tail`` on CPU tensors against the JAX tail on the same
    numpy-seeded inputs: u_seq, u_next and action bit for bit (one add and a
    min/max, each rounded once; NaN where the JAX tail has NaN), the weights
    within WEIGHTS_RTOL (and WEIGHTS_ATOL for subnormals). T·A reaches
    across K7's round of 1024 entries: 1023 (T=341, A=3), 1024 (256, 4),
    1025 (1025, 1) and rows of two to five rounds."""
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


def _stub(monkeypatch, rc: int = 0, failing: str = "solve_tail"):
    """CPU tensors taken for CUDA ones and K1's, K2's, K7's, K2''s and K6's
    C entries recorded (returning `rc` for the kernel `failing`; K6's layout
    the source's); the stubbed launches count in copies of the launch
    counts."""
    monkeypatch.setattr(st, "_LAUNCHES", dict(st._LAUNCHES))
    monkeypatch.setattr(ct, "_LAUNCHES", dict(ct._LAUNCHES))
    monkeypatch.setattr(ws, "_LAUNCHES", dict(ws._LAUNCHES))
    monkeypatch.setattr(ws, "_CHECKED", set())
    monkeypatch.setattr(fs, "_LAUNCHES", dict(fs._LAUNCHES))
    monkeypatch.setattr(fs, "_FAMILY_LAUNCHES", {k: dict(v) for k, v in fs._FAMILY_LAUNCHES.items()})
    monkeypatch.setattr(fs, "_WIDTH_LAUNCHES", {k: dict(v) for k, v in fs._WIDTH_LAUNCHES.items()})
    calls = {"solve_partials": [], "softmin_combine": [], "solve_tail": [], "combine_tail": [],
             "world_advance": []}

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

    lib = types.SimpleNamespace(mppi_world_layout=layout, mppi_solve_residency=lambda *a: 0,
                                **{f"mppi_{k}": entry(k) for k in calls})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(st, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(fs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ws, "_on_cuda", lambda tensors: True)
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
    robot strides (views of K2's (…, 2) output), the factor torch's CUDA
    division by λ multiplies by (``_rounding.scalar_reciprocal``), R, T, A
    and K; each launch counts once."""
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
    assert a["inv_lam"] == _rounding.scalar_reciprocal(lam) == float(np.float32(1.0 / lam))
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
    """Device-free: the fused solve bound for CUDA (K1, K2 and K2' stubbed
    too) at two opt iterations runs no torch op of the old tail: ``solve``'s
    inner update ends in K2' asking for u_seq alone, its last in K2 and one
    launch of K7 for every output and the weights; ``solve_in_place`` (the
    episode's) ends both updates in K2', the inner one asking for u_seq, the
    last for the action and U shifted in place; no world is stepped without
    an ``Advance``."""
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
    epilogues = [dict(zip(EPILOGUE_ARGS, c)) for c in calls["combine_tail"]]
    assert len(calls["solve_partials"]) == 4 and len(calls["softmin_combine"]) == len(tails) == 1
    assert len(epilogues) == 3 and not calls["world_advance"]
    assert tuple(k for k in FULL if tails[0][k] is not None) == FULL
    asked = [tuple(k for k in ("u_seq", "u_next", "action") if e[k] is not None) for e in epilogues]
    assert asked == [ITERATE, ITERATE, CYCLE]
    assert epilogues[2]["u_next"] == U.data_ptr() and epilogues[2]["U"] != U.data_ptr()
    assert all(e["world"] == -1 and e["tickets"] == ctrl._tickets.data_ptr() for e in epilogues)
    assert ct.launch_counts()["combine_tail"] == 3 and st.launch_counts()["solve_tail"] == 1


# ---------------------------------------------------------------------------
# K2' (ops/combine_tail.py): the fold with the tail and the world's step


# the C entry's arguments, by name (csrc/combine_tail.cu, mppi_combine_tail)
EPILOGUE_ARGS = ("partials", "R", "nb", "T", "A", "lam", "beta_eta", "dU", "U", "max_a", "clamp",
                 "u_seq", "u_next", "action", "tickets", "world", "in", "out", "n_leaves",
                 "time_in", "time_out", "per_robot_clock", "params", "n_params", "steps", "xs", "us",
                 "ts", "n_hist", "step_ptr", "x_out", "one_block", "stream")


def _world_of_kind(kind: str):
    """A world whose K6 body is `kind`, from its config."""
    name = {"point_mass1": "point_mass1d", "point_mass2": "point_mass2d",
            "point_mass3": "point_mass3d"}.get(kind, kind)
    return make_world(load_config(os.path.join(ROOT, "configs", f"{name}.yaml")))


def _epilogue_inputs(R, T: int, A: int, nb: int, seed: int = 0):
    """partials (…, nb, 2 + T·A), U, max_a and λ from a numpy seed."""
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    partials = rng.uniform(0.0, 2.0, lead + (nb, 2 + T * A)).astype(np.float32)
    U = rng.uniform(-1.5, 1.5, lead + (T, A)).astype(np.float32)
    max_a = rng.uniform(0.3, 1.2, A).astype(np.float32)
    return (*_torch(partials, U, max_a), float(rng.choice([0.3, 1.1, 1.7])))


def _advance(name: str, R, n: int = 5, per_robot: bool = False):
    """An ``Advance`` of config `name`'s world for R robots (None: one
    robot, no robot axis): its start state, histories of n rows, x buffer."""
    cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    world = make_world(cfg)
    state = world.reset(R)
    if per_robot:
        state = world.from_x(state.x, torch.full((R,), world.params.timestep))
    state = type(state)(*(leaf.clone(memory_format=torch.contiguous_format) for leaf in state))
    lead = () if R is None else (R,)
    return ws.Advance(world, state, torch.zeros(n + 1, *lead, cfg.state_dim),
                      torch.zeros(n, *lead, cfg.action_dim), torch.zeros(n, *state.time.shape),
                      state.x.clone())


@pytest.mark.parametrize("name,R,per_robot", [
    ("point_mass2d", None, False), ("quadrotor3d", 4, False), ("quadrotor3d", 4, True),
    ("cartpole", 3, False), ("cartpole", 3, True)])
def test_cuda_bound_epilogue_passes_its_buffers(monkeypatch, name, R, per_robot):
    """Device-free: a CUDA-bound K2' call passes the partials, R, nb, T, A
    and λ, new β η and ΔU buffers, U and max_a by address, the clamp flag,
    u_seq (an inner iteration) or u_next over U in place and a new action
    (the cycle), the tickets, and with an ``Advance`` of a world with a K6
    body that world's id, its state's leaves (in place), clock and its
    layout, pack, steps_per_control, histories, the counter and the x buffer,
    as K6's entry takes them; without one, world −1 and null pointers. β and
    η come back as views of one (…, 2) buffer, as K2's; each launch counts
    once under K2', none under K2, K7 or K6."""
    calls = _stub(monkeypatch)
    adv = _advance(name, R, per_robot=per_robot)
    cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    T, A, nb = 6, cfg.action_dim, 5
    partials, U, max_a, lam = _epilogue_inputs(R, T, A, nb)
    rows = 1 if R is None else R
    tickets = torch.zeros(rows + 1, dtype=torch.int32)
    step = torch.tensor(2)
    beta, eta, dU, tail = ct.combine_tail(partials, lam, U, max_a, True, ITERATE, tickets)
    beta2, eta2, dU2, cyc = ct.combine_tail(partials, lam, U, max_a, False, CYCLE, tickets, into=U,
                                            step=step, advance=adv)
    assert len(calls["combine_tail"]) == 2 and ct.launch_counts()["combine_tail"] == 2
    assert not (calls["softmin_combine"] or calls["solve_tail"] or calls["world_advance"])
    a, b = (dict(zip(EPILOGUE_ARGS, c)) for c in calls["combine_tail"])
    for args, d, bt in ((a, dU, beta), (b, dU2, beta2)):
        assert (args["partials"], args["R"], args["nb"], args["T"], args["A"], args["lam"]) == (
            partials.data_ptr(), rows, nb, T, A, lam)
        assert (args["U"], args["max_a"], args["dU"], args["beta_eta"]) == (
            U.data_ptr(), max_a.data_ptr(), d.data_ptr(), bt.data_ptr())
        assert (args["tickets"], args["stream"]) == (tickets.data_ptr(), 5)
    assert eta.data_ptr() == beta.data_ptr() + 4 and beta.shape == eta.shape == U.shape[:-2]
    assert dU.shape == U.shape and tail.u_seq.shape == U.shape
    assert (a["clamp"], a["u_seq"], a["u_next"], a["action"]) == (1, tail.u_seq.data_ptr(), None,
                                                                  None)
    assert a["world"] == -1 and (a["in"], a["xs"], a["step_ptr"], a["x_out"]) == (None,) * 4
    assert (b["clamp"], b["u_seq"], b["u_next"], b["action"]) == (
        0, None, U.data_ptr(), cyc.action.data_ptr())
    assert cyc.u_next is U and cyc.action.shape == U.shape[:-2] + (A,)
    kind = adv.world._kernel_kind
    leaves = [leaf.data_ptr() for leaf in adv.state[:-1]]
    assert b["world"] == ws.WORLDS[kind][0] and b["n_leaves"] == len(leaves)
    assert list(b["in"])[:len(leaves)] == list(b["out"])[:len(leaves)] == leaves
    assert (b["time_in"], b["time_out"], b["per_robot_clock"]) == (
        adv.state.time.data_ptr(), adv.state.time.data_ptr(), int(per_robot))
    packed = adv.world._packs[torch.device("cpu")]
    assert (b["params"], b["n_params"], b["steps"]) == (packed.data_ptr(), packed.numel(),
                                                        adv.world.params.steps_per_control)
    assert (b["xs"], b["us"], b["ts"], b["n_hist"], b["step_ptr"], b["x_out"]) == (
        adv.xs.data_ptr(), adv.us.data_ptr(), adv.ts.data_ptr(), 5, step.data_ptr(),
        adv.x.data_ptr())


def test_epilogue_refuses_what_it_cannot_compute(monkeypatch):
    """Before any launch, a CUDA-bound K2' call refuses: a tail it does not
    compute (the weights' FULL), `into` without u_next, an ``Advance``
    without the cycle's action or without a counter tensor, float64 or
    non-contiguous partials or of another width, a non-contiguous U, R out
    of range, tickets of another dtype or size, and a world whose action dim
    is not the solve's. A refused launch raises with its error, counts
    nothing and falls back to nothing: K2, K7 and K6 are not called."""
    calls = _stub(monkeypatch, rc=700, failing="combine_tail")
    partials, U, max_a, lam = _epilogue_inputs(None, 4, 2, 3)
    tickets = torch.zeros(2, dtype=torch.int32)
    adv, step = _advance("point_mass2d", None), torch.tensor(0)

    def call(*args, **kw):
        base = dict(partials=partials, lam_softmin=lam, U=U, max_a=max_a, clamp=True,
                    outputs=CYCLE, tickets=tickets)
        base.update(kw)
        return ct.combine_tail(*args, **base)

    for kw, err, match in (
            (dict(outputs=FULL), ValueError, "computes the tails"),
            (dict(outputs=ITERATE, into=U), ValueError, "into"),
            (dict(outputs=ITERATE, advance=adv, step=step), ValueError, "action"),
            (dict(advance=adv, step=0), TypeError, "0-dim int64"),
            (dict(partials=partials.double()), TypeError, "float32"),
            (dict(partials=partials[:, :-1]), ValueError, "partials"),
            (dict(partials=torch.zeros(2 + 8, 3).t()), ValueError, "contiguous"),
            (dict(U=torch.zeros(2, 4).t()), ValueError, "contiguous"),
            (dict(tickets=torch.zeros(2, dtype=torch.int64)), ValueError, "int32"),
            (dict(tickets=torch.zeros(1, dtype=torch.int32)), ValueError, "R \\+ 1 = 2"),
            (dict(advance=_advance("pendulum", None), step=step), ValueError, "takes 1 actions"),
    ):
        with pytest.raises(err, match=match):
            call(**kw)
    R = fs.MAX_ROBOTS + 1
    with pytest.raises(ValueError, match="robots"):
        call(partials=torch.zeros(R, 1, 3), U=torch.zeros(R, 1, 1), max_a=torch.ones(1),
             tickets=torch.zeros(R + 1, dtype=torch.int32))
    assert not calls["combine_tail"]
    with pytest.raises(RuntimeError, match="combine_tail failed to launch: cudaError_t 700"):
        call(advance=adv, step=step)
    assert len(calls["combine_tail"]) == 1 and ct.launch_counts()["combine_tail"] == 0
    assert not (calls["softmin_combine"] or calls["solve_tail"] or calls["world_advance"])
    assert int(step) == 0 and not adv.xs.any()


@pytest.mark.parametrize("capturing", [False, True])
def test_only_an_epilogue_that_runs_is_counted(monkeypatch, capturing):
    """While the stream captures a CUDA graph K2''s entry is called (the
    graph records the launch) but nothing is counted."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    partials, U, max_a, lam = _epilogue_inputs(3, 4, 2, 3)
    ct.combine_tail(partials, lam, U, max_a, True, ITERATE, torch.zeros(4, dtype=torch.int32))
    assert len(calls["combine_tail"]) == 1
    assert ct.launch_counts()["combine_tail"] == (0 if capturing else 1)


def test_epilogue_steps_a_world_without_a_body_after_it(monkeypatch):
    """Device-free: with a world from user code (no K6 body) K2' launches
    without a world (−1) and the world's own torch ops then step it under
    the action K2' wrote, writing the histories and advancing the counter
    as ``advance_into`` does; K6 is not called."""
    from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld

    class UserWorld(PointMassWorld):
        pass

    calls = _stub(monkeypatch)
    adv = _advance("point_mass2d", None)
    adv = adv._replace(world=UserWorld(adv.world.params))
    partials, U, max_a, lam = _epilogue_inputs(None, 4, 2, 3)
    step = torch.tensor(1)
    x0 = adv.state.x.clone()
    _, _, _, cyc = ct.combine_tail(partials, lam, U, max_a, True, CYCLE,
                                   torch.zeros(2, dtype=torch.int32), into=U, step=step,
                                   advance=adv)
    (args,) = calls["combine_tail"]
    assert dict(zip(EPILOGUE_ARGS, args))["world"] == -1 and not calls["world_advance"]
    want = ws.plain_advance(adv.world, adv.world.from_x(x0, adv.world.reset().time), cyc.action)
    assert int(step) == 2 and torch.equal(adv.xs[2], want.x) and torch.equal(adv.x, want.x)
    assert torch.equal(adv.us[1], cyc.action)


@pytest.mark.parametrize("opt_iters", [1, 2])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
@pytest.mark.parametrize("R", [None, 3], ids=["solo", "fleet"])
def test_plain_epilogue_is_the_three_kernels_plain_versions(R, clamp, opt_iters):
    """On CPU tensors K2' is K2's, K7's and K6's plain versions in that
    order, bit for bit: β, η, ΔU, the tail's outputs (in place), the world's
    state, histories, x buffer and counter; ``opt_iters`` inner updates of U
    first, as the episode's cycle runs them."""
    name = "pendulum"
    cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    T, A, nb = 7, cfg.action_dim, 4
    got_adv, want_adv = _advance(name, R), _advance(name, R)
    step_got, step_want = torch.tensor(1), torch.tensor(1)
    combine = fs.fleet_softmin_combine if R is not None else fs.softmin_combine
    tickets = torch.zeros((R or 1) + 1, dtype=torch.int32)
    for j in range(opt_iters):
        partials, U, max_a, lam = _epilogue_inputs(R, T, A, nb, seed=j)
        last = j == opt_iters - 1
        form = CYCLE if last else ITERATE
        U_got, U_want = U.clone(), U.clone()
        got = ct.combine_tail(partials, lam, U_got, max_a, clamp, form, tickets,
                              into=U_got if last else None, step=step_got,
                              advance=got_adv if last else None)
        beta, eta, dU = combine(partials, lam, T, A)
        tail = st.solve_tail(U_want, dU, max_a, clamp, form, into=U_want if last else None)
        if last:
            ws.advance_into(want_adv.world, want_adv.state, tail.action, want_adv.xs, want_adv.us,
                            want_adv.ts, step_want, want_adv.x)
        for a, b in zip(got[:3], (beta, eta, dU)):
            assert torch.equal(a, b)
        for a, b in zip(got[3], tail):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
        assert torch.equal(U_got, U_want)
    for a, b in zip((*got_adv.state, got_adv.xs, got_adv.us, got_adv.ts, got_adv.x, step_got),
                    (*want_adv.state, want_adv.xs, want_adv.us, want_adv.ts, want_adv.x,
                     step_want)):
        assert torch.equal(a, b)
    assert not tickets.any()


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


def test_chip_smoke_tail_and_world_digests_run_on_the_cpu():
    """chip_smoke.py's digests of K7's and K6's outputs (``--time-commit``),
    on CPU tensors: one per case of the K7 check (here the row's round
    boundary), one per layout of the K6 check, the same on a second run."""
    import chip_smoke

    shapes = ((None, 341, 3, 50), (None, 256, 4, 50), (8, 1025, 1, 64))
    runs = []
    for _ in range(2):
        d = {}
        got = chip_smoke.check_solve_tail(device="cpu", shapes=shapes, digests=d)
        assert got["bit_equal"] and got["cases"] == 9
        for name in ("cartpole", "arm"):
            assert chip_smoke.check_world_step(name, device="cpu", digests=d)["bit_equal"]
        runs.append(d)
    assert len(runs[0]) == 9 + 2 * len(chip_smoke.WORLD_LAYOUTS)
    assert runs[0] == runs[1]
    assert len(set(runs[0].values())) == len(runs[0])


def test_chip_smoke_commit_times_launch_k7_and_k6(monkeypatch):
    """Device-free: chip_smoke.py's ``--time-commit`` entries for K7 and K6
    (``tail_world_commit_times``) with the C entries stubbed and the timers
    calling each function once: K7 launched at the flagship (R=1, T=200,
    A=3, K=10⁴) with every output and in the cycle's form, at R=8 and at
    point_mass2d's (T=50, A=2, K=3000); K6 at R=1 and R=8 for every world of
    WORLD_CASES; each entry with events, device time and the bound. Its
    kernel names: the identities' probe kernel apart from K6's instances,
    K7's two block widths apart (one name in a package before them)."""
    import chip_smoke

    calls = _stub(monkeypatch)
    monkeypatch.setattr(chip_smoke, "paired_median_ms", lambda k, p, r, pr: (k(), p(), 1.0, 2.0)[2:])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, name=None, **kw: (fn(), 0.5)[1])
    got = chip_smoke.tail_world_commit_times(device="cpu")
    assert len(got) == 4 + 2 * len(chip_smoke.WORLD_CASES)
    assert all(r["ms"] == 1.0 and r["device_ms"] == 0.5 and r["bound_ms"] > 0 for r in got.values())
    k7 = [dict(zip(ENTRY_ARGS, c)) for c in calls["solve_tail"]]
    shapes = sorted({(c["R"], c["T"], c["A"], c["K"], c["weights"] is not None) for c in k7})
    assert shapes == [(1, 50, 2, 3000, True), (1, 200, 3, 0, False), (1, 200, 3, 10_000, True),
                      (8, 200, 3, 10_000, True)]
    kinds = {ws.pack_fields(chip_smoke._world_of(n))[0] for n in chip_smoke.WORLD_CASES}
    ids = {c[0] for c in calls["world_advance"]}
    assert ids == {ws.WORLDS[k][0] for k in kinds}
    assert {c[12] for c in calls["world_advance"]} == {1, 8}  # R
    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_123world_identities_kernelEPyPj") == \
        "world_identities"
    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_117solve_tail_kernelILi256EEEvNS_8TailArgsE") \
        == "solve_tail<256>"
    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_117solve_tail_kernelENS_8TailArgsE") == "solve_tail"


def test_chip_smoke_closed_loop_shares_runs_on_the_cpu():
    """chip_smoke.py's weighing shares of a closed loop drive
    ``runner.EpisodeCycle`` with a solve of their own (the full fleet solve,
    its costs kept, U shifted in place): on the CPU, a whole point_mass3d
    episode of an R=2 fleet at K=64 gives a share in [0, 1] at each mark."""
    import chip_smoke

    got = chip_smoke.closed_loop_shares("point_mass3d", 2, 64, device="cpu")
    assert (got["R"], got["K"], got["family"]) == (2, 64, "lti")
    assert all(0.0 <= got[k] <= 1.0 for k in ("first", "middle", "last"))


@pytest.mark.parametrize("name,R,clocks,opt_iters", [
    ("pendulum", 8, "per-robot", 2), ("point_mass2d", None, "shared", 1),
    ("quadrotor3d", 8, "nan", 1)])
def test_chip_smoke_epilogue_cycle_check_runs_on_the_cpu(name, R, clocks, opt_iters):
    """chip_smoke.py's check of the epilogue cycle against the four-kernel
    cycle, on CPU tensors, where both run the plain versions: bit-equal over
    its cycles (x, U, the state and its clock, the histories, the counter),
    at a fleet with per-robot clocks, one robot and a fleet with a NaN
    state."""
    import chip_smoke

    got = chip_smoke.check_epilogue_cycle(name, R, clocks, opt_iters, device="cpu")
    assert got == {"bit_equal": True, "max_abs_err": 0.0}


@pytest.mark.parametrize("name,R", [("cartpole", 8), ("arm", None)])
def test_chip_smoke_epilogue_plain_check_runs_on_the_cpu(name, R):
    """chip_smoke.py's check of K2' against its plain version, on CPU
    tensors (both sides the plain version): β, η and ΔU agree, the tail and
    the world step bit for bit, the counter advanced, the tickets 0."""
    import chip_smoke

    assert chip_smoke.check_epilogue_plain(name, R, device="cpu") == {"max_abs_err": 0.0}


def test_chip_smoke_names_the_epilogue_instances():
    """chip_smoke.py's kernel names (``--sass-diff``, ptxas lines) tell K2''s
    instances apart by world body, the tail alone as NoWorld, and keep K2's
    own name."""
    import chip_smoke

    mangled = ("_ZN12_GLOBAL__N_119combine_tail_kernelINS_5world9PointMassILi3EEEEEvPKfiifPfS6_"
               "NS_12EpilogueArgsE")
    assert chip_smoke.kernel_key(mangled) == "combine_tail<PointMass3>"
    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_119combine_tail_kernelINS_7NoWorldEEEvPKf"
                                 ) == "combine_tail<NoWorld>"
    assert chip_smoke.kernel_key("_ZN12_GLOBAL__N_122softmin_combine_kernelEPKfiifiPfS2_"
                                 ) == "softmin_combine"
    assert chip_smoke.cycle_kernels(1) == 2 and chip_smoke.cycle_kernels(2) == 4


@pytest.mark.gpu
def test_epilogue_on_the_card():
    """On the card: the epilogue cycle bit-equal to the four-kernel cycle and
    K2' against its plain version, at a few layouts (chip_smoke.py runs every
    config of EPISODE_CONFIGS)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2' has no CPU mode")
    import chip_smoke

    for name, R, clocks in (("pendulum", 8, "per-robot"), ("flagship", None, "shared"),
                            ("quadrotor3d", 64, "nan")):
        assert chip_smoke.check_epilogue_cycle(name, R, clocks, 2)["bit_equal"]
    chip_smoke.check_epilogue_plain("cartpole", 8)


@pytest.mark.gpu
def test_tail_kernel_on_the_card():
    """On the card: K7 against its plain version, bit for bit, at small
    shapes of every mode (chip_smoke.py runs every shape of TAIL_SHAPES)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    import chip_smoke

    got = chip_smoke.check_solve_tail(device="cuda", shapes=((None, 1, 3, 50), (8, 200, 4, 3000)))
    assert got["bit_equal"] and got["launches"] == 3 * got["cases"]
