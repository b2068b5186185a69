"""The port's multi-GPU path (``mppi_gpu_tpu_torch.parallel``) against the
JAX package and against its own solo solve, on the CPU.

- K5's plain version (``fused_solve.weighted_update_reference``) against
  TPU kernel #7 (``pallas_weighted_update``) run as tests/test_pallas.py
  runs it (testmode pseudo-noise, interpret mode), on the kernel's own ε;
- the one-pass combine and the softmin across ranks, device-free, with a
  rank whose rollouts all cost +inf;
- the sharded Philox solve on n virtual ranks, each at its draw offset,
  against the solo solve at the same K (chip_smoke.check_sharded);
- gloo process groups of 2 and 4 ranks (tests/_torch_dist_worker.py, one
  process per rank, each group meeting at a ``file://`` store under the
  test's temporary directory): ``solve_with_eps`` on the JAX sharded
  solve's per-shard ε against that solve, the Philox solve against the solo
  one, the all-reduces per update, the sharded fleet bit for bit against
  ``BatchedMPPIController``, ``init_multihost``'s re-calls, and the debug
  dump built on the coordinator alone;
- device-free, with ``torch.cuda``'s device selection stubbed: each kernel
  launches on its tensors' device and stream, and ``make_mesh`` binds the
  process to its rank's GPU;
- uneven K and R, and the CLI's ``--sharded``, ``--multihost`` and
  ``--coordinator``.

Tests marked `gpu` run K5 and the sharded solve on the card through
chip_smoke's checks and skip without a CUDA device.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.controller import sample_noise as jax_sample_noise  # noqa: E402
from mppi_gpu_tpu.models import PointMassLTI as JaxPointMass  # noqa: E402
from mppi_gpu_tpu.ops import cost as jc  # noqa: E402
from mppi_gpu_tpu.ops import pallas_rollout as pr  # noqa: E402
from mppi_gpu_tpu.ops.softmin import softmin_weights as jax_softmin  # noqa: E402
from mppi_gpu_tpu.parallel import ShardedMPPIController as JaxShardedController  # noqa: E402
from mppi_gpu_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mppi_gpu_tpu_torch import cli  # noqa: E402
from mppi_gpu_tpu_torch.batched import BatchedMPPIController  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops.cost import goal_of  # noqa: E402
from mppi_gpu_tpu_torch.parallel import (  # noqa: E402
    ShardedFleetController,
    ShardedMPPIController,
    init_multihost,
    make_mesh,
    sharded_mppi_solve,
)
from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh  # noqa: E402
from mppi_gpu_tpu_torch.runner import run_fleet_episode  # noqa: E402
from mppi_gpu_tpu_torch.parallel.sharded import (  # noqa: E402
    COLLECTIVES,
    onepass_combine,
    softmin_across,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
PM2 = os.path.join(ROOT, "configs", "point_mass2d.yaml")
PENDULUM = os.path.join(ROOT, "configs", "pendulum.yaml")
# the sharded solve against the JAX one on the same ε:
# tests/test_sharding.py's tolerances (action and u_next rtol 1e-4 atol 1e-6,
# S rtol 1e-5, β rtol 1e-6), η at rtol 1e-5 (a sum of K terms in f32)
U_TOL = dict(rtol=1e-4, atol=1e-6)
# the port against itself on one stream: S and β bit for bit; η and ΔU are
# f32 sums of K terms in another order (per rank, then across the ranks)
ORDER_TOL = dict(rtol=1e-5, atol=1e-7)
# where the modes of the Philox tasks are named
MODES = {"iid": {}, "antithetic": dict(antithetic=True), "ou": dict(noise_beta=0.5),
         "two-iterations": dict(opt_iters=2)}


def _rank_rollouts(K: int, n: int, d: int, antithetic: bool) -> torch.Tensor:
    """The solo solve's rollout indices that rank d of n rolls out: its K/n
    draws from its offset on, then (antithetic) their mirrors."""
    k_loc = K // n
    if not antithetic:
        return torch.arange(d * k_loc, (d + 1) * k_loc)
    h = k_loc // 2
    return torch.cat([torch.arange(d * h, (d + 1) * h), K // 2 + torch.arange(d * h, (d + 1) * h)])


def _spawn(tmp, n: int, tasks: list) -> list[list]:
    """Run `tasks` on a gloo group of n worker processes; each rank's results."""
    os.makedirs(tmp, exist_ok=True)
    spec = os.path.join(tmp, "spec.pt")
    torch.save(dict(world=n, init="file://" + os.path.join(tmp, "init"), tasks=tasks), spec)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, WORKER, spec, str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = [p.communicate(timeout=180) for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
    return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False) for r in range(n)]


# ---------------------------------------------------------------------------
# (a) K5's plain version against TPU kernel #7


@pytest.mark.parametrize("A,K,T,anti,ou", [(2, 300, 12, False, 0.0), (3, 514, 9, True, 0.0),
                                           (2, 300, 12, False, 0.5)])
def test_weighted_update_plain_matches_pallas_kernel(A, K, T, anti, ou):
    """``pallas_weighted_update`` (TPU kernel #7, interpret mode, testmode
    pseudo-noise) with the softmin weights of ``pallas_rollout_costs``'s S
    against ``weighted_update_reference`` on the kernel's own ε (its host
    twin, rank order, so the antithetic mirrors sit where S has them) within
    rtol 1e-5, atol 1e-7: f32 sums of K terms in two orders. On CPU tensors
    ``weighted_update`` is that plain version and launches nothing."""
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
    eps = torch.tensor(np.asarray(pr.fake_noise_tensor(plan, sigma, ou_beta=ou, key=key))[:, :K])
    w_t = torch.tensor(np.asarray(w))
    got = fs.weighted_update_reference(w_t, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(dU_j), rtol=1e-5, atol=1e-7)
    fs.reset_launch_counts()
    wrapped = fs.weighted_update(torch.tensor(np.asarray(sigma)), w_t, T, K, 0, 0, 0, False,
                                 0.0, eps=eps.contiguous())
    assert torch.equal(wrapped, got) and fs.launch_counts()["weighted_update"] == 0


def test_weighted_update_philox_mode_on_the_cpu_is_the_plain_stream():
    """Philox mode on CPU tensors: Σ w ε over the port's stream from draw k0
    on (iid, antithetic, OU), as ``noise_dump`` writes it; wrong shapes raise."""
    sigma, K, T = torch.tensor([0.3, 0.5]), 64, 6
    w = torch.softmax(torch.randn(K, generator=torch.Generator().manual_seed(0)), 0)
    for anti, ou, k0 in ((False, 0.0, 0), (True, 0.0, 32), (False, 0.5, 640)):
        eps = fs.noise_dump(sigma, T, K, 9, 2, 1, anti, ou, k0=k0)
        assert torch.equal(fs.weighted_update(sigma, w, T, K, 9, 2, 1, anti, ou, k0=k0),
                           fs.weighted_update_reference(w, eps))
    with pytest.raises(ValueError, match="w must have shape"):
        fs.weighted_update(sigma, w[:-1], T, K, 9, 2, 1, False, 0.0)
    with pytest.raises(ValueError, match="even K"):
        fs.weighted_update(sigma, torch.ones(K - 1), T, K - 1, 9, 2, 1, True, 0.0)
    with pytest.raises(ValueError, match="32-bit"):
        fs.weighted_update(sigma, w, T, K, 9, 2, 1, False, 0.0, k0=-1)


# ---------------------------------------------------------------------------
# (b) the combine, device-free


def test_onepass_combine_equals_the_global_softmin_with_an_all_inf_rank():
    """Per-rank unnormalized solves (K1 + K2 without the division, plain
    versions) combined by ``onepass_combine`` equal the softmin over the
    union, and ``softmin_across`` gives its weights, when rank 2's rollouts
    all cost +inf: its β_d is +inf, its η_d and ΔŨ_d NaN, and its f_d = 0
    drops them instead of spreading the NaN."""
    n, k_loc, T = 4, 64, 7
    cfg = load_config(PM2).replace(samples=n * k_loc, horizon=T, lambda_=0.8)
    ctrl = MPPIController(cfg, device="cpu")
    x, U = torch.tensor([0.2, -0.1, 0.05, 0.0]), 0.05 * torch.ones(T, 2)
    eps = ctrl._eps(17, 0, 0).clone()
    eps[:, 2 * k_loc:3 * k_loc] = 1e30
    cores = [fs.family_fused_solve(ctrl._family, x, U, goal_of(ctrl.cost), cfg.lambda_, k_loc,
                                   0, 0, 0, False, 0.0, normalize=False,
                                   eps=eps[:, d * k_loc:(d + 1) * k_loc].contiguous())
             for d in range(n)]
    S_d, beta_d, eta_d, dU_d = (torch.stack(v) for v in zip(*cores))
    assert beta_d[2] == float("inf") and torch.isnan(eta_d[2]) and torch.isnan(dU_d[2]).all()
    reduce = virtual_mesh(n, "cpu").all_reduce
    beta, eta, dU = onepass_combine(beta_d, eta_d, dU_d, cfg.lambda_, reduce)
    want = ctrl.solve_with_eps(x, U, eps).info
    assert beta == want.beta and torch.isfinite(dU).all()
    np.testing.assert_allclose(float(eta), float(want.eta), **ORDER_TOL)
    dU_want = torch.einsum("tka,k->ta", eps, want.weights)
    np.testing.assert_allclose(dU.numpy(), dU_want.numpy(), **ORDER_TOL)
    b2, e2, w2 = softmin_across(S_d, cfg.lambda_, reduce)
    assert b2 == want.beta and (w2[2] == 0).all()
    np.testing.assert_allclose(w2.reshape(-1).numpy(), want.weights.numpy(), **ORDER_TOL)


# ---------------------------------------------------------------------------
# (c) the draw offsets: the sharded solve is the solo solve's rollouts


@pytest.mark.parametrize("mode", ["iid", "antithetic", "ou"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_philox_solve_equals_the_solo_solve(n, mode):
    """n virtual ranks, each at its draw offset, both branches: each rank's S
    the solo solve's for its rollouts bit for bit, β equal, η and the action
    within f32 (chip_smoke.check_sharded)."""
    import chip_smoke

    cfg = load_config(os.path.join(ROOT, "configs", "point_mass3d.yaml")).replace(
        samples=256, horizon=12, **MODES[mode])
    out = chip_smoke.check_sharded(cfg, virtual_mesh(n, "cpu"), device="cpu")
    assert set(out) == {"one-pass", "two-kernel"}


def test_sharded_solve_with_two_iterations_follows_the_solo_solve():
    """opt_iters = 2: the first update's ΔU differs from the solo one's by its
    order of summation, so the second update's S is held to rtol 1e-5, the
    action to f32 (ORDER_TOL), in both branches; the functional
    ``sharded_mppi_solve`` is the controller's solve."""
    cfg = load_config(PM2).replace(samples=256, horizon=10, opt_iters=2, noise_beta=0.5)
    solo = MPPIController(cfg, device="cpu")
    x, U = torch.tensor([0.3, -0.2, 0.0, 0.1]), solo.init_action_seq() + 0.1
    want = solo.solve(x, U, 4, 3)
    mesh = virtual_mesh(4, "cpu")
    for onepass in (True, False):
        got = ShardedMPPIController(cfg, mesh=mesh, onepass=onepass).solve(x, U, 4, 3)
        np.testing.assert_allclose(got.info.costs.numpy(), want.info.costs.numpy(), rtol=1e-5)
        np.testing.assert_allclose(got.action.numpy(), want.action.numpy(), **ORDER_TOL)
        fn = sharded_mppi_solve(mesh, solo.dynamics, solo.cost, x, U, seed=4, step=3,
                                sigma=solo.sigma, lambda_=cfg.lambda_, max_a=solo.max_a,
                                K=cfg.samples, antithetic=False, ou_beta=0.5, opt_iters=2,
                                onepass=onepass)
        assert all(torch.equal(a, b) for a, b in zip(fn.info, got.info))


def test_sharded_solve_debug_dumps_the_single_gpu_stream():
    """``solve_debug`` on four ranks: the dump is the single-GPU stream at
    the global K (what the ranks drew between them), its rollouts and costs
    the solo dump's bit for bit, its weights and action within f32."""
    cfg = load_config(PM2).replace(samples=128, horizon=8)
    solo = MPPIController(cfg, device="cpu")
    ctrl = ShardedMPPIController(cfg, mesh=virtual_mesh(4, "cpu"))
    x, U = torch.tensor([0.1, 0.0, 0.0, 0.2]), solo.init_action_seq()
    (res, eps, xs), (want, eps_w, xs_w) = ctrl.solve_debug(x, U, 3), solo.solve_debug(x, U, 3)
    assert torch.equal(eps, eps_w) and torch.equal(xs, xs_w)
    assert torch.equal(res.info.costs, want.info.costs)
    np.testing.assert_allclose(res.info.weights.numpy(), want.info.weights.numpy(), **ORDER_TOL)
    np.testing.assert_allclose(res.action.numpy(), want.action.numpy(), **ORDER_TOL)


# ---------------------------------------------------------------------------
# (d) gloo process groups of 2 and 4 ranks


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n={n}")
def gloo(request, tmp_path_factory):
    """One group of n worker processes running every task of this section:
    the JAX sharded solve's ε through ``solve_with_eps``, the Philox solve
    in each mode, two fleets, ``init_multihost``'s re-calls, the debug
    dump."""
    n = request.param
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
    eps = np.concatenate([np.asarray(jax_sample_noise(jax.random.fold_in(key, d), T, K // n, 2, sigma))
                          for d in range(n)], axis=1)
    xt, Ut = torch.as_tensor(x), torch.as_tensor(U)
    tasks = [("solve", dict(cfg=cfg, x=xt, U=Ut, onepass=o, eps=torch.as_tensor(eps)))
             for o in (True, False)]
    # K/n a multiple of 32 for the Philox tasks: the eager rollout sums its
    # step costs with torch.sum over t, which on the CPU takes a batch in
    # chunks of 32 rollouts and a narrower tail in another order
    tasks += [("solve", dict(cfg=cfg.replace(samples=128, **MODES[m]), x=xt, U=Ut, onepass=o,
                             seed=3, step=2))
              for m in MODES for o in (True, False)]
    R = 4
    goals = torch.as_tensor(rng.normal(size=(R, 4)).astype(np.float32))
    xs = torch.as_tensor((rng.normal(size=(R, 4)) * 0.1).astype(np.float32))
    pend = load_config(PENDULUM).replace(samples=K, horizon=T)
    ps = torch.as_tensor(np.pi - rng.uniform(0.1, 0.5, (R, 2)).astype(np.float32))
    tasks += [("fleet", dict(cfg=cfg, n_robots=R, xs=xs, goals=goals)),
              ("fleet", dict(cfg=pend, n_robots=R, xs=ps)), ("multihost", {}),
              ("debug", dict(cfg=cfg.replace(samples=128), x=xt, U=Ut, step=3))]
    ranks = _spawn(tmp_path_factory.mktemp(f"gloo{n}"), n, tasks)
    return dict(n=n, cfg=cfg, x=xt, U=Ut, jres=jres, tasks=tasks, ranks=ranks)


def _task_results(gloo, name: str):
    """(kwargs, [rank results]) of every task called `name`."""
    return [(kw, [r[i] for r in gloo["ranks"]])
            for i, (task, kw) in enumerate(gloo["tasks"]) if task == name]


def test_sharded_matches_the_jax_sharded_solve(gloo):
    """``solve_with_eps`` on the JAX sharded solve's per-shard ε (its
    fold_in keys, rebuilt as tests/test_sharding.py does): action, u_next, β
    and η equal to the JAX solve's on every rank, and each rank's costs its
    slice of the JAX costs, in both branches."""
    n, jres = gloo["n"], gloo["jres"]
    k_loc = gloo["cfg"].samples // n
    for kw, ranks in _task_results(gloo, "solve")[:2]:
        for d, (got, _) in enumerate(ranks):
            label = f"n={n} onepass={kw['onepass']} rank {d}"
            np.testing.assert_allclose(got["action"].numpy(), np.asarray(jres.action), **U_TOL,
                                       err_msg=label)
            np.testing.assert_allclose(got["u_next"].numpy(), np.asarray(jres.u_next), **U_TOL,
                                       err_msg=label)
            np.testing.assert_allclose(float(got["beta"]), float(jres.info.beta), rtol=1e-6)
            np.testing.assert_allclose(float(got["eta"]), float(jres.info.eta), rtol=1e-5)
            np.testing.assert_allclose(got["costs"].numpy(),
                                       np.asarray(jres.info.costs)[d * k_loc:(d + 1) * k_loc],
                                       rtol=1e-5, err_msg=label)


def test_gloo_sharded_philox_solve_equals_the_solo_solve(gloo):
    """Over the group, each mode and branch: rank d's costs the solo solve's
    for its rollouts (bit for bit for one update; rtol 1e-5 after a first
    update whose ΔU was summed in another order), β equal, η and the action
    within f32."""
    n = gloo["n"]
    for kw, ranks in _task_results(gloo, "solve")[2:]:
        cfg = kw["cfg"]
        want = MPPIController(cfg, device="cpu").solve(gloo["x"], gloo["U"], 3, 2)
        for d, (got, _) in enumerate(ranks):
            label = f"n={n} {cfg.antithetic=} {cfg.noise_beta=} {cfg.opt_iters=} {kw['onepass']=}"
            S_want = want.info.costs[_rank_rollouts(cfg.samples, n, d, cfg.antithetic)]
            if cfg.opt_iters == 1:
                assert torch.equal(got["costs"], S_want), label
                assert torch.equal(got["beta"], want.info.beta), label
            else:
                np.testing.assert_allclose(got["costs"].numpy(), S_want.numpy(), rtol=1e-5)
            np.testing.assert_allclose(float(got["eta"]), float(want.info.eta), **ORDER_TOL)
            np.testing.assert_allclose(got["action"].numpy(), want.action.numpy(), **ORDER_TOL,
                                       err_msg=label)


def test_collectives_per_update(gloo):
    """The tripwire: ``COLLECTIVES`` all-reduces per update of each branch
    (one-pass: the min of β and one sum of η packed with ΔU; two-kernel:
    the min, the sum of η, the sum of ΔU), counted by wrapping the ``dist``
    calls, no all_gather; the sharded fleet one all_gather per update (the
    pendulum's config updates twice per solve)."""
    assert COLLECTIVES == {"onepass": 2, "two-kernel": 3}
    for kw, ranks in _task_results(gloo, "solve"):
        want = COLLECTIVES["onepass" if kw["onepass"] else "two-kernel"] * kw["cfg"].opt_iters
        for _, calls in ranks:
            assert calls == {"all_reduce": want, "all_gather": 0}
    for kw, ranks in _task_results(gloo, "fleet"):
        want = {"all_reduce": 0, "all_gather": kw["cfg"].opt_iters}
        assert all(calls == want for _, calls in ranks)


def test_sharded_fleet_equals_the_fleet_bit_for_bit(gloo):
    """R = 4 robots over the group (the point mass with goals, the goal-less
    pendulum): every leaf of every rank's result, the whole fleet's, equal
    to ``BatchedMPPIController``'s."""
    for kw, ranks in _task_results(gloo, "fleet"):
        fleet = BatchedMPPIController(kw["cfg"], kw["n_robots"], device="cpu", goals=kw.get("goals"))
        want = fleet.solve(kw["xs"], fleet.init_action_seqs(), fleet.init_seeds(), 1)
        want = dict(action=want.action, u_next=want.u_next, **want.info._asdict())
        for got, _ in ranks:
            for k, v in want.items():
                assert torch.equal(got[k], v), (kw["cfg"].env, k)


def test_sharded_fleet_episode_equals_the_fleet_episode(tmp_path):
    """``run_fleet_episode`` on a ``ShardedFleetController`` over a gloo
    world of one (a worker process) runs as it does on the unsharded
    ``BatchedMPPIController``: xs, us and the clock bit for bit, the point
    mass with its goals and the goal-less pendulum, 6 cycles of 4 robots."""
    for name in ("point_mass2d", "pendulum"):
        cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml")).replace(samples=64,
                                                                                horizon=8)
        ((got,),) = _spawn(tmp_path / name, 1,
                           [("fleet_episode", dict(cfg=cfg, n_robots=4, num_steps=6))])
        want = run_fleet_episode(BatchedMPPIController(cfg, 4, device="cpu"), num_steps=6)
        for k in ("xs", "us", "times"):
            assert np.array_equal(got[k], getattr(want, k)), (name, k)


# a gloo world of one in a fresh process: the threads of the process before
# the group, with it after a fleet episode (whose cycle, cached on the
# controller, holds the controller and its mesh in a reference cycle), and
# after shutdown_multihost; the mesh's group after it
TEARDOWN = """
import os, sys, tempfile
import torch
torch.set_num_threads(1)
from mppi_gpu_tpu_torch.config import load_config
from mppi_gpu_tpu_torch.parallel import ShardedFleetController, global_mesh, init_multihost
from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost
from mppi_gpu_tpu_torch.runner import run_fleet_episode
def threads():
    return len(os.listdir("/proc/self/task"))
before = threads()
init_multihost("file://" + os.path.join(tempfile.mkdtemp(), "init"), 1, 0, backend="gloo")
cfg = load_config(sys.argv[1]).replace(samples=64, horizon=8)
ctrl = ShardedFleetController(cfg, 4, mesh=global_mesh("cpu"))
run_fleet_episode(ctrl, num_steps=3)
during = threads()
shutdown_multihost()
print(before, during, threads(), ctrl.mesh.group is None)
"""


def test_shutdown_multihost_joins_the_group_threads(tmp_path):
    """``shutdown_multihost`` leaves no thread of gloo's process group
    behind, though a fleet episode's cycle cached on its controller still
    holds the controller's mesh: the mesh names the default group and does
    not hold it, so ``destroy_process_group`` destroys it and joins its
    threads then, and not during the interpreter's exit, where CPython ends
    a thread that asks for the GIL and the C++ runtime aborts the process
    ("terminate called without an active exception"). The process exits 0."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run([sys.executable, "-c", TEARDOWN, PM2], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    before, during, after, no_group = out.stdout.split()
    assert int(during) > int(before) and int(after) == int(before), out.stdout
    assert no_group == "True"


def test_init_multihost_recalls(gloo):
    """A re-call with the first call's arguments or with none returns (rank,
    world); one with other arguments raises RuntimeError; rank 0 alone is
    the coordinator."""
    n = gloo["n"]
    ((_, ranks),) = _task_results(gloo, "multihost")
    for d, got in enumerate(ranks):
        assert got["same"] == got["bare"] == (d, n)
        assert got["conflict"] is not None and "conflicting" in got["conflict"]
        assert got["coordinator"] == (d == 0)


def test_solve_debug_dumps_on_the_coordinator_alone(gloo):
    """``solve_debug`` over the group: the coordinator's dump is the solo
    dump of the whole K (ε and trajectories bit for bit); every other rank
    builds none, gets None for both, and the coordinator's action."""
    ((kw, ranks),) = _task_results(gloo, "debug")
    _, eps_w, xs_w = MPPIController(kw["cfg"], device="cpu").solve_debug(kw["x"], kw["U"],
                                                                         kw["step"])
    assert torch.equal(ranks[0]["eps"], eps_w) and torch.equal(ranks[0]["xs"], xs_w)
    for got in ranks[1:]:
        assert got["eps"] is None and got["xs"] is None
        assert torch.equal(got["action"], ranks[0]["action"])


# ---------------------------------------------------------------------------
# (e) the device a rank's work runs on


class _FakeCudaDevices:
    """Stands in for ``torch.cuda``'s device selection on the CPU: the
    current device index, and the devices asked for their current stream or
    made current."""

    def __init__(self, monkeypatch):
        self.current, self.set, self.streams = 0, [], []
        monkeypatch.setattr(torch.cuda, "device", self._device)
        monkeypatch.setattr(torch.cuda, "current_stream", self._stream)
        monkeypatch.setattr(torch.cuda, "set_device", self._set_device)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    @contextlib.contextmanager
    def _device(self, device):
        prev, self.current = self.current, torch.device(device).index
        try:
            yield
        finally:
            self.current = prev

    def _stream(self, device=None):
        self.streams.append(torch.device(device).index)
        return types.SimpleNamespace(cuda_stream=100 + torch.device(device).index)

    def _set_device(self, device):
        self.set.append(torch.device(device))


def test_kernels_launch_on_the_device_of_their_tensors(monkeypatch):
    """Device-free: ``fused_solve._launch`` calls a C entry with the CUDA
    runtime's current device set to the tensors' device (cuda:2 here, while
    the thread's is cuda:0) and that device's current stream as its last
    argument, restores the thread's device, and raises on a launch error;
    every C entry of ``fused_solve`` goes out through it."""
    cuda = _FakeCudaDevices(monkeypatch)
    seen = []
    fs._launch("k", lambda *a: seen.append((cuda.current, a)) or 0, torch.device("cuda", 2), 7, 8)
    assert seen == [(2, (7, 8, 102))] and cuda.streams == [2] and cuda.current == 0
    with pytest.raises(RuntimeError, match=r"k<A=3> failed to launch: cudaError_t 700"):
        fs._launch("k<A=3>", lambda *a: 700, torch.device("cuda", 1))
    assert cuda.current == 0
    src = inspect.getsource(fs)
    assert not re.search(r"lib\.mppi_\w+\(", src)  # no entry called around _launch
    entries = re.findall(r"_launch\(\s*[^,]+,\s*lib\.(mppi_\w+),\s*\w+\.device,", src)
    assert sorted(entries) == ["mppi_family_solve_partials", "mppi_family_solve_residency",
                               "mppi_noise_dump", "mppi_softmin_combine", "mppi_solve_partials",
                               "mppi_solve_residency", "mppi_weighted_update"]


def test_make_mesh_binds_the_process_to_its_gpu(monkeypatch):
    """``make_mesh`` makes a rank's CUDA device the process's current one:
    ``cuda:LOCAL_RANK`` by default (torchrun's variable), or the device
    given; a CPU mesh selects no GPU."""
    cuda = _FakeCudaDevices(monkeypatch)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_mesh().device == torch.device("cuda", 3)
    assert make_mesh("cuda:1").device == torch.device("cuda", 1)
    make_mesh("cpu")
    assert cuda.set == [torch.device("cuda", 3), torch.device("cuda", 1)]


# ---------------------------------------------------------------------------
# (f) what raises, and the CLI


def test_sharded_fleet_solve_with_eps_on_virtual_ranks():
    """The injected-ε fleet solve over two virtual ranks (each its robots'
    rows of ε) equals ``BatchedMPPIController``'s, every leaf bit for bit."""
    cfg = load_config(PENDULUM).replace(samples=64, horizon=8)
    R = 4
    fleet = BatchedMPPIController(cfg, R, device="cpu")
    sharded = ShardedFleetController(cfg, R, mesh=virtual_mesh(2, "cpu"))
    rng = np.random.default_rng(5)
    xs = torch.as_tensor((np.pi - rng.uniform(0.1, 0.5, (R, 2))).astype(np.float32))
    eps = torch.as_tensor((0.8 * rng.standard_normal((R, 8, 64, 1))).astype(np.float32))
    Us = fleet.init_action_seqs()
    want, got = fleet.solve_with_eps(xs, Us, eps), sharded.solve_with_eps(xs, Us, eps)
    for a, b in zip([want.action, want.u_next, *want.info], [got.action, got.u_next, *got.info]):
        assert torch.equal(a, b)


def test_uneven_K_and_R_raise():
    mesh = virtual_mesh(2, "cpu")
    cfg = load_config(PM2).replace(samples=13, horizon=4)
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedMPPIController(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="even per-rank"):
        ShardedMPPIController(cfg.replace(samples=12, antithetic=True), mesh=virtual_mesh(4, "cpu"))
    with pytest.raises(ValueError, match="n_robots=3 must divide evenly"):
        ShardedFleetController(cfg.replace(samples=16), 3, mesh=mesh)
    with pytest.raises(ValueError, match="n >= 1"):
        virtual_mesh(0, "cpu")
    with pytest.raises(ValueError, match="or none of them"):
        init_multihost("localhost:1234", 2)
    assert make_mesh("cpu").size == 1 and make_mesh("cpu").group is None


def test_cli_sharded_on_the_cpu(capsys, tmp_path, monkeypatch):
    """``--sharded --device cpu`` without torchrun: a world of one, exit 0."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    traj = tmp_path / "traj.csv"
    rc = cli.main(["-c", PM2, "--device", "cpu", "--sharded", "--max-steps", "5", "-t", str(traj)])
    out = capsys.readouterr().out
    assert rc == 0 and "episode finished: 5 control steps" in out and traj.exists()


@pytest.mark.parametrize("argv,needle", [
    (["--multihost", "--coordinator", "localhost:1234"], "--coordinator requires"),
    (["--multihost"], "--multihost needs"),
])
def test_cli_multihost_wiring_errors_exit_2(capsys, monkeypatch, argv, needle):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = cli.main(["-c", PM2, "--device", "cpu", "--max-steps", "1", *argv])
    assert rc == 2 and needle in capsys.readouterr().err


def test_cli_multihost_over_two_gloo_processes(tmp_path):
    """``--multihost --coordinator file://... --num-processes 2 --process-id
    r`` on two processes: both exit 0 and print their coordinates; only the
    coordinator writes the trajectory."""
    init = "file://" + str(tmp_path / "cli-init")
    argv = ["-c", PM2, "--device", "cpu", "--max-steps", "4", "-t", str(tmp_path / "traj.csv"),
            "--multihost", "--coordinator", init, "--num-processes", "2"]
    ranks = _spawn(str(tmp_path / "cli"), 2, [("cli", dict(argv=argv))])
    for d, (got,) in enumerate(ranks):
        assert got["rc"] == 0, got["out"]
        assert f"multihost: process {d}/2, world 2" in got["out"]
        assert ("trajectory written to" in got["out"]) == (d == 0)
    assert len((tmp_path / "traj.csv").read_text().splitlines()) == 5


def test_chip_smoke_sharded_checks_run_on_the_cpu():
    """chip_smoke.py's K5, model-reassignment, sharded-fleet and process-group
    checks on the CPU with the plain versions (the group: two spawned gloo
    ranks)."""
    import chip_smoke

    assert chip_smoke.check_weighted_update(3, 300, 10, device="cpu") == 0.0
    chip_smoke.check_reassigned_dynamics(device="cpu")
    cfg = chip_smoke._config("point_mass3d").replace(samples=128, horizon=10)
    chip_smoke.check_sharded_fleet(cfg, 4, virtual_mesh(2, "cpu"), device="cpu")
    ranks = chip_smoke.group_run(cfg, 2, backend="gloo", device="cpu")
    solo = MPPIController(cfg, device="cpu")
    want = solo.solve(torch.full((6,), 0.05), solo.init_action_seq(), cfg.seed, 2)
    for onepass in (True, False):
        assert torch.equal(torch.cat([r[onepass][2] for r in ranks]), want.info.costs)
        np.testing.assert_allclose(ranks[1][onepass][0].numpy(), want.action.numpy(), **ORDER_TOL)


@pytest.mark.parametrize("mults,blocks", [(16, 1), (23, 1), (32, 2), (46, 2)])
def test_chip_smoke_loop_counter_reads_the_unroll_factor(mults, blocks):
    """A Philox loop can hold up to 23 round-constant multiplies for one
    step (K4's LtiObstacle<3> loop, SASS of a build on the card): the
    per-step count divides the loop's instructions by one block, not two; a
    loop with two blocks (32 to 46 multiplies, as K3's and K5's two chains)
    by two."""
    import chip_smoke

    lines = ["Function : k", "/*0000*/ MOV R1, c[0x0][0x28] ;"]
    lines += [f"/*{16 * (i + 1):04x}*/ IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ ;" for i in range(mults)]
    lines += [f"/*{16 * (mults + 1):04x}*/ @P2 BRA 0x10 ;", f"/*{16 * (mults + 2):04x}*/ EXIT ;"]
    steps = chip_smoke.philox_loop_steps(chip_smoke.sass_functions("\n".join(lines))["k"])
    assert steps == [(mults + 1) / blocks]


# ---------------------------------------------------------------------------
# on the card: K5 and the sharded solve, through chip_smoke's checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.gpu
def test_gpu_weighted_update(cuda):
    import chip_smoke

    chip_smoke.check_weighted_update(3, 1000, 50, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["iid", "antithetic"])
def test_gpu_sharded_solve(cuda, mode):
    import chip_smoke

    cfg = load_config(os.path.join(ROOT, "configs", "point_mass3d.yaml")).replace(
        samples=2048, horizon=50, **MODES[mode])
    chip_smoke.check_sharded(cfg, virtual_mesh(4, cuda), device=cuda)
