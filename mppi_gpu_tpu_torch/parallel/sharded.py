"""Sharded MPPI solve: K rollouts over the ranks of a mesh (torch counterpart
of ``mppi_gpu_tpu.parallel.sharded``).

Rank d of n rolls out K/n trajectories and the ranks combine their softmin
with all-reduces of a few floats. Its rollouts draw the port's noise stream
at the draw offset k0 = d·K/n (d·K/2n under antithetic, the mirrors kept on
the rank): counter word 0 = k0 + the local draw index (``ops/philox.py``).
So the ranks together roll out exactly the single-GPU solve's K rollouts:
each S_k is the solo S_k bit for bit (under antithetic a permutation of
them), β is equal, and η and ΔU agree to the order of their sums. (The JAX
package folds the mesh position into the key instead, which is equal only in
distribution.) Two branches, as ``mppi_gpu_tpu/controller.py:481-521``:

* **one-pass** (the default): each rank runs the solo solve core
  unnormalized (K1, then K2 without the division by η) to (β_d, η_d, ΔŨ_d);
  then β = min β_d, f_d = exp((β − β_d)/λ), η = Σ f_d η_d, ΔU = Σ f_d ΔŨ_d / η.
  Two collectives per update: the min, and one sum of η packed with ΔU. On
  the fused backend K1 writes each local rank's S into its row of one
  (n_local, K/n) buffer and K2 its [β_d, η_d, ΔŨ_d] into its row of one
  (n_local, 2 + T·A) buffer; after the MIN, K8 (``ops/sharded_combine``)
  scales every local row by its f_d, the SUM adds them in place, and K9
  divides by η as it runs the tail (and the world's step where the episode
  asks for it): K1, K2, K8, K9 on a world of one. The eager backend runs
  :func:`onepass_combine`, the plain version, and the controller's tail;
* **two-kernel** (``onepass=False``, JAX's ``MPPI_SHARDED_ONEPASS=0``): each
  rank's costs (K4), the softmin across the ranks (:func:`softmin_across`:
  β = min, η = Σ exp(−(S − β)/λ)), the update of the rank's ε by its weights
  w = exp(−(S − β)/λ)/η (K5), and ΔU = Σ over the ranks: three collectives.
  On the fused backend K4 writes each local rank's S into its row of one
  (n_local, K/n) buffer; K10 (``ops/sharded_combine``) takes every row's
  min β_d, the MIN collective β; K11 every row's η_d, the SUM collective η;
  K5 in its softmin form forms each rank's weights from S, β, η and λ and
  K2 folds its rows into the rank's row of one (n_local, T·A) buffer; the
  SUM collective adds those in place; K9 runs the tail and the world's step:
  K4, K10, K11, K5, K2, K9 on a world of one, and between the collectives
  nothing but the port's kernels. The eager backend runs
  :func:`softmin_across`, the plain version of K10, K11 and K5's weights,
  and K7.

The eager backend runs the same branches on the plain versions. The combine
takes the ranks' values stacked on a leading axis and the mesh's reducer
(``parallel/mesh.py``): on a real rank that axis holds its own value and the
reducer is a ``torch.distributed`` all-reduce on it; in a virtual mesh one
process runs every rank in turn (each at its offset) and the reducer is a
reduction over the axis. One code path serves both. On CPU tensors each
kernel's wrapper runs its plain version, so the fused branch holds to the
plain one there bit for bit.

Outputs: ``action``, ``u_next``, β and η are the same on every rank; the
per-rollout ``info.costs`` and ``info.weights`` are the rank's own (K/n,)
slice (the JAX info "comes back sharded over K"), every local rank's in
rank order in a virtual mesh.
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.controller import (
    FULL,
    MPPIController,
    SolveResult,
    _finish_fused,
    _result,
    resolve_backend,
)
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.ops import families, philox
from mppi_gpu_tpu_torch.ops import fused_solve as fs
from mppi_gpu_tpu_torch.ops import sharded_combine as sc
from mppi_gpu_tpu_torch.ops import world_step as ws
from mppi_gpu_tpu_torch.ops.cost import Cost
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs, rollout_trajectories
from mppi_gpu_tpu_torch.ops.solve_tail import softmin_of
from mppi_gpu_tpu_torch.parallel.mesh import Mesh, make_mesh

# all-reduces per update of each branch (tests/test_torch_sharded.py counts them)
COLLECTIVES = {"onepass": 2, "two-kernel": 3}


def rollouts_per_rank(K: int, n: int, antithetic: bool) -> int:
    """K/n, or ``ValueError`` when K does not divide over n ranks or, under
    antithetic, a rank's count is odd (its mirrors stay on the rank)."""
    if K % n:
        raise ValueError(f"K={K} must divide evenly over {n} ranks")
    k_loc = K // n
    if antithetic and k_loc % 2:
        raise ValueError(
            f"antithetic sampling needs an even per-rank rollout count; K={K} over {n} ranks "
            f"gives {k_loc} per rank"
        )
    return k_loc


def draw_offset(rank: int, k_loc: int, antithetic: bool) -> int:
    """The counter word of rank `rank`'s first draw: its rollouts draw
    k_loc (k_loc/2 under antithetic) of the single-GPU stream's draws."""
    return rank * (k_loc // 2 if antithetic else k_loc)


def onepass_combine(beta_d, eta_d, dU_d, lam: float, reduce):
    """The one-pass combine of the ranks' unnormalized solves, stacked on a
    leading axis: β_d (n,), η_d (n,), ΔŨ_d (n, T, A) → (β, η, ΔU (T, A)), with
    `reduce(t, op)` the min or sum over every rank (``Mesh.all_reduce``).
    A rank whose rollouts all cost +inf (β_d = +inf, its η_d and ΔŨ_d NaN)
    has f_d = 0 and adds nothing; if every rank's do, β is +inf and η and ΔU
    are NaN, as on one GPU. The plain version of K8 and K9's division
    (``ops/sharded_combine``)."""
    beta = reduce(beta_d, "min", keep=True)
    f = torch.exp((beta - beta_d) / lam)[:, None]
    part = torch.cat([eta_d[:, None], dU_d.reshape(dU_d.shape[0], -1)], 1)
    total = reduce(torch.where(f == 0, 0.0, f * part), "sum")
    return beta, total[0], (total[1:] / total[0]).view(dU_d.shape[1:])


def softmin_across(S_d, lam: float, reduce):
    """The softmin over every rank's costs S_d (n, K/n), stacked on a leading
    axis: (β, η, w (n, K/n)) with w_k = exp(−(S_k − β)/λ)/η (two
    collectives), each rank's η_d summed in K11's fixed order
    (``sharded_combine.eta_sum``). The plain version of K10, K11 and K5's
    softmin form."""
    beta = reduce(torch.amin(S_d, 1), "min")
    e = torch.exp(-(S_d - beta) / lam)
    eta = reduce(sc.eta_sum(e), "sum")
    return beta, eta, e / eta


def _eager_core(dyn: Dynamics, cost: Cost, x0, U, eps, lam: float):
    """One rank's unnormalized solve on the eager backend, the plain form of
    K1 + K2 without the division: (S, β_d, η_d, ΔŨ_d = Σ_k e_k ε_k)."""
    S = rollout_costs(dyn, cost, x0, U, eps)
    beta = torch.min(S)
    e = torch.exp(-(S - beta) / lam)
    return S, beta, e.sum(), fs.weighted_update_reference(e, eps)


def _solve_once(
    mesh: Mesh, backend: str, fam, dyn: Dynamics, cost: Cost, x0, U, sigma, lam: float, max_a,
    *, K: int, clamp: bool, antithetic: bool, ou_beta: float, onepass: bool, seed: int,
    step, it: int, eps=None, outputs=FULL, into=None, advance=None, tickets=None,
    row_tickets=None, torch_combine: bool = False,
) -> SolveResult:
    """One sharded update of U for (seed, step, it), or on the injected ε
    (T, K, A) of which rank d takes its slice; its tail (the same on every
    rank, after the collectives) computes `outputs` only, then with
    `advance` the world's step under its action: on the fused backend one
    launch of K9 (``ops/sharded_combine``, with the controller's `tickets`),
    on the eager one K7 and K6 on the card; the two-kernel branch's K10 and
    K11 take the controller's `row_tickets` (one int32 zero per local rank)
    for rows of more than eight blocks (``sc.row_form``'s ticket form). `torch_combine` runs the fused
    backend's combine as the eager backend's (the torch ops, K5 on torch's
    weights, K7 and K6): the yardstick chip_smoke.py holds K8-K11 to."""
    anti = antithetic and eps is None
    k_loc = rollouts_per_rank(K, mesh.size, anti)
    T = U.shape[0]
    fused = backend == "fused"
    goal = families.call_goal(fam, cost)
    ranks = mesh.local_ranks
    args = (k_loc, seed, step, it, anti, ou_beta)
    k0 = {d: draw_offset(d, k_loc, anti) for d in ranks}
    # each rank's ε: its slice of the injected ε, its part of the stream on
    # the eager backend, or None (drawn in the kernels)
    noise = {d: eps[:, d * k_loc:(d + 1) * k_loc].contiguous() if eps is not None
             else None if fused
             else philox.sample_eps(seed, step, it, T, k_loc, sigma, antithetic=anti,
                                    ou_beta=ou_beta, k0=k0[d])
             for d in ranks}
    if fused and not torch_combine:
        if onepass:
            return _fused_onepass(mesh, fam, x0, U, goal, lam, max_a, args, noise, k0, clamp,
                                  outputs, into, step, advance, tickets)
        return _fused_two_kernel(mesh, fam, x0, U, goal, lam, max_a, args, noise, k0, clamp,
                                 outputs, into, step, advance, tickets, row_tickets)
    if onepass:
        cores = [fs.family_fused_solve(fam, x0, U, goal, lam, *args, eps=noise[d], k0=k0[d],
                                       normalize=False) if fused
                 else _eager_core(dyn, cost, x0, U, noise[d], lam)
                 for d in ranks]
        S, beta_d, eta_d, dU_d = (torch.stack(v) for v in zip(*cores))
        beta, eta, dU = onepass_combine(beta_d, eta_d, dU_d, lam, mesh.all_reduce)
    else:
        S = torch.stack([fs.fused_rollout_costs(fam, x0, U, goal, *args, eps=noise[d], k0=k0[d])
                         if fused else rollout_costs(dyn, cost, x0, U, noise[d])
                         for d in ranks])
        beta, eta, w = softmin_across(S, lam, mesh.all_reduce)
        dU = mesh.all_reduce(torch.stack([
            fs.weighted_update(fam.sigma, w_d, T, *args, eps=noise[d], k0=k0[d]) if fused
            else fs.weighted_update_reference(w_d, noise[d])
            for d, w_d in zip(ranks, w)
        ]), "sum")
    res = _finish_fused(U, dU, S.reshape(-1), beta, eta, lam, max_a, clamp, outputs, into)
    ws.advance_after(advance, res.action, step)
    return res


def _fused_onepass(mesh: Mesh, fam, x0, U, goal, lam: float, max_a, args, noise, k0,
                   clamp: bool, outputs, into, step, advance, tickets) -> SolveResult:
    """The one-pass branch on the fused backend: per local rank K1 (S into
    its row of one buffer) and K2 unnormalized (into its row of the rows
    [β_d, η_d, ΔŨ_d]), the MIN collective on the β_d, K8, the SUM
    collective in place, then K9: ΔU = Σ/η, the tail and, with `advance`,
    the world's step."""
    T, A = U.shape
    f32 = dict(dtype=torch.float32, device=U.device)
    S = torch.empty(len(mesh.local_ranks), args[0], **f32)
    rows = torch.empty(len(mesh.local_ranks), 2 + T * A, **f32)
    for i, d in enumerate(mesh.local_ranks):
        fs.family_fused_solve(fam, x0, U, goal, lam, *args, eps=noise[d], k0=k0[d],
                              normalize=False, S_out=S[i], out=rows[i])
    beta = mesh.all_reduce(rows[:, 0], "min", keep=True)  # the β_d stay for K8
    sums = mesh.all_reduce(sc.sharded_scale(rows, beta, lam), "sum")  # [η, Σ f_d·ΔŨ_d]
    S = S.reshape(-1)
    softmin = (S, beta, sums[0], lam) if "weights" in outputs else None
    _, tail = sc.sharded_tail(U, sums, max_a, clamp, outputs, softmin, into, divide=True,
                              step=step, advance=advance, tickets=tickets)
    return _result(tail, S, beta, sums[0], tail.weights)


def _fused_two_kernel(mesh: Mesh, fam, x0, U, goal, lam: float, max_a, args, noise, k0,
                      clamp: bool, outputs, into, step, advance, tickets,
                      row_tickets) -> SolveResult:
    """The two-kernel branch on the fused backend: per local rank K4 (S into
    its row of one buffer), K10 on every row, the MIN collective, K11 on
    every row, the SUM collective, per local rank K5 in its softmin form and
    K2's fold into its row of one (n_local, T·A) buffer, the SUM collective
    in place, then K9: the tail and, with `advance`, the world's step."""
    T, A = U.shape
    f32 = dict(dtype=torch.float32, device=U.device)
    ranks = mesh.local_ranks
    S = torch.empty(len(ranks), args[0], **f32)
    for i, d in enumerate(ranks):
        fs.fused_rollout_costs(fam, x0, U, goal, *args, eps=noise[d], k0=k0[d], S_out=S[i])
    beta = mesh.all_reduce(sc.softmin_min(S, row_tickets), "min")
    eta = mesh.all_reduce(sc.softmin_eta(S, beta, lam, row_tickets), "sum")
    rows = torch.empty(len(ranks), T * A, **f32)
    for i, d in enumerate(ranks):
        fs.weighted_update(fam.sigma, (S[i], beta, eta, lam), T, *args, eps=noise[d], k0=k0[d],
                           out=rows[i])
    dU = mesh.all_reduce(rows, "sum").view(T, A)
    S = S.reshape(-1)
    softmin = (S, beta, eta, lam) if "weights" in outputs else None
    _, tail = sc.sharded_tail(U, dU, max_a, clamp, outputs, softmin, into, step=step,
                              advance=advance, tickets=tickets)
    return _result(tail, S, beta, eta, tail.weights)


def sharded_mppi_solve(
    mesh: Mesh, dyn: Dynamics, cost: Cost, x0: torch.Tensor, U: torch.Tensor, *, seed: int,
    step: int = 0, sigma: torch.Tensor, lambda_: float, max_a: torch.Tensor, K: int,
    clamp: bool = True, rollout_backend: str = "auto", antithetic: bool = False,
    ou_beta: float = 0.0, opt_iters: int = 1, onepass: bool = True,
) -> SolveResult:
    """One MPPI solve with K rollouts sharded over `mesh`: ``opt_iters``
    updates (iteration j on counter word it = j), the last returned before
    which nothing is shifted, as ``controller.mppi_solve``. The inputs are
    replicated on every rank and on the mesh's device."""
    rollouts_per_rank(K, mesh.size, antithetic)
    backend = resolve_backend(rollout_backend, mesh.device, dyn, cost)
    fam = families.family_for(dyn, cost, sigma) if backend == "fused" else None
    for j in range(opt_iters):
        res = _solve_once(
            mesh, backend, fam, dyn, cost, x0, U, sigma, float(lambda_), max_a, K=K,
            clamp=clamp, antithetic=antithetic, ou_beta=ou_beta, onepass=onepass, seed=seed,
            step=step, it=j,
        )
        U = res.info.u_seq
    return res


class ShardedMPPIController(MPPIController):
    """Drop-in ``MPPIController`` whose solve runs over a mesh: this process's
    rank of a process group (:func:`~mppi_gpu_tpu_torch.parallel.mesh.make_mesh`,
    the default) or n ranks in one process (``virtual_mesh``). Every rank
    runs the same closed loop; ``onepass=False`` selects the two-kernel
    branch. On a CUDA device its ``solve`` is a replayed CUDA graph, the
    collectives of a process group captured in it (``graphs.SolveGraph``),
    and ``runner.run_episode_jit`` captures its whole control cycle."""

    def __init__(
        self,
        cfg: MPPIConfig,
        *,
        mesh: Mesh | None = None,
        rollout_backend: str = "auto",
        onepass: bool = True,
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
    ) -> None:
        mesh = mesh if mesh is not None else make_mesh()
        rollouts_per_rank(cfg.samples, mesh.size, cfg.antithetic)
        super().__init__(cfg, device=mesh.device, rollout_backend=rollout_backend,
                         dynamics=dynamics, cost=cost)
        self.mesh = mesh
        self.onepass = onepass
        # the fused backend's combine as torch ops, K7 and K6 (chip_smoke.py's
        # yardstick for K8-K11; part of the solve's identity)
        self._torch_combine = False
        # K10 and K11 find each local rank's last block by a ticket, zero
        # between launches (rows of more than eight blocks; shorter rows are
        # one block or one cluster)
        self._row_tickets = torch.zeros(len(mesh.local_ranks), dtype=torch.int32,
                                        device=self.device)

    def _solve_identity(self) -> tuple:
        return (*super()._solve_identity(), id(self.mesh), self.onepass, self._torch_combine)

    def _solve_once(self, x, U, seed: int, step, it: int, outputs=FULL, into=None,
                    advance=None, eps=None) -> SolveResult:
        """One sharded update, then with `advance` the world's step under its
        action: on the fused backend on the card the update's tail and the
        step are one launch of K9 after the combine (K8, or K10, K11 and K5's
        softmin form), on the eager backend K7 and K6."""
        cfg = self.cfg
        return _solve_once(
            self.mesh, self.rollout_backend, self._family, self.dynamics, self.cost, x, U,
            self.sigma, cfg.lambda_, self.max_a,
            K=cfg.samples if eps is None else eps.shape[1], clamp=cfg.clamp_action,
            antithetic=cfg.antithetic, ou_beta=cfg.noise_beta, onepass=self.onepass, seed=seed,
            step=step, it=it, eps=eps, outputs=outputs, into=into, advance=advance,
            tickets=self._tickets, row_tickets=self._row_tickets,
            torch_combine=self._torch_combine,
        )

    def solve_with_eps(self, x: torch.Tensor, U: torch.Tensor, eps: torch.Tensor) -> SolveResult:
        """Sharded solve on the injected ε (T, K, a), the same on every rank:
        rank d rolls out its slice, rollouts d·K/n to (d + 1)·K/n − 1."""
        return self._solve_once(x.to(self.device, torch.float32), U, 0, 0, 0, eps=eps)

    def solve_debug(
        self, x: torch.Tensor, U: torch.Tensor, step: int
    ) -> tuple[SolveResult, torch.Tensor | None, torch.Tensor | None]:
        """The sharded :meth:`solve_auto` (every rank must call it, or
        ``solve_auto``, at this step) and, on the coordinator (the process
        that runs rank 0), the dump of the whole K: the ε of the single-GPU
        stream (K3 over the global K on the fused backend), which is what the
        ranks drew between them, its eager rollouts, and their costs and
        weights under the combined β and η in the single-GPU rollout order.
        Every other process gets ``(result, None, None)``."""
        cfg, seed = self.cfg, self.cfg.seed
        x = x.to(self.device, torch.float32)
        U = self._iterate(x, U, seed, step)
        it = cfg.opt_iters - 1
        res = self._solve_once(x, U, seed, step, it)
        if 0 not in self.mesh.local_ranks:
            return res, None, None
        if self.rollout_backend == "fused":
            eps = fs.noise_dump(self.sigma, cfg.horizon, cfg.samples, seed, step, it,
                                cfg.antithetic, cfg.noise_beta)
        else:
            eps = self._eps(seed, step, it)
        S, xs = rollout_trajectories(self.dynamics, self.cost, x, U, eps)
        weights = softmin_of(S, res.info.beta, res.info.eta, cfg.lambda_)
        return res._replace(info=res.info._replace(costs=S, weights=weights)), eps, xs
