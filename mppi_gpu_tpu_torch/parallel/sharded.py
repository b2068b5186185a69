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
  then β = min β_d, f_d = exp((β − β_d)/λ), η = Σ f_d η_d, ΔU = Σ f_d ΔŨ_d / η
  (:func:`onepass_combine`). Two collectives per update: the min, and one
  sum of η packed with ΔU;
* **two-kernel** (``onepass=False``, JAX's ``MPPI_SHARDED_ONEPASS=0``): each
  rank's costs (K4), the softmin across the ranks (:func:`softmin_across`:
  β = min, η = Σ exp(−(S − β)/λ)), the update of the rank's ε by its weights
  w = exp(−(S − β)/λ)/η (K5), and ΔU = Σ over the ranks: three collectives.

The eager backend runs the same branches on the plain versions. The combine
functions take the ranks' values stacked on a leading axis and the mesh's
reducer (``parallel/mesh.py``): on a real rank that axis holds its own value
and the reducer is a ``torch.distributed`` all-reduce; in a virtual mesh
one process runs every rank in turn (each at its offset) and the reducer is
a reduction over the axis. One code path serves both.

Outputs: ``action``, ``u_next``, β and η are the same on every rank; the
per-rollout ``info.costs`` and ``info.weights`` are the rank's own (K/n,)
slice (the JAX info "comes back sharded over K"), every local rank's in
rank order in a virtual mesh.
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.controller import (
    MPPIController,
    SolveResult,
    _finish_fused,
    resolve_backend,
)
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.ops import families, philox
from mppi_gpu_tpu_torch.ops import fused_solve as fs
from mppi_gpu_tpu_torch.ops.cost import Cost
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs, rollout_trajectories
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
    are NaN, as on one GPU."""
    beta = reduce(beta_d, "min")
    f = torch.exp((beta - beta_d) / lam)[:, None]
    part = torch.cat([eta_d[:, None], dU_d.reshape(dU_d.shape[0], -1)], 1)
    total = reduce(torch.where(f == 0, 0.0, f * part), "sum")
    return beta, total[0], (total[1:] / total[0]).view(dU_d.shape[1:])


def softmin_across(S_d, lam: float, reduce):
    """The softmin over every rank's costs S_d (n, K/n), stacked on a leading
    axis: (β, η, w (n, K/n)) with w_k = exp(−(S_k − β)/λ)/η (two
    collectives)."""
    beta = reduce(torch.amin(S_d, 1), "min")
    e = torch.exp(-(S_d - beta) / lam)
    eta = reduce(e.sum(1), "sum")
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
    step: int, it: int, eps=None,
) -> SolveResult:
    """One sharded update of U for (seed, step, it), or on the injected ε
    (T, K, A) of which rank d takes its slice."""
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
    return _finish_fused(U, dU, S.reshape(-1), beta, eta, lam, max_a, clamp)


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
    branch."""

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

    def _solve_once(self, x, U, seed: int, step: int, it: int, eps=None) -> SolveResult:
        cfg = self.cfg
        return _solve_once(
            self.mesh, self.rollout_backend, self._family, self.dynamics, self.cost, x, U,
            self.sigma, cfg.lambda_, self.max_a,
            K=cfg.samples if eps is None else eps.shape[1], clamp=cfg.clamp_action,
            antithetic=cfg.antithetic, ou_beta=cfg.noise_beta, onepass=self.onepass, seed=seed,
            step=step, it=it, eps=eps,
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
        weights = torch.exp(-(S - res.info.beta) / cfg.lambda_) / res.info.eta
        return res._replace(info=res.info._replace(costs=S, weights=weights)), eps, xs
