"""Fleet × mesh: R robots sharded over the ranks (torch counterpart of
``mppi_gpu_tpu.parallel.fleet``).

Robots share nothing per solve, so whole robots go to each rank: rank d of
n solves robots d·R/n to (d + 1)·R/n − 1 with the fleet kernels (one launch
of K1 and one of K2 for its R/n robots on the fused backend), each robot
under its own seed (``ops/philox.fleet_seeds``) and goal, at the whole
fleet's block width. So robot r's result is ``BatchedMPPIController``'s bit
for bit. The full (R, ·) result
comes back on every rank through one all_gather of the packed outputs per
update, so ``runner.run_fleet_episode`` runs on it unchanged: on the CPU, a
loop over gloo, bit for bit as on the unsharded fleet
(``tests/test_torch_sharded.py``); on a CUDA device a replayed CUDA graph of
the cycle with NCCL's all_gather captured in it, as is the host loop's
solve (``graphs.SolveGraph``).
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.batched import BatchedMPPIController
from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.controller import FULL, SolveInfo, SolveResult
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.ops import world_step as ws
from mppi_gpu_tpu_torch.ops.cost import Cost
from mppi_gpu_tpu_torch.parallel.mesh import Mesh, make_mesh


class ShardedFleetController(BatchedMPPIController):
    """``BatchedMPPIController`` whose robots are sharded over a mesh (this
    process's rank of a process group by default, or n ranks in one process,
    ``virtual_mesh``). The inputs (xs, Us, seeds, goals) are the whole
    fleet's on every rank; so is the result."""

    def __init__(
        self,
        cfg: MPPIConfig,
        n_robots: int,
        *,
        mesh: Mesh | None = None,
        goals: torch.Tensor | None = None,
        rollout_backend: str = "auto",
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
    ) -> None:
        mesh = mesh if mesh is not None else make_mesh()
        if n_robots % mesh.size:
            raise ValueError(f"n_robots={n_robots} must divide evenly over {mesh.size} ranks")
        super().__init__(cfg, n_robots, device=mesh.device, goals=goals,
                         rollout_backend=rollout_backend, dynamics=dynamics, cost=cost)
        self.mesh = mesh
        per = n_robots // mesh.size
        self._local = [range(d * per, (d + 1) * per) for d in mesh.local_ranks]

    def _gather(self, parts: list[SolveResult]) -> SolveResult:
        """The local ranks' results → every robot's, in robot order: one
        all_gather of their leaves packed into rows of floats (a leaf the
        solve did not compute, None, stays None)."""
        fields = zip(*([p.action, p.u_next, *p.info] for p in parts))
        leaves = [None if v[0] is None else torch.cat(v) for v in fields]
        present = [v for v in leaves if v is not None]
        rows = self.mesh.all_gather(torch.cat([v.reshape(v.shape[0], -1) for v in present], 1))
        gathered = iter(w.reshape(-1, *v.shape[1:])
                        for w, v in zip(rows.split([v[0].numel() for v in present], 1), present))
        out = [None if v is None else next(gathered) for v in leaves]
        return SolveResult(out[0], out[1], SolveInfo(*out[2:]))

    def _solve_identity(self) -> tuple:
        return (*super()._solve_identity(), id(self.mesh))

    def _solve_once(self, xs, Us, seeds, step, it: int, outputs=FULL, into=None,
                    advance=None) -> SolveResult:
        """Each local rank's robots (their tails computing `outputs` only),
        gathered; the whole fleet's shifted sequences then copied into `into`
        when given, once every rank has read Us; then with `advance` the
        whole fleet's world step under the gathered actions."""
        res = self._gather([
            self._solve_robots(xs[r.start:r.stop], Us[r.start:r.stop], seeds[r.start:r.stop],
                               step, it, r, outputs=outputs)
            for r in self._local
        ])
        res = res if into is None else res._replace(u_next=into.copy_(res.u_next))
        ws.advance_after(advance, res.action, step)
        return res

    def solve_with_eps(self, xs: torch.Tensor, Us: torch.Tensor, eps: torch.Tensor) -> SolveResult:
        """Deterministic fleet solve on the injected ε (R, T, K, a), the same
        on every rank: each rank solves its robots on their rows."""
        xs = xs.to(self.device, torch.float32)
        return self._gather([
            self._solve_robots(xs[r.start:r.stop], Us[r.start:r.stop], 0, 0, 0, r,
                               eps=eps[r.start:r.stop])
            for r in self._local
        ])
