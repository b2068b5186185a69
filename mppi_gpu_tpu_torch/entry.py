"""The port's entry points for a harness (the counterpart of the root
``__graft_entry__.py``, which drives the JAX package):

* :func:`entry` — ``(fn, args)``: ``fn(x, U, step)`` is one MPPI solve of
  the flagship, point_mass3d at K=10⁴, T=200, on the card, a replayed CUDA
  graph (``MPPIController.solve``), returning ``(action, u_next)``;
* :func:`dryrun_multichip` — one sharded solve in both branches over n
  ranks: a process group of n ranks where the caller started one (torchrun,
  ``parallel.init_multihost``), else n virtual ranks on one device.

    python -c "from mppi_gpu_tpu_torch.entry import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from mppi_gpu_tpu_torch.config import MPPIConfig, load_config
from mppi_gpu_tpu_torch.controller import MPPIController

# the repository's root, which holds configs/
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flagship_config(K: int = 10_000, T: int = 200) -> MPPIConfig:
    """configs/point_mass3d.yaml at K rollouts over T steps:
    ``__graft_entry__._make_controller``'s config."""
    return load_config(os.path.join(ROOT, "configs", "point_mass3d.yaml")).replace(samples=K,
                                                                                   horizon=T)


def entry(device: str = "cuda", K: int = 10_000, T: int = 200):
    """(fn, example_args): ``fn(x, U, step)`` runs one full MPPI solve
    (sample → rollout → softmin → update → clamp → shift) of the flagship on
    `device` under the config's seed, step an int or a 0-dim int64 tensor,
    and returns ``(action, u_next)``. On a CUDA device the first call
    captures the solve as a CUDA graph and every call replays it."""
    ctrl = MPPIController(flagship_config(K, T), device=device)

    def fn(x, U, step):
        res = ctrl.solve_auto(x, U, step)
        return res.action, res.u_next

    x = torch.zeros(6, dtype=torch.float32, device=ctrl.device)
    return fn, (x, ctrl.init_action_seq(), 0)


def dryrun_multichip(n: int, device: str | None = None, K: int | None = None) -> None:
    """One sharded solve of the flagship's task over n ranks, the one-pass
    branch and the two-kernel one: over this process's rank of the default
    process group when one of n ranks is initialized (every rank calls this),
    else over ``virtual_mesh(n)``. K is 1024·n by default. Asserts that the
    costs are this process's (K·local/n,) rollouts (K on a virtual mesh)
    and that the weights sum to 1 over every rank."""
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController, make_mesh
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh

    grouped = dist.is_available() and dist.is_initialized() and dist.get_world_size() == n
    mesh = make_mesh(device) if grouped else virtual_mesh(n, device)
    K = 1024 * n if K is None else K
    cfg = flagship_config(K, 50)
    local = K * len(mesh.local_ranks) // n
    for onepass in (True, False):
        ctrl = ShardedMPPIController(cfg, mesh=mesh, onepass=onepass)
        x = torch.zeros(6, dtype=torch.float32, device=ctrl.device)
        res = ctrl.solve_auto(x, ctrl.init_action_seq(), 0)
        total = mesh.all_reduce(res.info.weights.sum().reshape(1, 1), "sum")
        branch = "one-pass" if onepass else "two-kernel"
        if tuple(res.info.costs.shape) != (local,):
            raise AssertionError(f"{branch}: costs {tuple(res.info.costs.shape)}, want ({local},)")
        if abs(float(total) - 1.0) > 1e-4:
            raise AssertionError(f"{branch}: the weights sum to {float(total)} over the ranks")
        print(f"dryrun_multichip OK [{branch}]: {n} ranks ({'process group' if grouped else 'virtual'}"
              f"), K={K}, action={res.action.tolist()}")
