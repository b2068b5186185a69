"""The ranks a sharded solve runs on (torch counterpart of
``mppi_gpu_tpu.parallel.mesh``).

MPPI's only parallel axis is the rollout batch K; here K shards over the
ranks of a ``torch.distributed`` process group, one GPU each, and the solve
combines the ranks with all-reduces of a few floats (``parallel/sharded.py``).
A :class:`Mesh` names this process's part of that: the group, the world's
size, the ranks this process runs, and its device.

Every value a rank contributes to a collective carries a leading axis over
the ranks this process runs: one entry on a real rank (``make_mesh``), n in
a :func:`virtual_mesh`, where one process runs every rank in turn and the
collectives are plain reductions over that axis. The solve is the same code
either way, so one GPU can hold the sharded solve to the solo one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """``size`` ranks in all, of which this process runs ``local_ranks`` on
    ``device``; ``grouped`` when the ranks span the processes of the default
    process group (:attr:`group`), False when this process runs every rank.
    The mesh names the group and does not hold it: a controller, or an
    episode's cycle cached on it, would otherwise keep gloo's process group
    alive past ``destroy_process_group`` until the interpreter's exit tears
    it down."""

    size: int
    local_ranks: tuple[int, ...]
    device: torch.device
    grouped: bool = False

    @property
    def group(self) -> dist.ProcessGroup | None:
        """The process group joining the ranks (the default one), or None."""
        return dist.group.WORLD if self.grouped else None

    def all_reduce(self, t: torch.Tensor, op: str, keep: bool = False) -> torch.Tensor:
        """The ``"min"`` or ``"sum"`` of `t` over every rank: `t` holds one
        entry per local rank on its leading axis, which the result drops.
        One entry is its own reduction: the result is a view of it, and no
        kernel runs (a sum over one entry would only turn a −0.0 into +0.0);
        on a real rank ``dist.all_reduce`` then runs in place on that entry,
        in `t`'s own storage, unless `keep` (the caller reads `t` again),
        which gives the collective a copy of it. Two or more entries (a
        virtual mesh) are reduced over the axis, which is the collective."""
        if t.shape[0] == 1:
            out = t[0].clone() if keep and self.group is not None else t[0]
        else:
            out = t.amin(0) if op == "min" else t.sum(0)
        if self.group is not None:
            out = out.contiguous()
            dist.all_reduce(out, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.SUM,
                            group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `t` (this process's, stacked on the leading
        axis) concatenated in rank order on every rank: one
        ``dist.all_gather`` when the ranks span processes."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def _default_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (torchrun's variable; 0 without it)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the sharded solve runs a rank per CUDA device and CUDA is not available; "
            "pass device='cpu' (a gloo group) to run it on the CPU"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(device: torch.device | str | None = None) -> Mesh:
    """This process's rank in the default process group (``init_multihost``
    or the caller's ``init_process_group``), or a world of one without a
    group when none is initialized. The device is `device`, by default
    ``cuda:LOCAL_RANK``; the CPU only when asked for (a gloo group). A CUDA
    device becomes this process's current one (``torch.cuda.set_device``),
    so that torch's work and NCCL's run where the rank's tensors are."""
    device = torch.device(device) if device is not None else _default_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(1, (0,), device)
    return Mesh(dist.get_world_size(), (dist.get_rank(),), device, grouped=True)


def virtual_mesh(n: int, device: torch.device | str | None = None) -> Mesh:
    """n ranks run in turn by this process on one device: the sharded solve
    with its draw offsets and its combine, without a process group."""
    if n < 1:
        raise ValueError(f"a mesh has n >= 1 ranks, got {n}")
    device = torch.device(device) if device is not None else _default_device()
    return Mesh(n, tuple(range(n)), device)
