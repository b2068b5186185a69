"""Multi-process bootstrap: ``torch.distributed.init_process_group`` → global
mesh → :class:`~mppi_gpu_tpu_torch.parallel.sharded.ShardedMPPIController`
(torch counterpart of ``mppi_gpu_tpu.parallel.multihost``).

Every process runs the same program, one rank per GPU (NCCL) or per CPU
process (gloo). :func:`init_multihost` joins them into one process group,
either from torchrun's environment (``env://``: ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or from an explicit coordinator
address, process count and process id; :func:`global_mesh` is then this
process's rank of it, and the sharded solve's all-reduces of a few floats
run over NCCL or gloo. Nothing discovers a cluster on its own: the address,
the world's size and the rank come from the caller or from torchrun.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mppi_gpu_tpu_torch.parallel.mesh import Mesh, make_mesh

_INITIALIZED: tuple | None = None  # the arguments of the successful first call


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> tuple[int, int]:
    """Idempotent ``init_process_group``. With all three arguments the group
    meets at ``tcp://HOST:PORT`` (`coordinator_address` as ``HOST:PORT``, or
    a full ``tcp://`` or ``file://`` URL) with `num_processes` ranks, this
    one `process_id`; with none, at ``env://`` (torchrun). `backend` is
    ``"nccl"`` or ``"gloo"``, by default NCCL when CUDA is available and gloo
    otherwise. A re-call with no arguments, or with the first call's, returns
    the coordinates; one with other arguments raises ``RuntimeError``.

    Returns ``(rank, world size)``."""
    global _INITIALIZED
    args = (coordinator_address, num_processes, process_id)
    given = [a is not None for a in args]
    if any(given) and not all(given):
        raise ValueError(
            "init_multihost takes the coordinator address, the process count and the process "
            f"id together, or none of them (torchrun's environment); got {args}"
        )
    if _INITIALIZED is None:
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        if all(given):
            url = coordinator_address if "://" in coordinator_address else (
                f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                    rank=process_id)
        else:
            dist.init_process_group(backend, init_method="env://")
        _INITIALIZED = args
    elif any(given) and args != _INITIALIZED:
        # a no-argument re-call asks for the coordinates; a re-call with other
        # wiring is a misconfiguration, surfaced instead of ignored
        raise RuntimeError(
            f"init_multihost already initialized with {_INITIALIZED}; "
            f"conflicting re-initialization with {args}"
        )
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Leave the process group :func:`init_multihost` joined (a no-op when
    it joined none); a later :func:`init_multihost` joins anew. Every rank
    meets the others at a barrier first, so no rank tears its connections
    down while a peer still sends on them: a rank that left early, its work
    done, could abort a peer's gloo transport mid-collective. So every rank
    of the group calls it, as every rank calls the collectives."""
    global _INITIALIZED
    if _INITIALIZED is not None:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
        dist.destroy_process_group()
        _INITIALIZED = None


def global_mesh(device: torch.device | str | None = None) -> Mesh:
    """This process's rank of the group (call after :func:`init_multihost`),
    on `device` (default ``cuda:LOCAL_RANK``)."""
    return make_mesh(device)


def is_coordinator() -> bool:
    """True on the process that owns printing, the CSV and the dumps: rank 0,
    or the only process when no group is initialized."""
    return not dist.is_initialized() or dist.get_rank() == 0
