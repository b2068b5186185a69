"""Multi-GPU execution (torch counterpart of ``mppi_gpu_tpu.parallel``): the
ranks a solve runs on, the K-sharded solve, the sharded fleet, and the
multi-process bootstrap."""

from mppi_gpu_tpu_torch.parallel.fleet import ShardedFleetController
from mppi_gpu_tpu_torch.parallel.mesh import make_mesh
from mppi_gpu_tpu_torch.parallel.multihost import (
    global_mesh,
    init_multihost,
    is_coordinator,
)
from mppi_gpu_tpu_torch.parallel.sharded import ShardedMPPIController, sharded_mppi_solve

__all__ = [
    "make_mesh",
    "ShardedFleetController",
    "ShardedMPPIController",
    "sharded_mppi_solve",
    "init_multihost",
    "global_mesh",
    "is_coordinator",
]
