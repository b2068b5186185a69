"""CSV/trajectory IO matching the reference's outputs (src/main.cu:32-156),
and checkpoint/resume of the closed loop."""

from mppi_gpu_tpu_torch.io.checkpoint import Checkpoint, load_checkpoint, save_checkpoint
from mppi_gpu_tpu_torch.io.csvio import write_step_dump_csv, write_traj_csv

__all__ = ["write_traj_csv", "write_step_dump_csv", "Checkpoint", "save_checkpoint",
           "load_checkpoint"]
