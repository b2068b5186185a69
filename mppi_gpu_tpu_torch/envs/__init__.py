"""Ground-truth world for the closed loop: the torch point-mass world.

The other families' worlds, the native C++ world and the MuJoCo plant are
not ported yet (ROADMAP.md, Open items §1 items 5, 6 and 10).
"""

from mppi_gpu_tpu_torch.envs.params import WorldParams, world_params_for_config
from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld, WorldState

__all__ = ["WorldParams", "world_params_for_config", "PointMassWorld", "WorldState"]
