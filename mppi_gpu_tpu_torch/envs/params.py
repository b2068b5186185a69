"""Ground-truth world parameters.

The reference's worlds are MuJoCo XMLs (reference envs/point_mass{1d,2d,3d}.xml)
— a frictionless point mass on 1-3 slide joints. All three share identical
per-axis physics; only the number of axes differs:

    sphere r=0.05, default density 1000  →  body mass m = 4/3·π·r³·ρ
    joint: armature 0.01, damping 0.1, range ±1.4 (limited)
    motor: gear 10, ctrlrange ±1
    option: gravity 0, integrator RK4, timestep 0.01

so each axis follows the decoupled linear ODE

    (m + armature) · q̈ = gear · clamp(u, ±1) − damping · q̇

integrated with RK4 at the physics timestep. This is deliberately *different*
from the controller's internal LTI model (no damping/armature/gear, dt=0.1):
the model-plant mismatch is a feature of the reference (measured by its `miss`
tool) and is preserved here.

Control cadence matches the reference env (src/PointMassEnv.cpp:115-139):
each `simulate(u)` call advances physics until sim time has grown by ≥ 1/60 s
(= ceil((1/60)/0.01) = 2 steps of 0.01 s), and the episode ends when sim time
exceeds 10 s (+ the one warm-up step taken at construction).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.envs.base import ControlCadence

SPHERE_RADIUS = 0.05
DENSITY = 1000.0


@dataclass(frozen=True)
class WorldParams(ControlCadence):
    n_axes: int                 # 1, 2, or 3 slide joints
    mass: float = (4.0 / 3.0) * math.pi * SPHERE_RADIUS**3 * DENSITY
    armature: float = 0.01
    damping: float = 0.1
    gear: float = 10.0
    ctrl_range: float = 1.0
    joint_range: float = 1.4
    timestep: float = 0.01      # physics dt
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001    # episode length in sim seconds (PointMassEnv.cpp:96)

    @property
    def state_dim(self) -> int:
        return 2 * self.n_axes

    @property
    def effective_mass(self) -> float:
        return self.mass + self.armature


def world_params_for_config(cfg: MPPIConfig) -> WorldParams:
    """World params for a point-mass config: the built-in constants above,
    keyed by the config's dimensionality. An ``env`` that points at a MuJoCo
    XML is not ported yet (ROADMAP.md, Open items §1 item 5)."""
    if str(cfg.env).endswith(".xml"):
        raise NotImplementedError(
            f"config env '{cfg.env}' is a MuJoCo XML; XML worlds are not ported "
            "to mppi_gpu_tpu_torch yet (see ROADMAP.md)"
        )
    return WorldParams(n_axes=cfg.action_dim)
