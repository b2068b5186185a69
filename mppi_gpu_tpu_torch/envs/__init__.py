"""Ground-truth worlds for the closed loop: the torch point-mass, pendulum,
cart-pole, unicycle, planar-quadrotor, two-link-arm and 3-D quadrotor
worlds, picked from a config by :func:`make_world` (the counterpart of
``mppi_gpu_tpu.envs.make_jax_world``; the obstacle cost's point mass runs in
the point-mass world). Each world steps one robot or a fleet of R robots
(``reset(n_robots)``, ``from_x`` of an (R, s) state) on the host
(``simulate``) or on the device (``advance``, ``envs/base.py``); on a CUDA
device either runs a control cycle as one launch of the world-step kernel
(``ops/world_step.py``).

The host loop's plants, picked by :func:`make_host_world` (the counterpart
of ``mppi_gpu_tpu.runner._make_world``), have the reference-env API
(``reset()``, ``simulate(u) -> done``, ``get_x()``, ``time``,
``set_state(x, time)``): the torch world behind :class:`TorchPlant`, the
native C++ worlds (``envs/native.py``) and real MuJoCo
(``envs/mujoco_world.py``). A config whose ``env`` is a MuJoCo XML of the
reference's point-mass schema takes its physics from the XML
(``envs/xml.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_gpu_tpu_torch.envs import mujoco_world, native
from mppi_gpu_tpu_torch.envs.arm_world import ArmParams, ArmState, ArmWorld
from mppi_gpu_tpu_torch.envs.cartpole_world import CartPoleParams, CartPoleState, CartPoleWorld
from mppi_gpu_tpu_torch.envs.params import WorldParams, world_params_for_config
from mppi_gpu_tpu_torch.envs.pendulum_world import PendulumParams, PendulumState, PendulumWorld
from mppi_gpu_tpu_torch.envs.point_mass_world import PointMassWorld, WorldState
from mppi_gpu_tpu_torch.envs.quadrotor3d_world import (
    Quadrotor3DParams,
    Quadrotor3DState,
    Quadrotor3DWorld,
)
from mppi_gpu_tpu_torch.envs.quadrotor_world import (
    QuadrotorParams,
    QuadrotorState,
    QuadrotorWorld,
)
from mppi_gpu_tpu_torch.envs.unicycle_world import UnicycleParams, UnicycleState, UnicycleWorld
from mppi_gpu_tpu_torch.envs.mujoco_world import mujoco_available
from mppi_gpu_tpu_torch.envs.native import native_available
from mppi_gpu_tpu_torch.envs.xml import XMLWorld, XMLWorldError, load_world_xml

# (substring of the config's env, its world's params), in the order of
# mppi_gpu_tpu.envs.params_for_config; anything else is the point-mass
# world. max-a[0] of the quadrotors bounds the collective F, the sum over
# their 4 (3-D) or 2 (planar) rotors, so each rotor's envelope is a quarter
# or a half of it.
_FAMILIES = (
    ("arm", lambda cfg: ArmParams(max_t1=cfg.max_a[0], max_t2=cfg.max_a[1])),
    ("unicycle", lambda cfg: UnicycleParams(max_v=cfg.max_a[0], max_w=cfg.max_a[1])),
    ("cartpole", lambda cfg: CartPoleParams(max_force=max(cfg.max_a))),
    ("pendulum", lambda cfg: PendulumParams(max_torque=max(cfg.max_a))),
    ("quadrotor3d", lambda cfg: Quadrotor3DParams(max_thrust=cfg.max_a[0] / 4.0)),
    ("quadrotor", lambda cfg: QuadrotorParams(max_thrust=cfg.max_a[0] / 2.0)),
)
# world params type → world
_WORLDS = {
    ArmParams: ArmWorld, UnicycleParams: UnicycleWorld, CartPoleParams: CartPoleWorld,
    PendulumParams: PendulumWorld, QuadrotorParams: QuadrotorWorld,
    Quadrotor3DParams: Quadrotor3DWorld,
}


def params_for_config(cfg):
    """The world family and its physical parameters from the config's `env`."""
    env = str(cfg.env)
    for family, params in _FAMILIES:
        if family in env:
            return params(cfg)
    return world_params_for_config(cfg)


def make_world(cfg, params=None, device: torch.device | str = "cpu"):
    """The ground-truth world for `params` (default: the config's), its
    states on `device`."""
    params = params if params is not None else params_for_config(cfg)
    return _WORLDS.get(type(params), PointMassWorld)(params, device)


class TorchPlant:
    """The torch world as a host plant: the reference-env API over one
    robot's state on the CPU, stepped by ``World.simulate`` (the counterpart
    of the JAX runner's ``_JaxWorldAdapter``)."""

    def __init__(self, world) -> None:
        self.world, self.params = world, world.params
        self.reset()

    def reset(self) -> None:
        self.state = self.world.reset()

    def simulate(self, u: np.ndarray) -> bool:
        self.state, done = self.world.simulate(self.state, torch.from_numpy(u))
        return done

    def step(self, u: np.ndarray) -> None:
        """One physics step (the mismatch harness)."""
        self.state = self.world.physics_step(self.state, torch.from_numpy(u))

    def get_x(self) -> np.ndarray:
        return self.state.x.numpy()

    @property
    def time(self) -> float:
        return float(self.state.time)

    def set_state(self, x: np.ndarray, time: float) -> None:
        self.state = self.world.from_x(torch.from_numpy(x), time)


# world params type → (native world, MuJoCo world); None: no such plant
_HOST = {
    WorldParams: (native.NativePointMassWorld, mujoco_world.MujocoPointMassWorld),
    PendulumParams: (native.NativePendulumWorld, mujoco_world.MujocoPendulumWorld),
    CartPoleParams: (native.NativeCartPoleWorld, mujoco_world.MujocoCartPoleWorld),
    QuadrotorParams: (native.NativeQuadrotorWorld, mujoco_world.MujocoQuadrotorWorld),
    Quadrotor3DParams: (native.NativeQuadrotor3DWorld, mujoco_world.MujocoQuadrotor3DWorld),
    ArmParams: (None, mujoco_world.MujocoArmWorld),
    UnicycleParams: (None, None),
}
WORLD_BACKENDS = ("torch", "native", "mujoco")


def make_host_world(cfg, params=None, backend: str = "torch"):
    """The closed loop's plant for `params` (default: the config's) on
    `backend`: "torch" (the torch world, :class:`TorchPlant`), "native" (the
    C++ twin) or "mujoco" (real ``mj_step``; a point-mass config whose env
    is an XML loads that XML). The unicycle has no native or MuJoCo plant,
    and the arm no native one: both raise ValueError by name, as the JAX
    runner does."""
    params = params if params is not None else params_for_config(cfg)
    if backend == "torch":
        return TorchPlant(make_world(cfg, params))
    if backend not in WORLD_BACKENDS:
        raise ValueError(f"unknown world backend '{backend}' ({'|'.join(WORLD_BACKENDS)})")
    plants = _HOST.get(type(params), _HOST[WorldParams])
    if plants == (None, None):
        raise ValueError(
            "the unicycle family is kinematic: there is no native/MuJoCo plant to adjudicate "
            "(no contact or inertia physics); its fine-RK4 torch world IS the ground truth "
            "(use --world torch)"
        )
    cls = plants[backend == "mujoco"]
    if cls is None:
        raise ValueError("no native C++ twin is wired for the arm family; use --world torch or "
                         "--world mujoco")
    if cls is mujoco_world.MujocoPointMassWorld and str(cfg.env).endswith(".xml"):
        return cls(params, xml_path=str(cfg.env))
    return cls(params)


__all__ = [
    "WorldParams", "world_params_for_config", "params_for_config", "make_world",
    "make_host_world", "TorchPlant", "WORLD_BACKENDS", "native_available", "mujoco_available",
    "load_world_xml", "XMLWorld", "XMLWorldError",
    "PointMassWorld", "WorldState", "PendulumParams", "PendulumState", "PendulumWorld",
    "CartPoleParams", "CartPoleState", "CartPoleWorld", "UnicycleParams", "UnicycleState",
    "UnicycleWorld", "QuadrotorParams", "QuadrotorState", "QuadrotorWorld", "ArmParams",
    "ArmState", "ArmWorld", "Quadrotor3DParams", "Quadrotor3DState", "Quadrotor3DWorld",
]
