"""The families of the fused solve (counterpart of
``mppi_gpu_tpu.ops.pallas_rollout.FAMILIES`` and ``family_for``, without the
TPU's tile layout).

A family is one (dynamics type, cost type) pair whose step and cost the fused
solve kernel K1 (``csrc/mppi_solve.cu``) carries as a compile-time template
argument. :func:`family_for` maps the exact pair to a :class:`FusedFamily`:
the family's id in the C entry, its state dimension S and its parameters
packed into one float32 vector on the solve's device, built once (the
controller builds it at init, so a solve reads no device scalar):

    [σ (A), Σ⁻¹ (A), family part]
    lti        w (2A)
    pendulum   w_angle, w_vel, g/l, m·l², b
    cartpole   w_pos, w_angle, w_posvel, w_angvel, m_p·l, m_p, m_c + m_p, l, g
    unicycle   w_pos, w_head
    quadrotor  w_px, w_pz, w_th, w_vx, w_vz, w_om, m, I, r, g
    arm        w_pos, w_vel, A, B, D, G1, G2, b, max_rate, l1, l2 (the cost's)

A family whose cost has a ``goal`` field (lti, unicycle, quadrotor, arm)
takes its goal, of the state's length, per call and per robot, not in the
pack. The derived entries (g/l, m·l², m_p·l, m_c + m_p) are computed in
float32 from the model's own tensors, as the eager model computes them, and
K1 divides where the model divides (by m·l², m_c + m_p, m, I and the arm's
mass-matrix determinant), so the kernel repeats the eager model's
arithmetic. The arm's forward kinematics take the link lengths of the cost,
as the eager cost does. The family also keeps the eager model and cost
themselves: they are the kernel's plain version (``ops/fused_solve.py``).

A mismatched pair (a pendulum with the quadratic cost, say) is not fusable
and raises ``TypeError``, as ``family_for`` does in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from mppi_gpu_tpu_torch.models.arm import TwoLinkArmDynamics
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.cartpole import CartPoleDynamics
from mppi_gpu_tpu_torch.models.pendulum import PendulumDynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_gpu_tpu_torch.models.unicycle import UnicycleDynamics
from mppi_gpu_tpu_torch.ops.cost import (
    ArmReachCost,
    CartPoleBalanceCost,
    Cost,
    PendulumSwingupCost,
    QuadraticCost,
    QuadrotorHoverCost,
    UnicycleWaypointCost,
)

MAX_A = 4  # one Philox call yields four normals


@dataclass(frozen=True)
class FusedFamily:
    name: str              # a key of FAMILY_ID
    fid: int               # FamilyId in csrc/mppi_solve.cu
    state_dim: int         # S
    action_dim: int        # A
    dynamics: Dynamics     # the eager model and cost: the plain version
    cost: Cost
    sigma: torch.Tensor    # (A,) noise std, also the pack's head
    params: torch.Tensor   # packed float32 vector, on the solve's device
    dt: float              # host copies of the kernel's scalars
    lam_cost: float

    @property
    def has_goal(self) -> bool:
        """The cost has a ``goal`` field, passed per call and per robot, and
        not a built-in target (``mppi_gpu_tpu.batched._has_goal``)."""
        return any(f.name == "goal" for f in dataclasses.fields(self.cost))

    @property
    def n_params(self) -> int:
        """Length of the pack: the floats K1 reads from `params`."""
        A = self.action_dim
        part = {"lti": 2 * A, "pendulum": 5, "cartpole": 9, "unicycle": 2, "quadrotor": 10,
                "arm": 11}
        return 2 * A + part[self.name]

    def cost_for(self, goal: torch.Tensor | None) -> Cost:
        """The eager cost aiming at `goal` (one robot's), for the plain
        version; the cost itself for a family without a goal."""
        return dataclasses.replace(self.cost, goal=goal) if self.has_goal else self.cost


def _lti_part(dyn: PointMassLTI, cost: QuadraticCost) -> list[torch.Tensor]:
    return [cost.w]


def _pendulum_part(dyn: PendulumDynamics, cost: PendulumSwingupCost) -> list[torch.Tensor]:
    return [
        cost.w_angle, cost.w_vel, dyn.gravity / dyn.length, dyn.mass * dyn.length**2,
        dyn.damping,
    ]


def _cartpole_part(dyn: CartPoleDynamics, cost: CartPoleBalanceCost) -> list[torch.Tensor]:
    mp, l = dyn.pole_mass, dyn.pole_length
    return [cost.w, mp * l, mp, dyn.cart_mass + mp, l, dyn.gravity]


def _unicycle_part(dyn: UnicycleDynamics, cost: UnicycleWaypointCost) -> list[torch.Tensor]:
    return [cost.w]


def _quadrotor_part(dyn: QuadrotorDynamics, cost: QuadrotorHoverCost) -> list[torch.Tensor]:
    return [cost.w, dyn.mass, dyn.inertia, dyn.arm, dyn.gravity]


def _arm_part(dyn: TwoLinkArmDynamics, cost: ArmReachCost) -> list[torch.Tensor]:
    return [
        cost.w, dyn.A, dyn.B, dyn.D, dyn.G1, dyn.G2, dyn.damping, dyn.max_rate,
        torch.as_tensor(cost.l1), torch.as_tensor(cost.l2),
    ]


# name → (FamilyId, model type, cost type, family part of the pack)
_FAMILIES: dict[str, tuple[int, type, type, Callable]] = {
    "lti": (0, PointMassLTI, QuadraticCost, _lti_part),
    "pendulum": (1, PendulumDynamics, PendulumSwingupCost, _pendulum_part),
    "cartpole": (2, CartPoleDynamics, CartPoleBalanceCost, _cartpole_part),
    "unicycle": (3, UnicycleDynamics, UnicycleWaypointCost, _unicycle_part),
    "quadrotor": (4, QuadrotorDynamics, QuadrotorHoverCost, _quadrotor_part),
    "arm": (5, TwoLinkArmDynamics, ArmReachCost, _arm_part),
}
FAMILY_NAMES = tuple(_FAMILIES)
FAMILY_ID = {name: fid for name, (fid, *_) in _FAMILIES.items()}


def covered() -> str:
    """The pairs the fused solve covers, for error messages."""
    pairs = ", ".join(f"{m.__name__} + {c.__name__}" for _, m, c, _ in _FAMILIES.values())
    return f"{pairs} (A <= {MAX_A})"


def family_name(dyn: Dynamics, cost: Cost) -> str:
    """The fused family of the exact (model, cost) pair, or ``TypeError``."""
    for name, (_, model_t, cost_t, _) in _FAMILIES.items():
        if isinstance(dyn, model_t) and type(cost) is cost_t and dyn.action_dim <= MAX_A:
            return name
    raise TypeError(
        f"the fused solve covers {covered()}; got {type(dyn).__name__} + {type(cost).__name__}"
    )


def is_fusable(dyn: Dynamics, cost: Cost) -> bool:
    try:
        family_name(dyn, cost)
    except TypeError:
        return False
    return True


def family_for(dyn: Dynamics, cost: Cost, sigma: torch.Tensor) -> FusedFamily:
    """The fused family of (dyn, cost) with its parameters packed on σ's
    device. Reads dt and λ to the host once."""
    name = family_name(dyn, cost)
    fid, _, _, part = _FAMILIES[name]
    head = [sigma, cost.inv_s]
    params = torch.cat([
        t.to(sigma.device, torch.float32).reshape(-1) for t in head + part(dyn, cost)
    ])
    return FusedFamily(
        name=name, fid=fid, state_dim=dyn.state_dim, action_dim=dyn.action_dim,
        dynamics=dyn, cost=cost, sigma=sigma, params=params.to(sigma.device).contiguous(),
        dt=float(dyn.dt), lam_cost=float(cost.lambda_),
    )
