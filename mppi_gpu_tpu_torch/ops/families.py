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
    lti           w (2A)
    pendulum      w_angle, w_vel, g/l, m·l², b
    cartpole      w_pos, w_angle, w_posvel, w_angvel, m_p·l, m_p, m_c + m_p, l, g
    unicycle      w_pos, w_head
    quadrotor     w_px, w_pz, w_th, w_vx, w_vz, w_om, m, I, r, g
    arm           w_pos, w_vel, A, B, D, G1, G2, b, max_rate, l1, l2 (the cost's)
    lti-obstacle  w (2A), penalty, M, centres (M·A), r² (M)
    quadrotor3d   w (8), m, Jx, Jy, Jz, Jz − Jy, Jx − Jz, Jy − Jx, g

A family whose cost has a goal (all but the pendulum and the cart-pole; the
obstacle cost's is its quadratic base's, ``ops/cost.goal_of``) takes it, of
the state's length, per call and per robot, not in the pack. The derived
entries (g/l, m·l², m_p·l, m_c + m_p, the inertia differences, r²) are
computed in float32 from the model's and the cost's own tensors, as the
eager model and cost compute them, and K1 divides where the model divides
(by m·l², m_c + m_p, m, I, Jx, Jy, Jz and the arm's mass-matrix
determinant), so the kernel repeats the eager arithmetic. The obstacle count
M is stored as a float (exact) and read by K1 at run time. The arm's forward
kinematics take the link lengths of the cost, as the eager cost does. The
family also keeps the eager model and cost themselves: they are the
kernel's plain version (``ops/fused_solve.py``).

A mismatched pair (a pendulum with the quadratic cost, say) is not fusable
and raises ``TypeError``, as ``family_for`` does in the JAX package; so is
an obstacle cost whose base is not the quadratic cost or whose centres are
not of the action's width (``pallas_rollout._LTIObstacleFamily.supports``).

A family can also be registered from user code (:func:`register_family`,
the counterpart of ``mppi_gpu_tpu.register_family``): a class with

* ``name: str`` — unique, not a built-in name;
* ``supports(dyn, cost) -> bool`` — whether it fuses the pair;
* ``pack(dyn, cost) -> list[Tensor]`` — the family part of the pack, after
  the shared ``[σ, Σ⁻¹]`` head, in the order its struct's ``load`` reads it;
* ``cuda_source: str`` — CUDA C++ that defines a family struct as
  ``csrc/mppi_solve.cuh`` describes it (``kS``, ``kGoal``, ``load``,
  ``step``, ``cost``), in its plain version's order of rounded operations,
  as the built-in structs in ``csrc/mppi_solve.cu`` are written;
* ``cuda_struct: str`` — the struct's name;
* ``has_goal: bool`` (optional, default False) — the Python mirror of the
  struct's ``kGoal``: True when the struct reads a per-call goal of the
  state's length (the cost's ``goal``, per robot), False when the family
  keeps its target in its pack (re-aiming the cost then re-packs).

:func:`family_name`, :func:`is_fusable`, :func:`family_for` and
:func:`covered` consult the user families after the built-ins, the first
that supports the pair winning. A user family's :class:`FusedFamily` has no
FamilyId; it carries the registered class, whose K1 and K4 are built from
its source into a library of their own at the first launch on a CUDA
device (``ops/_build.load_family_library``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from mppi_gpu_tpu_torch.models.arm import TwoLinkArmDynamics
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.models.cartpole import CartPoleDynamics
from mppi_gpu_tpu_torch.models.pendulum import PendulumDynamics
from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_gpu_tpu_torch.models.quadrotor3d import Quadrotor3DDynamics
from mppi_gpu_tpu_torch.models.unicycle import UnicycleDynamics
from mppi_gpu_tpu_torch.ops.cost import (
    ArmReachCost,
    CartPoleBalanceCost,
    Cost,
    ObstacleCost,
    PendulumSwingupCost,
    QuadraticCost,
    Quadrotor3DHoverCost,
    QuadrotorHoverCost,
    UnicycleWaypointCost,
    goal_of,
    has_goal,
    with_goal,
)

MAX_A = 4  # one Philox call yields four normals


@dataclass(frozen=True)
class FusedFamily:
    name: str              # a key of FAMILY_ID, or a registered family's name
    fid: int | None        # FamilyId in csrc/mppi_solve.cu; None for a user family
    state_dim: int         # S
    action_dim: int        # A
    dynamics: Dynamics     # the eager model and cost: the plain version
    cost: Cost
    sigma: torch.Tensor    # (A,) noise std, also the pack's head
    params: torch.Tensor   # packed float32 vector, on the solve's device
    dt: float              # host copies of the kernel's scalars
    lam_cost: float
    user: type | None = None  # the registered class of a user family
    user_params: int = 0      # the length of its family part of the pack

    @property
    def has_goal(self) -> bool:
        """A goal is passed per call and per robot: the cost has one
        (``ops/cost.goal_of``) and not a built-in target
        (``mppi_gpu_tpu.batched._has_goal``); for a user family, its
        ``has_goal`` (its struct's kGoal)."""
        if self.user is not None:
            return bool(getattr(self.user, "has_goal", False))
        return has_goal(self.cost)

    @property
    def n_params(self) -> int:
        """Length of the pack: the floats K1 reads from `params`."""
        A = self.action_dim
        if self.user is not None:
            return 2 * A + self.user_params
        if self.name == "lti-obstacle":
            return 4 * A + 2 + self.cost.centers.shape[0] * (A + 1)
        part = {"lti": 2 * A, "pendulum": 5, "cartpole": 9, "unicycle": 2, "quadrotor": 10,
                "arm": 11, "quadrotor3d": 16}
        return 2 * A + part[self.name]

    def cost_for(self, goal: torch.Tensor | None) -> Cost:
        """The eager cost aiming at `goal` (one robot's), for the plain
        version; the cost itself for a family without a goal."""
        return with_goal(self.cost, goal) if self.has_goal else self.cost


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


def _obstacle_part(dyn: PointMassLTI, cost: ObstacleCost) -> list[torch.Tensor]:
    M = torch.tensor(float(cost.centers.shape[0]), device=cost.penalty.device)
    return [cost.base.w, cost.penalty, M, cost.centers, cost.radii**2]


def _quadrotor3d_part(dyn: Quadrotor3DDynamics, cost: Quadrotor3DHoverCost) -> list[torch.Tensor]:
    jx, jy, jz = dyn.inertia[0], dyn.inertia[1], dyn.inertia[2]
    return [cost.w, dyn.mass, dyn.inertia, jz - jy, jx - jz, jy - jx, dyn.gravity]


def _obstacle_fits(dyn: PointMassLTI, cost: ObstacleCost) -> bool:
    """``_LTIObstacleFamily.supports``: a quadratic base, obstacle centres in
    the position space of the action's width."""
    return type(cost.base) is QuadraticCost and cost.centers.shape[-1] == dyn.action_dim


# name → (FamilyId, model type, cost type, family part of the pack, and the
# pair's further condition or None)
_FAMILIES: dict[str, tuple[int, type, type, Callable, Callable | None]] = {
    "lti": (0, PointMassLTI, QuadraticCost, _lti_part, None),
    "pendulum": (1, PendulumDynamics, PendulumSwingupCost, _pendulum_part, None),
    "cartpole": (2, CartPoleDynamics, CartPoleBalanceCost, _cartpole_part, None),
    "unicycle": (3, UnicycleDynamics, UnicycleWaypointCost, _unicycle_part, None),
    "quadrotor": (4, QuadrotorDynamics, QuadrotorHoverCost, _quadrotor_part, None),
    "arm": (5, TwoLinkArmDynamics, ArmReachCost, _arm_part, None),
    "lti-obstacle": (6, PointMassLTI, ObstacleCost, _obstacle_part, _obstacle_fits),
    "quadrotor3d": (7, Quadrotor3DDynamics, Quadrotor3DHoverCost, _quadrotor3d_part, None),
}
FAMILY_NAMES = tuple(_FAMILIES)
FAMILY_ID = {name: fid for name, (fid, *_) in _FAMILIES.items()}

# families registered from user code, by name, in registration order
_USER_FAMILIES: dict[str, type] = {}
_USER_PROTOCOL = ("name", "supports", "pack", "cuda_source", "cuda_struct")


def register_family(cls):
    """Register a fused (model, cost) family from user code (usable as a
    class decorator); the protocol is in the module's docstring. A missing
    attribute raises ``TypeError``, a built-in name ``ValueError``;
    registering a name again replaces the family (a module imported
    twice)."""
    for attr in _USER_PROTOCOL:
        if not hasattr(cls, attr):
            raise TypeError(f"fused family {cls!r} lacks required attribute '{attr}'")
    if not isinstance(cls.name, str) or not cls.name:
        raise TypeError(f"fused family {cls!r}: 'name' must be a non-empty str")
    if not isinstance(cls.cuda_source, str) or not isinstance(cls.cuda_struct, str):
        raise TypeError(f"fused family '{cls.name}': 'cuda_source' and 'cuda_struct' must be str")
    if cls.name in _FAMILIES:
        raise ValueError(f"cannot override built-in fused family '{cls.name}'")
    _USER_FAMILIES[cls.name] = cls
    return cls


def unregister_family(name: str) -> None:
    """Remove a family registered from user code; built-ins are
    permanent (``ValueError``)."""
    if name in _FAMILIES:
        raise ValueError(f"cannot unregister built-in fused family '{name}'")
    _USER_FAMILIES.pop(name, None)


def covered() -> str:
    """The pairs the fused solve covers, for error messages."""
    pairs = ", ".join(f"{m.__name__} + {c.__name__}" for _, m, c, *_ in _FAMILIES.values())
    users = "".join(f", {name} (registered)" for name in _USER_FAMILIES)
    return f"{pairs}{users} (A <= {MAX_A})"


def family_name(dyn: Dynamics, cost: Cost) -> str:
    """The fused family of the exact (model, cost) pair, or ``TypeError``:
    the built-ins first, then the families registered from user code."""
    if dyn.action_dim <= MAX_A:
        for name, (_, model_t, cost_t, _, fits) in _FAMILIES.items():
            if (isinstance(dyn, model_t) and type(cost) is cost_t
                    and (fits is None or fits(dyn, cost))):
                return name
        for name, cls in _USER_FAMILIES.items():
            if cls.supports(dyn, cost):
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
    user = _USER_FAMILIES.get(name)
    if user is None:
        fid, _, _, part, _ = _FAMILIES[name]
        parts = part(dyn, cost)
    else:
        fid, parts = None, user.pack(dyn, cost)
    parts = [torch.as_tensor(t).to(sigma.device, torch.float32).reshape(-1) for t in parts]
    head = [t.to(sigma.device, torch.float32).reshape(-1) for t in (sigma, cost.inv_s)]
    return FusedFamily(
        name=name, fid=fid, state_dim=dyn.state_dim, action_dim=dyn.action_dim,
        dynamics=dyn, cost=cost, sigma=sigma, params=torch.cat(head + parts).contiguous(),
        dt=float(dyn.dt), lam_cost=float(cost.lambda_), user=user,
        user_params=sum(t.numel() for t in parts) if user is not None else 0,
    )


def call_goal(fam: FusedFamily | None, cost: Cost) -> torch.Tensor | None:
    """The goal a solve of `cost` passes per call (``ops/cost.goal_of``), or
    None where its fused family `fam` keeps the target in its pack (a user
    family without ``has_goal``). With `fam` None (a pair no family fuses)
    the cost's goal, which the eager path reads from the cost itself."""
    return goal_of(cost) if fam is None or fam.has_goal else None
