"""Rollout cost functions (torch counterpart of ``mppi_gpu_tpu.ops.cost``).

:class:`QuadraticCost` matches the reference's `Cost` (src/cost.cu:42-64):

    step(x', u, ε)  = λ · Σ_i u_i · Σ⁻¹_ii · ε_i  +  Σ_j w_j (x'_j − g_j)²
    final(x)        =                              Σ_j w_j (x_j  − g_j)²

with ``x'`` the state after applying ``u + ε``. The rollout total is
``Σ_{t<T} step(x_{t+1}, u_t, ε_t) + final(x_T)``: the terminal state cost is
counted twice, kept for reference parity.

A fleet's per-robot goals ride the cost's ``goal`` field with a leading
robot axis R (:func:`batch_goals`, the counterpart of
``mppi_gpu_tpu.batched._batch_goals``); ``step`` and ``final`` then take
states of shape (R, K, s). A cost's goal is read and replaced through
:func:`goal_of` and :func:`with_goal`, which look through the ``base`` of a
cost that wraps a goal cost (:class:`ObstacleCost`).

:class:`PendulumSwingupCost` and :class:`CartPoleBalanceCost` are the
pendulum and cart-pole families' costs; their targets (upright, centred) are
built in, so they have no ``goal`` field. :class:`UnicycleWaypointCost`,
:class:`QuadrotorHoverCost`, :class:`ArmReachCost` and
:class:`Quadrotor3DHoverCost` are the unicycle, planar-quadrotor,
two-link-arm and 3-D quadrotor families' costs; each aims at a ``goal`` of
the state's length of which only some entries are read, and takes per-robot
goals as the quadratic cost does. :class:`ObstacleCost` is the quadratic
cost plus a penalty for each spherical obstacle the position is inside.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig


@runtime_checkable
class Cost(Protocol):
    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """(..., s), (a,) or (..., a), (..., a) → (...) per-sample step cost."""

    def final(self, x: torch.Tensor) -> torch.Tensor:
        """(..., s) → (...) terminal cost."""


def _ctrl(lambda_, u, inv_s, eps) -> torch.Tensor:
    """The MPPI control term λ · Σ_i u_i · Σ⁻¹_ii · ε_i of every cost."""
    return lambda_ * torch.sum(u * inv_s * eps, dim=-1)


@dataclass(frozen=True)
class QuadraticCost:
    w: torch.Tensor        # (s,) state-cost diagonal
    goal: torch.Tensor     # (s,), or (R, s) per robot of a fleet
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    def _goal(self) -> torch.Tensor:
        # per-robot goals (R, s) meet states (R, K, s)
        return self.goal if self.goal.dim() == 1 else self.goal[..., None, :]

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        d = x_next - self._goal()
        return _ctrl(self.lambda_, u, self.inv_s, eps) + torch.sum(d * self.w * d, dim=-1)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        d = x - self._goal()
        return torch.sum(d * self.w * d, dim=-1)


@dataclass(frozen=True)
class ObstacleCost:
    """The quadratic cost plus ``penalty`` for each spherical obstacle that
    the position ``x[:a]`` (a = the centres' width) lies inside, after each
    step and at the end: ``penalty · #{m : Σ_i (q_i − c_{m,i})² < r_m²}``.
    The squared distance is summed left to right over i, so the fused
    kernel's obstacle count (``csrc/mppi_solve.cu``) is this one bit for bit;
    a NaN distance is never inside. λ and Σ⁻¹ are the base cost's."""

    base: QuadraticCost
    centers: torch.Tensor  # (M, a) obstacle centres in position space
    radii: torch.Tensor    # (M,)
    penalty: torch.Tensor  # 0-dim

    @property
    def lambda_(self) -> torch.Tensor:
        return self.base.lambda_

    @property
    def inv_s(self) -> torch.Tensor:
        return self.base.inv_s

    def _obstacle(self, x: torch.Tensor) -> torch.Tensor:
        d2 = None
        for i in range(self.centers.shape[-1]):
            d = x[..., i, None] - self.centers[:, i]  # (..., M)
            d2 = d * d if d2 is None else d2 + d * d
        inside = d2 < self.radii**2
        return self.penalty * torch.sum(inside.to(x.dtype), dim=-1)

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return self.base.step(x_next, u, eps) + self._obstacle(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.final(x) + self._obstacle(x)


@dataclass(frozen=True)
class PendulumSwingupCost:
    """Swing-up cost of the pendulum family: ``w_angle·(1 − cos θ) +
    w_vel·θ̇²`` per step (θ = 0 upright; the trig form handles the angle
    wrap), plus the standard MPPI control term."""

    w_angle: torch.Tensor  # 0-dim
    w_vel: torch.Tensor    # 0-dim
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_angle * (1.0 - torch.cos(x[..., 0])) + self.w_vel * x[..., 1] ** 2

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return _ctrl(self.lambda_, u, self.inv_s, eps) + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


@dataclass(frozen=True)
class CartPoleBalanceCost:
    """Balance cost of the cart-pole family: pole upright, cart centred, both
    velocities low. ``w = [w_pos, w_angle, w_posvel, w_angvel]``; the angle
    term is the wrap-safe ``1 − cos θ``."""

    w: torch.Tensor        # (4,)
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        return (
            self.w[0] * x[..., 0] ** 2
            + self.w[1] * (1.0 - torch.cos(x[..., 1]))
            + self.w[2] * x[..., 2] ** 2
            + self.w[3] * x[..., 3] ** 2
        )

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return _ctrl(self.lambda_, u, self.inv_s, eps) + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


def _goal_xy(goal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first two goal entries, 0-dim for one goal (s,); (R, 1) for
    per-robot goals (R, s), to meet states (R, K, s)."""
    g = goal if goal.dim() == 1 else goal[..., None, :]
    return g[..., 0], g[..., 1]


@dataclass(frozen=True)
class UnicycleWaypointCost:
    """Waypoint cost of the unicycle family, ``w = [w_pos, w_head]``: the
    squared distance to the waypoint ``goal[0:2]`` plus the wrap-safe
    face-the-goal term ``w_head·(1 − d̂·ĥ)``, with d̂ the unit vector to the
    waypoint (one rsqrt; the 1e-3 m² keeps it finite at the waypoint) and
    ĥ = (cos θ, sin θ). ``goal[2]`` is unused."""

    w: torch.Tensor        # (2,)
    goal: torch.Tensor     # (3,), or (R, 3) per robot of a fleet
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    EPS = 1e-3

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        gx, gy = _goal_xy(self.goal)
        dx = gx - x[..., 0]
        dy = gy - x[..., 1]
        d2 = dx * dx + dy * dy
        align = (dx * torch.cos(x[..., 2]) + dy * torch.sin(x[..., 2])) * torch.rsqrt(d2 + self.EPS)
        return self.w[0] * d2 + self.w[1] * (1.0 - align)

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return _ctrl(self.lambda_, u, self.inv_s, eps) + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


@dataclass(frozen=True)
class ArmReachCost:
    """Reaching cost of the two-link-arm family, ``w = [w_pos, w_vel]``: the
    squared distance of the end effector, by the forward kinematics
    ``l1·(cos q1, sin q1) + l2·(cos(q1+q2), sin(q1+q2))``, to the target
    ``goal[0:2]``, plus ``w_vel·(q̇1² + q̇2²)``. ``goal[2:4]`` are unused. The
    link lengths are the cost's own (defaults of
    ``TwoLinkArmDynamics.create``) and may differ from the model's."""

    w: torch.Tensor        # (2,)
    goal: torch.Tensor     # (4,), or (R, 4) per robot of a fleet
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹
    l1: torch.Tensor | float = 0.5
    l2: torch.Tensor | float = 0.5

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        gx, gy = _goal_xy(self.goal)
        q1, q12 = x[..., 0], x[..., 0] + x[..., 1]
        ex = self.l1 * torch.cos(q1) + self.l2 * torch.cos(q12)
        ey = self.l1 * torch.sin(q1) + self.l2 * torch.sin(q12)
        dx, dy = ex - gx, ey - gy
        vel = x[..., 2] ** 2 + x[..., 3] ** 2
        return self.w[0] * (dx * dx + dy * dy) + self.w[1] * vel

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return _ctrl(self.lambda_, u, self.inv_s, eps) + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


@dataclass(frozen=True)
class QuadrotorHoverCost:
    """Hover/waypoint cost of the planar-quadrotor family, ``w = [w_px, w_pz,
    w_th, w_vx, w_vz, w_om]``: quadratic on the position towards
    ``goal[0:2]`` and on the velocities towards zero, wrap-safe
    ``1 − cos θ`` on the tilt. ``goal[2:6]`` are unused."""

    w: torch.Tensor        # (6,)
    goal: torch.Tensor     # (6,), or (R, 6) per robot of a fleet
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        gx, gz = _goal_xy(self.goal)
        dx, dz = x[..., 0] - gx, x[..., 1] - gz
        return (
            self.w[0] * dx * dx
            + self.w[1] * dz * dz
            + self.w[2] * (1.0 - torch.cos(x[..., 2]))
            + self.w[3] * x[..., 3] ** 2
            + self.w[4] * x[..., 4] ** 2
            + self.w[5] * x[..., 5] ** 2
        )

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return _ctrl(self.lambda_, u, self.inv_s, eps) + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


@dataclass(frozen=True)
class Quadrotor3DHoverCost:
    """Hover/waypoint cost of the 3-D quadrotor family, ``w = [w_px, w_py,
    w_pz, w_tilt, w_vx, w_vy, w_vz, w_om]``: quadratic on the position
    towards ``goal[0:3]`` and on the velocity towards ``goal[7:10]``, the
    tilt ``2(qx² + qy²)`` (zero iff the body z axis points up, yaw-free) and
    |ω|². Every sum runs left to right, in the JAX cost's order of terms.
    ``goal`` has the state's 13 entries; the others are unused."""

    w: torch.Tensor        # (8,)
    goal: torch.Tensor     # (13,), or (R, 13) per robot of a fleet
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (a,) diagonal of Σ⁻¹

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        g = self.goal if self.goal.dim() == 1 else self.goal[..., None, :]
        w = self.w

        def quad(i: int, k: int) -> torch.Tensor:  # w_k (x_i − g_i)²
            d = x[..., i] - g[..., i]
            return d * w[k] * d

        pos = quad(0, 0) + quad(1, 1) + quad(2, 2)
        tilt = 2.0 * (x[..., 4] * x[..., 4] + x[..., 5] * x[..., 5])
        vel = quad(7, 4) + quad(8, 5) + quad(9, 6)
        om = x[..., 10] * x[..., 10] + x[..., 11] * x[..., 11] + x[..., 12] * x[..., 12]
        return pos + w[3] * tilt + vel + w[7] * om

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return _ctrl(self.lambda_, u, self.inv_s, eps) + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


def _goal_owner(cost: Cost, *, required: bool = False):
    """The cost whose ``goal`` field holds `cost`'s goal: `cost` itself, or
    the goal cost it wraps in ``base`` (``mppi_gpu_tpu.batched._batch_goals``);
    for a cost whose target is built in None, or ``TypeError`` if
    `required`."""
    for c in (cost, getattr(cost, "base", None)):
        if dataclasses.is_dataclass(c) and any(f.name == "goal" for f in dataclasses.fields(c)):
            return c
    if required:
        raise TypeError(
            f"per-robot goals need a cost with a 'goal' field; "
            f"{type(cost).__name__} has none (its target is built in)"
        )
    return None


def has_goal(cost: Cost) -> bool:
    return _goal_owner(cost) is not None


def goal_of(cost: Cost) -> torch.Tensor | None:
    """`cost`'s goal, (s,) or (R, s) per robot; None for a built-in target."""
    owner = _goal_owner(cost)
    return None if owner is None else owner.goal


def with_goal(cost: Cost, goal: torch.Tensor) -> Cost:
    """`cost` aiming at `goal`, through its ``base`` where the goal lives
    there; ``TypeError`` for a cost whose target is built in."""
    owner = _goal_owner(cost, required=True)
    if owner is cost:
        return dataclasses.replace(cost, goal=goal)
    return dataclasses.replace(cost, base=dataclasses.replace(owner, goal=goal))


def only_goal_differs(old: Cost | None, new: Cost) -> bool:
    """True if `new` is `old` aimed elsewhere, as :func:`with_goal` makes it:
    the same type, and every field but the goal (through ``base`` where the
    goal lives there) the very same object. Identity, not equality: nothing
    is read from the device."""
    owner = _goal_owner(new)
    if old is None or owner is None or type(old) is not type(new):
        return False

    def same_but(a, b, skip: str) -> bool:
        return type(a) is type(b) and all(
            getattr(a, f.name) is getattr(b, f.name)
            for f in dataclasses.fields(b) if f.name != skip)

    if owner is new:
        return same_but(old, new, "goal")
    return same_but(old, new, "base") and same_but(old.base, new.base, "goal")


def goal_free_key(cost: Cost) -> tuple:
    """The identity of `cost` but its goal: its type and the id of every
    field but the goal (through ``base`` where the goal lives there); the
    cost's own id where its target is built in. While `cost` lives, another
    cost has its key exactly when :func:`only_goal_differs` holds between
    them (a solve graph keys on it and takes the goal as an input)."""
    owner = _goal_owner(cost)
    if owner is None:
        return (id(cost),)

    def ids(c, skip: str) -> tuple:
        return (type(c), *(id(getattr(c, f.name)) for f in dataclasses.fields(c) if f.name != skip))

    return ids(cost, "goal") if owner is cost else ids(cost, "base") + ids(owner, "goal")


def batch_goals(cost: Cost, goals: torch.Tensor, n_robots: int) -> Cost:
    """``cost`` with the (R, s) per-robot ``goals`` as its goal
    (:func:`with_goal`). Raises ``TypeError`` for a cost without a goal (its
    target is built in) and ``ValueError`` for goals that are not
    (n_robots, s)."""
    shape = (n_robots, _goal_owner(cost, required=True).goal.shape[-1])
    if tuple(goals.shape) != shape:
        raise ValueError(f"goals must be {shape}, got {tuple(goals.shape)}")
    return with_goal(cost, goals)


CostFactory = Callable[[MPPIConfig, torch.device], Cost]
COST_REGISTRY: dict[str, CostFactory] = {}


def register_cost(name: str) -> Callable[[CostFactory], CostFactory]:
    def deco(fn: CostFactory) -> CostFactory:
        COST_REGISTRY[name] = fn
        return fn

    return deco


def _inv_s(cfg: MPPIConfig, device: torch.device | str) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.inv_sigma == "from-noise":
        return 1.0 / torch.tensor(cfg.noise, **f32) ** 2
    return torch.ones(cfg.action_dim, **f32)  # reference parity: Σ⁻¹ = I


@register_cost("quadratic")
def _make_quadratic(cfg: MPPIConfig, device: torch.device | str) -> QuadraticCost:
    f32 = dict(dtype=torch.float32, device=device)
    return QuadraticCost(
        w=torch.tensor(cfg.cost_w, **f32),
        goal=torch.tensor(cfg.goal, **f32),
        lambda_=torch.tensor(cfg.lambda_, **f32),
        inv_s=_inv_s(cfg, device),
    )


@register_cost("pendulum")
def _make_pendulum(cfg: MPPIConfig, device: torch.device | str) -> PendulumSwingupCost:
    if len(cfg.cost_w) != 2:
        raise ValueError(f"pendulum cost needs cost.w = [w_angle, w_vel], got {cfg.cost_w}")
    f32 = dict(dtype=torch.float32, device=device)
    return PendulumSwingupCost(
        w_angle=torch.tensor(cfg.cost_w[0], **f32),
        w_vel=torch.tensor(cfg.cost_w[1], **f32),
        lambda_=torch.tensor(cfg.lambda_, **f32),
        inv_s=_inv_s(cfg, device),
    )


@register_cost("cartpole")
def _make_cartpole(cfg: MPPIConfig, device: torch.device | str) -> CartPoleBalanceCost:
    if len(cfg.cost_w) != 4:
        raise ValueError(
            "cartpole cost needs cost.w = [w_pos, w_angle, w_posvel, w_angvel], "
            f"got {cfg.cost_w}"
        )
    f32 = dict(dtype=torch.float32, device=device)
    return CartPoleBalanceCost(
        w=torch.tensor(cfg.cost_w, **f32),
        lambda_=torch.tensor(cfg.lambda_, **f32),
        inv_s=_inv_s(cfg, device),
    )


def _goal_cost(cls, n_w: int, names: str):
    """The factory of a goal-aiming cost `cls` whose cost.w holds the `n_w`
    weights `names`."""

    def make(cfg: MPPIConfig, device: torch.device | str):
        if len(cfg.cost_w) != n_w:
            raise ValueError(f"{cfg.cost_type} cost needs cost.w = [{names}], got {cfg.cost_w}")
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            w=torch.tensor(cfg.cost_w, **f32),
            goal=torch.tensor(cfg.goal, **f32),
            lambda_=torch.tensor(cfg.lambda_, **f32),
            inv_s=_inv_s(cfg, device),
        )

    return make


register_cost("unicycle")(_goal_cost(UnicycleWaypointCost, 2, "w_pos, w_head"))
register_cost("arm")(_goal_cost(ArmReachCost, 2, "w_pos, w_vel"))
register_cost("quadrotor")(
    _goal_cost(QuadrotorHoverCost, 6, "w_px, w_pz, w_th, w_vx, w_vz, w_om")
)
register_cost("quadrotor3d")(
    _goal_cost(Quadrotor3DHoverCost, 8, "w_px, w_py, w_pz, w_tilt, w_vx, w_vy, w_vz, w_om")
)


@register_cost("obstacle")
def _make_obstacle(cfg: MPPIConfig, device: torch.device | str) -> ObstacleCost:
    if not cfg.obstacles:
        raise ValueError(
            "cost.type 'obstacle' needs cost.obstacles: a list of "
            "[center..., radius] entries (center dims = action-dim)"
        )
    for o in cfg.obstacles:
        if len(o) != cfg.action_dim + 1:
            raise ValueError(
                f"each obstacle needs {cfg.action_dim} center coords + radius, "
                f"got {len(o)} values: {o}"
            )
    obs = torch.tensor(cfg.obstacles, dtype=torch.float32, device=device)
    return ObstacleCost(
        base=_make_quadratic(cfg, device), centers=obs[:, :-1].contiguous(),
        radii=obs[:, -1].contiguous(),
        penalty=torch.tensor(cfg.obstacle_w, dtype=torch.float32, device=device),
    )


def make_cost(cfg: MPPIConfig, device: torch.device | str) -> Cost:
    if cfg.cost_type in COST_REGISTRY:
        return COST_REGISTRY[cfg.cost_type](cfg, device)
    raise ValueError(
        f"unknown cost.type '{cfg.cost_type}'; known: {sorted(COST_REGISTRY)}"
    )
