"""Out-of-tree fused family: a kinematic bicycle (front-steer car),
registered from user code (counterpart of the repo's
``examples/custom_family.py``, with the same model, cost, controller and exit
criterion).

Everything here is user code; nothing in the package is edited:

1. ``BicycleDynamics`` / ``BicycleWaypointCost``: an ordinary model and cost
   (the ``Dynamics`` and ``Cost`` protocols). They alone give a working
   controller on the eager backend, on any device, and they are the plain
   version the fused kernels are held against.
2. ``BicycleFamily``: the pair's fused twin, registered with
   ``@register_family``. It gives the pack (its parameters after the shared
   σ and Σ⁻¹) and a CUDA C++ struct that steps the model and costs a state
   with the same rounded operations in the same order. At the first solve on
   a CUDA device the struct is compiled with ``nvcc`` into a library of its
   own (``build/mppi_gpu_tpu_torch/libfamily_<hash>.so``), which instantiates
   K1 (the fused solve's rollout kernel) and K4 (the costs-only sweep) on it;
   K2, K3, the fleet grid and the sharded solve are shared machinery. After
   registration the ``auto`` backend resolves the pair to ``fused`` on a
   CUDA device, as it does the eight built-in families.

The model: rear-axle kinematic bicycle with velocity drag,

    ṗx = v·cos θ      θ̇ = v·tan δ / L
    ṗy = v·sin θ      v̇ = a − c·v

state ``x = [px, py, θ, v]``, action ``u = [a, δ]`` (acceleration, steer
angle), one RK2 (midpoint) step of dt per horizon step, tan δ as sin δ / cos δ.
The waypoint lives in the cost, and so in the family's pack: re-aiming the
cost re-packs (the family has no per-call goal).

Run:  python -m mppi_gpu_tpu_torch.examples.custom_family [--steps 120] [--samples 1024]
      [--backend auto|eager|fused]   (``--device cpu`` runs the eager path on the CPU)

Prints the resolved backend, the final pose and its distance to the
waypoint; exits 0 when that distance is under 0.3 m.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.controller import BACKENDS, MPPIController
from mppi_gpu_tpu_torch.ops.families import register_family

WAYPOINT = (3.0, 1.5)
REACH = 0.3  # m

# ---------------------------------------------------------------------------
# 1) the model and the cost: plain torch, the eager path and the plain version


@dataclass(frozen=True)
class BicycleDynamics:
    dt: torch.Tensor         # 0-dim float32
    wheelbase: torch.Tensor  # L
    drag: torch.Tensor       # c
    state_dim: int = 4
    action_dim: int = 2

    @staticmethod
    def create(dt: float, wheelbase: float = 0.5, drag: float = 0.3,
               device: torch.device | str = "cpu") -> "BicycleDynamics":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return BicycleDynamics(dt=f32(dt), wheelbase=f32(wheelbase), drag=f32(drag))

    def _deriv(self, x: torch.Tensor, acc: torch.Tensor, tan_d: torch.Tensor) -> torch.Tensor:
        th, v = x[..., 2], x[..., 3]
        return torch.stack(
            [v * torch.cos(th), v * torch.sin(th), v * tan_d / self.wheelbase, acc - self.drag * v],
            dim=-1,
        )

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        acc, steer = u[..., 0], u[..., 1]
        # tan as sin/cos, the expression the CUDA struct repeats
        tan_d = torch.sin(steer) / torch.cos(steer)
        h = self.dt
        x_m = x + 0.5 * h * self._deriv(x, acc, tan_d)  # RK2 midpoint
        return x + h * self._deriv(x_m, acc, tan_d)


@dataclass(frozen=True)
class BicycleWaypointCost:
    """``w = [w_pos, w_vel]``: the squared distance to the (gx, gy) waypoint
    plus a cruise-speed term (v − v_ref)², and the MPPI control term."""

    w: torch.Tensor        # (2,)
    goal: torch.Tensor     # (2,) waypoint position
    v_ref: torch.Tensor    # 0-dim cruise speed
    lambda_: torch.Tensor  # 0-dim temperature
    inv_s: torch.Tensor    # (2,) diagonal of Σ⁻¹

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        dx = x[..., 0] - self.goal[0]
        dy = x[..., 1] - self.goal[1]
        dv = x[..., 3] - self.v_ref
        return self.w[0] * (dx * dx + dy * dy) + self.w[1] * dv * dv

    def step(self, x_next: torch.Tensor, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        ctrl = self.lambda_ * torch.sum(u * self.inv_s * eps, dim=-1)
        return ctrl + self._state(x_next)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self._state(x)


# ---------------------------------------------------------------------------
# 2) the fused family, registered from user code

BICYCLE_CUDA = r"""
// Kinematic bicycle, x = (px, py, th, v), u = (a, delta): BicycleDynamics.step
// and BicycleWaypointCost._state, operation for operation.
struct Bicycle {
  static constexpr int kS = 4;
  static constexpr bool kGoal = false;  // the waypoint is in the pack
  float w_pos, w_vel, gx, gy, v_ref, L, drag, h, hh;

  __device__ __forceinline__ void load(const float* fp, const float*, float dt) {
    w_pos = fp[0];
    w_vel = fp[1];
    gx = fp[2];
    gy = fp[3];
    v_ref = fp[4];
    L = fp[5];
    drag = fp[6];
    h = dt;
    hh = 0.5f * dt;
  }

  __device__ __forceinline__ void deriv(const float s[4], float acc, float tan_d,
                                        float d[4]) const {
    d[0] = __fmul_rn(s[3], cosf(s[2]));
    d[1] = __fmul_rn(s[3], sinf(s[2]));
    d[2] = __fdiv_rn(__fmul_rn(s[3], tan_d), L);
    d[3] = __fsub_rn(acc, __fmul_rn(drag, s[3]));
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[2]) const {
    const float tan_d = __fdiv_rn(sinf(ue[1]), cosf(ue[1]));
    float d[4], m[4];
    deriv(x, ue[0], tan_d, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = __fadd_rn(x[i], __fmul_rn(hh, d[i]));
    deriv(m, ue[0], tan_d, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __fadd_rn(x[i], __fmul_rn(h, d[i]));
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    const float dx = __fsub_rn(x[0], gx), dy = __fsub_rn(x[1], gy), dv = __fsub_rn(x[3], v_ref);
    return __fadd_rn(__fmul_rn(w_pos, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))),
                     __fmul_rn(__fmul_rn(w_vel, dv), dv));
  }
};
"""


@register_family
class BicycleFamily:
    """Fused family of (BicycleDynamics, BicycleWaypointCost). Its pack
    after σ and Σ⁻¹: w_pos, w_vel, gx, gy, v_ref, L, c (the struct's
    ``load`` order)."""

    name = "bicycle-demo"
    cuda_source = BICYCLE_CUDA
    cuda_struct = "Bicycle"
    has_goal = False

    @staticmethod
    def supports(dyn, cost) -> bool:
        return isinstance(dyn, BicycleDynamics) and type(cost) is BicycleWaypointCost

    @staticmethod
    def pack(dyn: BicycleDynamics, cost: BicycleWaypointCost) -> list[torch.Tensor]:
        return [cost.w, cost.goal, cost.v_ref, dyn.wheelbase, dyn.drag]


# ---------------------------------------------------------------------------
# demo: receding-horizon drive to the waypoint, the model as the world


def bicycle_config(samples: int = 1024, horizon: int = 40) -> MPPIConfig:
    """The JAX example's controller settings."""
    return MPPIConfig(
        env="bicycle-demo", samples=samples, state_dim=4, action_dim=2, horizon=horizon,
        dt=0.05, lambda_=0.4, noise=(0.8, 0.5), init_act=(0.0, 0.0), max_a=(2.0, 0.6),
        goal=(*WAYPOINT, 0.0, 0.0), cost_w=(1.0, 1.0, 0.0, 0.0),
    )


def bicycle_pair(cfg: MPPIConfig, device: torch.device | str = "cpu"):
    """The JAX example's model and cost for `cfg`, on `device`."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    dyn = BicycleDynamics.create(cfg.dt, device=device)
    cost = BicycleWaypointCost(
        # v_ref = 0: the speed term doubles as a brake, parking the car at the
        # waypoint instead of cruising past it
        w=f32([2.0, 0.3]), goal=f32(WAYPOINT), v_ref=f32(0.0), lambda_=f32(cfg.lambda_),
        inv_s=f32([1.0, 1.0]),
    )
    return dyn, cost


def make_controller(samples: int, horizon: int = 40, backend: str = "auto",
                    device: torch.device | str = "cuda"):
    """The JAX example's controller: (MPPIController, its model)."""
    cfg = bicycle_config(samples, horizon)
    dyn, cost = bicycle_pair(cfg, device)
    ctrl = MPPIController(cfg, device=device, rollout_backend=backend, dynamics=dyn, cost=cost)
    return ctrl, dyn


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m mppi_gpu_tpu_torch.examples.custom_family")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    ctrl, dyn = make_controller(args.samples, backend=args.backend, device=device)
    print(f"backend resolved: {ctrl.rollout_backend}")
    x = torch.zeros(4, dtype=torch.float32, device=device)  # at rest at the origin
    U = ctrl.init_action_seq()
    for step in range(args.steps):  # the model as the world
        res = ctrl.solve_auto(x, U, step)
        x, U = dyn.step(x, res.action), res.u_next
    x = x.cpu()
    px, py = float(x[0]), float(x[1])
    d = ((px - WAYPOINT[0]) ** 2 + (py - WAYPOINT[1]) ** 2) ** 0.5
    print(f"final pose ({px:.3f}, {py:.3f})  dist-to-waypoint {d:.3f} m")
    ok = d < REACH
    print("reached waypoint" if ok else "did NOT reach waypoint")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
