"""Ground-truth cart-pole world in torch (counterpart of
``mppi_gpu_tpu.envs.cartpole_world``): the controller model's coupled ODE
(``models/cartpole.py``) integrated with RK4 at a 10× finer timestep, with
the actuator clamp and a hard track limit (the cart is clamped at
±track_limit and its velocity zeroed at the stop), four physics steps per
control cycle of 1/60 s and 500 control cycles per episode. State is
float32, time included, like the JAX world. A fleet of R cart-poles is one
state whose four leaves are (R,), under one shared clock or one clock per
robot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.envs.base import ControlCadence, World, clock


@dataclass(frozen=True)
class CartPoleParams(ControlCadence):
    cart_mass: float = 1.0
    pole_mass: float = 0.1
    pole_length: float = 0.5
    gravity: float = 9.81
    max_force: float = 10.0
    track_limit: float = 2.4
    timestep: float = 0.005
    control_period: float = 1.0 / 60.0
    sim_end: float = 10.0001
    init_theta: float = 0.15  # start tilted: the controller must catch it

    @property
    def state_dim(self) -> int:
        return 4


class CartPoleState(NamedTuple):
    p: torch.Tensor     # 0-dim float32, or (R,) for a fleet
    th: torch.Tensor
    pd: torch.Tensor
    thd: torch.Tensor
    time: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        """[p, θ, ṗ, θ̇]: (4,), or (R, 4) for a fleet."""
        return torch.stack([self.p, self.th, self.pd, self.thd], dim=-1)


@dataclass(frozen=True)
class CartPoleWorld(World):
    params: CartPoleParams
    device: torch.device | str = "cpu"

    def _accels(self, th, thd, u):
        pp = self.params
        total = pp.cart_mass + pp.pole_mass
        s, c = torch.sin(th), torch.cos(th)
        a = (u + pp.pole_mass * pp.pole_length * thd**2 * s) / total
        thdd = (pp.gravity * s - c * a) / (
            pp.pole_length * (4.0 / 3.0 - pp.pole_mass * c**2 / total)
        )
        pdd = a - pp.pole_mass * pp.pole_length * thdd * c / total
        return pdd, thdd

    def physics_step(self, s: CartPoleState, u: torch.Tensor) -> CartPoleState:
        pp = self.params
        h = pp.timestep
        u0 = torch.clamp(u[..., 0], -pp.max_force, pp.max_force)

        def deriv(p, th, pd, thd):
            pdd, thdd = self._accels(th, thd, u0)
            return pd, thd, pdd, thdd

        y = (s.p, s.th, s.pd, s.thd)
        k1 = deriv(*y)
        k2 = deriv(*(yi + 0.5 * h * ki for yi, ki in zip(y, k1)))
        k3 = deriv(*(yi + 0.5 * h * ki for yi, ki in zip(y, k2)))
        k4 = deriv(*(yi + h * ki for yi, ki in zip(y, k3)))
        p, th, pd, thd = (
            yi + (h / 6.0) * (a + 2 * b + 2 * c + d)
            for yi, a, b, c, d in zip(y, k1, k2, k3, k4)
        )
        hit = torch.abs(p) > pp.track_limit
        p = torch.clamp(p, -pp.track_limit, pp.track_limit)
        pd = torch.where(hit, torch.zeros_like(pd), pd)
        return CartPoleState(p=p, th=th, pd=pd, thd=thd, time=s.time + h)

    def reset(self, n_robots: int | None = None) -> CartPoleState:
        """Centred, the pole tilted by init_theta, at rest, time = timestep;
        with `n_robots`, R cart-poles so."""
        f32 = dict(dtype=torch.float32, device=self.device)
        pp = self.params
        shape = () if n_robots is None else (n_robots,)
        z = torch.zeros(shape, **f32)
        return CartPoleState(
            p=z, th=torch.full(shape, pp.init_theta, **f32), pd=z, thd=z,
            time=torch.tensor(pp.timestep, **f32),
        )

    def from_x(self, x: torch.Tensor, time) -> CartPoleState:
        """The state whose [p, θ, ṗ, θ̇] is `x` ((4,) or (R, 4)) at `time`."""
        return CartPoleState(*x.unbind(-1), time=clock(time, x.device))
