"""``quadrotor3d``: the rigid body [p, q (w, x, y, z), v, ω] under
[F, τx, τy, τz] with diagonal inertia J: ṗ = v, v̇ = R(q) ẑ F/m − g ẑ,
q̇ = ½ q ⊗ (0, ω), ω̇ = J⁻¹ (τ − ω × Jω); one midpoint (RK2) step of dt,
the quaternion renormalised at the end of the step. Cost per step the same
control term as ``lti``'s plus w_p |p − g_p|² (per axis), w_tilt · 2 (qx² +
qy²), w_v |v − g_v|² (per axis) and w_ω |ω|²; the same state cost at the
end."""

from __future__ import annotations

import torch


class Model:
    def __init__(self, cfg: dict, device, dtype) -> None:
        f = dict(dtype=dtype, device=device)
        self.A = 4
        self.dt = torch.tensor(float(cfg["dt"]), **f)
        self.w = [float(v) for v in cfg["cost"]["w"]]
        self.goal = torch.tensor(cfg["goal"], **f)
        self.lam = float(cfg["lambda"])
        model = cfg["model"]
        self.m = torch.tensor(model["mass"], **f)
        self.J = [torch.tensor(v, **f) for v in model["inertia"]]
        self.g = torch.tensor(model["gravity"], **f)

    def _derivs(self, q, om, u):
        qw, qx, qy, qz = q.unbind(-1)
        wx, wy, wz = om.unbind(-1)
        fm = u[..., 0] / self.m
        acc = torch.stack([2.0 * (qx * qz + qw * qy) * fm, 2.0 * (qy * qz - qw * qx) * fm,
                           (1.0 - 2.0 * (qx * qx + qy * qy)) * fm - self.g], dim=-1)
        qdot = 0.5 * torch.stack([-(qx * wx + qy * wy + qz * wz), qw * wx + qy * wz - qz * wy,
                                  qw * wy + qz * wx - qx * wz, qw * wz + qx * wy - qy * wx], dim=-1)
        jx, jy, jz = self.J
        omdot = torch.stack([(u[..., 1] - (jz - jy) * wy * wz) / jx,
                             (u[..., 2] - (jx - jz) * wz * wx) / jy,
                             (u[..., 3] - (jy - jx) * wx * wy) / jz], dim=-1)
        return qdot, acc, omdot

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p, q, v, om = x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13]
        h = self.dt
        qd1, a1, wd1 = self._derivs(q, om, u)
        v_m = v + 0.5 * h * a1
        qd2, a2, wd2 = self._derivs(q + 0.5 * h * qd1, om + 0.5 * h * wd1, u)
        q_n = q + h * qd2
        q_n = q_n * torch.rsqrt(torch.sum(q_n * q_n, dim=-1, keepdim=True))
        return torch.cat([p + h * v_m, q_n, v + h * a2, om + h * wd2], dim=-1)

    def state_cost(self, x: torch.Tensor) -> torch.Tensor:
        w, g = self.w, self.goal
        d = x - g
        pos = w[0] * d[..., 0] ** 2 + w[1] * d[..., 1] ** 2 + w[2] * d[..., 2] ** 2
        tilt = 2.0 * (x[..., 4] ** 2 + x[..., 5] ** 2)
        vel = w[4] * d[..., 7] ** 2 + w[5] * d[..., 8] ** 2 + w[6] * d[..., 9] ** 2
        om = x[..., 10] ** 2 + x[..., 11] ** 2 + x[..., 12] ** 2
        return pos + w[3] * tilt + vel + w[7] * om
