"""``quadrotor3d``: [F, τx, τy, τz] mixed to four rotor thrusts ("+"
layout, arm r, drag κ) clamped to [0, max-thrust], the achieved wrench
rebuilt from them, the rigid body of ``models/quadrotor3d.py`` stepped by RK4
at ``timestep`` with the quaternion renormalised after each step."""

from __future__ import annotations

import torch

from bench_port.reference.worlds import steps_per_cycle


def cycle(w: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One cycle of states x (..., 13) under commands u (..., 4)."""
    r, kap, h = w["arm"], w["kappa"], w["timestep"]
    F, tx, ty, tz = u.unbind(-1)
    qf, qx_, qy_, qz_ = F / 4.0, tx / (2.0 * r), ty / (2.0 * r), tz / (4.0 * kap)
    f = torch.clamp(torch.stack([qf - qy_ + qz_, qf + qx_ - qz_, qf + qy_ + qz_, qf - qx_ - qz_],
                                dim=-1), 0.0, w["max-thrust"])
    f1, f2, f3, f4 = f.unbind(-1)
    wrench = torch.stack([f1 + f2 + f3 + f4, r * (f2 - f4), r * (f3 - f1),
                          kap * (f1 - f2 + f3 - f4)], dim=-1)
    jx, jy, jz = w["inertia"]

    def deriv(y):
        _, q, v, om = y
        qw, qx, qy, qz = q.unbind(-1)
        wx, wy, wz = om.unbind(-1)
        fm = wrench[..., 0] / w["mass"]
        acc = torch.stack([2.0 * (qx * qz + qw * qy) * fm, 2.0 * (qy * qz - qw * qx) * fm,
                           (1.0 - 2.0 * (qx * qx + qy * qy)) * fm - w["gravity"]], dim=-1)
        qdot = 0.5 * torch.stack([-(qx * wx + qy * wy + qz * wz), qw * wx + qy * wz - qz * wy,
                                  qw * wy + qz * wx - qx * wz, qw * wz + qx * wy - qy * wx], dim=-1)
        omdot = torch.stack([(wrench[..., 1] - (jz - jy) * wy * wz) / jx,
                             (wrench[..., 2] - (jx - jz) * wz * wx) / jy,
                             (wrench[..., 3] - (jy - jx) * wx * wy) / jz], dim=-1)
        return v, qdot, acc, omdot

    y = (x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13])
    for _ in range(steps_per_cycle(w)):
        k1 = deriv(y)
        k2 = deriv(tuple(a + 0.5 * h * b for a, b in zip(y, k1)))
        k3 = deriv(tuple(a + 0.5 * h * b for a, b in zip(y, k2)))
        k4 = deriv(tuple(a + h * b for a, b in zip(y, k3)))
        p, q, v, om = (a + (h / 6.0) * (b + 2 * c + 2 * d + e)
                       for a, b, c, d, e in zip(y, k1, k2, k3, k4))
        y = (p, q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True)), v, om)
    return torch.cat(y, dim=-1)
