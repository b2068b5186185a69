"""``point_mass``: per axis (m + armature) q̈ = gear · clamp(u, ±ctrl) −
damping · q̇, RK4 at ``timestep``, a position past ±range clamped with its
velocity zeroed; ⌈period/timestep⌉ steps per control cycle. The same
arithmetic on the device (``cycle``, torch) and on the host (``host_cycle``:
NumPy float32 in the C++ plant's order), the reference's XML point mass."""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference.worlds import steps_per_cycle


def mass(w: dict) -> float:
    """Sphere of `radius` at `density`, plus the joint's armature."""
    return 4.0 / 3.0 * math.pi * w["radius"] ** 3 * w["density"] + w["armature"]


def cycle(w: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One cycle of states x (..., 2n) under actions u (..., n)."""
    n = u.shape[-1]
    m, h, lim = mass(w), w["timestep"], w["range"]
    u = torch.clamp(u, -w["ctrl-range"], w["ctrl-range"])
    q, qd = x[..., :n], x[..., n:]

    def acc(v):
        return (w["gear"] * u - w["damping"] * v) / m

    for _ in range(steps_per_cycle(w)):
        k1v = acc(qd)
        k2q, k2v = qd + 0.5 * h * k1v, acc(qd + 0.5 * h * k1v)
        k3q, k3v = qd + 0.5 * h * k2v, acc(qd + 0.5 * h * k2v)
        k4q, k4v = qd + h * k3v, acc(qd + h * k3v)
        q_new = q + (h / 6.0) * (qd + 2 * k2q + 2 * k3q + k4q)
        qd_new = qd + (h / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
        hit = torch.abs(q_new) > lim
        q, qd = torch.clamp(q_new, -lim, lim), torch.where(hit, torch.zeros_like(qd_new), qd_new)
    return torch.cat([q, qd], dim=-1)


def host_cycle(w: dict, x: np.ndarray, u: np.ndarray) -> np.ndarray:
    """:func:`cycle` in float32 scalars, in the host plant's order."""
    f = np.float32
    n = u.shape[-1]
    m = f(4.0 / 3.0 * math.pi * w["radius"] ** 3 * w["density"]) + f(w["armature"])
    h, lim, gear, damp = f(w["timestep"]), f(w["range"]), f(w["gear"]), f(w["damping"])
    ctrl = f(w["ctrl-range"])
    q, qd = x[:n].astype(f), x[n:].astype(f)
    for _ in range(steps_per_cycle(w)):
        for i in range(n):
            ui = min(max(f(u[i]), -ctrl), ctrl)

            def acc(v):
                return (gear * ui - damp * v) / m

            k1q, k1v = qd[i], acc(qd[i])
            k2q = qd[i] + f(0.5) * h * k1v
            k2v = acc(k2q)
            k3q = qd[i] + f(0.5) * h * k2v
            k3v = acc(k3q)
            k4q = qd[i] + h * k3v
            k4v = acc(k4q)
            qn = q[i] + (h / f(6.0)) * (k1q + f(2.0) * k2q + f(2.0) * k3q + k4q)
            vn = qd[i] + (h / f(6.0)) * (k1v + f(2.0) * k2v + f(2.0) * k3v + k4v)
            if qn > lim or qn < -lim:
                qn, vn = min(max(qn, -lim), lim), f(0.0)
            q[i], qd[i] = qn, vn
    return np.concatenate([q, qd])
