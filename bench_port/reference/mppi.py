"""One MPPI control cycle, plainly, for Rs robots at once:

for each of the ``opt-iters`` iterations j: ε = σ · normals(seed, step, j);
K rollouts of T steps from x under U + ε; S_k = Σ_t cost + final cost;
β = min S, e_k = exp(−(S_k − β)/λ), w = e/Σe, ΔU = Σ_k w_k ε_k;
U ← clamp(U + ΔU, ±max-a). The cycle's action is U[0] of the last
iteration, and the next cycle starts from U shifted by one step, its last
action repeated.
"""

from __future__ import annotations

import torch

from bench_port.reference import philox
from bench_port.reference.models import model


class Solver:
    """The cycle of configuration `cfg` (a parsed configuration file) for
    robots whose int64 seeds are `seeds` (Rs,), in `dtype` on `device`."""

    def __init__(self, cfg: dict, seeds: torch.Tensor, device, dtype=torch.float32) -> None:
        f = dict(dtype=dtype, device=device)
        self.cfg, self.dtype = cfg, dtype
        self.model = model(cfg, device, dtype)
        self.seeds = seeds.to(device)
        # robots that share a seed (the episodes of one robot) share their draws
        self.unique, self.inverse = torch.unique(self.seeds, return_inverse=True)
        self.T, self.K, self.A = int(cfg["horizon"]), int(cfg["samples"]), self.model.A
        self.iters = int(cfg.get("opt-iters", 1))
        self.sigma = torch.tensor(cfg["noise"], **f)
        self.max_a = torch.tensor(cfg["max-a"], **f)
        self.lam = float(cfg["lambda"])

    def init_U(self) -> torch.Tensor:
        U = torch.tensor(self.cfg["init-act"], dtype=self.dtype, device=self.sigma.device)
        return U.expand(self.seeds.shape[0], self.T, self.A).contiguous()

    def normals(self, step, it: int) -> torch.Tensor:
        """(Rs, T, K, A) standard normals of every robot at `step`, `it`."""
        n = philox.normals(self.unique, step, it, self.T, self.K, self.A, self.dtype)
        if n.shape[0] == 1:
            return n.expand(self.seeds.shape[0], *n.shape[1:])
        return n[self.inverse]

    def update(self, x: torch.Tensor, U: torch.Tensor, step, it: int) -> torch.Tensor:
        """U + ΔU clamped, for states x (Rs, s) and sequences U (Rs, T, A)."""
        eps = self.sigma * self.normals(step, it)
        m = self.model
        xk = x[:, None, :].expand(x.shape[0], self.K, x.shape[1])
        costs = []
        for t in range(self.T):
            u = U[:, t, None, :]
            xk = m.step(xk, u + eps[:, t])
            costs.append(self.lam * torch.sum(u * eps[:, t], dim=-1) + m.state_cost(xk))
        S = torch.sum(torch.stack(costs), dim=0) + m.state_cost(xk)
        beta = torch.amin(S, dim=1, keepdim=True)
        e = torch.exp(-(S - beta) / self.lam)
        w = e / torch.sum(e, dim=1, keepdim=True)
        dU = torch.einsum("rtka,rk->rta", eps, w)
        return torch.clamp(U + dU, -self.max_a, self.max_a)

    def cycle(self, x: torch.Tensor, U: torch.Tensor, step) -> tuple[torch.Tensor, torch.Tensor]:
        """(action (Rs, A), the next cycle's U) at control step `step`."""
        for it in range(self.iters):
            U = self.update(x, U, step, it)
        return U[:, 0], torch.cat([U[:, 1:], U[:, -1:]], dim=1)
