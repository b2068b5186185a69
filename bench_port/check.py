"""How ``correct`` is decided: the plain reference (``bench_port.reference``)
judges what the timed path produced.

* Episodes (one robot, or every robot of a fleet). The controller's
  nominal sequence U is state that the episode keeps on the device and
  never hands out, and it amplifies float32 rounding from cycle to cycle
  (on the card the gap between the port and the reference grows several
  times a cycle once the actions leave their bounds, until the two
  sequences part), so the reference can follow an episode only from its
  start, where U is the configuration's. It runs its own controller over
  the episode's first ``cycles`` cycles at the states the program's world
  reached, and the action the program executed at each is compared with
  the reference's, in units of σ per action dimension. A robot-episode's
  gap is its largest; the run's ``action_gap`` is a high quantile
  (``quantile`` in the cell's file) over every judged robot-episode: every
  robot of ``episodes`` episodes drawn from the window. Where a few of a
  softmin's weights nearly tie, rounding moves the action far more than
  elsewhere, so the largest over a run would follow those few; a fault in
  more robot-episodes than the quantile leaves out reads at its own size.
  The world's step is judged alone on every cycle of every judged
  robot-episode: the reference steps x_c under the program's action and
  compares with x_{c+1} (``world_gap``, in state units, the largest).
* The host loop: the loop hands the controller its U, so at each sampled
  step the reference solves from the state and the sequence the loop
  handed over; the action and the shifted sequence the controller returned
  are compared in units of σ (``action_gap``, ``sequence_gap``), the
  plant's next state with the reference's step of it (``world_gap``), each
  the largest over the sampled steps.

The reference's controller computes in float64 from the float32 normals
of the stream; its worlds compute in float32, the configuration's
precision, in which the program's worlds repeat them bit for bit. Each
reading has its limit in the cell's file.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import mppi, philox, worlds

BLOCK_ROLLOUTS = 1 << 19  # rollouts of the robots the reference takes at once


def robot_seeds(noise_seed: int, R: int) -> torch.Tensor:
    """The (R,) int64 noise seeds of R robots: the seed itself for one
    robot, each robot's own for a fleet."""
    if R == 1:
        return torch.tensor([noise_seed], dtype=torch.int64)
    return philox.fleet_seeds(noise_seed, R)


def _worst(a: float, b) -> float:
    """The larger gap; a gap that is not a number is infinite."""
    b = float(b)
    return max(a, b if b == b else float("inf"))


def _sigma(cfg: dict, device) -> torch.Tensor:
    return torch.tensor(cfg["noise"], dtype=torch.float32, device=device)


def episode_gaps(cfg: dict, seeds: torch.Tensor, xs: np.ndarray, us: np.ndarray,
                 clocks: np.ndarray, first: int, device,
                 dtype=torch.float64) -> tuple[np.ndarray, float]:
    """The gaps of the robots with `seeds` (Rs,) over one stretch of
    episodes: states xs (N+1, Rs, s), actions us (N, Rs, A), each cycle's
    clock before it (N, Rs). Returns the action gaps of the `first` cycles
    (first, Rs) and the largest world gap over every cycle. The robots are
    taken in blocks of at most ``BLOCK_ROLLOUTS`` rollouts."""
    X = torch.as_tensor(xs, dtype=torch.float32, device=device)
    Ua = torch.as_tensor(us, dtype=torch.float32, device=device)
    n, Rs = min(first, Ua.shape[0]), Ua.shape[1]
    per = np.zeros((n, Rs))
    step = max(1, BLOCK_ROLLOUTS // int(cfg["samples"]))
    for b in range(0, Rs, step):
        r = slice(b, min(Rs, b + step))
        solver = mppi.Solver(cfg, seeds[r], device, dtype)
        U = solver.init_U()
        for c in range(n):
            a, U = solver.cycle(X[c, r].to(dtype), U, c)
            gap = torch.amax(torch.abs(a.float() - Ua[c, r]) / _sigma(cfg, device), dim=-1)
            per[c, r] = torch.nan_to_num(gap, nan=float("inf")).cpu().numpy()
    clock = torch.as_tensor(clocks, dtype=torch.float32, device=device)
    nxt = worlds.cycle(cfg["world"], X[:-1], Ua, clock)
    return per, _worst(0.0, torch.max(torch.abs(nxt - X[1:])))


def nearest_rank(values: np.ndarray, q: float) -> float:
    """The `q` quantile of `values` by nearest rank: the smallest value that
    at least a share q of them do not exceed."""
    v = np.sort(np.asarray(values, np.float64).ravel())
    return float(v[max(0, math.ceil(q * v.size) - 1)])


def episode_reading(check: dict, action_gaps: np.ndarray, world_gap: float) -> dict[str, float]:
    """A run's episode readings from the action gaps (cycles, robot-episodes)
    of every judged robot-episode: ``action_gap`` is the ``quantile`` (the
    cell file's) over them of each one's largest gap, since a few
    robot-episodes read far above the rest where the softmin's weights
    amplify rounding (see above); ``world_gap`` the largest world gap."""
    worst = np.max(action_gaps, axis=0)
    return {"action_gap": nearest_rank(worst, float(check["quantile"])), "world_gap": world_gap}


def hostloop_gaps(cfg: dict, noise_seed: int, records: list, device,
                  dtype=torch.float64) -> dict[str, float]:
    """The gaps of the sampled host-loop steps, each (step, x, U, action,
    shifted U, the plant's next x), arrays on the host."""
    solver = mppi.Solver(cfg, torch.tensor([noise_seed], dtype=torch.int64), device, dtype)
    sig = _sigma(cfg, device)
    gaps = {"action_gap": 0.0, "sequence_gap": 0.0, "world_gap": 0.0}
    for step, x, U, action, u_next, x_next in records:
        f = dict(dtype=dtype, device=device)
        a, Un = solver.cycle(torch.as_tensor(x, **f)[None], torch.as_tensor(U, **f)[None], step)
        a_p = torch.as_tensor(action, dtype=torch.float32, device=device)
        U_p = torch.as_tensor(u_next, dtype=torch.float32, device=device)
        for k, v in (("action_gap", torch.max(torch.abs(a[0].float() - a_p) / sig)),
                     ("sequence_gap", torch.max(torch.abs(Un[0].float() - U_p) / sig)),
                     ("world_gap", np.max(np.abs(
                         worlds.host_cycle(cfg["world"], x, action) - x_next)))):
            gaps[k] = _worst(gaps[k], v)
    return gaps


def control_episode(cfg: dict, seeds: torch.Tensor, x0: np.ndarray, n: int, t0: float, device,
                    dtype=torch.bfloat16) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference in `dtype` in the program's place: the first `n` cycles
    of an episode of its own controller and world from x0 (Rs, s); (xs, us,
    clocks (n, Rs)) as the program's histories are read."""
    w = cfg["world"]
    solver = mppi.Solver(cfg, seeds, device, dtype)
    U = solver.init_U()
    x = torch.as_tensor(x0, device=device).to(dtype)
    clock, h = np.float32(t0), np.float32(w["timestep"])
    xs, us, clocks = [x], [], []
    for c in range(n):
        a, U = solver.cycle(x, U, c)
        x = worlds.cycle(w, x, a, torch.tensor(clock, device=device))
        clocks.append(clock)
        for _ in range(worlds.steps_per_cycle(w)):
            clock = np.float32(clock + h)
        xs.append(x)
        us.append(a)
    clocks = np.repeat(np.asarray(clocks, np.float32)[:, None], x.shape[0], axis=1)
    return torch.stack(xs).float().cpu().numpy(), torch.stack(us).float().cpu().numpy(), clocks
