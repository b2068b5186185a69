"""MPPI controller (torch counterpart of ``mppi_gpu_tpu.controller``).

One solve: sample ε → roll out K trajectories over T → softmin → weighted
update ``U += Σ_k w_k ε_k`` → clamp → shift. Two backends:

* ``eager`` — plain torch on any device: ``ops.philox`` noise,
  ``ops.rollout``, ``ops.softmin``;
* ``fused`` — the hand-written CUDA solve (``ops.fused_solve``, kernels K1 +
  K2) on a CUDA device; the noise never leaves the kernel. ``solve``'s last
  update ends in K7, the solve's tail with the weights; an inner opt
  iteration and the device episode's update end in K2 with the tail (and
  the world's step) as its epilogue (``ops.combine_tail``, K2').

``auto`` picks ``fused`` on a CUDA device when the (model, cost) pair is a
fused family (``ops.families``: the point-mass LTI model with the quadratic
or the obstacle cost, the pendulum with its swing-up cost, the cart-pole
with its balance cost, the unicycle, planar quadrotor, two-link arm and 3-D
quadrotor with their waypoint, hover, reaching and hover costs, and any
family registered from user code with ``ops.families.register_family``),
and ``eager`` otherwise. The fused family's parameters are packed when the
controller's ``cost`` or ``dynamics`` is assigned (at init or later, as the
examples re-tune the cost), never per solve, and not when the cost is only
re-aimed at another goal (the goal is passed per solve), unless the family
keeps its goal in its pack (a user family without ``has_goal``). Both backends
draw the same noise stream (``ops.philox``): counter (k, t, step, it) under
the seed, so a solve is a pure function of (seed, step, it) and replayable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.ops import families
from mppi_gpu_tpu_torch.ops import fused_solve as fs
from mppi_gpu_tpu_torch.ops import philox
from mppi_gpu_tpu_torch.ops import world_step as ws
from mppi_gpu_tpu_torch.ops.combine_tail import combine_tail
from mppi_gpu_tpu_torch.ops.cost import Cost, make_cost, only_goal_differs
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs, rollout_trajectories
from mppi_gpu_tpu_torch.ops.softmin import softmin_weights
from mppi_gpu_tpu_torch.ops.solve_tail import CYCLE, ITERATE, OUTPUTS, solve_tail
from mppi_gpu_tpu_torch.ops.solve_tail import shift_action_seq  # noqa: F401 (the public name)

BACKENDS = ("auto", "eager", "fused")
# what a solve's tail computes (``ops/solve_tail``): every field of a
# SolveResult, or ITERATE's or CYCLE's part of it
FULL = OUTPUTS


class SolveInfo(NamedTuple):
    """Per-solve diagnostics (same fields as the JAX package's)."""

    costs: torch.Tensor    # (K,) per-rollout total cost S_k
    beta: torch.Tensor     # 0-dim: min_k S_k
    eta: torch.Tensor      # 0-dim: Σ_k exp(−(S_k−β)/λ)
    weights: torch.Tensor  # (K,) softmin weights
    u_seq: torch.Tensor    # (T, a) updated nominal sequence BEFORE the shift

    def cpu(self) -> "SolveInfo":
        return SolveInfo(*(v.cpu() for v in self))


class SolveResult(NamedTuple):
    action: torch.Tensor   # (a,) U_new[0], the action to execute now
    u_next: torch.Tensor   # (T, a) shifted sequence for the next solve
    info: SolveInfo


def sample_noise(
    seed: int, step: int, it: int, T: int, K: int, sigma: torch.Tensor,
    *, antithetic: bool = False, ou_beta: float = 0.0,
) -> torch.Tensor:
    """(T, K, a) ε of the port's stream for (seed, step, it) — the exact noise
    both backends consume (``ops.philox``)."""
    return philox.sample_eps(
        seed, step, it, T, K, sigma, antithetic=antithetic, ou_beta=ou_beta
    )


def _result(tail, S, beta, eta, weights) -> SolveResult:
    return SolveResult(action=tail.action, u_next=tail.u_next,
                       info=SolveInfo(costs=S, beta=beta, eta=eta, weights=weights, u_seq=tail.u_seq))


def _finish(U, dU, S, beta, eta, weights, max_a, clamp: bool, outputs=FULL,
            into: torch.Tensor | None = None) -> SolveResult:
    """Update + clamp + shift, shared by every backend (``ops/solve_tail``:
    K7 on a CUDA device), for the `outputs` asked for (of :data:`FULL`; the
    others None), the shifted sequence written into `into` when given; the
    weights are the caller's; a leading robot axis passes through."""
    tail = solve_tail(U, dU, max_a, clamp, tuple(o for o in outputs if o != "weights"), into=into)
    return _result(tail, S, beta, eta, weights)


def _finish_fused(U, dU, S, beta, eta, lambda_: float, max_a, clamp: bool, outputs=FULL,
                  into: torch.Tensor | None = None) -> SolveResult:
    """The tail of a fused solve core, as :func:`_finish`, with the softmin
    weights computed from (S, β, η) in the same launch, and only when
    `outputs` asks for them; β, η of shape () or (R,) against S of (K,) or
    (R, K)."""
    softmin = (S, beta, eta, lambda_) if "weights" in outputs else None
    tail = solve_tail(U, dU, max_a, clamp, outputs, softmin, into)
    return _result(tail, S, beta, eta, tail.weights)


def softmin_update(S: torch.Tensor, eps: torch.Tensor, lambda_: torch.Tensor | float):
    """The softmin of the costs S (K,) and the update ΔU = Σ_k w_k ε_k of the
    noise eps (T, K, a) that produced them: (SoftminResult, ΔU (T, a))."""
    sm = softmin_weights(S, lambda_)
    return sm, torch.einsum("tka,k->ta", eps, sm.weights)


def solve_from_costs(
    S: torch.Tensor,       # (K,) rollout costs
    eps: torch.Tensor,     # (T, K, a) the noise that produced them
    U: torch.Tensor,       # (T, a) nominal sequence
    lambda_: torch.Tensor | float,
    max_a: torch.Tensor,   # (a,)
    *,
    clamp: bool,
    outputs=FULL,
    into: torch.Tensor | None = None,
) -> SolveResult:
    """Softmin-weighted update + clamp + shift."""
    sm, dU = softmin_update(S, eps, lambda_)
    return _finish(U, dU, S, sm.beta, sm.eta, sm.weights, max_a, clamp, outputs, into)


def mppi_solve_deterministic(
    dyn: Dynamics, cost: Cost, x0: torch.Tensor, U: torch.Tensor, eps: torch.Tensor,
    lambda_: torch.Tensor | float, max_a: torch.Tensor, *, clamp: bool = True,
) -> SolveResult:
    """One MPPI solve with injected noise — the parity/testing mode."""
    S = rollout_costs(dyn, cost, x0, U, eps)
    return solve_from_costs(S, eps, U, lambda_, max_a, clamp=clamp)


def resolve_backend(requested: str, device: torch.device, dyn: Dynamics, cost: Cost) -> str:
    """``auto`` → ``fused`` on a CUDA device for a fused family's pair
    (``ops.families``), else ``eager``. ``fused`` anywhere but on a CUDA
    device, or for another pair, raises."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown rollout backend '{requested}'; known: {BACKENDS}")
    fusable = families.is_fusable(dyn, cost)
    if requested == "auto":
        return "fused" if device.type == "cuda" and fusable else "eager"
    if requested == "fused":
        if device.type != "cuda":
            raise ValueError(
                f"the fused backend runs the CUDA kernels and needs a CUDA device, got {device}"
            )
        if not fusable:
            raise ValueError(
                f"the fused backend covers {families.covered()}; got "
                f"{type(dyn).__name__} + {type(cost).__name__}"
            )
    return requested


class MPPIController:
    """Config-driven MPPI controller.

    Usage:
        ctrl = MPPIController(load_config("configs/point_mass2d.yaml"), device="cuda")
        U = ctrl.init_action_seq()
        action, U, info = ctrl.solve_auto(x, U, step)
    """

    def __init__(
        self,
        cfg: MPPIConfig,
        *,
        device: torch.device | str,
        rollout_backend: str = "auto",
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
    ) -> None:
        from mppi_gpu_tpu_torch.models import dynamics_for_config

        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self._cost = self._family = None  # packed once, when the cost is assigned below
        self.dynamics = dynamics if dynamics is not None else dynamics_for_config(cfg, self.device)
        cost = cost if cost is not None else make_cost(cfg, self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sigma = torch.tensor(cfg.noise, **f32)
        self.lambda_ = torch.tensor(cfg.lambda_, **f32)
        self.max_a = torch.tensor(cfg.max_a, **f32)
        self.rollout_backend = resolve_backend(rollout_backend, self.device, self.dynamics, cost)
        self.cost = cost
        # K2's epilogue finds each robot's last block by a ticket: one per
        # robot and one for the robots' world steps, zero between launches
        self._tickets = torch.zeros(2, dtype=torch.int32, device=self.device)

    @property
    def cost(self) -> Cost:
        return self._cost

    @cost.setter
    def cost(self, cost: Cost) -> None:
        """Assigning the cost re-packs the fused family from it (one small
        pack on the device, its scalars read to the host once), so the fused
        backend solves with the weights of the cost assigned last, as the
        eager one does; a solve reads no device scalar. A cost that is the
        current one re-aimed (``with_goal``: every other field the same
        object, ``ops/cost.only_goal_differs``) keeps the pack, which holds
        no goal (the solve passes ``goal_of(self.cost)``), and reads nothing
        from the device, unless the family holds its goal in the pack (a
        user family without ``has_goal``), which re-packs. On the fused
        backend a cost the family cannot fuse raises."""
        fam = self._family
        if only_goal_differs(self._cost, cost) and (fam is None or fam.has_goal):
            if fam is not None:
                self._family = dataclasses.replace(fam, cost=cost)
        else:
            self._family = self._pack(self.dynamics, cost)
        self._cost = cost

    @property
    def dynamics(self) -> Dynamics:
        return self._dynamics

    @dynamics.setter
    def dynamics(self, dynamics: Dynamics) -> None:
        """Assigning the model re-packs the fused family from it and the
        current cost (its parameters, dt and the plain version's model), as
        assigning the cost does; on the fused backend a model the family
        cannot fuse raises and changes nothing. Before the first cost is
        assigned (in ``__init__``) there is nothing to pack."""
        if self._cost is not None:
            self._family = self._pack(dynamics, self._cost)
        self._dynamics = dynamics

    def _pack(self, dyn: Dynamics, cost: Cost) -> families.FusedFamily | None:
        """The fused family of (dyn, cost) packed on the device, None for a
        pair no family fuses; raises for such a pair on the fused backend."""
        fusable = families.is_fusable(dyn, cost)
        if self.rollout_backend == "fused" and not fusable:
            raise ValueError(
                f"the fused backend covers {families.covered()}; got "
                f"{type(dyn).__name__} + {type(cost).__name__}"
            )
        return families.family_for(dyn, cost, self.sigma) if fusable else None

    # -- state helpers -----------------------------------------------------
    def init_action_seq(self) -> torch.Tensor:
        """U[t] = init-act for all t."""
        u0 = torch.tensor(self.cfg.init_act, dtype=torch.float32, device=self.device)
        return u0.expand(self.cfg.horizon, -1).contiguous()

    # -- solves ------------------------------------------------------------
    def _fused(self, x, U, seed: int, step, it: int, eps=None, outputs=FULL,
               into=None, advance=None) -> SolveResult:
        """The fused kernels (Philox mode, or injected-ε mode with `eps`):
        K1, then for `outputs` = FULL K2 and the tail with the weights
        (:func:`_finish_fused`: K7 on the card), else K2 with the tail and,
        with `advance`, the world's step as its epilogue
        (``ops.combine_tail``: one launch of K2' on the card)."""
        cfg = self.cfg
        K, anti = (cfg.samples, cfg.antithetic) if eps is None else (eps.shape[1], False)
        args = (self._family, x, U, families.call_goal(self._family, self.cost), cfg.lambda_, K,
                seed, step, it, anti, cfg.noise_beta)
        if outputs == FULL:
            S, beta, eta, dU = fs.family_fused_solve(*args, eps=eps)
            res = _finish_fused(U, dU, S, beta, eta, cfg.lambda_, self.max_a, cfg.clamp_action,
                                outputs, into)
            ws.advance_after(advance, res.action, step)
            return res
        S, partials = fs.family_solve_partials(*args, eps)
        beta, eta, _, tail = combine_tail(partials, cfg.lambda_, U, self.max_a, cfg.clamp_action,
                                          outputs, self._tickets, into, step, advance)
        return _result(tail, S, beta, eta, None)

    def _solve_once(self, x: torch.Tensor, U: torch.Tensor, seed: int, step, it: int,
                    outputs=FULL, into=None, advance=None) -> SolveResult:
        """One update of U, its tail computing `outputs` only (the shifted
        sequence into `into` when given), then with `advance` the world's
        step under its action (``ops.world_step.Advance``)."""
        if self.rollout_backend == "fused":
            return self._fused(x, U, seed, step, it, outputs=outputs, into=into, advance=advance)
        cfg = self.cfg
        eps = self._eps(seed, step, it)
        S = rollout_costs(self.dynamics, self.cost, x, U, eps)
        res = solve_from_costs(S, eps, U, self.lambda_, self.max_a, clamp=cfg.clamp_action,
                               outputs=outputs, into=into)
        ws.advance_after(advance, res.action, step)
        return res

    def _eps(self, seed, step, it: int) -> torch.Tensor:
        cfg = self.cfg
        return sample_noise(
            seed, step, it, cfg.horizon, cfg.samples, self.sigma,
            antithetic=cfg.antithetic, ou_beta=cfg.noise_beta,
        )

    def _iterate(self, x: torch.Tensor, U: torch.Tensor, seed: int, step) -> torch.Tensor:
        """Iterated MPPI: the first opt_iters − 1 updates of the nominal
        sequence (fresh noise per iteration through the counter's `it`)."""
        for j in range(self.cfg.opt_iters - 1):
            U = self._solve_once(x, U, seed, step, j, ITERATE).info.u_seq
        return U

    def solve_in_place(self, x: torch.Tensor, U: torch.Tensor, seed: int, step,
                       advance: ws.Advance | None = None) -> torch.Tensor:
        """The device episode's solve (``runner.EpisodeCycle``): :meth:`solve`
        op by op (every opt iteration), computing only what the cycle reads,
        as XLA's dead-code elimination leaves the JAX package's jitted
        episode: returns the action, and writes the shifted sequence over U
        in place; neither the weights over K nor an updated sequence beside
        U are computed. With `advance`, the world's step under the action at
        the counter `step` follows (``ops.world_step.Advance``): on the
        fused backend on a CUDA device inside the last update's K2' where
        the world has a K6 body, else after the solve."""
        U_last = self._iterate(x, U, seed, step)
        return self._solve_once(x, U_last, seed, step, self.cfg.opt_iters - 1, CYCLE, U,
                                advance).action

    def _solve_identity(self) -> tuple:
        """The identity of every object whose tensors a solve reads, the
        cost aside (the fused pack's parameters, the model, σ, λ and the
        clamp; reassigning ``dynamics`` changes it, re-aiming the cost at
        another goal does not), the config and the backend: part of a graph's
        key (``graphs.solve_key``, ``runner.cycle_key``)."""
        params = None if self._family is None else self._family.params
        return (id(params), id(self.dynamics), id(self.sigma), id(self.lambda_), id(self.max_a),
                self.cfg, self.rollout_backend)

    def solve(self, x: torch.Tensor, U: torch.Tensor, seed: int, step=0, *,
              capture: bool = True) -> SolveResult:
        """One control step for noise stream (seed, step). With
        ``opt_iters > 1`` the nominal sequence is updated that many times
        (iteration j draws counter word it = j) before U[0] is executed and
        the shift happens once; ``SolveInfo`` is the final iteration's.
        `step` is an int or a 0-dim int64 tensor on the controller's device
        (the same noise bit for bit); either way the solve reads nothing
        from the device, so a CUDA graph can capture it and replay it with
        the step its counter holds.

        On a CUDA device the solve is a CUDA graph, captured at the first
        call and again when its key changes (``graphs.SolveGraph``: a new
        cost or model, shape or solo seed; not a goal re-aim), and replayed
        (the counterpart of the JAX package's jitted solve). ``capture=False``
        launches it op by op, the graph's yardstick (the same result bit for
        bit); so does a call made while the stream captures another graph
        (``runner.EpisodeCycle``), which then records those launches."""
        from mppi_gpu_tpu_torch import graphs

        if graphs.replays(self.device, capture):
            return graphs.graphed_solve(self, x, U, seed, step)
        x = x.to(self.device, torch.float32)
        U = self._iterate(x, U, seed, step)
        return self._solve_once(x, U, seed, step, self.cfg.opt_iters - 1)

    def solve_auto(self, x: torch.Tensor, U: torch.Tensor, step, *,
                   capture: bool = True) -> SolveResult:
        """:meth:`solve` under the config's seed."""
        return self.solve(x, U, self.cfg.seed, step, capture=capture)

    def solve_with_eps(self, x: torch.Tensor, U: torch.Tensor, eps: torch.Tensor) -> SolveResult:
        """Deterministic solve with injected noise (parity/testing); runs the
        fused kernels in their injected-ε mode on the fused backend."""
        x = x.to(self.device, torch.float32)
        if self.rollout_backend == "fused":
            return self._fused(x, U, 0, 0, 0, eps=eps)
        return mppi_solve_deterministic(
            self.dynamics, self.cost, x, U, eps, self.lambda_, self.max_a,
            clamp=self.cfg.clamp_action,
        )

    def solve_debug(
        self, x: torch.Tensor, U: torch.Tensor, step: int
    ) -> tuple[SolveResult, torch.Tensor, torch.Tensor]:
        """:meth:`solve_auto` that also returns the noise it consumed and the
        rollout trajectories: ``(result, eps (T, K, a), xs (T+1, K, s))`` —
        the data of the per-step debug dump. Under iterated MPPI the dump
        documents the final iteration. On the fused backend the solve runs
        through the kernels and K3 (``noise_dump``) writes the same stream;
        the trajectories come from the eager rollout of that ε."""
        cfg, seed = self.cfg, self.cfg.seed
        x = x.to(self.device, torch.float32)
        U = self._iterate(x, U, seed, step)
        it = cfg.opt_iters - 1
        if self.rollout_backend == "fused":
            res = self._solve_once(x, U, seed, step, it)
            eps = fs.noise_dump(
                self.sigma, cfg.horizon, cfg.samples, seed, step, it,
                cfg.antithetic, cfg.noise_beta,
            )
            _, xs = rollout_trajectories(self.dynamics, self.cost, x, U, eps)
            return res, eps, xs
        eps = self._eps(seed, step, it)
        S, xs = rollout_trajectories(self.dynamics, self.cost, x, U, eps)
        return solve_from_costs(S, eps, U, self.lambda_, self.max_a, clamp=cfg.clamp_action), eps, xs


def mppi_solve(
    dyn: Dynamics, cost: Cost, x0: torch.Tensor, U: torch.Tensor, *, seed: int,
    step: int, sigma: torch.Tensor, lambda_: float, max_a: torch.Tensor, K: int,
    clamp: bool = True, antithetic: bool = False, ou_beta: float = 0.0,
    opt_iters: int = 1,
) -> SolveResult:
    """Functional eager solve (the JAX package's ``mppi_solve`` with the scan
    backend): ``opt_iters`` updates, iteration j on counter word it = j, the
    last one returned (before which nothing is shifted)."""
    T = U.shape[0]
    for j in range(opt_iters):
        eps = sample_noise(seed, step, j, T, K, sigma, antithetic=antithetic, ou_beta=ou_beta)
        res = mppi_solve_deterministic(dyn, cost, x0, U, eps, lambda_, max_a, clamp=clamp)
        U = res.info.u_seq
    return res
