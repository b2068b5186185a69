"""Batched multi-robot MPPI: one call solves R independent control problems
(torch counterpart of ``mppi_gpu_tpu.batched``).

Each robot has its own state, nominal sequence, seed and, for a cost with a
goal (every family's but the pendulum's and the cart-pole's; the obstacle
cost's is its quadratic base's, ``ops/cost.goal_of``), goal (R, s);
the dynamics, the cost's weights, σ, λ, K and T are shared. A fleet of
pendulums or cart-poles, whose costs aim at a built-in target, takes no
goals (``goals=`` raises ``TypeError``), nor does a fleet of a family
registered from user code that keeps its goal in its pack
(``ops.families.call_goal``): its robots share that goal.
Two backends:

* ``fused`` — one launch of K1 and one of K2 for the whole fleet
  (``ops.fused_solve.fleet_family_fused_solve``): the robot is a grid axis of the
  kernels, as it is of the TPU's fleet kernels (``pallas_fleet_solve_core``);
* ``eager`` — the single-robot plain solve, robot by robot (the CPU and the
  tests).

Robot r's solve is the single-robot solve under its seed and goal, bit for
bit on the eager backend and on the fused one (the fleet's decomposability
invariant, ``mppi_gpu_tpu/batched.py:92-103``): its noise is the port's
stream under ``seeds[r]`` (``ops.philox.fleet_seeds``), counter
(k, t, step, it). On the fused backend that holds at one block width: a
fleet whose R·K passes ``ops.fused_solve.block_width``'s crossover runs K1's
per-rollout body where one robot runs the slab body, and then its S and β
are still the single-robot solve's bit for bit, its ΔU to rounding. Every
slice of the fleet (``_solve_robots``) runs the whole fleet's width.
"""

from __future__ import annotations

import torch

from mppi_gpu_tpu_torch.config import MPPIConfig
from mppi_gpu_tpu_torch.controller import (
    FULL,
    MPPIController,
    SolveResult,
    _finish,
    _finish_fused,
    _result,
    softmin_update,
)
from mppi_gpu_tpu_torch.models.base import Dynamics
from mppi_gpu_tpu_torch.ops import families, philox
from mppi_gpu_tpu_torch.ops import fused_solve as fs
from mppi_gpu_tpu_torch.ops import world_step as ws
from mppi_gpu_tpu_torch.ops.combine_tail import combine_tail
from mppi_gpu_tpu_torch.ops.cost import Cost, batch_goals, has_goal, with_goal
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs


class BatchedMPPIController(MPPIController):
    """Solves R problems per call: states (R, s), sequences (R, T, a), seeds
    (R,) int64. Every leaf of the returned ``SolveResult`` carries a leading
    R axis: action (R, a), u_next (R, T, a), costs (R, K), beta and eta (R,),
    weights (R, K), u_seq (R, T, a).

    Usage:
        fleet = BatchedMPPIController(cfg, 8, goals=goals, device="cuda")
        Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
        res = fleet.solve_batch(xs, Us, seeds, step)
    """

    def __init__(
        self,
        cfg: MPPIConfig,
        n_robots: int,
        *,
        device: torch.device | str,
        goals: torch.Tensor | None = None,  # (R, s) per-robot goals
        rollout_backend: str = "auto",
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
    ) -> None:
        if n_robots < 1:
            raise ValueError(f"a fleet has n_robots >= 1, got {n_robots}")
        super().__init__(
            cfg, device=device, rollout_backend=rollout_backend, dynamics=dynamics, cost=cost
        )
        self.n_robots = n_robots
        self._tickets = torch.zeros(n_robots + 1, dtype=torch.int32, device=self.device)
        # a cost with a goal carries one goal row per robot, shared ones
        # repeated: the fused kernels read robot r's row (a family that
        # keeps its goal in its pack has none to batch)
        goal = families.call_goal(self._family, self.cost)
        if goals is not None and goal is None and has_goal(self.cost):
            raise TypeError(f"the {self._family.name} family keeps its goal in its pack: "
                            "per-robot goals do not apply")
        if goals is None and goal is not None:
            goals = goal if goal.dim() == 2 else goal.expand(n_robots, -1)
        if goals is not None:
            goals = torch.as_tensor(goals, dtype=torch.float32, device=self.device)
            self.cost = batch_goals(self.cost, goals.contiguous(), n_robots)

    # -- batched state helpers --------------------------------------------
    def init_action_seqs(self) -> torch.Tensor:
        """(R, T, a): every robot starts from U[t] = init-act."""
        return self.init_action_seq().expand(self.n_robots, -1, -1).contiguous()

    def init_seeds(self) -> torch.Tensor:
        """(R,) int64 per-robot seeds under the config's seed, on the
        controller's device (``ops.philox.fleet_seeds``)."""
        return philox.fleet_seeds(self.cfg.seed, self.n_robots).to(self.device)

    def _seeds(self, seeds) -> torch.Tensor:
        seeds = torch.as_tensor(seeds, dtype=torch.int64, device=self.device)
        if tuple(seeds.shape) != (self.n_robots,):
            raise ValueError(
                f"a fleet solve takes ({self.n_robots},) per-robot seeds (init_seeds()), "
                f"got shape {tuple(seeds.shape)}"
            )
        return seeds

    def _robot_cost(self, r: int) -> Cost:
        """Robot r's single-robot cost (its own goal)."""
        goal = families.call_goal(self._family, self.cost)
        return self.cost if goal is None else with_goal(self.cost, goal[r])

    # -- solves ------------------------------------------------------------
    def _solve_robots(self, xs, Us, seeds, step, it: int, robots: range,
                      eps=None, outputs=FULL, into=None, advance=None) -> SolveResult:
        """One update of the fleet's robots `robots`, whose rows of xs, Us,
        seeds (and of eps (R, T, K, a) in the injected-ε mode) are given: on
        the fused backend one launch of K1 and one of K2, on the eager one
        the rollouts and the softmin robot by robot; then one tail for the
        fleet, computing `outputs` only (the shifted sequences into `into`
        when given), then with `advance` the world's step (the whole fleet's);
        on the fused backend a tail without the weights is K2's epilogue
        (K2', ``ops.combine_tail``), as in ``MPPIController._fused``."""
        cfg = self.cfg
        goals = families.call_goal(self._family, self.cost)
        if self.rollout_backend == "fused":
            K, anti = (cfg.samples, cfg.antithetic) if eps is None else (eps.shape[2], False)
            args = (self._family, xs, Us, None if goals is None else goals[robots.start:robots.stop],
                    cfg.lambda_, K, seeds, step, it, anti, cfg.noise_beta)
            if outputs != FULL:
                S, partials = fs.fleet_family_solve_partials(*args, eps, self.n_robots)
                beta, eta, _, tail = combine_tail(
                    partials, cfg.lambda_, Us, self.max_a, cfg.clamp_action, outputs,
                    self._tickets[:len(robots) + 1], into, step, advance)
                return _result(tail, S, beta, eta, None)
            S, beta, eta, dU = fs.fleet_family_fused_solve(*args, eps=eps, n_robots=self.n_robots)
            res = _finish_fused(Us, dU, S, beta, eta, cfg.lambda_, self.max_a, cfg.clamp_action,
                                outputs, into)
            ws.advance_after(advance, res.action, step)
            return res
        # the seeds stay on the device: a solve reads nothing from it
        seed_list = seeds.unbind(0) if eps is None else [0] * len(robots)
        rows = []
        for i, r in enumerate(robots):
            e = self._eps(seed_list[i], step, it) if eps is None else eps[i]
            S = rollout_costs(self.dynamics, self._robot_cost(r), xs[i], Us[i], e)
            sm, dU = softmin_update(S, e, self.lambda_)
            rows.append((S, sm.beta, sm.eta, sm.weights, dU))
        S, beta, eta, weights, dU = (torch.stack(v) for v in zip(*rows))
        res = _finish(Us, dU, S, beta, eta, weights, self.max_a, cfg.clamp_action, outputs, into)
        ws.advance_after(advance, res.action, step)
        return res

    def _solve_once(self, xs, Us, seeds, step, it: int, outputs=FULL, into=None,
                    advance=None) -> SolveResult:
        return self._solve_robots(xs, Us, seeds, step, it, range(self.n_robots), outputs=outputs,
                                  into=into, advance=advance)

    def solve(self, xs: torch.Tensor, Us: torch.Tensor, seeds, step=0, *,
              capture: bool = True) -> SolveResult:
        """One MPPI solve per robot for noise streams (seeds[r], step), with
        ``opt_iters`` updates (iteration j on counter word it = j) as in
        :meth:`MPPIController.solve`, `step` an int or a 0-dim int64 tensor
        on the device, and nothing read from the device; on a CUDA device a
        replayed graph unless ``capture=False``, the seeds and the goals among
        its inputs. On the fused backend every iteration is one launch of K1
        and one of K2, whatever R is."""
        return super().solve(xs, Us, self._seeds(seeds), step, capture=capture)

    solve_batch = solve

    def solve_batch_auto(self, xs: torch.Tensor, Us: torch.Tensor, seeds, step) -> SolveResult:
        """:meth:`solve_batch` at control step `step` (the JAX fleet folds
        the step into its keys; here it is the counter word)."""
        return self.solve(xs, Us, seeds, step)

    def solve_with_eps(self, xs: torch.Tensor, Us: torch.Tensor, eps: torch.Tensor) -> SolveResult:
        """Deterministic fleet solve with injected noise eps (R, T, K, a)
        (parity/testing); runs the fleet kernels in their injected-ε mode on
        the fused backend."""
        xs = xs.to(self.device, torch.float32)
        return self._solve_robots(xs, Us, 0, 0, 0, range(self.n_robots), eps=eps)

    solve_batch_with_eps = solve_with_eps

    def solve_debug(self, *args, **kwargs):
        raise NotImplementedError(
            "per-step debug dumps cover one robot; run MPPIController.solve_debug "
            "with a robot's seed and goal"
        )
