"""The fused MPPI solve: wrappers of the CUDA kernels in
``csrc/mppi_solve.cu`` (K1's and K4's bodies in ``csrc/mppi_solve.cuh``)
and their plain versions.

* :func:`fleet_family_solve_partials` (K1) — for each of R robots, rollout,
  cost and per-block softmin partials ``(β_b, η_b, ΔŨ_b)`` over blocks of
  :func:`block_width` rollouts, for one fused family (``ops/families.py``: the
  point-mass LTI model with the quadratic and the obstacle cost, and the
  pendulum, cart-pole, unicycle, planar-quadrotor, two-link-arm and 3-D
  quadrotor models with their costs, or a family registered from user
  code, whose K1 and K4 come from a library built on its own struct,
  ``ops/_build.load_family_library``, through the same wrappers);
* :func:`fleet_softmin_combine` (K2) — each robot's associative fold of its
  partials into ``β``, ``η`` and ``ΔU``;
* :func:`fleet_family_fused_solve` — K1 then K2, the fleet controller's
  ``fused`` backend;
* :func:`family_solve_partials`, :func:`softmin_combine`,
  :func:`family_fused_solve` — the single-robot solve: the R = 1 launch of
  the same kernels;
* :func:`noise_dump` (K3) — the ε stream K1 consumed, for the debug dump and
  the replay check; its plain version is ``ops/philox.py``;
* :func:`fused_rollout_costs`, :func:`fleet_rollout_costs` (K4) — the
  costs-only sweep: K1's first pass alone, S (K,) or (R, K) with no softmin
  and no update. It is the floor of a solve (the counterpart of the TPU's
  ``pallas_rollout_costs`` / ``pallas_planar_rollout_costs`` that
  ``bench.bench_floor`` times); no controller launches it. Its S is K1's S
  for the same inputs, bit for bit.
* :func:`weighted_update` (K5) — ΔU = Σ_k w_k ε_k for given normalized
  weights w, ε regenerated in the kernel (K5's per-block sums folded by K2
  without the division by η): the update of the two-kernel sharded solve
  (``parallel/sharded.py``); its plain version is
  :func:`weighted_update_reference`, and :func:`weighted_update_partials`
  is the plain twin of K5's rows (:data:`DRAW_GROUP` draws each, the OU
  filter run on the row's sums).

The LTI functions :func:`lti_solve_partials`, :func:`fused_solve`,
:func:`fleet_solve_partials` and :func:`fleet_fused_solve` take the
point-mass problem as tensors (σ, Σ⁻¹, w, goal, λ, dt) and run the same
kernels on its family (:func:`lti_family`, built per call).

Each wrapper launches its kernel when its inputs lie on a CUDA device, on
that device and torch's current stream there (:func:`_launch`, whatever
device the calling thread had selected), through one launcher per kernel
(K1's serves K4 too), which counts the
launch under the kernel's name (:func:`launch_counts`; K1's and K4's also
by family, :func:`family_launch_counts`). A launch made while the stream
captures a CUDA graph runs nothing and counts nothing; the graph's replays
run it, and only a trace sees those. On CPU tensors it runs the plain
version: for K1 the family's eager model and cost through
``ops/rollout.rollout_costs`` and the same per-block partials, for the fleet
robot by robot. Any other placement, dtype, shape or layout raises. There
is no fallback from the device to the plain version.

K1 and K4 have two bodies with the same S bit for bit: the per-rollout body
(:data:`BLOCK` rollouts per block), which fills the card at large R·K, and
the slab body (:data:`SLAB_WIDTH` rollouts per block, the noise drawn in
parallel over the horizon into shared memory), for the main path's K.
:func:`block_width` picks one from the shapes alone; the partials have
ceil(K / width) rows, and the plain :func:`block_partials` takes the same
width. ΔU at two widths differs by rounding only. A body that fails to
build or launch raises: nothing falls back to the other body.

Noise: ``eps=None`` is the Philox mode (production): ε is generated in the
kernel from (seed, step, it), robot r under its own seed. K1's and K4's
wrappers take the control step as an int, passed by value, or as a 0-dim
int64 tensor on the inputs' device, whose address K1 reads the step from
(the S of both forms is the same bit for bit): a captured CUDA graph replays
the step its counter holds (``runner.run_episode_jit``). The single-robot
wrappers take a draw offset ``k0`` (counter word 0 = k0 + draw index, 0 on
one GPU) with which a rank of the sharded solve draws its part of the
stream. ``eps`` given is the injected-ε mode for parity tests: a (T, K, A)
tensor, (R, T, K, A) for the fleet, is read instead.
"""

from __future__ import annotations

import math

import torch

from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.ops import philox
from mppi_gpu_tpu_torch.ops.cost import QuadraticCost
from mppi_gpu_tpu_torch.ops.families import FAMILY_ID, FAMILY_NAMES, MAX_A, FusedFamily
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs

BLOCK = 128          # rollouts per block of K1's per-rollout body (kBlock)
SLAB_WIDTH = 32      # rollouts per block of K1's slab body (kSlabRollouts)
DRAW_GROUP = 64      # draws per block of K3 and K5, one partial row of K5 (kGroup)
_SLAB_CHUNK = 7      # horizon steps per stage of the slab body's pipeline (kChunk)
# R·K up to which K1 and K4 take the slab body, by family: beyond it the
# per-rollout body's blocks fill the card, and the slab body, two blocks per
# SM at T=200, cannot hide its rollout warp's latency; the longer the
# family's step, the sooner. Each is the largest R·K of the sweep {1024,
# 3000, 10⁴, 2·10⁴, 3·10⁴, 5·10⁴, 10⁵} at T=200 up to which the slab body's
# device time was at most the per-rollout body's for K1 and at most 5 %
# above it for K4, the least over a family's instances (NVIDIA H100 80GB
# HBM3, 700 W; chip_smoke.body_times; the table in PERF.md §6)
SLAB_MAX_ROLLOUTS = {
    "lti": 30_000, "lti-obstacle": 10_000, "pendulum": 20_000, "cartpole": 10_000,
    "unicycle": 20_000, "quadrotor": 10_000, "arm": 10_000, "quadrotor3d": 10_000,
}
MAX_ROBOTS = 65535   # K1's grid axis y is the robot (kMaxRobots)
_SMEM_BYTES = 232448 - 1024  # per-block shared memory on Hopper, less static use
_COMBINE_SMEM_FLOATS = 8 * 32  # K2's per-warp column sums (kCombineWarps · kCombineCols)

# launches of each CUDA kernel of csrc/mppi_solve.cu, counted by the function
# that launches it, where it launches; K1's and K4's also by family and by
# body (block width)
_LAUNCHES = dict.fromkeys(
    ("solve_partials", "softmin_combine", "noise_dump", "rollout_costs", "weighted_update"), 0)
_FAMILY_LAUNCHES = {k: dict.fromkeys(FAMILY_NAMES, 0) for k in ("solve_partials", "rollout_costs")}
_WIDTH_LAUNCHES = {k: dict.fromkeys((SLAB_WIDTH, BLOCK), 0)
                   for k in ("solve_partials", "rollout_costs")}


def _noise_words(seed: int, step: int, it: int) -> tuple[int, int, int, int]:
    seed &= (1 << 64) - 1
    return seed & 0xFFFFFFFF, seed >> 32, step & 0xFFFFFFFF, it & 0xFFFFFFFF


def _ou_c(ou_beta: float) -> float:
    return (1.0 - ou_beta**2) ** 0.5


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if every tensor is on
    the CPU; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs are spread over devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the fused solve runs on CUDA or CPU tensors, got {dev}")
    return dev.type == "cuda"


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_problem(T: int, A: int, K: int, antithetic: bool) -> None:
    if not 1 <= A <= MAX_A:
        raise ValueError(f"the fused solve supports 1 <= A <= {MAX_A}, got A={A}")
    if K < 1 or T < 1:
        raise ValueError(f"need K >= 1 and T >= 1, got K={K}, T={T}")
    if antithetic and K % 2:
        raise ValueError(f"antithetic sampling needs an even K, got {K}")


def _check_fleet(R: int) -> None:
    if not 1 <= R <= MAX_ROBOTS:
        raise ValueError(f"the fused solve takes 1 <= R <= {MAX_ROBOTS} robots, got R={R}")


def _step_tensors(step) -> tuple[torch.Tensor, ...]:
    """`step` as the tensors a wrapper checks the placement of: () for an
    int, (step,) for a 0-dim int64 tensor; anything else raises."""
    if not isinstance(step, torch.Tensor):
        return ()
    if step.dtype != torch.int64 or step.dim() != 0:
        raise TypeError(f"a step tensor is 0-dim int64, got {step.dtype} of shape {tuple(step.shape)}")
    return (step,)


def _check_seeds(seeds, R: int) -> None:
    """`seeds` is one int shared by every robot, or an (R,) int64 tensor."""
    if not isinstance(seeds, torch.Tensor):
        return
    if seeds.dtype != torch.int64:
        raise TypeError(f"seeds must be int64, got {seeds.dtype}")
    if tuple(seeds.shape) != (R,) or not seeds.is_contiguous():
        raise ValueError(f"seeds must be a contiguous ({R},) tensor, got {tuple(seeds.shape)}")


def _robot_seeds(seeds, R: int) -> list[int]:
    return seeds.tolist() if isinstance(seeds, torch.Tensor) else [int(seeds)] * R


def _launch(kernel: str, entry, device: torch.device, *args) -> bool:
    """Call the C entry `entry` on `args` and torch's current stream on
    `device`, the device of the kernel's tensors, with the CUDA runtime's
    current device set to it: ``<<<>>>`` launches there, whatever device the
    calling thread had selected. Raises if `kernel` failed to launch.
    Returns whether the kernel ran: False when the stream was capturing a
    CUDA graph, which only records the launch."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
        captured = torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t {err}")
    return not captured


# --------------------------------------------------------------------------
# K1: rollout + cost + per-block softmin partials


def lti_family(sigma, inv_s, w, dt: float, lam_cost: float) -> FusedFamily:
    """The point-mass LTI family with the quadratic cost of weights `w`
    (2A,), Σ⁻¹ `inv_s` (A,), σ (A,), dt and λ, its parameters packed on σ's
    device (the goal is passed per call)."""
    A = sigma.shape[0] if sigma.dim() == 1 else -1
    f32 = dict(dtype=torch.float32, device=sigma.device)
    return FusedFamily(
        name="lti", fid=FAMILY_ID["lti"], state_dim=2 * A, action_dim=A,
        dynamics=PointMassLTI(torch.tensor(dt, **f32), A),
        cost=QuadraticCost(w, None, torch.tensor(lam_cost, **f32), inv_s),
        sigma=sigma, params=torch.cat([sigma.reshape(-1), inv_s.reshape(-1), w.reshape(-1)]),
        dt=float(dt), lam_cost=float(lam_cost),
    )


def _check_family(fam: FusedFamily, T: int, A: int, K: int, antithetic: bool) -> None:
    _check_problem(T, A, K, antithetic)
    _check("sigma", fam.sigma, (A,))
    if fam.action_dim != A:
        raise ValueError(f"the {fam.name} family has A={fam.action_dim}, the sequence A={A}")
    _check("params", fam.params, (fam.n_params,))


def _check_goal(fam: FusedFamily, goal) -> None:
    """A goal (of the state's length, checked by the caller) is passed
    exactly when the family's cost has one (``ops/cost.goal_of``)."""
    if goal is not None and not fam.has_goal:
        raise TypeError(f"the {fam.name} family's cost has no goal (its target is built in)")
    if goal is None and fam.has_goal:
        raise ValueError(f"the {fam.name} family's cost aims at a goal: pass one per robot")


def _solo_on_cuda(fam: FusedFamily, x0, U, goal, K: int, antithetic: bool, eps, step=0) -> bool:
    """Check one robot's inputs (x0 (S,), U (T, A), goal (S,) for a family
    with a goal, eps (T, K, A) or None, the step); True if they lie on a CUDA
    device."""
    T, A = U.shape if U.dim() == 2 else (-1, -1)
    _check_family(fam, T, A, K, antithetic)
    _check_goal(fam, goal)
    S_dim = fam.state_dim
    for name, t, shape in (
        ("x0", x0, (S_dim,)), ("U", U, (T, A)),
    ) + ((("goal", goal, (S_dim,)),) if fam.has_goal else ()) + (
        (("eps", eps, (T, K, A)),) if eps is not None else ()
    ):
        _check(name, t, shape)
    return _on_cuda(*(t for t in (x0, U, fam.params, goal, eps) if t is not None),
                    *_step_tensors(step))


def _fleet_on_cuda(fam: FusedFamily, xs, Us, goals, K: int, seeds, antithetic: bool, eps,
                   step=0) -> bool:
    """Check a fleet's inputs (xs (R, S), Us (R, T, A), goals (R, S) for a
    family with a goal, seeds, eps (R, T, K, A) or None, the step); True if
    they lie on a CUDA device."""
    if Us.dim() != 3:
        raise ValueError(f"Us must be (R, T, A), got {tuple(Us.shape)}")
    R, T, A = Us.shape
    _check_fleet(R)
    _check_family(fam, T, A, K, antithetic)
    _check_goal(fam, goals)
    S_dim = fam.state_dim
    for name, t, shape in (
        ("xs", xs, (R, S_dim)), ("Us", Us, (R, T, A)),
    ) + ((("goals", goals, (R, S_dim)),) if fam.has_goal else ()) + (
        (("eps", eps, (R, T, K, A)),) if eps is not None else ()
    ):
        _check(name, t, shape)
    _check_seeds(seeds, R)
    per_robot = seeds if isinstance(seeds, torch.Tensor) else None
    return _on_cuda(*(t for t in (xs, Us, fam.params, goals, eps, per_robot) if t is not None),
                    *_step_tensors(step))


def slab_bytes(T: int, A: int) -> int:
    """Shared memory of one block of K1's slab body (``slab_smem`` in
    csrc/mppi_solve.cu): an 8-byte mbarrier per chunk of the horizon, U, the
    block's softmin weights and the (T, A, 32) slab of ε."""
    return 8 * -(-T // _SLAB_CHUNK) + 4 * ((SLAB_WIDTH + 1) * T * A + SLAB_WIDTH)


def block_width(R: int, K: int, T: int, A: int, family: str | None = None) -> int:
    """Rollouts per block of K1 and K4 for R robots of K rollouts over T
    steps of A actions of fused family `family`, which picks the body:
    :data:`SLAB_WIDTH` (the slab body) while R·K is at most the family's
    :data:`SLAB_MAX_ROLLOUTS` (the least of them for None or a family
    registered from user code, whose crossover nobody measured) and the
    slab fits in a block's shared memory, else :data:`BLOCK` (the
    per-rollout body). A pure function of its arguments. The crossovers were
    measured at T=200; a shorter horizon puts more slab blocks on an SM, so
    they hold there conservatively."""
    limit = SLAB_MAX_ROLLOUTS.get(family, min(SLAB_MAX_ROLLOUTS.values()))
    if R * K <= limit and slab_bytes(T, A) <= _SMEM_BYTES:
        return SLAB_WIDTH
    return BLOCK


def block_partials(S: torch.Tensor, eps: torch.Tensor, lam_softmin: float,
                   width: int | None = None) -> torch.Tensor:
    """K1's per-block partials of one robot's costs S (K,) and noise ε
    (T, K, A) over blocks of `width` rollouts (:func:`block_width` for one
    robot if None): (nb, 2 + T·A), row b holding β_b = min S over block b's
    real rollouts, η_b = Σ e_k with e_k = exp(−(S_k − β_b)/λ), and
    ΔŨ_b[t, a] = Σ e_k ε_k[t, a]. Rollouts past K take no part; a block whose
    real rollouts all cost +inf gives η_b = 0, ΔŨ_b = 0; a NaN S gives a NaN
    β_b. In S's dtype."""
    T, K, A = eps.shape
    W = block_width(1, K, T, A) if width is None else width
    nb = -(-K // W)
    like = dict(dtype=S.dtype, device=S.device)
    valid = (torch.arange(nb * W, device=S.device) < K).view(nb, W)
    S_b = torch.full((nb * W,), math.inf, **like)
    S_b[:K] = S
    S_b = S_b.view(nb, W)
    beta_b = torch.amin(S_b, dim=1)
    live = valid & (beta_b != math.inf)[:, None]
    e = torch.where(live, torch.exp(-(S_b - beta_b[:, None]) / lam_softmin), 0.0)
    eps_b = torch.zeros(T, nb * W, A, **like)
    eps_b[:, :K] = eps
    dUt = torch.einsum("tnka,nk->nta", eps_b.view(T, nb, W, A), e)
    return torch.cat([beta_b[:, None], e.sum(1)[:, None], dUt.reshape(nb, T * A)], 1)


def _plain_costs(fam: FusedFamily, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps,
                 k0=0):
    """(S (K,), ε): the family's eager model and cost on the port's noise
    stream for (seed, step, it) from draw k0 on, or on the given ε."""
    if eps is None:
        eps = philox.sample_eps(
            seed, step, it, U.shape[0], K, fam.sigma, antithetic=antithetic, ou_beta=ou_beta,
            k0=k0,
        )
    return rollout_costs(fam.dynamics, fam.cost_for(goal), x0, U, eps), eps


def family_solve_partials_reference(
    fam: FusedFamily, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta,
    eps=None, k0=0, width=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 for one robot: ``(S (K,), partials (nb, 2 + T·A))``
    (:func:`block_partials` over blocks of `width`, :func:`block_width` for
    one robot if None), S from the family's eager model and cost on the
    port's noise stream from draw k0 on (or the given ε)."""
    S, eps = _plain_costs(fam, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps, k0)
    if width is None:
        width = block_width(1, K, *U.shape, fam.name)
    return S, block_partials(S, eps, lam_softmin, width)


def _fleet_width(fam: FusedFamily, Us, K: int, n_robots: int | None) -> int:
    """:func:`block_width` of a fleet of `n_robots` robots (R = Us.shape[0]
    if None) of whose robots `Us` holds R: a slice of a fleet (a rank of the
    sharded fleet) runs the whole fleet's body."""
    R, T, A = Us.shape
    return block_width(R if n_robots is None else n_robots, K, T, A, fam.name)


def fleet_family_solve_partials_reference(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta,
    eps=None, n_robots=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 for a fleet: the single-robot plain version for
    robot r on (xs[r], Us[r], goals[r], seed r, eps[r]) at the fleet's block
    width, stacked into ``(S (R, K), partials (R, nb, 2 + T·A))``."""
    R = Us.shape[0]
    width = _fleet_width(fam, Us, K, n_robots)
    out = [
        family_solve_partials_reference(
            fam, xs[r], Us[r], None if goals is None else goals[r], lam_softmin, K, seed,
            step, it, antithetic, ou_beta, None if eps is None else eps[r], width=width,
        )
        for r, seed in enumerate(_robot_seeds(seeds, R))
    ]
    return torch.stack([S for S, _ in out]), torch.stack([p for _, p in out])


def _launch_solve_partials(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta,
    eps, R: int, lead: tuple[int, ...], k0: int = 0, width: int | None = None,
):
    """Launch K1 for R robots on checked CUDA tensors, or K4 (K1's first pass
    alone) when `lam_softmin` is None; the outputs get the leading shape
    `lead`: () for the single-robot wrappers, (R,) for the fleet's. The body
    is :func:`block_width`'s, unless `width` forces one (chip_smoke.py times
    both bodies at one shape with it). A step tensor goes to the kernel by
    its address (``step_ptr``), an int by value. Returns ``(S, partials)``
    from K1, S from K4. Counts the launch under its kernel, in total, for the
    family and for the width."""
    T, A = Us.shape[-2:]
    pass2 = lam_softmin is not None
    if width is None:
        width = block_width(R, K, T, A, fam.name)
    if width == SLAB_WIDTH:
        smem = slab_bytes(T, A)
    elif width == BLOCK:
        smem = 4 * (1 + BLOCK // 32 if pass2 else 1) * T * A
    else:
        raise ValueError(f"K1 runs blocks of {SLAB_WIDTH} or {BLOCK} rollouts, not {width}")
    if smem > _SMEM_BYTES:
        raise ValueError(f"T·A = {T * A} exceeds the {width}-rollout body's shared-memory budget")
    from mppi_gpu_tpu_torch.ops._build import load_library

    nb = -(-K // width)
    per_robot = isinstance(seeds, torch.Tensor)
    step_ptr = isinstance(step, torch.Tensor)
    S = torch.empty(*lead, K, dtype=torch.float32, device=Us.device)
    partials = (torch.empty(*lead, nb, 2 + T * A, dtype=torch.float32, device=Us.device)
                if pass2 else None)
    kernel = "solve_partials" if pass2 else "rollout_costs"
    args = (
        xs.data_ptr(), Us.data_ptr(), fam.params.data_ptr(),
        goals.data_ptr() if goals is not None else None,
        seeds.data_ptr() if per_robot else None, step.data_ptr() if step_ptr else None,
        eps.data_ptr() if eps is not None else None, S.data_ptr(),
        partials.data_ptr() if pass2 else None,
        R, K, T, A, fam.dt, fam.lam_cost, float(lam_softmin) if pass2 else 1.0,
        *_noise_words(0 if per_robot else int(seeds), 0 if step_ptr else step, it),
        philox.draw_offset(k0),
        int(antithetic), float(ou_beta), _ou_c(ou_beta), width,
    )
    label = f"{kernel}<{fam.name}>"
    if fam.user is None:
        lib = load_library()
        ran = _launch(label, lib.mppi_solve_partials, Us.device, fam.fid, *args)
    else:
        lib = _family_library(fam)
        ran = _launch(label, lib.mppi_family_solve_partials, Us.device, *args)
    if ran:
        _LAUNCHES[kernel] += 1
        by_family = _FAMILY_LAUNCHES[kernel]
        by_family[fam.name] = by_family.get(fam.name, 0) + 1
        _WIDTH_LAUNCHES[kernel][width] += 1
    return (S, partials) if pass2 else S


def _family_library(fam: FusedFamily):
    """The library built from a user family's source (``ops/_build``, at
    its first launch), once its struct's kS and kGoal are found to be the
    family's state dimension and ``has_goal``."""
    from mppi_gpu_tpu_torch.ops import _build

    user = fam.user
    lib = _build.load_family_library(user.cuda_source, user.cuda_struct, fam.action_dim)
    S, goal = lib.family_struct
    if (S, goal) != (fam.state_dim, fam.has_goal):
        raise ValueError(
            f"the {fam.name} family's struct {user.cuda_struct} has kS={S}, kGoal={goal}; its "
            f"model has state_dim={fam.state_dim} and the family has_goal={fam.has_goal}"
        )
    return lib


def family_solve_partials(
    fam: FusedFamily, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta,
    eps=None, k0=0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 for one robot of family `fam` (the R = 1 launch of the fleet
    kernel) on CUDA tensors, its plain version on CPU tensors. x0 (S,),
    U (T, A), goal (S,) for a family with a goal, else None; the draws start
    at counter word k0; `step` is an int or a 0-dim int64 tensor on the
    inputs' device; see :func:`family_solve_partials_reference` for the
    outputs."""
    if not _solo_on_cuda(fam, x0, U, goal, K, antithetic, eps, step):
        return family_solve_partials_reference(
            fam, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta, eps, k0,
        )
    return _launch_solve_partials(
        fam, x0, U, goal, lam_softmin, K, int(seed), step, it, antithetic, ou_beta, eps, 1, (),
        k0,
    )


def fleet_family_solve_partials(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta,
    eps=None, n_robots=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 for R robots of family `fam` in one launch on CUDA tensors, its
    plain version on CPU tensors. xs (R, S), Us (R, T, A), goals (R, S) for a
    family with a goal, else None; ``seeds`` an (R,) int64 tensor of
    per-robot seeds or one int for every robot, eps (R, T, K, A) or None; the
    family's parameters, both λ, (step, it), antithetic and OU are shared.
    The block width is the fleet's (:func:`block_width` of `n_robots`, the
    whole fleet's size where these R robots are a slice of it; R if None).
    Returns ``(S (R, K), partials (R, nb, 2 + T·A))``."""
    if not _fleet_on_cuda(fam, xs, Us, goals, K, seeds, antithetic, eps, step):
        return fleet_family_solve_partials_reference(
            fam, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta, eps,
            n_robots,
        )
    return _launch_solve_partials(
        fam, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta, eps,
        Us.shape[0], (Us.shape[0],), width=_fleet_width(fam, Us, K, n_robots),
    )


# --------------------------------------------------------------------------
# K4: the costs-only sweep


def rollout_costs_reference(
    fam: FusedFamily, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps=None, k0=0,
) -> torch.Tensor:
    """Plain version of K4 for one robot: S (K,), the family's eager model and
    cost on the port's noise stream from draw k0 on (or the given ε)."""
    return _plain_costs(fam, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps, k0)[0]


def fleet_rollout_costs_reference(
    fam: FusedFamily, xs, Us, goals, K, seeds, step, it, antithetic, ou_beta, eps=None,
) -> torch.Tensor:
    """Plain version of K4 for a fleet: robot by robot, stacked into S (R, K)."""
    return torch.stack([
        rollout_costs_reference(
            fam, xs[r], Us[r], None if goals is None else goals[r], K, seed, step, it,
            antithetic, ou_beta, None if eps is None else eps[r],
        )
        for r, seed in enumerate(_robot_seeds(seeds, Us.shape[0]))
    ])


def fused_rollout_costs(
    fam: FusedFamily, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps=None, k0=0,
) -> torch.Tensor:
    """K4 for one robot of family `fam` (the R = 1 launch) on CUDA tensors,
    its plain version on CPU tensors: the rollout costs S (K,) of the solve
    :func:`family_solve_partials` would run on the same inputs, and nothing
    else. Arguments as there, without λ_softmin."""
    if not _solo_on_cuda(fam, x0, U, goal, K, antithetic, eps, step):
        return rollout_costs_reference(
            fam, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps, k0,
        )
    return _launch_solve_partials(
        fam, x0, U, goal, None, K, int(seed), step, it, antithetic, ou_beta, eps, 1, (), k0,
    )


def fleet_rollout_costs(
    fam: FusedFamily, xs, Us, goals, K, seeds, step, it, antithetic, ou_beta, eps=None,
) -> torch.Tensor:
    """K4 for R robots in one launch on CUDA tensors, its plain version on CPU
    tensors: S (R, K); arguments as :func:`fleet_family_solve_partials`,
    without λ_softmin."""
    if not _fleet_on_cuda(fam, xs, Us, goals, K, seeds, antithetic, eps, step):
        return fleet_rollout_costs_reference(
            fam, xs, Us, goals, K, seeds, step, it, antithetic, ou_beta, eps,
        )
    return _launch_solve_partials(
        fam, xs, Us, goals, None, K, seeds, step, it, antithetic, ou_beta, eps, Us.shape[0],
        (Us.shape[0],),
    )


# --------------------------------------------------------------------------
# K2: fold of the per-block partials


def softmin_combine_reference(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int, normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 for one robot: β = min β_b, f_b = exp((β − β_b)/λ),
    η = Σ f_b η_b, ΔU = Σ f_b ΔŨ_b / η (without the division by η unless
    `normalize`). Returns (β, η, ΔU (T, A))."""
    beta_b, eta_b = partials[:, 0], partials[:, 1]
    beta = torch.min(beta_b)
    f = torch.exp((beta - beta_b) / lam_softmin)
    eta = torch.sum(f * eta_b)
    dU = torch.sum(f[:, None] * partials[:, 2:], dim=0)
    return beta, eta, (dU / eta if normalize else dU).view(T, A)


def fleet_softmin_combine_reference(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 for a fleet: robot by robot, stacked into
    (β (R,), η (R,), ΔU (R, T, A))."""
    out = [softmin_combine_reference(p, lam_softmin, T, A) for p in partials]
    return tuple(torch.stack(v) for v in zip(*out))


def _launch_softmin_combine(
    partials: torch.Tensor, lam_softmin: float, R: int, T: int, A: int, lead: tuple[int, ...],
    normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (grid: 32-column tiles of ΔU × robots) on checked CUDA
    partials; returns (β η (*lead, 2), ΔU (*lead, T, A)). Counts the
    launch."""
    nb = partials.shape[-2]
    if nb < 1 or 4 * (nb + _COMBINE_SMEM_FLOATS) > _SMEM_BYTES:
        raise ValueError(f"{nb} partials exceed the combine kernel's shared memory")
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    beta_eta = torch.empty(*lead, 2, dtype=torch.float32, device=partials.device)
    dU = torch.empty(*lead, T, A, dtype=torch.float32, device=partials.device)
    if _launch(
        "softmin_combine", lib.mppi_softmin_combine, partials.device,
        partials.data_ptr(), R, nb, T * A, float(lam_softmin), int(normalize),
        beta_eta.data_ptr(), dU.data_ptr(),
    ):
        _LAUNCHES["softmin_combine"] += 1
    return beta_eta, dU


def softmin_combine(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int, normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 for one robot's (nb, 2 + T·A) partials (the R = 1 launch) on a CUDA
    tensor, its plain version on a CPU tensor. Without `normalize`, ΔU is
    Σ f_b ΔŨ_b, not divided by η: a rank's share of the one-pass sharded
    solve."""
    if partials.dim() != 2:
        raise ValueError(f"partials must be (nb, 2 + T·A), got {tuple(partials.shape)}")
    _check("partials", partials, (partials.shape[0], 2 + T * A))
    if not _on_cuda(partials):
        return softmin_combine_reference(partials, lam_softmin, T, A, normalize)
    beta_eta, dU = _launch_softmin_combine(partials, lam_softmin, 1, T, A, (), normalize)
    return beta_eta[0], beta_eta[1], dU


def fleet_softmin_combine(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on a CUDA (R, nb, 2 + T·A) tensor, one launch for the fleet; its plain
    version on a CPU tensor. Returns (β (R,), η (R,), ΔU (R, T, A))."""
    if partials.dim() != 3:
        raise ValueError(f"partials must be (R, nb, 2 + T·A), got {tuple(partials.shape)}")
    R, nb = partials.shape[:2]
    _check_fleet(R)
    _check("partials", partials, (R, nb, 2 + T * A))
    if not _on_cuda(partials):
        return fleet_softmin_combine_reference(partials, lam_softmin, T, A)
    beta_eta, dU = _launch_softmin_combine(partials, lam_softmin, R, T, A, (R,))
    return beta_eta[:, 0], beta_eta[:, 1], dU


# --------------------------------------------------------------------------
# K1 + K2: the whole solve core


def family_fused_solve_reference(fam: FusedFamily, x0, U, goal, lam_softmin, *args, eps=None,
                                 k0=0, normalize=True, width=None):
    """Plain version of :func:`family_fused_solve` (over blocks of `width`
    rollouts, :func:`block_width`'s for one robot if None)."""
    S, partials = family_solve_partials_reference(fam, x0, U, goal, lam_softmin, *args, eps, k0,
                                                  width)
    return (S, *softmin_combine_reference(partials, lam_softmin, *U.shape, normalize))


def family_fused_solve(fam: FusedFamily, x0, U, goal, lam_softmin, *args, eps=None, k0=0,
                       normalize=True):
    """One MPPI solve core of family `fam`: ``(S (K,), β, η, ΔU (T, A))``
    with ΔU = Σ_k w_k ε_k for the softmin weights w_k = exp(−(S_k − β)/λ)/η;
    ``args`` are (K, seed, step, it, antithetic, ou_beta) as for
    :func:`family_solve_partials`, the draws from counter word k0 on.
    Without `normalize` ΔU is η·Σ_k w_k ε_k, the share a rank of the one-pass
    sharded solve contributes. Clamp and shift are the caller's
    (``controller.MPPIController``)."""
    S, partials = family_solve_partials(fam, x0, U, goal, lam_softmin, *args, eps, k0)
    return (S, *softmin_combine(partials, lam_softmin, *U.shape, normalize))


def fleet_family_fused_solve_reference(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, *args, eps=None, n_robots=None
):
    """Plain version of :func:`fleet_family_fused_solve`:
    :func:`family_fused_solve_reference` robot by robot at the fleet's block
    width, stacked."""
    width = _fleet_width(fam, Us, K, n_robots)
    out = [
        family_fused_solve_reference(
            fam, xs[r], Us[r], None if goals is None else goals[r], lam_softmin, K, seed,
            *args, eps=None if eps is None else eps[r], width=width,
        )
        for r, seed in enumerate(_robot_seeds(seeds, Us.shape[0]))
    ]
    return tuple(torch.stack(v) for v in zip(*out))


def fleet_family_fused_solve(fam: FusedFamily, xs, Us, goals, lam_softmin, *args, eps=None,
                             n_robots=None):
    """R MPPI solve cores of family `fam` in one launch of K1 and one of K2:
    ``(S (R, K), β (R,), η (R,), ΔU (R, T, A))``; arguments as
    :func:`fleet_family_solve_partials`."""
    S, partials = fleet_family_solve_partials(fam, xs, Us, goals, lam_softmin, *args, eps,
                                              n_robots)
    return (S, *fleet_softmin_combine(partials, lam_softmin, *Us.shape[1:]))


# --------------------------------------------------------------------------
# the point-mass LTI problem as tensors


def _lti(family_fn, name: str, doc: str):
    """`family_fn` under the LTI signature (x0, U, σ, Σ⁻¹, w, goal, λ_cost,
    λ_softmin, dt, K, seed, step, it, antithetic, ou_beta, eps=None): the
    family is :func:`lti_family` of (σ, Σ⁻¹, w, dt, λ_cost)."""

    def fn(x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
           antithetic, ou_beta, eps=None):
        return family_fn(
            lti_family(sigma, inv_s, w, dt, lam_cost), x0, U, goal, lam_softmin, K, seed,
            step, it, antithetic, ou_beta, eps=eps,
        )

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = doc
    return fn


lti_solve_partials = _lti(
    family_solve_partials, "lti_solve_partials",
    "K1 for one point-mass robot; see :func:`family_solve_partials`.")
lti_solve_partials_reference = _lti(
    family_solve_partials_reference, "lti_solve_partials_reference",
    "Plain version of :func:`lti_solve_partials`.")
fused_solve = _lti(
    family_fused_solve, "fused_solve",
    "One point-mass MPPI solve core; see :func:`family_fused_solve`.")
fused_solve_reference = _lti(
    family_fused_solve_reference, "fused_solve_reference",
    "Plain version of :func:`fused_solve`.")
fleet_solve_partials = _lti(
    fleet_family_solve_partials, "fleet_solve_partials",
    "K1 for R point-mass robots, xs, Us, goals and seeds per robot; see "
    ":func:`fleet_family_solve_partials`.")
fleet_solve_partials_reference = _lti(
    fleet_family_solve_partials_reference, "fleet_solve_partials_reference",
    "Plain version of :func:`fleet_solve_partials`.")
fleet_fused_solve = _lti(
    fleet_family_fused_solve, "fleet_fused_solve",
    "R point-mass MPPI solve cores in one launch of K1 and one of K2; see "
    ":func:`fleet_family_fused_solve`.")
fleet_fused_solve_reference = _lti(
    fleet_family_fused_solve_reference, "fleet_fused_solve_reference",
    "Plain version of :func:`fleet_fused_solve`.")


# --------------------------------------------------------------------------
# K3: the noise dump


def noise_dump(
    sigma: torch.Tensor, T: int, K: int, seed: int, step: int, it: int,
    antithetic: bool, ou_beta: float, *, words: bool = False, k0: int = 0,
):
    """The (T, K, A) ε that K1 consumes in its Philox
    mode for (seed, step, it) from draw k0 on, in rollout order. With
    ``words`` also returns the (T, K_draw, 4) Philox words of the draws
    (int64 holding uint32 values) for a bit-exact check against
    ``ops/philox.philox_words``. K3 on a CUDA ``sigma``, ``ops/philox.py`` on
    a CPU one."""
    A = sigma.shape[0] if sigma.dim() == 1 else -1
    _check_problem(T, A, K, antithetic)
    _check("sigma", sigma, (A,))
    K_draw = K // 2 if antithetic else K
    if not _on_cuda(sigma):
        eps = philox.sample_eps(
            seed, step, it, T, K, sigma, antithetic=antithetic, ou_beta=ou_beta, k0=k0
        )
        if not words:
            return eps
        return eps, philox.philox_words(seed, step, it, T, K_draw, sigma.device, k0)
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    eps = torch.empty(T, K, A, dtype=torch.float32, device=sigma.device)
    w_out = (
        torch.empty(T, K_draw, 4, dtype=torch.int32, device=sigma.device)
        if words else None
    )
    if _launch(
        "noise_dump", lib.mppi_noise_dump, sigma.device,
        sigma.data_ptr(), eps.data_ptr(), w_out.data_ptr() if words else None,
        K, T, A, *_noise_words(seed, step, it), philox.draw_offset(k0), int(antithetic),
        float(ou_beta), _ou_c(ou_beta),
    ):
        _LAUNCHES["noise_dump"] += 1
    if not words:
        return eps
    return eps, w_out.to(torch.int64) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# K5: the weighted update


def weighted_update_reference(w: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (with K2's fold): ΔU (T, A) = Σ_k w_k ε_k[t, a]
    for weights w (K,) and noise ε (T, K, A)."""
    return torch.einsum("tka,k->ta", eps, w)


def weighted_update_partials(w: torch.Tensor, x: torch.Tensor, sigma: torch.Tensor | None = None,
                             antithetic: bool = False, ou_beta: float = 0.0) -> torch.Tensor:
    """Plain twin of K5's rows, (nb, 2 + T·A) with β_b = η_b = 0, which K2's
    ``normalize`` 0 fold (:func:`softmin_combine_reference`) sums into ΔU.
    Philox mode (`sigma` (A,) given): `x` holds the standard normals
    (T, K_draw, A) of the draws; under `antithetic` draw kd weighs
    w̃ = w[kd] − w[K_draw + kd] (its mirror's ε is −ε_kd); row b holds
    σ·N_b for N_b[t, a] = Σ w̃·n over draws b·DRAW_GROUP … b·DRAW_GROUP + 63,
    and with OU (`ou_beta` > 0) σ·E_b, E_b[0] = N_b[0], E_b[t] =
    β·E_b[t−1] + √(1−β²)·N_b[t]: the recursion run once on the row's sums,
    which equals Σ w̃·e over its draws' OU states in real arithmetic.
    Injected mode (`sigma` None): `x` is ε (T, K, A) and row b holds
    Σ w·ε over its rollouts. In x's dtype."""
    T, n, A = x.shape
    if sigma is not None and antithetic:
        w = w[:n] - w[n:]
    nb = -(-n // DRAW_GROUP)
    wp = torch.zeros(nb * DRAW_GROUP, dtype=x.dtype, device=x.device)
    wp[:n] = w
    xp = torch.zeros(T, nb * DRAW_GROUP, A, dtype=x.dtype, device=x.device)
    xp[:, :n] = x
    N = torch.einsum("tbga,bg->bta", xp.view(T, nb, DRAW_GROUP, A), wp.view(nb, DRAW_GROUP))
    if sigma is not None:
        if ou_beta > 0.0:
            c, E = _ou_c(ou_beta), [N[:, 0]]
            for t in range(1, T):
                E.append(ou_beta * E[-1] + c * N[:, t])
            N = torch.stack(E, 1)
        N = sigma * N
    return torch.cat([torch.zeros(nb, 2, dtype=x.dtype, device=x.device), N.reshape(nb, T * A)], 1)


def weighted_update_rows(T: int, K: int, A: int, fold: bool) -> int:
    """K5's partial rows, ceil(n / DRAW_GROUP) for its n draws (K/2 with the
    antithetic mirrors folded in, else K); ``ValueError`` when its (T, A)
    sums do not fit a block's shared memory."""
    if 4 * T * A > _SMEM_BYTES:
        raise ValueError(f"T·A = {T * A} exceeds the kernel's shared-memory budget")
    return -(-(K // 2 if fold else K) // DRAW_GROUP)


def weighted_update(
    sigma: torch.Tensor, w: torch.Tensor, T: int, K: int, seed: int, step: int, it: int,
    antithetic: bool, ou_beta: float, eps=None, k0: int = 0,
) -> torch.Tensor:
    """ΔU (T, A) = Σ_k w_k ε_k for normalized softmin weights w (K,), ε the
    port's noise stream for (seed, step, it) from draw k0 on under σ (A,)
    (the stream K1 and K4 draw), or the given ε (T, K, A). On CUDA tensors
    K5 writes per-block sums, regenerating ε, and K2 folds them (f_b = 1,
    not divided by η); on CPU tensors :func:`weighted_update_reference` on
    the stream ``ops/philox.py`` draws."""
    A = sigma.shape[0] if sigma.dim() == 1 else -1
    _check_problem(T, A, K, antithetic and eps is None)
    _check("sigma", sigma, (A,))
    _check("w", w, (K,))
    if eps is not None:
        _check("eps", eps, (T, K, A))
    if not _on_cuda(*(t for t in (sigma, w, eps) if t is not None)):
        if eps is None:
            eps = philox.sample_eps(seed, step, it, T, K, sigma, antithetic=antithetic,
                                    ou_beta=ou_beta, k0=k0)
        return weighted_update_reference(w, eps)
    fold = antithetic and eps is None  # one lane per draw, its mirror folded in
    nb = weighted_update_rows(T, K, A, fold)
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    partials = torch.empty(nb, 2 + T * A, dtype=torch.float32, device=w.device)
    if _launch(
        f"weighted_update<A={A}>", lib.mppi_weighted_update, w.device,
        sigma.data_ptr(), w.data_ptr(), eps.data_ptr() if eps is not None else None,
        partials.data_ptr(), K, T, A, *_noise_words(seed, step, it), philox.draw_offset(k0),
        int(fold), float(ou_beta), _ou_c(ou_beta),
    ):
        _LAUNCHES["weighted_update"] += 1
    return _launch_softmin_combine(partials, 1.0, 1, T, A, (), normalize=False)[1]


def reset_launch_counts() -> None:
    for kernel in _LAUNCHES:
        _LAUNCHES[kernel] = 0
    for counts in (*_FAMILY_LAUNCHES.values(), *_WIDTH_LAUNCHES.values()):
        counts.update(dict.fromkeys(counts, 0))


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return dict(_LAUNCHES)


def family_launch_counts(kernel: str = "solve_partials") -> dict[str, int]:
    """K1's (or K4's, ``kernel="rollout_costs"``) launches by family; they
    add up to ``launch_counts()[kernel]``."""
    return dict(_FAMILY_LAUNCHES[kernel])


def width_launch_counts(kernel: str = "solve_partials") -> dict[int, int]:
    """K1's (or K4's) launches by block width, that is by body:
    :data:`SLAB_WIDTH` the slab body, :data:`BLOCK` the per-rollout body."""
    return dict(_WIDTH_LAUNCHES[kernel])
