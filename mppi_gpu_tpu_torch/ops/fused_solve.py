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
  weights w, or for the weights K5 forms itself from the softmin (S, β, η,
  λ) (its softmin form, the update of the two-kernel sharded solve,
  ``parallel/sharded.py``), ε regenerated in the kernel (K5's per-block
  sums folded by K2 without the division by η); its plain version is
  :func:`weighted_update_reference` (on the softmin's weights as torch ops
  compute them, :func:`softmin_weights_of`), and
  :func:`weighted_update_partials` is the plain twin of K5's rows
  (:data:`DRAW_GROUP` draws each, the OU filter run on the row's sums).

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
(:data:`BLOCK` rollouts per block, one thread per rollout; K1's second pass
draws the noise of the rollouts that weigh again, over (step, rollout), and
sums e·ε from shared memory), which fills the card at large R·K, and the
slab body (:data:`SLAB_WIDTH` rollouts per block, the noise drawn in
parallel over the horizon, a ring of chunks ahead of the rollout warp; its
second pass is the per-rollout body's at 32 slots), for the main path's K.
:func:`block_width` picks one from the shapes alone; the partials have
ceil(K / width) rows, and the plain :func:`block_partials` takes the same
width (at the slab width, the slab body's order of ΔŨ's sums). ΔU at two
widths differs by rounding only. A body that fails to build or launch
raises: nothing falls back to the other body. Each launch call is counted
by the waves its grid takes (:func:`wave_launch_counts`).

Noise: ``eps=None`` is the Philox mode (production): ε is generated in the
kernel from (seed, step, it), robot r under its own seed. K1's, K4's and
K5's wrappers take the control step as an int, passed by value, or as a
0-dim int64 tensor on the inputs' device, whose address the kernel reads the
step from (the results of both forms are the same bit for bit): a captured
CUDA graph replays the step its counter holds (``runner.run_episode_jit``,
``graphs.SolveGraph``). The single-robot
wrappers take a draw offset ``k0`` (counter word 0 = k0 + draw index, 0 on
one GPU) with which a rank of the sharded solve draws its part of the
stream. ``eps`` given is the injected-ε mode for parity tests: a (T, K, A)
tensor, (R, T, K, A) for the fleet, is read instead.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.ops import _rounding, philox
from mppi_gpu_tpu_torch.ops.cost import QuadraticCost
from mppi_gpu_tpu_torch.ops.families import FAMILY_ID, FAMILY_NAMES, MAX_A, FusedFamily
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs
from mppi_gpu_tpu_torch.utils import timing

BLOCK = 128          # rollouts per block of K1's per-rollout body (kBlock)
DELTA_CELLS = 8 * (BLOCK + 8)  # floats per action of its second pass's slab (kDeltaCells)
SLAB_WIDTH = 32      # rollouts per block of K1's slab body (kSlabRollouts)
SLAB_THREADS = 256   # threads per block of the slab body: 1 rollout, 7 draw warps (kSlabThreads)
SLAB_RING = 4        # least slots of the slab body's ring (kRing)
SLAB_MIN_BLOCKS = 3  # blocks per SM its registers and ring leave room for (kSlabMinBlocks)
SLAB_LEAN_STATE = 8  # states up to which a family keeps SLAB_MIN_BLOCKS, else 2 (kSlabLeanState)
DRAW_GROUP = 64      # draws per block of K3 and K5, one partial row of K5 (kGroup)
_SLAB_CHUNK = 7      # horizon steps per slot of the slab body's ring (kChunk)
# R·K up to which K1 and K4 take the slab body, by family: beyond it the
# per-rollout body's blocks fill the card, and the slab body (two blocks per
# SM at T=200 when these were measured) cannot hide its rollout warp's
# latency; the longer the family's step, the sooner. Each is the largest R·K
# of the sweep {1024,
# 3000, 10⁴, 2·10⁴, 3·10⁴, 5·10⁴, 10⁵} at T=200 up to which the slab body's
# device time was at most the per-rollout body's for K1 with every rollout
# weighing (λ = 1e9: the per-rollout body's second pass draws and sums only
# the rollouts whose weight is not 0, so this is its slowest case; the rule
# sees the shapes, not the weights) and at most 5 % above it for K4, the
# least over a family's instances (NVIDIA H100 80GB HBM3, 700 W;
# chip_smoke.body_times; the table in PERF.md §6)
SLAB_MAX_ROLLOUTS = {
    "lti": 30_000, "lti-obstacle": 10_000, "pendulum": 20_000, "cartpole": 10_000,
    "unicycle": 20_000, "quadrotor": 10_000, "arm": 10_000, "quadrotor3d": 10_000,
}
MAX_ROBOTS = 65535   # K1's grid axis y is the robot (kMaxRobots)
_SMEM_BYTES = 232448 - 1024  # per-block shared memory on Hopper, less static use
# one Hopper SM (NVIDIA H100): its shared memory, the 1 KB the runtime keeps
# per block, its 32-bit registers, threads and blocks
_SM_SMEM, _SM_BLOCK_SMEM, _SM_REGISTERS, _SM_THREADS, _SM_BLOCKS = 233472, 1024, 65536, 2048, 32
H100_SMS = 132
_COMBINE_SMEM_FLOATS = 8 * 32  # K2's per-warp column sums (kCombineWarps · kCombineCols)
_COMBINE_THREADS, _COMBINE_WARPS = 256, 8  # the fold's block (kCombineThreads, kCombineWarps)
# K2' folds a robot's partials in one block (grid (1, R)) where they are at
# most COMBINE_ONE_BLOCK_FLOATS floats, nb·(2 + T·A), of at most
# COMBINE_ONE_BLOCK_COLUMNS columns T·A, and the block's shared memory holds
# them; else in 32-column tiles (grid (⌈T·A/32⌉, R)), as K2 always does. Both
# forms give the same floats bit for bit (csrc/softmin_combine.cuh); the
# one-block form spares K2' the tiles' ticket and the reload of ΔU, and costs
# one SM's bandwidth and all the columns' sums in one block. The crossover,
# K2''s µs per launch in a replayed graph of each form over nb 16-313 × T·A
# 40-600, R = 1 and 8 (chip_smoke.combine_crossover, `--combine`; NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6): one block at most the tiles' at every
# shape of T·A ≤ 240 up to 13146 floats, the tiles faster at T·A = 600 from
# 9632 floats and at 15488, within 0.1 µs at 16014. K2 alone, with no tail
# to spare, was faster in tiles at every shape (by 0.03-0.5 µs).
COMBINE_ONE_BLOCK_FLOATS = 13_312
COMBINE_ONE_BLOCK_COLUMNS = 256  # one column per thread of the block

# launches of each CUDA kernel of csrc/mppi_solve.cu, counted by the function
# that launches it, where it launches; K1's and K4's also by family and by
# body (block width): views of ``utils/timing``'s registry, ``launch.<kernel>``,
# ``launch.<kernel>.family.<name>``, ``launch.<kernel>.width.<width>``
_LAUNCHES = timing.Counters("launch", ("solve_partials", "softmin_combine", "noise_dump",
                                       "rollout_costs", "weighted_update"))
_FAMILY_LAUNCHES = {k: timing.Counters(f"launch.{k}.family", FAMILY_NAMES)
                    for k in ("solve_partials", "rollout_costs")}
_WIDTH_LAUNCHES = {k: timing.Counters(f"launch.{k}.width", (SLAB_WIDTH, BLOCK))
                   for k in ("solve_partials", "rollout_costs")}
# K1's and K4's launches by the waves their grid takes (:func:`waves`),
# ``launch.<kernel>.waves.<n>``, counted at each launch call: a launch that a
# graph captures counts once, its replays not at all
_WAVE_LAUNCHES = {k: timing.Counters(f"launch.{k}.waves", ())
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


def rollout_bytes(T: int, A: int, pass2: bool = True) -> int:
    """Shared memory of one block of the per-rollout body (``rollout_smem``
    in csrc/mppi_solve.cuh): U; K1 (`pass2`) also the weights and draws of
    its :data:`BLOCK` slots, one count per warp and the slab of
    :data:`DELTA_CELLS` floats per action that its second pass fills chunk
    by chunk (eight steps of 128 slots, rows padded to 136), whatever T."""
    return 4 * (T * A + (2 * BLOCK + BLOCK // 32 + DELTA_CELLS * A if pass2 else 0))


def slab_ring(T: int, A: int) -> int:
    """Slots of the slab body's ring (``slab_ring`` in csrc/mppi_solve.cuh):
    every 7-step chunk of the horizon where the shared memory of
    :data:`SLAB_MIN_BLOCKS` blocks per SM holds them all, else as many as it
    holds, and at least :data:`SLAB_RING`."""
    chunks = -(-T // _SLAB_CHUNK)
    room = (_SM_SMEM // SLAB_MIN_BLOCKS - _SM_BLOCK_SMEM
            - 4 * (T * A + 3 * SLAB_WIDTH + SLAB_THREADS // 32))
    fit = room // (16 + 4 * _SLAB_CHUNK * A * SLAB_WIDTH) if room > 0 else 0
    return max(SLAB_RING, min(chunks, fit))


def slab_bytes(T: int, A: int) -> int:
    """Shared memory of one block of K1's slab body (``slab_smem`` in
    csrc/mppi_solve.cuh): a full and an empty 8-byte mbarrier per slot of
    the ring (:func:`slab_ring`), U, the second pass's 32 slot weights, 32
    slot draws, 32 places and its count per warp, and the ring of 7 steps ×
    A × 32 floats a slot. Within 1/3 of an SM's shared memory wherever U leaves room
    for four slots."""
    ring = slab_ring(T, A)
    return 16 * ring + 4 * (T * A + 3 * SLAB_WIDTH + SLAB_THREADS // 32
                            + ring * _SLAB_CHUNK * SLAB_WIDTH * A)


def slab_horizon_fits(T: int, A: int) -> bool:
    """The horizon limit of the rule (:func:`block_width`): whether the slab
    body's former whole-horizon layout, an mbarrier per 7-step chunk, U, 32
    weights and a (T, A, 32) slab, fits a block's shared memory. The ring
    runs any T, but the crossovers of :data:`SLAB_MAX_ROLLOUTS` were measured
    with that layout, so the rule keeps its limit: up to T = 582 at A = 3,
    437 at A = 4."""
    return 8 * -(-T // _SLAB_CHUNK) + 4 * ((SLAB_WIDTH + 1) * T * A + SLAB_WIDTH) <= _SMEM_BYTES


def block_width(R: int, K: int, T: int, A: int, family: str | None = None) -> int:
    """Rollouts per block of K1 and K4 for R robots of K rollouts over T
    steps of A actions of fused family `family`, which picks the body:
    :data:`SLAB_WIDTH` (the slab body) while R·K is at most the family's
    :data:`SLAB_MAX_ROLLOUTS` (the least of them for None or a family
    registered from user code, whose crossover nobody measured) and the
    horizon is within :func:`slab_horizon_fits`, else :data:`BLOCK` (the
    per-rollout body). A pure function of its arguments. The crossovers were
    measured at T=200; a shorter horizon puts more slab blocks on an SM, so
    they hold there conservatively."""
    limit = SLAB_MAX_ROLLOUTS.get(family, min(SLAB_MAX_ROLLOUTS.values()))
    if R * K <= limit and slab_horizon_fits(T, A):
        return SLAB_WIDTH
    return BLOCK


def resident_blocks(threads: int, registers: int, smem: int) -> int:
    """Blocks of `threads` threads of `registers` registers each (the
    allocation rounds them up to a multiple of 8) and `smem` bytes of
    dynamic shared memory that one Hopper SM holds: the least of what its
    registers, shared memory, threads and block slots allow. The model of
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` that the tests pin the
    slab body's constants to; the launches read the runtime's."""
    per_thread = -(-registers // 8) * 8
    return min(_SM_REGISTERS // (per_thread * threads), _SM_SMEM // (smem + _SM_BLOCK_SMEM),
               _SM_THREADS // threads, _SM_BLOCKS)


def waves(blocks: int, per_sm: int, sms: int = H100_SMS) -> int:
    """The waves a grid of `blocks` blocks takes on `sms` SMs that hold
    `per_sm` of them each: ⌈blocks / (sms · per_sm)⌉."""
    return -(-blocks // (sms * per_sm))


def block_partials(S: torch.Tensor, eps: torch.Tensor, lam_softmin: float,
                   width: int | None = None) -> torch.Tensor:
    """K1's per-block partials of one robot's costs S (K,) and noise ε
    (T, K, A) over blocks of `width` rollouts (:func:`block_width` for one
    robot if None): (nb, 2 + T·A), row b holding β_b = min S over block b's
    real rollouts, η_b = Σ e_k with e_k = exp(−(S_k − β_b)/λ), and
    ΔŨ_b[t, a] = Σ e_k ε_k[t, a], at :data:`SLAB_WIDTH` summed in the slab
    body's order (:func:`_slab_row_sums`). Rollouts past K take no part; a
    block whose real rollouts all cost +inf gives η_b = 0, ΔŨ_b = 0; a NaN S
    gives a NaN β_b. In S's dtype."""
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
    eps_b = eps_b.view(T, nb, W, A)
    if W == SLAB_WIDTH:
        dU = _slab_row_sums(e, eps_b)
    else:
        dU = torch.einsum("tnka,nk->nta", eps_b, e).reshape(nb, T * A)
    return torch.cat([beta_b[:, None], e.sum(1)[:, None], dU], 1)


def _slab_row_sums(e: torch.Tensor, eps_b: torch.Tensor) -> torch.Tensor:
    """ΔŨ_b (nb, T·A) of blocks of 32 rollouts with weights e (nb, 32) and
    noise ε (T, nb, 32, A), in the order of the slab body's second pass
    (``weigh_rows`` in csrc/mppi_solve.cuh, at 32 slots): the n rollouts of
    a block whose e_k ≠ 0 (NaN too) take slots 0..n−1 in rollout order, each
    cell the rounded product e_k·ε_k; a row's sum over them is, for
    n ≤ 16, the slots 0, 2, 4, … added in turn from +0 plus the slots 1, 3,
    5, … so added; for n > 16, each of two lanes l adds slots l, l + 4, … and
    l + 2, l + 6, … so, and the lanes' sums are added. A block where none
    weighs gives +0. The empty slots past n, +0 here, add nothing: a sum
    from +0 is never −0."""
    nb, W = e.shape
    T, A = eps_b.shape[0], eps_b.shape[-1]
    weighs = e != 0
    cells = torch.where(weighs[None, :, :, None], e[None, :, :, None] * eps_b, 0.0)
    order = torch.argsort((~weighs).to(torch.int8), dim=1, stable=True)  # weighing first
    c = cells.permute(1, 2, 0, 3).reshape(nb, W, T * A)
    c = torch.gather(c, 1, order[:, :, None].expand(nb, W, T * A))

    def run(first: int, step: int) -> torch.Tensor:  # slots first, first + step, … in turn
        acc = torch.zeros_like(c[:, 0])
        for i in range(first, W, step):
            acc = acc + c[:, i]
        return acc

    one_lane = run(0, 2) + run(1, 2)
    two_lanes = (run(0, 4) + run(2, 4)) + (run(1, 4) + run(3, 4))
    return torch.where((weighs.sum(1) <= 16)[:, None], one_lane, two_lanes)


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
    S_out: torch.Tensor | None = None,
):
    """Launch K1 for R robots on checked CUDA tensors, or K4 (K1's first pass
    alone) when `lam_softmin` is None; the outputs get the leading shape
    `lead`: () for the single-robot wrappers, (R,) for the fleet's; S is
    written into `S_out` when given (checked). The body
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
        smem = rollout_bytes(T, A, pass2)
    else:
        raise ValueError(f"K1 runs blocks of {SLAB_WIDTH} or {BLOCK} rollouts, not {width}")
    if smem > _SMEM_BYTES:
        raise ValueError(f"T·A = {T * A} exceeds the {width}-rollout body's shared-memory budget")
    from mppi_gpu_tpu_torch.ops._build import load_library

    nb = -(-K // width)
    per_robot = isinstance(seeds, torch.Tensor)
    step_ptr = isinstance(step, torch.Tensor)
    if S_out is None:
        S = torch.empty(*lead, K, dtype=torch.float32, device=Us.device)
    else:
        _check("S_out", S_out, (*lead, K))
        S = S_out
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
    # the instance: what the residency entry takes, less the family's own id
    instance = (goals.data_ptr() if goals is not None else None,
                eps.data_ptr() if eps is not None else None, T, A, int(pass2), width)
    key = (fam.name, goals is not None, eps is not None, T, A, pass2, width, Us.device)
    if fam.user is None:
        lib = load_library()
        n = _waves(lib, key, nb * R, lambda out: _launch(
            label, lib.mppi_solve_residency, Us.device, fam.fid, *instance, out))
        ran = _launch(label, lib.mppi_solve_partials, Us.device, fam.fid, *args)
    else:
        lib = _family_library(fam)
        n = _waves(lib, key, nb * R, lambda out: _launch(
            label, lib.mppi_family_solve_residency, Us.device, *instance, out))
        ran = _launch(label, lib.mppi_family_solve_partials, Us.device, *args)
    if n is not None:  # launched, or captured
        by_waves = _WAVE_LAUNCHES[kernel]
        by_waves[n] = by_waves.get(n, 0) + 1
    if ran:
        _LAUNCHES[kernel] += 1
        by_family = _FAMILY_LAUNCHES[kernel]
        by_family[fam.name] = by_family.get(fam.name, 0) + 1
        _WIDTH_LAUNCHES[kernel][width] += 1
    return (S, partials) if pass2 else S


def _waves(lib, key: tuple, blocks: int, query) -> int | None:
    """:func:`waves` of a grid of `blocks` blocks of the K1 or K4 instance
    `key` of library `lib`, whose residency and SMs `query(out)` writes into
    two ints at address `out` (its C entry), read once per instance and
    kept on the library; None where the entry reports no block per SM (the
    launch that follows then fails and raises)."""
    cache = lib.__dict__.setdefault("k1_residency", {})
    if key not in cache:
        out = (ctypes.c_int * 2)()
        query(ctypes.addressof(out))
        cache[key] = tuple(out)
    per_sm, sms = cache[key]
    return waves(blocks, per_sm, sms) if per_sm > 0 and sms > 0 else None


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
    eps=None, k0=0, S_out=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 for one robot of family `fam` (the R = 1 launch of the fleet
    kernel) on CUDA tensors, its plain version on CPU tensors. x0 (S,),
    U (T, A), goal (S,) for a family with a goal, else None; the draws start
    at counter word k0; `step` is an int or a 0-dim int64 tensor on the
    inputs' device; S written into `S_out` (K,) when given (a sharded rank's
    row of one buffer); see :func:`family_solve_partials_reference` for the
    outputs."""
    if not _solo_on_cuda(fam, x0, U, goal, K, antithetic, eps, step):
        S, partials = family_solve_partials_reference(
            fam, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta, eps, k0,
        )
        return (S if S_out is None else S_out.copy_(S)), partials
    return _launch_solve_partials(
        fam, x0, U, goal, lam_softmin, K, int(seed), step, it, antithetic, ou_beta, eps, 1, (),
        k0, S_out=S_out,
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
    S_out=None,
) -> torch.Tensor:
    """K4 for one robot of family `fam` (the R = 1 launch) on CUDA tensors,
    its plain version on CPU tensors: the rollout costs S (K,) of the solve
    :func:`family_solve_partials` would run on the same inputs, and nothing
    else. Arguments as there, without λ_softmin; S written into `S_out` (K,)
    when given (a sharded rank's row of one buffer)."""
    if not _solo_on_cuda(fam, x0, U, goal, K, antithetic, eps, step):
        S = rollout_costs_reference(
            fam, x0, U, goal, K, seed, step, it, antithetic, ou_beta, eps, k0,
        )
        return S if S_out is None else S_out.copy_(S)
    return _launch_solve_partials(
        fam, x0, U, goal, None, K, int(seed), step, it, antithetic, ou_beta, eps, 1, (), k0,
        S_out=S_out,
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


def combine_smem(nb: int, TA: int, one_block: bool) -> int:
    """Shared bytes of the fold's block in either form
    (csrc/softmin_combine.cuh, block_smem_floats and tile_smem_floats): one
    block holds the robot's partials (and 4 floats of slack, to align its
    16-byte copies), the factors f_b and the warps' sums of every column; a
    tile f_b, its warps' sums and each lane's staged rows (all its warp's
    ⌈nb/8⌉, or as many as fit)."""
    if one_block:
        return 4 * (4 + nb * (2 + TA) + nb + _COMBINE_WARPS * TA)
    per = -(-nb // _COMBINE_WARPS)
    room = (_SMEM_BYTES // 4 - nb - _COMBINE_THREADS) // _COMBINE_THREADS
    return 4 * (nb + _COMBINE_THREADS + _COMBINE_THREADS * max(0, min(per, room)))


def combine_one_block(nb: int, TA: int) -> bool:
    """K2''s form for nb partial rows of T·A columns: one block per robot
    where the partials are at most COMBINE_ONE_BLOCK_FLOATS floats of at
    most COMBINE_ONE_BLOCK_COLUMNS columns and fit one block's shared memory
    with K2''s row, else column tiles (K2's only form). A function of the
    shapes alone, so a fleet's robots take their solo launch's form."""
    return (nb * (2 + TA) <= COMBINE_ONE_BLOCK_FLOATS and TA <= COMBINE_ONE_BLOCK_COLUMNS
            and max(combine_smem(nb, TA, True), 4 * TA) <= _SMEM_BYTES)


def _combine_form(nb: int, TA: int, one_block: bool | None, row_bytes: int = 0) -> bool:
    """The form a K2 (False) or K2' launch takes (`one_block` None: the
    rule's); raises where nb partials do not fit the form's shared memory."""
    if one_block is None:
        one_block = combine_one_block(nb, TA)
    if nb < 1 or max(combine_smem(nb, TA, one_block), row_bytes) > _SMEM_BYTES:
        raise ValueError(f"{nb} partials of {TA} columns exceed the combine kernel's shared memory "
                         f"in the {'one-block' if one_block else 'tiled'} form")
    return one_block


def _launch_softmin_combine(
    partials: torch.Tensor, lam_softmin: float, R: int, T: int, A: int, lead: tuple[int, ...],
    normalize: bool = True, out: torch.Tensor | None = None, dU_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (grid: 32-column tiles of ΔU × robots) on checked CUDA
    partials; returns (β η (*lead, 2), ΔU (*lead, T, A)), for one robot the
    two parts of `out` (2 + T·A,) when given, or ΔU as a view of `dU_out`
    (T·A,) when given (β η then into a scratch pair). Counts the launch."""
    nb = partials.shape[-2]
    _combine_form(nb, T * A, False)
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    f32 = dict(dtype=torch.float32, device=partials.device)
    if out is not None:
        beta_eta, dU = out[:2], out[2:].view(T, A)
    else:
        beta_eta = torch.empty(*lead, 2, **f32)
        dU = dU_out.view(T, A) if dU_out is not None else torch.empty(*lead, T, A, **f32)
    if _launch(
        "softmin_combine", lib.mppi_softmin_combine, partials.device,
        partials.data_ptr(), R, nb, T * A, float(lam_softmin), int(normalize),
        beta_eta.data_ptr(), dU.data_ptr(),
    ):
        _LAUNCHES["softmin_combine"] += 1
    return beta_eta, dU


def softmin_combine(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int, normalize: bool = True,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 for one robot's (nb, 2 + T·A) partials (the R = 1 launch) on a CUDA
    tensor, its plain version on a CPU tensor. Without `normalize`, ΔU is
    Σ f_b ΔŨ_b, not divided by η: a rank's share of the one-pass sharded
    solve. With `out` (2 + T·A,) the result [β, η, ΔU] is written there (a
    sharded rank's row of one buffer) and returned as its views."""
    if partials.dim() != 2:
        raise ValueError(f"partials must be (nb, 2 + T·A), got {tuple(partials.shape)}")
    _check("partials", partials, (partials.shape[0], 2 + T * A))
    if out is not None:
        _check("out", out, (2 + T * A,))
    if not _on_cuda(*(t for t in (partials, out) if t is not None)):
        beta, eta, dU = softmin_combine_reference(partials, lam_softmin, T, A, normalize)
        if out is None:
            return beta, eta, dU
        out[0], out[1] = beta, eta
        out[2:].copy_(dU.reshape(-1))
        return out[0], out[1], out[2:].view(T, A)
    beta_eta, dU = _launch_softmin_combine(partials, lam_softmin, 1, T, A, (), normalize, out)
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
                       normalize=True, S_out=None, out=None):
    """One MPPI solve core of family `fam`: ``(S (K,), β, η, ΔU (T, A))``
    with ΔU = Σ_k w_k ε_k for the softmin weights w_k = exp(−(S_k − β)/λ)/η;
    ``args`` are (K, seed, step, it, antithetic, ou_beta) as for
    :func:`family_solve_partials`, the draws from counter word k0 on.
    Without `normalize` ΔU is η·Σ_k w_k ε_k, the share a rank of the one-pass
    sharded solve contributes. S is written into `S_out` (K,) and [β, η, ΔU]
    into `out` (2 + T·A,) when given (a sharded rank's rows). Clamp and shift
    are the caller's (``controller.MPPIController``)."""
    S, partials = family_solve_partials(fam, x0, U, goal, lam_softmin, *args, eps, k0, S_out)
    return (S, *softmin_combine(partials, lam_softmin, *U.shape, normalize, out))


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


def softmin_weights_of(softmin) -> torch.Tensor:
    """The weights exp(−(S − β)/λ)/η of `softmin` = (S (K,), β, η 0-dim, λ a
    Python float) as torch ops compute them: what K5's softmin form forms."""
    S, beta, eta, lam = softmin
    return torch.exp(-(S - beta) / lam) / eta


def weighted_update(
    sigma: torch.Tensor, w, T: int, K: int, seed: int, step, it: int,
    antithetic: bool, ou_beta: float, eps=None, k0: int = 0, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """ΔU (T, A) = Σ_k w_k ε_k for normalized softmin weights w, ε the
    port's noise stream for (seed, step, it) from draw k0 on under σ (A,)
    (the stream K1 and K4 draw), or the given ε (T, K, A). `w` is the
    weights (K,), or the softmin (S (K,), β, η 0-dim, λ a Python float)
    from which K5's softmin form forms each weight in its prologue,
    exp(−(S_k − β)/λ)/η with torch's rounding (the division by λ a product
    with float32(1/λ), ``_rounding.scalar_reciprocal``), and writes no w:
    the two-kernel sharded solve's update after its collectives. `step` is
    an int, passed by value, or a 0-dim int64 tensor on the inputs' device,
    whose address K5 reads the step from, as K1 does. ΔU is written into
    `out` (T·A,) when given (a sharded rank's row of one buffer) and
    returned as its view. On CUDA tensors K5 writes per-block sums,
    regenerating ε, and K2 folds them (f_b = 1, not divided by η); on CPU
    tensors :func:`weighted_update_reference` on the stream
    ``ops/philox.py`` draws and, for a softmin, on the weights of
    :func:`softmin_weights_of`."""
    A = sigma.shape[0] if sigma.dim() == 1 else -1
    _check_problem(T, A, K, antithetic and eps is None)
    _check("sigma", sigma, (A,))
    softmin = w if isinstance(w, tuple) else None
    if softmin is not None:
        S, beta, eta, lam = softmin
        _check("S", S, (K,))
        _check("beta", beta, ())
        _check("eta", eta, ())
        tensors = [sigma, S, beta, eta]
    else:
        _check("w", w, (K,))
        tensors = [sigma, w]
    if eps is not None:
        _check("eps", eps, (T, K, A))
        tensors.append(eps)
    if out is not None:
        _check("out", out, (T * A,))
        tensors.append(out)
    if not _on_cuda(*tensors, *_step_tensors(step)):
        if eps is None:
            eps = philox.sample_eps(seed, step, it, T, K, sigma, antithetic=antithetic,
                                    ou_beta=ou_beta, k0=k0)
        dU = weighted_update_reference(w if softmin is None else softmin_weights_of(softmin), eps)
        return dU if out is None else out.view(T, A).copy_(dU)
    fold = antithetic and eps is None  # one lane per draw, its mirror folded in
    nb = weighted_update_rows(T, K, A, fold)
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    step_ptr = isinstance(step, torch.Tensor)
    partials = torch.empty(nb, 2 + T * A, dtype=torch.float32, device=sigma.device)
    if softmin is None:  # the weights given, or their costs (w null)
        w_ptr, form = w.data_ptr(), (None, None, None, 0.0)
    else:
        w_ptr = None
        form = (S.data_ptr(), beta.data_ptr(), eta.data_ptr(), _rounding.scalar_reciprocal(lam))
    if _launch(
        f"weighted_update<A={A}>", lib.mppi_weighted_update, sigma.device,
        sigma.data_ptr(), w_ptr, eps.data_ptr() if eps is not None else None,
        partials.data_ptr(), K, T, A, *_noise_words(seed, 0 if step_ptr else step, it),
        philox.draw_offset(k0), int(fold), float(ou_beta), _ou_c(ou_beta),
        step.data_ptr() if step_ptr else None, *form,
    ):
        _LAUNCHES["weighted_update"] += 1
    return _launch_softmin_combine(partials, 1.0, 1, T, A, (), normalize=False, dU_out=out)[1]


def reset_launch_counts() -> None:
    for kernel in _LAUNCHES:
        _LAUNCHES[kernel] = 0
    for counts in (*_FAMILY_LAUNCHES.values(), *_WIDTH_LAUNCHES.values(),
                   *_WAVE_LAUNCHES.values()):
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


def wave_launch_counts(kernel: str = "solve_partials") -> dict[int, int]:
    """K1's (or K4's) launch calls by the waves their grid takes on the
    card (:func:`waves` with the runtime's residency of the instance), a
    captured launch once; where nothing was counted, {}."""
    return {n: c for n, c in _WAVE_LAUNCHES[kernel].items() if c}
