"""The fused MPPI solve: wrappers of the CUDA kernels in
``csrc/mppi_solve.cu`` and their plain versions.

* :func:`fleet_family_solve_partials` (K1) — for each of R robots, rollout,
  cost and per-block softmin partials ``(β_b, η_b, ΔŨ_b)`` over blocks of
  :data:`BLOCK` rollouts, for one fused family (``ops/families.py``: the
  point-mass LTI, pendulum and cart-pole models with their costs);
* :func:`fleet_softmin_combine` (K2) — each robot's associative fold of its
  partials into ``β``, ``η`` and ``ΔU``;
* :func:`fleet_family_fused_solve` — K1 then K2, the fleet controller's
  ``fused`` backend;
* :func:`family_solve_partials`, :func:`softmin_combine`,
  :func:`family_fused_solve` — the single-robot solve: the R = 1 launch of
  the same kernels;
* :func:`noise_dump` (K3) — the ε stream K1 consumed, for the debug dump and
  the replay check; its plain version is ``ops/philox.py``.

The LTI functions :func:`lti_solve_partials`, :func:`fused_solve`,
:func:`fleet_solve_partials` and :func:`fleet_fused_solve` take the
point-mass problem as tensors (σ, Σ⁻¹, w, goal, λ, dt) and run the same
kernels on its family (:func:`lti_family`, built per call).

Each wrapper launches its kernel when its inputs lie on a CUDA device,
through the kernel's one launcher, which counts the launch in its
``launches`` attribute (:data:`KERNELS` maps the CUDA kernel's name to it;
K1's launcher also counts by family); on CPU tensors it runs the plain
version: for K1 the family's eager model and cost through
``ops/rollout.rollout_costs`` and the same per-block partials, for the fleet
robot by robot. Any other placement, dtype, shape or layout raises. There
is no fallback from the device to the plain version.

Noise: ``eps=None`` is the Philox mode (production): ε is generated in the
kernel from (seed, step, it), robot r under its own seed. ``eps`` given is
the injected-ε mode for parity tests: a (T, K, A) tensor, (R, T, K, A) for
the fleet, is read instead.
"""

from __future__ import annotations

import math

import torch

from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.ops import philox
from mppi_gpu_tpu_torch.ops.cost import QuadraticCost
from mppi_gpu_tpu_torch.ops.families import FAMILY_ID, FAMILY_NAMES, MAX_A, FusedFamily
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs

BLOCK = 128          # rollouts per K1 block (kBlock in csrc/mppi_solve.cu)
MAX_ROBOTS = 65535   # K1's grid axis y is the robot (kMaxRobots)
_SMEM_BYTES = 232448 - 1024  # per-block shared memory on Hopper, less static use


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


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
    if goal is not None and not fam.has_goal:
        raise TypeError(f"the {fam.name} family's cost has no goal (its target is built in)")


def block_partials(S: torch.Tensor, eps: torch.Tensor, lam_softmin: float) -> torch.Tensor:
    """K1's per-block partials of one robot's costs S (K,) and noise ε
    (T, K, A): (nb, 2 + T·A), row b holding β_b = min S over block b's real
    rollouts, η_b = Σ e_k with e_k = exp(−(S_k − β_b)/λ), and
    ΔŨ_b[t, a] = Σ e_k ε_k[t, a]. Rollouts past K take no part; a block whose
    real rollouts all cost +inf gives η_b = 0, ΔŨ_b = 0; a NaN S gives a NaN
    β_b. In S's dtype."""
    T, K, A = eps.shape
    nb = -(-K // BLOCK)
    like = dict(dtype=S.dtype, device=S.device)
    valid = (torch.arange(nb * BLOCK, device=S.device) < K).view(nb, BLOCK)
    S_b = torch.full((nb * BLOCK,), math.inf, **like)
    S_b[:K] = S
    S_b = S_b.view(nb, BLOCK)
    beta_b = torch.amin(S_b, dim=1)
    live = valid & (beta_b != math.inf)[:, None]
    e = torch.where(live, torch.exp(-(S_b - beta_b[:, None]) / lam_softmin), 0.0)
    eps_b = torch.zeros(T, nb * BLOCK, A, **like)
    eps_b[:, :K] = eps
    dUt = torch.einsum("tnka,nk->nta", eps_b.view(T, nb, BLOCK, A), e)
    return torch.cat([beta_b[:, None], e.sum(1)[:, None], dUt.reshape(nb, T * A)], 1)


def family_solve_partials_reference(
    fam: FusedFamily, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta,
    eps=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 for one robot: ``(S (K,), partials (nb, 2 + T·A))``
    (:func:`block_partials`), S from the family's eager model and cost on
    the port's noise stream (or the given ε)."""
    T = U.shape[0]
    if eps is None:
        eps = philox.sample_eps(
            seed, step, it, T, K, fam.sigma, antithetic=antithetic, ou_beta=ou_beta
        )
    S = rollout_costs(fam.dynamics, fam.cost_for(goal), x0, U, eps)
    return S, block_partials(S, eps, lam_softmin)


def fleet_family_solve_partials_reference(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta,
    eps=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 for a fleet: the single-robot plain version for
    robot r on (xs[r], Us[r], goals[r], seed r, eps[r]), stacked into
    ``(S (R, K), partials (R, nb, 2 + T·A))``."""
    out = [
        family_solve_partials_reference(
            fam, xs[r], Us[r], None if goals is None else goals[r], lam_softmin, K, seed,
            step, it, antithetic, ou_beta, None if eps is None else eps[r],
        )
        for r, seed in enumerate(_robot_seeds(seeds, Us.shape[0]))
    ]
    return torch.stack([S for S, _ in out]), torch.stack([p for _, p in out])


def _launch_solve_partials(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta,
    eps, R: int, lead: tuple[int, ...],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 for R robots on checked CUDA tensors; the outputs get the
    leading shape `lead`: () for the single-robot wrapper, (R,) for the
    fleet's. Counts the launch, in total and for the family."""
    T, A = Us.shape[-2:]
    if 4 * (1 + BLOCK // 32) * T * A > _SMEM_BYTES:
        raise ValueError(f"T·A = {T * A} exceeds the kernel's shared-memory budget")
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    nb = -(-K // BLOCK)
    per_robot = isinstance(seeds, torch.Tensor)
    S = torch.empty(*lead, K, dtype=torch.float32, device=Us.device)
    partials = torch.empty(*lead, nb, 2 + T * A, dtype=torch.float32, device=Us.device)
    err = lib.mppi_solve_partials(
        fam.fid, xs.data_ptr(), Us.data_ptr(), fam.params.data_ptr(),
        goals.data_ptr() if goals is not None else None,
        seeds.data_ptr() if per_robot else None,
        eps.data_ptr() if eps is not None else None, S.data_ptr(), partials.data_ptr(),
        R, K, T, A, fam.dt, fam.lam_cost, float(lam_softmin),
        *_noise_words(0 if per_robot else int(seeds), step, it), int(antithetic),
        float(ou_beta), _ou_c(ou_beta), _stream(),
    )
    _raise_on(err, f"solve_partials<{fam.name}>")
    _launch_solve_partials.launches += 1
    _launch_solve_partials.family_launches[fam.name] += 1
    return S, partials


_launch_solve_partials.launches = 0
_launch_solve_partials.family_launches = dict.fromkeys(FAMILY_NAMES, 0)


def family_solve_partials(
    fam: FusedFamily, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta,
    eps=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 for one robot of family `fam` (the R = 1 launch of the fleet
    kernel) on CUDA tensors, its plain version on CPU tensors. x0 (S,),
    U (T, A), goal (S,) for a family with a goal, else None; see
    :func:`family_solve_partials_reference` for the outputs."""
    T, A = U.shape if U.dim() == 2 else (-1, -1)
    _check_family(fam, T, A, K, antithetic)
    S_dim = fam.state_dim
    for name, t, shape in (
        ("x0", x0, (S_dim,)), ("U", U, (T, A)),
    ) + ((("goal", goal, (S_dim,)),) if fam.has_goal else ()) + (
        (("eps", eps, (T, K, A)),) if eps is not None else ()
    ):
        _check(name, t, shape)
    _check_goal(fam, goal)
    tensors = (x0, U, fam.params) + ((goal,) if fam.has_goal else ()) + (
        (eps,) if eps is not None else ()
    )
    if not _on_cuda(*tensors):
        return family_solve_partials_reference(
            fam, x0, U, goal, lam_softmin, K, seed, step, it, antithetic, ou_beta, eps,
        )
    return _launch_solve_partials(
        fam, x0, U, goal, lam_softmin, K, int(seed), step, it, antithetic, ou_beta, eps, 1, (),
    )


def fleet_family_solve_partials(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta,
    eps=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 for R robots of family `fam` in one launch on CUDA tensors, its
    plain version on CPU tensors. xs (R, S), Us (R, T, A), goals (R, S) for a
    family with a goal, else None; ``seeds`` an (R,) int64 tensor of
    per-robot seeds or one int for every robot, eps (R, T, K, A) or None; the
    family's parameters, both λ, (step, it), antithetic and OU are shared.
    Returns ``(S (R, K), partials (R, nb, 2 + T·A))``."""
    if Us.dim() != 3:
        raise ValueError(f"Us must be (R, T, A), got {tuple(Us.shape)}")
    R, T, A = Us.shape
    _check_fleet(R)
    _check_family(fam, T, A, K, antithetic)
    S_dim = fam.state_dim
    for name, t, shape in (
        ("xs", xs, (R, S_dim)), ("Us", Us, (R, T, A)),
    ) + ((("goals", goals, (R, S_dim)),) if fam.has_goal else ()) + (
        (("eps", eps, (R, T, K, A)),) if eps is not None else ()
    ):
        _check(name, t, shape)
    _check_goal(fam, goals)
    _check_seeds(seeds, R)
    tensors = (xs, Us, fam.params) + ((goals,) if fam.has_goal else ()) + (
        (eps,) if eps is not None else ()
    ) + ((seeds,) if isinstance(seeds, torch.Tensor) else ())
    if not _on_cuda(*tensors):
        return fleet_family_solve_partials_reference(
            fam, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta, eps,
        )
    return _launch_solve_partials(
        fam, xs, Us, goals, lam_softmin, K, seeds, step, it, antithetic, ou_beta, eps, R, (R,),
    )


# --------------------------------------------------------------------------
# K2: fold of the per-block partials


def softmin_combine_reference(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 for one robot: β = min β_b, f_b = exp((β − β_b)/λ),
    η = Σ f_b η_b, ΔU = Σ f_b ΔŨ_b / η. Returns (β, η, ΔU (T, A))."""
    beta_b, eta_b = partials[:, 0], partials[:, 1]
    beta = torch.min(beta_b)
    f = torch.exp((beta - beta_b) / lam_softmin)
    eta = torch.sum(f * eta_b)
    dU = torch.sum(f[:, None] * partials[:, 2:], dim=0) / eta
    return beta, eta, dU.view(T, A)


def fleet_softmin_combine_reference(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 for a fleet: robot by robot, stacked into
    (β (R,), η (R,), ΔU (R, T, A))."""
    out = [softmin_combine_reference(p, lam_softmin, T, A) for p in partials]
    return tuple(torch.stack(v) for v in zip(*out))


def _launch_softmin_combine(
    partials: torch.Tensor, lam_softmin: float, R: int, T: int, A: int, lead: tuple[int, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (one block per robot) on checked CUDA partials; returns
    (β η (*lead, 2), ΔU (*lead, T, A)). Counts the launch."""
    nb = partials.shape[-2]
    if nb < 1 or 4 * nb > _SMEM_BYTES:
        raise ValueError(f"{nb} partials exceed the combine kernel's shared memory")
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    beta_eta = torch.empty(*lead, 2, dtype=torch.float32, device=partials.device)
    dU = torch.empty(*lead, T, A, dtype=torch.float32, device=partials.device)
    err = lib.mppi_softmin_combine(
        partials.data_ptr(), R, nb, T * A, float(lam_softmin), beta_eta.data_ptr(),
        dU.data_ptr(), _stream(),
    )
    _raise_on(err, "softmin_combine")
    _launch_softmin_combine.launches += 1
    return beta_eta, dU


_launch_softmin_combine.launches = 0


def softmin_combine(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 for one robot's (nb, 2 + T·A) partials (the R = 1 launch) on a CUDA
    tensor, its plain version on a CPU tensor."""
    if partials.dim() != 2:
        raise ValueError(f"partials must be (nb, 2 + T·A), got {tuple(partials.shape)}")
    _check("partials", partials, (partials.shape[0], 2 + T * A))
    if not _on_cuda(partials):
        return softmin_combine_reference(partials, lam_softmin, T, A)
    beta_eta, dU = _launch_softmin_combine(partials, lam_softmin, 1, T, A, ())
    return beta_eta[0], beta_eta[1], dU


def fleet_softmin_combine(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on a CUDA (R, nb, 2 + T·A) tensor, one block per robot; its plain
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


def family_fused_solve_reference(fam: FusedFamily, x0, U, goal, lam_softmin, *args, eps=None):
    """Plain version of :func:`family_fused_solve`."""
    S, partials = family_solve_partials_reference(fam, x0, U, goal, lam_softmin, *args, eps)
    return (S, *softmin_combine_reference(partials, lam_softmin, *U.shape))


def family_fused_solve(fam: FusedFamily, x0, U, goal, lam_softmin, *args, eps=None):
    """One MPPI solve core of family `fam`: ``(S (K,), β, η, ΔU (T, A))``
    with ΔU = Σ_k w_k ε_k for the softmin weights w_k = exp(−(S_k − β)/λ)/η;
    ``args`` are (K, seed, step, it, antithetic, ou_beta) as for
    :func:`family_solve_partials`. Clamp and shift are the caller's
    (``controller.MPPIController``)."""
    S, partials = family_solve_partials(fam, x0, U, goal, lam_softmin, *args, eps)
    return (S, *softmin_combine(partials, lam_softmin, *U.shape))


def fleet_family_fused_solve_reference(
    fam: FusedFamily, xs, Us, goals, lam_softmin, K, seeds, *args, eps=None
):
    """Plain version of :func:`fleet_family_fused_solve`:
    :func:`family_fused_solve_reference` robot by robot, stacked."""
    out = [
        family_fused_solve_reference(
            fam, xs[r], Us[r], None if goals is None else goals[r], lam_softmin, K, seed,
            *args, eps=None if eps is None else eps[r],
        )
        for r, seed in enumerate(_robot_seeds(seeds, Us.shape[0]))
    ]
    return tuple(torch.stack(v) for v in zip(*out))


def fleet_family_fused_solve(fam: FusedFamily, xs, Us, goals, lam_softmin, *args, eps=None):
    """R MPPI solve cores of family `fam` in one launch of K1 and one of K2:
    ``(S (R, K), β (R,), η (R,), ΔU (R, T, A))``; arguments as
    :func:`fleet_family_solve_partials`."""
    S, partials = fleet_family_solve_partials(fam, xs, Us, goals, lam_softmin, *args, eps)
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
    antithetic: bool, ou_beta: float, *, words: bool = False,
):
    """The (T, K, A) ε that K1 consumes in its Philox
    mode for (seed, step, it), in rollout order. With ``words`` also returns
    the (T, K_draw, 4) Philox words of the draws (int64 holding uint32 values)
    for a bit-exact check against ``ops/philox.philox_words``. K3 on a CUDA
    ``sigma``, ``ops/philox.py`` on a CPU one."""
    A = sigma.shape[0] if sigma.dim() == 1 else -1
    _check_problem(T, A, K, antithetic)
    _check("sigma", sigma, (A,))
    K_draw = K // 2 if antithetic else K
    if not _on_cuda(sigma):
        eps = philox.sample_eps(
            seed, step, it, T, K, sigma, antithetic=antithetic, ou_beta=ou_beta
        )
        if not words:
            return eps
        return eps, philox.philox_words(seed, step, it, T, K_draw, sigma.device)
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    eps = torch.empty(T, K, A, dtype=torch.float32, device=sigma.device)
    w_out = (
        torch.empty(T, K_draw, 4, dtype=torch.int32, device=sigma.device)
        if words else None
    )
    err = lib.mppi_noise_dump(
        sigma.data_ptr(), eps.data_ptr(), w_out.data_ptr() if words else None,
        K, T, A, *_noise_words(seed, step, it), int(antithetic), float(ou_beta),
        _ou_c(ou_beta), _stream(),
    )
    _raise_on(err, "noise_dump")
    noise_dump.launches += 1
    if not words:
        return eps
    return eps, w_out.to(torch.int64) & 0xFFFFFFFF


noise_dump.launches = 0

# each CUDA kernel of csrc/mppi_solve.cu and the function that launches it
# (the single-robot and the fleet wrappers share one launcher per kernel)
KERNELS = {
    "solve_partials": _launch_solve_partials,
    "softmin_combine": _launch_softmin_combine,
    "noise_dump": noise_dump,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _launch_solve_partials.family_launches = dict.fromkeys(FAMILY_NAMES, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def family_launch_counts() -> dict[str, int]:
    """K1's launches by family (they add up to ``launch_counts()["solve_partials"]``)."""
    return dict(_launch_solve_partials.family_launches)
