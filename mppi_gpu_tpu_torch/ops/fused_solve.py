"""The fused MPPI solve for the point-mass LTI family with the quadratic cost:
wrappers of the CUDA kernels in ``csrc/mppi_lti.cu`` and their plain
versions.

* :func:`lti_solve_partials` (K1) — rollout, cost and per-block softmin
  partials ``(β_b, η_b, ΔŨ_b)`` over blocks of :data:`BLOCK` rollouts;
* :func:`softmin_combine` (K2) — the associative fold of the partials into
  ``β``, ``η`` and ``ΔU``;
* :func:`fused_solve` — K1 then K2, the controller's ``fused`` backend;
* :func:`noise_dump` (K3) — the ε stream K1 consumed, for the debug dump and
  the replay check; its plain version is ``ops/philox.py``.

Each wrapper launches its kernel when its inputs lie on a CUDA device, and
counts the launch in its ``launches`` attribute; on CPU tensors it runs the
plain version. Any other placement, dtype, shape or layout raises. There is
no fallback from the device to the plain version.

Noise: ``eps=None`` is the Philox mode (production): ε is generated in the
kernel from (seed, step, it). ``eps`` given is the injected-ε mode for parity
tests: a (T, K, A) tensor is read instead.
"""

from __future__ import annotations

import math

import torch

from mppi_gpu_tpu_torch.models.point_mass import PointMassLTI
from mppi_gpu_tpu_torch.ops import philox
from mppi_gpu_tpu_torch.ops.cost import QuadraticCost
from mppi_gpu_tpu_torch.ops.rollout import rollout_costs

BLOCK = 128          # rollouts per K1 block (kBlock in csrc/mppi_lti.cu)
MAX_A = 4            # one Philox call yields four normals
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


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# --------------------------------------------------------------------------
# K1: rollout + cost + per-block softmin partials


def lti_solve_partials_reference(
    x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
    antithetic, ou_beta, eps=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``(S (K,), partials (nb, 2 + T·A))`` with row b
    holding β_b = min S over block b's real rollouts, η_b = Σ e_k with
    e_k = exp(−(S_k − β_b)/λ), and ΔŨ_b[t, a] = Σ e_k ε_k[t, a]. Rollouts past
    K take no part; a block whose real rollouts all cost +inf gives
    η_b = 0, ΔŨ_b = 0."""
    T, A = U.shape
    if eps is None:
        eps = philox.sample_eps(
            seed, step, it, T, K, sigma, antithetic=antithetic, ou_beta=ou_beta
        )
    f32 = dict(dtype=torch.float32, device=U.device)
    dyn = PointMassLTI(torch.tensor(dt, **f32), A)
    cost = QuadraticCost(w, goal, torch.tensor(lam_cost, **f32), inv_s)
    S = rollout_costs(dyn, cost, x0, U, eps)
    nb = -(-K // BLOCK)
    valid = (torch.arange(nb * BLOCK, device=U.device) < K).view(nb, BLOCK)
    S_b = torch.full((nb * BLOCK,), math.inf, **f32)
    S_b[:K] = S
    S_b = S_b.view(nb, BLOCK)
    beta_b = torch.amin(S_b, dim=1)
    live = valid & (beta_b != math.inf)[:, None]
    e = torch.where(live, torch.exp(-(S_b - beta_b[:, None]) / lam_softmin), 0.0)
    eps_b = torch.zeros(T, nb * BLOCK, A, **f32)
    eps_b[:, :K] = eps
    dUt = torch.einsum("tnka,nk->nta", eps_b.view(T, nb, BLOCK, A), e)
    partials = torch.cat([beta_b[:, None], e.sum(1)[:, None], dUt.reshape(nb, T * A)], 1)
    return S, partials


def lti_solve_partials(
    x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
    antithetic, ou_beta, eps=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors; see
    :func:`lti_solve_partials_reference` for the outputs."""
    T, A = U.shape
    _check_problem(T, A, K, antithetic)
    for name, t, shape in (
        ("x0", x0, (2 * A,)), ("U", U, (T, A)), ("sigma", sigma, (A,)),
        ("inv_s", inv_s, (A,)), ("w", w, (2 * A,)), ("goal", goal, (2 * A,)),
    ) + ((("eps", eps, (T, K, A)),) if eps is not None else ()):
        _check(name, t, shape)
    tensors = (x0, U, sigma, inv_s, w, goal) + ((eps,) if eps is not None else ())
    if not _on_cuda(*tensors):
        return lti_solve_partials_reference(
            x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step,
            it, antithetic, ou_beta, eps,
        )
    if 4 * (1 + BLOCK // 32) * T * A > _SMEM_BYTES:
        raise ValueError(f"T·A = {T * A} exceeds the kernel's shared-memory budget")
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    nb = -(-K // BLOCK)
    S = torch.empty(K, dtype=torch.float32, device=U.device)
    partials = torch.empty(nb, 2 + T * A, dtype=torch.float32, device=U.device)
    err = lib.mppi_lti_solve_partials(
        x0.data_ptr(), U.data_ptr(), sigma.data_ptr(), inv_s.data_ptr(),
        w.data_ptr(), goal.data_ptr(), eps.data_ptr() if eps is not None else None,
        S.data_ptr(), partials.data_ptr(), K, T, A, float(dt), float(lam_cost),
        float(lam_softmin), *_noise_words(seed, step, it), int(antithetic),
        float(ou_beta), _ou_c(ou_beta), _stream(),
    )
    _raise_on(err, "lti_solve_partials")
    lti_solve_partials.launches += 1
    return S, partials


lti_solve_partials.launches = 0


# --------------------------------------------------------------------------
# K2: fold of the per-block partials


def softmin_combine_reference(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: β = min β_b, f_b = exp((β − β_b)/λ),
    η = Σ f_b η_b, ΔU = Σ f_b ΔŨ_b / η. Returns (β, η, ΔU (T, A))."""
    beta_b, eta_b = partials[:, 0], partials[:, 1]
    beta = torch.min(beta_b)
    f = torch.exp((beta - beta_b) / lam_softmin)
    eta = torch.sum(f * eta_b)
    dU = torch.sum(f[:, None] * partials[:, 2:], dim=0) / eta
    return beta, eta, dU.view(T, A)


def softmin_combine(
    partials: torch.Tensor, lam_softmin: float, T: int, A: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if partials.dim() != 2:
        raise ValueError(f"partials must be (nb, 2 + T·A), got {tuple(partials.shape)}")
    _check("partials", partials, (partials.shape[0], 2 + T * A))
    if not _on_cuda(partials):
        return softmin_combine_reference(partials, lam_softmin, T, A)
    nb = partials.shape[0]
    if nb < 1 or 4 * nb > _SMEM_BYTES:
        raise ValueError(f"{nb} partials exceed the combine kernel's shared memory")
    from mppi_gpu_tpu_torch.ops._build import load_library

    lib = load_library()
    beta_eta = torch.empty(2, dtype=torch.float32, device=partials.device)
    dU = torch.empty(T, A, dtype=torch.float32, device=partials.device)
    err = lib.mppi_softmin_combine(
        partials.data_ptr(), nb, T * A, float(lam_softmin), beta_eta.data_ptr(),
        dU.data_ptr(), _stream(),
    )
    _raise_on(err, "softmin_combine")
    softmin_combine.launches += 1
    return beta_eta[0], beta_eta[1], dU


softmin_combine.launches = 0


# --------------------------------------------------------------------------
# K1 + K2: the whole solve core


def fused_solve_reference(
    x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
    antithetic, ou_beta, eps=None,
):
    """Plain version of :func:`fused_solve`."""
    S, partials = lti_solve_partials_reference(
        x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
        antithetic, ou_beta, eps,
    )
    return (S, *softmin_combine_reference(partials, lam_softmin, *U.shape))


def fused_solve(
    x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
    antithetic, ou_beta, eps=None,
):
    """One MPPI solve core: ``(S (K,), β, η, ΔU (T, A))`` with ΔU = Σ_k w_k ε_k
    for the softmin weights w_k = exp(−(S_k − β)/λ)/η. Clamp and shift are the
    caller's (``controller.mppi_solve``)."""
    S, partials = lti_solve_partials(
        x0, U, sigma, inv_s, w, goal, lam_cost, lam_softmin, dt, K, seed, step, it,
        antithetic, ou_beta, eps,
    )
    return (S, *softmin_combine(partials, lam_softmin, *U.shape))


# --------------------------------------------------------------------------
# K3: the noise dump


def noise_dump(
    sigma: torch.Tensor, T: int, K: int, seed: int, step: int, it: int,
    antithetic: bool, ou_beta: float, *, words: bool = False,
):
    """The (T, K, A) ε that :func:`lti_solve_partials` consumes in its Philox
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

KERNELS = (lti_solve_partials, softmin_combine, noise_dump)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
