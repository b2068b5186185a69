"""The port's noise stream: Philox4x32-10 + Box-Muller, in plain torch.

This is the plain version of the CUDA noise-dump kernel (K3,
``csrc/mppi_solve.cu``) and the stream the fused solve kernel (K1) draws in its
Philox mode; both must reproduce it. It replaces the JAX package's key-based
samplers (``controller.sample_noise``) and the TPU's on-chip PRNG
(``pallas_rollout._standard_normal``), neither of which a GPU can replay, so
the port is held to its own stream (dump + replay), not to the TPU's bits.

Stream definition:

* key = (seed low word, seed high word); counter = (k0 + k, t, step, it)
  for the drawing rollout k, horizon step t, control step and
  opt-iteration; the draw offset k0 is 0 on one GPU, and a rank of the
  sharded solve draws its K/n rollouts at k0 = rank · K/n (rank · K/2n
  under antithetic), so the ranks together draw this stream at K;
* one Philox4x32-10 call per (k, t) gives four uint32 words, hence up to
  A ≤ 4 normals through two Box-Muller pairs — words (0, 1) give normals 0
  and 1, words (2, 3) normals 2 and 3 — from 24-bit uniforms
  ``u = (w >> 8) · 2⁻²⁴``: ``r = sqrt(−2·log1p(−u1))``, ``θ = 2π·u2``,
  ``(r cos θ, r sin θ)``, the formulas of ``pallas_rollout._standard_normal``;
* ``antithetic``: only rollouts k < K/2 draw; rollout K/2 + k is −ε_k (the
  scan path's convention, ``controller.sample_noise``);
* OU noise: e_0 = ν_0, e_t = β e_{t−1} + √(1−β²) ν_t, then ε = σ·e.

Fleets: robot r draws the stream above under its own seed ``fleet_seeds(seed,
R)[r]`` (:func:`fleet_seeds`), so its noise is exactly the single-robot
stream of that seed, whatever the fleet around it.

uint32 words live in int64 tensors. The 32×32→64 multiply of a Philox round
would overflow int64, so it runs on 16-bit limbs (:func:`_mulhilo`).
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi
_INV_2_24 = 2.0**-24


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant m and the
    uint32 words in b (int64 tensor), from 16-bit limbs so that no partial
    product leaves int64."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    p = m_lo * b_lo                    # < 2^32
    mid = m_hi * b_lo + m_lo * b_hi    # < 2^33
    s = p + ((mid & 0xFFFF) << 16)     # < 2^33
    lo = s & _MASK32
    hi = (m_hi * b_hi + (mid >> 16) + (s >> 32)) & _MASK32
    return hi, lo


def philox4x32(
    ctr: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[int, int],
    rounds: int = 10,
) -> tuple[torch.Tensor, ...]:
    """Philox4x32-R (Salmon et al., SC'11; Random123) on int64 tensors
    holding uint32 words. Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draw_offset(k0: int) -> int:
    """`k0` as counter word 0 of the first draw, or ``ValueError`` when it is
    not a 32-bit word (the draw index k0 + k wraps modulo 2³², as in K1)."""
    if not 0 <= k0 < 1 << 32:
        raise ValueError(f"the draw offset k0 is a 32-bit counter word, got {k0}")
    return int(k0)


def philox_words(
    seed: int, step: int, it: int, T: int, K_draw: int, device: torch.device | str,
    k0: int = 0,
) -> torch.Tensor:
    """(T, K_draw, 4) int64: the four uint32 words of counter
    (k0 + k, t, step, it) under key (seed low, seed high)."""
    k0 = draw_offset(k0)
    seed &= (1 << 64) - 1
    key = (seed & _MASK32, seed >> 32)
    i64 = dict(dtype=torch.int64, device=device)
    k = ((torch.arange(K_draw, **i64) + k0) & _MASK32).expand(T, K_draw)
    t = torch.arange(T, **i64)[:, None].expand(T, K_draw)
    c2 = torch.full((T, K_draw), step & _MASK32, **i64)
    c3 = torch.full((T, K_draw), it & _MASK32, **i64)
    return torch.stack(philox4x32((k, t, c2, c3), key), dim=-1)


def box_muller(words: torch.Tensor, A: int) -> torch.Tensor:
    """(..., 4) uint32 words → (..., A) float32 standard normals, A ≤ 4."""
    if not 1 <= A <= 4:
        raise ValueError(f"one Philox call yields at most 4 normals, got A={A}")
    u = (words >> 8).to(torch.float32) * _INV_2_24  # 24-bit uniforms in [0, 1)
    out = []
    for pair in range((A + 1) // 2):
        u1, u2 = u[..., 2 * pair], u[..., 2 * pair + 1]
        r = torch.sqrt(-2.0 * torch.log1p(-u1))
        th = u2 * _TWO_PI
        out += [r * torch.cos(th), r * torch.sin(th)]
    return torch.stack(out[:A], dim=-1)


def normals_to_eps(
    nu: torch.Tensor,      # (T, K_draw, A) standard normals
    sigma: torch.Tensor,   # (A,)
    *,
    antithetic: bool,
    ou_beta: float,
) -> torch.Tensor:
    """The step "normals → ε": OU recursion over t, σ scale, antithetic mirror.
    Returns (T, K, A) with K = 2·K_draw under ``antithetic``."""
    if ou_beta > 0.0:
        c = (1.0 - ou_beta**2) ** 0.5
        e = [nu[0]]
        for t in range(1, nu.shape[0]):
            e.append(ou_beta * e[-1] + c * nu[t])
        nu = torch.stack(e)
    eps = sigma * nu
    if antithetic:
        eps = torch.cat([eps, -eps], dim=1)
    return eps


def sample_eps(
    seed: int,
    step: int,
    it: int,
    T: int,
    K: int,
    sigma: torch.Tensor,
    *,
    antithetic: bool = False,
    ou_beta: float = 0.0,
    k0: int = 0,
) -> torch.Tensor:
    """(T, K, A) ε of the stream for (seed, step, it), on sigma's device,
    drawn from counter word k0 on."""
    if antithetic and K % 2:
        raise ValueError(f"antithetic sampling needs an even K, got {K}")
    K_draw = K // 2 if antithetic else K
    words = philox_words(seed, step, it, T, K_draw, sigma.device, k0)
    nu = box_muller(words, sigma.shape[0])
    return normals_to_eps(nu, sigma, antithetic=antithetic, ou_beta=ou_beta)


# counter word t of the per-robot seed draws; a solve's t stays below T < 2³² − 1
FLEET_SEED_T = _MASK32


def fleet_seeds(seed: int, R: int) -> torch.Tensor:
    """(R,) int64 per-robot seeds for a fleet under the base ``seed`` (the
    port's ``jax.random.split(key, R)``). Robot r's seed is the pair of
    Philox words (w0, w1) at counter (r, 2³² − 1, 0, 0) under the base key,
    w1 the high word, read as a signed int64. No solve draws at t = 2³² − 1,
    so the robots' keys are drawn apart from every noise word of the base
    stream; being 64-bit Philox outputs they are distinct from each other
    and from the base seed except with negligible probability. A pure
    function of (seed, r): robot r's seed does not depend on R."""
    if R < 1:
        raise ValueError(f"a fleet has R >= 1 robots, got {R}")
    seed &= (1 << 64) - 1
    i64 = dict(dtype=torch.int64)
    full = lambda v: torch.full((R,), v, **i64)  # noqa: E731
    w0, w1, _, _ = philox4x32(
        (torch.arange(R, **i64), full(FLEET_SEED_T), full(0), full(0)),
        (seed & _MASK32, seed >> 32),
    )
    hi = w1 - ((w1 >> 31) << 32)  # the high word as a signed int32
    return hi * (1 << 32) + w0
