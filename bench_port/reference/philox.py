"""The controller's noise stream, written again from its definition:
Philox4x32-10 (Salmon et al., SC'11) under the key (seed low word, seed high
word), counter (k, t, control step, opt iteration), then Box-Muller on 24-bit
uniforms: u = (w >> 8) · 2⁻²⁴, r = sqrt(−2 log1p(−u1)), θ = 2π u2, the pair
(r cos θ, r sin θ) from words (0, 1) and the next from words (2, 3).

A fleet's robot r draws the same stream under its own seed, the two Philox
words at counter (r, 2³² − 1, 0, 0) under the base key, read as a signed
64-bit integer.

uint32 words live in int64 tensors; each 32×32 product is taken on 16-bit
limbs so that nothing leaves int64. The float part runs in `dtype`.
"""

from __future__ import annotations

import math

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
SEED_T = MASK  # counter word t of the fleet's seed draws


def _mul(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m · b."""
    mh, ml = m >> 16, m & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = mh * bl + ml * bh
    s = ml * bl + ((mid & 0xFFFF) << 16)
    return (mh * bh + (mid >> 16) + (s >> 32)) & MASK, s & MASK


def philox(c0, c1, c2, c3, k0, k1):
    """Ten rounds; every argument an int64 tensor of uint32 words (or an int)."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        h0, l0 = _mul(M0, c0)
        h1, l1 = _mul(M1, c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def key_words(seeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) key words of int64 seeds, two's complement."""
    return seeds & MASK, (seeds >> 32) & MASK


def fleet_seeds(seed: int, R: int) -> torch.Tensor:
    """(R,) int64 robot seeds under the base `seed`."""
    seed &= (1 << 64) - 1
    i64 = dict(dtype=torch.int64)
    full = lambda v: torch.full((R,), v, **i64)  # noqa: E731
    w0, w1, _, _ = philox(torch.arange(R, **i64), full(SEED_T), full(0), full(0),
                          seed & MASK, seed >> 32)
    return (w1 - ((w1 >> 31) << 32)) * (1 << 32) + w0


def normals(seeds: torch.Tensor, step, it: int, T: int, K: int, A: int,
            dtype=torch.float32) -> torch.Tensor:
    """(Rs, T, K, A) standard normals of robots with int64 `seeds` (Rs,) at
    control step `step` (an int, or a 0-dim int64 tensor) and iteration `it`,
    drawn in float32 and handed over in `dtype`."""
    dev = seeds.device
    i64 = dict(dtype=torch.int64, device=dev)
    shape = (seeds.shape[0], T, K)
    k = torch.arange(K, **i64).expand(shape)
    t = torch.arange(T, **i64)[:, None].expand(shape)
    s = torch.as_tensor(step, **i64).expand(shape) & MASK
    i = torch.full(shape, it & MASK, **i64)
    lo, hi = key_words(seeds)
    w = philox(k, t, s, i, lo[:, None, None], hi[:, None, None])
    u = [(x >> 8).to(torch.float32) * (2.0 ** -24) for x in w]
    out = []
    for p in range((A + 1) // 2):
        r = torch.sqrt(-2.0 * torch.log1p(-u[2 * p]))
        th = u[2 * p + 1] * (2.0 * math.pi)
        out += [r * torch.cos(th), r * torch.sin(th)]
    return torch.stack(out[:A], dim=-1).to(dtype)
