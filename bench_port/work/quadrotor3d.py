"""The 3-D quadrotor (s = 13, A = 4), per rollout-step and per rollout.

Derivatives, once: F/m (1 mul by 1/m), 2·F/m (1); v̇: x and y 2 each + 1
mul, z: qx² + qy² (2), 1 − 2·(·) (1 FMA), ·F/m (1), − g (1) → 12; q̇: four
components of three products (1 mul, 2 FMA) and ½· (1) → 16; ω̇: ω_j ω_k
(1), τ − c·(·) (1 FMA), ·(1/J) (1) per axis → 9. 37 in all, twice per step.
Step: u = U + ε (4 adds); the midpoint's v, q, ω (3 + 4 + 3 FMA); q at the
end (4 FMA); its squared norm (1 mul, 3 FMA), one rsqrt (sfu) and 4 muls;
p, v, ω at the end (3 + 3 + 3 FMA).  Cost: λ Σ U_i ε_i (4 FMA, 1 mul);
position and velocity 2·3 × (sub, mul, FMA); tilt (1 mul, 1 FMA, 1 FMA
with its weight); |ω|² (1 mul, 2 FMA) and its weight (1 FMA); the running
sum (1 add).
"""

from collections import Counter

_DERIVS = 2 + 12 + 16 + 9


def step(A: int, s: int) -> Counter:
    model = 4 + 2 * _DERIVS + 10 + 4 + 4 + 4 + 9
    cost = 5 + 18 + 3 + 4 + 1
    return Counter(fp32=model + cost, sfu=1)


def rollout(A: int, s: int) -> Counter:
    """The final state cost once more and its add."""
    return Counter(fp32=18 + 3 + 4 + 1)
