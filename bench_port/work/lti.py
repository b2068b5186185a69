"""The point mass on A axes (state s = 2A), per rollout-step and per rollout.

Step, per axis: u = U + ε (1 add); q' = q + dt·q̇ + (dt²/2)·u (2 FMA);
q̇' = q̇ + dt·u (1 FMA).  Cost: λ Σ_i U_i ε_i (A FMA, 1 mul); Σ_j w_j d_j²
with d = x' − g (s subs, s muls, s FMA); the running sum (1 add).
"""

from collections import Counter


def step(A: int, s: int) -> Counter:
    return Counter(fp32=4 * A + (A + 1) + 3 * s + 1)


def rollout(A: int, s: int) -> Counter:
    """The final state cost once more and its add."""
    return Counter(fp32=3 * s + 1)
