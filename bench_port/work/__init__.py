"""The least work a control cycle needs, counted from the cell's shapes and
never from the compiled code, and the least time the card needs for it.

Counts are per class: ``fp32`` instructions (an FMA one, at the 128 per SM
and clock behind the published 67 TFLOP/s, which counts an FMA as two
flops), ``int`` (32-bit integer), ``sfu`` (special
functions: log1p, sqrt, sin, cos, rsqrt, each one), ``cvt`` (integer to
float conversions), ``bytes`` (read once and written once) and ``issue``
(every instruction takes one lane-slot of the SMs' issue). Each class's
time is its count over its peak (``bench_port/peaks.json``); the largest is
the bound, and its class is named beside it.

K1's work is its rollout sweep: each of R·K rollouts draws its noise and
steps its model and cost over T steps. The weighted update runs only over
rollouts whose weight is not 0, a count the run does not know, so it is
left out of the bound (as is the per-rollout body's second draw), never
counted dense.
"""

from __future__ import annotations

import importlib
import json
from collections import Counter
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def draw(A: int) -> Counter:
    """One rollout-step's noise: one Philox4x32-10 call (ten rounds of two
    32×32 wide multiplies and two three-input XORs; the counter word k0 + k
    one add; the four words' 8-bit shifts) and ⌈A/2⌉ Box-Muller pairs (two
    conversions, two scalings of 2⁻²⁴, log1p, sqrt, −2·, 2π·, and cos,
    r·cos, sin, r·sin for each normal used), then ε = σ·n."""
    pairs = (A + 1) // 2
    c = Counter(int=10 * (2 + 2) + 1 + 2 * pairs, cvt=2 * pairs, sfu=2 * pairs, fp32=4 * pairs)
    c["sfu"] += A       # cos or sin per normal
    c["fp32"] += A + A  # r·cos / r·sin, then σ·n
    return c


def family(name: str):
    return importlib.import_module(f"bench_port.work.{name}")


def k1_launch(fam: str, R: int, K: int, T: int, A: int, s: int) -> Counter:
    """K1's rollout sweep over R robots of K rollouts and T steps."""
    f = family(fam)
    n = R * K
    c = Counter()
    for k, v in (draw(A) + f.step(A, s)).items():
        c[k] = v * n * T
    for k, v in f.rollout(A, s).items():
        c[k] += v * n
    c["bytes"] += 4 * (R * T * A + R * s + n)  # U and x read, S written
    return c


def issue(c: Counter) -> Counter:
    out = Counter(c)
    out["issue"] = sum(c[k] for k in ("fp32", "int", "sfu", "cvt"))
    return out


def bound(c: Counter) -> tuple[float, str]:
    """(seconds, class) of the least time the card needs for counts `c`."""
    c = issue(c)
    sm = PEAKS["sms"] * PEAKS["boost_hz"]
    times = {k: c[k] / (sm * PEAKS["per_sm_per_clock"][k])
             for k in ("fp32", "int", "sfu", "cvt", "issue")}
    times["bytes"] = c["bytes"] / PEAKS["bytes_per_s"]
    cls = max(times, key=times.get)
    return times[cls], cls

