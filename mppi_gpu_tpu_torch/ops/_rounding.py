"""The float32 factor by which torch's CUDA division of a float32 tensor by a
Python float multiplies, for the kernels that repeat such a division bit for
bit: K7's weights (the division by λ, ``ops/solve_tail.py``) and K6's packs
(the worlds' divisions by their parameters, ``ops/world_step.pack_fields``),
which K2's epilogue runs too.

torch divides a CUDA tensor by a CPU scalar c as a product with a reciprocal
computed once on the host. On an NVIDIA H100 with torch 2.11 (CUDA 12.8) that
reciprocal is 1/c in double rounded once to float32, not 1.0f/(float)c:
``chip_smoke.py``'s ``reciprocal_probe`` compares both with torch's quotient
over 2²⁰ values, at every divisor the worlds pack and at λ = 1.1, 1.7, 0.064
and 1/3, where the two floats differ for some. On the CPU torch divides
truly, so this factor concerns the card alone.
"""

from __future__ import annotations

import numpy as np


def scalar_reciprocal(c: float) -> float:
    """float32(1/c): the factor torch's CUDA ``x / c`` multiplies a float32
    tensor x by, for a Python float c."""
    return float(np.float32(1.0 / c))
