"""The sharded combine of the one-pass branch: device µs per control cycle
of K2 unnormalized (``softmin_combine_kernel``), K8 (``sharded_scale``) and
K9 (``sharded_tail``: ΔU = Σ/η, the tail and the world's step) in rank 0's
trace. They are latency-bound, so no roofline of their own."""

from bench_port import trace

COMBINE = r"^(softmin_combine_kernel|sharded_scale_kernel|sharded_tail_kernel)\b"


def read(run):
    if run.trace is None:
        return None
    n, us = trace.device_us(run.trace, COMBINE)
    return us / run.window.cycles if n else None
