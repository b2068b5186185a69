"""K2' ``combine_tail`` (the fold, the tail and the world's step): its device
µs per control cycle in the trace."""

from bench_port import trace


def read(run):
    if run.trace is None:
        return None
    n, us = trace.device_us(run.trace, r"^combine_tail_kernel<")
    return us / run.window.cycles if n else None
