"""The exchange: device µs per control cycle of NCCL's kernels in rank 0's
trace, the time a collective waits for the slowest rank included."""

from bench_port import trace

NCCL = r"^ncclDevKernel|^ncclKernel"


def read(run):
    if run.trace is None:
        return None
    n, us = trace.device_us(run.trace, NCCL)
    return us / run.window.cycles if n else None
