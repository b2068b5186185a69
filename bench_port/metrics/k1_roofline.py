"""K1 ``solve_partials`` (either body) against its least time: the counted
rollout sweep of one launch (``bench_port.work.k1_launch``) over K1's mean
device time per launch in the trace."""

from bench_port import trace, work

K1 = r"^(solve_partials_kernel|slab_partials_kernel)<"


def read(run):
    if run.trace is None:
        return None
    n, us = trace.device_us(run.trace, K1)
    if not n:
        return None
    least, _ = work.bound(run.k1_launch)
    return 100.0 * least * n / (us * 1e-6)
