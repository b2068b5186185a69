"""The whole cycle against the card's peak: the least time the card needs for
the cycle's counted work (every K1 launch of it; the update, whose size the
run does not know, left out) over the traced window's time per cycle."""

from bench_port import work


def read(run):
    if run.trace is None or not run.window.cycles:
        return None
    least, _ = work.bound(run.cycle_work)
    return 100.0 * least * run.window.cycles / run.trace.span_s
