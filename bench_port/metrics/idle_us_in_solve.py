"""Device-idle µs per host-loop step while the host is inside the port's
``solve`` span, in the window traced with the port's spans
(``bench_port.spans``): the key and the copies in before the replay gives
the device work."""

from bench_port import spans


def read(run):
    t, w = getattr(run, "span_trace", None), getattr(run, "span_window", None)
    if t is None or not w.cycles or not any(s.name == "solve" for s in run.spans):
        return None
    return spans.solve_idle_ns(run.spans, t)[0] / w.cycles / 1e3
