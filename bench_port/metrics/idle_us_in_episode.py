"""Device-idle µs per control cycle between the records of one episode, in
the window traced with the port's spans (``bench_port.spans``): the gaps
between a replay's graph nodes and between replays."""

from bench_port import spans


def read(run):
    t, w = getattr(run, "span_trace", None), getattr(run, "span_window", None)
    if t is None or not w.cycles or not any(s.name == "episode" for s in run.spans):
        return None
    return spans.episode_idle_ns(run.spans, t)[1] / w.cycles / 1e3
