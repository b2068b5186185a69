"""Device-idle µs per control cycle between one episode's last device record
and the next one's first, in the window traced with the port's spans
(``bench_port.spans``): an episode's records start after its
``episode.replay`` span opens and end before its ``episode.read_back`` span
closes. The host's work between episodes: the histories read back, the next
episode's world, key and copies in."""

from bench_port import spans


def read(run):
    t, w = getattr(run, "span_trace", None), getattr(run, "span_window", None)
    if t is None or not w.cycles or not any(s.name == "episode" for s in run.spans):
        return None
    return spans.episode_idle_ns(run.spans, t)[0] / w.cycles / 1e3
