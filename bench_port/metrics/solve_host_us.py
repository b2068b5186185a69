"""Host µs per host-loop step inside the port's ``solve`` span
(``graphs.graphed_solve``: the key, the copies in, the replay's launch, the
copy out), in the window traced with the port's spans: the inside
counterpart of ``host_us_per_step``."""


def read(run):
    w = getattr(run, "span_window", None)
    solves = [s for s in getattr(run, "spans", ()) if s.name == "solve" and s.end_ns is not None]
    if w is None or not w.cycles or not solves:
        return None
    return sum(s.end_ns - s.start_ns for s in solves) / w.cycles / 1e3
