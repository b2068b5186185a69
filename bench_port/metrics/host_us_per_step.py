"""The host loop's host time per step: each step's wall time less the device
busy time inside it (the copies into the solve graph's buffers, its
replay's launch, the read-back and the plant). The wall time is the same
loop's just before the trace, untraced (the tracer records every host
operation, ~0.3 ms a step); the busy time is the trace's."""


def read(run):
    t, w, plain = run.trace, run.window, run.untraced
    if t is None or not w.latencies_s or not plain.cycles:
        return None
    return (plain.wall_s / plain.cycles - t.busy_s / w.cycles) * 1e6
