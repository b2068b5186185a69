"""The share of the traced window in which no kernel or copy ran on the
device: one less the union of the device records' intervals over the
window."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.span_s)
