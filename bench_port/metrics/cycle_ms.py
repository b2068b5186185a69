"""The window's wall time over the control cycles completed in it (an
episode window ends on an episode's end; a host-loop cycle is one step,
the plant's included)."""


def read(run):
    w = run.window
    return w.wall_s * 1e3 / w.cycles if w.cycles else None
