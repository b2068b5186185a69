"""The 95th percentile, over every step of the window, of the host clock from
the state handed to the controller to the action in a host array."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
