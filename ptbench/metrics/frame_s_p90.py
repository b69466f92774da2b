"""The 90th percentile of the window's frame times, from the entry's call
to the film on the host, in seconds (linear interpolation between order
statistics)."""

import numpy as np


def read(run):
    if not run.frames:
        return None
    t = [f["t_host"] - f["t_call"] for f in run.frames]
    return float(np.percentile(np.asarray(t, np.float64), 90))
