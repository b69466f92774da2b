"""The share of the traced window's wall time in which no device activity
ran: 100 * (1 - union of the activity intervals / window), in %."""

from ptbench import tracing


def read(run):
    if not run.device_spans or run.window_s <= 0:
        return None
    lo = run.window_start
    busy = tracing.busy_seconds(run.device_spans, lo, lo + run.window_s)
    return 100.0 * (1.0 - busy / run.window_s)
