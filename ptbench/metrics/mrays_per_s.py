"""The renderer's ray counters (`Profile.total_rays`) summed over the
window's frames, over the window's wall time, in millions a second. The
two light-tracing routes count lens connections by different definitions,
so this compares only within one route."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return sum(f["total_rays"] for f in run.frames) / run.window_s / 1e6
