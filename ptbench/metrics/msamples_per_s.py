"""Pixel samples (path samples for path tracing, light paths for light
tracing) of every frame completed in the window, over the window's whole
wall time, in millions a second."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return len(run.frames) * run.samples_per_frame / run.window_s / 1e6
