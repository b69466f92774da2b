"""The summed duration of every device activity a frame, in ms, from the
device-only trace of the window."""


def read(run):
    if not run.device_spans or not run.frames:
        return None
    return sum(b - a for a, b, _ in run.device_spans) * 1e3 / len(run.frames)
