"""The renderer's bounce rounds a frame (its `stats["rounds"]`, an exact
count), the mean over the window's frames."""


def read(run):
    r = [f["rounds"] for f in run.frames if f["rounds"] is not None]
    return sum(r) / len(r) if r else None
