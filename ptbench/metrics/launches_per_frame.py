"""Device activities (kernels and copies) a frame, from the device-only
torch.profiler trace of the window."""


def read(run):
    if not run.device_spans or not run.frames:
        return None
    return len(run.device_spans) / len(run.frames)
