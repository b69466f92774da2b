"""Seconds from the process's start (the harness's first line) to the
window's: imports, the kernel library's load (and its nvcc build, in a
checkout's first run: the result's `device.build_s` gives that part
apart), the scene's build on the card and one warm-up frame."""


def read(run):
    return run.setup_s
