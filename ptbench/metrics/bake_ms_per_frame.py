"""The self time of the program's `bake` spans a frame, in ms: the
per-call bake of the megakernel scene (`build_mega_scene`, `camera.to`;
the LT megakernel's `build_lt_scene`), less the gate it holds. A program
span, recorded in a `--trace 1` window."""

from ptbench import spans


def read(run):
    return spans.per_frame_ms(run, "bake")
