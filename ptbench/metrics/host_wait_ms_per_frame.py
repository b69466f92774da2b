"""The self time of the program's `wait` spans a frame, in ms: the host
blocked on the device at each alive check of the round loop and at the
counters' fetch that ends the call. A program span, recorded in a
`--trace 1` window."""

from ptbench import spans


def read(run):
    return spans.per_frame_ms(run, "wait")
