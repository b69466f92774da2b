"""The self time of the program's `feed` spans a frame, in ms: the host's
issue of the torch chains that feed the round kernels (`tex_feed`,
`env_feed`, `med_feed`, the LT spawn feed). A program span, recorded in a
`--trace 1` window; in the host-bound cells, whose feeds set the pace."""

from ptbench import spans


def read(run):
    return spans.per_frame_ms(run, "feed")
