"""100 x the valid splats the LT megakernel's kernels added to the film
over the entries of its splat rows ((camera samples + 2) x lanes a round):
the program's counters `splats_added` and `splat_slots`, summed over the
window, in %."""

from ptbench import spans


def read(run):
    return spans.splat_share(run)
