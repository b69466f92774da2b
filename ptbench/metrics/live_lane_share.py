"""100 x the lanes alive at their round's start over the lanes the
megakernel rounds launched (the program's counters `lanes_live` and
`lanes_launched`, one value a round, summed over the window), in %. The
rest of the lane-rounds run dead lanes: the regen tail, the LT lanes that
wait for a respawn."""

from ptbench import spans


def read(run):
    return spans.live_lane_share(run)
