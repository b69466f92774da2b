"""`live_lane_share` in the host-bound cells, whose end-to-end metrics carry bounds
of their own (their runs spread more than the device-bound cells')."""

from ptbench.metrics.live_lane_share import read  # noqa: F401
