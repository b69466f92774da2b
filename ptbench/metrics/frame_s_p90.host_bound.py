"""`frame_s_p90` in the host-bound cells, whose end-to-end metrics carry bounds
of their own (their runs spread more than the device-bound cells')."""

from ptbench.metrics.frame_s_p90 import read  # noqa: F401
