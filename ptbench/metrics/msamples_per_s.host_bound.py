"""`msamples_per_s` in the host-bound cells, whose end-to-end metrics carry bounds
of their own (their runs spread more than the device-bound cells')."""

from ptbench.metrics.msamples_per_s import read  # noqa: F401
