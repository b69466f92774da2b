"""`bake_ms_per_frame` in the host-bound cells, whose end-to-end metrics carry bounds
of their own (their runs spread more than the device-bound cells')."""

from ptbench.metrics.bake_ms_per_frame import read  # noqa: F401
