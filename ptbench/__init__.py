"""The benchmark of `pathtracer_tpu_torch` (see `run.py`)."""
