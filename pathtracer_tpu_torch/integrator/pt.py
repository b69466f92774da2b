"""Integrator settings (the `PTSettings` part of `integrator/pt.py`).

The port's path tracer is the megakernel's regen loop
(`kernels/megakernel.py`: the fused round and the two-program round); the
XLA wavefront and regen integrators are still to be ported (ROADMAP §1
items 5 and 8). The light tracer is `integrator/lt.py` with
`kernels/lt_mega.py`. `medium_aware` turns on the tracked-medium transport
of the two-program and split rounds.
"""

from __future__ import annotations

import dataclasses

from pathtracer_tpu_torch.core.bounds import BOUNDED_VISIBLE_RANGE, Bounds1D


@dataclasses.dataclass(frozen=True)
class PTSettings:
    """Static per-render integrator settings."""

    max_bounces: int = 8
    min_bounces: int = 1  # russian-roulette start index
    light_samples: int = 1
    russian_roulette: bool = True
    only_direct: bool = False
    medium_aware: bool = False
    hwss: bool = False  # hero-wavelength x4
    wavelength_bounds: Bounds1D = BOUNDED_VISIBLE_RANGE

