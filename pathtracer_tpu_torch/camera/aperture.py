"""Aperture shapes: circular and bladed (counterpart of `camera/aperture.py`).

The unit-disk sample is warped by the polygon's radial profile, so no
sample is rejected."""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.core.sampling import random_in_unit_disk


def sample_aperture(u1, u2, radius, blades, sharpness):
    """Point on the aperture: unit disk warp -> polygon blend. blades < 3 is
    a circular aperture; `sharpness` in [0,1] pulls in the polygon edge."""
    disk = random_in_unit_disk(u1, u2)
    blades_f = max(float(blades), 3.0)
    phi = torch.atan2(disk[..., 1], disk[..., 0])
    seg = 2.0 * math.pi / blades_f
    a = torch.remainder(phi, seg) - seg / 2.0
    poly = math.cos(math.pi / blades_f) / torch.cos(a)
    t = min(max(float(sharpness), 0.0), 1.0) if int(blades) >= 3 else 0.0
    r_scale = (1.0 - t) + t * poly
    return disk * (r_scale * radius)[..., None]
