"""Shared constants and tiny helpers (counterpart of `pathtracer_tpu.prelude`)."""

from __future__ import annotations

import enum

import torch

# Visually-loud error color used to flag NaN/invalid pixels.
MAUVE_XYZ = (0.5199467, 0.3772858, 0.7161815)

# Geometric offsets against self-intersection.
NORMAL_OFFSET = 1e-3
INTERSECTION_TIME_OFFSET = 1e-6

# Default ray tmax ("infinity").
RAY_TMAX = 1e9


class TransportMode(enum.IntEnum):
    """Radiance (light -> camera) vs Importance (camera -> light) transport."""

    Importance = 0
    Radiance = 1


def power_heuristic(a, b):
    """Balance heuristic a/(a+b) (named as in the reference)."""
    return a / (a + b)


def safe_div(num, den, default=0.0):
    """num/den with den==0 mapped to `default` (no NaN/inf). `default` goes
    to `torch.where` as a Python number: a tensor made of it on the card
    would be a copy from the host, which waits for the card."""
    den_ok = den != 0.0
    q = num / torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, q, default)
