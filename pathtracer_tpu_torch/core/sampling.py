"""Stateless sampling primitives (counterpart of `core/sampling.py`).

The JAX package draws threefry streams folded from a key; the port draws
its uniforms outside these functions (see `kernels/megakernel.TorchUniforms`)
and keeps only the warps from uniforms to samples.
"""

from __future__ import annotations

import math

import torch


def random_in_unit_disk(u, v):
    """Polar mapping: radius sqrt(u), angle 2πv -> [..., 2]."""
    r = torch.sqrt(u)
    phi = 2.0 * math.pi * v
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def power_cosine_direction(u, v, n):
    """A direction with pdf ∝ cosⁿθ about +z -> [..., 3]."""
    cos_t = torch.pow(u, 1.0 / (n + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * v
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)
