"""Stateless sampling primitives (counterpart of `core/sampling.py`).

The JAX package draws threefry streams folded from a key (`fold`,
`uniform`, `sample_2d`); the port draws its uniforms outside these
functions (see `kernels/megakernel.TorchUniforms`) and keeps only the warps
from uniforms to samples.
"""

from __future__ import annotations

import math

import torch


def choose(u, p):
    """Branch on u < p and rescale u to [0, 1) within the chosen branch ->
    (below mask, rescaled u)."""
    if not isinstance(p, torch.Tensor):
        p = torch.tensor(p, dtype=u.dtype)
    below = u < p
    u_new = torch.where(below, u / torch.clamp(p, min=1e-12),
                        (u - p) / torch.clamp(1.0 - p, min=1e-12))
    return below, torch.clamp(u_new, 0.0, 1.0 - 1e-7)


def random_cosine_direction(u, v):
    """A cosine-weighted direction about +z (pdf z / π) -> [..., 3]."""
    r = torch.sqrt(u)
    phi = 2.0 * math.pi * v
    z = torch.sqrt(torch.clamp(1.0 - u, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def random_on_unit_sphere(u, v):
    """A uniform direction on the unit sphere -> [..., 3]."""
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * v
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


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
