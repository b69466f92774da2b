"""Henyey-Greenstein homogeneous participating medium (counterpart of
`mediums/hg.py`): the phase function, inverse-CDF cosθ sampling, the
exponential free flight and Beer-Lambert transmittance, as plain functions
on tensors."""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.kernels.cmath import V3, orthonormal_basis


def hg_phase(g, cos_theta):
    """HG phase p(cosθ), θ between the incoming and outgoing propagation
    directions; forward peak at cosθ = +1 for g > 0. Normalised over the
    sphere."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return (1.0 - g2) / torch.clamp(
        4.0 * math.pi * denom * torch.sqrt(torch.clamp(denom, min=1e-12)),
        min=1e-12)


def hg_sample_cos(g, u):
    """Inverse-CDF sample of cosθ (isotropic below |g| = 1e-4): u = 0 is
    backward (-1), u = 1 forward (+1)."""
    iso = 2.0 * u - 1.0
    big = torch.abs(g) > 1e-6
    sq = (1.0 - g * g) / torch.where(big, 1.0 - g + 2.0 * g * u, 1.0)
    aniso = (1.0 + g * g - sq * sq) / torch.where(big, 2.0 * g, 1.0)
    return torch.clamp(torch.where(torch.abs(g) < 1e-4, iso, aniso), -1.0,
                       1.0)


def about_axis(wi, cos_t, u2):
    """The direction at polar cosine `cos_t` and azimuth 2π·u2 about the
    axis wi [..., 3], in the Frisvad/Duff frame of `kernels/cmath.py` (the
    JAX package's `vecmath.orthonormal_basis`)."""
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    w = V3(*wi.unbind(-1))
    t_ax, b_ax = orthonormal_basis(w)
    sc, ss = sin_t * torch.cos(phi), sin_t * torch.sin(phi)
    return torch.stack([sc * t + ss * b + cos_t * a
                        for t, b, a in zip(t_ax, b_ax, w)], dim=-1)


def hg_sample_direction(g, wi, u1, u2):
    """A scattered direction about the incoming direction wi [..., 3] ->
    (wo, phase pdf); for HG the pdf is the phase value."""
    cos_t = hg_sample_cos(g, u1)
    return about_axis(wi, cos_t, u2), hg_phase(g, cos_t)


def beer_lambert_tr(sigma_t, dist):
    return torch.exp(-sigma_t * dist)


def sample_free_flight(sigma_s, u):
    """Exponential distance sampling from the scattering coefficient (inf
    where sigma_s is 0)."""
    return torch.where(
        sigma_s > 1e-12,
        -torch.log(torch.clamp(1.0 - u, min=1e-12))
        / torch.clamp(sigma_s, min=1e-12), float("inf"))
