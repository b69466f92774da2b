"""Rayleigh scattering medium (counterpart of `mediums/rayleigh.py`): a
λ⁻⁴ scattering coefficient from an IOR curve with a corrective factor, the
phase (1 + cos²θ)·3/(16π) and its cube-root inverse-transform sampling."""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.mediums.hg import about_axis


def rayleigh_sigma_s(ior, lam_nm, number_density_factor):
    """Scattering coefficient ∝ (n² - 1)² / λ⁴, times a scene-tunable
    factor standing in for the number density."""
    lam_m = lam_nm * 1e-9
    n2m1 = ior * ior - 1.0
    lam2 = lam_m * lam_m
    return number_density_factor * (n2m1 * n2m1) / torch.clamp(
        lam2 * lam2, min=1e-40) * 1e-32


def rayleigh_phase(cos_theta):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)


def rayleigh_sample_cos(u):
    """Inverse CDF of the Rayleigh phase: the real root of
    (3c + c³ + 4)/8 = u by Cardano. torch has no cbrt; the radicand
    z + sqrt(z² + 1) is positive, so a power takes its place (equal to a
    cube root within a few ulp, not to the last bit)."""
    z = 2.0 * (2.0 * u - 1.0)
    w = (z + torch.sqrt(z * z + 1.0)) ** (1.0 / 3.0)
    return torch.clamp(w - 1.0 / w, -1.0, 1.0)


def rayleigh_sample_direction(wi, u1, u2):
    cos_t = rayleigh_sample_cos(u1)
    return about_axis(wi, cos_t, u2), rayleigh_phase(cos_t)
