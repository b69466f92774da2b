"""Spectral arithmetic of the plain reference, frozen here: the scene
file's curve kinds evaluated in closed form, and the CIE 1931 colour
matching functions as the multi-lobe Gaussian fits of Wyman, Sloan and
Shirley (JCGT 2013), which the renderer's film uses."""

from __future__ import annotations

import numpy as np
import torch

# wavelengths a path samples, uniformly, in nm
LAMBDA_LO, LAMBDA_HI = 380.0, 780.0

_H, _C, _KB = 6.62607015e-34, 2.99792458e8, 1.380649e-23


def _planck(lam_nm, t):
    lam = lam_nm * 1e-9
    return (2.0 * _H * _C * _C / lam ** 5) / np.expm1(_H * _C / (lam * _KB * t))


def curve(spec: dict, lam: torch.Tensor) -> torch.Tensor:
    """The curve `spec` at wavelengths `lam` (nm), in lam's dtype."""
    kind = spec["kind"]
    if kind == "flat":
        return torch.full_like(lam, float(spec["value"]))
    if kind == "spike":
        d = lam - float(spec["center"])
        left = torch.exp(d / max(float(spec["left"]), 1e-6))
        right = torch.exp(-d / max(float(spec["right"]), 1e-6))
        return float(spec["value"]) * torch.where(d < 0.0, left, right)
    if kind == "cauchy":
        return float(spec["a"]) + float(spec["b"]) / (lam * lam)
    if kind == "blackbody":
        t = float(spec["temperature"])
        peak = _planck(np.array([2.8977721e6 / t]), t)[0]
        x = lam.double() * 1e-9
        val = (2.0 * _H * _C * _C / x ** 5) / torch.expm1(_H * _C / (x * _KB * t))
        return (float(spec["value"]) * val / peak).to(lam.dtype)
    raise ValueError(f"unknown curve kind {kind!r}")


def _g(x, mu, t1, t2):
    t = torch.where(x < mu, t1, t2)
    return torch.exp(-0.5 * (t * (x - mu)) ** 2)


def cmf(lam: torch.Tensor) -> torch.Tensor:
    """x-bar, y-bar, z-bar at `lam` -> [..., 3]."""
    x = (1.056 * _g(lam, 599.8, 0.0264, 0.0323)
         + 0.362 * _g(lam, 442.0, 0.0624, 0.0374)
         - 0.065 * _g(lam, 501.1, 0.0490, 0.0382))
    y = 0.821 * _g(lam, 568.8, 0.0213, 0.0247) + 0.286 * _g(lam, 530.9, 0.0613, 0.0322)
    z = 1.217 * _g(lam, 437.0, 0.0845, 0.0278) + 0.681 * _g(lam, 459.0, 0.0385, 0.0725)
    return torch.stack([x, y, z], dim=-1)


