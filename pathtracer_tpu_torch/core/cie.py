"""CIE 1931 colorimetry (counterpart of `core/cie.py`): the Wyman, Sloan &
Shirley (JCGT 2013) multi-lobe Gaussian fits of x̄ȳz̄ and XYZ -> RGB."""

from __future__ import annotations

import torch


def _g(x, mu, t1, t2):
    t = torch.where(x < mu, t1, t2)
    return torch.exp(-0.5 * (t * (x - mu)) ** 2)


def x_bar(lam):
    return (
        1.056 * _g(lam, 599.8, 0.0264, 0.0323)
        + 0.362 * _g(lam, 442.0, 0.0624, 0.0374)
        - 0.065 * _g(lam, 501.1, 0.0490, 0.0382)
    )


def y_bar(lam):
    return 0.821 * _g(lam, 568.8, 0.0213, 0.0247) + 0.286 * _g(lam, 530.9, 0.0613, 0.0322)


def z_bar(lam):
    return 1.217 * _g(lam, 437.0, 0.0845, 0.0278) + 0.681 * _g(lam, 459.0, 0.0385, 0.0725)


def wavelength_to_xyz(lam, energy):
    """A wavelength and its energy -> XYZ: [...] -> [..., 3]."""
    return torch.stack([energy * x_bar(lam), energy * y_bar(lam),
                        energy * z_bar(lam)], dim=-1)


# XYZ -> linear RGB 3x3 matrices (rows = R,G,B), D65 white.
XYZ_TO_REC709 = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)

XYZ_TO_REC2020 = (
    (1.7166512, -0.3556708, -0.2533663),
    (-0.6666844, 1.6164812, 0.0157685),
    (0.0176399, -0.0427706, 0.9421031),
)


def xyz_to_rgb(xyz, matrix):
    m = torch.as_tensor(matrix, dtype=xyz.dtype, device=xyz.device)
    return torch.einsum("ij,...j->...i", m, xyz)


# Chromaticity coordinates embedded in EXR/PNG metadata.
CHROMATICITIES = {
    "Rec709": dict(r=(0.64, 0.33), g=(0.30, 0.60), b=(0.15, 0.06), w=(0.3127, 0.3290)),
    "Rec2020": dict(r=(0.708, 0.292), g=(0.170, 0.797), b=(0.131, 0.046), w=(0.3127, 0.3290)),
    "sRGB": dict(r=(0.64, 0.33), g=(0.30, 0.60), b=(0.15, 0.06), w=(0.3127, 0.3290)),
}
