"""Tonemapping and OETFs on the XYZ film (counterpart of
`tonemap/tonemap.py`).

A tonemapper's `initialize(film)` returns a small dict of film statistics
and `map(stats, film)` the tonemapped XYZ film; NaN pixels are flagged
MAUVE. `tonemap_to_rgb` runs the whole pipeline.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.core import cie
from pathtracer_tpu_torch.prelude import MAUVE_XYZ


def _luminance_stats(film_xyz):
    y = film_xyz[..., 1]
    finite = torch.isfinite(y) & (y > 0.0)
    y_safe = torch.where(finite, y, 1e-9)
    log_avg = torch.exp(torch.mean(torch.where(finite, torch.log(1e-9 + y_safe),
                                               0.0)))
    return dict(
        max_lum=torch.max(torch.where(finite, y_safe, 0.0)),
        min_lum=torch.min(torch.where(finite, y_safe, float("inf"))),
        avg_lum=torch.mean(y_safe),
        log_avg_lum=log_avg,
    )


def _flag_nan(film_xyz):
    bad = ~torch.all(torch.isfinite(film_xyz), dim=-1, keepdim=True)
    mauve = torch.tensor(MAUVE_XYZ, dtype=film_xyz.dtype,
                         device=film_xyz.device)
    return torch.where(bad, mauve, film_xyz)


@dataclasses.dataclass(frozen=True)
class Clamp:
    exposure: float = 0.0
    luminance_only: bool = True
    silenced: bool = True

    def initialize(self, film_xyz, factor: float = 1.0):
        return dict(factor=factor * 2.0 ** self.exposure,
                    **_luminance_stats(film_xyz))

    def map(self, stats, film_xyz):
        film = _flag_nan(film_xyz) * stats["factor"]
        if self.luminance_only:
            y = film[..., 1:2]
            scale = torch.where(y > 1.0, 1.0 / torch.clamp(y, min=1e-9), 1.0)
            return film * scale
        return torch.clamp(film, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Reinhard0:
    """L/(1+L) with a key value on luminance."""

    key_value: float = 0.18
    luminance_only: bool = True

    def initialize(self, film_xyz, factor: float = 1.0):
        stats = _luminance_stats(film_xyz * factor)
        return dict(factor=factor,
                    scale=self.key_value / torch.clamp(stats["log_avg_lum"],
                                                       min=1e-9), **stats)

    def _curve(self, l):
        return l / (1.0 + l)

    def map(self, stats, film_xyz):
        film = _flag_nan(film_xyz) * stats["factor"]
        if not self.luminance_only:
            return self._curve(stats["scale"] * film)
        y = film[..., 1:2]
        l_out = self._curve(stats["scale"] * y)
        return film * torch.where(y > 0, l_out / torch.clamp(y, min=1e-9), 0.0)


@dataclasses.dataclass(frozen=True)
class Reinhard0x3(Reinhard0):
    """Per-XYZ-channel variant."""

    luminance_only: bool = False


@dataclasses.dataclass(frozen=True)
class Reinhard1(Reinhard0):
    """Extended Reinhard with a white point."""

    white_point: float = 1.0

    def _curve(self, l):
        w2 = self.white_point * self.white_point
        return l * (1.0 + l / w2) / (1.0 + l)


@dataclasses.dataclass(frozen=True)
class Reinhard1x3(Reinhard1):
    luminance_only: bool = False


# --------------------------------------------------------------------- OETF


def sRGB_oetf(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def rec709_oetf(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x < 0.018, 4.5 * x, 1.099 * x ** 0.45 - 0.099)


def rec2020_oetf(x):
    x = torch.clamp(x, 0.0, 1.0)
    a, b = 1.09929682680944, 0.018053968510807
    return torch.where(x < b, 4.5 * x, a * x ** 0.45 - (a - 1.0))


OETFS = {"sRGB": sRGB_oetf, "Rec709": rec709_oetf, "Rec2020": rec2020_oetf}
RGB_MATRICES = {
    "sRGB": cie.XYZ_TO_REC709,
    "Rec709": cie.XYZ_TO_REC709,
    "Rec2020": cie.XYZ_TO_REC2020,
}


def tonemap_to_rgb(film_xyz, tonemapper, colorspace: str = "Rec709",
                   factor: float = 1.0):
    """stats -> tonemap -> XYZ to RGB -> OETF. Returns (display RGB in
    [0, 1], linear RGB)."""
    stats = tonemapper.initialize(film_xyz, factor)
    mapped = tonemapper.map(stats, film_xyz)
    matrix = RGB_MATRICES[colorspace]
    linear_rgb = cie.xyz_to_rgb(_flag_nan(film_xyz) * factor, matrix)
    mapped_rgb = torch.clamp(cie.xyz_to_rgb(mapped, matrix), 0.0, 1.0)
    return OETFS[colorspace](mapped_rgb), linear_rgb
