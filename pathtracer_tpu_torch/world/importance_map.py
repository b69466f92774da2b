"""Environment importance map bake (counterpart of
`world/importance_map.py:bake_importance_tables`), in memory.

Per-row conditional CDFs and a marginal CDF over rows of the luminance of
Σ_layers weight × curve, with the equirect area element folded in; the
environment samples them by a 2-level inverse transform
(`world/environment.py:env_sample_uv`). The JAX package caches the tables
on disk; the port bakes them where the scene is built and keeps no cache.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.core.bounds import BOUNDED_VISIBLE_RANGE, Bounds1D


def bake_importance_tables(
    layers: List[Tuple[np.ndarray, int]],
    curves: List[spectral.HostCurve],
    width: int,
    height: int,
    luminance_curve: Optional[spectral.HostCurve] = None,
    bounds: Bounds1D = BOUNDED_VISIBLE_RANGE,
    n_lambda: int = 100,
):
    """layers: texture layers (weight map, curve index) -> (marginal_cdf
    f32[H+1], row_cdf f32[H, W+1], pdf f32[H, W], the joint pdf over the uv
    unit square)."""
    lams = np.linspace(bounds.lower, bounds.upper, n_lambda)
    lum_w = (luminance_curve.sample(lams) if luminance_curve is not None
             else np.ones_like(lams))
    lum = np.zeros((height, width), np.float64)
    for weights, curve_idx in layers:
        cw = float(np.trapezoid(
            np.maximum(curves[curve_idx].sample(lams), 0.0) * lum_w, lams))
        lum += _resample(weights, height, width) * cw
    # the equirect area element, so sampling follows true radiance
    v = (np.arange(height) + 0.5) / height
    lum *= np.sin(np.pi * v)[:, None]
    lum = np.maximum(lum, 0.0)
    total = lum.sum()
    if total <= 0:
        lum = np.ones_like(lum)
        total = lum.sum()
    pdf = lum / total * (width * height)
    row_sum = lum.sum(axis=1)
    marginal_cdf = np.concatenate([[0.0], np.cumsum(row_sum / total)])
    with np.errstate(invalid="ignore", divide="ignore"):
        row_cdf = np.concatenate(
            [np.zeros((height, 1)),
             np.cumsum(lum / np.maximum(row_sum[:, None], 1e-30), axis=1)],
            axis=1)
    return (marginal_cdf.astype(np.float32), row_cdf.astype(np.float32),
            pdf.astype(np.float32))


def _resample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resample of a weight plane to the bake size."""
    ys = np.minimum((np.arange(h) * img.shape[0]) // h, img.shape[0] - 1)
    xs = np.minimum((np.arange(w) * img.shape[1]) // w, img.shape[1] - 1)
    return img[np.ix_(ys, xs)].astype(np.float64)
