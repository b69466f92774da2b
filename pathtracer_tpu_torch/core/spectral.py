"""Spectral curves (counterpart of `core/spectral.py`).

Host curve descriptions evaluate themselves on a numpy wavelength grid;
`bake_curves` turns a scene's curves into one `[n_curves, RES]` LUT block
(the `CurveBank`) with exactly the reference's numpy arithmetic, and
`evaluate` is a per-lane lerp on that LUT in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pathtracer_tpu_torch.core.bounds import Bounds1D, EXTENDED_VISIBLE_RANGE

SPECTRAL_RES = 512  # LUT knots over the bank's wavelength domain


# ------------------------------------------------------------------ host IR


class HostCurve:
    def sample(self, lams: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def integral(self, bounds: Bounds1D, n: int = 1024) -> float:
        lams = np.linspace(bounds.lower, bounds.upper, n)
        return float(np.trapezoid(self.sample(lams), lams))


@dataclasses.dataclass
class FlatCurve(HostCurve):
    strength: float

    def sample(self, lams):
        return np.full_like(lams, self.strength, dtype=np.float64)


@dataclasses.dataclass
class CauchyCurve(HostCurve):
    """Cauchy dispersion n(λ) = a + b/λ² (λ in nm)."""

    a: float
    b: float

    def sample(self, lams):
        return self.a + self.b / (lams * lams)


@dataclasses.dataclass
class BlackbodyCurve(HostCurve):
    """Planck blackbody SPD, peak-normalised then scaled by `strength`."""

    temperature: float
    strength: float = 1.0

    def sample(self, lams):
        val = planck_np(lams, self.temperature)
        lam_peak = 2.8977721e6 / self.temperature  # nm
        peak = planck_np(np.array([lam_peak]), self.temperature)[0]
        return self.strength * val / max(peak, 1e-30)


def planck_np(lams_nm: np.ndarray, t: float) -> np.ndarray:
    lam = lams_nm * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    with np.errstate(over="ignore"):
        return (2.0 * h * c * c / lam**5) / np.expm1(h * c / (lam * kb * t))


@dataclasses.dataclass
class TabulatedCurve(HostCurve):
    """Piecewise (x, y) samples, Linear or Cubic (Catmull-Rom), zero outside
    the tabulated domain."""

    xs: np.ndarray
    ys: np.ndarray
    mode: str = "Cubic"  # "Linear" | "Cubic"

    def sample(self, lams):
        xs, ys = np.asarray(self.xs, np.float64), np.asarray(self.ys, np.float64)
        order = np.argsort(xs)
        xs, ys = xs[order], ys[order]
        if self.mode == "Linear" or len(xs) < 3:
            out = np.interp(lams, xs, ys, left=0.0, right=0.0)
        else:
            out = _catmull_rom(lams, xs, ys)
        inside = (lams >= xs[0]) & (lams <= xs[-1])
        return np.where(inside, out, 0.0)


def _catmull_rom(q, xs, ys):
    """Catmull-Rom through non-uniform knots with clamped ends."""
    idx = np.clip(np.searchsorted(xs, q) - 1, 0, len(xs) - 2)
    x0 = xs[np.maximum(idx - 1, 0)]
    x1, x2 = xs[idx], xs[idx + 1]
    x3 = xs[np.minimum(idx + 2, len(xs) - 1)]
    y0 = ys[np.maximum(idx - 1, 0)]
    y1, y2 = ys[idx], ys[idx + 1]
    y3 = ys[np.minimum(idx + 2, len(xs) - 1)]
    t = np.clip((q - x1) / np.maximum(x2 - x1, 1e-12), 0.0, 1.0)
    m1 = np.where(x2 > x0, (y2 - y0) / np.maximum(x2 - x0, 1e-12), 0.0) * (x2 - x1)
    m2 = np.where(x3 > x1, (y3 - y1) / np.maximum(x3 - x1, 1e-12), 0.0) * (x2 - x1)
    t2, t3 = t * t, t * t * t
    return (
        (2 * t3 - 3 * t2 + 1) * y1
        + (t3 - 2 * t2 + t) * m1
        + (-2 * t3 + 3 * t2) * y2
        + (t3 - t2) * m2
    )


@dataclasses.dataclass
class LinearCurve(HostCurve):
    """Evenly spaced signal over [lower, upper]."""

    signal: np.ndarray
    bounds: Bounds1D
    mode: str = "Linear"

    def sample(self, lams):
        xs = np.linspace(self.bounds.lower, self.bounds.upper, len(self.signal))
        return TabulatedCurve(xs, np.asarray(self.signal), self.mode).sample(lams)


@dataclasses.dataclass
class SpikeCurve(HostCurve):
    """Exponential spike at `lam0`: strength · exp(−|λ−λ0|/taper_side)."""

    lam0: float
    left_taper: float
    right_taper: float
    strength: float

    def sample(self, lams):
        d = lams - self.lam0
        left = np.exp(d / max(self.left_taper, 1e-6))
        right = np.exp(-d / max(self.right_taper, 1e-6))
        return self.strength * np.where(d < 0.0, left, right)


# ------------------------------------------------------------- device bank


@dataclasses.dataclass
class CurveBank:
    """All scene curves baked to one LUT block."""

    values: torch.Tensor  # [C, RES] f32 — curve value at each grid knot
    pairs: torch.Tensor  # [C*RES, 2] f32 — (v[k], v[k+1]) per flat knot
    cdf: torch.Tensor  # [C, RES] f32 — normalised CDF over the grid
    cdf_pairs: torch.Tensor  # [C*RES, 2] f32 — (cdf[k], cdf[k+1])
    integral: torch.Tensor  # [C] f32 — ∫ curve dλ over the grid domain
    lam_lo: float
    lam_hi: float

    @property
    def n_curves(self):
        return self.values.shape[0]


def bake_curves_np(
    curves: Sequence[HostCurve],
    bounds: Bounds1D = EXTENDED_VISIBLE_RANGE,
    res: int = SPECTRAL_RES,
) -> dict:
    """The bank's arrays in numpy (f32), keyed by `CurveBank` field."""
    grid = np.linspace(bounds.lower, bounds.upper, res)
    vals = (np.stack([np.maximum(c.sample(grid), 0.0) for c in curves])
            if curves else np.zeros((0, res)))
    dx = grid[1] - grid[0]
    # trapezoid cumulative integral -> CDF
    seg = 0.5 * (vals[:, 1:] + vals[:, :-1]) * dx
    cum = np.concatenate([np.zeros((vals.shape[0], 1)), np.cumsum(seg, axis=1)], axis=1)
    total = cum[:, -1:]
    cdf = np.where(total > 0.0, cum / np.maximum(total, 1e-30),
                   np.linspace(0, 1, res)[None, :])

    def pair_pack(a):
        nxt = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
        return np.stack([a, nxt], axis=-1).reshape(-1, 2)

    return dict(
        values=vals.astype(np.float32),
        pairs=pair_pack(vals).astype(np.float32),
        cdf=cdf.astype(np.float32),
        cdf_pairs=pair_pack(cdf).astype(np.float32),
        integral=total[:, 0].astype(np.float32),
        lam_lo=float(bounds.lower),
        lam_hi=float(bounds.upper),
    )


def bake_curves(curves: Sequence[HostCurve],
                bounds: Bounds1D = EXTENDED_VISIBLE_RANGE,
                res: int = SPECTRAL_RES, device="cpu") -> CurveBank:
    arrs = bake_curves_np(curves, bounds, res)
    return CurveBank(**{k: (torch.as_tensor(v, device=device)
                            if isinstance(v, np.ndarray) else v)
                        for k, v in arrs.items()})


def evaluate(bank: CurveBank, idx, lam):
    """Curve `idx` at wavelength(s) `lam`: a lerp between the two bracketing
    knots (u clipped to [0, RES-1-1e-4])."""
    res = bank.values.shape[1]
    lam = torch.as_tensor(lam, dtype=torch.float32, device=bank.values.device)
    if not isinstance(idx, torch.Tensor):
        # a fill, not a copy from the host (which waits for the card)
        idx = torch.full(lam.shape, int(idx), device=lam.device)
    idx, lam = torch.broadcast_tensors(idx, lam)
    u = (lam - bank.lam_lo) / (bank.lam_hi - bank.lam_lo) * (res - 1)
    u = torch.clamp(u, 0.0, res - 1 - 1e-4)
    i0 = u.to(torch.int32)
    frac = u - i0
    vp = bank.pairs[(idx.long() * res + i0.long())]
    return vp[..., 0] * (1.0 - frac) + vp[..., 1] * frac


def cdf_at(bank: CurveBank, idx, lam):
    """Curve `idx`'s normalised CDF at wavelength(s) `lam` (the lerp of
    `evaluate` on the CDF knots)."""
    res = bank.cdf.shape[1]
    idx, lam = torch.broadcast_tensors(torch.as_tensor(idx, device=lam.device),
                                       lam)
    u = (lam - bank.lam_lo) / (bank.lam_hi - bank.lam_lo) * (res - 1)
    u = torch.clamp(u, 0.0, res - 1 - 1e-4)
    i0 = u.to(torch.int32)
    frac = u - i0
    vp = bank.cdf_pairs[idx.long() * res + i0.long()]
    return vp[..., 0] * (1.0 - frac) + vp[..., 1] * frac


def sample_power_and_pdf(bank: CurveBank, idx, u, bounds: Bounds1D):
    """A wavelength drawn from curve `idx`'s SPD restricted to `bounds` by
    inverting its CDF -> (lam, power, pdf per nm). The knot below the
    target is found by a branchless binary search (9 dependent gathers at
    512 knots), which counts the knots whose CDF is below the target as a
    scan of the row does, the CDF being monotone."""
    res = bank.cdf.shape[1]
    idx, u = torch.broadcast_tensors(torch.as_tensor(idx, device=u.device), u)
    idx = idx.long()
    cdf_lo = cdf_at(bank, idx, torch.full_like(u, bounds.lower))
    cdf_hi = cdf_at(bank, idx, torch.full_like(u, bounds.upper))
    span = torch.clamp(cdf_hi - cdf_lo, min=1e-9)
    target = cdf_lo + u * span
    cdf_flat = bank.cdf.reshape(-1)
    base = idx * res
    if res & (res - 1) == 0:
        i1 = torch.zeros_like(base)
        s = res >> 1
        while s:
            probe = i1 + s
            i1 = torch.where(cdf_flat[base + probe - 1] < target, probe, i1)
            s >>= 1
    else:
        i1 = (bank.cdf[idx] < target[..., None]).sum(dim=-1)
    i1 = torch.clamp(i1, 1, res - 1)
    cp = bank.cdf_pairs[base + (i1 - 1)]
    c0, c1 = cp[..., 0], cp[..., 1]
    frac = torch.clamp((target - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0,
                       1.0)
    step = float(np.float32(bank.lam_hi - bank.lam_lo) / np.float32(res - 1))
    lam = bank.lam_lo + ((i1 - 1).float() + frac) * step
    lam = torch.clamp(lam, bounds.lower, bounds.upper)
    power = evaluate(bank, idx, lam)
    pdf = power / torch.clamp(bank.integral[idx] * span, min=1e-20)
    return lam, power, pdf
