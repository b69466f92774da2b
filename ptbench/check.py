"""The comparison that decides `correct`: the films and ray counters of a
window's frames against the plain reference's, rendered after the window
from the same scene data at the same film size.

Each film is reduced to the means of a grid of pixel blocks. Both sides
are independent Monte Carlo estimates of one expectation, so every number
compared is a gap measured in standard errors (z):

- `film_z_rms`: the root mean square over blocks and X, Y, Z of the z of
  the window's mean film against the reference's. Both sides sample one
  distribution, so the variance of a pixel sample's contribution to a
  block is pooled from the spread between the program's frames and between
  the reference's batches, each weighted by its degrees of freedom (the
  two-sample test). The reference's few batches alone would mostly miss
  the rare bright paths of a caustic and underestimate it;
- `frame_z_rms_max`: the largest over the frames of one frame's root mean
  square block z against the reference (the same pooled variance, at one
  frame's samples), which a single altered frame moves;
- `frame_z_max`: the largest z of one frame's mean X, Y or Z against the
  reference's (the frames' spread taken robustly, from their median
  absolute deviation);
- `bounce_z`: the z of the bounce rays a pixel sample casts, each program
  frame against the reference's count of the definition its route counts
  by (the largest z over the routes the frames took);
- `sample_gap`: exact, the sum over frames of |samples counted - samples
  asked for|;
- `repeated_frames`: exact, the frames whose film equals an earlier
  frame's bit for bit (each frame has a seed of its own);
- `nonfinite`: exact, the non-finite film values.

The limits are per cell (`ptbench/limits/<workload>.json`).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

def block_means(film: np.ndarray, grid: int) -> np.ndarray:
    """A film [H, W, 3] -> float64 block means [grid, grid, 3]."""
    h, w, _ = film.shape
    if h % grid or w % grid:
        raise ValueError(f"a {w} x {h} film does not split into {grid} x "
                         f"{grid} blocks")
    f = np.asarray(film, np.float64)
    return f.reshape(grid, h // grid, grid, w // grid, 3).mean(axis=(1, 3))


def film_digest(film: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(film).tobytes(),
                           digest_size=16).hexdigest()


class Side:
    """What one side (the program's frames, or the reference's batches)
    hands the comparison: block means [n, G, G, 3], bounce rays a sample
    ([n] dicts, by counting definition: a reference batch has every
    definition, a program frame the one its route counts by), and for the
    program the per-frame sample counts, digests and non-finite counts."""

    def __init__(self, spp: int):
        self.spp = spp  # samples a pixel of each entry
        self.blocks, self.bounce, self.samples = [], [], []
        self.digests, self.nonfinite = [], 0

    def add(self, film, grid, bounce_rays, samples):
        film = np.asarray(film)
        bad = ~np.isfinite(film)
        self.nonfinite += int(bad.sum())
        self.blocks.append(block_means(np.where(bad, 0.0, film), grid))
        self.bounce.append({k: float(v) / max(float(samples), 1.0)
                            for k, v in bounce_rays.items()})
        self.samples.append(float(samples))
        self.digests.append(film_digest(film))


def _z(diff, var):
    """diff / sqrt(var), 0 where both are 0 and inf where only var is."""
    diff, var = np.asarray(diff, np.float64), np.asarray(var, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.abs(diff) / np.sqrt(var)
    z = np.where(var > 0, z, np.where(diff == 0, 0.0, np.inf))
    return np.where(np.isnan(z), np.inf, z)


def _frame_z(pb, rb):
    """The z of each frame's mean X, Y, Z against the reference's -> [F, 3];
    the frames' spread from their median absolute deviation."""
    pm, rm = pb.mean(axis=(1, 2)), rb.mean(axis=(1, 2))  # [n, 3]
    s_f = 1.4826 * np.median(np.abs(pm - np.median(pm, axis=0)), axis=0)
    var_rm = rm.var(axis=0, ddof=1) / rb.shape[0]
    return _z(pm - rm.mean(0), s_f * s_f + var_rm)


def _pooled(pb, rb, spp_p, spp_r):
    """The variance of one sample a pixel of each block, pooled over the
    program's frames and the reference's batches."""
    nf, nr = pb.shape[0], rb.shape[0]
    return ((pb.var(axis=0, ddof=1) * spp_p * (nf - 1) if nf > 1 else 0.0)
            + rb.var(axis=0, ddof=1) * spp_r * (nr - 1)) / (nf + nr - 2)


def _frame_z_rms(pb, rb, s2, spp_p, spp_r):
    """Each frame's root mean square block z against the reference -> [F]."""
    var = s2 / spp_p + s2 / (spp_r * rb.shape[0])
    z = _z(pb - rb.mean(0), np.broadcast_to(var, pb.shape))
    return np.sqrt(np.mean(z * z, axis=(1, 2, 3)))


def readings(prog: Side, ref: Side, asked_samples: float) -> dict:
    """Every number compared, from the two sides."""
    pb, rb = np.stack(prog.blocks), np.stack(ref.blocks)
    nf, nr = pb.shape[0], rb.shape[0]
    s2 = _pooled(pb, rb, prog.spp, ref.spp)
    z = _z(pb.mean(0) - rb.mean(0), s2 / (prog.spp * nf) + s2 / (ref.spp * nr))
    film_z_rms = float(np.sqrt(np.mean(z * z)))
    frame_z_rms_max = float(_frame_z_rms(pb, rb, s2, prog.spp, ref.spp).max())

    frame_z_max = float(_frame_z(pb, rb).max())

    bounce_z = 0.0
    for name in sorted({k for e in prog.bounce for k in e}):
        bp = np.asarray([e[name] for e in prog.bounce if name in e])
        br = np.asarray([e[name] for e in ref.bounce])
        var_b = (bp.var(ddof=1) / len(bp) if len(bp) > 1 else 0.0) \
            + br.var(ddof=1) / len(br)
        bounce_z = max(bounce_z, float(_z(bp.mean() - br.mean(), var_b)))

    sample_gap = float(sum(abs(s - asked_samples) for s in prog.samples))
    repeated = len(prog.digests) - len(set(prog.digests))
    return {"film_z_rms": film_z_rms, "frame_z_rms_max": frame_z_rms_max,
            "frame_z_max": frame_z_max,
            "bounce_z": bounce_z, "sample_gap": sample_gap,
            "repeated_frames": float(repeated),
            "nonfinite": float(prog.nonfinite)}


def judge(values: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}}) with every number that has
    a limit, in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values[name]
        checks[name] = {"value": v, "limit": limit}
        ok = ok and not math.isnan(v) and v <= limit
    return ok, checks


def failed_frames(prog: Side, ref: Side, limits: dict) -> int:
    """Frames that fail on their own: a repeat of an earlier frame, or one
    whose frame-level z passes its limit."""
    pb, rb = np.stack(prog.blocks), np.stack(ref.blocks)
    bad = np.zeros(pb.shape[0], bool)
    if "frame_z_rms_max" in limits:
        s2 = _pooled(pb, rb, prog.spp, ref.spp)
        bad |= _frame_z_rms(pb, rb, s2, prog.spp, ref.spp) \
            > limits["frame_z_rms_max"]
    if "frame_z_max" in limits:
        bad |= (_frame_z(pb, rb) > limits["frame_z_max"]).any(axis=1)
    seen, n = set(), 0
    for b, dg in zip(bad, prog.digests):
        n += int(b or dg in seen)
        seen.add(dg)
    return n
