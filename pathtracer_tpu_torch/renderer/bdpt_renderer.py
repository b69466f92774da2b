"""BDPT renderer: own-pixel contributions and lens splats combined into one
film (counterpart of `renderer/bdpt_renderer.py`)."""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.core import cie
from pathtracer_tpu_torch.integrator.bdpt import (
    S_JITTER,
    BDPTSettings,
    _bdpt_trace,
    host_cameras,
)
from pathtracer_tpu_torch.integrator.lt import check_camera, host_world
from pathtracer_tpu_torch.kernels.cmath import fdiv
from pathtracer_tpu_torch.renderer.common import timed_render
from pathtracer_tpu_torch.utils import profile as prof

# film points a pass, scaled by the strategy count: a pass builds [n · P]
# lanes (P about max_depth² pairs); the JAX package caps n · P near 8M
# lanes, so a 512² film at max_depth 6 takes two passes a sample
BDPT_LANE_BUDGET = 1 << 23


def _bdpt_chunk(world, cameras, it: int, start: int, settings: BDPTSettings,
                width: int, height: int, n_chunk: int, uniforms, film,
                splats):
    """One pass over the film points [start, start + n_chunk): a jittered
    film point each, one `bdpt_trace` sample, its own-pixel XYZ added to
    `film` and its splats' to `splats` (both [W·H, 3]) -> counters."""
    dev = film.device
    ids = start + torch.arange(n_chunk, dtype=torch.int32, device=dev)
    xy = torch.stack([(ids % width).float(), (ids // width).float()], dim=-1)
    jitter = uniforms.lanes(it, 2, n_chunk, dev, stream=S_JITTER)
    film_uv = torch.stack([fdiv(xy[:, 0] + jitter[:, 0], float(width)),
                           fdiv(xy[:, 1] + jitter[:, 1], float(height))], -1)
    own, splat_uv, splat_e, lam, lam_splat, counters = _bdpt_trace(
        world, cameras, settings, film_uv, uniforms, it)
    span = settings.wavelength_bounds.span
    film.index_add_(0, ids.long(), cie.wavelength_to_xyz(lam, own) * span)
    px = torch.clamp((splat_uv[:, 0] * width).to(torch.int32), 0, width - 1)
    py = torch.clamp((splat_uv[:, 1] * height).to(torch.int32), 0,
                     height - 1)
    splats.index_add_(0, (py * width + px).long(),
                      cie.wavelength_to_xyz(lam_splat, splat_e) * span)
    return counters


def render_bdpt(world, camera, settings: BDPTSettings, width: int,
                height: int, min_samples: int,
                generator: torch.Generator | None = None, uniforms=None,
                device=None, stats: dict | None = None):
    """Render `min_samples` BDPT samples per pixel on the world's device.
    Returns (film [H, W, 3] XYZ, Profile, elapsed seconds); the elapsed
    time ends with the counters' host fetch, which waits for the device.

    Each sample runs in passes of at most BDPT_LANE_BUDGET / max_depth²
    film points; pass (c, start) draws its uniforms as `it` = 5000 + c ·
    7919 + start (the JAX package's key folds), from `uniforms` (see
    kernels/megakernel.TorchUniforms) or else from `generator`, which must
    live on the world's device. Own-pixel terms average over the samples;
    splats are film-wide measurements over the W·H·spp light subpaths. A
    `stats` dict, if given, gets the passes run under "passes"."""
    check_camera(camera)
    n = width * height
    p_est = max(settings.max_depth * settings.max_depth, 1)
    n_chunks = max(-(-(n * p_est) // BDPT_LANE_BUDGET), 1)
    n_chunk = -(-n // n_chunks)

    def trace(device, uniforms):
        if device != world.prims.pa.device:
            raise ValueError(f"the world lives on {world.prims.pa.device}, "
                             f"not {device}")
        wh, cams = host_world(world), host_cameras(camera)
        film = torch.zeros((n, 3), dtype=torch.float32, device=device)
        splats = torch.zeros((n, 3), dtype=torch.float32, device=device)
        total = torch.zeros(prof.N_COUNTERS, dtype=torch.float64,
                            device=device)
        passes = 0
        for c in range(min_samples):
            for start in range(0, n, n_chunk):
                total += _bdpt_chunk(wh, cams, 5000 + c * 7919 + start, start,
                                     settings, width, height,
                                     min(n_chunk, n - start), uniforms, film,
                                     splats)
                passes += 1
        if stats is not None:
            stats["passes"] = stats.get("passes", 0) + passes
        out = film / min_samples + splats * (float(n) / (n * min_samples))
        return out.reshape(height, width, 3), total

    return timed_render(world, generator, uniforms, device, trace)
