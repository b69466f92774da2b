"""Splatting renderer: drives the light tracer (counterpart of
`renderer/splatted.py:render_splatted`, megakernel branch)."""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.kernels.lt_mega import lt_gate_refusal, lt_trace_mega
from pathtracer_tpu_torch.renderer.common import timed_render


def render_splatted(world, camera, settings, width: int, height: int,
                    min_samples: int, generator: torch.Generator | None = None,
                    uniforms=None, device=None, stats: dict | None = None):
    """Render `min_samples` light paths per pixel. Returns (film [H, W, 3]
    XYZ, the splat sum scaled by pixels / paths so that it reads like a
    path-traced film, Profile, elapsed seconds); the elapsed time ends with
    the counters' host fetch, which waits for the device.

    Random numbers come from `uniforms` (see
    kernels/megakernel.TorchUniforms) or else from `generator`, which must
    live on `device`. A `stats` dict, if given, gets the rounds and the
    route.

    Scenes in the LT megakernel's gate render through
    `kernels/lt_mega.py:lt_trace_mega` on the world's device unless
    `device` says otherwise; the rest raise `NotImplementedError` naming the
    ROADMAP item that ports the light-tracing wavefront."""
    why = lt_gate_refusal(world, camera, settings)
    if why is not None:
        raise NotImplementedError(why)
    n_pix = width * height
    total_paths = n_pix * min_samples

    def trace(device, uniforms):
        film, counters = lt_trace_mega(world, camera, settings, width, height,
                                       total_paths, uniforms, device=device,
                                       stats=stats)
        film = film * (float(n_pix) / float(total_paths))
        return film.reshape(height, width, 3), counters

    return timed_render(world, generator, uniforms, device, trace)
