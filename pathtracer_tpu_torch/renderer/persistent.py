"""Fixed-pixel sample-regeneration renderer (counterpart of
`renderer/persistent.py:render_regen`, megakernel branch)."""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.kernels.megakernel import (
    gate_refusal,
    pt_trace_regen_mega,
)
from pathtracer_tpu_torch.renderer.common import timed_render


def render_regen(world, camera, settings, width: int, height: int,
                 min_samples: int, generator: torch.Generator | None = None,
                 uniforms=None, device=None, stats: dict | None = None,
                 stepper: str | None = None):
    """Render `min_samples` samples per pixel with one lane per pixel.
    Returns (film [H, W, 3] XYZ, Profile, elapsed seconds); the elapsed time
    ends with the counters' host fetch, which waits for the device.

    Random numbers come from `uniforms` (an object with `init` and `round`,
    see kernels/megakernel.TorchUniforms) or else from `generator`, which
    must live on `device`. A `stats` dict, if given, gets the number of
    bounce rounds run under "rounds".

    Scenes in the megakernel's gate render through the fused round, the
    texture-feed round (uv-textured lambertians) or the two-program round
    (`kernels/megakernel.py`; medium-aware settings ride its medium
    branch), or all of them through the split round with
    `stepper="split"`, on the world's device unless `device` says
    otherwise; the rest raise `NotImplementedError` naming the ROADMAP item
    that ports their route (scenes for the regen integrator without
    kernels)."""
    why = gate_refusal(world, camera, settings)
    if why is not None:
        raise NotImplementedError(why)

    def trace(device, uniforms):
        acc, counters = pt_trace_regen_mega(world, camera, settings, width,
                                            height, min_samples, uniforms,
                                            device=device, stats=stats,
                                            stepper=stepper)
        return (acc / float(min_samples)).reshape(height, width, 3), counters

    return timed_render(world, generator, uniforms, device, trace)
