"""Fixed-pixel sample-regeneration renderer (counterpart of
`renderer/persistent.py:render_regen`)."""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.integrator.pt_regen import pt_trace_regen
from pathtracer_tpu_torch.kernels.megakernel import (
    _pt_trace_regen_mega,
    gate_refusal,
)
from pathtracer_tpu_torch.renderer.common import timed_render
from pathtracer_tpu_torch.utils import profile as prof


def render_regen(world, camera, settings, width: int, height: int,
                 min_samples: int, generator: torch.Generator | None = None,
                 uniforms=None, device=None, stats: dict | None = None,
                 stepper: str | None = None,
                 use_megakernel: bool | None = None):
    """Render `min_samples` samples per pixel with one lane per pixel.
    Returns (film [H, W, 3] XYZ, Profile, elapsed seconds); the elapsed time
    ends with the counters' host fetch, which waits for the device.

    Random numbers come from `uniforms` (an object with `init`, `round` and
    `lanes`, see kernels/megakernel.TorchUniforms) or else from
    `generator`, which must live on `device`. A `stats` dict, if given, gets
    the number of bounce rounds run under "rounds" and the route that ran
    under "route" ("megakernel" or "regen").

    `use_megakernel` None takes the megakernel's rounds for a scene in its
    gate (`kernels/megakernel.py`: the fused, texture-feed or two-program
    round, or all of them through the split round with `stepper="split"`,
    which only this route takes) and the regen integrator without kernels
    (`integrator/pt_regen.py`) for every other scene; False takes the regen
    integrator for every scene; True raises `NotImplementedError` on a
    scene outside the gate. The megakernel renders on `device` (default:
    the world's), the regen integrator on the world's device only."""
    with prof.span("render"):
        why = gate_refusal(world, camera, settings)
        if use_megakernel and why is not None:
            raise NotImplementedError(why)
        mega = why is None and use_megakernel is not False
        if stats is not None:
            stats["route"] = "megakernel" if mega else "regen"

        def trace(device, uniforms):
            if mega:
                acc, counters = _pt_trace_regen_mega(
                    world, camera, settings, width, height, min_samples,
                    uniforms, device, stats, stepper)
            else:
                acc, counters = pt_trace_regen(
                    world, camera, settings, width, height, min_samples,
                    uniforms, device=device, stats=stats)
            film = (acc / float(min_samples)).reshape(height, width, 3)
            return film, counters

        return timed_render(world, generator, uniforms, device, trace)
