"""Splatting renderer: drives the light tracer (counterpart of
`renderer/splatted.py:render_splatted`)."""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.integrator.lt import (
    _has_proxy,
    _lt_trace,
    check_camera,
    host_world,
)
from pathtracer_tpu_torch.kernels.lt_mega import (
    _lt_trace_mega,
    lt_gate_refusal,
)
from pathtracer_tpu_torch.renderer.common import timed_render
from pathtracer_tpu_torch.utils import profile as prof


def render_splatted(world, camera, settings, width: int, height: int,
                    min_samples: int, generator: torch.Generator | None = None,
                    uniforms=None, device=None, stats: dict | None = None,
                    paths_per_chunk: int | None = None,
                    use_megakernel: bool | None = None):
    """Render `min_samples` light paths per pixel. Returns (film [H, W, 3]
    XYZ, the splat sum scaled by pixels / paths so that it reads like a
    path-traced film, Profile, elapsed seconds); the elapsed time ends with
    the counters' host fetch, which waits for the device.

    Random numbers come from `uniforms` (see
    kernels/megakernel.TorchUniforms) or else from `generator`, which must
    live on `device`. A `stats` dict, if given, gets the route under
    "route" ("lt_mega" or "lt_trace") and the rounds (bounces) run.

    `use_megakernel` None takes the LT megakernel
    (`kernels/lt_mega.py:lt_trace_mega`) for a scene in its gate and the
    light-tracing wavefront (`integrator/lt.py:lt_trace`) for every other
    scene; False takes `lt_trace` for every scene; True raises
    `NotImplementedError` on a scene outside the gate. The megakernel
    renders on `device` (default: the world's), `lt_trace` on the world's
    device only, in calls of `paths_per_chunk` paths (default: one a
    pixel), chunk c drawing its uniforms as chunk c."""
    with prof.span("render"):
        why = lt_gate_refusal(world, camera, settings)
        if use_megakernel and why is not None:
            raise NotImplementedError(why)
        mega = why is None and use_megakernel is not False
        if stats is not None:
            stats["route"] = "lt_mega" if mega else "lt_trace"
        n_pix = width * height
        total_paths = n_pix * min_samples

        def trace(device, uniforms):
            if mega:
                film, counters = _lt_trace_mega(world, camera, settings,
                                                width, height, total_paths,
                                                uniforms, device, None, stats)
                film = film * (float(n_pix) / float(total_paths))
                return film.reshape(height, width, 3), counters
            if device != world.prims.pa.device:
                raise ValueError(f"the world lives on "
                                 f"{world.prims.pa.device}, not {device}")
            check_camera(camera)
            wh, cam_h, has_proxy = (host_world(world), camera.to("cpu"),
                                    _has_proxy(world))
            chunk = paths_per_chunk or n_pix
            n_chunks = -(-total_paths // chunk)
            film = torch.zeros((n_pix, 3), dtype=torch.float32,
                               device=device)
            counters = torch.zeros(prof.N_COUNTERS, dtype=torch.float64,
                                   device=device)
            for c in range(n_chunks):
                f, cn = _lt_trace(wh, cam_h, has_proxy, settings, width,
                                  height, chunk, uniforms, c, stats)
                film = film + f
                counters = counters + cn
            film = film * (float(n_pix) / float(n_chunks * chunk))
            return film.reshape(height, width, 3), counters

        return timed_render(world, generator, uniforms, device, trace)
