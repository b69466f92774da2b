"""What the renderers share: the default device and uniform source, and the
timing of a render up to the counters' host fetch."""

from __future__ import annotations

import time

import torch

from pathtracer_tpu_torch.kernels.megakernel import TorchUniforms
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.utils.profile import Profile


def timed_render(world, generator, uniforms, device, trace):
    """Run `trace(device, uniforms) -> (film, counters)` and return (film,
    Profile, elapsed seconds); the elapsed time ends with the counters' host
    fetch, which waits for the device. `device` defaults to the world's;
    `uniforms` to a TorchUniforms over `generator`, which must live on
    `device` (seed 0 when it is None)."""
    device = torch.device(device) if device is not None \
        else world.prims.pa.device
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        uniforms = TorchUniforms(generator)
    t0 = time.perf_counter()
    film, counters = trace(device, uniforms)
    with prof.span("wait"):
        counts = counters.cpu().tolist()
    profile = Profile().add_device_counts(counts)
    elapsed = time.perf_counter() - t0
    return film, profile, elapsed
