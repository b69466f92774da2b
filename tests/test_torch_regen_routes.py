"""The port's two routes on scenes inside the megakernel's gate, on the
CPU: the regen integrator without kernels (`use_megakernel=False`) against
the megakernel rounds' plain twins (the default route) on `cornell_box`
and on `light_grid_cornell(n=4)` (16 lights, in the gate), each from its
own torch.Generator at 16x16 @ 64 spp.

The two routes draw their uniforms in different layouts, so the films are
two independent estimates of one image. HWSS (C = 4) keeps the spectral
noise of the blue channel low enough at this size for the bounds fixed
before the runs: film means per XYZ channel within rtol 0.05 and counters
within rtol 0.08 (tests/test_kernels_pallas.py:780-820).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.renderer.persistent import render_regen

from torch_ref_helpers import NEE_SETTINGS, both_settings, both_worlds

torch.set_num_threads(2)

W = H = 16
SPP = 64


def _counts(profile):
    return np.array([profile.camera_rays, profile.bounce_rays,
                     profile.shadow_rays, profile.light_rays,
                     profile.env_hits], np.float64)


@pytest.mark.parametrize("recipe", ["cornell", "light_grid4"])
def test_regen_matches_megakernel_route(recipe):
    _, tw, _, tc = both_worlds(recipe)
    _, ts = both_settings(**NEE_SETTINGS, hwss=True)
    out = {}
    for route, use in (("regen", False), ("megakernel", None)):
        stats = {}
        film, prof, _ = render_regen(
            tw, tc, ts, W, H, SPP, use_megakernel=use, stats=stats,
            generator=torch.Generator().manual_seed(5))
        assert stats["route"] == route
        film = film.numpy()
        assert np.isfinite(film).all() and film[..., 1].mean() > 1.0
        out[route] = film.mean(axis=(0, 1)), _counts(prof)
    np.testing.assert_allclose(out["regen"][0], out["megakernel"][0],
                               rtol=0.05)
    want = out["megakernel"][1]
    nz = want > 0
    np.testing.assert_allclose(out["regen"][1][nz], want[nz], rtol=0.08)
