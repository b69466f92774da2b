"""Whole renders of the regen integrator without kernels on the CPU: the
port's `render_regen(..., use_megakernel=False)` against the JAX
`render_regen` (which takes `pt_trace_regen` on the CPU), and the HWSS
dispersive furnace through the port.

- The port replays the JAX draws (`torch_ref_helpers.RegenReplay` on the
  key the JAX renderer folds for its one batch, fold(key, 77)), so the two
  renders share their sample stream and the bounds measure the port, not
  the noise: film means per XYZ channel within rtol 0.05 and counters
  within rtol 0.08 (tests/test_kernels_pallas.py:780-820), at 16x16 @ 64
  spp, on `cornell_box`, on `light_grid_cornell` (25 lights: outside the
  megakernel's gate) and on `textured_sun` (a uv-textured sphere under the
  Sun: rays escape, and the BSDF dispatch evaluates the texture at the NaN
  uv of a miss before the round discards it).
- The dispersive furnace (tests/test_spectral_mis.py:25-60): a near-delta
  dispersive sphere in a unit environment renders uniform at C = 4; center
  over corner within 0.06 of 1 at 16x16 @ 256 spp, that file's bound.
"""

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.core import sampling
from pathtracer_tpu.renderer.persistent import render_regen as j_render
from pathtracer_tpu_torch.renderer.persistent import render_regen

from torch_ref_helpers import (
    FURNACE_SETTINGS,
    NEE_SETTINGS,
    RegenReplay,
    both_settings,
    both_worlds,
)

torch.set_num_threads(2)

W = H = 16
SPP = 64


def _counts(profile):
    return np.array([profile.camera_rays, profile.bounce_rays,
                     profile.shadow_rays, profile.light_rays,
                     profile.env_hits], np.float64)


@pytest.mark.parametrize("recipe", ["cornell", "light_grid", "textured_sun"])
def test_replayed_render_matches_jax(recipe):
    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_settings(**NEE_SETTINGS)
    key = jax.random.PRNGKey(4)
    ref, ref_prof, _ = j_render(jw, jc, js, W, H, SPP, key=key,
                                use_megakernel=False)
    ref = np.asarray(ref)
    stats = {}
    film, prof, _ = render_regen(
        tw, tc, ts, W, H, SPP, use_megakernel=False, stats=stats,
        uniforms=RegenReplay(sampling.fold(key, 77)))
    film = film.numpy()
    assert stats["route"] == "regen" and stats["rounds"] > 0
    assert film.shape == (H, W, 3) and np.isfinite(film).all()
    assert film[..., 1].mean() > 1.0
    np.testing.assert_allclose(film.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=0.05)
    want = _counts(ref_prof)
    nz = want > 0
    np.testing.assert_allclose(_counts(prof)[nz], want[nz], rtol=0.08)
    assert _counts(prof)[0] == W * H * SPP


def test_dispersive_furnace_hwss():
    _, tw, _, tc = both_worlds("furnace")
    _, ts = both_settings(**{**FURNACE_SETTINGS, "max_bounces": 32},
                          hwss=True)
    stats = {}
    film, _, _ = render_regen(tw, tc, ts, W, H, 256, use_megakernel=False,
                              stats=stats,
                              generator=torch.Generator().manual_seed(0))
    assert stats["route"] == "regen"
    y = film[..., 1].numpy()
    center = y[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3].mean()
    corner = np.concatenate([y[:3, :3].ravel(), y[-3:, -3:].ravel()]).mean()
    assert abs(center / corner - 1.0) < 0.06
