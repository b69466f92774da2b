"""A two-program render on the CPU: the port's `render_regen` (plain K12 and
K34 twins) against the JAX package's `pt_trace_regen_mega` (Pallas
interpret mode, two-program round forced by PT_MEGA_NOFUSED as
tests/test_kernels_pallas.py does; the gem's 11 chunks take that round
anyway) on the gem stand-in at 16x16 @ 2 spp, with the JAX uniform draws
replayed into the port (`JaxReplay`, two streams per round). The JAX kernels
run at a 1024-lane tile (PT_MEGA_TILE, pt_trace_regen_mega's own lever) to
keep their interpret-mode compile short.

Tolerances: film mean within rtol 1e-2 and >= 97% of pixels within rtol
1e-3; counters within rtol 1e-2. The same uniforms drive both renders, so
only the lanes whose RR or shadow decision flips on f32 op order diverge
(XLA's CPU backend contracts multiply-adds into FMAs, torch does not), and
the near-delta dispersive gem amplifies such a flip along the rest of the
path.
"""

import numpy as np
import jax
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.renderer.persistent import render_regen

from torch_ref_helpers import NEE_SETTINGS, JaxReplay, both_settings, \
    both_worlds

torch.set_num_threads(2)

W = H = 16
SPP = 2


@pytest.fixture(scope="module")
def gem():
    mp = pytest.MonkeyPatch()
    mp.setenv("PT_MEGA_NOFUSED", "1")
    mp.setenv("PT_MEGA_TILE", "1024")
    mp.setattr(jm, "TILE", 1024)
    mp.setattr(jm, "SUB", 8)
    try:
        jw, tw, jc, tc = both_worlds("gem")
        js, ts = both_settings(**NEE_SETTINGS)
        key = jax.random.PRNGKey(5)
        acc, counters = jm.pt_trace_regen_mega(jw, jc, js, W, H, SPP, key,
                                               interpret=True)
        stats = {}
        film, profile, _ = render_regen(tw, tc, ts, W, H, SPP,
                                        uniforms=JaxReplay(key), stats=stats)
    finally:
        mp.undo()
    return dict(ref=np.asarray(acc).reshape(H, W, 3) / SPP,
                ref_counters=np.asarray(counters), film=film.numpy(),
                profile=profile, stats=stats)


def test_gem_render_matches_jax(gem):
    ref, film = gem["ref"], gem["film"]
    assert film.shape == (H, W, 3) and np.isfinite(film).all()
    assert film[..., 1].mean() > 0
    np.testing.assert_allclose(film.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-2)
    close = np.isclose(film, ref, rtol=1e-3, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.97, f"only {close.mean():.4f} of pixels agree"


def test_gem_counters_match_jax(gem):
    p = gem["profile"]
    got = np.array([p.camera_rays, p.bounce_rays, p.shadow_rays,
                    p.light_rays, p.env_hits], np.float64)
    np.testing.assert_allclose(got, gem["ref_counters"], rtol=1e-2)
    assert got[0] == W * H * SPP and gem["stats"]["rounds"] > 0
    assert tm.k2_rows(NEE_SETTINGS["light_samples"]) == 56
