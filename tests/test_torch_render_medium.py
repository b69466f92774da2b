"""Medium-aware renders on the CPU through `render_regen` (the plain twins
of K12 and K34 with their medium branch, after `med_feed`).

Against the JAX package: `absorbing_sphere` (σ_s 0, σ_a 0.5 in a unit sphere
behind a near-index-matched boundary, unit constant environment) at 24x24 @
8 spp, max and min bounces 6, no NEE, no RR, against
`pt_trace_regen_mega(interpret=True)` at a 1024-lane tile, with the JAX
uniform draws replayed into the port (`JaxReplay`). Tolerances: film mean
within rtol 1e-2 and the counters within rtol 1e-2: the same uniforms drive
both, so only lanes whose reflect-or-transmit pick at the boundary flips on
f32 operation order diverge.

Analytic checks on the port's own generator, at the bounds of the JAX
package's tests (tests/test_kernels_pallas.py::test_mega_medium_beer_lambert,
tests/test_render_medium.py): the absorbing sphere's centre over its
corners within 0.08 of exp(-1) (the centre pixels cross a chord of at least
1.87 of the 2-unit diameter); the pure scatterer (σ_s 1, σ_a 0, g 0) in the
unit furnace within 0.05 of unity; the two overlapping absorbers within 5%
of exp(-2 σ_A - 2 σ_B) and more than 20% from what tracking only the
innermost medium would give; and media ignored when `medium_aware` is off.
These renders use four hero-wavelength lanes: with one λ a sample, a
pixel's Y is ȳ(λ) times its radiance and the λ noise (relative deviation
about 1) would need some thousand samples behind each ratio; four
equidistant λs bring it to a few percent at the 128 to 1,500 samples the
centre and corner blocks hold.
"""

import numpy as np
import jax
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.renderer.persistent import render_regen

from torch_ref_helpers import (
    JaxReplay,
    both_settings,
    both_worlds,
    torch_camera,
)

torch.set_num_threads(2)

W = H = 24


def _settings(max_bounces, medium_aware=True, hwss=False):
    return both_settings(max_bounces=max_bounces, min_bounces=max_bounces,
                         light_samples=0, russian_roulette=False,
                         medium_aware=medium_aware, hwss=hwss)


def _centre_over_corner(film, half=2, corner=2):
    """Mean Y of the centre block over that of the corner blocks (which see
    the bare environment: the spheres end 16 degrees off the axis)."""
    y = film[..., 1].numpy()
    centre = y[H // 2 - half:H // 2 + half, W // 2 - half:W // 2 + half]
    c = corner
    corners = np.concatenate([y[:c, :c].ravel(), y[:c, -c:].ravel(),
                              y[-c:, :c].ravel(), y[-c:, -c:].ravel()])
    return float(centre.mean() / corners.mean())


def _render(recipe, max_bounces, spp, medium_aware=True, seed=7, vfov=None):
    _, tw, _, tc = both_worlds(recipe)
    if vfov is not None:
        tc = torch_camera(**dict(scenes.MEDIUM_CAMERA, vfov_degrees=vfov),
                          device="cpu")
    _, ts = _settings(max_bounces, medium_aware, hwss=True)
    calls = tm.PLAIN_CALLS
    stats = {}
    film, profile, _ = render_regen(
        tw, tc, ts, W, H, spp, generator=torch.Generator().manual_seed(seed),
        stats=stats)
    # medium-aware: the K12 and K34 twins; else this one-prim scene under a
    # constant environment takes the fused round
    assert tm.PLAIN_CALLS - calls == (2 if medium_aware else 1) * stats[
        "rounds"]
    assert np.isfinite(film.numpy()).all()
    return film


@pytest.fixture(scope="module")
def absorbing():
    mp = pytest.MonkeyPatch()
    mp.setenv("PT_MEGA_TILE", "1024")
    mp.setattr(jm, "TILE", 1024)
    mp.setattr(jm, "SUB", 8)
    spp = 8
    try:
        jw, tw, jc, tc = both_worlds("absorbing_sphere")
        js, ts = _settings(6)
        assert jm.mega_available(jw, jc, js)
        assert tm.gate_refusal(tw, tc, ts) is None
        key = jax.random.PRNGKey(7)
        acc, counters = jm.pt_trace_regen_mega(jw, jc, js, W, H, spp, key,
                                               interpret=True)
        film, profile, _ = render_regen(tw, tc, ts, W, H, spp,
                                        uniforms=JaxReplay(key))
    finally:
        mp.undo()
    return dict(ref=np.asarray(acc).reshape(H, W, 3) / spp,
                ref_counters=np.asarray(counters), film=film, profile=profile)


def test_absorbing_render_matches_jax(absorbing):
    ref, film = absorbing["ref"], absorbing["film"].numpy()
    np.testing.assert_allclose(film.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-2)
    close = np.isclose(film, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.97, close.mean()


def test_absorbing_counters_match_jax(absorbing):
    p, ref = absorbing["profile"], absorbing["ref_counters"]
    from pathtracer_tpu_torch.utils import profile as prof

    for name, slot in (("camera_rays", prof.CAMERA_RAYS),
                       ("bounce_rays", prof.BOUNCE_RAYS),
                       ("env_hits", prof.ENV_HITS)):
        np.testing.assert_allclose(getattr(p, name), ref[slot], rtol=1e-2,
                                   err_msg=name)
    assert p.shadow_rays == ref[prof.SHADOW_RAYS] == 0


def test_beer_lambert_centre_over_corner(absorbing):
    """Both packages' films, and a 48 spp render from the port's own
    generator, show exp(-σ_a · chord) through the sphere's middle."""
    expected = np.exp(-0.5 * 2.0)
    own = _render("absorbing_sphere", 6, 48)
    for film in (absorbing["film"], torch.as_tensor(absorbing["ref"])):
        y = film[..., 1].numpy()  # the JAX test's blocks, C = 1
        ratio = y[10:14, 10:14].mean() / np.concatenate(
            [y[:2, :2].ravel(), y[-2:, -2:].ravel()]).mean()
        assert abs(ratio - expected) < 0.08, (ratio, expected)
    ratio = _centre_over_corner(own, corner=4)
    assert abs(ratio - expected) < 0.08, (ratio, expected)


def test_medium_ignored_when_disabled():
    ratio = _centre_over_corner(_render("absorbing_sphere", 6, 16,
                                        medium_aware=False), corner=4)
    assert abs(ratio - 1.0) < 0.03, ratio


def test_scattering_furnace_conserves_energy():
    ratio = _centre_over_corner(_render("scattering_furnace", 64, 16),
                                corner=4)
    assert abs(ratio - 1.0) < 0.05, ratio


def test_nested_media_need_the_stack():
    sa, sb = scenes.NESTED_SIGMA_A
    # a 30 degree view: the 2x2 centre pixels lie within 1.8 degrees of the
    # axis, where both chords are over 1.98 of the 2-unit diameters, and the
    # 2x2 corner blocks over 18 degrees off it, past both spheres
    ratio = _centre_over_corner(
        _render("nested_media", 8, 48, vfov=30.0, seed=11), half=1)
    expected = np.exp(-2.0 * sa - 2.0 * sb)
    innermost_only = np.exp(-0.8 * sa - 1.2 * sb)
    assert abs(ratio - expected) / expected < 0.05, (ratio, expected)
    assert abs(ratio - innermost_only) / innermost_only > 0.2


def test_fog_cornell_renders_with_nee():
    """The fog box through NEE, RR and four λ lanes: finite, lit, shadow
    rays traced, and another image than the same box without media
    tracking."""
    _, tw, _, tc = both_worlds("fog_cornell")
    kw = dict(max_bounces=8, min_bounces=1, light_samples=2,
              russian_roulette=True, hwss=True)
    films = {}
    for medium in (True, False):
        _, ts = both_settings(**kw, medium_aware=medium)
        film, profile, _ = render_regen(
            tw, tc, ts, 12, 12, 4, generator=torch.Generator().manual_seed(5))
        assert np.isfinite(film.numpy()).all()
        assert profile.shadow_rays > 0 and film[..., 1].mean() > 0
        films[medium] = film
    assert not torch.equal(films[True], films[False])
