"""The port's light-tracing renderer (`renderer/splatted.py:
render_splatted` -> `kernels/lt_mega.py:lt_trace_mega`, plain twins on the
CPU) against the JAX package:

- with the JAX draws replayed (LTReplay), the chip scene with its lens
  proxy at 16x16, 4096 particles, against the JAX `lt_trace_mega` (Pallas
  interpret mode at a 1024-lane tile, one round per dispatched program):
  film mean and counters within rtol 1e-2, the particle count exact;
- a particle count that does not divide the lanes (3,001) is spawned
  exactly;
- light tracing against the port's path tracer on the Cornell box and on
  the lens-proxy box of the JAX package's tests/test_render_lt.py: film
  mean Y within 0.15 (the JAX test's bound), at max and min bounces 4
  without Russian roulette;
- the gate refuses what the megakernel does not take: those scenes render
  through the light-tracing wavefront `lt_trace` unless use_megakernel=True,
  and a camera the port does not have is refused naming its ROADMAP item.
"""

import numpy as np
import jax
import pytest
import torch

from pathtracer_tpu.kernels import lt_mega as jlt
from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.lt import LTSettings
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.kernels import lt_mega as tlt
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.renderer.splatted import render_splatted
from pathtracer_tpu_torch.utils import profile as prof

from torch_ref_helpers import LTReplay, both_lt_settings, both_worlds

torch.set_num_threads(2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_replayed_render_matches_jax(monkeypatch):
    monkeypatch.setenv("PT_LT_MEGA_ROUNDS", "1")
    jw, tw, jc, tc = both_worlds("chip_lens")
    js, ts = both_lt_settings(max_bounces=4, camera_samples=1,
                              stratified=True)
    key = jax.random.PRNGKey(13)
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        jfilm, jcount = jlt.lt_trace_mega(jw, jc, js, 16, 16, 4096, key,
                                          interpret=True)
    finally:
        jm.TILE, jm.SUB = tile, sub
    stats = {}
    film, profile, _ = render_splatted(tw, tc, ts, 16, 16, 16,
                                       uniforms=LTReplay(key), device="cpu",
                                       stats=stats)
    assert stats["route"] == "lt_mega" and stats["lt_round"] == "v2"
    jfilm = np.asarray(jfilm) * (256.0 / 4096.0)
    assert np.isfinite(film.numpy()).all()
    np.testing.assert_allclose(film.numpy().reshape(-1, 3).mean(axis=0),
                               jfilm.mean(axis=0), rtol=1e-2)
    jc_ = np.asarray(jcount)
    assert profile.light_rays == int(jc_[prof.LIGHT_RAYS]) == 4096
    for got, slot in ((profile.bounce_rays, prof.BOUNCE_RAYS),
                      (profile.camera_rays, prof.CAMERA_RAYS)):
        assert abs(got - jc_[slot]) <= 1e-2 * jc_[slot], slot


def test_remainder_particles_spawn_exactly():
    """3,001 particles on 3,001 lanes of a 4,096-lane pad, and 3,001 on
    fewer lanes than particles, by the per-lane budgets."""
    _, tw, _, tc = both_worlds("cornell")
    _, ts = both_lt_settings(max_bounces=2, camera_samples=1)
    for n_paths in (3001, 2 * (1 << 20) + 3001):
        state, b_each = tlt.lt_init(n_paths, "cpu")
        assert float(state[tlt.LS_BUDGET].sum()) == n_paths
    film, counters = tlt.lt_trace_mega(
        tw, tc, ts, 8, 8, 3001, tm.TorchUniforms(_gen(5)), device="cpu")
    assert int(counters[prof.LIGHT_RAYS]) == 3001
    assert np.isfinite(film.numpy()).all() and float(film.sum()) > 0


@pytest.mark.parametrize("recipe,cam", [("cornell_box", "CORNELL_CAMERA"),
                                        ("lens_box", "LENS_BOX_CAMERA")])
def test_lt_matches_pt_mean(recipe, cam):
    """Light and path tracing are unbiased estimators of the same film: the
    means agree within Monte Carlo noise (the lens box adds direct lens
    hits on the proxy, MIS-paired with the lens connections)."""
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build("cpu")
    camera = make_projective_camera(**getattr(scenes, cam), device="cpu")
    if recipe == "lens_box":
        assert int((world.prims.mat_kind == 2).sum()) == 1
    pt_film, _, _ = render_regen(
        world, camera, PTSettings(max_bounces=4, min_bounces=4,
                                  light_samples=1, russian_roulette=False),
        16, 16, 32, generator=_gen(12))
    lt_film, profile, _ = render_splatted(
        world, camera, LTSettings(max_bounces=4, min_bounces=4,
                                  camera_samples=1, russian_roulette=False),
        16, 16, 160, generator=_gen(13))
    pt_y, lt_y = float(pt_film[..., 1].mean()), float(lt_film[..., 1].mean())
    assert profile.light_rays == 16 * 16 * 160
    assert lt_y > 0
    assert abs(lt_y - pt_y) / pt_y < 0.15, (pt_y, lt_y)


def _many_lights(n):
    b = SceneBuilder()
    emit = b.add_curve(spectral.FlatCurve(1.0), name="emit")
    ml = b.add_diffuse_light(emit, emit, 0, name="ml")
    for i in range(n):
        b.add_sphere([i * 0.1, 0.0, 0.0], 0.01, ml)
    return b.build("cpu")


@pytest.mark.parametrize("what", ["uv_texture", "too_many_prims",
                                  "too_many_lights", "camera"])
def test_gate_refuses_with_roadmap_item(what):
    """A scene the LT megakernel's gate refuses renders through the
    light-tracing wavefront `lt_trace` by default and raises only under
    use_megakernel=True; a camera the port does not have raises on either
    route, `lt_trace` naming the ROADMAP item that ports it."""
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
    if what == "uv_texture":
        world = scenes.textured_cornell(SceneBuilder(), spectral).build("cpu")
    elif what == "too_many_prims":
        world = scenes.random_prims(SceneBuilder(), spectral, grid=64,
                                    n_each=4).build("cpu")
    elif what == "too_many_lights":
        world = _many_lights(tlt.LT_MAX_LIGHTS + 1)
    else:
        world = scenes.cornell_box(SceneBuilder(), spectral).build("cpu")
        cam = object()
    settings = LTSettings(max_bounces=2)
    assert tlt.lt_gate_refusal(world, cam, settings) is not None
    with pytest.raises(NotImplementedError, match="use_megakernel=True"):
        render_splatted(world, cam, settings, 8, 8, 1, use_megakernel=True)
    if what == "camera":
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 10"):
            render_splatted(world, cam, settings, 8, 8, 1)
        return
    stats = {}
    film, profile, _ = render_splatted(world, cam, settings, 8, 8, 1,
                                       generator=_gen(4), stats=stats)
    assert stats["route"] == "lt_trace" and profile.light_rays == 64
    assert film.shape == (8, 8, 3) and bool(torch.isfinite(film).all())
    if what == "too_many_lights":
        assert tlt.lt_gate_refusal(_many_lights(tlt.LT_MAX_LIGHTS), cam,
                                   settings) is None


def test_wrappers_take_plain_twins_on_cpu():
    """On CPU tensors the three wrappers run their twins and count no
    launch; a route's wrapper refuses the other route's scene, and every
    wrapper a film of another size than the scene's."""
    _, tw, _, tc = both_worlds("hdri")
    _, ts = both_lt_settings()
    scene = tlt.build_lt_scene(tw, tc, ts, 16, 16, "cpu")
    assert not scene.spawn_inkernel
    with pytest.raises(ValueError):
        tlt.build_lt_scene(tw, tc, ts, 16, 16, "cpu", spawn_inkernel=True)
    state, _ = tlt.lt_init(4096, "cpu")
    unif = tm.TorchUniforms(_gen(3))
    u = unif.round(0, tlt.nu_lt(1), 4096, "cpu")
    launches = (tlt.SHADE_LAUNCHES, tlt.FINALIZE_SPAWN_LAUNCHES,
                tlt.FINALIZE_LAUNCHES)
    calls = tlt.PLAIN_CALLS
    film = torch.zeros((16 * 16, 3))
    q = tlt.lt_shade(u, state, scene, film)
    assert q.shape == (tlt.q2_rows(1), 4096) and not q.any()
    feed = tlt.spawn_feed_for(scene, ts, unif, 0, 4096)
    out = tlt.lt_finalize(u, state, q, feed, scene, film)
    assert out[tlt.k4_aux(1)["resp"]].sum() == 4096
    assert (tlt.SHADE_LAUNCHES, tlt.FINALIZE_SPAWN_LAUNCHES,
            tlt.FINALIZE_LAUNCHES) == launches
    assert tlt.PLAIN_CALLS == calls + 2
    with pytest.raises(ValueError):
        tlt.lt_finalize_spawn(u, torch.zeros((tlt.NUSP, 4096)), state, q,
                              scene, film)
    with pytest.raises(ValueError):
        tlt.lt_finalize(u, state, q[:8], feed, scene, film)
    for wrong in (film[:-1], torch.zeros((16, 16, 3))):
        with pytest.raises(ValueError, match="film"):
            tlt.lt_shade(u, state, scene, wrong)
        with pytest.raises(ValueError, match="film"):
            tlt.lt_finalize(u, state, q, feed, scene, wrong)
