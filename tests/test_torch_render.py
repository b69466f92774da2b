"""The whole slice on the CPU: the port's `render_regen` (plain fused round)
against the JAX package's `pt_trace_regen_mega` (Pallas interpret mode) on
the chip scene at 64x64 @ 4 spp, then the HWSS furnace and the film files;
the routing of scenes between the fused and the two-program round, and of
the scenes outside the megakernel's gate to the regen integrator without
kernels (test_torch_render_gem.py holds a two-program
render against JAX, test_torch_env.py the HDR furnace).

- Uniforms replayed from JAX: the films must agree — mean within 1e-2
  relative and >= 99% of pixels within rtol 1e-3 (only the few lanes whose
  RR or shadow decision flips on f32 op order may diverge).
- The port's own torch.Generator: film mean within rtol 0.2 and counters
  within rtol 0.08 of the JAX render, the JAX package's own standard for two
  sample streams (tests/test_kernels_pallas.py:78-119).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu import tonemap as jax_tm
from pathtracer_tpu.tonemap import read_exr
from pathtracer_tpu.tonemap import tonemap_to_rgb as jax_tonemap
from pathtracer_tpu.tonemap.io_png import read_png
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.renderer.output import output_film
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch import tonemap as torch_tm
from pathtracer_tpu_torch.tonemap import Reinhard0, tonemap_to_rgb

from torch_ref_helpers import (
    FURNACE_SETTINGS,
    NEE_SETTINGS,
    JaxReplay,
    both_settings,
    both_worlds,
)

torch.set_num_threads(2)

W = H = 64
SPP = 4


@pytest.fixture(scope="module")
def chip():
    jw, tw, jc, tc = both_worlds("chip")
    js, ts = both_settings(**NEE_SETTINGS)
    key = jax.random.PRNGKey(3)
    acc, counters = jm.pt_trace_regen_mega(jw, jc, js, W, H, SPP, key,
                                           interpret=True)
    ref = np.asarray(acc).reshape(H, W, 3) / SPP
    film, profile, _ = render_regen(tw, tc, ts, W, H, SPP,
                                    uniforms=JaxReplay(key))
    return dict(ref=ref, ref_counters=np.asarray(counters), film=film.numpy(),
                profile=profile, world=tw, camera=tc, settings=ts)


def _counts(profile):
    return np.array([profile.camera_rays, profile.bounce_rays,
                     profile.shadow_rays, profile.light_rays,
                     profile.env_hits], np.float64)


def test_replayed_render_matches_jax(chip):
    ref, film = chip["ref"], chip["film"]
    assert film.shape == (H, W, 3) and np.isfinite(film).all()
    np.testing.assert_allclose(film.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-2)
    close = np.isclose(film, ref, rtol=1e-3, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    got, want = _counts(chip["profile"]), chip["ref_counters"]
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_own_generator_render_matches_jax_statistically(chip):
    film, profile, _ = render_regen(
        chip["world"], chip["camera"], chip["settings"], W, H, SPP,
        generator=torch.Generator().manual_seed(11))
    film = film.numpy()
    assert np.isfinite(film).all() and film[..., 1].mean() > 1e-3
    np.testing.assert_allclose(film.mean(axis=(0, 1)),
                               chip["ref"].mean(axis=(0, 1)), rtol=0.2)
    want = chip["ref_counters"]
    nz = want > 0
    np.testing.assert_allclose(_counts(profile)[nz], want[nz], rtol=0.08)


def test_dispersive_furnace_hwss():
    """Hero-wavelength spectral MIS at C = 4: a near-delta dispersive sphere
    in a unit environment must render uniform (tests/test_spectral_mis.py)."""
    _, tw, _, tc = both_worlds("furnace")
    _, ts = both_settings(**FURNACE_SETTINGS, hwss=True)
    film, _, _ = render_regen(tw, tc, ts, 16, 16, 64,
                              generator=torch.Generator().manual_seed(3))
    y = film[..., 1].numpy()
    center = y[5:11, 5:11].mean()
    corner = np.concatenate([y[:3, :3].ravel(), y[-3:, -3:].ravel()]).mean()
    assert abs(center / corner - 1.0) < 0.12


def test_film_files_read_back(chip, tmp_path):
    film = chip["film"]
    exr, png = output_film(film, "chip", Reinhard0(),
                           output_dir=str(tmp_path))
    display, linear = tonemap_to_rgb(torch.as_tensor(film), Reinhard0())
    np.testing.assert_array_equal(read_exr(exr), linear.numpy())
    img = read_png(png)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    want = (np.clip(display.numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(img, want)
    assert os.path.getsize(exr) > H * W * 12


@pytest.mark.parametrize("colorspace", ["Rec709", "sRGB", "Rec2020"])
@pytest.mark.parametrize("mapper", ["Clamp", "Reinhard0", "Reinhard0x3",
                                    "Reinhard1", "Reinhard1x3"])
def test_tonemap_matches_jax(chip, mapper, colorspace):
    film = chip["ref"]
    d_ref, l_ref = jax_tonemap(jnp.asarray(film), getattr(jax_tm, mapper)(),
                               colorspace)
    d, lin = tonemap_to_rgb(torch.as_tensor(film), getattr(torch_tm, mapper)(),
                            colorspace)
    np.testing.assert_allclose(lin.numpy(), np.asarray(l_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("recipe,route", [
    ("chip", "fused"), ("furnace", "fused"), ("gem", "two_prog"),
    ("hdri", "two_prog"), ("sun", "two_prog"), ("textured", "texfeed"),
    ("textured_sun", "texfeed")])
def test_render_routes_by_gate(monkeypatch, recipe, route):
    """The fused round for at most 4 chunks under a constant environment
    without uv textures, the texture-feed round for uv-textured
    lambertians, the two-program round otherwise, one round call per
    round."""
    calls = {"fused": 0, "two_prog": 0, "texfeed": 0}
    for name in calls:
        fn = getattr(tm, f"{name}_round")

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(tm, f"{name}_round", counted)
    _, tw, _, tc = both_worlds(recipe)
    _, ts = both_settings(**{**NEE_SETTINGS, "max_bounces": 3})
    stats = {}
    film, profile, _ = render_regen(tw, tc, ts, 8, 8, 1, stats=stats,
                                    generator=torch.Generator().manual_seed(1))
    assert calls[route] == stats["rounds"] > 0
    assert sum(calls.values()) == stats["rounds"]
    assert np.isfinite(film.numpy()).all() and profile.camera_rays == 64


def _out_of_gate_world(what):
    """The Cornell box made to fall outside the megakernel's gate: with 17
    media (under medium-aware settings), with a multi-texel texture no
    lambertian reflects, or with the 8192-triangle height field and 12
    random prims of `random_prims` in it."""
    b = scenes.cornell_box(SceneBuilder(), spectral)
    if what == "medium":
        c = b.curve_index("white")
        for _ in range(16):
            b.add_medium_hg(c, c, c)
    elif what == "uv_texture":
        c = b.curve_index("white")
        b.add_texture([(np.ones((4, 4), np.float32), c)])
    else:
        scenes.random_prims(b, spectral, grid=64, n_each=4)
    return b.build("cpu")


@pytest.mark.parametrize("what", ["medium", "uv_texture", "too_many_prims"])
def test_render_refuses_with_roadmap_item(what):
    """Medium-aware settings over more than 16 media, a multi-texel texture
    used other than as a lambertian's reflectance or the HDR map, and scenes
    over 8192 prims fall outside the megakernel's gate and render through
    the regen integrator without kernels; `use_megakernel=True` still
    refuses them, naming the gate. Medium-aware settings on a scene the
    gate takes stay on the megakernel."""
    _, ts = both_settings(**NEE_SETTINGS)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
    if what == "medium":
        ts = type(ts)(**{**ts.__dict__, "medium_aware": True})
        world = scenes.cornell_box(SceneBuilder(), spectral).build("cpu")
        assert tm.gate_refusal(world, cam, ts) is None
    world = _out_of_gate_world(what)
    assert tm.gate_refusal(world, cam, ts) is not None
    with pytest.raises(NotImplementedError, match="render_regen renders"):
        render_regen(world, cam, ts, 8, 8, 1, use_megakernel=True)
    stats = {}
    film, profile, _ = render_regen(world, cam, ts, 8, 8, 1, stats=stats,
                                    generator=torch.Generator().manual_seed(2))
    assert stats["route"] == "regen" and stats["rounds"] > 0
    film = film.numpy()
    assert np.isfinite(film).all() and film[..., 1].mean() > 0.0
    assert profile.camera_rays == 64


def test_render_refuses_transformed_world():
    """A world with per-prim transforms raises, naming ROADMAP §1 items 9
    and 13 (the dense sweep kernel has no per-prim transform)."""
    _, ts = both_settings(**NEE_SETTINGS)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
    world = scenes.cornell_box(SceneBuilder(), spectral).build("cpu")
    world = dataclasses.replace(world, prims=dataclasses.replace(
        world.prims, xf_inv=world.prims.xf_inv.repeat(2, 1, 1),
        xf_fwd=world.prims.xf_fwd.repeat(2, 1, 1)))
    for use in (None, False):
        with pytest.raises(NotImplementedError, match="items 9 and 13"):
            render_regen(world, cam, ts, 8, 8, 1, use_megakernel=use)
