"""The port's light-tracing wavefront (`integrator/lt.py:lt_trace`, plain
torch on the CPU, the dense sweep's plain twins under `World.intersect` /
`intersect_any`) against the JAX package's `lt_trace`:

- `_connect_to_camera` on seeded random vertices of the Cornell box (a
  pinhole) and of the lens box (a 0.12 aperture with the lens proxy in the
  scene, so the balance heuristic against the direct lens hit applies),
  with and without the vertex pdf callback: film uv and energy within rtol
  1e-5, validity and the unblocked-connection count equal;
- `lt_trace` with the JAX draws replayed on the Cornell box and on the
  lens box (direct lens hits), stratified there
  (`torch_ref_helpers.lt_trace_matches_jax`; test_torch_lt_trace_scenes.py
  takes the textured box and the HDR blob);
- `render_splatted`'s routes by `use_megakernel`, and light tracing through
  `lt_trace` against path tracing on the lens box: film mean Y within 0.15.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.integrator import lt as jlt
from pathtracer_tpu.utils import profile as jprof
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator import lt as tlt
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.renderer.splatted import render_splatted
from pathtracer_tpu_torch.utils import profile as prof

from torch_ref_helpers import both_worlds, lt_trace_matches_jax

torch.set_num_threads(2)

def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("recipe", ["cornell", "lens_box"])
@pytest.mark.parametrize("with_pdf", [False, True])
def test_connect_to_camera_matches_jax(recipe, with_pdf):
    jw, tw, jc, tc = both_worlds(recipe)
    rng = np.random.default_rng(11)
    n = 1024
    point = rng.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)
    normal = rng.normal(size=(n, 3))
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)) \
        .astype(np.float32)
    beta = rng.uniform(0.1, 2.0, n).astype(np.float32)
    lam = rng.uniform(380.0, 780.0, n).astype(np.float32)
    ul = rng.uniform(size=(n, 2)).astype(np.float32)
    n_conn = 2 if with_pdf else 1

    def jpdf(d):
        return jnp.abs(jnp.sum(jnp.asarray(normal) * d, -1)) / jnp.pi

    def tpdf(d):
        return torch.abs(torch.sum(torch.as_tensor(normal) * d, -1)) / np.pi

    normal_arg = None if recipe == "cornell" and not with_pdf else normal
    jfu, jfv, je, jvalid, jcount = jlt._connect_to_camera(
        jw, jc, jnp.asarray(point),
        None if normal_arg is None else jnp.asarray(normal_arg),
        jnp.asarray(beta), jnp.asarray(lam), jnp.asarray(ul), jprof.zeros(),
        bsdf_pdf_toward=jpdf if with_pdf else None, n_conn=n_conn)
    counters = torch.zeros(prof.N_COUNTERS, dtype=torch.float64)
    fu, fv, e, valid, counters = tlt._connect_to_camera(
        tw, tc.to("cpu"), torch.as_tensor(point),
        None if normal_arg is None else torch.as_tensor(normal_arg),
        torch.as_tensor(beta), torch.as_tensor(lam), torch.as_tensor(ul),
        counters, bsdf_pdf_toward=tpdf if with_pdf else None,
        n_conn=n_conn)
    jvalid = np.asarray(jvalid)
    assert 0 < jvalid.sum() < n
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    for got, ref in ((fu, jfu), (fv, jfv), (e, je)):
        np.testing.assert_allclose(got.numpy()[jvalid],
                                   np.asarray(ref)[jvalid], rtol=1e-5)
    assert float(counters[prof.CAMERA_RAYS]) == float(
        np.asarray(jcount)[jprof.CAMERA_RAYS])


@pytest.mark.parametrize("recipe,cs,stratified", [("cornell", 1, False),
                                                ("lens_box", 1, True)])
def test_lt_trace_matches_jax(recipe, cs, stratified):
    lt_trace_matches_jax(recipe, cs, stratified)


def _world(recipe, cam):
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build("cpu")
    return world, make_projective_camera(**getattr(scenes, cam),
                                         device="cpu")


@pytest.mark.parametrize("recipe,cam,in_gate", [
    ("cornell_box", "CORNELL_CAMERA", True),
    ("textured_cornell", "TEXTURED_CAMERA", False)])
def test_render_splatted_routes(recipe, cam, in_gate):
    """None: the megakernel in its gate, lt_trace elsewhere; False:
    lt_trace; True: the megakernel, refusing scenes outside its gate."""
    world, camera = _world(recipe, cam)
    settings = tlt.LTSettings(max_bounces=2)
    for use in (None, False, True):
        stats = {}
        if use and not in_gate:
            with pytest.raises(NotImplementedError, match="LT megakernel"):
                render_splatted(world, camera, settings, 8, 8, 1,
                                use_megakernel=use, stats=stats)
            continue
        film, profile, _ = render_splatted(
            world, camera, settings, 8, 8, 2, generator=_gen(3),
            use_megakernel=use, stats=stats, paths_per_chunk=32)
        mega = in_gate and use is not False
        assert stats["route"] == ("lt_mega" if mega else "lt_trace")
        assert mega or stats["chunks"] == 4
        assert profile.light_rays == 128
        assert torch.isfinite(film).all() and float(film[..., 1].mean()) > 0


def test_lt_trace_matches_pt_mean():
    """Light tracing through lt_trace and path tracing are unbiased
    estimators of the same film: on the lens box (direct lens hits
    MIS-paired with the lens connections) the means agree within Monte
    Carlo noise, at max and min bounces 4 without Russian roulette."""
    world, camera = _world("lens_box", "LENS_BOX_CAMERA")
    pt_film, _, _ = render_regen(
        world, camera, PTSettings(max_bounces=4, min_bounces=4,
                                  light_samples=1, russian_roulette=False),
        16, 16, 32, generator=_gen(12))
    stats = {}
    lt_film, profile, _ = render_splatted(
        world, camera, tlt.LTSettings(max_bounces=4, min_bounces=4,
                                      russian_roulette=False),
        16, 16, 160, generator=_gen(13), use_megakernel=False,
        paths_per_chunk=8192, stats=stats)
    pt_y, lt_y = float(pt_film[..., 1].mean()), float(lt_film[..., 1].mean())
    assert stats["route"] == "lt_trace"
    assert profile.light_rays == 16 * 16 * 160
    assert abs(lt_y - pt_y) / pt_y < 0.15, (pt_y, lt_y)
