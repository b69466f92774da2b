"""Scene intake: the port's numpy SceneBuilder against the JAX SceneBuilder
on the same recipes, `world_from_numpy` on the JAX World's leaves, and the
fused round's table bake against the JAX `build_mega_scene`. Every array
the port keeps must be equal (exactly: the same numpy arithmetic)."""

import numpy as np
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jax_mk
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral as torch_spectral
from pathtracer_tpu_torch.kernels import megakernel as torch_mk
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.world.world import field_names, world_from_numpy

from torch_ref_helpers import (
    FURNACE_SETTINGS,
    NEE_SETTINGS,
    RECIPES,
    both_settings,
    both_worlds,
    jax_world_fields,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=sorted(RECIPES))
def worlds(request):
    return request.param, both_worlds(request.param)


def _assert_fields_equal(got: dict, ref: dict):
    for name in field_names():
        g, r = np.asarray(got[name]), np.asarray(ref[name])
        assert g.shape == r.shape, name
        assert g.dtype.kind == r.dtype.kind, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_builder_matches_jax(worlds):
    _, (jw, tw, _, _) = worlds
    _assert_fields_equal(tw.numpy_fields(), jax_world_fields(jw, field_names()))


def test_world_from_jax_leaves(worlds):
    """The JAX World's leaves through world_from_numpy give the port's own
    build of the same recipe."""
    _, (jw, tw, _, _) = worlds
    w = world_from_numpy(jax_world_fields(jw, field_names()), "cpu")
    _assert_fields_equal(w.numpy_fields(), tw.numpy_fields())


def test_mega_bake_matches_jax(worlds):
    recipe, (jw, tw, jc, tc) = worlds
    kw = FURNACE_SETTINGS if recipe == "furnace" else NEE_SETTINGS
    js, ts = both_settings(**kw)
    if recipe == "light_grid":
        # 25 lights: both gates refuse it (the regen integrator's scene)
        assert not jax_mk.mega_available(jw, jc, js)
        assert torch_mk.gate_refusal(tw, tc, ts) is not None
        return
    assert jax_mk.mega_available(jw, jc, js)
    assert torch_mk.gate_refusal(tw, tc, ts) is None
    ref = jax_mk.build_mega_scene(jw, jc, js)
    got = torch_mk.build_mega_scene(tw, tc)
    for name in ("prim_tab", "dense_tab", "mat_tab", "light_tab", "spec_tab"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for key, value in got.consts.items():
        assert ref.consts[key] == value, key


def test_chip_scene_shapes():
    _, tw, _, tc = both_worlds("chip")
    scene = torch_mk.build_mega_scene(tw, tc)
    assert tw.prims.count == 32
    assert tuple(scene.dense_tab.shape) == (32, 128)
    assert tuple(scene.prim_tab.shape) == (24, 128)
    assert tuple(scene.spec_tab.shape) == (32, 512)
    assert scene.consts["has_ggx"] and scene.consts["has_metal"]
    types = set(scene.prim_tab[0, :28].tolist())
    assert types == {0.0, 1.0, 2.0}  # triangles, spheres, rects


@pytest.mark.parametrize("what", ["transform", "medium", "texels",
                                  "mesh_transform", "instancing"])
def test_builder_refuses_outside_slice(what):
    b = SceneBuilder()
    c = b.add_curve(torch_spectral.FlatCurve(0.5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "transform":
            b.add_transform(np.eye(4))
        elif what == "medium":
            # media build; medium-aware settings take at most 16 of them
            # (17 table rows with vacuum), as the JAX gate does
            for _ in range(17):
                med = b.add_medium_hg(c, c, c)
            eta = b.add_curve(torch_spectral.FlatCurve(1.03))
            b.add_sphere([0.0, 0.0, 0.0], 1.0, b.add_ggx(
                0.001, eta, c, c, permeability=1.0, inner_medium=med))
            world = b.build("cpu")
            assert world.mediums.count == 18
            assert int(world.mats.inner_medium[0]) == 17
            cam = make_projective_camera(**scenes.CORNELL_CAMERA,
                                         device="cpu")
            torch_mk.build_mega_scene(world, cam)  # surface transport
            torch_mk.build_mega_scene(world, cam, settings=both_settings(
                **NEE_SETTINGS, medium_aware=True)[1])
        elif what == "texels":
            # multi-texel textures build, and the texture-feed round takes
            # them as a lambertian's reflectance; the megakernel refuses
            # them anywhere else, as the JAX gate does
            b.add_texture([(np.ones((2, 2), np.float32), c)])
            m = b.add_lambertian(b.add_texture([(np.ones((1, 1),
                                                         np.float32), c)]))
            b.add_sphere([0.0, 0.0, 0.0], 1.0, m)
            torch_mk.build_mega_scene(
                b.build("cpu"),
                make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu"))
        elif what == "mesh_transform":
            b.add_mesh(np.eye(3), [[0, 1, 2]], None, 0, transform=np.eye(4))
        else:
            b.add_mesh(np.eye(3), [[0, 1, 2]], None, 0, mesh_key="m")


def test_gate_refuses_large_scene():
    """More than 4 chunks of 32 prims is the two-program round's job; more
    than 8192 prims is outside the megakernel (the regen integrator without
    kernels, ROADMAP §1 item 5)."""
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
    _, ts = both_settings(**NEE_SETTINGS)
    w = scenes.random_prims(SceneBuilder(), torch_spectral, grid=8,
                            n_each=4).build("cpu")
    assert w.prims.count > 128
    assert torch_mk.gate_refusal(w, cam, ts) is None
    assert not torch_mk.fused_ok(torch_mk.build_mega_scene(w, cam))
    big = scenes.random_prims(SceneBuilder(), torch_spectral, grid=64,
                              n_each=4).build("cpu")
    assert big.prims.count > torch_mk.MEGA_MAX_PRIMS
    assert torch_mk.gate_refusal(big, cam, ts) is not None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_mk.build_mega_scene(big, cam)
