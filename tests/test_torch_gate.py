"""The megakernels' scene gate (`kernels/megakernel.py:scene_refusal`),
which the path tracer's `gate_refusal` and the light tracer's
`lt_gate_refusal` call with their own light cap, texture exemption and
media cap: its verdict under surface settings, medium-aware settings and
the light tracer's on every recipe of `scenes.py` and on scenes built to
fall outside it, against the table below; then each public driver and bake
refuses an out-of-gate scene called directly, and evaluates the gate once a
call (no JAX)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.lt import LTSettings
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.kernels import lt_mega as lt
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.utils import profile

# (surface PT, medium-aware PT, LT): None where the gate takes the scene,
# "out" where it refuses it, "media" for medium-aware settings over
# MAX_MEDIA media
EXPECTED = {
    "cornell_box": (None, None, None),
    "light_grid_cornell": ("out", "out", None),
    "cornell_sharp": (None, None, None),
    "chip_scene": (None, None, None),
    "dispersive_furnace": (None, None, None),
    "random_prims": (None, None, None),
    "gem_cornell": (None, None, None),
    "mesh_cornell": (None, None, None),
    "hdri_blob": (None, None, None),
    "hdr_furnace": (None, None, None),
    "sun_sphere": (None, None, None),
    "textured_cornell": (None, None, "out"),
    "textured_sun": (None, None, "out"),
    "chip_lens": (None, None, None),
    "lens_box": (None, None, None),
    "spike_box": (None, None, None),
    "absorbing_sphere": (None, None, None),
    "scattering_furnace": (None, None, None),
    "nested_media": (None, None, None),
    "fog_cornell": (None, None, None),
    "textured_fog": (None, None, "out"),
    "textured_sizes": (None, None, "out"),
    # scenes built below
    "17_media": (None, "media", None),
    "unused_uv_texture": ("out", "out", "out"),
    "too_many_prims": ("out", "out", "out"),
    "16_lights": (None, None, None),
    "17_lights": ("out", "out", None),
    "128_lights": ("out", "out", None),
    "129_lights": ("out", "out", "out"),
    "transformed": ("out", "out", "out"),
    "not_projective": ("out", "out", "out"),
}
RECIPES = [n for n, f in vars(scenes).items()
           if inspect.isfunction(f) and not n.startswith("_")
           and list(inspect.signature(f).parameters)[:2] == ["b", "spectral"]
           and all(p.default is not p.empty for p in
                   list(inspect.signature(f).parameters.values())[2:])]


def _cam():
    return make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")


def _many_lights(n):
    b = SceneBuilder()
    emit = b.add_curve(spectral.FlatCurve(1.0), name="emit")
    ml = b.add_diffuse_light(emit, emit, 0, name="ml")
    for i in range(n):
        b.add_sphere([i * 0.1, 0.0, 0.0], 0.01, ml)
    return b.build("cpu")


def _scene(name):
    """-> (world, camera) of a recipe or of a scene built to test a cap."""
    if name in RECIPES:
        return getattr(scenes, name)(SceneBuilder(), spectral).build("cpu"), \
            _cam()
    if name.endswith("_lights"):
        return _many_lights(int(name.split("_")[0])), _cam()
    b = scenes.cornell_box(SceneBuilder(), spectral)
    c = b.curve_index("white")
    if name == "17_media":
        for _ in range(16):
            b.add_medium_hg(c, c, c)
    elif name == "unused_uv_texture":
        b.add_texture([(np.ones((4, 4), np.float32), c)])
    elif name == "too_many_prims":
        scenes.random_prims(b, spectral, grid=64, n_each=4)
    world = b.build("cpu")
    if name == "transformed":
        world = dataclasses.replace(world, prims=dataclasses.replace(
            world.prims, xf_inv=world.prims.xf_inv.repeat(2, 1, 1),
            xf_fwd=world.prims.xf_fwd.repeat(2, 1, 1)))
    return world, (object() if name == "not_projective" else _cam())


def _key(why):
    return None if why is None else {
        mk._NOT_IN_GATE: "out", mk._TOO_MANY_MEDIA: "media",
        lt._NOT_IN_GATE: "out"}[why]


def test_table_covers_every_recipe():
    assert set(RECIPES) <= set(EXPECTED)


@pytest.mark.parametrize("name", list(EXPECTED))
def test_gate_verdicts(name):
    world, cam = _scene(name)
    with profile.tracing() as rec:
        got = (_key(mk.gate_refusal(world, cam, PTSettings())),
               _key(mk.gate_refusal(world, cam,
                                    PTSettings(medium_aware=True))),
               _key(lt.lt_gate_refusal(world, cam, LTSettings())))
    assert got == EXPECTED[name]
    assert [s.name for s in rec.spans] == ["gate"] * 3


def _direct(call, world, cam):
    u = mk.TorchUniforms(torch.Generator().manual_seed(0))
    pt_s, lt_s = PTSettings(), LTSettings(max_bounces=2)
    if call == "pt_trace_regen_mega":
        return mk.pt_trace_regen_mega(world, cam, pt_s, 8, 8, 1, u)
    if call == "build_mega_scene":
        return mk.build_mega_scene(world, cam, settings=pt_s)
    if call == "lt_trace_mega":
        return lt.lt_trace_mega(world, cam, lt_s, 8, 8, 64, u)
    return lt.build_lt_scene(world, cam, lt_s, 8, 8)


@pytest.mark.parametrize("call", ["pt_trace_regen_mega", "build_mega_scene",
                                  "lt_trace_mega", "build_lt_scene"])
def test_direct_calls_refuse_out_of_gate_scenes(call):
    """Called directly, each driver and bake refuses a scene outside its
    gate with the gate's refusal and renders or bakes one inside it, each
    after one evaluation of the gate."""
    world, cam = _scene("129_lights")
    why = (mk._NOT_IN_GATE if call in ("pt_trace_regen_mega",
                                       "build_mega_scene")
           else lt._NOT_IN_GATE)
    with profile.tracing() as rec:
        with pytest.raises(NotImplementedError) as err:
            _direct(call, world, cam)
    assert str(err.value) == why
    assert [s.name for s in rec.spans] == ["gate"]
    with profile.tracing() as rec:
        _direct(call, *_scene("cornell_box"))
    assert sum(s.name == "gate" for s in rec.spans) == 1
