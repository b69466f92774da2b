"""The texture-feed round's pieces in the port against the JAX package: the
PNG reader, the texture-feed bake (`_M_TEXF`, `mat2tex`, `uvtab`, the
(texel, λ-knot) pair table), `tex_feed` on both branches, the K1 rows sweep
(`sweep_closest_rows_plain`) and K2 (`shade_plain`), on `textured_cornell`
(the checker wall, the RGBA cloud floor, a striped sphere, a tiled
icosahedron and a dotted disk) and `textured_sun` (the checker sphere under
the Sun). The JAX kernels run in interpret mode at a 1024-lane tile, as in
test_torch_two_prog.py; each port function gets the JAX function's own
inputs (the JAX state, hit rows and feed rows of two chained rounds).

Tolerances, and why:
- the PNG reader and `load_png_rgba` are the same integer and numpy
  arithmetic: equal; the bake is the same numpy arithmetic: equal;
- the rows sweep: prim ids exact and t within rtol 1e-5 on live lanes (the
  same prim tests in the same order; t divides where XLA may contract a
  multiply-add). A dead lane gets t = inf and id -1: the port skips dead
  lanes, the Pallas sweep sweeps them;
- tex_feed: >= 99.9% of values within rtol 1e-5 and all within rtol 1e-3:
  XLA's CPU backend contracts multiply-adds into FMAs and torch does not,
  and atan2/arccos amplify an ulp near the poles; a lane whose uv lands on
  a texel edge within that error would pick the neighbouring texel;
- K2: check_k2 (test_torch_two_prog.py).

On CPU tensors `tex_feed` is its plain twin `tex_feed_plain` (equal, no
kernel launched), and a traced render counts one `tex_feeds` a round and
no `tex_feeds_kernel`; untraced, it records nothing.
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu.parsing.images import load_png_rgba as jax_load_png
from pathtracer_tpu.parsing.images import srgb_to_linear as jax_srgb
from pathtracer_tpu.tonemap.io_png import read_png as jax_read_png
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.kernels import dense as tdense
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.parsing.images import load_png_rgba, srgb_to_linear
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.tonemap.io_png import read_png
from pathtracer_tpu_torch.utils import profile

from torch_ref_helpers import (
    NEE_SETTINGS,
    both_settings,
    both_worlds,
    chained_texfeed,
    check_k2,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["checker", "gradient", "single_pixel",
                                  "test"])
def test_png_reader_matches_jax(name):
    path = os.path.join(ROOT, "data", "textures", f"{name}.png")
    got, ref = read_png(path), jax_read_png(path)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    rgba = load_png_rgba(path)
    np.testing.assert_array_equal(rgba, jax_load_png(path))
    np.testing.assert_array_equal(srgb_to_linear(rgba), jax_srgb(rgba))


def _bakes(recipe):
    jw, tw, jc, tc = both_worlds(recipe)
    js, _ = both_settings(**NEE_SETTINGS)
    return jm.build_mega_scene(jw, jc, js), tm.build_mega_scene(tw, tc)


@pytest.mark.parametrize("recipe", ["textured", "textured_sun"])
def test_texfeed_bake_matches_jax(recipe):
    ref, got = _bakes(recipe)
    assert got.consts["tex_feed"] and ref.consts["tex_feed"]
    assert not tm.fused_ok(got)
    tex, bank, mat2tex, uvtab, lut = ref.tex_args
    np.testing.assert_array_equal(got.tex.mat2tex.numpy(), np.asarray(mat2tex))
    np.testing.assert_array_equal(got.tex.uvtab.numpy(), np.asarray(uvtab))
    np.testing.assert_array_equal(got.mat_tab[tm._M_TEXF].numpy(),
                                  np.asarray(ref.mat_tab[jm._M_TEXF]))
    assert lut is not None and got.tex.lut is not None
    for name in ("pairs", "meta"):
        np.testing.assert_array_equal(got.tex.lut[name].numpy(),
                                      np.asarray(lut[name]), err_msg=name)
    for name in ("res", "lam_lo", "lam_hi"):
        assert got.tex.lut[name] == lut[name], name
    np.testing.assert_array_equal(got.tex.tex.atlas.numpy(),
                                  np.asarray(tex.atlas))


def test_texfeed_bake_without_lut(monkeypatch):
    """Over TEX_LUT_MAX_TEXELS texels both bakes leave the pair table out
    (the feed then runs eval_texture)."""
    monkeypatch.setattr(jm, "TEX_LUT_MAX_TEXELS", 0)
    monkeypatch.setattr(tm, "TEX_LUT_MAX_TEXELS", 0)
    ref, got = _bakes("textured")
    assert ref.tex_args[4] is None and got.tex.lut is None


def test_gate_takes_textures_where_jax_does():
    """uv textures as a lambertian's reflectance are in the gate (fused
    round refused); a multi-texel texture anywhere else is not."""
    _, tw, _, tc = both_worlds("textured")
    _, ts = both_settings(**NEE_SETTINGS)
    assert tm.gate_refusal(tw, tc, ts) is None
    b = scenes.cornell_box(SceneBuilder(), spectral)
    b.add_texture([(np.ones((4, 4), np.float32), b.curve_index("white"))])
    w = b.build("cpu")
    assert not tm.mega_available(w, tc, ts)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 5"):
        tm.build_mega_scene(w, tc)


@pytest.fixture(scope="module", params=[("textured", 1), ("textured", 4),
                                        ("textured_sun", 1),
                                        ("textured_fog", 4)],
                ids=["C1", "C4", "sun_C1", "fog_C4"])
def rounds(request):
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        recipe, c = request.param
        yield chained_texfeed(recipe, c, medium=recipe == "textured_fog")
    finally:
        jm.TILE, jm.SUB = tile, sub


def assert_close(got, want, name):
    ok = np.isclose(got, want, rtol=1e-5, atol=1e-7)
    assert ok.mean() >= 0.999, f"{name}: {ok.mean()} within rtol 1e-5"
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2"])
def test_rows_sweep_matches_jax(rounds, r):
    x = rounds[r]
    tp = tdense.sweep_closest_rows_plain(torch.as_tensor(x["jin"]),
                                         x["scene"].dense_tab, tm.S_O,
                                         tm.S_ALIVE).numpy()
    live = x["alive"]
    assert live.any() and (~live).any()
    np.testing.assert_array_equal(tp[1][live], x["jtp"][1][live])
    hit = live & (tp[1] >= 0)
    np.testing.assert_allclose(tp[0][hit], x["jtp"][0][hit], rtol=1e-5)
    assert (tp[0][~live] == np.inf).all() and (tp[1][~live] == -1).all()
    assert not tp[2:].any()


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "eval_texture"])
@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2"])
def test_tex_feed_matches_jax(rounds, r, lut, monkeypatch):
    """Both branches against the JAX feed on the JAX state and hit rows; the
    LUT-less branch against JAX's LUT-less feed."""
    x = rounds[r]
    feed, c = x["scene"].tex, x["a"].c_lanes
    jtf = x["jtf"]
    if not lut:
        monkeypatch.setattr(jm, "TEX_LUT_MAX_TEXELS", 0)
        monkeypatch.setattr(tm, "TEX_LUT_MAX_TEXELS", 0)
        ref, got = _bakes(x["recipe"])
        feed = got.tex
        assert feed.lut is None
        jtf = np.asarray(jm._tex_feed(ref.tex_args, x["jin"], x["jtp"], c))
    tf = tm.tex_feed(feed, torch.as_tensor(x["jin"]), torch.as_tensor(
        x["jtp"]), c).numpy()
    assert tf.shape == (tm.tf_rows(c), x["jin"].shape[1]) == jtf.shape
    assert_close(tf, jtf, "tf")
    hit = x["jtp"][1] >= 0
    assert (tf[:c][:, hit] > 0).any() and not tf[:, ~hit].any()
    assert not tf[c:].any()


@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2"])
def test_k2_matches_jax(rounds, r):
    """shade_plain on the JAX state, hit rows and feed rows, and K2 of the
    port's own chain, against the JAX _k2_call. Under medium-aware settings
    (`textured_fog`) K2 takes the medium feed beside the texture feed, and
    the sampled pdf is held as test_torch_medium_round.py holds it."""
    x = rounds[r]
    scene, a = x["scene"], x["a"]
    state = torch.as_tensor(x["jin"])
    u12 = x["u12"]
    ef = (tm.env_feed(scene.env, state, u12, a.light_samples, a.c_lanes)
          if scene.env is not None else None)
    mf = (tm.med_feed(scene.med, state, u12, a.light_samples, a.c_lanes)
          if scene.med is not None else None)
    k2 = tm.shade_plain(u12, state, torch.as_tensor(x["jtp"]),
                        scene.prim_tab, scene.mat_tab, scene.light_tab,
                        scene.spec_tab, a, ef, torch.as_tensor(x["jtf"]), mf)
    ls = NEE_SETTINGS["light_samples"]
    fpdf_rtol = 5e-3 if a.medium else 1e-4
    check_k2(x["jk2"], k2.numpy(), x["alive"], ls, fpdf_rtol)
    check_k2(x["jk2"], x["k2"], x["alive"], ls, fpdf_rtol)
    # the textured surfaces are shaded with the fed reflectance; the camera
    # spawns in vacuum, so lanes scatter from the second round on
    assert x["k2"][tm.O_AT_SURF].sum() > 0
    if a.medium and r == 1:
        assert x["k2"][tm.O_SCAT].sum() > 0


@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2"])
def test_tex_feed_on_cpu_is_the_plain_twin(rounds, r):
    x = rounds[r]
    state, tp = torch.as_tensor(x["jin"]), torch.as_tensor(x["jtp"])
    c = x["a"].c_lanes
    launches = tm.TEX_FEED_LAUNCHES
    tf = tm.tex_feed(x["scene"].tex, state, tp, c)
    assert torch.equal(tf, tm.tex_feed_plain(x["scene"].tex, state, tp, c))
    assert tm.TEX_FEED_LAUNCHES == launches


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "off"])
def test_texture_feed_counts(traced, monkeypatch):
    """A traced CPU render of the textured box counts a texture feed a
    round, none of them served by the kernel; untraced, nothing reaches a
    recorder."""
    seen = []
    count = profile.Recorder.count

    def spy(self, name, value):
        seen.append(name)
        count(self, name, value)

    monkeypatch.setattr(profile.Recorder, "count", spy)
    world = scenes.textured_cornell(SceneBuilder(), spectral).build("cpu")
    cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device="cpu")
    stats = {}

    def render():
        render_regen(world, cam, PTSettings(light_samples=1), 16, 16, 1,
                     generator=torch.Generator().manual_seed(5), stats=stats)

    launches = tm.TEX_FEED_LAUNCHES
    if traced:
        with profile.tracing() as rec:
            render()
        rec.resolve()
        assert stats["route"] == "megakernel" and stats["rounds"] > 0
        assert rec.values("tex_feeds") == [1] * stats["rounds"]
        assert rec.total("tex_feeds_kernel") == 0
        assert len(rec.values("tex_feeds_kernel")) == stats["rounds"]
    else:
        render()
        assert stats["rounds"] > 0 and profile.recorder() is None
        assert seen == []
    assert tm.TEX_FEED_LAUNCHES == launches
