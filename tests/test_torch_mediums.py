"""The port's `mediums/` package against the JAX package's, function by
function on the same numpy inputs, and the medium table through both
packages' `SceneBuilder`s and bakes.

Tolerances, and why: rtol 1e-6 (atol 1e-7) on every function, both sides
being the same f32 expressions: XLA's CPU backend contracts multiply-adds
into FMAs and torch does not, and `log`, `exp` and `pow` are each library's
own, good to an ulp or two. The Rayleigh cosine is a Cardano root through a
cube root, which torch has not (`x ** (1/3)` on the positive radicand
stands in), and its `w - 1/w` cancels near u = 1/2, so it is held to atol
2e-6 on a value in [-1, 1]. Sampled directions are unit length to 1e-5.
The medium rows both packages build, the materials' medium ids and the
baked tables are equal exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu.mediums import hg as jhg
from pathtracer_tpu.mediums import rayleigh as jray
from pathtracer_tpu.mediums import tables as jtab
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.mediums import hg as thg
from pathtracer_tpu_torch.mediums import rayleigh as tray
from pathtracer_tpu_torch.mediums import tables as ttab

from torch_ref_helpers import both_settings, both_worlds, NEE_SETTINGS

torch.set_num_threads(2)

N = 4096
RTOL, ATOL = 1e-6, 1e-7


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        g=rng.uniform(-0.95, 0.95, N).astype(np.float32),
        cos=rng.uniform(-1.0, 1.0, N).astype(np.float32),
        u1=rng.random(N).astype(np.float32),
        u2=rng.random(N).astype(np.float32),
        lam=rng.uniform(380.0, 730.0, N).astype(np.float32),
        sigma=np.where(rng.random(N) < 0.2, 0.0,
                       rng.uniform(0.0, 4.0, N)).astype(np.float32),
        dist=rng.uniform(0.0, 3.0, N).astype(np.float32), d=d)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fn", ["hg_phase", "hg_sample_cos",
                                "sample_free_flight", "beer_lambert_tr",
                                "rayleigh_sigma_s", "rayleigh_phase",
                                "rayleigh_sample_cos"])
def test_scalar_functions_match_jax(fn):
    x = _inputs()
    args = {
        "hg_phase": ("g", "cos"), "hg_sample_cos": ("g", "u1"),
        "sample_free_flight": ("sigma", "u1"),
        "beer_lambert_tr": ("sigma", "dist"), "rayleigh_phase": ("cos",),
        "rayleigh_sample_cos": ("u1",)}.get(fn)
    if fn == "rayleigh_sigma_s":
        ior = (1.0 + x["u2"]).astype(np.float32)
        got = tray.rayleigh_sigma_s(_t(ior), _t(x["lam"]), 1.2e7)
        ref = jray.rayleigh_sigma_s(jnp.asarray(ior), jnp.asarray(x["lam"]),
                                    1.2e7)
    else:
        jmod, tmod = ((jray, tray) if fn.startswith("rayleigh")
                      else (jhg, thg))
        got = getattr(tmod, fn)(*[_t(x[k]) for k in args])
        ref = getattr(jmod, fn)(*[jnp.asarray(x[k]) for k in args])
    if fn == "hg_sample_cos":
        # g near 0 switches to the isotropic branch on both sides alike
        x["g"][:8] = [0.0, 1e-5, -1e-5, 5e-5, 2e-4, -2e-4, 1e-7, 0.0]
        got = thg.hg_sample_cos(_t(x["g"]), _t(x["u1"]))
        ref = jhg.hg_sample_cos(jnp.asarray(x["g"]), jnp.asarray(x["u1"]))
    _close(got, ref, atol=2e-6 if fn == "rayleigh_sample_cos" else ATOL)
    assert np.isfinite(np.asarray(got)).sum() == np.isfinite(
        np.asarray(ref)).sum()


@pytest.mark.parametrize("kind", ["hg", "rayleigh"])
def test_sample_direction_matches_jax(kind):
    """The sampled directions use the Frisvad/Duff frame of both packages:
    equal component for component, unit length, and at the sampled cosine
    to the axis."""
    x = _inputs(1)
    if kind == "hg":
        wo, pdf = thg.hg_sample_direction(_t(x["g"]), _t(x["d"]),
                                          _t(x["u1"]), _t(x["u2"]))
        jwo, jpdf = jhg.hg_sample_direction(
            jnp.asarray(x["g"]), jnp.asarray(x["d"]), jnp.asarray(x["u1"]),
            jnp.asarray(x["u2"]))
        cos = thg.hg_sample_cos(_t(x["g"]), _t(x["u1"]))
    else:
        wo, pdf = tray.rayleigh_sample_direction(_t(x["d"]), _t(x["u1"]),
                                                 _t(x["u2"]))
        jwo, jpdf = jray.rayleigh_sample_direction(
            jnp.asarray(x["d"]), jnp.asarray(x["u1"]), jnp.asarray(x["u2"]))
        cos = tray.rayleigh_sample_cos(_t(x["u1"]))
    _close(wo, jwo, rtol=1e-5, atol=4e-6)
    _close(pdf, jpdf, rtol=1e-5)
    _close(torch.linalg.norm(wo, dim=-1), np.ones(N), rtol=0, atol=1e-5)
    _close((wo * _t(x["d"])).sum(-1), cos, rtol=0, atol=1e-5)


def test_vacuum_only():
    v, jv = ttab.Mediums.vacuum_only(), jtab.Mediums.vacuum_only()
    assert v.count == jv.count == 1
    for f in ("mtype", "g_idx", "sigma_s_idx", "sigma_a_idx", "ior_idx",
              "corrective"):
        np.testing.assert_array_equal(getattr(v, f).numpy(),
                                      np.asarray(getattr(jv, f)))
    assert (ttab.MED_VACUUM, ttab.MED_HG, ttab.MED_RAYLEIGH) == (
        jtab.MED_VACUUM, jtab.MED_HG, jtab.MED_RAYLEIGH)


@pytest.fixture(scope="module", params=["absorbing_sphere", "nested_media",
                                        "fog_cornell"])
def media(request):
    return request.param, both_worlds(request.param)


def test_built_media_match_jax(media):
    """The medium rows (vacuum first) and the boundaries' medium ids of
    both packages' scenes are equal."""
    name, (jw, tw, _, _) = media
    for f in ("mtype", "g_idx", "sigma_s_idx", "sigma_a_idx", "ior_idx",
              "corrective"):
        got, ref = getattr(tw.mediums, f).numpy(), np.asarray(
            getattr(jw.mediums, f))
        assert got.dtype.kind == ref.dtype.kind, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    assert tw.mediums.count == jw.mediums.count == {
        "absorbing_sphere": 2, "nested_media": 3, "fog_cornell": 3}[name]
    for f in ("inner_medium", "outer_medium"):
        np.testing.assert_array_equal(getattr(tw.mats, f).numpy(),
                                      np.asarray(getattr(jw.mats, f)))
    assert tw.mats.inner_medium.max() == tw.mediums.count - 1


def test_baked_tables_match_jax(media):
    """The medium-aware bake: every table equal, the medium flag and the
    radius in the constants, the feed's tables on the port's scene."""
    _, (jw, tw, jc, tc) = media
    js, ts = both_settings(**NEE_SETTINGS, medium_aware=True)
    jscene = jm.build_mega_scene(jw, jc, js)
    tscene = tm.build_mega_scene(tw, tc, settings=ts)
    for name in ("dense_tab", "mat_tab", "light_tab", "spec_tab"):
        np.testing.assert_array_equal(getattr(tscene, name).numpy(),
                                      np.asarray(getattr(jscene, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(
        tscene.prim_tab.numpy(),
        np.asarray(jscene.prim_tab)[:tm._NP_ROWS], err_msg="prim_tab")
    assert tscene.consts["medium"] and jscene.consts["medium"]
    assert tscene.consts["radius"] == jscene.consts["radius"]
    assert tscene.med is not None and jscene.med_args is not None
    assert not tm.fused_ok(tscene)
    assert tm.build_mega_scene(tw, tc).med is None
    assert tm.gate_refusal(tw, tc, ts) is None


def test_table_functions_match_jax(media):
    """medium_coefficients, phase_eval, phase_sample and transmittance on
    random medium ids (vacuum among them) and wavelengths."""
    _, (jw, tw, _, _) = media
    x = _inputs(2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, tw.mediums.count, N).astype(np.int32)
    tj = (jw.mediums, jw.bank, jnp.asarray(ids), jnp.asarray(x["lam"]))
    tt = (tw.mediums, tw.bank, _t(ids), _t(x["lam"]))
    for got, ref in zip(ttab.medium_coefficients(*tt),
                        jtab.medium_coefficients(*tj)):
        _close(got, ref)
    _close(ttab.phase_eval(*tt, _t(x["cos"])),
           jtab.phase_eval(*tj, jnp.asarray(x["cos"])))
    _close(ttab.transmittance(*tt, _t(x["dist"])),
           jtab.transmittance(*tj, jnp.asarray(x["dist"])))
    wo, pdf = ttab.phase_sample(*tt, _t(x["d"]), _t(x["u1"]), _t(x["u2"]))
    jwo, jpdf = jtab.phase_sample(*tj, jnp.asarray(x["d"]),
                                  jnp.asarray(x["u1"]), jnp.asarray(x["u2"]))
    _close(wo, jwo, rtol=1e-5, atol=4e-6)
    _close(pdf, jpdf, rtol=1e-5)
    _close(torch.linalg.norm(wo, dim=-1), np.ones(N), rtol=0, atol=1e-5)
