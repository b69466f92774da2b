"""Sun and HDR environments in the port against the JAX package: the
Radiance HDR reader, the importance-map bake, `eval_texture`, the
environment's emission, pdf and sampling, the per-lane environment feed of
the two-program round, and three chained two-program rounds (K12 + K34,
JAX in interpret mode at a 1024-lane tile) on the HDR blob scene at C = 4
and the Sun scene at C = 1; last, the HDR furnace rendered through the
two-program round.

Tolerances, and why:
- the HDR reader and the importance bake are the same numpy arithmetic:
  equal;
- eval_texture gathers the same texels and lerps the same curve knots:
  rtol 1e-6;
- env_emission, env_pdf_for, env_sample_uv and the env-feed rows: >= 99.9%
  of values within rtol 1e-5 (atol 1e-6 on unit-vector components) and all
  within rtol 1e-3. XLA's CPU backend contracts multiply-adds into FMAs and
  torch does not; arccos near the poles and the sin Jacobian amplify such an
  ulp in a few lanes. `searchsorted(..., right=True)` ties as the JAX
  sum-of-less-than-or-equal does: a CDF entry equal to u counts as below u;
- the chained rounds: check_k2 and check_round (test_torch_two_prog.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu.parsing.images import load_hdr_rgba as jax_load_hdr
from pathtracer_tpu.textures import eval_texture as jax_eval_texture
from pathtracer_tpu.world import environment as jenv
from pathtracer_tpu.world.importance_map import (
    bake_importance_tables as jax_bake,
)
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.core import spectral as torch_spectral
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.kernels.cmath import V3
from pathtracer_tpu_torch.parsing.images import load_hdr_rgba
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.textures.texture import eval_texture
from pathtracer_tpu_torch.world import environment as tenv
from pathtracer_tpu_torch.world.importance_map import bake_importance_tables

from torch_ref_helpers import (
    NEE_SETTINGS,
    both_settings,
    both_worlds,
    chained_two_prog,
    check_k2,
    check_round,
)

torch.set_num_threads(2)

N = 4096


def assert_close(got, want, atol=0.0, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    ok = np.isclose(got, want, rtol=1e-5, atol=atol)
    assert ok.mean() >= 0.999, f"{name}: {ok.mean()} within rtol 1e-5"
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol,
                               err_msg=name)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lam = rng.uniform(380.0, 780.0, N).astype(np.float32)
    u1, u2 = rng.random((2, N)).astype(np.float32)
    return d, lam, u1, u2


def _v3(d):
    return V3(*[torch.as_tensor(d[:, i]) for i in range(3)])


def _write_flat_hdr(path, h=5, w=7, seed=1):
    """A flat-scanline RGBE file (the blob map is run-length encoded)."""
    rgbe = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    rgbe[..., 3] = np.clip(rgbe[..., 3], 120, 140)
    header = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
              + f"-Y {h} +X {w}\n".encode())
    with open(path, "wb") as f:
        f.write(header + rgbe.tobytes())


def test_hdr_reader_matches_jax(tmp_path):
    got = load_hdr_rgba(scenes.HDR_BLOB)
    assert got.shape == (32, 64, 4) and got[..., :3].max() > 0
    np.testing.assert_array_equal(got, jax_load_hdr(scenes.HDR_BLOB))
    flat = str(tmp_path / "flat.hdr")
    _write_flat_hdr(flat)
    np.testing.assert_array_equal(load_hdr_rgba(flat, 0.5),
                                  jax_load_hdr(flat, 0.5))


@pytest.mark.parametrize("size", [(64, 32), (32, 16), (24, 40)])
def test_importance_bake_matches_jax(size):
    img = load_hdr_rgba(scenes.HDR_BLOB)
    curves = [torch_spectral.SpikeCurve(610.0, 40.0, 60.0, 1.0),
              torch_spectral.FlatCurve(0.5), torch_spectral.FlatCurve(0.0)]
    layers = [(img[..., k], k) for k in range(3)]
    got = bake_importance_tables(layers, curves, *size)
    want = jax_bake(layers, curves, *size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("recipe", ["hdri", "cornell"])
def test_eval_texture_matches_jax(recipe):
    """Multi-layer multi-texel textures (the HDR blob's) and the all-1x1,
    single-layer case (the Cornell walls)."""
    jw, tw, _, _ = both_worlds(recipe)
    rng = np.random.default_rng(3)
    tid = rng.integers(0, int(tw.tex.count), N).astype(np.int32)
    lam = rng.uniform(370.0, 790.0, N).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (N, 2)).astype(np.float32)
    got = eval_texture(tw.tex, tw.bank, torch.as_tensor(tid),
                       torch.as_tensor(lam), torch.as_tensor(uv[:, 0]),
                       torch.as_tensor(uv[:, 1]))
    want = jax_eval_texture(jw.tex, jw.bank, jnp.asarray(tid),
                            jnp.asarray(lam), jnp.asarray(uv))
    assert float(np.asarray(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("recipe", ["hdri", "hdr_furnace", "sun"])
def test_environment_matches_jax(recipe):
    jw, tw, _, _ = both_worlds(recipe)
    d, lam, u1, u2 = _inputs()
    want_e = jenv.env_emission(jw.env, jw.bank, jw.tex, jnp.asarray(d),
                               jnp.asarray(lam))
    got_e = tenv.env_emission(tw.env, tw.bank, tw.tex, _v3(d),
                              torch.as_tensor(lam))
    assert_close(got_e.numpy(), want_e, name="env_emission")
    assert_close(tenv.env_pdf_for(tw.env, _v3(d)).numpy(),
                 jenv.env_pdf_for(jw.env, jnp.asarray(d)), name="pdf_for")
    want_d, want_p = jenv.env_sample_uv(jw.env, jnp.asarray(u1),
                                        jnp.asarray(u2))
    got_d, got_p = tenv.env_sample_uv(tw.env, torch.as_tensor(u1),
                                      torch.as_tensor(u2))
    assert_close(np.stack([x.numpy() for x in got_d], -1), want_d,
                 atol=1e-6, name="sample_uv direction")
    assert_close(got_p.numpy(), want_p, name="sample_uv pdf")
    assert float(np.asarray(want_p).min()) >= 0.0


@pytest.mark.parametrize("recipe,lut", [("hdri", True), ("hdri", False),
                                        ("sun", False)],
                         ids=["hdri-lut", "hdri-texture", "sun"])
def test_env_feed_matches_jax(recipe, lut):
    """`env_feed`'s rows against `_env_feed` at C = 4, light samples 2, on
    seeded ray directions, wavelengths and uniforms: HDR through the baked
    (texel, λ-knot) table and through eval_texture, and Sun."""
    jw, tw, jc, tc = both_worlds(recipe)
    d, lam, _, _ = _inputs(1)
    n_pad = N
    state = np.zeros((tm.NS, n_pad), np.float32)
    state[tm.S_D:tm.S_D + 3] = d.T
    state[tm.S_LAM:tm.S_LAM + 4] = np.stack(
        [np.roll(lam, k) for k in range(4)])
    u = np.random.default_rng(2).random((tm.n_u_rows(2), n_pad)).astype(
        np.float32)
    js, _ = both_settings(**NEE_SETTINGS)
    env_args = jm.build_mega_scene(jw, jc, js).env_args
    feed = tm.build_mega_scene(tw, tc).env
    if not lut:
        env_args = env_args[:3] + (None,)
        feed = tm.EnvFeed(env=feed.env, bank=feed.bank, tex=feed.tex)
    assert (env_args[3] is not None) == lut == (feed.lut is not None)
    want = jm._env_feed(env_args, jnp.asarray(state), jnp.asarray(u), 2, 4)
    got = tm.env_feed(feed, torch.as_tensor(state), torch.as_tensor(u), 2, 4)
    assert got.shape == tuple(want.shape) == (tm.ef_rows(2, 4), n_pad)
    dir_rows = [5 + k * 8 + i for k in range(2) for i in range(3)]
    for row in range(want.shape[0]):
        assert_close(got[row].numpy(), np.asarray(want[row]),
                     atol=1e-6 if row in dir_rows else 0.0,
                     name=f"ef row {row}")


@pytest.fixture(scope="module", params=[("hdri", 4), ("sun", 1)],
                ids=["hdri-C4", "sun-C1"])
def rounds(request):
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        yield chained_two_prog(*request.param)
    finally:
        jm.TILE, jm.SUB = tile, sub


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_env_rounds_match_jax(rounds, r):
    x = rounds[r]
    check_k2(x["jk2"], x["k2"], x["alive"], NEE_SETTINGS["light_samples"])
    check_round(x["state"], x["out"], x["counts"])
    assert x["out"][tm.O4_ENV_CT].sum() > 0


def test_world_takes_every_environment():
    """world_from_numpy keeps Sun and HDR environments, and the fused
    round's gate leaves them to the two-program round."""
    for recipe, kind in (("hdri", tenv.ENV_HDR), ("sun", tenv.ENV_SUN)):
        _, tw, _, tc = both_worlds(recipe)
        assert int(tw.env.kind) == kind
        scene = tm.build_mega_scene(tw, tc)
        assert not tm.fused_ok(scene) and scene.env is not None
    assert bool(both_worlds("hdri")[1].env.imp_baked)
    assert jax.numpy.asarray(both_worlds("sun")[0].env.kind) == jenv.ENV_SUN


def test_hdr_furnace_two_prog():
    """A constant-valued HDR map (importance-sampled) around a unit-albedo
    sphere through the two-program round, with env feed and MIS: sphere
    pixels must equal direct-environment pixels within 0.05 (C = 4 keeps the
    spectral noise of the map's basis curves below that)."""
    _, tw, _, tc = both_worlds("hdr_furnace")
    _, ts = both_settings(max_bounces=10, min_bounces=3, light_samples=2,
                          russian_roulette=True, hwss=True)
    film, _, _ = render_regen(tw, tc, ts, 32, 32, 48,
                              generator=torch.Generator().manual_seed(1))
    y = film[..., 1].numpy()
    assert np.isfinite(y).all()
    center = y[12:20, 12:20].mean()
    corner = np.concatenate([y[:3, :3].ravel(), y[-3:, -3:].ravel()]).mean()
    assert abs(center / corner - 1.0) < 0.05, (center, corner)
