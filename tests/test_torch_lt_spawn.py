"""The light tracer's particle spawning in the port against the JAX package,
function by function on the same numpy-seeded inputs: the disk and
cosine-power samplers, the emission CDF and its inversion, surface
sampling, emission and its direction pdf, the light pick, the camera's
lens-connection protocol, `stratify_u0`, `spawn_particles`,
`_connect_to_camera_values`, the v2 spawn table and the v1 spawn feed (the
port's `lt_spawn_feed` against `_lt_spawn_feed`, on the uniforms the JAX
feed draws). Scenes: the Cornell box (diffuse light), the sharp-light box,
the HDR blob and the Sun sphere (environment spawning), a constant
environment mixed with the box's light (p_env 0.3) and the chip scene with
its lens proxy.

Tolerance: >= 99.9% of elements within rtol 1e-5 and all within rtol 1e-3
(XLA's CPU backend contracts multiply-adds into FMAs, torch does not); the
wavelengths from the CDF inversion are exact but where the target lies
within an ulp of a knot; discrete outputs equal on >= 99.9% of lanes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.core import sampling as jsampling
from pathtracer_tpu.core import spectral as jspectral
from pathtracer_tpu.geometry import sample_surface as jsample_surface
from pathtracer_tpu.integrator import lt as jlt_int
from pathtracer_tpu.kernels import lt_mega as jlt
from pathtracer_tpu.materials import tables as jtables
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.core import sampling as tsampling
from pathtracer_tpu_torch.core import spectral as tspectral
from pathtracer_tpu_torch.geometry.soa import sample_surface
from pathtracer_tpu_torch.integrator import lt as tlt_int
from pathtracer_tpu_torch.kernels import lt_mega as tlt
from pathtracer_tpu_torch.kernels.cmath import V3
from pathtracer_tpu_torch.materials import tables as ttables
from pathtracer_tpu_torch.parsing import SceneBuilder as TorchBuilder

from torch_ref_helpers import (
    RECIPES,
    JaxBuilder,
    LTReplay,
    both_lt_settings,
    both_worlds,
)

torch.set_num_threads(2)
N = 4096


def _u(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def close(ref, got, name, rtol=1e-5, frac=0.999):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert ref.shape == got.shape, name
    ok = np.isclose(got, ref, rtol=rtol, atol=1e-6, equal_nan=True)
    assert ok.mean() >= frac, f"{name}: {ok.mean()} within rtol {rtol}"
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=name)


def same(ref, got, name, frac=0.999):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, name
    assert (ref == got).mean() >= frac, f"{name}: {(ref == got).mean()}"


def _v3(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


def mix_box(b, spectral):
    """The Cornell box lit by its light and a constant environment, with the
    environment picked for 30% of the particles."""
    scenes.cornell_box(b, spectral)
    one = b.add_curve(spectral.FlatCurve(0.5), name="env_half")
    b.set_environment_constant(one, 1.0)
    b.env_sampling_probability = 0.3
    return b


def worlds(recipe):
    if recipe == "mix":
        return (mix_box(JaxBuilder(), jspectral).build(),
                mix_box(TorchBuilder(), tspectral).build(device="cpu"))
    jw, tw, _, _ = both_worlds(recipe)
    return jw, tw


SPAWN_RECIPES = ["cornell", "sharp", "hdri", "sun", "mix", "chip_lens"]


def test_samplers_match_jax():
    u = _u(1, (3, N))
    n = np.where(u[2] < 0.5, 1.0, 6.0).astype(np.float32)
    close(jsampling.random_in_unit_disk(u[0], u[1]),
          tsampling.random_in_unit_disk(_t(u[0]), _t(u[1])), "disk")
    close(jsampling.power_cosine_direction(u[0], u[1], n),
          tsampling.power_cosine_direction(_t(u[0]), _t(u[1]), _t(n)),
          "power cosine")


@pytest.mark.parametrize("recipe", ["cornell", "sharp", "spike_box"])
def test_emission_spectrum_matches_jax(recipe):
    """cdf_at on a λ grid and the CDF inversion of every curve."""
    jw, tw = worlds(recipe)
    jb, tb = jw.bank, tw.bank
    n_curves = tb.values.shape[0]
    lam = np.linspace(360.0, 840.0, 999, dtype=np.float32)
    idx = np.repeat(np.arange(n_curves, dtype=np.int32), lam.size)
    lam_all = np.tile(lam, n_curves)
    close(jspectral.cdf_at(jb, idx, lam_all),
          tspectral.cdf_at(tb, _t(idx), _t(lam_all)), "cdf_at")
    u = _u(2, idx.size)
    wb = tlt_int.LTSettings().wavelength_bounds
    ref = jspectral.sample_power_and_pdf(jb, idx, u, wb)
    got = tspectral.sample_power_and_pdf(tb, _t(idx), _t(u), wb)
    same(ref[0], got[0], "lam")
    for name, r, g in zip(("lam", "power", "pdf"), ref, got):
        close(r, g, name)


@pytest.mark.parametrize("recipe", ["cornell", "sharp", "chip_lens"])
def test_sample_surface_matches_jax(recipe):
    jw, tw = worlds(recipe)
    valid = np.flatnonzero(np.asarray(jw.prims.valid))
    pid = valid[np.arange(N) % valid.size].astype(np.int32)
    u = _u(3, (2, N))
    rp, rn, ra = jsample_surface(jw.prims, pid, u[0], u[1])
    gp, gn, ga = sample_surface(tw.prims, _t(pid), _t(u[0]), _t(u[1]))
    close(rp, _v3(gp), "point")
    close(rn, _v3(gn), "normal")
    close(ra, ga, "area pdf")


@pytest.mark.parametrize("recipe", ["cornell", "sharp", "chip_lens"])
def test_emission_matches_jax(recipe):
    """emission, emission_direction_pdf and sample_emission_spectrum of
    every material, and the light pick."""
    jw, tw = worlds(recipe)
    m = int(tw.mats.count)
    mid = (np.arange(N) % m).astype(np.int32)
    u = _u(4, (3, N))
    cos = (u[0] * 2.0 - 1.0).astype(np.float32)
    lam = (380.0 + 400.0 * u[1]).astype(np.float32)
    close(jtables.emission(jw.mats, jw.bank, mid, lam, jnp.zeros((N, 2)), cos),
          ttables.emission(tw.mats, tw.bank, _t(mid), _t(lam), None, _t(cos)),
          "emission")
    close(jtables.emission_direction_pdf(jw.mats, mid, cos),
          ttables.emission_direction_pdf(tw.mats, _t(mid), _t(cos)),
          "emission pdf")
    wb = tlt_int.LTSettings().wavelength_bounds
    for name, r, g in zip(("lam", "power", "pdf"),
                          jtables.sample_emission_spectrum(
                              jw.mats, jw.bank, mid, u[2], wb),
                          ttables.sample_emission_spectrum(
                              tw.mats, tw.bank, _t(mid), _t(u[2]), wb)):
        close(r, g, name)
    rl, rp = jw.pick_random_light(u[2])
    gl, gp = tw.pick_random_light(_t(u[2]))
    same(rl, gl, "light", frac=1.0)
    assert float(rp) == gp


def test_lens_protocol_matches_jax():
    """The camera's get_pixel_for_ray, sample_lens_point, lens_area,
    we_focal and we_film_area."""
    _, _, jc, tc = both_worlds("chip_lens")
    u = _u(5, (4, N))
    rl = jc.sample_lens_point(u[0], u[1])
    gl = tc.sample_lens_point(_t(u[0]), _t(u[1]))
    close(rl, _v3(gl), "lens point")
    d = np.stack([np.ones(N), u[2] - 0.5, u[3] - 0.5], -1).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jc.get_pixel_for_ray(np.asarray(rl), d)
    got = tc.get_pixel_for_ray(gl, V3(*[_t(d[:, k]) for k in range(3)]))
    close(ref[0], got[0], "film u")
    close(ref[1], got[1], "film v")
    same(ref[2], got[2], "on film")
    assert np.float32(jc.lens_area()) == np.float32(tc.lens_area())
    assert np.float32(jc.we_focal()) == np.float32(tc.we_focal())
    assert np.float32(jc.we_film_area()) == np.float32(tc.we_film_area())


def test_stratification_matches_jax():
    js, ts = both_lt_settings(stratified=True)
    key = jax.random.PRNGKey(4)
    cells = ts.strata_uv ** 2 * ts.strata_lam
    perm = _t(jax.random.permutation(jsampling.fold(key, 7), cells)).long()
    u0 = jax.random.uniform(key, (N, 9))
    np.testing.assert_array_equal(
        np.asarray(jlt_int.stratify_u0(js, u0, key)),
        tlt_int.stratify_u0(ts, _t(u0), perm).numpy())
    usp = jax.random.uniform(key, (jlt.NUSP, N))
    np.testing.assert_array_equal(
        np.asarray(jlt._stratify_usp(js, usp, key)),
        tlt.stratify_usp(ts, _t(usp), perm).numpy())


@pytest.mark.parametrize("recipe", SPAWN_RECIPES)
def test_spawn_particles_matches_jax(recipe):
    jw, tw = worlds(recipe)
    js, ts = both_lt_settings()
    u0 = _u(6, (N, 9))
    ref = jlt_int.spawn_particles(jw, js, u0)
    got = tlt_int.spawn_particles(tw, ts, _t(u0))
    for k in ("pick_env", "alive"):
        same(ref[k], got[k], k)
    for k in ("o", "d", "lp_i", "ln"):
        close(ref[k], _v3(got[k]), k)
    same(ref["lam_i"], got["lam_i"], "lam_i")
    for k in ("lam", "beta", "prev_pdf0", "lam_i", "area_pdf", "lam_pdf"):
        close(ref[k], got[k], k)
    assert np.float32(ref["pick_pdf"]) == np.float32(got["pick_pdf"])


@pytest.mark.parametrize("recipe", ["chip_lens", "sharp", "cornell"])
def test_connect_to_camera_matches_jax(recipe):
    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_lt_settings()
    u0, uc = _u(7, (N, 9)), _u(8, (N, 2))
    ref = jlt_int._connect_to_camera_values(
        jw, jc, jlt_int.spawn_particles(jw, js, u0), uc)
    got = tlt_int._connect_to_camera_values(
        tw, tc, tlt_int.spawn_particles(tw, ts, _t(u0)), _t(uc))
    same(ref["valid"], got["valid"], "valid")
    for k in ("so", "dir"):
        close(ref[k], _v3(got[k]), k)
    for k in ("tmax", "film_u", "film_v", "energy"):
        close(ref[k], got[k], k)


@pytest.mark.parametrize("recipe",
                         ["cornell", "sharp", "chip_lens", "spike_box"])
def test_spawn_table_matches_jax(recipe):
    jw, tw = worlds(recipe)
    wb = tlt_int.LTSettings().wavelength_bounds
    np.testing.assert_array_equal(tlt.bake_lt_spawn_tab(tw, wb),
                                  jlt.bake_lt_spawn_tab(jw, wb))


@pytest.mark.parametrize("recipe", ["hdri", "sun", "mix", "chip_lens"])
def test_spawn_feed_matches_jax(recipe):
    """The v1 spawn rows of two rounds, stratified, on the uniforms the JAX
    feed draws."""
    jw, tw = worlds(recipe)
    cam = RECIPES["chip_lens" if recipe == "mix" else recipe][1]
    from pathtracer_tpu.camera import make_projective_camera as jcam
    from pathtracer_tpu_torch.camera import make_projective_camera as tcam

    jc, tc = jcam(**cam), tcam(**cam, device="cpu")
    js, ts = both_lt_settings(stratified=True)
    key = jax.random.PRNGKey(9)
    replay = LTReplay(key)
    scene = tlt.build_lt_scene(tw, tc, ts, 32, 32, "cpu", False)
    for it in range(2):
        ref = np.asarray(jlt._lt_spawn_feed(jw, js, key, jnp.int32(it), N, jc,
                                            32, 32))
        got = tlt.spawn_feed_for(scene, ts, replay, it, N).numpy()
        disc = [tlt.F_ALIVE, tlt.F_ENV, tlt.F_LV + 7, tlt.F_LV_VALID]
        for row in range(tlt.NF):
            if row in disc:
                same(ref[row], got[row], f"feed row {row}")
            elif row in (tlt.F_BETA, tlt.F_PREV):
                # an environment particle's direction pdf takes acos of
                # the sampled direction's z: near the poles a 1-ulp cos
                # difference between XLA's and torch's libm becomes ~2e-5
                # relative (0.1-0.2% of the mix box's lanes)
                close(ref[row], got[row], f"feed row {row}", frac=0.995)
            else:
                close(ref[row], got[row], f"feed row {row}")


def test_gate_matches_jax():
    """The LT gate takes every recipe but the uv-textured ones, as the JAX
    gate does; the v2 route takes the constant environments."""
    for recipe in sorted(RECIPES):
        jw, tw, jc, tc = both_worlds(recipe)
        js, ts = both_lt_settings()
        assert jlt.lt_mega_available(jw, jc, js) == \
            (tlt.lt_gate_refusal(tw, tc, ts) is None), recipe
        assert jlt.lt_mega_spawn_inkernel(jw) == \
            tlt.lt_mega_spawn_inkernel(tw), recipe
    assert tlt.lt_gate_refusal(*both_worlds("textured")[1::2],
                               both_lt_settings()[1]) is not None
