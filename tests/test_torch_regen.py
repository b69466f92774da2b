"""The regen integrator without kernels, module by module, on the CPU: the
port's `core/vecmath` and `core/sampling` warps, `World.intersect` /
`intersect_any` (the plain twins of the dense sweep kernels plus the
attribute fill) and the BSDF dispatch, each against the JAX package on
the same seeded inputs (test_torch_regen_rounds.py holds `pt_trace_regen`
round by round, test_torch_render_regen.py whole renders).

Tolerances, fixed before the runs:
- vecmath and sampling: rtol 1e-6, atol 1e-6 (a few ulps).
- HitRecord: hit and prim id exactly; t, point and normals rtol 1e-5, atol
  1e-5; uv atol 1e-5; material id, mat kind and instance id exactly.
- bsdf_eval / bsdf_sample: rtol 1e-4, atol 1e-6 where the GGX roughness is
  above 1e-3. A near-delta lobe (alpha <= 1e-3) turns the ulps of the half
  vector into relative changes of D of 1e-3 and more (XLA contracts and
  orders the f32 operations differently, ROADMAP §3): there f and pdf are
  held to rtol 2e-2 and the sampled direction and weight to the general
  bound.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core import sampling as jsampling
from pathtracer_tpu.core import vecmath as jvec
from pathtracer_tpu.geometry import intersect_any_dense as j_any
from pathtracer_tpu.geometry import intersect_dense as j_closest
from pathtracer_tpu.kernels.dense import (
    pallas_intersect_any_dense,
    pallas_intersect_dense,
)
from pathtracer_tpu.materials import tables as jmt
from pathtracer_tpu.prelude import TransportMode as JMode
from pathtracer_tpu_torch.core import sampling as tsampling
from pathtracer_tpu_torch.core import vecmath as tvec
from pathtracer_tpu_torch.kernels import dense as tdense
from pathtracer_tpu_torch.materials import tables as tmt
from pathtracer_tpu_torch.prelude import TransportMode as TMode

from torch_ref_helpers import both_worlds

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- vecmath


def _vec_cases():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(257, 3)).astype(np.float32)
    b = rng.normal(size=(257, 3)).astype(np.float32)
    n = _unit(rng, 257)
    w = _unit(rng, 257)
    eta = rng.uniform(0.5, 2.0, 257).astype(np.float32)
    u = rng.uniform(size=257).astype(np.float32)
    v = rng.uniform(size=257).astype(np.float32)
    p = np.float32(0.3)
    return {
        "dot": ("dot", (a, b)), "cross": ("cross", (a, b)),
        "length": ("length", (a,)), "length_squared": ("length_squared", (a,)),
        "normalize": ("normalize", (a,)), "reflect": ("reflect", (w, n)),
        "refract": ("refract", (w, n, eta)),
        "orthonormal_basis": ("orthonormal_basis", (n,)),
        "direction_to_uv": ("direction_to_uv", (n,)),
        "uv_to_direction": ("uv_to_direction", (u, v)),
        "choose": ("choose", (u, p)),
        "random_cosine_direction": ("random_cosine_direction", (u, v)),
        "random_on_unit_sphere": ("random_on_unit_sphere", (u, v)),
    }


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)]


@pytest.mark.parametrize("name", sorted(_vec_cases()))
def test_vecmath_and_sampling_match_jax(name):
    fn, args = _vec_cases()[name]
    in_sampling = hasattr(tsampling, fn) and fn in (
        "choose", "random_cosine_direction", "random_on_unit_sphere")
    jmod, tmod = (jsampling, tsampling) if in_sampling else (jvec, tvec)
    ref = getattr(jmod, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(tmod, fn)(*[torch.as_tensor(a) if isinstance(a, np.ndarray)
                              else a for a in args])
    for g, r in zip(_flat(got), _flat(ref), strict=True):
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, **TOL)


def test_tangent_frame_round_trip():
    rng = np.random.default_rng(2)
    n, v = _unit(rng, 500), rng.normal(size=(500, 3)).astype(np.float32)
    jf = jvec.TangentFrame.from_normal(jnp.asarray(n))
    tf = tvec.TangentFrame.from_normal(torch.as_tensor(n))
    loc = tf.to_local(torch.as_tensor(v))
    np.testing.assert_allclose(loc.numpy(), np.asarray(
        jf.to_local(jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(tf.to_world(loc).numpy(), v, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tf.to_world(torch.as_tensor(v)).numpy(),
        np.asarray(jf.to_world(jnp.asarray(v))), **TOL)


# ------------------------------------------------------------- intersect

INTERSECT_RECIPES = ["cornell", "gem", "textured", "light_grid",
                     "fog_cornell"]
N_RAYS = 2048


@functools.lru_cache(maxsize=None)
def _scene_rays(recipe):
    jw, tw, _, _ = both_worlds(recipe)
    rng = np.random.default_rng(5)
    c = np.asarray(jw.center, np.float32)
    r = np.float32(jw.radius)
    o = (c + rng.uniform(-0.5, 0.5, (N_RAYS, 3)) * r).astype(np.float32)
    d = _unit(rng, N_RAYS)
    tmin = np.full(N_RAYS, 1e-6, np.float32)
    tmax = np.where(rng.uniform(size=N_RAYS) < 0.5, 1e9,
                    rng.uniform(0.05, 1.5, N_RAYS)).astype(np.float32)
    return jw, tw, o, d, tmin, tmax


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("recipe", INTERSECT_RECIPES)
def test_intersect_matches_jax(recipe, ref):
    jw, tw, o, d, tmin, tmax = _scene_rays(recipe)
    jargs = (jw.prims, *[jnp.asarray(x) for x in (o, d, tmin, tmax)])
    jhr = (pallas_intersect_dense(*jargs, interpret=True) if ref == "pallas"
           else j_closest(*jargs))
    launches = tdense.CLOSEST_LAUNCHES
    thr = tw.intersect(*[torch.as_tensor(x) for x in (o, d, tmin, tmax)])
    assert tdense.CLOSEST_LAUNCHES == launches  # the CPU takes the twin
    hit = np.asarray(jhr.hit)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    assert 0.2 < hit.mean() < 1.0
    for f in ("prim_id", "material_id", "mat_kind", "instance_id"):
        np.testing.assert_array_equal(getattr(thr, f).numpy(),
                                      np.asarray(getattr(jhr, f)), err_msg=f)
    for f in ("t", "point", "normal", "geo_normal"):
        np.testing.assert_allclose(getattr(thr, f).numpy()[hit],
                                   np.asarray(getattr(jhr, f))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(thr.uv.numpy()[hit], np.asarray(jhr.uv)[hit],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(thr.t.numpy()[~hit], 1e9)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("recipe", INTERSECT_RECIPES)
def test_intersect_any_matches_jax(recipe, ref):
    jw, tw, o, d, tmin, tmax = _scene_rays(recipe)
    jargs = (jw.prims, *[jnp.asarray(x) for x in (o, d, tmin, tmax)])
    want = np.asarray(pallas_intersect_any_dense(*jargs, interpret=True)
                      if ref == "pallas" else j_any(*jargs))
    got = tw.intersect_any(*[torch.as_tensor(x) for x in (o, d, tmin, tmax)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 1.0


@pytest.mark.parametrize("recipe", INTERSECT_RECIPES)
def test_intersect_any_live_lanes_match_jax(recipe):
    """`intersect_any(..., live=)` sweeps only the live lanes: there it
    equals the unmasked query and the JAX `intersect_any_dense`, elsewhere
    it reads False, whatever the dead lanes hold (NaN origins, zero
    directions, t_min = t_max = 0, the JAX package's padding)."""
    jw, tw, o, d, tmin, tmax = _scene_rays(recipe)
    live = np.random.default_rng(6).uniform(size=N_RAYS) < 0.6
    dead = np.flatnonzero(~live)
    o2, d2, tmin2, tmax2 = o.copy(), d.copy(), tmin.copy(), tmax.copy()
    o2[dead[0::3]] = np.nan
    d2[dead[1::3]] = 0.0
    tmin2[dead[2::3]] = tmax2[dead[2::3]] = 0.0
    want = np.asarray(j_any(jw.prims, *[jnp.asarray(x)
                                        for x in (o, d, tmin, tmax)]))
    full = tw.intersect_any(*[torch.as_tensor(x) for x in (o, d, tmin,
                                                           tmax)])
    got = tw.intersect_any(*[torch.as_tensor(x) for x in (o2, d2, tmin2,
                                                          tmax2)],
                           live=torch.as_tensor(live))
    assert got.dtype == torch.bool and got.shape == (N_RAYS,)
    np.testing.assert_array_equal(got.numpy()[live], full.numpy()[live])
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    assert not got.numpy()[~live].any()
    assert 0.1 < want[live].mean() < 1.0


def test_intersect_refuses_transforms_and_ignore_prim():
    from pathtracer_tpu_torch.geometry.soa import intersect_dense

    _, tw, o, d, tmin, tmax = _scene_rays("cornell")
    args = [torch.as_tensor(x) for x in (o, d, tmin, tmax)]
    with pytest.raises(NotImplementedError, match="ignore_prim"):
        intersect_dense(tw.prims, *args, ignore_prim=args[2].int())
    tw2 = dataclasses.replace(tw, prims=dataclasses.replace(
        tw.prims, xf_inv=tw.prims.xf_inv.repeat(2, 1, 1),
        xf_fwd=tw.prims.xf_fwd.repeat(2, 1, 1)))
    with pytest.raises(NotImplementedError, match="items 9 and 13"):
        tw2.intersect(*args)
    with pytest.raises(NotImplementedError, match="items 9 and 13"):
        tw2.intersect_any(*args)


# ------------------------------------------------------------------ BSDF

BSDF_RECIPES = ["cornell", "gem", "textured", "fog_cornell", "chip",
                "furnace"]


def _bsdf_inputs(recipe, c_lanes, n=1536):
    jw, tw, _, _ = both_worlds(recipe)
    rng = np.random.default_rng(11 + c_lanes)
    m = int(jw.mats.count)
    mat_id = np.repeat(rng.integers(0, m, n).astype(np.int32), c_lanes)
    k = n * c_lanes
    lam = rng.uniform(380.0, 780.0, k).astype(np.float32)
    uv = np.repeat(rng.uniform(size=(n, 2)).astype(np.float32), c_lanes, 0)
    wi = np.repeat(_unit(rng, n), c_lanes, 0)
    wo = np.repeat(_unit(rng, n), c_lanes, 0)
    u = rng.uniform(size=(k, 3)).astype(np.float32)
    alpha = np.asarray(jw.mats.alpha)[mat_id]
    delta = (np.asarray(jw.mats.mtype)[mat_id] == jmt.MAT_GGX) & (
        alpha <= 1e-3)
    return jw, tw, mat_id, lam, uv, wi, wo, u, delta


def _close(got, want, delta, err_msg, loose_delta=True):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[~delta], want[~delta], rtol=1e-4,
                               atol=1e-6, err_msg=err_msg)
    np.testing.assert_allclose(got[delta], want[delta],
                               rtol=2e-2 if loose_delta else 1e-4,
                               atol=1e-6, err_msg=err_msg + " (alpha<=1e-3)")


@pytest.mark.parametrize("c_lanes", [1, 4])
@pytest.mark.parametrize("recipe", BSDF_RECIPES)
def test_bsdf_eval_and_sample_match_jax(recipe, c_lanes):
    jw, tw, mat_id, lam, uv, wi, wo, u, delta = _bsdf_inputs(recipe, c_lanes)
    jargs = [jnp.asarray(x) for x in (mat_id, lam, uv, wi, wo)]
    targs = [torch.as_tensor(x) for x in (mat_id, lam, uv, wi, wo)]
    jf, jp = jmt.bsdf_eval(jw.mats, jw.bank, jw.tex, *jargs, JMode.Radiance)
    tf, tp = tmt.bsdf_eval(tw.mats, tw.bank, tw.tex, *targs, TMode.Radiance)
    _close(tf, jf, delta, "eval f")
    _close(tp, jp, delta, "eval pdf")
    ju = [jnp.asarray(u[:, i]) for i in range(3)]
    tu = [torch.as_tensor(u[:, i]) for i in range(3)]
    jr = jmt.bsdf_sample(jw.mats, jw.bank, jw.tex, *jargs[:4], *ju,
                         JMode.Radiance)
    tr = tmt.bsdf_sample(tw.mats, tw.bank, tw.tex, *targs[:4], *tu,
                         TMode.Radiance)
    _close(tr[0], jr[0], delta, "sample wo", loose_delta=False)
    _close(tr[1], jr[1], delta, "sample f")
    _close(tr[2], jr[2], delta, "sample pdf")
    _close(tr[3], jr[3], delta, "sample weight", loose_delta=False)
    assert (np.asarray(jr[3]) > 0).mean() > 0.3
