"""The port's BDPT (`integrator/bdpt.py`, plain torch on the CPU) against
the JAX package's:

- `_mis_weight_batched` against the JAX function and against the port's
  sequential `_mis_weight` (the ratio walk that tests/test_bdpt_mis_batched.py
  pins the JAX batched form to) on seeded random subpath pdf tables, for
  every pair of every strategy family at max_depth 6: rtol 2e-5;
- `generate_light_subpath` and `generate_eye_subpath` with the JAX draws
  replayed at max_depth 4 on the Cornell box: every Subpath field and
  escape record, discrete fields equal, continuous fields within rtol 1e-4,
  the counters equal;
- `bdpt_trace` with the JAX draws replayed at max_depth 3 on the Cornell
  box against the JAX batched body
  (`torch_ref_helpers.bdpt_trace_matches_jax`; test_torch_bdpt_trace.py
  takes max_depth 5 and a selected pair, test_torch_render_bdpt.py the HDR
  blob and `render_bdpt`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from pathtracer_tpu.integrator import bdpt as jbd
from pathtracer_tpu.utils import profile as jprof
from pathtracer_tpu_torch.integrator import bdpt as tbd
from pathtracer_tpu_torch.integrator.lt import host_world
from pathtracer_tpu_torch.utils import profile as prof

from torch_ref_helpers import BDPTReplay, bdpt_trace_matches_jax, both_worlds

torch.set_num_threads(2)


def _random_subpaths(rng, n, d):
    """The same random Subpath for both packages (test_bdpt_mis_batched's
    recipe)."""
    def arr(shape=()):
        return rng.uniform(0.05, 4.0, (n, d) + shape).astype(np.float32)

    f = dict(pos=arr((3,)), ns=arr((3,)), gn=arr((3,)), wi=arr((3,)),
             mat_id=np.zeros((n, d), np.int32),
             prim_id=np.zeros((n, d), np.int32),
             is_light=rng.uniform(size=(n, d)) < 0.3, beta=arr(),
             pdf_fwd=arr(), pdf_rev=arr(),
             valid=rng.uniform(size=(n, d)) < 0.8)
    return (jbd.Subpath(**{k: jnp.asarray(v) for k, v in f.items()}),
            tbd.Subpath(**{k: torch.as_tensor(v) for k, v in f.items()}))


def test_mis_weight_batched_matches_jax_and_loop():
    rng = np.random.default_rng(7)
    n, D = 64, 6
    yj, yt = _random_subpaths(rng, n, D)
    zj, zt = _random_subpaths(rng, n, D)
    pairs = ([(s, t) for s in range(1, D + 1) for t in range(2, D + 1)]
             + [(0, t) for t in range(2, D + 1)]
             + [(s, 1) for s in range(1, D + 1)])
    P = len(pairs)
    # the junction pdfs, with zeros sprinkled in (the walk remaps them to 1)
    je = [np.where(rng.uniform(size=(n, P)) < 0.15, 0.0,
                   rng.uniform(0.0, 3.0, (n, P))).astype(np.float32)
          for _ in range(4)]
    s_arr = np.asarray([s for s, _ in pairs], np.int32)
    t_arr = np.asarray([t for _, t in pairs], np.int32)
    w_j = np.asarray(jbd._mis_weight_batched(
        yj, zj, jnp.asarray(s_arr), jnp.asarray(t_arr), D,
        *[jnp.asarray(a) for a in je]))
    te = [torch.as_tensor(a) for a in je]
    w_t = tbd._mis_weight_batched(yt, zt, torch.as_tensor(s_arr),
                                  torch.as_tensor(t_arr), D, *te).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=2e-5)
    for j, (s, t) in enumerate(pairs):
        w_l = tbd._mis_weight(None, None, yt, zt, s, t, D,
                              *[a[:, j] for a in te])
        np.testing.assert_allclose(w_t[:, j], w_l.numpy(), rtol=2e-5,
                                   err_msg=f"pair (s={s}, t={t})")


def _close_fields(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-6,
                               err_msg=name)


def test_subpaths_match_jax():
    jw, tw, jc, tc = both_worlds("cornell")
    n, md = 256, 4
    key = jax.random.PRNGKey(5)
    k_lam, k_light, k_eye, _ = jax.random.split(key, 4)
    lam = np.array(380.0 + jax.random.uniform(k_lam, (n,)) * 400.0)
    film_uv = np.random.default_rng(1).uniform(size=(n, 2)) \
        .astype(np.float32)
    js = jbd.BDPTSettings(max_depth=md)

    def light(world, lam, key):
        return jbd.generate_light_subpath(world, js, lam, jnp.ones((n,)),
                                          key, n, jprof.zeros())

    def eye(world, camera, film_uv, lam, key):
        return jbd.generate_eye_subpath(world, camera, js, film_uv, lam, key,
                                        jprof.zeros())

    y_j, prim_j, cy_j = jax.jit(light)(jw, jnp.asarray(lam), k_light)
    z_j, esc_j, cz_j = jax.jit(eye)(jw, jc, jnp.asarray(film_uv),
                                    jnp.asarray(lam), k_eye)
    ts = tbd.BDPTSettings(max_depth=md)
    wh, cams = host_world(tw), tbd.host_cameras(tc)
    rep = BDPTReplay(key, direct=True)
    lam_t = torch.as_tensor(lam)
    cy = torch.zeros(prof.N_COUNTERS, dtype=torch.float64)
    y, prim, cy = tbd.generate_light_subpath(wh, ts, lam_t, torch.ones(n),
                                             rep, 0, n, cy)
    cz = torch.zeros(prof.N_COUNTERS, dtype=torch.float64)
    z, esc, cz = tbd.generate_eye_subpath(wh, cams, ts,
                                          torch.as_tensor(film_uv), lam_t,
                                          rep, 0, cz)
    assert y.pos.shape == (n, md, 3) and z.valid.shape == (n, md)
    assert 0 < int(y.valid[:, 2].sum()) < n and int(z.is_light.sum()) > 0
    for side, got, ref in (("light", y, y_j), ("eye", z, z_j)):
        for f in tbd.Subpath._fields:
            _close_fields(getattr(got, f).numpy(), getattr(ref, f),
                          f"{side} {f}")
    _close_fields(prim.numpy(), prim_j, "light prim")
    assert len(esc) == len(esc_j) == md - 1
    for i, (e, e_j) in enumerate(zip(esc, esc_j)):
        for k in ("escaped", "beta", "dir", "pdf_sa"):
            _close_fields(e[k].numpy(), e_j[k], f"escape {i} {k}")
    np.testing.assert_array_equal(cy.numpy(), np.asarray(cy_j))
    np.testing.assert_array_equal(cz.numpy(), np.asarray(cz_j))


def test_bdpt_trace_matches_jax():
    own, _, splat_e = bdpt_trace_matches_jax("cornell", 3)[:3]
    assert own.sum() > 0 and splat_e.sum() > 0
