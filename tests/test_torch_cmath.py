"""The port's plain device math (pathtracer_tpu_torch.kernels.cmath, the twin
of csrc/cmath.cuh) against the JAX package's kernels/cmath.py on the same
seeded inputs, plus the CIE fits, spectral LUT evaluation and the camera.

Tolerance: rtol 1e-5 (f32 op-order noise; XLA's CPU backend contracts some
multiply-adds into FMAs, torch does not). Near-delta GGX lobes amplify
one-ulp direction differences into large relative f/pdf differences, so
there the sampled f and pdf must match on >= 99.5% of lanes, as the JAX
package's own cmath test demands (tests/test_kernels_cmath.py:151-161)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.camera import make_projective_camera as jax_camera
from pathtracer_tpu.core import cie as jax_cie
from pathtracer_tpu.core import spectral as jax_spectral
from pathtracer_tpu.kernels import cmath as jc
from pathtracer_tpu.prelude import TransportMode as JMode
from pathtracer_tpu_torch.camera import make_projective_camera as torch_camera
from pathtracer_tpu_torch.core import cie as torch_cie
from pathtracer_tpu_torch.core import spectral as torch_spectral
from pathtracer_tpu_torch.kernels import cmath as tc
from pathtracer_tpu_torch.prelude import TransportMode as TMode

torch.set_num_threads(2)

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    d = dict(a=_unit(rng), b=_unit(rng), c=_unit(rng),
             u1=rng.random(N).astype(np.float32),
             u2=rng.random(N).astype(np.float32),
             u3=rng.random(N).astype(np.float32),
             eta=rng.uniform(0.4, 1.6, N).astype(np.float32),
             refl=rng.uniform(0, 1.2, N).astype(np.float32),
             alpha=rng.uniform(0.01, 1.0, N).astype(np.float32),
             eta_i=rng.uniform(1.1, 2.4, N).astype(np.float32),
             eta_o=np.ones(N, np.float32),
             kappa=np.where(rng.random(N) < 0.5, 0.0,
                            rng.uniform(0.5, 4.0, N)).astype(np.float32),
             perm=rng.uniform(0.0, 1.0, N).astype(np.float32),
             cos=rng.uniform(-1.0, 1.0, N).astype(np.float32))
    return d


class _Side:
    """Hands one side's module and array constructors to a case."""

    def __init__(self, mod, arr, mode):
        self.m, self.arr, self.mode = mod, arr, mode

    def v3(self, a):
        return self.m.V3(self.arr(a[:, 0]), self.arr(a[:, 1]),
                         self.arr(a[:, 2]))


JAX = _Side(jc, jnp.asarray, JMode)
TORCH = _Side(tc, torch.as_tensor, TMode)


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _flat(x):
    """Every array of a (nested) tuple/list result, bools as f32."""
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [_np(x).astype(np.float32)]


def _ggx_args(s, d, near_delta=False):
    alpha = (np.full(N, 4e-4, np.float32) if near_delta else d["alpha"])
    metallic = s.arr(d["kappa"] > 0.0)
    return (s.arr(alpha), s.arr(d["eta_i"]), s.arr(d["eta_o"]),
            s.arr(d["kappa"]), metallic, s.arr(d["perm"]))


CASES = {
    "dot": lambda s, d: s.m.dot(s.v3(d["a"]), s.v3(d["b"])),
    "cross": lambda s, d: s.m.cross(s.v3(d["a"]), s.v3(d["b"])),
    "normalize": lambda s, d: s.m.normalize(s.v3(d["a"] * 3.0)),
    "reflect": lambda s, d: s.m.reflect(s.v3(d["a"]), s.v3(d["b"])),
    "refract": lambda s, d: s.m.refract(s.v3(d["a"]), s.v3(d["b"]),
                                        s.arr(d["eta"])),
    "orthonormal_basis": lambda s, d: s.m.orthonormal_basis(s.v3(d["a"])),
    "to_local_world": lambda s, d: s.m.to_world(
        *s.m.orthonormal_basis(s.v3(d["a"])), s.v3(d["a"]),
        s.m.to_local(*s.m.orthonormal_basis(s.v3(d["a"])), s.v3(d["a"]),
                     s.v3(d["b"]))),
    "uv_to_direction": lambda s, d: s.m.uv_to_direction(s.arr(d["u1"]),
                                                        s.arr(d["u2"])),
    "direction_to_uv": lambda s, d: s.m.direction_to_uv(s.v3(d["a"])),
    "random_cosine_direction": lambda s, d: s.m.random_cosine_direction(
        s.arr(d["u1"]), s.arr(d["u2"])),
    "eval_lambertian": lambda s, d: s.m.eval_lambertian(
        s.arr(d["refl"]), s.v3(d["a"]), s.v3(d["b"])),
    "sample_lambertian": lambda s, d: s.m.sample_lambertian(
        s.arr(d["refl"]), s.v3(d["a"]), s.arr(d["u1"]), s.arr(d["u2"])),
    "ggx_d": lambda s, d: s.m.ggx_d(s.arr(d["alpha"]), s.v3(d["a"])),
    "ggx_d_near_delta": lambda s, d: s.m.ggx_d(
        s.arr(np.full(N, 4e-4, np.float32)),
        s.v3(_unit(np.random.default_rng(3)) * [1e-3, 1e-3, 1.0])),
    "smith_g2": lambda s, d: s.m.smith_g2(s.arr(d["alpha"]), s.arr(d["cos"]),
                                          s.arr(d["u1"])),
    "sample_vndf": lambda s, d: s.m.sample_vndf(
        s.arr(d["alpha"]), s.v3(d["a"]), s.arr(d["u1"]), s.arr(d["u2"])),
    "vndf_pdf": lambda s, d: s.m.vndf_pdf(s.arr(d["alpha"]), s.v3(d["a"]),
                                          s.v3(d["b"])),
    "fresnel_dielectric": lambda s, d: s.m.fresnel_dielectric(
        s.arr(d["eta_i"]), s.arr(d["eta_o"]), s.arr(d["cos"])),
    "fresnel_conductor": lambda s, d: s.m.fresnel_conductor(
        s.arr(d["eta"]), s.arr(d["kappa"] + 0.1), s.arr(d["cos"])),
    "eval_ggx_lanes": lambda s, d: [
        v for fp in s.m.eval_ggx_lanes(
            s.arr(d["alpha"]), s.arr(d["kappa"] > 0.0), s.arr(d["perm"]),
            s.v3(d["a"]), s.v3(d["b"]), s.mode.Radiance,
            [(s.arr(d["eta_i"] + 0.1 * k), s.arr(d["eta_o"]),
              s.arr(d["kappa"])) for k in range(4)]) for v in fp],
    "sample_ggx_direction": lambda s, d: s.m.sample_ggx(
        *_ggx_args(s, d), s.v3(d["a"]), s.arr(d["u1"]), s.arr(d["u2"]),
        s.arr(d["u3"]), s.mode.Radiance)[0],
    "sample_ggx_weight": lambda s, d: s.m.sample_ggx(
        *_ggx_args(s, d), s.v3(d["a"]), s.arr(d["u1"]), s.arr(d["u2"]),
        s.arr(d["u3"]), s.mode.Radiance)[3],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cmath_matches_jax(name):
    d = _inputs(7)
    ref = _flat(CASES[name](JAX, d))
    got = _flat(CASES[name](TORCH, d))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("near_delta", [False, True])
def test_sample_ggx_f_pdf(near_delta):
    """Sampled f and pdf, including the α = 4e-4 near-delta lobe whose
    stable D denominator keeps pdfs far above the kill gates."""
    d = _inputs(11)
    outs = []
    for s in (JAX, TORCH):
        _, f, pdf, _ = s.m.sample_ggx(
            *_ggx_args(s, d, near_delta), s.v3(d["a"]), s.arr(d["u1"]),
            s.arr(d["u2"]), s.arr(d["u3"]), s.mode.Radiance)
        outs.append((_np(f), _np(pdf)))
    (f_r, p_r), (f_t, p_t) = outs
    for a, b in ((f_t, f_r), (p_t, p_r)):
        assert np.isfinite(a).all()
        ok = np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert ok.mean() >= 0.995, f"only {ok.mean():.4f} within tolerance"
    if near_delta:
        assert np.percentile(p_t[p_r > 0], 1) > 1.0


def test_cie_fits():
    lam = np.linspace(360.0, 830.0, 2001).astype(np.float32)
    for fn in ("x_bar", "y_bar", "z_bar"):
        ref = np.asarray(getattr(jax_cie, fn)(jnp.asarray(lam)))
        got = getattr(torch_cie, fn)(torch.as_tensor(lam)).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)
    xyz = np.random.default_rng(1).random((64, 3)).astype(np.float32)
    ref = np.asarray(jax_cie.xyz_to_rgb(jnp.asarray(xyz), jax_cie.XYZ_TO_REC709))
    got = torch_cie.xyz_to_rgb(torch.as_tensor(xyz),
                               torch_cie.XYZ_TO_REC709).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


def test_spectral_bake_and_evaluate():
    def curves(sp):
        return [sp.FlatCurve(0.7), sp.CauchyCurve(1.5, 4200.0),
                sp.BlackbodyCurve(5500.0, 18.0),
                sp.SpikeCurve(630.0, 60.0, 60.0, 0.65),
                sp.TabulatedCurve(np.array([400.0, 500.0, 600.0, 700.0]),
                                  np.array([0.1, 0.8, 0.3, 0.5])),
                sp.LinearCurve(np.array([0.2, 0.9, 0.4]),
                               jax_spectral.Bounds1D(380.0, 780.0))]

    jb = jax_spectral.bake_curves(curves(jax_spectral))
    tb = torch_spectral.bake_curves(curves(torch_spectral))
    for field in ("values", "pairs", "cdf", "cdf_pairs", "integral"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      np.asarray(getattr(jb, field)))
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 6, N).astype(np.int32)
    lam = rng.uniform(360.0, 800.0, N).astype(np.float32)
    ref = np.asarray(jax_spectral.evaluate(jb, jnp.asarray(idx),
                                           jnp.asarray(lam)))
    got = torch_spectral.evaluate(tb, torch.as_tensor(idx),
                                  torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("aperture, blades", [(0.0, 0), (0.1, 0), (0.1, 6)])
def test_camera_get_ray(aperture, blades):
    kw = dict(look_from=[-1.2, 0.5, 0.5], look_at=[0.5, 0.5, 0.5],
              vfov_degrees=40.0, focal_distance=1.7,
              aperture_diameter=aperture, aspect_ratio=1.5, blades=blades,
              blade_sharpness=0.7)
    jcam, tcam = jax_camera(**kw), torch_camera(**kw, device="cpu")
    u = np.random.default_rng(9).random((4, N)).astype(np.float32)
    ref = jcam.get_ray(*[jnp.asarray(x) for x in u])
    got = tcam.get_ray(*[torch.as_tensor(x) for x in u])
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-6)


def test_camera_from_jax_leaves():
    """camera_from_numpy on the JAX camera's leaves gives the port's own
    make_projective_camera, field for field."""
    from pathtracer_tpu_torch.camera import camera_from_numpy

    kw = dict(look_from=[-1.2, 0.5, 0.5], look_at=[0.5, 0.5, 0.5],
              vfov_degrees=40.0, focal_distance=1.7, aperture_diameter=0.1,
              aspect_ratio=1.5, blades=6, blade_sharpness=0.7)
    jcam, tcam = jax_camera(**kw), torch_camera(**kw, device="cpu")
    names = [f.name for f in dataclasses.fields(tcam)]
    got = camera_from_numpy({n: np.asarray(getattr(jcam, n)) for n in names},
                            "cpu")
    for n in names:
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      getattr(tcam, n).numpy(), err_msg=n)
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(jcam, n)), err_msg=n)


def test_prelude_matches_jax():
    from pathtracer_tpu import prelude as jp
    from pathtracer_tpu_torch import prelude as tp

    for name in ("INTERSECTION_TIME_OFFSET", "NORMAL_OFFSET", "RAY_TMAX",
                 "MAUVE_XYZ"):
        assert np.allclose(getattr(tp, name), getattr(jp, name)), name
    assert [int(m) for m in TMode] == [int(m) for m in JMode]
    a, b = np.random.default_rng(2).random((2, N)).astype(np.float32)
    ref = np.asarray(jp.power_heuristic(jnp.asarray(a), jnp.asarray(b)))
    got = tp.power_heuristic(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
