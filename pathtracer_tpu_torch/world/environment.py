"""Environments: Constant, Sun and HDR (counterpart of
`world/environment.py`).

The HDR environment's texel weights live in the shared texture atlas and
its importance tables (`world/importance_map.py`) ride the `Environment`.
`rotation` (world -> env) is applied to a query direction before the
equirect mapping. Directions are `V3`s of per-lane tensors
(`kernels/cmath.py`); the rotation is applied as written-out dot products.

The JAX package evaluates all three kinds and selects by `kind`; the port
reads `kind` on the host and evaluates the one branch it names. The
importance-map inverse transform selects rows and columns with indexed
gathers and `torch.searchsorted(..., right=True)`: the index of the first
CDF entry greater than u, so an entry equal to u counts as below it, as
the JAX package's sum-of-less-than-or-equal does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels.cmath import V3
from pathtracer_tpu_torch.textures.texture import Textures, eval_texture

ENV_CONSTANT = 0  # the JAX package's kind codes
ENV_SUN = 1
ENV_HDR = 2


@dataclasses.dataclass
class Environment:
    kind: torch.Tensor  # i32
    strength: torch.Tensor  # f32
    curve_idx: torch.Tensor  # i32 — SPD of Constant and Sun
    sun_direction: torch.Tensor  # f32[3]
    sun_cos_angle: torch.Tensor  # f32 cos(angular_diameter / 2)
    tex_id: torch.Tensor  # i32 — HDR texture id
    rotation: torch.Tensor  # f32[3,3] world->env
    rotation_inv: torch.Tensor  # f32[3,3] env->world
    imp_marginal_cdf: torch.Tensor  # f32[H+1]
    imp_row_cdf: torch.Tensor  # f32[H, W+1]
    imp_pdf: torch.Tensor  # f32[H, W] joint pdf over uv
    imp_baked: torch.Tensor  # bool


def constant_env_numpy(curve_idx: int, strength: float) -> dict:
    """The numpy fields of a constant environment (`Environment` names),
    equal to the JAX package's `Environment.constant`."""
    eye = np.eye(3, dtype=np.float32)
    return dict(kind=np.int32(ENV_CONSTANT), strength=np.float32(strength),
                curve_idx=np.int32(curve_idx),
                sun_direction=np.array([0.0, 0.0, 1.0], np.float32),
                sun_cos_angle=np.float32(0.0), tex_id=np.int32(0),
                rotation=eye, rotation_inv=eye.copy(),
                imp_marginal_cdf=np.zeros((2,), np.float32),
                imp_row_cdf=np.zeros((1, 2), np.float32),
                imp_pdf=np.ones((1, 1), np.float32),
                imp_baked=np.bool_(False))


def sun_env_numpy(curve_idx: int, strength: float, sun_direction,
                  angular_diameter: float) -> dict:
    """A Sun environment: the constant SPD inside a cap of
    `angular_diameter` (radians) around `sun_direction`."""
    sd = np.asarray(sun_direction, np.float64)
    sd = sd / np.linalg.norm(sd)
    return dict(constant_env_numpy(curve_idx, strength),
                kind=np.int32(ENV_SUN),
                sun_direction=sd.astype(np.float32),
                sun_cos_angle=np.float32(np.cos(angular_diameter / 2.0)))


def hdr_env_numpy(tex_id: int, strength: float, rotation=None,
                  tables=None) -> dict:
    """An HDR environment over texture `tex_id`. `rotation` is the 3x3
    env->world rotation (identity if None); `tables` the baked importance
    tables (marginal, row, pdf) or None for uniform-uv sampling."""
    rot = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    env = dict(constant_env_numpy(0, strength), kind=np.int32(ENV_HDR),
               tex_id=np.int32(tex_id),
               rotation=np.linalg.inv(rot).astype(np.float32),
               rotation_inv=rot.astype(np.float32))
    if tables is not None:
        marginal, row, pdf = tables
        env.update(imp_marginal_cdf=marginal, imp_row_cdf=row, imp_pdf=pdf,
                   imp_baked=np.bool_(True))
    return env


def rotate(m: torch.Tensor, d: V3) -> V3:
    """m @ d for a 3x3 matrix `m` and a V3 of per-lane tensors."""
    r = [[float(m[i, j]) for j in range(3)] for i in range(3)]
    return V3(*[r[i][0] * d.x + r[i][1] * d.y + r[i][2] * d.z
                for i in range(3)])


def _uv_solid_angle_jacobian(v):
    """|d(uv)/dω|⁻¹ of the equirect map, 2π² sin(πv) + 0.001."""
    return 2.0 * math.pi * math.pi * torch.sin(math.pi * v) + 0.001


def _sun_in(env: Environment, d: V3):
    s = [float(x) for x in env.sun_direction]
    return (d.x * s[0] + d.y * s[1] + d.z * s[2]) >= float(env.sun_cos_angle)


def env_emission(env: Environment, bank: spectral.CurveBank, tex: Textures,
                 d: V3, lam):
    """Radiance arriving from unit world direction `d` at wavelength `lam`."""
    kind = int(env.kind)
    if kind == ENV_HDR:
        u, v = cmath.direction_to_uv(rotate(env.rotation, d))
        e = eval_texture(tex, bank, int(env.tex_id), lam, u, v)
    else:
        e = spectral.evaluate(bank, int(env.curve_idx), lam)
        if kind == ENV_SUN:
            e = torch.where(_sun_in(env, d), e, 0.0)
    return float(env.strength) * e


def env_pdf_for(env: Environment, d: V3):
    """Solid-angle pdf with which `env_sample_uv` yields direction `d`."""
    kind = int(env.kind)
    if kind == ENV_SUN:
        cap_area = 2.0 * math.pi * (1.0 - env.sun_cos_angle.float())
        inv_cap = float(1.0 / torch.clamp(cap_area, min=1e-9))
        return torch.where(_sun_in(env, d), inv_cap, 0.0)
    u, v = cmath.direction_to_uv(rotate(env.rotation, d))
    jac = _uv_solid_angle_jacobian(v)
    h, w = env.imp_pdf.shape
    if kind == ENV_HDR and bool(env.imp_baked) and (h, w) != (1, 1):
        yi = torch.clamp((v * h).long(), 0, h - 1)
        xi = torch.clamp((u * w).long(), 0, w - 1)
        return env.imp_pdf.to(d.x.device)[yi, xi] / jac
    return 1.0 / jac


def _safe_cdf_frac(num, den):
    ok = den > 1e-12
    return num / torch.where(ok, den, 1.0) * ok.float()


def env_sample_uv(env: Environment, u1, u2):
    """A world direction sampled from the environment and its solid-angle
    pdf -> (V3, pdf)."""
    kind = int(env.kind)
    dev = u1.device
    if kind == ENV_SUN:
        cos_a = env.sun_cos_angle.float()
        cos_t = 1.0 - u1 * (1.0 - cos_a)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * math.pi * u2
        s = [env.sun_direction[i].float() for i in range(3)]
        t_ax, b_ax = cmath.orthonormal_basis(V3(*s))
        a, b = sin_t * torch.cos(phi), sin_t * torch.sin(phi)
        d = V3(*[a * float(t_ax[i]) + b * float(b_ax[i]) + cos_t * float(s[i])
                 for i in range(3)])
        return d, env_pdf_for(env, d)
    h, w = env.imp_pdf.shape
    uu, vv = u1, u2
    if kind == ENV_HDR and bool(env.imp_baked) and (h, w) != (1, 1):
        # 2-level inverse transform with the intra-texel CDF lerp. The
        # uniforms are often column slices of a block: torch.searchsorted
        # warns on a strided input and copies it, so copy once here
        u1, u2 = u1.contiguous(), u2.contiguous()
        mcdf = env.imp_marginal_cdf.to(dev)
        rows = env.imp_row_cdf.to(dev)
        yi = torch.clamp(torch.searchsorted(mcdf, u1, right=True) - 1, 0,
                         h - 1)
        row = rows[yi]
        xi = torch.clamp(torch.searchsorted(row, u2[:, None],
                                            right=True)[:, 0] - 1, 0, w - 1)
        m0, m1 = mcdf[yi], mcdf[yi + 1]
        fy = torch.clamp(_safe_cdf_frac(u1 - m0, m1 - m0), 0.0, 1.0)
        r0 = row.gather(1, xi[:, None])[:, 0]
        r1 = row.gather(1, xi[:, None] + 1)[:, 0]
        fx = torch.clamp(_safe_cdf_frac(u2 - r0, r1 - r0), 0.0, 1.0)
        uu = cmath.fdiv(xi.float() + fx, float(w))
        vv = cmath.fdiv(yi.float() + fy, float(h))
    d = rotate(env.rotation_inv, cmath.uv_to_direction(uu, vv))
    return d, env_pdf_for(env, d)
