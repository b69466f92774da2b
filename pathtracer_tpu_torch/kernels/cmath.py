"""Componentwise (structure-of-arrays) vector and BSDF math in plain torch
(counterpart of `pathtracer_tpu.kernels.cmath`).

`V3` is a tuple of three same-shaped tensors. These functions are the plain
twin of `csrc/cmath.cuh`, which holds the same math as `__device__`
functions for the CUDA kernels; the round's plain versions
(`kernels/megakernel.py:_shade`, `_finalize_core`) call them on per-lane
tensors.
Same names, same guards and the same operation order as the JAX module.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.prelude import TransportMode, safe_div

PI = math.pi


def fdiv(x, c: float):
    """x / c rounded once, as IEEE division. PyTorch's CUDA kernel divides
    by a host scalar as a multiply by its reciprocal, one ulp off the CUDA
    kernels' division; dividing by a tensor keeps the plain twin exact."""
    return x / torch.full_like(x, c)


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def scale(self, s):
        return V3(self.x * s, self.y * s, self.z * s)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length_squared(a: V3):
    return dot(a, a)


def normalize(a: V3) -> V3:
    inv = 1.0 / torch.sqrt(torch.clamp(dot(a, a), min=1e-20))
    return a.scale(inv)


def where(m, a: V3, b: V3) -> V3:
    return V3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
              torch.where(m, a.z, b.z))


def reflect(w: V3, n: V3) -> V3:
    return (-w) + n.scale(2.0 * dot(w, n))


def refract(w: V3, n: V3, eta_rel):
    """Returns (wt, tir_mask)."""
    cos_i = dot(w, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta_rel * eta_rel * sin2_i
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = (-w).scale(eta_rel) + n.scale(eta_rel * cos_i - cos_t)
    return wt, tir


def orthonormal_basis(n: V3):
    """Branchless Frisvad/Duff tangent frame."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = V3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def to_local(t: V3, b: V3, n: V3, w: V3) -> V3:
    return V3(dot(w, t), dot(w, b), dot(w, n))


def to_world(t: V3, b: V3, n: V3, wl: V3) -> V3:
    return V3(
        t.x * wl.x + b.x * wl.y + n.x * wl.z,
        t.y * wl.x + b.y * wl.y + n.y * wl.z,
        t.z * wl.x + b.z * wl.y + n.z * wl.z,
    )


def uv_to_direction(u, v) -> V3:
    """Equirect (u, v) -> unit direction."""
    phi = 2.0 * PI * u
    theta = PI * v
    st = torch.sin(theta)
    return V3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))


def direction_to_uv(d: V3):
    u = torch.remainder(fdiv(torch.atan2(d.y, d.x), 2.0 * PI), 1.0)
    v = fdiv(torch.acos(torch.clamp(d.z, -1.0, 1.0)), PI)
    return u, v


# ------------------------------------------------------------------ sampling


def random_cosine_direction(u, v) -> V3:
    r = torch.sqrt(u)
    phi = 2.0 * PI * v
    return V3(r * torch.cos(phi), r * torch.sin(phi),
              torch.sqrt(torch.clamp(1.0 - u, min=0.0)))


def random_in_unit_disk(u, v):
    r = torch.sqrt(u)
    phi = 2.0 * PI * v
    return r * torch.cos(phi), r * torch.sin(phi)


# ---------------------------------------------------------------- lambertian


def eval_lambertian(reflectance, wi: V3, wo: V3):
    same_hemi = wi.z * wo.z > 0.0
    f = torch.where(same_hemi, fdiv(torch.clamp(reflectance, max=1.0), PI),
                    0.0)
    pdf = torch.where(same_hemi, fdiv(torch.abs(wo.z), PI), 0.0)
    return f, pdf


def sample_lambertian(reflectance, wi: V3, u1, u2):
    wo = random_cosine_direction(u1, u2)
    wo = V3(wo.x, wo.y, torch.where(wi.z < 0.0, -wo.z, wo.z))
    f, pdf = eval_lambertian(reflectance, wi, wo)
    return wo, f, pdf


# ----------------------------------------------------------------------- ggx


def ggx_d(alpha, wh: V3):
    """Stable a2*cos2 + sin2 denominator (the nz2*(a2-1)+1 form cancels
    catastrophically for near-delta lobes)."""
    a2 = alpha * alpha
    nz2 = wh.z * wh.z
    sx2 = wh.x * wh.x + wh.y * wh.y
    denom = nz2 * a2 + sx2
    return a2 / torch.clamp(PI * denom * denom, min=1e-20)


def smith_lambda(alpha, w_z):
    cos2 = w_z * w_z
    tan2 = torch.clamp(1.0 - cos2, min=0.0) / torch.clamp(cos2, min=1e-12)
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def smith_g1(alpha, w_z):
    return 1.0 / (1.0 + smith_lambda(alpha, w_z))


def smith_g2(alpha, wi_z, wo_z):
    return 1.0 / (1.0 + smith_lambda(alpha, wi_z) + smith_lambda(alpha, wo_z))


def sample_vndf(alpha, wi: V3, u1, u2) -> V3:
    """Heitz visible-normal sampling."""
    flip = wi.z < 0.0
    wi_u = where(flip, -wi, wi)
    v = normalize(V3(alpha * wi_u.x, alpha * wi_u.y, wi_u.z))
    lensq = v.x * v.x + v.y * v.y
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-12
    t1 = V3(torch.where(big, -v.y * inv_len, 1.0),
            torch.where(big, v.x * inv_len, 0.0),
            torch.zeros_like(v.z))
    t2 = cross(v, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    n_h = t1.scale(p1) + t2.scale(p2) + v.scale(p3)
    wh = normalize(V3(alpha * n_h.x, alpha * n_h.y,
                      torch.clamp(n_h.z, min=1e-6)))
    return where(flip, -wh, wh)


def vndf_pdf(alpha, wi: V3, wh: V3):
    g1 = smith_g1(alpha, torch.abs(wi.z))
    d = ggx_d(alpha, wh)
    return safe_div(g1 * d * torch.abs(dot(wi, wh)), torch.abs(wi.z))


def fresnel_dielectric(eta_i, eta_t, cos_i):
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    r = ei / et
    sin_t2 = r * r * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin_t2 >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    r_par = safe_div(et * ci - ei * ct, et * ci + ei * ct)
    r_perp = safe_div(ei * ci - et * ct, ei * ci + et * ct)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def fresnel_conductor(eta_rel, k_rel, cos_i):
    ci = torch.abs(torch.clamp(cos_i, -1.0, 1.0))
    ci2 = ci * ci
    si2 = 1.0 - ci2
    e2, k2 = eta_rel * eta_rel, k_rel * k_rel
    t0 = e2 - k2 - si2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + ci2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return torch.clamp(0.5 * (rs + rp), 0.0, 1.0)


def _reflect_probability(fres, metallic, permeability):
    p = 1.0 - permeability * (1.0 - fres)
    return torch.where(metallic, 1.0, torch.clamp(p, 0.0, 1.0))


def _finite_nonneg(x):
    return torch.where(torch.isfinite(x) & (x >= 0.0), x, 0.0)


def eval_ggx_lanes(alpha, metallic, permeability, wi: V3, wo: V3,
                   transport_mode, lanes, has_metal=True):
    """GGX eval for several spectral lanes sharing (wi, wo, alpha): the
    λ-independent reflection geometry is computed once. `lanes` is a list of
    (eta_i, eta_o, kappa); returns [(f, pdf)] per lane."""
    same_hemi = wi.z * wo.z > 0.0
    cos_i = wi.z
    abs_ci = torch.clamp(torch.abs(cos_i), min=1e-7)
    abs_co = torch.clamp(torch.abs(wo.z), min=1e-7)
    outside = cos_i > 0.0

    wh_r = normalize(wi + wo)
    wh_r = where(wh_r.z * cos_i < 0.0, -wh_r, wh_r)
    d_r = ggx_d(alpha, wh_r)
    g_r = smith_g2(alpha, wi.z, wo.z)
    cos_ih_r = dot(wi, wh_r)
    refl_fac = d_r * g_r / (4.0 * abs_ci * abs_co)
    g1_i = smith_g1(alpha, torch.abs(wi.z))
    refl_pdf = (safe_div(g1_i * d_r * torch.abs(cos_ih_r), torch.abs(wi.z))
                / torch.clamp(4.0 * torch.abs(cos_ih_r), min=1e-7))
    eta_sc_on = transport_mode == TransportMode.Radiance

    out = []
    for eta_i, eta_o, kappa in lanes:
        eta_from = torch.where(outside, eta_o, eta_i)
        eta_to = torch.where(outside, eta_i, eta_o)
        f_diel = fresnel_dielectric(eta_from, eta_to, cos_ih_r)
        if has_metal:
            f_cond = fresnel_conductor(
                safe_div(eta_to, eta_from, 1.0), safe_div(kappa, eta_from),
                cos_ih_r)
            fres_r = torch.where(metallic, f_cond, f_diel)
        else:
            fres_r = f_diel
        refl_f = fres_r * refl_fac

        # transmission lobe (Walter 2007 eq. 21): ht depends on λ
        ht = normalize(-(wi.scale(eta_from) + wo.scale(eta_to)))
        ht_u = where(ht.z < 0.0, -ht, ht)
        d_t = ggx_d(alpha, ht_u)
        cos_ih_t = dot(wi, ht)
        cos_oh_t = dot(wo, ht)
        fres_t = fresnel_dielectric(eta_from, eta_to, cos_ih_t)
        denom_t = eta_from * cos_ih_t + eta_to * cos_oh_t
        trans_f = (
            torch.abs(cos_ih_t * cos_oh_t) * (1.0 - fres_t) * d_t * g_r
            * safe_div(eta_to * eta_to, denom_t * denom_t)
            / (abs_ci * abs_co)
        )
        if eta_sc_on:
            eta_scale = safe_div(eta_from * eta_from, eta_to * eta_to, 1.0)
        else:
            eta_scale = 1.0
        jac_t = safe_div(eta_to * eta_to * torch.abs(cos_oh_t),
                         denom_t * denom_t)
        trans_f = trans_f * eta_scale * permeability
        trans_pdf = (safe_div(g1_i * d_t * torch.abs(dot(wi, ht_u)),
                              torch.abs(wi.z)) * jac_t)

        refl_prob = _reflect_probability(fres_r, metallic, permeability)
        f_out = torch.where(same_hemi, refl_f, trans_f)
        pdf_out = torch.where(
            same_hemi, refl_pdf * refl_prob,
            trans_pdf
            * (1.0 - _reflect_probability(fres_t, metallic, permeability)))
        out.append((_finite_nonneg(f_out), _finite_nonneg(pdf_out)))
    return out


def eval_ggx(alpha, eta_i, eta_o, kappa, metallic, permeability,
             wi: V3, wo: V3, transport_mode, has_metal=True):
    """Returns (f, pdf)."""
    return eval_ggx_lanes(alpha, metallic, permeability, wi, wo,
                          transport_mode, [(eta_i, eta_o, kappa)],
                          has_metal=has_metal)[0]


def sample_ggx(alpha, eta_i, eta_o, kappa, metallic, permeability,
               wi: V3, u1, u2, u_lobe, transport_mode, has_metal=True):
    """Returns (wo, f, pdf, weight)."""
    wh = sample_vndf(alpha, wi, u1, u2)
    cos_ih = dot(wi, wh)
    outside = wi.z > 0.0
    eta_from = torch.where(outside, eta_o, eta_i)
    eta_to = torch.where(outside, eta_i, eta_o)
    f_diel = fresnel_dielectric(eta_from, eta_to, cos_ih)
    if has_metal:
        f_cond = fresnel_conductor(
            safe_div(eta_to, eta_from, 1.0), safe_div(kappa, eta_from), cos_ih)
        fres = torch.where(metallic, f_cond, f_diel)
    else:
        fres = f_diel
    refl_prob = _reflect_probability(fres, metallic, permeability)

    wo_r = reflect(wi, wh)
    wh_towards = where(cos_ih < 0.0, -wh, wh)
    wo_t, tir = refract(wi, wh_towards,
                        eta_from / torch.clamp(eta_to, min=1e-7))
    choose_reflect = (u_lobe < refl_prob) | tir | metallic
    wo = where(choose_reflect, wo_r, wo_t)
    f, pdf = eval_ggx(alpha, eta_i, eta_o, kappa, metallic, permeability,
                      wi, wo, transport_mode, has_metal=has_metal)
    g2 = smith_g2(alpha, wi.z, wo.z)
    g1 = smith_g1(alpha, torch.abs(wi.z))
    g_ratio = safe_div(g2, g1)
    if transport_mode == TransportMode.Radiance:
        eta_scale = safe_div(eta_from * eta_from, eta_to * eta_to, 1.0)
    else:
        eta_scale = 1.0
    w_reflect = safe_div(fres * g_ratio, refl_prob)
    w_trans = g_ratio * eta_scale
    same_hemi = wi.z * wo.z > 0.0
    weight = torch.where(
        choose_reflect,
        torch.where(same_hemi, w_reflect, 0.0),
        torch.where(same_hemi, 0.0, w_trans))
    return wo, f, pdf, _finite_nonneg(weight)
