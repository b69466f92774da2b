"""Material table (counterpart of `materials/tables.py`): SoA parameters
indexed by material id, and the lights' emission, emission pdf and emission
spectrum sampling (the JAX `materials/diffuse_light.py` and
`sharp_light.py` folded in), and the masked BSDF dispatch over the material
types (`bsdf_eval`, `bsdf_sample`) that the regen integrator without
kernels calls on `[N, 3]` local directions. The lambertian and GGX math is
`kernels/cmath.py`'s, the plain twin of the round kernels' device code: it
agrees with the JAX `materials/ggx.py` and `lambertian.py` to f32
rounding."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels.cmath import V3, fdiv
from pathtracer_tpu_torch.textures.texture import eval_texture

MAT_LAMBERTIAN = 0
MAT_GGX = 1
MAT_DIFFUSE_LIGHT = 2
MAT_SHARP_LIGHT = 3
MAT_PASSTHROUGH = 4

# light sidedness (materials/diffuse_light.py)
SIDE_FORWARD = 0  # emits on the +normal side
SIDE_REVERSE = 1  # emits on the -normal side
SIDE_DUAL = 2  # emits both sides


@dataclasses.dataclass
class Materials:
    mtype: torch.Tensor  # i32[M]
    tex_id: torch.Tensor  # i32[M] lambertian reflectance texture (-1 unused)
    alpha: torch.Tensor  # f32[M] ggx roughness
    eta_idx: torch.Tensor  # i32[M] inner IOR curve
    eta_o_idx: torch.Tensor  # i32[M] outer IOR curve
    kappa_idx: torch.Tensor  # i32[M] extinction curve
    permeability: torch.Tensor  # f32[M]
    metallic: torch.Tensor  # bool[M] (kappa integral > 0)
    inner_medium: torch.Tensor  # i32[M]
    outer_medium: torch.Tensor  # i32[M]
    emit_idx: torch.Tensor  # i32[M] emission SPD curve
    bounce_idx: torch.Tensor  # i32[M] light bounce-color curve
    sharpness: torch.Tensor  # f32[M]
    sidedness: torch.Tensor  # i32[M]

    @property
    def count(self):
        return self.mtype.shape[0]


def sidedness_gate(sidedness, cos_theta):
    """1 where a direction with cosine `cos_theta` to the normal is on an
    emitting side, else 0."""
    return torch.where(sidedness == SIDE_DUAL, (cos_theta != 0.0).float(),
                       torch.where(sidedness == SIDE_FORWARD,
                                   (cos_theta > 0.0).float(),
                                   (cos_theta < 0.0).float()))


def emission(mats: Materials, bank, mat_id, lam, uv, cos_theta):
    """Radiance emitted toward a direction with cosine `cos_theta` to the
    normal: diffuse lights spd/π, sharp lights the cosine-power lobe, both
    gated by sidedness; 0 for other materials. `uv` is unused (the JAX
    signature's)."""
    mat_id = mat_id.long()
    mtype = mats.mtype[mat_id]
    spd = spectral.evaluate(bank, torch.clamp(mats.emit_idx[mat_id], min=0),
                            lam)
    side = mats.sidedness[mat_id]
    gate = sidedness_gate(side, cos_theta)
    e_diff = spd / math.pi * gate
    n = mats.sharpness[mat_id]
    e_sharp = spd * ((n + 1.0) * torch.abs(cos_theta) ** n
                     / (2.0 * math.pi)) * gate
    is_light = (mtype == MAT_DIFFUSE_LIGHT) | (mtype == MAT_SHARP_LIGHT)
    return torch.where(is_light, torch.where(mtype == MAT_SHARP_LIGHT,
                                             e_sharp, e_diff), 0.0)


def emission_direction_pdf(mats: Materials, mat_id, cos_theta):
    """The solid-angle pdf with which a light's own emission sampler draws a
    direction with cosine `cos_theta` (dual-sided lights halve it)."""
    mat_id = mat_id.long()
    return emission_direction_pdf_rows(mats.mtype[mat_id],
                                       mats.sidedness[mat_id],
                                       mats.sharpness[mat_id], cos_theta)


def emission_direction_pdf_rows(mtype, side, sharpness, cos_theta,
                                has_sharp: bool = True):
    """emission_direction_pdf on the lights' own type, sidedness and
    sharpness, as the material table or the LT light table holds them;
    `has_sharp` False leaves out the cosine-power lobe where no light is
    sharp."""
    gate = sidedness_gate(side, cos_theta)
    p = fdiv(torch.abs(cos_theta), math.pi) * gate
    if has_sharp:
        p_sharp = fdiv((sharpness + 1.0) * torch.abs(cos_theta) ** sharpness,
                       2.0 * math.pi) * gate
        p = torch.where(mtype == MAT_SHARP_LIGHT, p_sharp, p)
    p = torch.where(side == SIDE_DUAL, p * 0.5, p)
    is_light = (mtype == MAT_DIFFUSE_LIGHT) | (mtype == MAT_SHARP_LIGHT)
    return torch.where(is_light, p, 0.0)


def sample_emission_spectrum(mats: Materials, bank, mat_id, u, bounds):
    """λ drawn from the light's emission SPD -> (lam, power, pdf per nm)."""
    idx = torch.clamp(mats.emit_idx[mat_id.long()], min=0)
    return spectral.sample_power_and_pdf(bank, idx, u, bounds)


# ------------------------------------------------------------ BSDF dispatch


class MatRec(NamedTuple):
    """The material parameters of each lane, fetched once per dispatch."""

    mtype: torch.Tensor
    tex_id: torch.Tensor
    alpha: torch.Tensor
    eta_idx: torch.Tensor
    eta_o_idx: torch.Tensor
    kappa_idx: torch.Tensor
    permeability: torch.Tensor
    metallic: torch.Tensor
    inner_medium: torch.Tensor
    outer_medium: torch.Tensor
    emit_idx: torch.Tensor
    bounce_idx: torch.Tensor
    sharpness: torch.Tensor
    sidedness: torch.Tensor


def fetch_material(mats: Materials, mat_id) -> MatRec:
    i = mat_id.long()
    return MatRec(*[getattr(mats, f)[i] for f in MatRec._fields])


def _fetch_spectral(mats: Materials, bank, mat_id, lam):
    """(eta_i, eta_o, kappa, bounce) of each lane's material at λ."""
    i = mat_id.long()
    return tuple(spectral.evaluate(bank, torch.clamp(idx[i], min=0), lam)
                 for idx in (mats.eta_idx, mats.eta_o_idx, mats.kappa_idx,
                             mats.bounce_idx))


def _reflectance_from(curve_val, rec: MatRec, bank, tex, lam, uv):
    """A lambertian's texture value at (λ, uv), else the light's bounce
    curve value."""
    tex_val = eval_texture(tex, bank, torch.clamp(rec.tex_id, min=0), lam,
                           uv[..., 0], uv[..., 1])
    return torch.where(rec.mtype == MAT_LAMBERTIAN, tex_val, curve_val)


def _ggx_from(rec: MatRec, eta_i, eta_o, kappa):
    alpha = torch.clamp(rec.alpha, min=1e-4)
    eta_i = torch.clamp(eta_i, min=1e-3)
    eta_o = torch.clamp(eta_o, min=1e-3)
    return alpha, eta_i, eta_o, kappa


def bsdf_eval(mats: Materials, bank, tex, mat_id, lam, uv, wi, wo, mode):
    """(f, solid-angle pdf) of each lane's material for local directions
    wi, wo [N, 3]."""
    rec = fetch_material(mats, mat_id)
    s_eta_i, s_eta_o, s_kappa, s_bounce = _fetch_spectral(mats, bank, mat_id,
                                                          lam)
    refl = _reflectance_from(s_bounce, rec, bank, tex, lam, uv)
    wi3, wo3 = V3(*wi.unbind(-1)), V3(*wo.unbind(-1))
    f_lam, pdf_lam = cmath.eval_lambertian(refl, wi3, wo3)
    alpha, eta_i, eta_o, kappa = _ggx_from(rec, s_eta_i, s_eta_o, s_kappa)
    f_ggx, pdf_ggx = cmath.eval_ggx(alpha, eta_i, eta_o, kappa, rec.metallic,
                                    rec.permeability, wi3, wo3, mode)
    is_ggx = rec.mtype == MAT_GGX
    f = torch.where(is_ggx, f_ggx, f_lam)
    pdf = torch.where(is_ggx, pdf_ggx, pdf_lam)
    # a passthrough surface scatters nothing here (as in the reference)
    is_pass = rec.mtype == MAT_PASSTHROUGH
    return torch.where(is_pass, 0.0, f), torch.where(is_pass, 0.0, pdf)


def bsdf_sample(mats: Materials, bank, tex, mat_id, lam, uv, wi, u1, u2,
                u_lobe, mode):
    """A sampled local direction and its evaluation -> (wo [N, 3], f, pdf,
    weight), weight the throughput f·|cos θo| / pdf of the sampled lobe in
    closed form (stable for near-delta lobes)."""
    rec = fetch_material(mats, mat_id)
    s_eta_i, s_eta_o, s_kappa, s_bounce = _fetch_spectral(mats, bank, mat_id,
                                                          lam)
    refl = _reflectance_from(s_bounce, rec, bank, tex, lam, uv)
    wi3 = V3(*wi.unbind(-1))
    wo_lam, f_lam, pdf_lam = cmath.sample_lambertian(refl, wi3, u1, u2)
    # cosine sampling: f·cos/pdf is the reflectance, exactly
    w_lam = torch.clamp(refl, max=1.0)
    alpha, eta_i, eta_o, kappa = _ggx_from(rec, s_eta_i, s_eta_o, s_kappa)
    wo_ggx, f_ggx, pdf_ggx, w_ggx = cmath.sample_ggx(
        alpha, eta_i, eta_o, kappa, rec.metallic, rec.permeability, wi3,
        u1, u2, u_lobe, mode)
    is_ggx = rec.mtype == MAT_GGX
    wo = torch.stack(cmath.where(is_ggx, wo_ggx, wo_lam), dim=-1)
    f = torch.where(is_ggx, f_ggx, f_lam)
    pdf = torch.where(is_ggx, pdf_ggx, pdf_lam)
    weight = torch.where(is_ggx, w_ggx, w_lam)
    is_pass = rec.mtype == MAT_PASSTHROUGH
    return (wo, f, torch.where(is_pass, 0.0, pdf),
            torch.where(is_pass, 0.0, weight))
