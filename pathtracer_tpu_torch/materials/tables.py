"""Material table (counterpart of `materials/tables.py`): SoA parameters
indexed by material id, and the lights' emission, emission pdf and emission
spectrum sampling (the JAX `materials/diffuse_light.py` and
`sharp_light.py` folded in). The BSDF math itself lives in
`kernels/cmath.py` and the round kernels; the XLA-style masked dispatch is
not ported."""

from __future__ import annotations

import dataclasses
import math

import torch

from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.kernels.cmath import fdiv

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
