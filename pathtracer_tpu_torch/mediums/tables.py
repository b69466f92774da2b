"""Medium table (counterpart of `mediums/tables.py`): SoA parameters by
medium id and the per-lane dispatch over HG and Rayleigh media. Medium id 0
is vacuum; materials carry ids as inner/outer_medium and the medium-aware
round tracks a stack of them per lane."""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.mediums import hg as hg_mod
from pathtracer_tpu_torch.mediums import rayleigh as ray_mod

MED_VACUUM = 0
MED_HG = 1
MED_RAYLEIGH = 2


@dataclasses.dataclass
class Mediums:
    mtype: torch.Tensor  # i32[K] (index 0 = vacuum)
    g_idx: torch.Tensor  # i32[K] HG asymmetry curve
    sigma_s_idx: torch.Tensor  # i32[K]
    sigma_a_idx: torch.Tensor  # i32[K]
    ior_idx: torch.Tensor  # i32[K] Rayleigh IOR curve
    corrective: torch.Tensor  # f32[K] Rayleigh corrective factor

    @property
    def count(self):
        return self.mtype.shape[0]

    @staticmethod
    def vacuum_only(device="cpu") -> "Mediums":
        z = torch.zeros((1,), dtype=torch.int32, device=device)
        return Mediums(z, z, z, z, z, torch.zeros((1,), dtype=torch.float32,
                                                  device=device))


def _rows(meds: Mediums, med_id):
    """Each table column at the lanes' medium ids."""
    i = med_id.long()
    return (meds.mtype[i], meds.g_idx[i], meds.sigma_s_idx[i],
            meds.sigma_a_idx[i], meds.ior_idx[i], meds.corrective[i])


def medium_coefficients(meds: Mediums, bank, med_id, lam):
    """(sigma_s, sigma_a, g) at wavelength lam for medium id (0 = vacuum)."""
    mtype, g_idx, ss_idx, sa_idx, ior_idx, corr = _rows(meds, med_id)
    g = spectral.evaluate(bank, g_idx, lam)
    ss_hg = spectral.evaluate(bank, ss_idx, lam)
    sa_hg = spectral.evaluate(bank, sa_idx, lam)
    ior = spectral.evaluate(bank, ior_idx, lam)
    ss_ray = ray_mod.rayleigh_sigma_s(ior, lam, corr)
    is_hg = mtype == MED_HG
    is_ray = mtype == MED_RAYLEIGH
    sigma_s = torch.where(is_hg, ss_hg, torch.where(is_ray, ss_ray, 0.0))
    return (sigma_s, torch.where(is_hg, sa_hg, 0.0),
            torch.where(is_hg, g, 0.0))


def phase_eval(meds: Mediums, bank, med_id, lam, cos_theta):
    i = med_id.long()
    g = spectral.evaluate(bank, meds.g_idx[i], lam)
    return torch.where(meds.mtype[i] == MED_RAYLEIGH,
                       ray_mod.rayleigh_phase(cos_theta),
                       hg_mod.hg_phase(g, cos_theta))


def phase_sample(meds: Mediums, bank, med_id, lam, wi, u1, u2):
    """A scattered direction about wi [..., 3] -> (wo, pdf = phase value)."""
    i = med_id.long()
    g = spectral.evaluate(bank, meds.g_idx[i], lam)
    wo_hg, p_hg = hg_mod.hg_sample_direction(g, wi, u1, u2)
    wo_ray, p_ray = ray_mod.rayleigh_sample_direction(wi, u1, u2)
    is_ray = meds.mtype[i] == MED_RAYLEIGH
    return (torch.where(is_ray[..., None], wo_ray, wo_hg),
            torch.where(is_ray, p_ray, p_hg))


def transmittance(meds: Mediums, bank, med_id, lam, dist):
    """Beer-Lambert transmittance over `dist` in medium `med_id`."""
    sigma_s, sigma_a, _ = medium_coefficients(meds, bank, med_id, lam)
    return torch.exp(-(sigma_s + sigma_a) * torch.clamp(dist, max=1e8))
