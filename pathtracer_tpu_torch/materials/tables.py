"""Material table (counterpart of `materials/tables.py`): SoA parameters
indexed by material id. The BSDF math itself lives in `kernels/cmath.py`
and the round kernels; the XLA-style masked dispatch is not ported."""

from __future__ import annotations

import dataclasses

import torch

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
