"""Scene geometry as structure-of-arrays (counterpart of `geometry/soa.py`).

Primitive encodings (pa/pb/pc are [P,3] payload slots):
  TRIANGLE: pa,pb,pc = world-space vertices; na,nb,nc = shading normals
  SPHERE:   pa = center, pb[0] = radius
  RECT:     pa = center, pb = half-edge u, pc = half-edge v
  DISK:     pa = center, pb = unit normal, pc[0] = radius

The port intersects only through the dense sweep (`kernels/dense.py`); the
BVH and two-level accelerators are still to be ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import torch

PRIM_TRIANGLE = 0
PRIM_SPHERE = 1
PRIM_RECT = 2
PRIM_DISK = 3


@dataclasses.dataclass
class Primitives:
    ptype: torch.Tensor  # i32[P]
    pa: torch.Tensor  # f32[P,3]
    pb: torch.Tensor  # f32[P,3]
    pc: torch.Tensor  # f32[P,3]
    na: torch.Tensor  # f32[P,3] triangle shading normals
    nb: torch.Tensor
    nc: torch.Tensor
    material_id: torch.Tensor  # i32[P]
    mat_kind: torch.Tensor  # i32[P] 0=Material 1=Light 2=Camera
    instance_id: torch.Tensor  # i32[P]
    transform_id: torch.Tensor  # i32[P]; 0 == identity
    area: torch.Tensor  # f32[P] world-space surface area
    valid: torch.Tensor  # bool[P] padding mask
    xf_fwd: torch.Tensor  # f32[T,4,4] local->world
    xf_inv: torch.Tensor  # f32[T,4,4] world->local

    @property
    def count(self):
        return self.ptype.shape[0]
