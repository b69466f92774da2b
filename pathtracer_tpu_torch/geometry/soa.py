"""Scene geometry as structure-of-arrays (counterpart of `geometry/soa.py`).

Primitive encodings (pa/pb/pc are [P,3] payload slots):
  TRIANGLE: pa,pb,pc = world-space vertices; na,nb,nc = shading normals
  SPHERE:   pa = center, pb[0] = radius
  RECT:     pa = center, pb = half-edge u, pc = half-edge v
  DISK:     pa = center, pb = unit normal, pc[0] = radius

The port intersects only through the dense sweep (`kernels/dense.py`); the
BVH and two-level accelerators are still to be ported (ROADMAP).
`sample_surface` draws the light tracer's emission points.
"""

from __future__ import annotations

import dataclasses
import math

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


def sample_surface(prims: Primitives, pid, u1, u2):
    """A uniform-area sample on primitive `pid` (per lane) -> (point V3,
    unit normal V3, area pdf), for every prim type, through the prim's
    transform (the JAX package's `sample_surface`)."""
    from pathtracer_tpu_torch.kernels import cmath
    from pathtracer_tpu_torch.kernels.cmath import V3

    pid = pid.long()

    def v3(a):
        r = a[pid]
        return V3(r[:, 0], r[:, 1], r[:, 2])

    pa, pb, pc = v3(prims.pa), v3(prims.pb), v3(prims.pc)
    ptype = prims.ptype[pid]
    area = prims.area[pid]
    su = torch.sqrt(u1)
    tri_p = pa.scale(1.0 - su) + pb.scale(su * (1.0 - u2)) + pc.scale(su * u2)
    tri_n = cmath.normalize(cmath.cross(pb - pa, pc - pa))
    z = 1.0 - 2.0 * u1
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    sph_n = V3(r_xy * torch.cos(phi), r_xy * torch.sin(phi), z)
    sph_p = pa + sph_n.scale(pb.x)
    rec_p = pa + pb.scale(2.0 * u1 - 1.0) + pc.scale(2.0 * u2 - 1.0)
    rec_n = cmath.normalize(cmath.cross(pb, pc))
    rr = torch.sqrt(u1) * pc.x
    t_ax, b_ax = cmath.orthonormal_basis(pb)
    dsk_p = pa + t_ax.scale(rr * torch.cos(phi)) + b_ax.scale(rr * torch.sin(phi))
    is_tri, is_sph = ptype == PRIM_TRIANGLE, ptype == PRIM_SPHERE
    is_rec = ptype == PRIM_RECT
    p_l = cmath.where(is_tri, tri_p, cmath.where(
        is_sph, sph_p, cmath.where(is_rec, rec_p, dsk_p)))
    n_l = cmath.where(is_tri, tri_n, cmath.where(
        is_sph, sph_n, cmath.where(is_rec, rec_n, pb)))
    if prims.xf_fwd.shape[0] == 1:
        m_fwd = prims.xf_fwd[0][None].expand(pid.shape[0], 4, 4)
        m_inv = prims.xf_inv[0][None].expand(pid.shape[0], 4, 4)
    else:
        tid = prims.transform_id[pid].long()
        m_fwd, m_inv = prims.xf_fwd[tid], prims.xf_inv[tid]
    point = V3(*[m_fwd[:, i, 0] * p_l.x + m_fwd[:, i, 1] * p_l.y
                 + m_fwd[:, i, 2] * p_l.z + m_fwd[:, i, 3] for i in range(3)])
    normal = _normalize_v3(V3(*[m_inv[:, 0, i] * n_l.x + m_inv[:, 1, i] * n_l.y
                                + m_inv[:, 2, i] * n_l.z for i in range(3)]))
    return point, normal, 1.0 / torch.clamp(area, min=1e-20)


def _normalize_v3(a):
    """core/vecmath.normalize: a · sqrt(max(1 / max(|a|², 1e-20), 0))."""
    ls = a.x * a.x + a.y * a.y + a.z * a.z
    return a.scale(torch.sqrt(torch.clamp(1.0 / torch.clamp(ls, min=1e-20),
                                          min=0.0)))
