"""Scene geometry as structure-of-arrays (counterpart of `geometry/soa.py`).

Primitive encodings (pa/pb/pc are [P,3] payload slots):
  TRIANGLE: pa,pb,pc = world-space vertices; na,nb,nc = shading normals
  SPHERE:   pa = center, pb[0] = radius
  RECT:     pa = center, pb = half-edge u, pc = half-edge v
  DISK:     pa = center, pb = unit normal, pc[0] = radius

The port intersects only through the dense sweep (`kernels/dense.py`): on
a CUDA tensor `intersect_dense` / `intersect_any_dense` launch the
hand-written `dense_sweep_closest` / `dense_sweep_any` kernels
(`kernels/csrc/dense_sweep.cu`), which walk the compact sweep table of
`sweep_table`, on a CPU tensor their plain twins, which read the packed
table of `dense_table`; the closest hit is the minimum t, ties to the
minimum prim id, as the JAX sweep reduces its chunks. `_fill_attributes`
then recomputes the winning prim's hit attributes in torch. Only
identity-transform scenes are taken: the kernel has no per-prim transform,
and the BVH and two-level accelerators are still to be ported (ROADMAP §1
items 9 and 13).
`sample_surface` draws the light and NEE sample points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import vecmath
from pathtracer_tpu_torch.prelude import RAY_TMAX

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


class HitRecord(NamedTuple):
    """Wavefront hit record (the JAX package's `HitRecord`)."""

    t: torch.Tensor  # f32[N]
    point: torch.Tensor  # f32[N,3]
    normal: torch.Tensor  # f32[N,3] shading normal (unit)
    geo_normal: torch.Tensor  # f32[N,3]
    uv: torch.Tensor  # f32[N,2]
    material_id: torch.Tensor  # i32[N]
    mat_kind: torch.Tensor  # i32[N]
    instance_id: torch.Tensor  # i32[N]
    prim_id: torch.Tensor  # i32[N]
    hit: torch.Tensor  # bool[N]


# why a scene with per-prim transforms is refused
NO_TRANSFORMS = ("the port intersects identity-transform scenes only: the "
                 "dense sweep kernel has no per-prim transform, and the BVH "
                 "and two-level accelerators that take instanced scenes are "
                 "still to be ported (ROADMAP §1 items 9 and 13)")


def _packed(prims: Primitives, pack) -> torch.Tensor:
    cols = [prims.ptype, prims.valid, prims.pa, prims.pb, prims.pc]
    tab = pack(*[c.detach().cpu().numpy() for c in cols])
    return torch.as_tensor(tab, device=prims.pa.device)


def dense_table(prims: Primitives) -> torch.Tensor:
    """The packed `[P_pad, 128]` f32 table the dense sweep's twins read
    (`kernels/dense.pack_prims_np`), on the prims' device."""
    from pathtracer_tpu_torch.kernels.dense import pack_prims_np

    return _packed(prims, pack_prims_np)


def sweep_table(prims: Primitives) -> torch.Tensor:
    """The compact `[P_pad, 16]` f32 sweep table the dense sweep kernels
    walk (`kernels/dense.pack_sweep_np`, host numpy), on the prims'
    device."""
    from pathtracer_tpu_torch.kernels.dense import pack_sweep_np

    return _packed(prims, pack_sweep_np)


def _ray_rows(o, d, t_min, t_max):
    """The sweep's `[8, N]` ray rows: origin, direction, tmin, tmax. The
    kernel bounds-checks its lanes, so N needs no padding."""
    return torch.cat([o.T, d.T, t_min[None], t_max[None]]).float() \
        .contiguous()


def _check_query(prims, ignore_prim):
    if ignore_prim is not None:
        raise NotImplementedError("ignore_prim has no caller and is not "
                                  "ported")
    if prims.xf_inv.shape[0] != 1:
        raise NotImplementedError(NO_TRANSFORMS)


def _tables(prims, tab, sweep):
    """The packed table and the sweep table, packed here where the caller
    passed None."""
    return (dense_table(prims) if tab is None else tab,
            sweep_table(prims) if sweep is None else sweep)


def intersect_dense(prims: Primitives, o, d, t_min, t_max, ignore_prim=None,
                    tab=None, sweep=None) -> HitRecord:
    """The closest hit over every prim. o, d: f32[N,3]; t_min, t_max:
    f32[N]; `tab` the packed table of `dense_table(prims)` and `sweep` the
    sweep table of `sweep_table(prims)` (packed here when None: pass them
    to pack once per render)."""
    from pathtracer_tpu_torch.kernels.dense import sweep_closest

    _check_query(prims, ignore_prim)
    tab, sweep = _tables(prims, tab, sweep)
    res = sweep_closest(_ray_rows(o, d, t_min, t_max), tab, sweep)
    pid = res[1].long()
    hit = pid >= 0
    return _fill_attributes(prims, o, d, res[0], torch.clamp(pid, min=0), hit)


def intersect_any_dense(prims: Primitives, o, d, t_min, t_max,
                        ignore_prim=None, tab=None, sweep=None, live=None):
    """Occlusion: does any prim block (t_min, t_max)? -> bool[N]. `tab`
    and `sweep` as `intersect_dense`'s; with `live` (bool[N]) only the live
    lanes are swept and the others read False."""
    from pathtracer_tpu_torch.kernels.dense import sweep_any

    _check_query(prims, ignore_prim)
    tab, sweep = _tables(prims, tab, sweep)
    return sweep_any(_ray_rows(o, d, t_min, t_max), tab, sweep,
                     live)[0] > 0.5


def _fill_attributes(prims: Primitives, o, d, t, pid, hit) -> HitRecord:
    """The winning prim's hit attributes (identity transforms: the JAX
    `_fill_attributes` without its transform branch)."""
    pa, pb, pc = prims.pa[pid], prims.pb[pid], prims.pc[pid]
    na, nb, nc = prims.na[pid], prims.nb[pid], prims.nc[pid]
    ptype = prims.ptype[pid]
    p_l = o + t[..., None] * d

    # triangle: barycentrics of the hit, interpolated shading normal
    e1, e2 = pb - pa, pc - pa
    tri_gn = vecmath.normalize(vecmath.cross(e1, e2))
    pvec = vecmath.cross(d, e2)
    det = vecmath.dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - pa
    bu = vecmath.dot(tvec, pvec) * inv_det
    bv = vecmath.dot(d, vecmath.cross(tvec, e1)) * inv_det
    tri_sn = vecmath.normalize((1.0 - bu - bv)[..., None] * na
                               + bu[..., None] * nb + bv[..., None] * nc)
    tri_uv = torch.stack([bu, bv], dim=-1)

    sph_n = vecmath.normalize(p_l - pa)
    sph_u, sph_v = vecmath.direction_to_uv(sph_n)
    sph_uv = torch.stack([sph_u, sph_v], dim=-1)

    rect_n = vecmath.normalize(vecmath.cross(pb, pc))
    rel = p_l - pa
    rect_uv = torch.stack([
        0.5 * (vecmath.dot(rel, pb)
               / torch.clamp(vecmath.dot(pb, pb), min=1e-20) + 1.0),
        0.5 * (vecmath.dot(rel, pc)
               / torch.clamp(vecmath.dot(pc, pc), min=1e-20) + 1.0)], dim=-1)

    # a disk's uv is (0, 0), as the reference leaves it
    disk_n = pb
    zero_uv = torch.zeros_like(rect_uv)

    is_tri = (ptype == PRIM_TRIANGLE)[..., None]
    is_sph = (ptype == PRIM_SPHERE)[..., None]
    is_rec = (ptype == PRIM_RECT)[..., None]
    normal = torch.where(is_tri, tri_sn, torch.where(
        is_sph, sph_n, torch.where(is_rec, rect_n, disk_n)))
    geo_normal = torch.where(is_tri, tri_gn, torch.where(
        is_sph, sph_n, torch.where(is_rec, rect_n, disk_n)))
    uv = torch.where(is_tri, tri_uv, torch.where(
        is_sph, sph_uv, torch.where(is_rec, rect_uv, zero_uv)))
    miss = torch.full_like(pid, -1, dtype=torch.int32)
    return HitRecord(
        t=torch.where(hit, t, RAY_TMAX),
        point=p_l,
        normal=normal,
        geo_normal=geo_normal,
        uv=uv,
        material_id=torch.where(hit, prims.material_id[pid], miss),
        mat_kind=torch.where(hit, prims.mat_kind[pid], miss),
        instance_id=torch.where(hit, prims.instance_id[pid], miss),
        prim_id=torch.where(hit, pid.to(torch.int32), miss),
        hit=hit,
    )


def primitive_area(prims: Primitives, pid):
    return prims.area[pid.long()]


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
