"""The regen path tracer's bounce round as one fused kernel (counterpart of
`pathtracer_tpu.kernels.megakernel`, restricted to its fused one-kernel
round).

One round takes every lane (one per pixel) one bounce further: closest hit,
emission and constant-environment adds with MIS, next-event estimation with
inline shadow sweeps, BSDF sampling with hero-wavelength spectral MIS,
Russian roulette, XYZ accumulation on death and a thin-lens respawn of the
lane's next camera sample. The lane state is `[NS=32, n_pad]` f32 rows
(`S_*` below); a round reads it and writes `[NK4=40, n_pad]`: the 32 new
state rows plus per-lane counter rows.

`fused_round` launches `csrc/fused_round.cu` on CUDA tensors and runs the
plain torch twin `fused_round_plain` on CPU tensors. The output is a second
buffer, not an in-place update, so the kernel and its twin can be run on the
same input. Random numbers come from outside the kernel: the render loop draws
one `[nu, n_pad]` uniform block per round (`nu_rows`) from a uniform source
(`TorchUniforms`, or a test's replay of the JAX draws).

Scope (`mega_available`): projective camera, identity transforms, at most
4 chunks of 32 prims, a constant environment, 1x1 textures, no media. Scenes
outside it raise `NotImplementedError` naming the ROADMAP item that ports
their route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from pathtracer_tpu_torch.core import cie
from pathtracer_tpu_torch.geometry.soa import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
)
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels.cmath import V3, fdiv
from pathtracer_tpu_torch.kernels.dense import (
    PBF,
    pack_prims_np,
    sweep_any_cols,
    sweep_closest_cols,
)
from pathtracer_tpu_torch.materials.tables import (
    MAT_DIFFUSE_LIGHT,
    MAT_GGX,
    MAT_LAMBERTIAN,
    MAT_PASSTHROUGH,
    MAT_SHARP_LIGHT,
)
from pathtracer_tpu_torch.prelude import (
    INTERSECTION_TIME_OFFSET,
    NORMAL_OFFSET,
    RAY_TMAX,
    TransportMode,
)
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.world.environment import ENV_CONSTANT

TILE = 4096  # lane padding unit: n_pad is a multiple of it
C_LANES = 4  # HWSS lanes
SPEC_RES = 512

# ---- state rows [NS, N]
S_O, S_D = 0, 3
S_LAM, S_BETA, S_RAD = 6, 10, 14
S_ACC = 18
S_DONE, S_ALIVE, S_BOUNCE, S_PREV_PDF = 21, 22, 23, 24
S_PIX = 25  # owning pixel index (f32, exact below 2^24)
S_PDFR = 26  # C_LANES rows: spectral-MIS pdf-ratio products (lane0 == 1)
NS = 32

# ---- round output rows: new state + per-lane counter indicators
O4_BOUNCE_CT = NS
O4_CAMERA_CT = NS + 1
O4_SHADOW_CT = NS + 2
O4_ENV_CT = NS + 3
NK4 = NS + 8

FUSED_MAX_CHUNKS = 4  # the fused round's gate: at most 4 chunks of 32 prims

# prim_tab rows (0..10 are the dense table's columns)
_R_NA, _R_NB, _R_NC = 11, 14, 17
_R_MAT, _R_KIND, _R_AREA = 20, 21, 22
_NP_ROWS = 24

# mat_tab rows
_M_TYPE, _M_ALPHA, _M_METAL, _M_PERM, _M_SIDE, _M_SHARP, _M_RSCALE = range(7)
_M_INNER, _M_OUTER = 8, 9
_NM_ROWS = 16

# light_tab rows
_L_PA, _L_PB, _L_PC = 0, 3, 6
_L_PTYPE, _L_AREA, _L_MAT, _L_MTYPE, _L_SIDE, _L_SHARP = 9, 10, 11, 12, 13, 14
_NL_ROWS = 16

# launches of the CUDA fused round, and calls of its plain twin
FUSED_LAUNCHES = 0
PLAIN_CALLS = 0

_OUT_OF_GATE = ("the fused round takes projective cameras, identity "
                "transforms, at most 4 chunks of 32 prims, a constant "
                "environment, 1x1 textures and no media; other scenes ride "
                "the two-program round (ROADMAP §2 item 4)")


def nu_rows(light_samples: int) -> int:
    """Uniform rows per round: 3 per NEE sample + 3 (BSDF) + 1 (RR) + 5
    (respawn), padded to a multiple of 8."""
    return -(-(3 * light_samples + 9) // 8) * 8


# ------------------------------------------------------------------ gate


def mega_available(world, camera, settings) -> bool:
    """Static scene/settings preconditions of the fused round."""
    return not settings.medium_aware and _scene_in_gate(world, camera)


def _scene_in_gate(world, camera) -> bool:
    from pathtracer_tpu_torch.camera.projective import ProjectiveCamera

    if not isinstance(camera, ProjectiveCamera):
        return False
    w = world
    if int(w.prims.xf_inv.shape[0]) != 1:
        return False
    if -(-w.prims.count // PBF) > FUSED_MAX_CHUNKS:
        return False
    if int(w.mats.count) > 24 or int(w.n_lights) > 16:
        return False
    if int(w.env.kind) != ENV_CONSTANT:
        return False
    t = w.tex
    if not (t.layer_count == 1).all():
        return False
    if not ((t.layer_w == 1).all() and (t.layer_h == 1).all()):
        return False
    return int(w.bank.values.shape[1]) == SPEC_RES


# ------------------------------------------------------------------ bake


@dataclasses.dataclass
class MegaScene:
    """Device tables + host constants of one (world, camera)."""

    prim_tab: torch.Tensor   # f32[24, P_pad128] per-prim attribute rows
    dense_tab: torch.Tensor  # f32[P_pad32, 128] packed sweep table
    mat_tab: torch.Tensor    # f32[16, 128]
    light_tab: torch.Tensor  # f32[16, 128]
    spec_tab: torch.Tensor   # f32[C8, 512] rows m*5+{ηi,ηo,κ,refl,emit}, env
    consts: dict             # host scalars (numbers and tuples)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def build_mega_scene(world, camera, device=None) -> MegaScene:
    """Host-side numpy bake of the fused round's tables, element for element
    the JAX package's `build_mega_scene` for scenes in the fused gate."""
    if not _scene_in_gate(world, camera):
        raise NotImplementedError(_OUT_OF_GATE)
    w = world
    device = device if device is not None else w.prims.pa.device
    prims = w.prims
    p = prims.count
    p_pad = -(-p // 128) * 128
    h = {name: _np(getattr(prims, name))
         for name in ("ptype", "valid", "pa", "pb", "pc", "na", "nb", "nc",
                      "material_id", "mat_kind", "area")}
    # sort prims by (type, Morton code of the centroid)
    cen = np.where((h["ptype"][:p] == 0)[:, None],
                   (h["pa"][:p] + h["pb"][:p] + h["pc"][:p]) / 3.0,
                   h["pa"][:p])
    lo_c = cen.min(axis=0)
    span_c = np.maximum(cen.max(axis=0) - lo_c, 1e-12)
    q = np.clip(((cen - lo_c) / span_c * 1023.0), 0, 1023).astype(np.uint64)

    def _spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    morton = (_spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1))
              | (_spread(q[:, 2]) << np.uint64(2)))
    order = np.lexsort((morton, h["ptype"][:p]))
    inv_order = np.empty(p, np.int64)
    inv_order[order] = np.arange(p)
    h = {k: v[order] for k, v in h.items()}
    tab = np.zeros((_NP_ROWS, p_pad), np.float32)
    tab[0, :p] = h["ptype"]
    tab[1, :p] = h["valid"]
    for i in range(3):
        tab[2 + i, :p] = h["pa"][:, i]
        tab[5 + i, :p] = h["pb"][:, i]
        tab[8 + i, :p] = h["pc"][:, i]
        tab[_R_NA + i, :p] = h["na"][:, i]
        tab[_R_NB + i, :p] = h["nb"][:, i]
        tab[_R_NC + i, :p] = h["nc"][:, i]
    tab[_R_MAT, :p] = h["material_id"]
    tab[_R_KIND, :p] = h["mat_kind"]
    tab[_R_AREA, :p] = h["area"]

    mats = w.mats
    m = int(mats.count)
    hm = {name: _np(getattr(mats, name))
          for name in ("mtype", "alpha", "metallic", "permeability",
                       "sidedness", "sharpness", "tex_id", "bounce_idx",
                       "eta_idx", "eta_o_idx", "kappa_idx", "emit_idx",
                       "inner_medium", "outer_medium")}
    mt = np.zeros((_NM_ROWS, 128), np.float32)
    mt[_M_TYPE, :m] = hm["mtype"]
    mt[_M_ALPHA, :m] = hm["alpha"]
    mt[_M_METAL, :m] = hm["metallic"].astype(np.float32)
    mt[_M_PERM, :m] = hm["permeability"]
    mt[_M_SIDE, :m] = hm["sidedness"]
    mt[_M_SHARP, :m] = hm["sharpness"]
    mt[_M_INNER, :m] = hm["inner_medium"]
    mt[_M_OUTER, :m] = hm["outer_medium"]
    # lambertian reflectance = 1x1 texel weight x layer curve; lights
    # reflect with their bounce curve at weight 1
    tex = w.tex
    layer_curve = _np(tex.layer_curve)
    layer_start = _np(tex.layer_start)
    atlas = _np(tex.atlas)
    layer_offset = _np(tex.layer_offset)
    mtype = hm["mtype"]
    tex_id = np.maximum(hm["tex_id"], 0)
    refl_curve = np.zeros(m, np.int64)
    refl_scale = np.ones(m, np.float32)
    for i in range(m):
        if mtype[i] == MAT_LAMBERTIAN:
            li = int(layer_start[int(tex_id[i])])
            refl_curve[i] = int(layer_curve[li])
            refl_scale[i] = float(atlas[int(layer_offset[li])])
        else:
            refl_curve[i] = int(hm["bounce_idx"][i])
    mt[_M_RSCALE, :m] = refl_scale

    # spectral rows: per material (eta_i, eta_o, kappa, refl, emit) + env
    bank_vals = _np(w.bank.values)
    c_rows = 5 * m + 1
    st = np.zeros((-(-c_rows // 8) * 8, SPEC_RES), np.float32)

    def curve(idx):
        return bank_vals[int(max(idx, 0))]

    for i in range(m):
        st[5 * i + 0] = curve(hm["eta_idx"][i])
        st[5 * i + 1] = curve(hm["eta_o_idx"][i])
        st[5 * i + 2] = curve(hm["kappa_idx"][i])
        st[5 * i + 3] = curve(refl_curve[i])
        st[5 * i + 4] = curve(hm["emit_idx"][i])
    st[5 * m] = curve(int(w.env.curve_idx)) * float(w.env.strength)

    lights = _np(w.lights)
    nl = int(w.n_lights)
    lt = np.zeros((_NL_ROWS, 128), np.float32)
    for l in range(nl):
        pid = int(inv_order[int(lights[l])])  # world ids are pre-sort
        for i in range(3):
            lt[_L_PA + i, l] = h["pa"][pid, i]
            lt[_L_PB + i, l] = h["pb"][pid, i]
            lt[_L_PC + i, l] = h["pc"][pid, i]
        lt[_L_PTYPE, l] = float(h["ptype"][pid])
        lt[_L_AREA, l] = float(h["area"][pid])
        mid = int(h["material_id"][pid])
        lt[_L_MAT, l] = mid
        lt[_L_MTYPE, l] = float(mtype[mid])
        lt[_L_SIDE, l] = float(hm["sidedness"][mid])
        lt[_L_SHARP, l] = float(hm["sharpness"][mid])

    rot_inv = _np(w.env.rotation_inv).astype(np.float32)
    rot_fwd = _np(w.env.rotation).astype(np.float32)
    p_env = float(np.clip(_np(w.env_sampling_probability), 0.0, 1.0))
    if nl == 0:
        p_env = 1.0  # no instance lights -> env-only NEE
    consts = dict(
        env_kind=int(w.env.kind),
        n_mats=m,
        n_lights=nl,
        p_env=p_env,
        has_ggx=bool((mtype == MAT_GGX).any()),
        has_metal=bool(hm["metallic"].any()),
        has_sharp=bool((mtype == MAT_SHARP_LIGHT).any()),
        env_rot=tuple(float(x) for x in rot_fwd.reshape(-1)),
        lam_lo=float(w.bank.lam_lo),
        lam_hi=float(w.bank.lam_hi),
        env_rot_inv=tuple(float(x) for x in rot_inv.reshape(-1)),
        cam_origin=tuple(float(x) for x in _np(camera.origin)),
        cam_w=tuple(float(x) for x in _np(camera.w)),
        cam_u=tuple(float(x) for x in _np(camera.u)),
        cam_v=tuple(float(x) for x in _np(camera.v)),
        cam_half_w=float(camera.half_width),
        cam_half_h=float(camera.half_height),
        cam_focal=float(camera.focal_distance),
        cam_lens_r=float(camera.lens_radius),
        cam_blades=int(camera.blades),
        cam_sharp=float(camera.blade_sharpness),
        radius=float(_np(w.radius)),
    )
    dense_tab = pack_prims_np(h["ptype"], h["valid"], h["pa"], h["pb"],
                              h["pc"])

    def dev(a):
        return torch.as_tensor(a, device=device)

    return MegaScene(prim_tab=dev(tab), dense_tab=dev(dense_tab),
                     mat_tab=dev(mt), light_tab=dev(lt), spec_tab=dev(st),
                     consts=consts)


# ------------------------------------------------------- round arguments


@dataclasses.dataclass(frozen=True)
class RoundArgs:
    """Scalars of one render's rounds: the scene constants and settings."""

    c_lanes: int
    light_samples: int
    n_mats: int
    n_lights: int
    p_env: float
    has_ggx: bool
    has_metal: bool
    has_sharp: bool
    lam_lo: float
    lam_hi: float
    env_rot: tuple
    env_rot_inv: tuple
    max_bounces: float
    min_bounces: float
    russian_roulette: bool
    only_direct: bool
    width: float
    height: float
    wb_lo: float
    wb_span: float
    cam_origin: tuple
    cam_u: tuple
    cam_v: tuple
    cam_w: tuple
    cam_half_w: float
    cam_half_h: float
    cam_focal: float
    cam_lens_r: float
    cam_blades: int
    cam_sharp: float

    @staticmethod
    def make(consts: dict, settings, width: int, height: int) -> "RoundArgs":
        wb = settings.wavelength_bounds
        c = consts
        return RoundArgs(
            c_lanes=C_LANES if settings.hwss else 1,
            light_samples=int(settings.light_samples),
            n_mats=c["n_mats"], n_lights=c["n_lights"], p_env=c["p_env"],
            has_ggx=c["has_ggx"], has_metal=c["has_metal"],
            has_sharp=c["has_sharp"], lam_lo=c["lam_lo"],
            lam_hi=c["lam_hi"], env_rot=c["env_rot"],
            env_rot_inv=c["env_rot_inv"],
            max_bounces=float(settings.max_bounces),
            min_bounces=float(settings.min_bounces),
            russian_roulette=bool(settings.russian_roulette),
            only_direct=bool(settings.only_direct),
            width=float(width), height=float(height),
            wb_lo=float(wb.lower), wb_span=float(wb.span),
            cam_origin=c["cam_origin"], cam_u=c["cam_u"], cam_v=c["cam_v"],
            cam_w=c["cam_w"], cam_half_w=c["cam_half_w"],
            cam_half_h=c["cam_half_h"], cam_focal=c["cam_focal"],
            cam_lens_r=c["cam_lens_r"], cam_blades=c["cam_blades"],
            cam_sharp=c["cam_sharp"])


class _CArgs(ctypes.Structure):
    """`struct RoundArgs` of csrc/fused_round.cu (all fields 4 bytes).
    Constants that the reference forms in double precision on the host and
    rounds once to f32 are precomputed here the same way."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "c_lanes", "light_samples", "n_mats", "n_lights", "has_ggx",
        "has_metal", "has_sharp", "rr_enabled", "only_direct", "cam_blades")
    ] + [(n, ctypes.c_float) for n in (
        "p_env", "p_env_div", "q_env_div", "pick_pdf", "sa_scale", "n_lights_f",
        "inv_ls", "lam_lo", "lam_span", "env_rz0", "env_rz1", "env_rz2")
    ] + [("env_rot_inv", ctypes.c_float * 9)] + [(n, ctypes.c_float) for n in (
        "max_bounces", "min_bounces", "width", "height", "wb_lo", "wb_span",
        "xyz_scale")
    ] + [(n, ctypes.c_float * 3) for n in (
        "cam_origin", "cam_u", "cam_v", "cam_fw")
    ] + [(n, ctypes.c_float) for n in (
        "cam_half_w", "cam_half_h", "cam_lens_r", "cam_sharp", "cam_seg",
        "cam_half_seg", "cam_cos_pi_bl")]


def _c_args(a: RoundArgs) -> _CArgs:
    s = _CArgs()
    nl1 = max(a.n_lights, 1)
    for name in ("c_lanes", "light_samples", "n_mats", "n_lights",
                 "cam_blades"):
        setattr(s, name, int(getattr(a, name)))
    s.has_ggx, s.has_metal, s.has_sharp = a.has_ggx, a.has_metal, a.has_sharp
    s.rr_enabled, s.only_direct = a.russian_roulette, a.only_direct
    s.p_env = a.p_env
    s.p_env_div = max(a.p_env, 1e-12)
    s.q_env_div = max(1.0 - a.p_env, 1e-12)
    s.pick_pdf = (1.0 - a.p_env) / float(nl1)
    s.sa_scale = (1.0 - a.p_env) * (1.0 / float(nl1))
    s.n_lights_f = float(nl1)
    s.inv_ls = 1.0 / a.light_samples if a.light_samples else 0.0
    s.lam_lo = a.lam_lo
    s.lam_span = a.lam_hi - a.lam_lo
    s.env_rz0, s.env_rz1, s.env_rz2 = a.env_rot[6:9]
    s.env_rot_inv[:] = list(a.env_rot_inv)
    for name in ("max_bounces", "min_bounces", "width", "height", "wb_lo",
                 "wb_span"):
        setattr(s, name, getattr(a, name))
    s.xyz_scale = a.wb_span / a.c_lanes
    s.cam_origin[:] = list(a.cam_origin)
    s.cam_u[:] = list(a.cam_u)
    s.cam_v[:] = list(a.cam_v)
    s.cam_fw[:] = [a.cam_focal * x for x in a.cam_w]
    s.cam_half_w, s.cam_half_h = a.cam_half_w, a.cam_half_h
    s.cam_lens_r = a.cam_lens_r
    s.cam_sharp = min(max(a.cam_sharp, 0.0), 1.0)
    bl = float(max(a.cam_blades, 3))
    s.cam_seg = 2.0 * math.pi / bl
    s.cam_half_seg = (2.0 * math.pi / bl) / 2.0
    s.cam_cos_pi_bl = float(np.cos(np.float32(math.pi / bl)))
    return s


# ------------------------------------------------------- plain fused round


def _balance(a, b):
    s = a + b
    return torch.where(s > 0.0, a / torch.where(s > 0.0, s, 1.0), 1.0)


def _emission_value(spd, mtype, side, sharp, cos_theta, has_sharp):
    """Diffuse and sharp light emission (sidedness-gated)."""
    fwd = (cos_theta > 0.0).float()
    rev = (cos_theta < 0.0).float()
    dual = (cos_theta != 0.0).float()
    gate = torch.where(side == 2, dual, torch.where(side == 0, fwd, rev))
    e_diff = fdiv(spd, math.pi) * gate
    if has_sharp:
        n = sharp
        e_sharp = fdiv(spd * (n + 1.0) * torch.abs(cos_theta) ** n,
                       2.0 * math.pi) * gate
        e = torch.where(mtype == MAT_SHARP_LIGHT, e_sharp, e_diff)
    else:
        e = e_diff
    is_light = (mtype == MAT_DIFFUSE_LIGHT) | (mtype == MAT_SHARP_LIGHT)
    return torch.where(is_light, e, 0.0)


def _bsdf_eval_lanes(mtype, alpha, metallic, perm, eta_i, eta_o, kappa,
                     refl, wi, wo, has_ggx, has_metal):
    """BSDF eval for C spectral lanes sharing (wi, wo) -> ([f], [pdf])."""
    C = len(refl)
    if has_ggx:
        a = torch.clamp(alpha, min=1e-4)
        lanes = [(torch.clamp(eta_i[ci], min=1e-3),
                  torch.clamp(eta_o[ci], min=1e-3), kappa[ci])
                 for ci in range(C)]
        ggx = cmath.eval_ggx_lanes(a, metallic > 0.5, perm, wi, wo,
                                   TransportMode.Radiance, lanes,
                                   has_metal=has_metal)
        is_ggx = mtype == MAT_GGX
    dead = mtype == MAT_PASSTHROUGH
    fs, pdfs = [], []
    for ci in range(C):
        f, pdf = cmath.eval_lambertian(refl[ci], wi, wo)
        if has_ggx:
            f = torch.where(is_ggx, ggx[ci][0], f)
            pdf = torch.where(is_ggx, ggx[ci][1], pdf)
        fs.append(torch.where(dead, 0.0, f))
        pdfs.append(torch.where(dead, 0.0, pdf))
    return fs, pdfs


def _sample_surface_light(lp_type, pa, pb, pc, u1, u2):
    """A point and normal on a light prim (identity transforms)."""
    su = torch.sqrt(u1)
    w0 = 1.0 - su
    w1 = su * (1.0 - u2)
    w2 = su * u2
    tri_p = pa.scale(w0) + pb.scale(w1) + pc.scale(w2)
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
    dsk_p = (pa + t_ax.scale(rr * torch.cos(phi))
             + b_ax.scale(rr * torch.sin(phi)))
    dsk_n = pb
    is_tri = lp_type == PRIM_TRIANGLE
    is_sph = lp_type == PRIM_SPHERE
    is_rec = lp_type == PRIM_RECT
    p = cmath.where(is_tri, tri_p, cmath.where(
        is_sph, sph_p, cmath.where(is_rec, rec_p, dsk_p)))
    nrm = cmath.where(is_tri, tri_n, cmath.where(
        is_sph, sph_n, cmath.where(is_rec, rec_n, dsk_n)))
    return p, nrm


def _hit_attributes(attr, o, d, t):
    """Point, shading normal, geometric normal, material id, kind and area
    of the hit prim (identity transforms). attr: [24, N] prim_tab columns."""
    pa = V3(attr[2], attr[3], attr[4])
    pb = V3(attr[5], attr[6], attr[7])
    pc = V3(attr[8], attr[9], attr[10])
    na = V3(*attr[_R_NA:_R_NA + 3])
    nb = V3(*attr[_R_NB:_R_NB + 3])
    nc = V3(*attr[_R_NC:_R_NC + 3])
    ptype = attr[0]
    point = o + d.scale(t)
    e1 = pb - pa
    e2 = pc - pa
    tri_gn = cmath.normalize(cmath.cross(e1, e2))
    pvec = cmath.cross(d, e2)
    det = cmath.dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12,
                          1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tvec = o - pa
    bu = cmath.dot(tvec, pvec) * inv_det
    bv = cmath.dot(d, cmath.cross(tvec, e1)) * inv_det
    tri_sn = cmath.normalize(na.scale(1.0 - bu - bv) + nb.scale(bu)
                             + nc.scale(bv))
    sph_n = cmath.normalize(point - pa)
    rect_n = cmath.normalize(cmath.cross(pb, pc))
    disk_n = pb
    is_tri = ptype == PRIM_TRIANGLE
    is_sph = ptype == PRIM_SPHERE
    is_rec = ptype == PRIM_RECT
    normal = cmath.where(is_tri, tri_sn, cmath.where(
        is_sph, sph_n, cmath.where(is_rec, rect_n, disk_n)))
    gn = cmath.where(is_tri, tri_gn, cmath.where(
        is_sph, sph_n, cmath.where(is_rec, rect_n, disk_n)))
    return point, normal, gn, attr[_R_MAT], attr[_R_KIND], attr[_R_AREA]


def _spectral_rows(spec_tab, lam, lam_lo, lam_hi):
    """λ -> a function row(r) giving curve row r (int or per-lane f32 ids)
    lerped at each lane's λ, with u clipped to [0, RES-1-1e-4]."""
    u = fdiv(lam - lam_lo, lam_hi - lam_lo) * (SPEC_RES - 1)
    u = torch.clamp(u, 0.0, SPEC_RES - 1 - 1e-4)
    i0 = torch.floor(u)
    frac = u - i0
    i0 = i0.long()
    flat = spec_tab.reshape(-1)

    def row(r):
        base = (r.long() if isinstance(r, torch.Tensor) else r) * SPEC_RES
        return flat[base + i0] * (1.0 - frac) + flat[base + i0 + 1] * frac

    return row


def fused_round_plain(u, state, dense_tab, prim_tab, mat_tab, light_tab,
                      spec_tab, a: RoundArgs):
    """One bounce round in plain torch -> out [NK4, N] (see module doc)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    ls = a.light_samples
    C = a.c_lanes
    nee_enabled = ls > 0
    p_env = a.p_env
    n_mats = a.n_mats
    n_lights = a.n_lights
    dev = state.device

    def s(i):
        return state[i]

    o = V3(s(S_O), s(S_O + 1), s(S_O + 2))
    d = V3(s(S_D), s(S_D + 1), s(S_D + 2))
    lam = [s(S_LAM + i) for i in range(C)]
    beta = [s(S_BETA + i) for i in range(C)]
    rad = [s(S_RAD + i) for i in range(C)]
    acc = [s(S_ACC + i) for i in range(3)]
    done = s(S_DONE)
    alive = s(S_ALIVE) > 0.5
    bounce_ct = s(S_BOUNCE)
    prev_pdf = s(S_PREV_PDF)
    ones = torch.ones_like(done)
    # hero-wavelength spectral MIS weight
    if C > 1:
        sum_pdfr = s(S_PDFR + 0)
        for ci in range(1, C):
            sum_pdfr = sum_pdfr + s(S_PDFR + ci)
        s_mis = C / torch.clamp(sum_pdfr, min=1e-30)
    else:
        s_mis = ones

    def mat(row, mid):
        return mat_tab[row][mid.long()]

    # ---- closest hit straight off the live ray state
    col = lambda x: x[:, None]  # noqa: E731
    t_min = torch.full_like(done, INTERSECTION_TIME_OFFSET)
    t_hit, pid = sweep_closest_cols(
        dense_tab, col(o.x), col(o.y), col(o.z), col(d.x), col(d.y),
        col(d.z), col(t_min), col(torch.full_like(done, RAY_TMAX)))
    hit = pid >= 0.0
    pid_c = torch.clamp(pid, min=0.0)
    attr = prim_tab[:, pid_c.long()]
    point, normal, gn, mat_id, kind, area = _hit_attributes(attr, o, d, t_hit)
    at_surface = alive & hit & (kind != 2.0)

    R = [_spectral_rows(spec_tab, lam[ci], a.lam_lo, a.lam_hi)
         for ci in range(C)]

    env_row = 5 * n_mats
    escaped = alive & ~hit
    if nee_enabled and p_env > 0.0:
        er = a.env_rot
        dz = er[6] * d.x + er[7] * d.y + er[8] * d.z
        # sqrt identity instead of arccos: sin(acos(z)) = sqrt(1 - z^2)
        jac = (2.0 * math.pi * math.pi
               * torch.sqrt(torch.clamp(1.0 - dz * dz, min=0.0)) + 0.001)
        env_nee_pdf = (1.0 / jac) * p_env
        use_mis_env = (bounce_ct > 0.5) & (env_nee_pdf + prev_pdf > 0.0)
        w_env = torch.where(use_mis_env,
                            _balance(prev_pdf, torch.clamp(env_nee_pdf,
                                                           min=0.0)), 1.0)
    else:
        w_env = ones
    for ci in range(C):
        env_e = R[ci](env_row)
        rad[ci] = rad[ci] + torch.where(escaped,
                                        beta[ci] * s_mis * env_e * w_env, 0.0)
    env_ct = escaped.float()

    wi_world = -d
    cos_at_light = cmath.dot(gn, wi_world)
    side = mat(_M_SIDE, mat_id)
    sharp = mat(_M_SHARP, mat_id)
    mtype = mat(_M_TYPE, mat_id)
    if n_lights > 0:
        pick_pdf = (1.0 - p_env) / float(max(n_lights, 1))
        hyp = pick_pdf * t_hit * t_hit / torch.clamp(
            torch.abs(cos_at_light) * area, min=1e-30)
        hyp = torch.where(torch.abs(cos_at_light) * area > 0.0, hyp, 0.0)
        use_mis_l = (bounce_ct > 0.5) & nee_enabled
        w_light = torch.where(use_mis_l & (prev_pdf + hyp > 0.0),
                              _balance(prev_pdf, torch.clamp(hyp, min=0.0)),
                              1.0)
        is_light_hit = at_surface & (kind == 1.0)
        for ci in range(C):
            spd = R[ci](5.0 * mat_id + 4.0)
            le = _emission_value(spd, mtype, side, sharp, cos_at_light,
                                 a.has_sharp)
            rad[ci] = rad[ci] + torch.where(
                is_light_hit, beta[ci] * s_mis * le * w_light, 0.0)

    tgt, btg = cmath.orthonormal_basis(normal)
    wi_local = cmath.to_local(tgt, btg, normal, wi_world)

    alpha = mat(_M_ALPHA, mat_id)
    metal = mat(_M_METAL, mat_id)
    perm = mat(_M_PERM, mat_id)
    rscale = mat(_M_RSCALE, mat_id)
    eta_i = [R[ci](5.0 * mat_id + 0.0) for ci in range(C)]
    eta_o = [R[ci](5.0 * mat_id + 1.0) for ci in range(C)]
    kappa = [R[ci](5.0 * mat_id + 2.0) for ci in range(C)]
    refl = [rscale * R[ci](5.0 * mat_id + 3.0) for ci in range(C)]

    shadow_ct = torch.zeros_like(done)

    # ---- NEE with immediate shadow resolution
    if nee_enabled:
        inv_ls = 1.0 / ls
        nl1 = max(n_lights, 1)
        for si in range(ls):
            u_pick, u1, u2 = u[3 * si], u[3 * si + 1], u[3 * si + 2]
            if p_env > 0.0:
                chose_env = u_pick < p_env
                u_pick2 = torch.where(
                    chose_env, fdiv(u_pick, max(p_env, 1e-12)),
                    fdiv(u_pick - p_env, max(1.0 - p_env, 1e-12)))
                u_pick2 = torch.clamp(u_pick2, 0.0, 1.0 - 1e-7)
            else:
                chose_env = torch.zeros_like(alive)
                u_pick2 = u_pick
            li = torch.clamp(torch.floor(u_pick2 * nl1), max=float(nl1 - 1))
            li_idx = li.long()

            def lrow(row):
                return light_tab[row][li_idx]

            lpa = V3(lrow(_L_PA), lrow(_L_PA + 1), lrow(_L_PA + 2))
            lpb = V3(lrow(_L_PB), lrow(_L_PB + 1), lrow(_L_PB + 2))
            lpc = V3(lrow(_L_PC), lrow(_L_PC + 1), lrow(_L_PC + 2))
            lp, ln = _sample_surface_light(lrow(_L_PTYPE), lpa, lpb, lpc,
                                           u1, u2)
            area_pdf = 1.0 / torch.clamp(lrow(_L_AREA), min=1e-20)
            to_l = lp - point
            dist2 = torch.clamp(cmath.length_squared(to_l), min=1e-12)
            dist = torch.sqrt(dist2)
            dir_l = to_l.scale(1.0 / dist)
            cos_l = cmath.dot(ln, -dir_l)
            lp_pdf = 1.0 / float(nl1)
            sa_pdf_light = (1.0 - p_env) * lp_pdf * area_pdf * torch.where(
                torch.abs(cos_l) > 0.0,
                dist2 / torch.clamp(torch.abs(cos_l), min=1e-30), 0.0)
            if p_env > 0.0:
                env_d_uv = cmath.uv_to_direction(u1, u2)
                ri = a.env_rot_inv
                env_dir = V3(
                    ri[0] * env_d_uv.x + ri[1] * env_d_uv.y + ri[2] * env_d_uv.z,
                    ri[3] * env_d_uv.x + ri[4] * env_d_uv.y + ri[5] * env_d_uv.z,
                    ri[6] * env_d_uv.x + ri[7] * env_d_uv.y + ri[8] * env_d_uv.z,
                )
                jac_s = (2.0 * math.pi * math.pi * torch.sin(math.pi * u2)
                         + 0.001)
                sa_pdf_env = (1.0 / jac_s) * p_env
                nee_dir = cmath.where(chose_env, env_dir, dir_l)
                nee_pdf = torch.where(chose_env, sa_pdf_env, sa_pdf_light)
                nee_tmax = torch.where(chose_env, RAY_TMAX, dist * 0.99)
            else:
                nee_dir = dir_l
                nee_pdf = sa_pdf_light
                nee_tmax = dist * 0.99
            wo_local = cmath.to_local(tgt, btg, normal, nee_dir)
            max_le = torch.zeros_like(done)
            max_thr = torch.zeros_like(done)
            contribs = []
            nee_fs, nee_pdfs = _bsdf_eval_lanes(
                mtype, alpha, metal, perm, eta_i, eta_o, kappa, refl,
                wi_local, wo_local, a.has_ggx, a.has_metal)
            l_mat = lrow(_L_MAT)
            for ci in range(C):
                spd_l = R[ci](5.0 * l_mat + 4.0)
                le_inst = _emission_value(spd_l, lrow(_L_MTYPE),
                                          lrow(_L_SIDE), lrow(_L_SHARP),
                                          cos_l, a.has_sharp)
                if p_env > 0.0:
                    le_ci = torch.where(chose_env, R[ci](env_row), le_inst)
                else:
                    le_ci = le_inst
                thr_ci = nee_fs[ci] * torch.abs(wo_local.z)
                max_le = torch.maximum(max_le, le_ci)
                max_thr = torch.maximum(max_thr, thr_ci)
                contribs.append((thr_ci, le_ci))
            worth = (at_surface & (max_le > 0.0) & (nee_pdf > 1e-12)
                     & (max_thr > 0.0))
            w_nee = _balance(nee_pdf, torch.clamp(nee_pdfs[0], min=0.0))
            so = point + gn.scale(NORMAL_OFFSET * torch.sign(
                cmath.dot(gn, nee_dir) + 1e-9))
            blocked = sweep_any_cols(
                dense_tab, col(so.x), col(so.y), col(so.z), col(nee_dir.x),
                col(nee_dir.y), col(nee_dir.z), col(t_min), col(nee_tmax))
            ok = worth & ~blocked
            inv_pdf = torch.where(nee_pdf > 1e-12,
                                  1.0 / torch.clamp(nee_pdf, min=1e-12), 0.0)
            for ci in range(C):
                thr_ci, le_ci = contribs[ci]
                contrib = (beta[ci] * s_mis * thr_ci * le_ci
                           * w_nee * inv_pdf * inv_ls)
                rad[ci] = rad[ci] + torch.where(ok, contrib, 0.0)
            shadow_ct = shadow_ct + (at_surface & worth).float()

    # ---- BSDF sample + HWSS ratios
    u_b = [u[3 * ls + i] for i in range(3)]
    wo_lam_s, f_lam_s, pdf_lam_s = cmath.sample_lambertian(
        refl[0], wi_local, u_b[0], u_b[1])
    w_lam_s = torch.clamp(refl[0], max=1.0)
    if a.has_ggx:
        wo_ggx_s, f_ggx_s, pdf_ggx_s, w_ggx_s = cmath.sample_ggx(
            torch.clamp(alpha, min=1e-4), torch.clamp(eta_i[0], min=1e-3),
            torch.clamp(eta_o[0], min=1e-3), kappa[0], metal > 0.5, perm,
            wi_local, u_b[0], u_b[1], u_b[2], TransportMode.Radiance,
            has_metal=a.has_metal)
        is_ggx = mtype == MAT_GGX
        wo_local_s = cmath.where(is_ggx, wo_ggx_s, wo_lam_s)
        f_pdf = torch.where(is_ggx, pdf_ggx_s, pdf_lam_s)
        ratio_hero = torch.where(is_ggx, w_ggx_s, w_lam_s)
    else:
        wo_local_s = wo_lam_s
        f_pdf = pdf_lam_s
        ratio_hero = w_lam_s
    is_pass = mtype == float(MAT_PASSTHROUGH)
    f_pdf = torch.where(is_pass, 0.0, f_pdf)
    ratio_hero = torch.where(is_pass, 0.0, ratio_hero)

    f_lanes, p_lanes = _bsdf_eval_lanes(
        mtype, alpha, metal, perm, eta_i, eta_o, kappa, refl,
        wi_local, wo_local_s, a.has_ggx, a.has_metal)
    hero_f = f_lanes[0]
    hero_dead = (hero_f <= 0.0) & (f_pdf > 1e-12)
    inv_hero = torch.where(hero_f > 0.0,
                           1.0 / torch.where(hero_f > 0.0, hero_f, 1.0), 0.0)
    inv_fpdf = torch.where(f_pdf > 1e-12,
                           1.0 / torch.clamp(f_pdf, min=1e-12), 0.0)
    ratios = [ratio_hero]
    for ci in range(1, C):
        stable = ratio_hero * f_lanes[ci] * inv_hero
        direct = f_lanes[ci] * torch.abs(wo_local_s.z) * inv_fpdf
        ratios.append(torch.where(hero_dead, direct, stable))
    sample_ok = f_pdf > 1e-12

    d_new = cmath.normalize(cmath.to_world(tgt, btg, normal, wo_local_s))
    o_new = point + gn.scale(NORMAL_OFFSET * torch.sign(cmath.dot(gn, d_new)))
    inv_p0 = torch.where(p_lanes[0] > 0.0,
                         1.0 / torch.where(p_lanes[0] > 0.0, p_lanes[0], 1.0),
                         0.0)
    pscale = [ones if ci == 0 else p_lanes[ci] * inv_p0 for ci in range(C)]

    # ---- RR + continuation
    ratio_best = ratios[0]
    for ci in range(1, C):
        ratio_best = torch.maximum(ratio_best, ratios[ci])
    sample_ok = sample_ok & (ratio_best > 0.0)
    if a.russian_roulette:
        rr_on = bounce_ct >= a.min_bounces
        p_cont = torch.where(rr_on, torch.clamp(ratio_best, 0.05, 1.0), 1.0)
    else:
        p_cont = ones
    u_rr = u[3 * ls + 3]
    survive = u_rr < p_cont
    inv_pc = 1.0 / torch.clamp(p_cont, min=1e-6)
    beta_next = []
    finite_ok = torch.ones_like(alive)
    for ci in range(C):
        bn = beta[ci] * torch.where(sample_ok, ratios[ci] * inv_pc, 0.0)
        beta_next.append(bn)
        finite_ok = finite_ok & torch.isfinite(bn)
    hit_depth_cap = (bounce_ct + 1.0) >= a.max_bounces
    continue_path = at_surface & sample_ok & survive & ~hit_depth_cap \
        & finite_ok
    if a.only_direct:
        continue_path = continue_path & ~(bounce_ct >= 1.0)
    bounce_ind = continue_path.float()

    # ---- death -> XYZ accumulate
    died = alive & ~continue_path
    xyz = [torch.zeros_like(done) for _ in range(3)]
    for ci in range(C):
        e = rad[ci] * (a.wb_span / C)
        xyz[0] = xyz[0] + e * cie.x_bar(lam[ci])
        xyz[1] = xyz[1] + e * cie.y_bar(lam[ci])
        xyz[2] = xyz[2] + e * cie.z_bar(lam[ci])
    for i in range(3):
        acc[i] = acc[i] + torch.where(died, xyz[i], 0.0)
    # S_DONE counts the samples LEFT (spp at spawn)
    done = done - died.float()
    has_work = died & (done > 0.5)
    camera_ind = has_work.float()

    # ---- respawn: thin-lens camera ray at the lane's owning pixel
    rnd = [u[3 * ls + 4 + i] for i in range(5)]
    pix = s(S_PIX)
    py = torch.floor(fdiv(pix, a.width))
    px = pix - py * a.width
    film_u = fdiv(px + rnd[0], a.width)
    film_v = fdiv(py + rnd[1], a.height)
    r_d = torch.sqrt(rnd[2])
    phi_d = 2.0 * math.pi * rnd[3]
    dx_l = r_d * torch.cos(phi_d)
    dy_l = r_d * torch.sin(phi_d)
    if a.cam_blades >= 3:
        bl = float(max(a.cam_blades, 3))
        phi_a = torch.atan2(dy_l, dx_l)
        seg = 2.0 * math.pi / bl
        a_ = torch.remainder(phi_a, seg) - seg / 2.0
        poly = torch.cos(torch.tensor(math.pi / bl, device=dev)) \
            / torch.cos(a_)
        t_ = min(max(a.cam_sharp, 0.0), 1.0)
        r_scale = (1.0 - t_) + t_ * poly
    else:
        r_scale = 1.0
    lx = dx_l * r_scale * a.cam_lens_r
    ly = dy_l * r_scale * a.cam_lens_r
    co = V3(*[torch.full_like(done, a.cam_origin[i]) for i in range(3)])
    cu, cv, cw = a.cam_u, a.cam_v, a.cam_w
    o_s = V3(co.x + lx * cu[0] + ly * cv[0],
             co.y + lx * cu[1] + ly * cv[1],
             co.z + lx * cu[2] + ly * cv[2])
    fpx = (film_u * 2.0 - 1.0) * a.cam_half_w
    fpy = (1.0 - film_v * 2.0) * a.cam_half_h
    focal = V3(co.x + a.cam_focal * cw[0] + fpx * cu[0] + fpy * cv[0],
               co.y + a.cam_focal * cw[1] + fpx * cu[1] + fpy * cv[1],
               co.z + a.cam_focal * cw[2] + fpx * cu[2] + fpy * cv[2])
    d_s = cmath.normalize(focal - o_s)
    lam_s = [a.wb_lo + torch.remainder(rnd[4] + ci / C, 1.0) * a.wb_span
             for ci in range(C)]

    # ---- merge + write-out
    cp = continue_path
    hw = has_work
    out = torch.empty((NK4, state.shape[1]), dtype=torch.float32, device=dev)
    o_out = cmath.where(cp, o_new, cmath.where(hw, o_s, o))
    d_out = cmath.where(cp, d_new, cmath.where(hw, d_s, d))
    out[S_O:S_O + 3] = torch.stack(list(o_out))
    out[S_D:S_D + 3] = torch.stack(list(d_out))
    out[S_LAM:S_LAM + C_LANES] = state[S_LAM:S_LAM + C_LANES]
    out[S_BETA:S_BETA + C_LANES] = state[S_BETA:S_BETA + C_LANES]
    out[S_RAD:S_RAD + C_LANES] = state[S_RAD:S_RAD + C_LANES]
    for ci in range(C):
        out[S_LAM + ci] = torch.where(hw, lam_s[ci], lam[ci])
        out[S_BETA + ci] = torch.where(cp, beta_next[ci],
                                       torch.where(hw, 1.0, beta[ci]))
        out[S_RAD + ci] = torch.where(died, 0.0, rad[ci])
    for i in range(3):
        out[S_ACC + i] = acc[i]
    out[S_DONE] = done
    out[S_ALIVE] = (cp | hw).float()
    out[S_BOUNCE] = torch.where(cp, bounce_ct + 1.0,
                                torch.where(hw, 0.0, bounce_ct))
    out[S_PREV_PDF] = torch.where(cp, f_pdf, torch.where(hw, 0.0, prev_pdf))
    out[S_PREV_PDF + 1:NS] = state[S_PREV_PDF + 1:NS]
    # spectral-MIS pdf-ratio products: times this bounce's ratios on
    # continuation, reset on respawn
    for ci in range(C):
        out[S_PDFR + ci] = torch.where(
            cp, s(S_PDFR + ci) * pscale[ci],
            torch.where(hw, 1.0, s(S_PDFR + ci)))
    out[O4_BOUNCE_CT] = bounce_ind
    out[O4_CAMERA_CT] = camera_ind
    out[O4_SHADOW_CT] = shadow_ct
    out[O4_ENV_CT] = env_ct
    out[O4_ENV_CT + 1:NK4] = 0.0
    return out


# ----------------------------------------------------------- CUDA wrapper


def _check_round(u, state, tabs, a: RoundArgs):
    n = state.shape[1]
    for name, x in (("u", u), ("state", state), *tabs.items()):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if x.device != state.device:
            raise ValueError(f"{name} is on {x.device}, state on "
                             f"{state.device}")
    if state.shape[0] != NS:
        raise ValueError(f"state must be [{NS}, N], got {tuple(state.shape)}")
    if u.shape[1] != n or u.shape[0] < 3 * a.light_samples + 9:
        raise ValueError(f"u must be [>= {3 * a.light_samples + 9}, {n}], "
                         f"got {tuple(u.shape)}")
    if a.c_lanes not in (1, C_LANES):
        raise ValueError(f"c_lanes must be 1 or {C_LANES}")
    dense = tabs["dense_tab"]
    if dense.shape[1] != 128 or dense.shape[0] > PBF * FUSED_MAX_CHUNKS \
            or dense.shape[0] % PBF:
        raise NotImplementedError(_OUT_OF_GATE)
    if tabs["prim_tab"].shape[0] != _NP_ROWS \
            or tabs["mat_tab"].shape != (_NM_ROWS, 128) \
            or tabs["light_tab"].shape != (_NL_ROWS, 128) \
            or tabs["spec_tab"].shape[1] != SPEC_RES \
            or tabs["spec_tab"].shape[0] < 5 * a.n_mats + 1:
        raise ValueError("table shapes do not match the bake")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")


def fused_round(u, state, scene: MegaScene, a: RoundArgs):
    """One bounce round -> out [NK4, N]: the CUDA kernel on CUDA tensors,
    the plain twin on CPU tensors."""
    global FUSED_LAUNCHES
    tabs = dict(dense_tab=scene.dense_tab, prim_tab=scene.prim_tab,
                mat_tab=scene.mat_tab, light_tab=scene.light_tab,
                spec_tab=scene.spec_tab)
    _check_round(u, state, tabs, a)
    if state.device.type == "cpu":
        return fused_round_plain(u, state, a=a, **tabs)
    from pathtracer_tpu_torch.kernels import _build

    lib = _build.library()
    if lib.fused_round_args_size() != ctypes.sizeof(_CArgs):
        raise RuntimeError("_CArgs does not mirror struct RoundArgs of "
                           "csrc/fused_round.cu")
    n = state.shape[1]
    out = torch.empty((NK4, n), dtype=torch.float32, device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    rc = lib.fused_round_launch(
        ptr(u), u.shape[0], ptr(state), ptr(out), n,
        ptr(scene.dense_tab), scene.dense_tab.shape[0],
        ptr(scene.prim_tab), scene.prim_tab.shape[1],
        ptr(scene.mat_tab), ptr(scene.light_tab), ptr(scene.spec_tab),
        scene.spec_tab.shape[0], ctypes.byref(cargs),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_round: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    FUSED_LAUNCHES += 1
    return out


# ------------------------------------------------------------ uniforms


class TorchUniforms:
    """Uniform source of a render: the initial spawn block and one
    `[rows, n_pad]` block per round, drawn from one `torch.Generator`."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def init(self, n_pad: int, device) -> torch.Tensor:
        return torch.rand((n_pad, 5), generator=self.generator,
                          device=device)

    def round(self, it: int, rows: int, n_pad: int, device) -> torch.Tensor:
        return torch.rand((rows, n_pad), generator=self.generator,
                          device=device)


# --------------------------------------------------------- render loop


def mega_init(camera, rnd0, a: RoundArgs, n: int, n_pad: int, spp: int):
    """Initial spawn: state [NS, n_pad] and the f64 counter vector [5].
    Lane i owns pixel i % n; lanes past n spawn dead."""
    dev = rnd0.device
    C = a.c_lanes
    pix = torch.remainder(
        torch.arange(n_pad, dtype=torch.float32, device=dev), float(n))
    xy = torch.stack([torch.remainder(pix, a.width),
                      torch.floor(fdiv(pix, a.width))], dim=-1)
    film_uv = (xy + rnd0[:, 0:2]) / torch.tensor(
        [a.width, a.height], dtype=torch.float32, device=dev)
    offs = torch.arange(C, dtype=torch.float32, device=dev) / C
    lam0 = a.wb_lo + torch.remainder(rnd0[:, 4:5] + offs[None, :], 1.0) \
        * a.wb_span
    o0, d0, tau0 = camera.get_ray(film_uv[:, 0], film_uv[:, 1],
                                  rnd0[:, 2], rnd0[:, 3])
    in_batch = torch.arange(n_pad, device=dev) < n
    state = torch.zeros((NS, n_pad), dtype=torch.float32, device=dev)
    state[S_O:S_O + 3] = o0.T
    state[S_D:S_D + 3] = d0.T
    state[S_LAM:S_LAM + C] = lam0.T
    state[S_BETA:S_BETA + C] = tau0[None, :]
    state[S_DONE] = torch.where(in_batch, float(spp), 0.0)
    state[S_ALIVE] = in_batch.float()
    state[S_PIX] = pix
    state[S_PDFR:S_PDFR + C] = 1.0
    counters = torch.zeros(prof.N_COUNTERS, dtype=torch.float64, device=dev)
    counters[prof.CAMERA_RAYS] = float(n)
    return state, counters


ALIVE_CHECK_EVERY = 4  # rounds between alive checks (one host fetch each)
# out rows O4_BOUNCE_CT.. O4_ENV_CT -> counter slots
_CT_SLOTS = (prof.BOUNCE_RAYS, prof.CAMERA_RAYS, prof.SHADOW_RAYS,
             prof.ENV_HITS)


def pt_trace_regen_mega(world, camera, settings, width, height, spp,
                        uniforms, device=None, stats=None):
    """Render `spp` samples of every pixel with one lane per pixel ->
    (xyz sums [width * height, 3], counters f64[5]), on `device`
    (default: the world's). The round launches on whatever device the
    tensors are on: the CUDA kernel on a card, the plain twin on the CPU.
    A `stats` dict, if given, gets the number of rounds added to "rounds"."""
    device = torch.device(device) if device is not None \
        else world.prims.pa.device
    scene = build_mega_scene(world, camera, device)
    a = RoundArgs.make(scene.consts, settings, width, height)
    n = width * height
    n_pad = -(-n // TILE) * TILE
    nu = nu_rows(a.light_samples)
    cam = camera.to(device)
    state, counters = mega_init(cam, uniforms.init(n_pad, device), a, n,
                                n_pad, spp)
    slots = torch.tensor(_CT_SLOTS, device=device)
    max_iters = int(spp * settings.max_bounces * 8 + 64)
    it = 0
    while it < max_iters:
        for _ in range(ALIVE_CHECK_EVERY):
            u = uniforms.round(it, nu, n_pad, device)
            out = fused_round(u, state, scene, a)
            state = out[:NS]
            counters.index_add_(0, slots, out[O4_BOUNCE_CT:O4_ENV_CT + 1]
                                .sum(dim=1, dtype=torch.float64))
            it += 1
        if not bool((state[S_ALIVE] > 0.5).any()):
            break
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + it
    return state[S_ACC:S_ACC + 3, :n].T, counters
