"""The light tracer's bounce round on the H100 (counterpart of
`pathtracer_tpu.kernels.lt_mega`).

One lane carries one particle at a time and a budget of particles to spawn.
A round takes every lane one bounce further in two kernels:

- K12-LT (`lt_shade`): the closest hit, the direct light-to-lens hit splat
  (a hit on the camera's lens proxy, thin-lens `get_pixel_for_ray`), the
  `camera_samples` lens connections of the vertex (lens sample, W_e, the
  BSDF toward the lens in Importance transport, MIS against the direct
  hit), and the BSDF sample that continues the walk -> the Q rows
  `[q2_rows(cs), N]` (`Q_*`);
- K34-LT: the connections' shadow sweeps, Russian roulette, death and the
  respawn of a lane with budget left, which takes one of two routes:
  v2 (`lt_finalize_spawn`, constant environments, at most 128 lights)
  samples the new particle in the kernel (light pick, surface sample,
  emission-λ CDF inversion, cosine or cosine-power direction, the
  constant environment's world disk) together with the light vertex's lens
  connection and its shadow sweep; v1 (`lt_finalize`, Sun and HDR
  environments, whose emission sampling needs the importance map) copies
  the particle from the torch spawn feed `lt_spawn_feed`
  (`integrator/lt.py:spawn_particles` and `_connect_to_camera_values`).

Both write the new state `[NS_LT, N]` and the resolved splat and counter
rows, and each adds the valid splats it settles to the film: K12-LT the
direct hits, K34-LT the unblocked connections and the light vertex. The
three kernels are `csrc/lt_round.cu`; each wrapper launches its kernel on
CUDA tensors, which adds each valid splat with an `atomicAdd` and skips the
empty ones, and runs its plain torch twin (`lt_shade_plain`,
`lt_finalize_spawn_plain`, `lt_finalize_plain`) on CPU tensors, then adds
the twin's splat rows with one `index_add_` (an empty row adds +0.0 to
pixel 0). The kernels walk the scene's compact `sweep_tab` from shared
memory (`csrc/walk.cuh`), K34-LT every shadow ray of a lane in one walk;
the twins read `dense_tab`.

Uniforms come from a uniform source (`megakernel.TorchUniforms`, or a
test's replay of the JAX draws): per round the `[nu_lt(cs), N]` block of
stream 0, then for v2 the `[NUSP, N]` spawn block of stream 2, for v1 the
`[N, 9]` spawn columns of stream 2 and the `[N, 2]` lens columns of stream
3; stratified spawning takes a permutation of the strata from stream 2.

Scope (`lt_gate_refusal`): projective camera, identity transforms, at most
8192 prims, 24 materials and 128 lights, 1x1 surface textures (an HDR
environment map is exempt), 512-knot spectral curves.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from pathtracer_tpu_torch.core import cie
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.kernels.cmath import V3, fdiv
from pathtracer_tpu_torch.kernels.dense import (
    PBF,
    sweep_any_cols,
    sweep_closest_cols,
)
from pathtracer_tpu_torch.materials.tables import (
    MAT_GGX,
    MAT_PASSTHROUGH,
    MAT_SHARP_LIGHT,
    emission_direction_pdf_rows,
)
from pathtracer_tpu_torch.prelude import (
    INTERSECTION_TIME_OFFSET,
    NORMAL_OFFSET,
    RAY_TMAX,
    TransportMode,
)
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.world.environment import ENV_CONSTANT

# ---- LT state rows [NS_LT, N]
LS_O = 0          # 3
LS_D = 3          # 3
LS_LAM = 6        # the particle's single wavelength
LS_BETA = 7
LS_PREV = 8       # solid-angle pdf of the sampling that produced d
LS_ALIVE = 9
LS_BOUNCE = 10
LS_BUDGET = 11    # particles this lane may still spawn
LS_ENV = 12       # the particle came from the environment
NS_LT = 16

# ---- K12-LT output rows
Q_HIT_PID = 0     # direct lens-hit splat: film pixel id (f32)
Q_HIT_XYZ = 1     # 3
Q_ALIVE = 4       # still walking after the lens-hit absorption
Q_FPDF = 5
Q_RATIO = 6
Q_SOK = 7
Q_ONEW = 8        # 3
Q_DNEW = 11       # 3
Q_CONN = 14       # per camera sample: so(3) dir(3) tmax pid xyz(3) valid
CONN_ROWS = 12

# ---- spawn-feed rows (v1)
F_O = 0           # 3
F_D = 3           # 3
F_LAM = 6
F_BETA = 7
F_PREV = 8
F_ALIVE = 9
F_ENV = 10
F_LV = 11         # light-vertex connection: so(3) dir(3) tmax pid xyz(3)
F_LV_VALID = F_LV + 11
NF = -(-(F_LV_VALID + 1) // 8) * 8

# ---- K34-LT output rows: new state + per camera sample pid(1) xyz(3)
K4_CONN = NS_LT
NUSP = 16          # v2 spawn uniform rows (9 particle + 2 lens, padded)

# spawn-table rows (v2): knots 0..511 of each light's emission CDF (lights
# on the 128 columns), then the CDF at the wavelength bounds and the SPD's
# integral
_SP_CDFLO = 512
_SP_CDFHI = 513
_SP_INTEG = 514
_NSP_ROWS = 520

# uniform streams of a round
STREAM_U, STREAM_SPAWN, STREAM_LENS = 0, 2, 3

LT_MAX_LIGHTS = 128

# launches of the CUDA kernels, and calls of any plain twin
SHADE_LAUNCHES = 0
FINALIZE_SPAWN_LAUNCHES = 0
FINALIZE_LAUNCHES = 0
PLAIN_CALLS = 0

_NOT_IN_GATE = ("the LT megakernel takes projective cameras, identity "
                "transforms, at most 8192 prims, 24 materials and 128 lights, "
                "1x1 surface textures and spectral curves of 512 knots; "
                "render_splatted takes other scenes through the "
                "light-tracing wavefront `integrator/lt.py:lt_trace` unless "
                "use_megakernel=True")


def q2_rows(camera_samples: int) -> int:
    return -(-(Q_CONN + CONN_ROWS * camera_samples) // 8) * 8


def k4_rows(camera_samples: int) -> int:
    """v1 K34-LT rows: state, splats, then lv_ok, resp, bounce, conn_ct."""
    return -(-(K4_CONN + 4 * camera_samples + 4) // 8) * 8


def k4_aux(camera_samples: int) -> dict:
    base = K4_CONN + 4 * camera_samples
    return dict(lv_ok=base, resp=base + 1, bounce=base + 2, conn_ct=base + 3)


def k4_rows_v2(camera_samples: int) -> int:
    """v2 K34-LT rows: state, splats, the light vertex's pid and xyz, then
    resp, bounce, conn_ct, lv_ct."""
    return -(-(K4_CONN + 4 * camera_samples + 8) // 8) * 8


def k4_aux_v2(camera_samples: int) -> dict:
    base = K4_CONN + 4 * camera_samples
    return dict(lv_pid=base, lv_xyz=base + 1, resp=base + 4, bounce=base + 5,
                conn_ct=base + 6, lv_ct=base + 7)


def discrete_rows(camera_samples: int, spawn_inkernel: bool):
    """The rows of K12-LT and of K34-LT (v2 or v1) that hold pixel ids,
    flags and counts, not measurements -> (Q rows, K34-LT rows)."""
    cs = camera_samples
    q = [Q_HIT_PID, Q_ALIVE, Q_SOK] + [
        Q_CONN + CONN_ROWS * ci + k for ci in range(cs) for k in (7, 11)]
    aux = k4_aux_v2(cs) if spawn_inkernel else k4_aux(cs)
    return q, [LS_ALIVE, LS_BOUNCE, LS_BUDGET, LS_ENV] + [
        K4_CONN + 4 * ci for ci in range(cs)] + [
        r for k, r in aux.items() if k != "lv_xyz"]


def nu_lt(camera_samples: int) -> int:
    """Uniform rows: 2 per lens connection, 3 (BSDF), 1 (RR), padded."""
    return -(-(2 * camera_samples + 4) // 8) * 8


# ------------------------------------------------------------------ gate


def lt_gate_refusal(world, camera, settings):
    """Why the LT megakernel does not render this scene, or None if it
    does (the JAX package's `lt_mega_available`, with the light cap its
    table bake needs), recorded as a `gate` span."""
    return mk.scene_refusal(world, camera, _NOT_IN_GATE,
                            max_lights=LT_MAX_LIGHTS, textured=False)


def lt_mega_spawn_inkernel(world) -> bool:
    """The v2 route: in-kernel spawning covers instance lights and constant
    environments with at most 128 lights."""
    return (int(world.env.kind) == ENV_CONSTANT
            and int(world.n_lights) <= LT_MAX_LIGHTS)


def bake_lt_spawn_tab(world, wb):
    """[520, 128] f32 table of the in-kernel emission-λ CDF inversion
    (`core/spectral.sample_power_and_pdf`): column l holds light l's
    emission-curve CDF knots, its CDF at the wavelength bounds and its
    integral (the JAX package's numpy bake, step for step)."""
    bank = world.bank
    cdf = mk._np(bank.cdf)
    integral = mk._np(bank.integral)
    lam_lo, lam_hi = float(bank.lam_lo), float(bank.lam_hi)
    res = cdf.shape[1]
    assert res == mk.SPEC_RES
    lights = mk._np(world.lights)
    mat_id = mk._np(world.prims.material_id)
    emit_idx = mk._np(world.mats.emit_idx)
    tab = np.zeros((_NSP_ROWS, 128), np.float32)

    def cdf_at_np(row, lam):
        u = (lam - lam_lo) / (lam_hi - lam_lo) * (res - 1)
        u = min(max(u, 0.0), res - 1 - 1e-4)
        i0 = int(u)
        frac = u - i0
        return row[i0] * (1.0 - frac) + row[min(i0 + 1, res - 1)] * frac

    for l, prim in enumerate(lights[:int(world.n_lights)][:128]):
        e = max(int(emit_idx[int(mat_id[int(prim)])]), 0)
        row = cdf[e]
        tab[:res, l] = row
        tab[_SP_CDFLO, l] = cdf_at_np(row, float(wb.lower))
        tab[_SP_CDFHI, l] = cdf_at_np(row, float(wb.upper))
        tab[_SP_INTEG, l] = float(integral[e])
    return tab


# ------------------------------------------------------------ the scene


@dataclasses.dataclass(frozen=True)
class LtArgs:
    """Scalars of one light-tracing render: the scene constants, the
    camera, the settings and the film."""

    cs: int
    max_bounces: float
    min_bounces: float
    russian_roulette: bool
    width: float
    height: float
    wb_lo: float
    wb_span: float
    n_mats: int
    n_lights: int
    p_env: float
    has_ggx: bool
    has_sharp: bool
    lam_lo: float
    lam_hi: float
    env_rot_inv: tuple
    cam_origin: tuple
    cam_u: tuple
    cam_v: tuple
    cam_w: tuple
    cam_half_w: float
    cam_half_h: float
    cam_focal: float
    cam_lens_r: float
    a_lens: float       # π r² of the lens, in double
    a_film: float       # (2 half_w)(2 half_h) of the focal plane, f32
    has_proxy: bool     # the lens proxy disk is in the scene
    world_radius: float
    world_center: tuple

    @staticmethod
    def make(world, camera, consts: dict, settings, width, height):
        wb = settings.wavelength_bounds
        c = consts
        hw = np.float32(camera.half_width.cpu().numpy())
        hh = np.float32(camera.half_height.cpu().numpy())
        return LtArgs(
            cs=int(settings.camera_samples),
            max_bounces=float(settings.max_bounces),
            min_bounces=float(settings.min_bounces),
            russian_roulette=bool(settings.russian_roulette),
            width=float(width), height=float(height),
            wb_lo=float(wb.lower), wb_span=float(wb.span),
            n_mats=c["n_mats"], n_lights=c["n_lights"], p_env=c["p_env"],
            has_ggx=c["has_ggx"], has_sharp=c["has_sharp"],
            lam_lo=c["lam_lo"], lam_hi=c["lam_hi"],
            env_rot_inv=c["env_rot_inv"], cam_origin=c["cam_origin"],
            cam_u=c["cam_u"], cam_v=c["cam_v"], cam_w=c["cam_w"],
            cam_half_w=c["cam_half_w"], cam_half_h=c["cam_half_h"],
            cam_focal=c["cam_focal"], cam_lens_r=c["cam_lens_r"],
            a_lens=float(np.pi) * float(camera.lens_radius) ** 2,
            a_film=float((np.float32(2.0) * hw) * (np.float32(2.0) * hh)),
            has_proxy=bool((world.prims.mat_kind == 2).any()),
            world_radius=float(mk._np(world.radius)),
            world_center=tuple(float(x) for x in mk._np(world.center)))


class _CLtArgs(ctypes.Structure):
    """`struct LtArgs` of csrc/lt_round.cu (all fields 4 bytes). Constants
    that the JAX kernels fold on the host in double precision are folded
    here the same way and rounded once to f32."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "cs", "n_mats", "n_lights", "nl1", "has_ggx", "has_sharp",
        "has_proxy", "lens_on", "env_on", "rr_enabled")
    ] + [(n, ctypes.c_float) for n in (
        "lam_lo", "lam_span", "lam_step", "max_bounces", "min_bounces",
        "width", "height", "wb_lo", "wb_hi", "wb_span", "inv_wb_span",
        "p_env", "q_pick", "nl_f", "inv_cs", "p_conn_cs", "p_conn_1",
        "a_lens_div", "a_film", "focal", "focal2", "half_w_div",
        "half_h_div", "lens_r", "world_radius", "pos_pdf")
    ] + [(n, ctypes.c_float * k) for n, k in (
        ("env_rot_inv", 9), ("cam_origin", 3), ("cam_u", 3), ("cam_v", 3),
        ("cam_w", 3), ("cam_fw", 3), ("world_center", 3))]


def _c_args(a: LtArgs) -> _CLtArgs:
    s = _CLtArgs()
    nl1 = max(a.n_lights, 1)
    a_lens_div = max(a.a_lens, 1e-30)
    s.cs, s.n_mats, s.n_lights, s.nl1 = a.cs, a.n_mats, a.n_lights, nl1
    s.has_ggx, s.has_sharp, s.has_proxy = a.has_ggx, a.has_sharp, a.has_proxy
    s.lens_on, s.env_on = a.a_lens > 0.0, a.p_env > 0.0
    s.rr_enabled = a.russian_roulette
    s.lam_lo, s.lam_span = a.lam_lo, a.lam_hi - a.lam_lo
    s.lam_step = (a.lam_hi - a.lam_lo) / (mk.SPEC_RES - 1)
    s.max_bounces, s.min_bounces = a.max_bounces, a.min_bounces
    s.width, s.height = a.width, a.height
    s.wb_lo, s.wb_hi, s.wb_span = a.wb_lo, a.wb_lo + a.wb_span, a.wb_span
    s.inv_wb_span = 1.0 / a.wb_span
    s.p_env = a.p_env
    s.q_pick = max(1.0 - a.p_env, 1e-6) * (1.0 / float(nl1))
    s.nl_f = float(nl1)
    s.inv_cs = 1.0 / a.cs
    s.p_conn_cs = a.cs / a_lens_div
    s.p_conn_1 = 1.0 / a_lens_div
    s.a_lens_div, s.a_film = a_lens_div, a.a_film
    s.focal, s.focal2 = a.cam_focal, a.cam_focal * a.cam_focal
    s.half_w_div = max(a.cam_half_w, 1e-9)
    s.half_h_div = max(a.cam_half_h, 1e-9)
    s.lens_r = a.cam_lens_r
    s.world_radius = a.world_radius
    s.pos_pdf = 1.0 / (math.pi * a.world_radius * a.world_radius)
    s.env_rot_inv[:] = list(a.env_rot_inv)
    for name in ("cam_origin", "cam_u", "cam_v", "cam_w"):
        getattr(s, name)[:] = list(getattr(a, name))
    s.cam_fw[:] = [a.cam_focal * x for x in a.cam_w]
    s.world_center[:] = list(a.world_center)
    return s


@dataclasses.dataclass
class LtScene:
    """Device tables of one light-tracing render, its scalars, and what the
    spawn feed (v1) reads: the world and the camera on the lanes' device."""

    tabs: mk.MegaScene
    a: LtArgs
    lcdf_tab: torch.Tensor = None   # f32[520, 128] (v2), else None
    world: object = None
    camera: object = None

    @property
    def spawn_inkernel(self) -> bool:
        return self.lcdf_tab is not None


def build_lt_scene(world, camera, settings, width, height, device=None,
                   spawn_inkernel=None) -> LtScene:
    """The bake of one render: the megakernel tables (without the regen
    feeds), the LT scalars and, for the v2 route, the spawn table.
    `spawn_inkernel` None takes v2 where `lt_mega_spawn_inkernel` allows
    it; False forces the spawn feed (v1)."""
    why = lt_gate_refusal(world, camera, settings)
    if why is not None:
        raise NotImplementedError(why)
    return _bake_lt_scene(world, camera, settings, width, height, device,
                          spawn_inkernel)


def _bake_lt_scene(world, camera, settings, width, height, device,
                   spawn_inkernel) -> LtScene:
    """`build_lt_scene` of a scene that its gate has taken."""
    device = torch.device(device) if device is not None \
        else world.prims.pa.device
    tabs = mk.bake_mega_scene(world, camera, device, feeds=False)
    a = LtArgs.make(world, camera, tabs.consts, settings, width, height)
    if spawn_inkernel is None:
        spawn_inkernel = lt_mega_spawn_inkernel(world)
    elif spawn_inkernel and not lt_mega_spawn_inkernel(world):
        raise ValueError("in-kernel spawning takes constant environments "
                         "with at most 128 lights")
    lcdf = (torch.as_tensor(bake_lt_spawn_tab(world, settings.wavelength_bounds),
                            device=device) if spawn_inkernel else None)
    return LtScene(tabs=tabs, a=a, lcdf_tab=lcdf,
                   world=_world_to(world, device), camera=camera.to(device))


def _world_to(world, device):
    """The World with every tensor on `device`."""
    return dataclasses.replace(world, **{
        f.name: (v.to(device) if isinstance(v, torch.Tensor)
                 else mk._to(v, device))
        for f in dataclasses.fields(world)
        for v in (getattr(world, f.name),)})


# ------------------------------------------------------------ plain twins


def _rdiv(c: float, x):
    """c / x as one IEEE division (torch computes scalar / tensor as a
    reciprocal times c)."""
    return torch.full_like(x, c) / x


def _col(x):
    return x[:, None]


def _sweep_any(dense_tab, so: V3, sd: V3, tmax):
    return sweep_any_cols(
        dense_tab, _col(so.x), _col(so.y), _col(so.z), _col(sd.x),
        _col(sd.y), _col(sd.z),
        _col(torch.full_like(tmax, INTERSECTION_TIME_OFFSET)), _col(tmax))


def _film_pid_for(a: LtArgs, o: V3, dneg: V3):
    """Thin-lens get_pixel_for_ray of a ray from lens point `o` travelling
    `dneg` into the scene -> (film pixel id f32, on the film)."""
    cw, cu, cv, co = a.cam_w, a.cam_u, a.cam_v, a.cam_origin
    focal = a.cam_focal
    cos_f = dneg.x * cw[0] + dneg.y * cw[1] + dneg.z * cw[2]
    valid = cos_f > 1e-6
    tt = _rdiv(focal, torch.where(valid, cos_f, 1.0))
    p = [o[i] + tt * dneg[i] - co[i] - focal * cw[i] for i in range(3)]
    fu = fdiv(p[0] * cu[0] + p[1] * cu[1] + p[2] * cu[2],
              max(a.cam_half_w, 1e-9))
    fv = fdiv(p[0] * cv[0] + p[1] * cv[1] + p[2] * cv[2],
              max(a.cam_half_h, 1e-9))
    film_u = (fu + 1.0) * 0.5
    film_v = (1.0 - fv) * 0.5
    inside = ((film_u >= 0.0) & (film_u < 1.0) & (film_v >= 0.0)
              & (film_v < 1.0))
    pxi = torch.clamp(torch.floor(film_u * a.width), max=a.width - 1.0)
    pyi = torch.clamp(torch.floor(film_v * a.height), max=a.height - 1.0)
    return pyi * a.width + pxi, valid & inside


def _lens_point_for(a: LtArgs, u1, u2) -> V3:
    """A point on the thin-lens aperture disk (polar map, √u1 and 2πu2)."""
    r_d = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    lx = r_d * torch.cos(phi) * a.cam_lens_r
    ly = r_d * torch.sin(phi) * a.cam_lens_r
    co, cu, cv = a.cam_origin, a.cam_u, a.cam_v
    return V3(*[co[i] + lx * cu[i] + ly * cv[i] for i in range(3)])


def _xyz(lam, e):
    return [e * cie.x_bar(lam), e * cie.y_bar(lam), e * cie.z_bar(lam)]


def _we(a: LtArgs, cos_cam):
    """The lens importance focal² / (cos³θ · A_film)."""
    x = torch.clamp(cos_cam, min=1e-6)
    return _rdiv(a.cam_focal * a.cam_focal, x * (x * x) * a.a_film)


def lt_shade_plain(u, state, dense_tab, prim_tab, mat_tab, spec_tab,
                   a: LtArgs):
    """K12-LT in plain torch -> Q rows [q2_rows(cs), N] (the JAX package's
    `_lt_shade_kernel`). A lane dead at the round's start gets all-zero
    rows; a live lane that hit nothing gets zero rows but for Q_ALIVE = 0 and
    zero-length connection rays (never blocked, as the JAX kernel's NaN
    rays are not); the continuation rows are 0 where the walk ended."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cs = a.cs
    n = state.shape[1]
    s = state
    o = V3(s[LS_O], s[LS_O + 1], s[LS_O + 2])
    d = V3(s[LS_D], s[LS_D + 1], s[LS_D + 2])
    lam, beta, prev_pdf = s[LS_LAM], s[LS_BETA], s[LS_PREV]
    alive0 = s[LS_ALIVE] > 0.5
    bounce = s[LS_BOUNCE]
    from_env = s[LS_ENV] > 0.5
    t_hit, pid = sweep_closest_cols(
        dense_tab, _col(o.x), _col(o.y), _col(o.z), _col(d.x), _col(d.y),
        _col(d.z), _col(torch.full_like(o.x, INTERSECTION_TIME_OFFSET)),
        _col(torch.full_like(o.x, RAY_TMAX)))
    hit = pid >= 0.0
    reach = alive0 & hit
    attr = prim_tab[:, torch.clamp(pid, min=0.0).long()]
    point, normal, gn, mat_id, kind, _ = mk._hit_attributes(attr, o, d, t_hit)
    R = mk._spectral_rows(spec_tab, lam, a.lam_lo, a.lam_hi)
    cw = a.cam_w
    q = torch.zeros((q2_rows(cs), n), dtype=torch.float32, device=s.device)

    # ---- the direct light -> lens hit
    d_dot_w = d.x * cw[0] + d.y * cw[1] + d.z * cw[2]
    hit_cam = reach & (kind == 2.0) & (d_dot_w < 0.0)
    fpid_h, on_film_h = _film_pid_for(a, point, -d)
    cos_cam_h = torch.abs(d_dot_w)
    if a.a_lens > 0.0:
        x = torch.clamp(cos_cam_h, min=1e-6)
        we_area = _rdiv(a.cam_focal * a.cam_focal,
                        max(a.a_lens, 1e-30) * ((x * x) * (x * x))
                        * a.a_film)
    else:
        we_area = torch.zeros_like(cos_cam_h)
    tm = torch.clamp(t_hit, min=1e-6)
    p_hit_area = prev_pdf * cos_cam_h / (tm * tm)
    n_comp = torch.where(bounce < 0.5, 1.0, float(cs))
    denom = p_hit_area + fdiv(n_comp, max(a.a_lens, 1e-30))
    w_hit = torch.where(denom > 0.0, p_hit_area / torch.where(
        denom > 0.0, denom, 1.0), 0.0)
    w_hit = torch.where((bounce < 0.5) & from_env, 1.0, w_hit)
    e_hit = beta * we_area * w_hit
    hit_ok = hit_cam & on_film_h & torch.isfinite(e_hit) & (e_hit > 0.0)
    q[Q_HIT_PID] = torch.where(hit_ok, fpid_h, 0.0)
    for i, r in enumerate(_xyz(lam, torch.where(hit_ok, e_hit, 0.0))):
        q[Q_HIT_XYZ + i] = r
    alive = reach & (kind != 2.0)

    # ---- shading frame and material
    tgt, btg = cmath.orthonormal_basis(normal)
    wi_local = cmath.to_local(tgt, btg, normal, -d)
    mid = mat_id.long()

    def mat(row):
        return mat_tab[row][mid]

    mtype, alpha = mat(mk._M_TYPE), mat(mk._M_ALPHA)
    metal, perm = mat(mk._M_METAL), mat(mk._M_PERM)
    eta_i, eta_o = R(5.0 * mat_id + 0.0), R(5.0 * mat_id + 1.0)
    kappa = R(5.0 * mat_id + 2.0)
    refl = mat(mk._M_RSCALE) * R(5.0 * mat_id + 3.0)

    # ---- the lens connections
    for ci in range(cs):
        lens = _lens_point_for(a, u[2 * ci], u[2 * ci + 1])
        to_cam = lens - point
        dist2 = torch.clamp(cmath.length_squared(to_cam), min=1e-12)
        dist = torch.sqrt(dist2)
        dir_c = to_cam.scale(1.0 / dist)
        fpid, on_film = _film_pid_for(a, lens, -dir_c)
        cos_cam = torch.abs(dir_c.x * cw[0] + dir_c.y * cw[1]
                            + dir_c.z * cw[2])
        wo_l = cmath.to_local(tgt, btg, normal, dir_c)
        f_c, pdf_c = mk._bsdf_eval_lanes(
            mtype, alpha, metal, perm, [eta_i], [eta_o], [kappa], [refl],
            wi_local, wo_l, a.has_ggx, True, TransportMode.Importance)
        f_c, pdf_c = f_c[0], pdf_c[0]
        energy = (beta * (1.0 / cs) / dist2 * _we(a, cos_cam) * f_c
                  * torch.abs(wo_l.z))
        if a.has_proxy and a.a_lens > 0.0:
            p_conn = cs / max(a.a_lens, 1e-30)
            den = p_conn + pdf_c * cos_cam / dist2
            energy = energy * torch.where(den > 0.0, _rdiv(
                p_conn, torch.where(den > 0.0, den, 1.0)), 1.0)
        so = point + gn.scale(NORMAL_OFFSET * torch.sign(
            cmath.dot(gn, dir_c) + 1e-9))
        valid = alive & on_film & (energy > 0.0) & torch.isfinite(energy)
        b = Q_CONN + CONN_ROWS * ci
        for i, x in enumerate((*so, *dir_c, dist * 0.99)):
            q[b + i] = torch.where(reach, x, 0.0)
        q[b + 7] = torch.where(valid, fpid, 0.0)
        for i, r in enumerate(_xyz(lam, torch.where(valid, energy, 0.0))):
            q[b + 8 + i] = r
        q[b + 11] = valid.float()

    # ---- the continuation sample (Importance transport)
    ub = [u[2 * cs + i] for i in range(3)]
    wo_s, _, pdf_lam = cmath.sample_lambertian(refl, wi_local, ub[0], ub[1])
    ratio = torch.clamp(refl, max=1.0)
    f_pdf = pdf_lam
    if a.has_ggx:
        wo_g, _, pdf_g, w_g = cmath.sample_ggx(
            torch.clamp(alpha, min=1e-4), torch.clamp(eta_i, min=1e-3),
            torch.clamp(eta_o, min=1e-3), kappa, metal > 0.5, perm, wi_local,
            ub[0], ub[1], ub[2], TransportMode.Importance)
        is_ggx = mtype == MAT_GGX
        wo_s = cmath.where(is_ggx, wo_g, wo_s)
        f_pdf = torch.where(is_ggx, pdf_g, f_pdf)
        ratio = torch.where(is_ggx, w_g, ratio)
    is_pass = mtype == MAT_PASSTHROUGH
    f_pdf = torch.where(is_pass, 0.0, f_pdf)
    ratio = torch.where(is_pass, 0.0, ratio)
    sample_ok = (f_pdf > 1e-12) & (ratio > 0.0)
    d_new = cmath.normalize(cmath.to_world(tgt, btg, normal, wo_s))
    o_new = point + gn.scale(NORMAL_OFFSET * torch.sign(cmath.dot(gn, d_new)))
    q[Q_ALIVE] = alive.float()
    q[Q_FPDF] = torch.where(alive, f_pdf, 0.0)
    q[Q_RATIO] = torch.where(alive, ratio, 0.0)
    q[Q_SOK] = (alive & sample_ok).float()
    for i, x in enumerate((*o_new, *d_new)):
        q[Q_ONEW + i] = torch.where(alive, x, 0.0)
    return q


def _state_in(state):
    s = state
    return dict(o=V3(s[LS_O], s[LS_O + 1], s[LS_O + 2]),
                d=V3(s[LS_D], s[LS_D + 1], s[LS_D + 2]), lam=s[LS_LAM],
                beta=s[LS_BETA], alive0=s[LS_ALIVE] > 0.5,
                bounce=s[LS_BOUNCE], budget=s[LS_BUDGET])


def _resolve_connections(k2, dense_tab, alive0, out, cs):
    """The connections' shadow sweeps: each unblocked valid connection's
    splat rows into `out`; -> the count of unblocked rays of lanes that
    were alive at the round's start."""
    conn_ct = torch.zeros_like(k2[0])
    for ci in range(cs):
        b = Q_CONN + CONN_ROWS * ci
        blocked = _sweep_any(dense_tab, V3(k2[b], k2[b + 1], k2[b + 2]),
                             V3(k2[b + 3], k2[b + 4], k2[b + 5]), k2[b + 6])
        ok = (k2[b + 11] > 0.5) & ~blocked
        conn_ct = conn_ct + (alive0 & ~blocked).float()
        out[K4_CONN + 4 * ci] = torch.where(ok, k2[b + 7], 0.0)
        for i in range(3):
            out[K4_CONN + 4 * ci + 1 + i] = torch.where(ok, k2[b + 8 + i],
                                                        0.0)
    return conn_ct


def _continue(k2, st, u_rr, a: LtArgs):
    """Russian roulette and continuation -> (continues, next β)."""
    alive = k2[Q_ALIVE] > 0.5
    ratio = k2[Q_RATIO]
    sample_ok = k2[Q_SOK] > 0.5
    bounce = st["bounce"]
    if a.russian_roulette:
        p_cont = torch.where(bounce >= a.min_bounces,
                             torch.clamp(ratio, 0.05, 1.0), 1.0)
    else:
        p_cont = torch.ones_like(ratio)
    survive = u_rr < p_cont
    beta_next = st["beta"] * torch.where(
        sample_ok, ratio / torch.clamp(p_cont, min=1e-6), 0.0)
    cp = (alive & sample_ok & survive & ~((bounce + 1.0) >= a.max_bounces)
          & torch.isfinite(beta_next))
    return cp, beta_next


def _write_state(out, state, st, k2, cp, hw, beta_next, sp_o, sp_d, sp_lam,
                 sp_beta, sp_prev, resp_ok, sp_env):
    """The new state rows: a continuing walk steps, a lane with budget left
    takes the new particle, any other lane keeps its state."""
    o_new = V3(k2[Q_ONEW], k2[Q_ONEW + 1], k2[Q_ONEW + 2])
    d_new = V3(k2[Q_DNEW], k2[Q_DNEW + 1], k2[Q_DNEW + 2])
    o_out = cmath.where(cp, o_new, cmath.where(hw, sp_o, st["o"]))
    d_out = cmath.where(cp, d_new, cmath.where(hw, sp_d, st["d"]))
    for i in range(3):
        out[LS_O + i] = o_out[i]
        out[LS_D + i] = d_out[i]
    out[LS_LAM] = torch.where(hw, sp_lam, st["lam"])
    out[LS_BETA] = torch.where(cp, beta_next,
                               torch.where(hw, sp_beta, st["beta"]))
    out[LS_PREV] = torch.where(cp, k2[Q_FPDF],
                               torch.where(hw, sp_prev, state[LS_PREV]))
    out[LS_ALIVE] = (cp | resp_ok).float()
    bounce = st["bounce"]
    out[LS_BOUNCE] = torch.where(cp, bounce + 1.0,
                                 torch.where(hw, 0.0, bounce))
    budget = st["budget"]
    out[LS_BUDGET] = torch.where(hw, budget - 1.0, budget)
    out[LS_ENV] = torch.where(hw, sp_env, state[LS_ENV])
    out[LS_ENV + 1:NS_LT] = state[LS_ENV + 1:NS_LT]


def _spawn_plain(a: LtArgs, usp, light_tab, spec_tab, lcdf_tab):
    """The in-kernel spawn of K34-LT v2 in plain torch (the JAX package's
    `_spawn_inkernel`): `spawn_particles` and the light vertex's lens
    connection from the light table, with the emission-λ CDF inverted by a
    binary search over the picked light's column of the spawn table."""
    u0 = usp
    nl = max(a.n_lights, 1)
    li = torch.clamp(torch.floor(u0[0] * nl), max=float(nl - 1))
    lix = li.long()

    def lrow(r):
        return light_tab[r][lix]

    lpa = V3(lrow(mk._L_PA), lrow(mk._L_PA + 1), lrow(mk._L_PA + 2))
    lpb = V3(lrow(mk._L_PB), lrow(mk._L_PB + 1), lrow(mk._L_PB + 2))
    lpc = V3(lrow(mk._L_PC), lrow(mk._L_PC + 1), lrow(mk._L_PC + 2))
    l_mat, l_mtype = lrow(mk._L_MAT), lrow(mk._L_MTYPE)
    l_side, l_sharp = lrow(mk._L_SIDE), lrow(mk._L_SHARP)
    lp, ln = mk._sample_surface_light(lrow(mk._L_PTYPE), lpa, lpb, lpc,
                                      u0[1], u0[2])
    area_pdf = 1.0 / torch.clamp(lrow(mk._L_AREA), min=1e-20)
    q_pick = max(1.0 - a.p_env, 1e-6) * (1.0 / float(nl))

    # ---- the emission-λ CDF inversion: i1 = the number of knots below the
    # target, by binary search over the light's CDF column
    flat = lcdf_tab.reshape(-1)

    def lsc(r):
        return flat[r * 128 + lix]

    cdf_lo, cdf_hi = lsc(_SP_CDFLO), lsc(_SP_CDFHI)
    span = torch.clamp(cdf_hi - cdf_lo, min=1e-9)
    target = cdf_lo + u0[3] * span
    i1 = torch.zeros_like(lix)
    step = mk.SPEC_RES >> 1
    while step:
        probe = i1 + step
        i1 = torch.where(flat[(probe - 1) * 128 + lix] < target, probe, i1)
        step >>= 1
    i1 = torch.clamp(i1, 1, mk.SPEC_RES - 1)
    c0, c1 = flat[(i1 - 1) * 128 + lix], flat[i1 * 128 + lix]
    frac = torch.clamp((target - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0,
                       1.0)
    lam_step = (a.lam_hi - a.lam_lo) / (mk.SPEC_RES - 1)
    lam_i = a.lam_lo + ((i1 - 1).float() + frac) * lam_step
    lam_i = torch.clamp(lam_i, a.wb_lo, a.wb_lo + a.wb_span)

    env_on = a.p_env > 0.0
    pick_env = (u0[8] < a.p_env) if env_on else torch.zeros_like(li,
                                                                  dtype=bool)
    lam = (torch.where(pick_env, a.wb_lo + u0[3] * a.wb_span, lam_i)
           if env_on else lam_i)
    R = mk._spectral_rows(spec_tab, lam, a.lam_lo, a.lam_hi)
    spd = R(5.0 * l_mat + 4.0)
    lam_pdf = spd / torch.clamp(lsc(_SP_INTEG) * span, min=1e-20)

    # ---- the emission direction
    nexp = (torch.where(l_mtype == MAT_SHARP_LIGHT, l_sharp, 1.0)
            if a.has_sharp else torch.ones_like(li))
    cos_t = torch.pow(u0[4], 1.0 / (nexp + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi_d = 2.0 * math.pi * u0[5]
    pick_rev = (l_side == 1) | ((l_side == 2) & (u0[6] < 0.5))
    t_ax, b_ax = cmath.orthonormal_basis(ln)
    fn = cmath.where(pick_rev, -ln, ln)
    lx, ly = sin_t * torch.cos(phi_d), sin_t * torch.sin(phi_d)
    d0_i = V3(*[lx * t_ax[i] + ly * b_ax[i] + cos_t * fn[i] for i in range(3)])
    dir_pdf = fdiv((nexp + 1.0) * torch.pow(cos_t, nexp), 2.0 * math.pi)
    dir_pdf = torch.where(l_side == 2, dir_pdf * 0.5, dir_pdf)
    le = mk._emission_value(spd, l_mtype, l_side, l_sharp,
                            cmath.dot(ln, d0_i), a.has_sharp)
    den_i = q_pick * area_pdf * dir_pdf * lam_pdf
    beta_i = torch.where(den_i != 0.0, le * torch.abs(cos_t) / torch.where(
        den_i != 0.0, den_i, 1.0), 0.0)
    alive = (beta_i > 0.0) if a.n_lights > 0 else torch.zeros_like(pick_env)
    o_sp = lp + ln.scale(NORMAL_OFFSET * torch.sign(cmath.dot(ln, d0_i)))
    d_sp, beta, prev0 = d0_i, beta_i, dir_pdf

    # ---- the constant environment: a direction, and a point on the world
    # disk facing inward
    if env_on:
        d_uv = cmath.uv_to_direction(u0[1], u0[2])
        ri = a.env_rot_inv
        d_out = V3(*[ri[3 * k] * d_uv.x + ri[3 * k + 1] * d_uv.y
                     + ri[3 * k + 2] * d_uv.z for k in range(3)])
        jac_s = 2.0 * math.pi * math.pi * torch.sin(math.pi * u0[2]) + 0.001
        dir_pdf_env = 1.0 / jac_s
        le_env = R(5 * a.n_mats)
        radius, ctr = a.world_radius, a.world_center
        te, be = cmath.orthonormal_basis(d_out)
        dx, dy = cmath.random_in_unit_disk(u0[4], u0[5])
        dx, dy = dx * radius, dy * radius
        lp_e = V3(*[ctr[i] + d_out[i] * radius + dx * te[i] + dy * be[i]
                    for i in range(3)])
        den_e = (a.p_env * dir_pdf_env * (1.0 / (math.pi * radius * radius))
                 * (1.0 / a.wb_span))
        beta_e = torch.where(den_e != 0.0, le_env / torch.where(
            den_e != 0.0, den_e, 1.0), 0.0)
        beta = torch.where(pick_env, beta_e, beta_i)
        o_sp = cmath.where(pick_env, lp_e, o_sp)
        d_sp = cmath.where(pick_env, -d_out, d0_i)
        alive = torch.where(pick_env, beta_e > 0.0, alive)
        prev0 = torch.where(pick_env, dir_pdf_env, dir_pdf)
    beta = torch.where(torch.isfinite(beta) & (beta > 0.0), beta, 0.0)
    alive = alive & (beta > 0.0)

    # ---- the light vertex's lens connection
    lens = _lens_point_for(a, u0[9], u0[10])
    to_cam = lens - lp
    dist2 = torch.clamp(cmath.length_squared(to_cam), min=1e-12)
    dist = torch.sqrt(dist2)
    dir_c = to_cam.scale(1.0 / dist)
    lv_pid, on_film = _film_pid_for(a, lens, -dir_c)
    cw = a.cam_w
    cos_cam = torch.abs(dir_c.x * cw[0] + dir_c.y * cw[1] + dir_c.z * cw[2])
    den_f = q_pick * area_pdf * lam_pdf
    beta_f = torch.where(den_f != 0.0, 1.0 / torch.where(den_f != 0.0, den_f,
                                                         1.0), 0.0)
    cos_lc = cmath.dot(ln, dir_c)
    le_c = mk._emission_value(spd, l_mtype, l_side, l_sharp, cos_lc,
                              a.has_sharp)
    energy = beta_f / dist2 * _we(a, cos_cam) * le_c * torch.abs(cos_lc)
    if a.has_proxy and a.a_lens > 0.0:
        p_conn = 1.0 / max(a.a_lens, 1e-30)
        den = p_conn + emission_direction_pdf_rows(
            l_mtype, l_side, l_sharp, cos_lc, a.has_sharp) * cos_cam / dist2
        energy = energy * torch.where(den > 0.0, _rdiv(
            p_conn, torch.where(den > 0.0, den, 1.0)), 1.0)
    lv_valid = (on_film & (energy > 0.0) & torch.isfinite(energy)
                & ~pick_env) if a.n_lights > 0 else torch.zeros_like(pick_env)
    so_lv = lp + ln.scale(NORMAL_OFFSET * torch.sign(cos_lc + 1e-9))
    return dict(o=o_sp, d=d_sp, lam=lam, beta=beta, alive=alive, prev0=prev0,
                pick_env=pick_env, so_lv=so_lv, dir_lv=dir_c,
                tmax_lv=dist * 0.99, lv_pid=lv_pid,
                lv_xyz=_xyz(lam_i, torch.where(lv_valid, energy, 0.0)),
                lv_valid=lv_valid)


def lt_finalize_spawn_plain(u, usp, state, k2, dense_tab, light_tab,
                            spec_tab, lcdf_tab, a: LtArgs):
    """K34-LT v2 in plain torch -> [k4_rows_v2(cs), N] (the JAX package's
    `_lt_finalize_spawn_kernel`): the connections' shadow sweeps, RR, death,
    the in-kernel respawn of lanes with budget left and the light vertex's
    lens connection with its shadow sweep."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cs = a.cs
    aux = k4_aux_v2(cs)
    st = _state_in(state)
    out = torch.zeros((k4_rows_v2(cs), state.shape[1]), dtype=torch.float32,
                      device=state.device)
    conn_ct = _resolve_connections(k2, dense_tab, st["alive0"], out, cs)
    sp = _spawn_plain(a, usp, light_tab, spec_tab, lcdf_tab)
    lv_ok = sp["lv_valid"] & ~_sweep_any(dense_tab, sp["so_lv"],
                                         sp["dir_lv"], sp["tmax_lv"])
    cp, beta_next = _continue(k2, st, u[2 * cs + 3], a)
    hw = ~cp & (st["budget"] >= 0.5)
    _write_state(out, state, st, k2, cp, hw, beta_next, sp["o"], sp["d"],
                 sp["lam"], sp["beta"], sp["prev0"], hw & sp["alive"],
                 sp["pick_env"].float())
    lv_gate = lv_ok & hw
    out[aux["lv_pid"]] = torch.where(lv_gate, sp["lv_pid"], 0.0)
    for i in range(3):
        out[aux["lv_xyz"] + i] = torch.where(lv_gate, sp["lv_xyz"][i], 0.0)
    out[aux["resp"]] = hw.float()
    out[aux["bounce"]] = cp.float()
    out[aux["conn_ct"]] = conn_ct
    out[aux["lv_ct"]] = lv_gate.float()
    return out


def lt_finalize_plain(u, state, k2, feed, dense_tab, a: LtArgs):
    """K34-LT v1 in plain torch -> [k4_rows(cs), N] (the JAX package's
    `_lt_finalize_kernel`): the finalize of v2 with the new particle and the
    light vertex's lens connection taken from the spawn feed's rows."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cs = a.cs
    aux = k4_aux(cs)
    st = _state_in(state)
    out = torch.zeros((k4_rows(cs), state.shape[1]), dtype=torch.float32,
                      device=state.device)
    conn_ct = _resolve_connections(k2, dense_tab, st["alive0"], out, cs)
    f = feed
    lv_ok = (f[F_LV_VALID] > 0.5) & ~_sweep_any(
        dense_tab, V3(f[F_LV], f[F_LV + 1], f[F_LV + 2]),
        V3(f[F_LV + 3], f[F_LV + 4], f[F_LV + 5]), f[F_LV + 6])
    cp, beta_next = _continue(k2, st, u[2 * cs + 3], a)
    hw = ~cp & (st["budget"] >= 0.5)
    _write_state(out, state, st, k2, cp, hw, beta_next,
                 V3(f[F_O], f[F_O + 1], f[F_O + 2]),
                 V3(f[F_D], f[F_D + 1], f[F_D + 2]), f[F_LAM], f[F_BETA],
                 f[F_PREV], hw & (f[F_ALIVE] > 0.5), f[F_ENV])
    out[aux["lv_ok"]] = (lv_ok & hw).float()
    out[aux["resp"]] = hw.float()
    out[aux["bounce"]] = cp.float()
    out[aux["conn_ct"]] = conn_ct
    return out


# ---------------------------------------------------------- CUDA wrappers


def _lib():
    from pathtracer_tpu_torch.kernels import _build

    lib = _build.library()
    if lib.lt_args_size() != ctypes.sizeof(_CLtArgs):
        raise RuntimeError("_CLtArgs does not mirror struct LtArgs of "
                           "csrc/lt_round.cu")
    return lib


def _check(scene: LtScene, u, state, film, rows: dict):
    """The round's tensors: f32, contiguous, 2-D, on one device, with the
    row counts the kernels read and write; the film [width * height, 3]."""
    t = scene.tabs
    mk._check_tensors(u=u, state=state, film=film, dense_tab=t.dense_tab,
                      **{k: v for k, (v, _) in rows.items()})
    if film.shape != (int(scene.a.width) * int(scene.a.height), 3):
        raise ValueError(f"film must be [width * height, 3], got "
                         f"{tuple(film.shape)}")
    n = state.shape[1]
    if state.shape[0] != NS_LT:
        raise ValueError(f"state must be [{NS_LT}, N], got "
                         f"{tuple(state.shape)}")
    if u.shape[1] != n or u.shape[0] < 2 * scene.a.cs + 4:
        raise ValueError(f"u must be [>= {2 * scene.a.cs + 4}, {n}], got "
                         f"{tuple(u.shape)}")
    for name, (x, r) in rows.items():
        if x.shape != (r, n):
            raise ValueError(f"{name} must be [{r}, {n}], got "
                             f"{tuple(x.shape)}")
    dense = t.dense_tab
    if dense.shape[1] != 128 or dense.shape[0] > mk.MEGA_MAX_PRIMS \
            or dense.shape[0] % PBF:
        raise NotImplementedError(_NOT_IN_GATE)


def _splat(film, pid_rows, xyz_rows):
    """One scatter-add of splat families' rows into the film (the twins'
    splat; an empty row adds +0.0 to pixel 0)."""
    pid = torch.cat(pid_rows).long()
    xyz = torch.stack([torch.cat([r[i] for r in xyz_rows]) for i in range(3)],
                      dim=-1)
    film.index_add_(0, pid, xyz)


def lt_shade(u, state, scene: LtScene, film):
    """K12-LT -> Q rows [q2_rows(cs), N], and the direct lens-hit splats
    added to `film` [width * height, 3]: the CUDA kernel on CUDA tensors, the plain twin and its rows' `index_add_` on CPU tensors. The
    kernel walks the scene's compact `sweep_tab`, resident in shared memory
    up to `megakernel.SWEEP_RESIDENT_ROWS` rows, else through the ring of
    tiles."""
    global SHADE_LAUNCHES
    t, a = scene.tabs, scene.a
    _check(scene, u, state, film, {})
    mk._check_tensors(state=state, prim_tab=t.prim_tab, mat_tab=t.mat_tab,
                      spec_tab=t.spec_tab)
    sweep = mk._sweep_tab(t)
    if state.device.type == "cpu":
        q = lt_shade_plain(u, state, t.dense_tab, t.prim_tab, t.mat_tab,
                           t.spec_tab, a)
        _splat(film, [q[Q_HIT_PID]], [q[Q_HIT_XYZ:Q_HIT_XYZ + 3]])
        return q
    lib = _lib()
    n = state.shape[1]
    q = torch.empty((q2_rows(a.cs), n), dtype=torch.float32,
                    device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.lt_shade_launch(
        mk._ptr(u), mk._ptr(state), mk._ptr(q), mk._ptr(film), n,
        mk._ptr(sweep), sweep.shape[0], mk.SWEEP_RESIDENT_ROWS,
        mk._ptr(t.prim_tab), t.prim_tab.shape[1],
        mk._ptr(t.mat_tab), mk._ptr(t.spec_tab), ctypes.byref(cargs),
        ctypes.c_void_p(stream))
    mk._raise_on(rc, "lt_shade")
    SHADE_LAUNCHES += 1
    return q


def lt_finalize_spawn(u, usp, state, k2, scene: LtScene, film):
    """K34-LT v2 -> [k4_rows_v2(cs), N], and the unblocked connections' and
    the light vertices' splats added to `film`: the CUDA kernel on
    CUDA tensors, the plain twin and its rows' `index_add_` on CPU tensors.
    The kernel walks the sweep table as `lt_shade` does, every shadow ray
    of a lane in one walk."""
    global FINALIZE_SPAWN_LAUNCHES
    t, a = scene.tabs, scene.a
    if scene.lcdf_tab is None:
        raise ValueError("the scene was baked for the spawn feed (v1)")
    _check(scene, u, state, film,
           dict(usp=(usp, NUSP), k2=(k2, q2_rows(a.cs))))
    mk._check_tensors(state=state, light_tab=t.light_tab, spec_tab=t.spec_tab,
                      lcdf_tab=scene.lcdf_tab)
    sweep = mk._sweep_tab(t)
    if state.device.type == "cpu":
        out = lt_finalize_spawn_plain(u, usp, state, k2, t.dense_tab,
                                      t.light_tab, t.spec_tab,
                                      scene.lcdf_tab, a)
        rows = [K4_CONN + 4 * ci for ci in range(a.cs)] + [
            k4_aux_v2(a.cs)["lv_pid"]]
        _splat(film, [out[b] for b in rows],
               [out[b + 1:b + 4] for b in rows])
        return out
    lib = _lib()
    n = state.shape[1]
    out = torch.empty((k4_rows_v2(a.cs), n), dtype=torch.float32,
                      device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.lt_finalize_spawn_launch(
        mk._ptr(u), mk._ptr(usp), mk._ptr(state), mk._ptr(k2), mk._ptr(out),
        mk._ptr(film), n, mk._ptr(sweep), sweep.shape[0],
        mk.SWEEP_RESIDENT_ROWS, mk._ptr(t.light_tab), mk._ptr(t.spec_tab),
        mk._ptr(scene.lcdf_tab), ctypes.byref(cargs), ctypes.c_void_p(stream))
    mk._raise_on(rc, "lt_finalize_spawn")
    FINALIZE_SPAWN_LAUNCHES += 1
    return out


def lt_finalize(u, state, k2, feed, scene: LtScene, film):
    """K34-LT v1 -> [k4_rows(cs), N] from the spawn feed's rows, and the
    splats added to `film` as `lt_finalize_spawn` adds them (the
    light vertex's from the feed's rows): the CUDA kernel on CUDA tensors,
    the plain twin and its rows' `index_add_` on CPU tensors. The kernel
    walks the sweep table as `lt_finalize_spawn` does."""
    global FINALIZE_LAUNCHES
    a = scene.a
    _check(scene, u, state, film,
           dict(k2=(k2, q2_rows(a.cs)), feed=(feed, NF)))
    sweep = mk._sweep_tab(scene.tabs)
    if state.device.type == "cpu":
        out = lt_finalize_plain(u, state, k2, feed, scene.tabs.dense_tab, a)
        gate = out[k4_aux(a.cs)["lv_ok"]]
        conns = [K4_CONN + 4 * ci for ci in range(a.cs)]
        _splat(film, [out[b] for b in conns] + [feed[F_LV + 7] * gate],
               [out[b + 1:b + 4] for b in conns]
               + [feed[F_LV + 8:F_LV + 11] * gate])
        return out
    lib = _lib()
    n = state.shape[1]
    out = torch.empty((k4_rows(a.cs), n), dtype=torch.float32,
                      device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.lt_finalize_launch(
        mk._ptr(u), mk._ptr(state), mk._ptr(k2), mk._ptr(feed), mk._ptr(out),
        mk._ptr(film), n, mk._ptr(sweep), sweep.shape[0],
        mk.SWEEP_RESIDENT_ROWS, ctypes.byref(cargs), ctypes.c_void_p(stream))
    mk._raise_on(rc, "lt_finalize")
    FINALIZE_LAUNCHES += 1
    return out


# ------------------------------------------------------------ the feeds


def stratify_usp(settings, usp, perm):
    """`integrator.lt.stratify_u0` on the row-major spawn uniforms (rows 1
    and 2 the emitter surface uv, row 3 the λ stratum)."""
    n = usp.shape[1]
    suv, slam = settings.strata_uv, settings.strata_lam
    cells = suv * suv * slam
    cid = perm[torch.arange(n, device=usp.device) % cells]
    usp = usp.clone()
    usp[1] = fdiv((cid % suv).float() + usp[1], float(suv))
    usp[2] = fdiv(((cid // suv) % suv).float() + usp[2], float(suv))
    usp[3] = fdiv((cid // (suv * suv)).float() + usp[3], float(slam))
    return usp


def lt_spawn_feed(world, camera, settings, u0, uc, width, height,
                  has_proxy=None):
    """The v1 respawn rows [NF, N] (the JAX package's `_lt_spawn_feed`,
    plain torch on the lanes' device): a candidate particle per lane from
    `spawn_particles` on the spawn columns u0 [N, 9] (stratified by the
    caller), and the light vertex's lens connection from
    `_connect_to_camera_values` on the lens columns uc [N, 2] (`has_proxy`
    as there)."""
    from pathtracer_tpu_torch.integrator.lt import (
        _connect_to_camera_values,
        spawn_particles,
    )

    sp = spawn_particles(world, settings, u0)
    lv = _connect_to_camera_values(world, camera, sp, uc, has_proxy)
    valid = lv["valid"] & ~sp["pick_env"] & (int(world.n_lights) > 0)
    e = torch.where(valid, lv["energy"], 0.0)
    xyz = _xyz(sp["lam_i"], e)
    px = torch.clamp((lv["film_u"] * width).to(torch.int32), 0, width - 1)
    py = torch.clamp((lv["film_v"] * height).to(torch.int32), 0, height - 1)
    rows = [*sp["o"], *sp["d"], sp["lam"], sp["beta"], sp["prev_pdf0"],
            sp["alive"].float(), sp["pick_env"].float(), *lv["so"],
            *lv["dir"], lv["tmax"], (py * width + px).float(), *xyz,
            valid.float()]
    f = torch.zeros((NF, u0.shape[0]), dtype=torch.float32, device=u0.device)
    f[:len(rows)] = torch.stack(rows)
    return f


# ----------------------------------------------------------- the rounds


def _count_splats(slot, *rows):
    """Sum into the f64 device scalar `slot` a round's valid splats: the
    entries of the splat rows `rows` (each [4 k, N]: pixel id, X, Y, Z of k
    families) whose pixel id or XYZ is not zero. An empty entry is all
    zeros, a pixel id is >= 0 and a valid splat's Y is > 0, so an entry is
    valid where its largest value is above 0: one `amax` a tensor, then one
    compare and one sum."""
    n = rows[0].shape[1]
    top = torch.empty((sum(r.shape[0] for r in rows) // 4, n),
                      dtype=rows[0].dtype, device=rows[0].device)
    i = 0
    for r in rows:
        k = r.shape[0] // 4
        torch.amax(r.view(k, 4, n), 1, out=top[i:i + k])
        i += k
    torch.sum(top > 0.0, (0, 1), dtype=torch.float64, out=slot)


def lt_round_v2(state, scene: LtScene, settings, uniforms, it: int, film,
                added=None):
    """One v2 round: K12-LT, then K34-LT with in-kernel spawning, each
    adding its valid splats to the film -> (out [k4_rows_v2(cs), N], q
    rows, counter row sums). `added` (tracing only): the f64 device scalar
    that gets the round's valid splats."""
    a = scene.a
    n_pad, dev = state.shape[1], state.device
    u = uniforms.round(it, nu_lt(a.cs), n_pad, dev, stream=STREAM_U)
    usp = uniforms.round(it, NUSP, n_pad, dev, stream=STREAM_SPAWN)
    if settings.stratified:
        cells = settings.strata_uv ** 2 * settings.strata_lam
        usp = stratify_usp(settings, usp, uniforms.permutation(
            it, cells, dev, stream=STREAM_SPAWN))
    q = lt_shade(u, state, scene, film)
    out = lt_finalize_spawn(u, usp, state, q, scene, film)
    aux = k4_aux_v2(a.cs)
    if added is not None:
        _count_splats(added, q[Q_HIT_PID:Q_HIT_XYZ + 3],
                      out[K4_CONN:aux["lv_xyz"] + 3])
    counts = torch.stack([out[aux["bounce"]],
                          out[aux["conn_ct"]] + out[aux["lv_ct"]],
                          out[aux["resp"]]])
    return out, q, counts


def lt_round_v1(state, scene: LtScene, settings, uniforms, it: int, film,
                added=None):
    """One v1 round: K12-LT, the torch spawn feed, K34-LT from the feed,
    each kernel adding its valid splats to the film -> (out [k4_rows(cs),
    N], q rows, counter row sums); `added` as `lt_round_v2`'s."""
    a = scene.a
    n_pad, dev = state.shape[1], state.device
    u = uniforms.round(it, nu_lt(a.cs), n_pad, dev, stream=STREAM_U)
    q = lt_shade(u, state, scene, film)
    with prof.span("feed"):
        feed = spawn_feed_for(scene, settings, uniforms, it, n_pad)
    out = lt_finalize(u, state, q, feed, scene, film)
    aux = k4_aux(a.cs)
    gate = out[aux["lv_ok"]]
    if added is not None:
        _count_splats(added, q[Q_HIT_PID:Q_HIT_XYZ + 3],
                      out[K4_CONN:K4_CONN + 4 * a.cs],
                      feed[F_LV + 7:F_LV + 11] * gate)
    counts = torch.stack([out[aux["bounce"]], out[aux["conn_ct"]] + gate,
                          out[aux["resp"]]])
    return out, q, counts


def spawn_feed_for(scene: LtScene, settings, uniforms, it: int, n_pad: int):
    """The spawn feed of round `it` on its uniform columns."""
    dev = scene.tabs.dense_tab.device
    u0 = uniforms.lanes(it, 9, n_pad, dev, stream=STREAM_SPAWN)
    if settings.stratified:
        from pathtracer_tpu_torch.integrator.lt import stratify_u0

        cells = settings.strata_uv ** 2 * settings.strata_lam
        u0 = stratify_u0(settings, u0, uniforms.permutation(
            it, cells, dev, stream=STREAM_SPAWN))
    uc = uniforms.lanes(it, 2, n_pad, dev, stream=STREAM_LENS)
    return lt_spawn_feed(scene.world, scene.camera, settings, u0, uc,
                         int(scene.a.width), int(scene.a.height),
                         scene.a.has_proxy)


# counter slots of a round's counter rows (bounce, camera, light)
_SLOTS = (prof.BOUNCE_RAYS, prof.CAMERA_RAYS, prof.LIGHT_RAYS)


def lt_init(n_paths: int, device):
    """The initial state [NS_LT, n_pad]: every lane dead with its particle
    budget, n_lanes = min(n_paths, 2^20), the remainder on the first lanes
    -> (state, b_each)."""
    n_lanes = min(n_paths, 1 << 20)
    n_pad = -(-n_lanes // mk.TILE) * mk.TILE
    b_each, rem = divmod(n_paths, n_lanes)
    budget = torch.zeros(n_pad, dtype=torch.float32, device=device)
    budget[:n_lanes] = float(b_each)
    budget[:rem] += 1.0
    state = torch.zeros((NS_LT, n_pad), dtype=torch.float32, device=device)
    state[LS_BUDGET] = budget
    return state, b_each


def lt_trace_mega(world, camera, settings, width: int, height: int,
                  n_paths: int, uniforms, device=None, spawn_inkernel=None,
                  stats=None):
    """Trace `n_paths` light particles -> (film [width * height, 3] XYZ
    splat sum, counters f64[5]), on `device` (default: the world's). Every
    lane spawns its budget of particles, so exactly n_paths are spawned.
    `spawn_inkernel` False forces the spawn-feed route (v1) on a scene that
    v2 takes. A `stats` dict, if given, gets "rounds" and "lt_round" (the
    K34-LT route, "v2" or "v1")."""
    why = lt_gate_refusal(world, camera, settings)
    if why is not None:
        raise NotImplementedError(why)
    return _lt_trace_mega(world, camera, settings, width, height, n_paths,
                          uniforms, device, spawn_inkernel, stats)


def _lt_trace_mega(world, camera, settings, width, height, n_paths,
                   uniforms, device, spawn_inkernel, stats):
    """`lt_trace_mega` on a scene that its gate has taken
    (`render_splatted` evaluates the gate once a call)."""
    if width * height >= (1 << 24):
        raise ValueError("the film's pixel ids ride f32 rows: width * height "
                         "must be below 2^24")
    device = torch.device(device) if device is not None \
        else world.prims.pa.device
    with prof.span("bake"):
        scene = _bake_lt_scene(world, camera, settings, width, height,
                               device, spawn_inkernel)
    state, b_each = lt_init(n_paths, device)
    film = torch.zeros((width * height, 3), dtype=torch.float32,
                       device=device)
    counters = torch.zeros(prof.N_COUNTERS, dtype=torch.float64,
                           device=device)
    lt_round = lt_round_v2 if scene.spawn_inkernel else lt_round_v1
    max_iters = int((b_each + 1) * settings.max_bounces * 4 + 64)
    added = mk.per_round(max_iters, device)  # the valid splats of each round

    def step(it):
        nonlocal state
        out, _, counts = lt_round(state, scene, settings, uniforms, it, film,
                                  None if added is None else added[it])
        state = out[:NS_LT]
        return counts

    rounds = mk.run_rounds(
        step, lambda: state[LS_ALIVE] > 0.5,
        lambda: (state[LS_ALIVE] + state[LS_BUDGET]) > 0.5, counters, _SLOTS,
        max_iters, stats)
    if added is not None:
        # the entries the round's splat would take with every empty row,
        # and the valid splats the kernels add
        prof.count("splat_slots", [(scene.a.cs + 2) * state.shape[1]] * rounds)
        prof.count("splats_added", added[:rounds])
    if stats is not None:
        stats["lt_round"] = "v2" if scene.spawn_inkernel else "v1"
    return film, counters
