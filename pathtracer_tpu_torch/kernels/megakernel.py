"""The regen path tracer's bounce round on the H100 (counterpart of
`pathtracer_tpu.kernels.megakernel`).

One round takes every lane (one per pixel) one bounce further: closest hit,
emission and environment adds with MIS, next-event estimation with shadow
sweeps, BSDF sampling with hero-wavelength spectral MIS, Russian roulette,
XYZ accumulation on death and a thin-lens respawn of the lane's next camera
sample. The lane state is `[NS=32, n_pad]` f32 rows (`S_*` below); a round
reads it and writes `[NK4=40, n_pad]`: the 32 new state rows plus per-lane
counter rows. A round takes one of three routes, as the JAX package's
`pt_trace_regen_mega` picks them:

- the fused round (`fused_round`, `csrc/fused_round.cu`): one kernel, for
  scenes of at most 4 chunks of 32 prims under a constant environment and
  without uv-dependent surface textures;
- the texture-feed round for scenes with uv-dependent lambertian
  reflectance: `dense.sweep_closest_rows` (K1: closest hit -> `[8, n_pad]`
  rows t, prim id) -> `env_feed` (Sun and HDR only) -> `tex_feed`
  (`csrc/tex_feed.cu`: each lane's uv and texture value at its λs) ->
  `shade` (K2: shading from the hit rows) -> `finalize_sweep` (K34);
- the two-program round for every other scene in the gate (up to 8192
  prims; constant, Sun and HDR environments; medium-aware transport):
  `env_feed` (torch, Sun and HDR only) and `med_feed` (torch, medium-aware
  settings only) -> `shade_sweep` (K12: closest hit + shading, writing the
  `[k2_rows(ls), n_pad]` K2 rows `O_*`) -> `finalize_sweep` (K34: NEE shadow
  sweeps + finalize). K2, K12 and K34 are in `csrc/two_prog_round.cu`.
  K12 and K34 walk the compact `sweep_tab` (64-byte rows with a rect's
  normal and edge norms baked in) from shared memory (`csrc/walk.cuh`):
  whole where it has at most `SWEEP_RESIDENT_ROWS` rows, else through a
  ring of tiles. The fused round walks it too (always whole: at most 128
  rows), and so do K1, K3 and the light tracer's K12-LT and K34-LT
  (`kernels/lt_mega.py`), at the same budget; every twin reads
  `dense_tab`.

`stepper="split"` runs every scene of the gate through the split round
instead (`split_round`, the JAX package's five-program pipeline): K1 ->
the feeds -> K2 -> `dense.sweep_any_rows` (K3, once per NEE sample) ->
`finalize` (K4: the finalize fed K3's blocked masks). It renders the same
film as the default routes bit for bit.

Medium-aware transport (`settings.medium_aware`) tracks a stack of up to
four media per lane in the packed state rows `S_MSTK0/1`. `med_feed` turns
the stack, the lane's λs and direction and four more uniform rows into the
free-flight distance, the σ sums, the scatterer's phase parameters and the
phase-sampled direction; K12/K2 decide scatter against surface, weight the
throughput by Beer-Lambert, shade a scatter point with the phase function
and move the stack across boundaries; K34/K4 continue from the scatter.

Each wrapper launches its CUDA kernel on CUDA tensors and runs its plain
torch twin (`fused_round_plain`, `shade_sweep_plain`, `shade_plain`,
`finalize_sweep_plain`, `finalize_plain`) on CPU tensors. Outputs are
second buffers, not in-place updates, so a kernel and its twin can run on
the same input. Random numbers come from outside the kernels: the render
loop draws uniform blocks per round from a uniform source
(`TorchUniforms`, or a test's replay of the JAX draws).

Scope (`gate_refusal`): projective camera, identity transforms, at most
8192 prims, 24 materials and 16 lights; multi-texel textures only as a
lambertian's reflectance or the HDR map; medium-aware settings with at
most 16 media. `renderer/persistent.py:render_regen` renders every other
scene through the regen integrator without kernels
(`integrator/pt_regen.py`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from pathtracer_tpu_torch.core import cie, spectral
from pathtracer_tpu_torch.geometry.soa import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
)
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels.cmath import V3, fdiv
from pathtracer_tpu_torch.kernels.dense import (
    PBF,
    check_sweep,
    pack_prims_np,
    pack_sweep_np,
    sweep_any_cols,
    sweep_any_rows,
    sweep_closest_cols,
    sweep_closest_rows,
)
from pathtracer_tpu_torch.materials.tables import (
    MAT_DIFFUSE_LIGHT,
    MAT_GGX,
    MAT_LAMBERTIAN,
    MAT_PASSTHROUGH,
    MAT_SHARP_LIGHT,
)
from pathtracer_tpu_torch.mediums.tables import (
    MED_RAYLEIGH,
    medium_coefficients,
    phase_eval,
    phase_sample,
)
from pathtracer_tpu_torch.prelude import (
    INTERSECTION_TIME_OFFSET,
    NORMAL_OFFSET,
    RAY_TMAX,
    TransportMode,
)
from pathtracer_tpu_torch.textures.texture import eval_texture
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.world.environment import (
    ENV_CONSTANT,
    ENV_HDR,
    env_emission,
    env_pdf_for,
    env_sample_uv,
    rotate,
)

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
# the tracked-medium stack: 4 medium ids packed two to a row as
# id_even + 256 * id_odd (ids < 256, so exact in f32); 0 rows = vacuum
S_MSTK0, S_MSTK1 = 30, 31
NS = 32

# ---- round output rows: new state + per-lane counter indicators
O4_BOUNCE_CT = NS
O4_CAMERA_CT = NS + 1
O4_SHADOW_CT = NS + 2
O4_ENV_CT = NS + 3
NK4 = NS + 8

# ---- K2 rows [k2_rows(ls), N]: what K12 hands K34. Surface rows hold 0 on
# lanes that are not at a surface, and a dead lane's rows are all 0.
O_RAD = 0          # 4: path radiance after the emission/environment adds
O_AT_SURF = 4
O_ENV_CT = 5
O_SHADOW_CT = 6
O_FPDF = 7
O_SAMPLE_OK = 8
O_RATIO = 9        # 4: throughput ratios of the BSDF sample
O_ONEW = 13        # 3
O_DNEW = 16        # 3
O_PSCALE = 19      # 4: per-lane pdf ratio p_c/p_0 at the sampled direction
# the medium branch's rows (0 unless the settings are medium-aware)
O_SCAT = 23        # the lane scattered in a medium before its surface hit
O_MEDW = 24        # 4: free-flight lane weights on the throughput
O_MSTK = 28        # 2: the packed medium stack after a boundary crossing
O_NEE = 30         # per light sample: so(3) dir(3) tmax worth contrib(4)
NEE_ROWS = 12
NU4 = 8            # K34's uniform rows: 1 (RR) + 5 (respawn), padded

MEGA_MAX_PRIMS = 8192  # the megakernel gate
# The kernels that walk the sweep table from dynamic shared memory (K12,
# K34, K1, K3, K12-LT, K34-LT, the dense sweeps of World.intersect /
# intersect_any) keep a table of at most this many rows whole
# in a block's shared memory: 576 rows x 64 B = 36 KB, the largest table that
# costs none of the six 128-thread blocks an SM holds of K12 and K34 (the
# ring takes 24 KB). A larger table goes through the ring of csrc/walk.cuh:
# on the card a resident table that cut the blocks to two ran 1.6-1.8x
# slower than the ring, while the ring costs 3-5% where the table would
# fit. At most 3584 (224 KB).
SWEEP_RESIDENT_ROWS = 576
FUSED_MAX_CHUNKS = 4  # the fused round's gate: at most 4 chunks of 32 prims

# prim_tab rows (0..10 are the dense table's columns)
_R_NA, _R_NB, _R_NC = 11, 14, 17
_R_MAT, _R_KIND, _R_AREA = 20, 21, 22
_NP_ROWS = 24

# mat_tab rows; _M_TEXF is 1 where a lambertian's reflectance comes from
# the texture feed
(_M_TYPE, _M_ALPHA, _M_METAL, _M_PERM, _M_SIDE, _M_SHARP, _M_RSCALE,
 _M_TEXF) = range(8)
_M_INNER, _M_OUTER = 8, 9
_NM_ROWS = 16

# light_tab rows
_L_PA, _L_PB, _L_PC = 0, 3, 6
_L_PTYPE, _L_AREA, _L_MAT, _L_MTYPE, _L_SIDE, _L_SHARP = 9, 10, 11, 12, 13, 14
_NL_ROWS = 16

# launches of the CUDA kernels (SHADE_LAUNCHES: K12, K2_LAUNCHES: K2,
# FINALIZE_LAUNCHES: K34, K4_LAUNCHES: K4, TEX_FEED_LAUNCHES: the texture
# feed, TEX_LUT_LAUNCHES: the bake of its pair table), and calls of any
# plain twin (the K1 and K3 rows sweeps count in kernels/dense.py)
FUSED_LAUNCHES = 0
SHADE_LAUNCHES = 0
K2_LAUNCHES = 0
FINALIZE_LAUNCHES = 0
K4_LAUNCHES = 0
TEX_FEED_LAUNCHES = 0
TEX_LUT_LAUNCHES = 0
PLAIN_CALLS = 0

_NOT_IN_GATE = ("the megakernel takes projective cameras, identity "
                "transforms, at most 8192 prims, 24 materials and 16 lights "
                "and spectral curves of 512 knots; render_regen renders "
                "other scenes through the regen integrator without kernels "
                "(integrator/pt_regen.py, ROADMAP §1 item 5)")
_TOO_MANY_MEDIA = ("medium-aware transport takes at most 16 media: the "
                   "medium feed gathers each medium's curves per lane; "
                   "render_regen renders larger tables through the regen "
                   "integrator without kernels (integrator/pt_regen.py, "
                   "ROADMAP §1 item 5)")
MAX_MEDIA = 16
_NOT_FUSED = ("the fused round takes at most 4 chunks of 32 prims under a "
              "constant environment without uv textures; other scenes ride "
              "the two-program or the texture-feed round")


def nu_rows(light_samples: int) -> int:
    """The fused round's uniform rows: 3 per NEE sample + 3 (BSDF) + 1 (RR)
    + 5 (respawn), padded to a multiple of 8."""
    return -(-(3 * light_samples + 9) // 8) * 8


def n_u_rows(light_samples: int, medium: bool = False) -> int:
    """K12's uniform rows: 3 per NEE sample + 3 (BSDF) + 4 when
    medium-aware (free flight, scatterer pick, phase u1 and u2), padded."""
    return -(-(3 * light_samples + 3 + (4 if medium else 0)) // 8) * 8


def k2_rows(light_samples: int) -> int:
    return -(-(O_NEE + NEE_ROWS * light_samples) // 8) * 8


def tf_rows(c_lanes: int) -> int:
    """Texture-feed rows: C per-lane reflectance values, padded."""
    return -(-c_lanes // 8) * 8


def ef_rows(light_samples: int, c_lanes: int) -> int:
    """Environment-feed rows (Sun and HDR only): C escape-emission rows + 1
    escape-pdf row, then per NEE sample dir(3) + pdf + C emission rows."""
    return -(-((c_lanes + 1) + light_samples * (4 + c_lanes)) // 8) * 8


def mf_idx(c_lanes: int) -> dict:
    """Row offsets of the medium-feed block for C λ lanes."""
    C = c_lanes
    i = {"flight": 0,       # free-flight distance at the hero σ_s (vacuum: 3e38)
         "sigt": 1,         # C: Σ σ_t over the tracked stack, per λ
         "sigs": 1 + C,     # C: Σ σ_s
         "ssh": 1 + 2 * C}  # the hero Σ σ_s (the flight's rate)
    i["wo"] = i["ssh"] + 1      # 3: the phase-sampled continuation direction
    i["phpdf"] = i["wo"] + 3    # the hero phase pdf at that direction
    i["phs"] = i["phpdf"] + 1   # C: companion / hero phase ratio (lane 0 = 1)
    i["g"] = i["phs"] + C       # C: the scatterer's HG g per λ
    i["isray"] = i["g"] + C     # the scatterer is Rayleigh
    i["inmed"] = i["isray"] + 1  # any tracked medium is not vacuum
    i["n"] = i["inmed"] + 1
    return i


def mf_rows(c_lanes: int) -> int:
    return -(-mf_idx(c_lanes)["n"] // 8) * 8


def _unpack_stack_rows(r0, r1):
    """The 4 medium ids of the two packed state rows (f32 each)."""
    return [torch.remainder(torch.floor(r0 + 0.5), 256.0),
            torch.floor(fdiv(r0 + 0.5, 256.0)),
            torch.remainder(torch.floor(r1 + 0.5), 256.0),
            torch.floor(fdiv(r1 + 0.5, 256.0))]


# ------------------------------------------------------------------ gate


def gate_refusal(world, camera, settings):
    """Why the megakernel does not render this scene, or None if it does
    (the JAX package's `mega_available`), recorded as a `gate` span.
    `settings` None is surface transport."""
    medium = settings is not None and settings.medium_aware
    return scene_refusal(world, camera, _NOT_IN_GATE, max_lights=16,
                         textured=True,
                         max_media=MAX_MEDIA if medium else None)


def scene_refusal(world, camera, why: str, max_lights: int, textured: bool,
                  max_media: int | None = None):
    """The megakernels' scene gate, recorded as a `gate` span -> `why` for
    a scene outside it, `_TOO_MANY_MEDIA` for more than `max_media` media,
    else None. It takes projective cameras, identity transforms, at most
    MEGA_MAX_PRIMS prims, 24 materials and `max_lights` lights, curves of
    SPEC_RES knots, and multi-texel or multi-layer textures only as the HDR
    map (the environment feed) or, where `textured`, as a lambertian's
    reflectance (the texture feed); any other texture is one 1x1 layer,
    baked into the material tables. The path tracer's gate and the light
    tracer's (`lt_mega.lt_gate_refusal`) differ only in what they pass."""
    from pathtracer_tpu_torch.camera.projective import ProjectiveCamera

    with prof.span("gate"):
        w = world
        if max_media is not None and int(w.mediums.count) > max_media:
            return _TOO_MANY_MEDIA
        if not isinstance(camera, ProjectiveCamera) \
                or int(w.prims.xf_inv.shape[0]) != 1 \
                or w.prims.count > MEGA_MAX_PRIMS \
                or int(w.mats.count) > 24 \
                or int(w.n_lights) > max_lights \
                or int(w.bank.values.shape[1]) != SPEC_RES:
            return why
        t = w.tex
        lc, lstart = _np(t.layer_count), _np(t.layer_start)
        lw, lh = _np(t.layer_w), _np(t.layer_h)
        tex_ok = np.ones(lc.shape[0], bool)
        layer_ok = np.ones(lw.shape[0], bool)

        def exempt(tid):
            tex_ok[tid] = False
            layer_ok[int(lstart[tid]):int(lstart[tid]) + int(lc[tid])] = False

        if int(w.env.kind) == ENV_HDR:
            exempt(int(w.env.tex_id))
        if textured:
            mtype, tex_id = _np(w.mats.mtype), _np(w.mats.tex_id)
            for i in range(int(w.mats.count)):
                if mtype[i] == MAT_LAMBERTIAN and tex_id[i] >= 0:
                    exempt(int(tex_id[i]))
        if not (lc[tex_ok] == 1).all() or not (
                (lw[layer_ok] == 1).all() and (lh[layer_ok] == 1).all()):
            return why
        return None


def fused_ok(scene) -> bool:
    """The fused round's gate on a baked scene: the JAX driver's `fused_ok`
    without its environment levers (a constant environment, no texture or
    medium feed and at most 4 chunks)."""
    return scene.dense_tab.shape[0] // PBF <= FUSED_MAX_CHUNKS \
        and scene.consts["env_kind"] == ENV_CONSTANT \
        and not scene.consts["tex_feed"] and not scene.consts["medium"]


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
    env: object = None       # None (constant env) or the Sun/HDR EnvFeed
    tex: object = None       # None or the TexFeed of uv-textured lambertians
    med: object = None       # None or the MedFeed of medium-aware settings
    # f32[P_pad32, 16] compact sweep table (`dense.pack_sweep_np`): what K12
    # and K34 walk in shared memory; the twins keep reading dense_tab
    sweep_tab: torch.Tensor = None


@dataclasses.dataclass
class EnvFeed:
    """What `env_feed` needs of a Sun or HDR environment: the environment
    (scalars and matrices on the host, importance tables on the device),
    the curve bank, the textures and, for an HDR map of at most
    ENV_LUT_MAX_TEXELS texels, the baked (texel, λ-knot) emission table."""

    env: object
    bank: object
    tex: object
    lut: dict = None


@dataclasses.dataclass
class TexFeed:
    """What `tex_feed` needs of a scene with uv-textured lambertians: the
    textures and the curve bank on the device, each material's texture id
    (`mat2tex` f32[128]), the hit prim's vertices, type and material
    (`uvtab` f32[P_pad, 16] in the bake's sorted prim order: pa 0-2, pb 3-5,
    pc 6-8, ptype 9, material 10) and, for at most TEX_LUT_MAX_TEXELS
    texels in all, the baked (texel, λ-knot) pair table."""

    tex: object
    bank: object
    mat2tex: torch.Tensor
    uvtab: torch.Tensor
    lut: dict = None


@dataclasses.dataclass
class MedFeed:
    """What `med_feed` needs under medium-aware settings: the medium table
    and the curve bank on the device."""

    meds: object
    bank: object


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _layer_tables(tex):
    """The textures' layer tables on the host: start and count a texture,
    curve, offset, w and h a layer (numpy)."""
    return SimpleNamespace(**{k: _np(getattr(tex, "layer_" + k)) for k in
                              ("start", "count", "curve", "offset", "w",
                               "h")})


def build_mega_scene(world, camera, device=None, settings=None) -> MegaScene:
    """Host-side numpy bake of the round's tables, element for element the
    JAX package's `build_mega_scene` (without its chunk-AABB and fetch-table
    rows, which the port does not use), for a scene in the megakernel's
    gate. Medium-aware `settings` add the medium feed's tables and set
    `consts["medium"]`."""
    why = gate_refusal(world, camera, settings)
    if why is not None:
        raise NotImplementedError(why)
    return bake_mega_scene(world, camera, device, medium=bool(
        settings is not None and settings.medium_aware))


def bake_mega_scene(world, camera, device=None, feeds=True,
                    medium=False) -> MegaScene:
    """The bake without a gate: each caller applies its own (the light
    tracer's takes up to 128 lights and no uv textures). `feeds` False
    leaves out the environment and texture feeds, which only the regen
    rounds read; `medium` adds the medium feed of medium-aware settings."""
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
    # lambertian reflectance = 1x1 texel weight x layer curve, or per hit
    # from the texture feed (_M_TEXF; the row keeps layer 0's curve at
    # weight 1, a value no lane selects); lights reflect with their bounce
    # curve at weight 1
    tex = w.tex
    lay = _layer_tables(tex)
    atlas = _np(tex.atlas)
    mtype = hm["mtype"]
    tex_id = np.maximum(hm["tex_id"], 0)
    refl_curve = np.zeros(m, np.int64)
    refl_scale = np.ones(m, np.float32)
    texf = np.zeros(m, np.float32)
    for i in range(m):
        if mtype[i] == MAT_LAMBERTIAN:
            ti = int(tex_id[i])
            li = int(lay.start[ti])
            refl_curve[i] = int(lay.curve[li])
            if int(lay.count[ti]) > 1 or int(lay.w[li]) * int(lay.h[li]) > 1:
                texf[i] = 1.0
            else:
                refl_scale[i] = float(atlas[int(lay.offset[li])])
        else:
            refl_curve[i] = int(hm["bounce_idx"][i])
    mt[_M_RSCALE, :m] = refl_scale
    mt[_M_TEXF, :m] = texf

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
        tex_feed=bool(texf.any()),
        medium=bool(medium),
        radius=float(_np(w.radius)),
    )
    dense_tab = pack_prims_np(h["ptype"], h["valid"], h["pa"], h["pb"],
                              h["pc"])
    sweep_tab = pack_sweep_np(h["ptype"], h["valid"], h["pa"], h["pb"],
                              h["pc"])

    def dev(a):
        return torch.as_tensor(a, device=device)

    tex_d, bank_d = _to(tex, device), _to(w.bank, device)
    env = None
    if feeds and consts["env_kind"] != ENV_CONSTANT:
        # scalars and matrices stay on the host (the feed reads them as
        # Python numbers), the tables go where the lanes are
        host = ("kind", "strength", "curve_idx", "sun_direction",
                "sun_cos_angle", "tex_id", "rotation", "rotation_inv",
                "imp_baked")
        e = dataclasses.replace(w.env, **{
            f.name: getattr(w.env, f.name).to(
                "cpu" if f.name in host else device)
            for f in dataclasses.fields(w.env)})
        env = EnvFeed(env=e, bank=bank_d, tex=tex_d,
                      lut=_bake_env_lut(w.env, w.bank, w.tex, device))
    tex_feed_ = None
    if feeds and texf.any():
        uvtab = np.zeros((p_pad, 16), np.float32)
        uvtab[:p, 0:3] = h["pa"]
        uvtab[:p, 3:6] = h["pb"]
        uvtab[:p, 6:9] = h["pc"]
        uvtab[:p, 9] = h["ptype"]
        uvtab[:p, 10] = h["material_id"]
        mat2tex = np.zeros(128, np.float32)
        mat2tex[:m] = tex_id
        tex_feed_ = TexFeed(
            tex=tex_d, bank=bank_d, mat2tex=dev(mat2tex), uvtab=dev(uvtab),
            lut=_bake_tex_lut(bank_d, tex_d, sorted(
                {int(tex_id[i]) for i in range(m) if texf[i]}), device, lay))
    med = (MedFeed(meds=_to(w.mediums, device), bank=bank_d)
           if medium else None)
    return MegaScene(prim_tab=dev(tab), dense_tab=dev(dense_tab),
                     mat_tab=dev(mt), light_tab=dev(lt), spec_tab=dev(st),
                     consts=consts, env=env, tex=tex_feed_, med=med,
                     sweep_tab=dev(sweep_tab))


def _to(obj, device):
    """A dataclass of tensors with every tensor on `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


ENV_LUT_MAX_TEXELS = 16384  # the JAX package's cap of the full bake


def _bake_env_lut(env, bank, tex, device):
    """An HDR environment's layer weight maps and basis curves pre-combined
    into one (texel, λ-knot) pair table, so one emission eval is one gather
    (the JAX package's `_bake_env_lut`; exact up to f32 reassociation: the
    layer sum commutes with the λ lerp). None for maps over
    ENV_LUT_MAX_TEXELS texels or layers of different sizes."""
    if int(env.kind) != ENV_HDR:
        return None
    tid = int(env.tex_id)
    layer_start, layer_count = _np(tex.layer_start), _np(tex.layer_count)
    layer_w, layer_h = _np(tex.layer_w), _np(tex.layer_h)
    start, count = int(layer_start[tid]), int(layer_count[tid])
    w_, h_ = int(layer_w[start]), int(layer_h[start])
    if w_ * h_ > ENV_LUT_MAX_TEXELS or count < 1:
        return None
    values = _np(bank.values)
    res = values.shape[1]
    atlas, offset = _np(tex.atlas), _np(tex.layer_offset)
    curve = _np(tex.layer_curve)
    e = np.zeros((h_ * w_, res), np.float32)
    for li in range(start, start + count):
        if int(layer_w[li]) != w_ or int(layer_h[li]) != h_:
            return None
        off = int(offset[li])
        e += atlas[off:off + h_ * w_, None] * values[int(curve[li])][None, :]
    pairs = np.stack([e, np.concatenate([e[:, 1:], e[:, -1:]], axis=1)],
                     axis=-1).reshape(h_ * w_ * res, 2)
    return dict(pairs=torch.as_tensor(pairs, device=device), w=w_, h=h_,
                res=res, lam_lo=float(bank.lam_lo), lam_hi=float(bank.lam_hi))


TEX_LUT_MAX_TEXELS = 65536  # the JAX package's cap of the surface bake


def _bake_tex_lut(bank, tex, tex_ids, device, lay):
    """`_bake_env_lut` for the surface textures the feed evaluates (the JAX
    package's `_bake_tex_lut`): per texture, E[texel, λ-knot] = Σ_layers
    weight(texel) · curve(knot), all textures in one flat pair table with a
    (base, w, h, 0) row per texture id in `meta` i32[128, 4]. The layout
    comes from the host layer tables `lay` (`_layer_tables`) through
    `_tex_lut_plan`: None where it refuses (the feed then runs
    `eval_texture`). The table is written by `_bake_tex_lut_kernel` on
    CUDA, by `_bake_tex_lut_plain` elsewhere. While tracing, counts
    `tex_lut_bakes` (1 a table baked) and `tex_lut_bakes_kernel` (1 where
    the kernel baked it)."""
    plan = _tex_lut_plan(lay, tex_ids, bank.values.shape[1])
    if plan is None:
        return None
    kernel = torch.device(device).type == "cuda"
    lut = (_bake_tex_lut_kernel if kernel else _bake_tex_lut_plain)(
        bank, tex, plan, device)
    prof.count("tex_lut_bakes", 1)
    prof.count("tex_lut_bakes_kernel", int(kernel))
    return lut


def _tex_lut_plan(lay, tex_ids, res):
    """The pair table's layout, from the host layer tables `lay`: None for
    a texture without layers or with layers of unequal size, or more than
    TEX_LUT_MAX_TEXELS texels in all; else `meta` i32[128, 4], `texs`
    i32[T, 4] a baked texture in `tex_ids`' order (its first pair row,
    texels, first row of `layers`, layer count), `layers` i32[L, 2] a layer
    of theirs in order (atlas offset, curve row), and `n_pairs`."""
    meta = np.zeros((128, 4), np.int32)
    texs, layers = [], []
    base = 0
    for t in tex_ids:
        s, n = int(lay.start[t]), int(lay.count[t])
        if n < 1:
            return None
        w_, h_ = int(lay.w[s]), int(lay.h[s])
        if any(int(lay.w[li]) != w_ or int(lay.h[li]) != h_
               for li in range(s, s + n)):
            return None
        meta[t] = (base, w_, h_, 0)
        texs.append((base, w_ * h_, len(layers), n))
        layers += [(int(lay.offset[li]), int(lay.curve[li]))
                   for li in range(s, s + n)]
        base += w_ * h_ * res
    if base > TEX_LUT_MAX_TEXELS * res:
        return None
    return dict(meta=meta, texs=np.array(texs, np.int32).reshape(-1, 4),
                layers=np.array(layers, np.int32).reshape(-1, 2),
                n_pairs=base)


def _bake_tex_lut_kernel(bank, tex, plan, device=None):
    """The pair table of `plan` written on the card by
    `csrc/tex_feed.cu:tex_lut_bake_kernel` from `tex.atlas` and
    `bank.values` (CUDA tensors), with `meta` and the launch's tables
    copied to the card in one."""
    global TEX_LUT_LAUNCHES
    values, atlas = bank.values, tex.atlas
    res = values.shape[1]
    meta, texs, layers = plan["meta"], plan["texs"], plan["layers"]
    for name, x in (("atlas", atlas), ("values", values)):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device.type != "cuda":
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             "tensor")
    ends = layers[:, 0].astype(np.int64) + np.repeat(texs[:, 1], texs[:, 3])
    if ends.max() > atlas.numel() or layers[:, 1].max() >= values.shape[0]:
        raise ValueError("the layer tables point outside the atlas or the "
                         "curve bank")
    tabs = torch.as_tensor(np.concatenate(
        [meta.ravel(), texs.ravel(), layers.ravel()]), device=atlas.device)
    pairs = torch.empty((plan["n_pairs"], 2), dtype=torch.float32,
                        device=atlas.device)
    stream = torch.cuda.current_stream(atlas.device).cuda_stream
    rc = _lib().tex_lut_bake_launch(
        _ptr(atlas), _ptr(values), res, _ptr(tabs[meta.size:]),
        texs.shape[0], _ptr(tabs[meta.size + texs.size:]), plan["n_pairs"],
        _ptr(pairs), ctypes.c_void_p(stream))
    _raise_on(rc, "tex_lut_bake")
    TEX_LUT_LAUNCHES += 1
    return dict(pairs=pairs, meta=tabs[:meta.size].view(meta.shape), res=res,
                lam_lo=float(bank.lam_lo), lam_hi=float(bank.lam_hi))


def _bake_tex_lut_plain(bank, tex, plan, device):
    """The pair table of `plan` in numpy, texture by texture: E from zeros,
    `e += weight · curve` a layer, each row paired with the next knot's
    value (the last knot with its own). The twin of
    `tex_lut_bake_kernel`, and the bake on the CPU."""
    atlas, values = _np(tex.atlas), _np(bank.values)
    res = values.shape[1]
    segs = []
    for _, n, l0, nl in plan["texs"]:
        e = np.zeros((n, res), np.float32)
        for off, curve in plan["layers"][l0:l0 + nl]:
            e += atlas[off:off + n, None] * values[curve][None, :]
        segs.append(np.stack([e, np.concatenate([e[:, 1:], e[:, -1:]],
                                                axis=1)],
                             axis=-1).reshape(n * res, 2))
    return dict(pairs=torch.as_tensor(np.concatenate(segs), device=device),
                meta=torch.as_tensor(plan["meta"], device=device), res=res,
                lam_lo=float(bank.lam_lo), lam_hi=float(bank.lam_hi))


def env_emission_lut(env, lut, d: V3, lam):
    """HDR emission through the baked pair table: nearest texel, λ lerp
    (the JAX package's `_env_emission_lut`)."""
    u, v = cmath.direction_to_uv(rotate(env.rotation, d))
    w_, h_, res = lut["w"], lut["h"], lut["res"]
    x = torch.clamp((torch.clamp(u, 0.0, 1.0 - 1e-6) * w_).long(), max=w_ - 1)
    y = torch.clamp((torch.clamp(v, 0.0, 1.0 - 1e-6) * h_).long(), max=h_ - 1)
    uu = fdiv(lam - lut["lam_lo"], lut["lam_hi"] - lut["lam_lo"]) * (res - 1)
    uu = torch.clamp(uu, 0.0, res - 1 - 1e-4)
    i0 = uu.long()
    frac = uu - i0.float()
    vp = lut["pairs"][(y * w_ + x) * res + i0]
    return float(env.strength) * (vp[..., 0] * (1.0 - frac)
                                  + vp[..., 1] * frac)


def env_feed(feed: EnvFeed, state, u, light_samples: int, c_lanes: int):
    """The per-lane environment rows K12 reads for a Sun or HDR environment
    -> ef [ef_rows(ls, C), n_pad] (the JAX package's `_env_feed`, plain
    torch on the lanes' device): the escape emission of each λ lane and the
    escape pdf from the ray direction, then per NEE sample the sampled
    direction, its pdf and its emission. An HDR map without a baked table
    is evaluated through `eval_texture`."""
    env = feed.env
    if feed.lut is not None:
        def emit(dd, ll):
            return env_emission_lut(env, feed.lut, dd, ll)
    else:
        def emit(dd, ll):
            return env_emission(env, feed.bank, feed.tex, dd, ll)
    d = V3(state[S_D], state[S_D + 1], state[S_D + 2])
    lam = [state[S_LAM + ci] for ci in range(c_lanes)]
    rows = [emit(d, lam[ci]) for ci in range(c_lanes)]
    rows.append(env_pdf_for(env, d))
    for si in range(light_samples):
        nd, npdf = env_sample_uv(env, u[3 * si + 1], u[3 * si + 2])
        rows += [nd.x, nd.y, nd.z, npdf]
        rows += [emit(nd, lam[ci]) for ci in range(c_lanes)]
    ef = torch.zeros((ef_rows(light_samples, c_lanes), state.shape[1]),
                     dtype=torch.float32, device=state.device)
    ef[:len(rows)] = torch.stack(rows)
    return ef


def tex_feed(feed: TexFeed, state, tp, c_lanes: int):
    """The per-lane reflectance rows K2 reads for uv-textured lambertians ->
    tf [tf_rows(C), n_pad]: `csrc/tex_feed.cu` on CUDA tensors where the
    bake produced the pair table (`feed.lut`), `tex_feed_plain` on CPU
    tensors and without a table (the `eval_texture` chain). While tracing,
    counts `tex_feeds` (calls) and `tex_feeds_kernel` (those the kernel
    served)."""
    global TEX_FEED_LAUNCHES
    lut = feed.lut
    kernel = state.device.type == "cuda" and lut is not None
    prof.count("tex_feeds", 1)
    prof.count("tex_feeds_kernel", int(kernel))
    if not kernel:
        return tex_feed_plain(feed, state, tp, c_lanes)
    _check_tensors(state=state, tp=tp)
    n = state.shape[1]
    rows = tf_rows(c_lanes)
    if state.shape[0] < S_LAM + c_lanes or tp.shape[0] < 2 \
            or tp.shape[1] != n:
        raise ValueError(f"state must be [>= {S_LAM + c_lanes}, N] and tp "
                         f"[>= 2, N], got {tuple(state.shape)}, "
                         f"{tuple(tp.shape)}")
    pairs, res = lut["pairs"], lut["res"]
    tf = torch.empty((rows, n), dtype=torch.float32, device=state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    # the twin's scalars as it rounds them to f32 (ctypes' c_float)
    rc = _lib().tex_feed_launch(
        _ptr(state), _ptr(tp), n, _ptr(feed.uvtab), feed.uvtab.shape[1],
        _ptr(feed.mat2tex), _ptr(lut["meta"]), _ptr(pairs), pairs.shape[0],
        res, lut["lam_lo"], lut["lam_hi"] - lut["lam_lo"], res - 1,
        res - 1 - 1e-4, c_lanes, rows, _ptr(tf), ctypes.c_void_p(stream))
    _raise_on(rc, "tex_feed")
    TEX_FEED_LAUNCHES += 1
    return tf


def tex_feed_plain(feed: TexFeed, state, tp, c_lanes: int):
    """`tex_feed`'s plain twin (the JAX package's `_tex_feed`, plain torch
    on the lanes' device): from K1's hit rows tp (t, prim id), each lane's
    hit point, its uv by prim type (triangle barycentrics, sphere equirect,
    rect parametric, disk (0, 0)), the hit material's texture and its value
    at each of the lane's λs; 0 where the lane hit nothing. The baked pair
    table takes one meta and one pair gather per λ, else `eval_texture`."""
    t, pid = tp[0], tp[1]
    hit = pid >= 0.0
    # gathers write [columns, n] rows, so the per-lane arithmetic below
    # reads contiguous rows
    rows = torch.index_select(feed.uvtab[:, :11].T, 1,
                              torch.clamp(pid, min=0.0).long())  # [11, n]
    pa, pb, pc = V3(*rows[0:3]), V3(*rows[3:6]), V3(*rows[6:9])
    ptype = rows[9]
    o = V3(state[S_O], state[S_O + 1], state[S_O + 2])
    d = V3(state[S_D], state[S_D + 1], state[S_D + 2])
    p = o + d.scale(t)
    # triangle barycentrics
    e1, e2 = pb - pa, pc - pa
    pvec = cmath.cross(d, e2)
    det = cmath.dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12,
                          1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    tvec = o - pa
    bu = cmath.dot(tvec, pvec) * inv_det
    bv = cmath.dot(d, cmath.cross(tvec, e1)) * inv_det
    # sphere equirect uv
    rel = p - pa
    nrm = torch.clamp(torch.sqrt(cmath.dot(rel, rel)), min=1e-20)
    sph_n = V3(rel.x / nrm, rel.y / nrm, rel.z / nrm)
    sph_u = torch.remainder(fdiv(torch.atan2(sph_n.y, sph_n.x), 2 * math.pi),
                            1.0)
    sph_v = fdiv(torch.acos(torch.clamp(sph_n.z, -1.0, 1.0)), math.pi)
    # rect parametric uv; a disk keeps uv (0, 0)
    rect_u = 0.5 * (cmath.dot(rel, pb)
                    / torch.clamp(cmath.dot(pb, pb), min=1e-20) + 1.0)
    rect_v = 0.5 * (cmath.dot(rel, pc)
                    / torch.clamp(cmath.dot(pc, pc), min=1e-20) + 1.0)
    is_tri = ptype == PRIM_TRIANGLE
    is_sph = ptype == PRIM_SPHERE
    is_rec = ptype == PRIM_RECT
    # a lane that hit nothing (t = inf) gets uv (0, 0), so that every texel
    # index below is in range; its value is masked out at the end
    zero = torch.zeros_like(t)
    u = torch.where(hit, torch.where(is_tri, bu, torch.where(
        is_sph, sph_u, torch.where(is_rec, rect_u, zero))), 0.0)
    v = torch.where(hit, torch.where(is_tri, bv, torch.where(
        is_sph, sph_v, torch.where(is_rec, rect_v, zero))), 0.0)
    tid = feed.mat2tex[rows[10].long()].long()
    lut = feed.lut
    if lut is not None:
        mrow = torch.index_select(lut["meta"][:, :3].T, 1, tid).long()
        tw, th = mrow[1], mrow[2]  # texture width, height; mrow[0]: base
        x = torch.minimum((torch.clamp(u, 0.0, 1.0 - 1e-6) * tw.float())
                          .long(), tw - 1)
        y = torch.minimum((torch.clamp(v, 0.0, 1.0 - 1e-6) * th.float())
                          .long(), th - 1)
        res = lut["res"]
        texel = mrow[0] + (y * tw + x) * res

        def value(lam):
            uu = torch.clamp(fdiv(lam - lut["lam_lo"],
                                  lut["lam_hi"] - lut["lam_lo"]) * (res - 1),
                             0.0, res - 1 - 1e-4)
            i0 = uu.long()
            frac = uu - i0.float()
            # an untextured material has no table row (w = h = 0): its
            # index goes negative and wraps, as the JAX gather's does; K2
            # never reads the value
            k = texel + i0
            k = 2 * torch.where(k < 0, k + lut["pairs"].shape[0], k)
            flat = lut["pairs"].view(-1)
            return flat[k] * (1.0 - frac) + flat[k + 1] * frac
    else:
        def value(lam):
            return eval_texture(feed.tex, feed.bank, tid, lam, u, v)
    tf = torch.zeros((tf_rows(c_lanes), state.shape[1]), dtype=torch.float32,
                     device=state.device)
    for ci in range(c_lanes):
        tf[ci] = torch.where(hit, value(state[S_LAM + ci]), 0.0)
    return tf


def med_feed(feed: MedFeed, state, u, light_samples: int, c_lanes: int):
    """The per-lane medium rows K12 and K2 read under medium-aware settings
    -> mf [mf_rows(C), n_pad] (rows `mf_idx`; the JAX package's `_med_feed`,
    plain torch on the lanes' device). Everything that does not need the
    hit distance: from the lane's packed medium stack, its λs and its
    direction, the σ_t and σ_s sums over the stack, the free flight at the
    hero λ (uniform row 3·ls + 3), the scatterer picked by σ_s share
    (+ 4), the direction sampled from its phase function (+ 5, + 6) with the
    hero pdf and the companion lanes' phase ratios, and its g per λ for the
    kernels' closed-form phase toward a NEE direction. A lane in vacuum
    flies 3e38, a finite stand-in for inf that keeps the f32 rows clean."""
    meds, bank = feed.meds, feed.bank
    C = c_lanes
    lam = state[S_LAM:S_LAM + C]  # [C, n]
    d = state[S_D:S_D + 3]
    stack_m = torch.stack(_unpack_stack_rows(state[S_MSTK0],
                                             state[S_MSTK1])).long()  # [4, n]
    # the four stack slots' coefficients in one pass -> [4, C, n], summed
    # in slot order as the JAX feed's loop sums them
    ss, sa, _ = medium_coefficients(meds, bank, stack_m[:, None, :],
                                    lam[None])
    sigma_s = ss[0] + ss[1] + ss[2] + ss[3]
    sigma_a = sa[0] + sa[1] + sa[2] + sa[3]
    sigma_t = sigma_s + sigma_a
    ss_hero = sigma_s[0]
    base = 3 * light_samples + 3
    u_flight, u_pick, u_ph1, u_ph2 = u[base], u[base + 1], u[base + 2], \
        u[base + 3]
    # the per-medium race of exponential flights is one exponential at the
    # summed rate and a categorical pick by σ_s share
    flight = torch.where(
        ss_hero > 1e-12,
        -torch.log(torch.clamp(1.0 - u_flight, min=1e-12))
        / torch.clamp(ss_hero, min=1e-12), 3e38)
    cum = torch.cumsum(ss[:, 0], dim=0)  # [4, n]: the hero λ, by slot
    pick = u_pick * torch.clamp(ss_hero, min=1e-20)
    slot = torch.clamp((cum < pick[None, :]).sum(dim=0), max=3)
    scat_med = torch.gather(stack_m, 0, slot[None, :])[0]
    in_med = (stack_m != 0).any(dim=0)
    wo_med, ph_pdf = phase_sample(meds, bank, scat_med, lam[0], d.T, u_ph1,
                                  u_ph2)
    wo = wo_med.unbind(-1)
    cos_sc = d[0] * wo[0] + d[1] * wo[1] + d[2] * wo[2]
    ph = phase_eval(meds, bank, scat_med[None, :], lam, cos_sc[None, :])
    ok = ph[0] > 0.0
    ph_scale = torch.where(ok, ph / torch.where(ok, ph[0], 1.0), 0.0)
    is_ray = meds.mtype[scat_med] == MED_RAYLEIGH
    g = torch.where(is_ray, 0.0, spectral.evaluate(
        bank, meds.g_idx[scat_med][None, :], lam))
    i = mf_idx(C)
    mf = torch.zeros((mf_rows(C), state.shape[1]), dtype=torch.float32,
                     device=state.device)
    mf[i["flight"]] = flight
    mf[i["sigt"]:i["sigt"] + C] = sigma_t
    mf[i["sigs"]:i["sigs"] + C] = sigma_s
    mf[i["ssh"]] = ss_hero
    mf[i["wo"]:i["wo"] + 3] = torch.stack(wo)
    mf[i["phpdf"]] = ph_pdf
    mf[i["phs"]] = 1.0
    mf[i["phs"] + 1:i["phs"] + C] = ph_scale[1:]
    mf[i["g"]:i["g"] + C] = g
    mf[i["isray"]] = is_ray.float()
    mf[i["inmed"]] = in_med.float()
    return mf


# ------------------------------------------------------- round arguments


@dataclasses.dataclass(frozen=True)
class RoundArgs:
    """Scalars of one render's rounds: the scene constants and settings."""

    c_lanes: int
    light_samples: int
    env_kind: int
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
    medium: bool = False  # medium-aware transport
    radius: float = 1.0   # the scene bound's radius (NEE transmittance)

    @staticmethod
    def make(consts: dict, settings, width: int, height: int) -> "RoundArgs":
        wb = settings.wavelength_bounds
        c = consts
        return RoundArgs(
            c_lanes=C_LANES if settings.hwss else 1,
            light_samples=int(settings.light_samples),
            env_kind=c["env_kind"], n_mats=c["n_mats"], n_lights=c["n_lights"], p_env=c["p_env"],
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
            cam_sharp=c["cam_sharp"], medium=bool(c.get("medium", False)),
            radius=c["radius"])


class _CArgs(ctypes.Structure):
    """`struct RoundArgs` of csrc/round_common.cuh (all fields 4 bytes).
    Constants that the reference forms in double precision on the host and
    rounds once to f32 are precomputed here the same way."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "c_lanes", "light_samples", "env_kind", "n_mats", "n_lights",
        "has_ggx", "has_metal", "has_sharp", "rr_enabled", "only_direct",
        "cam_blades", "medium")
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
        "cam_half_seg", "cam_cos_pi_bl", "env_tr_dist")]


def _c_args(a: RoundArgs) -> _CArgs:
    s = _CArgs()
    nl1 = max(a.n_lights, 1)
    for name in ("c_lanes", "light_samples", "env_kind", "n_mats",
                 "n_lights", "cam_blades"):
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
    s.medium = a.medium
    # the distance an environment NEE sample's transmittance is taken over
    s.env_tr_dist = 2.0 * a.radius
    return s


# ------------------------------------------------------------ plain twins


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
                     refl, wi, wo, has_ggx, has_metal,
                     mode=TransportMode.Radiance):
    """BSDF eval for C spectral lanes sharing (wi, wo) -> ([f], [pdf]);
    `mode` Importance drops the η² factor of transmission (light tracing)."""
    C = len(refl)
    if has_ggx:
        a = torch.clamp(alpha, min=1e-4)
        lanes = [(torch.clamp(eta_i[ci], min=1e-3),
                  torch.clamp(eta_o[ci], min=1e-3), kappa[ci])
                 for ci in range(C)]
        ggx = cmath.eval_ggx_lanes(a, metallic > 0.5, perm, wi, wo, mode,
                                   lanes, has_metal=has_metal)
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


def _lane_state(state, C):
    """A round's view of the state rows it reads."""
    def s(i):
        return state[i]

    if C > 1:
        # hero-wavelength spectral MIS weight
        sum_pdfr = s(S_PDFR + 0)
        for ci in range(1, C):
            sum_pdfr = sum_pdfr + s(S_PDFR + ci)
        s_mis = C / torch.clamp(sum_pdfr, min=1e-30)
    else:
        s_mis = torch.ones_like(s(S_DONE))
    return SimpleNamespace(
        o=V3(s(S_O), s(S_O + 1), s(S_O + 2)),
        d=V3(s(S_D), s(S_D + 1), s(S_D + 2)),
        lam=[s(S_LAM + i) for i in range(C)],
        beta=[s(S_BETA + i) for i in range(C)],
        rad=[s(S_RAD + i) for i in range(C)],
        acc=[s(S_ACC + i) for i in range(3)],
        done=s(S_DONE), alive=s(S_ALIVE) > 0.5, bounce_ct=s(S_BOUNCE),
        prev_pdf=s(S_PREV_PDF), s_mis=s_mis)


def _col(x):
    return x[:, None]


def _closest(dense_tab, st):
    """Closest hit straight off the live ray state -> (t, prim id | -1)."""
    o, d = st.o, st.d
    return sweep_closest_cols(
        dense_tab, _col(o.x), _col(o.y), _col(o.z), _col(d.x), _col(d.y),
        _col(d.z), _col(torch.full_like(o.x, INTERSECTION_TIME_OFFSET)),
        _col(torch.full_like(o.x, RAY_TMAX)))


def _phase_toward(g, is_ray, cos_sc):
    """The closed-form HG or Rayleigh phase toward a direction at cosine
    `cos_sc` to the ray, with the scatterer's fed g."""
    g2 = g * g
    den = 1.0 + g2 - 2.0 * g * cos_sc
    p_hg = (1.0 - g2) / torch.clamp(
        4.0 * math.pi * den * torch.sqrt(torch.clamp(den, min=1e-12)),
        min=1e-12)
    p_ray = 3.0 / (16.0 * math.pi) * (1.0 + cos_sc * cos_sc)
    return torch.where(is_ray, p_ray, p_hg)


def _shade(u, st, t_hit, pid, prim_tab, mat_tab, light_tab, spec_tab,
           a: RoundArgs, ef=None, tf=None, mf=None, state=None):
    """The shading shared by the fused round, K12 and K2 (the JAX package's
    `_all_kernel_body` and `_shade_body` up to the BSDF sample): hit
    attributes, the environment escape and light-hit emission adds with
    MIS, the NEE samples (ray, worth and contribution, not yet
    shadow-tested) and the BSDF sample with its HWSS ratios. `ef` holds the
    environment-feed rows of a Sun or HDR environment, `tf` the
    texture-feed rows that replace the baked reflectance of lambertians
    flagged `_M_TEXF`, `mf` the medium-feed rows of medium-aware settings
    (with `state`, for the packed medium stack): a lane whose free flight
    ends before its surface hit scatters there instead, its throughput
    takes the Beer-Lambert lane weights before any radiance add, its NEE
    leaves the scatter point weighted by the phase function and the
    transmittance to the light, it continues along the fed phase-sampled
    direction, and a lane that crosses a boundary moves its stack."""
    ls = a.light_samples
    C = a.c_lanes
    nee_enabled = ls > 0
    p_env = a.p_env
    n_mats = a.n_mats
    n_lights = a.n_lights
    env_fed = a.env_kind != ENV_CONSTANT
    o, d, lam, beta, s_mis = st.o, st.d, st.lam, list(st.beta), st.s_mis
    medium = a.medium
    rad = list(st.rad)
    alive, bounce_ct, prev_pdf = st.alive, st.bounce_ct, st.prev_pdf
    ones = torch.ones_like(prev_pdf)

    def mat(row, mid):
        return mat_tab[row][mid.long()]

    hit = pid >= 0.0
    pid_c = torch.clamp(pid, min=0.0)
    attr = prim_tab[:, pid_c.long()]
    point, normal, gn, mat_id, kind, area = _hit_attributes(attr, o, d, t_hit)
    at_surface = alive & hit & (kind != 2.0)

    if medium:
        mfi = mf_idx(C)
        flight = mf[mfi["flight"]]
        sig_t = [mf[mfi["sigt"] + ci] for ci in range(C)]
        sig_s = [mf[mfi["sigs"] + ci] for ci in range(C)]
        ss_hero = mf[mfi["ssh"]]
        in_med = mf[mfi["inmed"]] > 0.5
        g_scat = [mf[mfi["g"] + ci] for ci in range(C)]
        is_ray = mf[mfi["isray"]] > 0.5
        surf_t = torch.where(hit, t_hit, RAY_TMAX)
        scattered = alive & (flight < surf_t)
        travel = torch.clamp(torch.minimum(flight, surf_t), max=1e8)
        inv_ssh = torch.where(ss_hero > 0.0,
                              1.0 / torch.where(ss_hero > 0.0, ss_hero, 1.0),
                              0.0)
        # hero-divide-out Beer-Lambert lane weights
        medw = []
        for ci in range(C):
            w_exp = torch.exp(-(sig_t[ci] - ss_hero) * travel)
            lane_w = torch.where(scattered, sig_s[ci] * inv_ssh * w_exp,
                                 w_exp)
            lane_w = torch.where(in_med, lane_w, 1.0)
            medw.append(lane_w)
            beta[ci] = beta[ci] * lane_w
        at_surface = at_surface & ~scattered
        scat_p = o + d.scale(travel)
    else:
        scattered = torch.zeros_like(alive)

    R = [_spectral_rows(spec_tab, lam[ci], a.lam_lo, a.lam_hi)
         for ci in range(C)]

    env_row = 5 * n_mats
    escaped = alive & ~hit & ~scattered
    if nee_enabled and p_env > 0.0:
        if env_fed:
            env_nee_pdf = ef[C] * p_env
        else:
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
        env_e = ef[ci] if env_fed else R[ci](env_row)
        rad[ci] = rad[ci] + torch.where(escaped,
                                        beta[ci] * s_mis * env_e * w_env, 0.0)

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
    # the NEE source point: the scatter point of a medium event
    point_m = cmath.where(scattered, scat_p, point) if medium else point

    alpha = mat(_M_ALPHA, mat_id)
    metal = mat(_M_METAL, mat_id)
    perm = mat(_M_PERM, mat_id)
    rscale = mat(_M_RSCALE, mat_id)
    eta_i = [R[ci](5.0 * mat_id + 0.0) for ci in range(C)]
    eta_o = [R[ci](5.0 * mat_id + 1.0) for ci in range(C)]
    kappa = [R[ci](5.0 * mat_id + 2.0) for ci in range(C)]
    refl = [rscale * R[ci](5.0 * mat_id + 3.0) for ci in range(C)]
    if tf is not None:
        texm = mat(_M_TEXF, mat_id) > 0.5
        refl = [torch.where(texm, tf[ci], refl[ci]) for ci in range(C)]

    shadow_ct = torch.zeros_like(prev_pdf)

    # ---- NEE samples: shadow ray, worth and contribution per light sample
    nee = []
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
            to_l = lp - point_m
            dist2 = torch.clamp(cmath.length_squared(to_l), min=1e-12)
            dist = torch.sqrt(dist2)
            dir_l = to_l.scale(1.0 / dist)
            cos_l = cmath.dot(ln, -dir_l)
            lp_pdf = 1.0 / float(nl1)
            sa_pdf_light = (1.0 - p_env) * lp_pdf * area_pdf * torch.where(
                torch.abs(cos_l) > 0.0,
                dist2 / torch.clamp(torch.abs(cos_l), min=1e-30), 0.0)
            if p_env > 0.0:
                if env_fed:
                    # the sampled direction and its solid-angle pdf, fed
                    eb = C + 1 + si * (4 + C)
                    env_dir = V3(ef[eb], ef[eb + 1], ef[eb + 2])
                    sa_pdf_env = ef[eb + 3] * p_env
                else:
                    env_d_uv = cmath.uv_to_direction(u1, u2)
                    ri = a.env_rot_inv
                    env_dir = V3(
                        ri[0] * env_d_uv.x + ri[1] * env_d_uv.y
                        + ri[2] * env_d_uv.z,
                        ri[3] * env_d_uv.x + ri[4] * env_d_uv.y
                        + ri[5] * env_d_uv.z,
                        ri[6] * env_d_uv.x + ri[7] * env_d_uv.y
                        + ri[8] * env_d_uv.z,
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
            max_le = torch.zeros_like(prev_pdf)
            max_thr = torch.zeros_like(prev_pdf)
            thr, le = [], []
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
                    env_e_s = (ef[C + 1 + si * (4 + C) + 4 + ci] if env_fed
                               else R[ci](env_row))
                    le_ci = torch.where(chose_env, env_e_s, le_inst)
                else:
                    le_ci = le_inst
                thr_ci = nee_fs[ci] * torch.abs(wo_local.z)
                if medium:
                    # at a scatter the phase toward the NEE direction is
                    # the throughput and the hero pdf
                    ph_ci = _phase_toward(g_scat[ci], is_ray,
                                          cmath.dot(d, nee_dir))
                    thr_ci = torch.where(scattered, ph_ci, thr_ci)
                    if ci == 0:
                        pdf_s0 = torch.where(scattered, ph_ci, nee_pdfs[0])
                max_le = torch.maximum(max_le, le_ci)
                max_thr = torch.maximum(max_thr, thr_ci)
                thr.append(thr_ci)
                le.append(le_ci)
            nee_src = (at_surface | scattered) if medium else at_surface
            worth = (nee_src & (max_le > 0.0) & (nee_pdf > 1e-12)
                     & (max_thr > 0.0))
            w_nee = _balance(nee_pdf, torch.clamp(
                pdf_s0 if medium else nee_pdfs[0], min=0.0))
            so = point + gn.scale(NORMAL_OFFSET * torch.sign(
                cmath.dot(gn, nee_dir) + 1e-9))
            if medium:
                # no normal offset at a scatter point
                so = cmath.where(scattered, scat_p, so)
            inv_pdf = torch.where(nee_pdf > 1e-12,
                                  1.0 / torch.clamp(nee_pdf, min=1e-12), 0.0)
            contrib = [beta[ci] * s_mis * thr[ci] * le[ci] * w_nee * inv_pdf
                       * inv_ls for ci in range(C)]
            if medium:
                # transmittance through the tracked media over the shadow
                # distance (an environment sample: the scene's diameter)
                tr_dist = (torch.where(chose_env, 2.0 * a.radius, dist)
                           if p_env > 0.0 else dist)
                tr_dist = torch.clamp(tr_dist, max=1e8)
                contrib = [contrib[ci] * torch.where(
                    in_med, torch.exp(-sig_t[ci] * tr_dist), 1.0)
                    for ci in range(C)]
            nee.append(SimpleNamespace(so=so, dir=nee_dir, tmax=nee_tmax,
                                       worth=worth, contrib=contrib))
            shadow_ct = shadow_ct + worth.float()

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

    d_new = cmath.normalize(cmath.to_world(tgt, btg, normal, wo_local_s))
    o_new = point + gn.scale(NORMAL_OFFSET * torch.sign(cmath.dot(gn, d_new)))
    inv_p0 = torch.where(p_lanes[0] > 0.0,
                         1.0 / torch.where(p_lanes[0] > 0.0, p_lanes[0], 1.0),
                         0.0)
    pscale = [ones if ci == 0 else p_lanes[ci] * inv_p0 for ci in range(C)]
    sample_ok = f_pdf > 1e-12
    med = None
    if medium:
        # a scatter continues along the fed phase-sampled direction from
        # the scatter point; phase value = pdf, so the hero ratio is 1 and
        # the companions' ratios and pdf ratios are the fed phase ratios
        wo_m = V3(mf[mfi["wo"]], mf[mfi["wo"] + 1], mf[mfi["wo"] + 2])
        ph_s = [mf[mfi["phs"] + ci] for ci in range(C)]
        d_new = cmath.where(scattered, wo_m, d_new)
        o_new = cmath.where(scattered, scat_p, o_new)
        f_pdf = torch.where(scattered, mf[mfi["phpdf"]], f_pdf)
        ratios = [torch.where(scattered, ph_s[ci], ratios[ci])
                  for ci in range(C)]
        pscale = [pscale[ci] if ci == 0
                  else torch.where(scattered, ph_s[ci], pscale[ci])
                  for ci in range(C)]
        sample_ok = sample_ok | scattered
        # a transmission through a boundary whose two media differ removes
        # the first occurrence of the departed medium from the stack and
        # pushes the entered one into the first empty slot
        stack = _unpack_stack_rows(state[S_MSTK0], state[S_MSTK1])
        crossed = at_surface & (wo_local_s.z * wi_local.z < 0.0)
        entering = wo_local_s.z < 0.0
        inner, outer = mat(_M_INNER, mat_id), mat(_M_OUTER, mat_id)
        do_tr = crossed & (inner != outer)
        rm_id = torch.where(entering, outer, inner)
        add_id = torch.where(entering, inner, outer)
        seen = torch.zeros_like(alive)
        for k in range(4):
            match = (stack[k] == rm_id) & do_tr & (rm_id > 0.5)
            stack[k] = torch.where(match & ~seen, 0.0, stack[k])
            seen = seen | match
        seen = torch.zeros_like(alive)
        for k in range(4):
            empty = stack[k] < 0.5
            sel = empty & ~seen & do_tr & (add_id > 0.5)
            seen = seen | empty
            stack[k] = torch.where(sel, add_id, stack[k])
        med = SimpleNamespace(
            scattered=scattered, medw=medw,
            mstk=[stack[0] + 256.0 * stack[1], stack[2] + 256.0 * stack[3]])
    return SimpleNamespace(
        rad=rad, at_surface=at_surface, env_ct=escaped.float(),
        shadow_ct=shadow_ct, nee=nee, f_pdf=f_pdf, sample_ok=sample_ok,
        ratios=ratios, o_new=o_new, d_new=d_new, pscale=pscale, med=med)


def _resolve_nee(dense_tab, nee, rad):
    """Shadow-test each NEE sample's ray and add its contribution where it
    was worth tracing and is unblocked, in sample order."""
    rad = list(rad)
    for r in nee:
        so, sd = r.so, r.dir
        blocked = sweep_any_cols(
            dense_tab, _col(so.x), _col(so.y), _col(so.z), _col(sd.x),
            _col(sd.y), _col(sd.z),
            _col(torch.full_like(so.x, INTERSECTION_TIME_OFFSET)),
            _col(r.tmax))
        ok = r.worth & ~blocked
        for ci in range(len(rad)):
            rad[ci] = rad[ci] + torch.where(ok, r.contrib[ci], 0.0)
    return rad


def _finalize_core(state, st, a: RoundArgs, rad, at_surface, f_pdf,
                   sample_ok, ratios, o_new, d_new, pscale, u_rr, rnd,
                   med=None):
    """The finalize shared by the fused round, K34 and K4 (the JAX package's
    `_finalize_core`): Russian roulette and continuation, XYZ accumulation
    on death, the thin-lens respawn at the lane's owning pixel and the
    state write-out -> out [NK4, N] (counter rows past the camera row 0).
    `med` carries the medium rows of a medium-aware round (scattered, the
    lane weights medw, the new packed stack rows mstk): the weights go on
    the throughput, a scatter always continues with hero ratio 1, and the
    stack follows a continuation and empties on a respawn."""
    C = a.c_lanes
    dev = state.device
    lam, beta, acc = st.lam, st.beta, list(st.acc)
    if med is not None:
        beta = [beta[ci] * med.medw[ci] for ci in range(C)]
    alive, bounce_ct, prev_pdf = st.alive, st.bounce_ct, st.prev_pdf
    o, d = st.o, st.d
    ones = torch.ones_like(prev_pdf)

    # ---- RR + continuation
    ratio_best = ratios[0]
    for ci in range(1, C):
        ratio_best = torch.maximum(ratio_best, ratios[ci])
    if med is not None:
        ratio_best = torch.where(med.scattered, 1.0, ratio_best)
        sample_ok = med.scattered | (sample_ok & (ratio_best > 0.0))
        at_surface = at_surface | med.scattered
    else:
        sample_ok = sample_ok & (ratio_best > 0.0)
    if a.russian_roulette:
        rr_on = bounce_ct >= a.min_bounces
        p_cont = torch.where(rr_on, torch.clamp(ratio_best, 0.05, 1.0), 1.0)
    else:
        p_cont = ones
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

    # ---- death -> XYZ accumulate
    died = alive & ~continue_path
    xyz = [torch.zeros_like(prev_pdf) for _ in range(3)]
    for ci in range(C):
        e = rad[ci] * (a.wb_span / C)
        xyz[0] = xyz[0] + e * cie.x_bar(lam[ci])
        xyz[1] = xyz[1] + e * cie.y_bar(lam[ci])
        xyz[2] = xyz[2] + e * cie.z_bar(lam[ci])
    for i in range(3):
        acc[i] = acc[i] + torch.where(died, xyz[i], 0.0)
    # S_DONE counts the samples LEFT (spp at spawn)
    done = st.done - died.float()
    has_work = died & (done > 0.5)

    # ---- respawn: thin-lens camera ray at the lane's owning pixel
    pix = state[S_PIX]
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
    co = V3(*[torch.full_like(prev_pdf, a.cam_origin[i]) for i in range(3)])
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
        pr = state[S_PDFR + ci]
        out[S_PDFR + ci] = torch.where(cp, pr * pscale[ci],
                                       torch.where(hw, 1.0, pr))
    if med is not None:
        for i, row in enumerate((S_MSTK0, S_MSTK1)):
            out[row] = torch.where(cp, med.mstk[i],
                                   torch.where(hw, 0.0, state[row]))
    out[O4_BOUNCE_CT] = cp.float()
    out[O4_CAMERA_CT] = hw.float()
    out[O4_CAMERA_CT + 1:NK4] = 0.0
    return out


def fused_round_plain(u, state, dense_tab, prim_tab, mat_tab, light_tab,
                      spec_tab, a: RoundArgs):
    """One bounce round in plain torch -> out [NK4, N] (see module doc); the
    JAX package's `_all_kernel_body`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    ls = a.light_samples
    st = _lane_state(state, a.c_lanes)
    t_hit, pid = _closest(dense_tab, st)
    sh = _shade(u, st, t_hit, pid, prim_tab, mat_tab, light_tab, spec_tab, a)
    rad = _resolve_nee(dense_tab, sh.nee, sh.rad)
    out = _finalize_core(
        state, st, a, rad, sh.at_surface, sh.f_pdf, sh.sample_ok, sh.ratios,
        sh.o_new, sh.d_new, sh.pscale, u_rr=u[3 * ls + 3],
        rnd=[u[3 * ls + 4 + i] for i in range(5)])
    out[O4_SHADOW_CT] = sh.shadow_ct
    out[O4_ENV_CT] = sh.env_ct
    return out


def shade_sweep_plain(u, state, dense_tab, prim_tab, mat_tab, light_tab,
                      spec_tab, a: RoundArgs, ef=None, mf=None):
    """K12 in plain torch: closest hit + shading -> k2 [k2_rows(ls), N] (the
    JAX package's `_shade_sweep_kernel` -> `_shade_body`). Surface rows are 0
    on lanes neither at a surface nor scattered, and every row of a dead
    lane is 0. `mf` is `med_feed`'s rows under medium-aware settings."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    st = _lane_state(state, a.c_lanes)
    t_hit, pid = _closest(dense_tab, st)
    return _k2_out(state, st, a, _shade(u, st, t_hit, pid, prim_tab, mat_tab,
                                        light_tab, spec_tab, a, ef, None, mf,
                                        state))


def shade_plain(u, state, tp, prim_tab, mat_tab, light_tab, spec_tab,
                a: RoundArgs, ef=None, tf=None, mf=None):
    """K2 in plain torch: shading from K1's hit rows tp (t, prim id) -> k2
    [k2_rows(ls), N], as K12 writes them (the JAX package's `_shade_kernel`
    -> `_shade_body`); `tf` is `tex_feed`'s rows or None, `mf` `med_feed`'s
    or None."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    st = _lane_state(state, a.c_lanes)
    return _k2_out(state, st, a, _shade(u, st, tp[0], tp[1], prim_tab,
                                        mat_tab, light_tab, spec_tab, a, ef,
                                        tf, mf, state))


def _k2_out(state, st, a: RoundArgs, sh):
    """The K2 rows of a shading result: surface rows 0 on lanes that are
    neither at a surface nor scattered in a medium, every row of a dead
    lane 0. The medium rows (scattered, the lane weights, 1 past C, and the
    packed stack) are written for every live lane."""
    C, ls = a.c_lanes, a.light_samples
    k2 = torch.zeros((k2_rows(ls), state.shape[1]), dtype=torch.float32,
                     device=state.device)
    surf = sh.at_surface
    if sh.med is not None:
        surf = surf | sh.med.scattered
        k2[O_SCAT] = sh.med.scattered.float()
        for ci in range(C_LANES):
            k2[O_MEDW + ci] = torch.where(
                st.alive, sh.med.medw[ci] if ci < C else 1.0, 0.0)
        for i in range(2):
            k2[O_MSTK + i] = torch.where(st.alive, sh.med.mstk[i], 0.0)

    def put(row, v, mask=surf):
        k2[row] = torch.where(mask, v, 0.0)

    for ci in range(C):
        put(O_RAD + ci, sh.rad[ci], st.alive)
        put(O_RATIO + ci, sh.ratios[ci])
        put(O_PSCALE + ci, sh.pscale[ci])
    k2[O_AT_SURF] = sh.at_surface.float()
    k2[O_ENV_CT] = sh.env_ct
    k2[O_SHADOW_CT] = sh.shadow_ct
    put(O_FPDF, sh.f_pdf)
    k2[O_SAMPLE_OK] = (surf & sh.sample_ok).float()
    for i, x in enumerate((*sh.o_new, *sh.d_new)):
        put(O_ONEW + i, x)
    for si, r in enumerate(sh.nee):
        b = O_NEE + NEE_ROWS * si
        for i, x in enumerate((*r.so, *r.dir, r.tmax)):
            put(b + i, x)
        k2[b + 7] = r.worth.float()
        for ci in range(C):
            put(b + 8 + ci, r.contrib[ci])
    return k2


def finalize_sweep_plain(u, state, k2, dense_tab, a: RoundArgs):
    """K34 in plain torch: NEE shadow sweeps + finalize -> out [NK4, N] (the
    JAX package's `_finalize_sweep_kernel` -> `_finalize_body`). A dead lane
    passes its state through with zero counters."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    C, ls = a.c_lanes, a.light_samples

    def k(i):
        return k2[i]

    nee = []
    for si in range(ls):
        b = O_NEE + NEE_ROWS * si
        nee.append(SimpleNamespace(
            so=V3(k(b), k(b + 1), k(b + 2)),
            dir=V3(k(b + 3), k(b + 4), k(b + 5)), tmax=k(b + 6),
            worth=k(b + 7) > 0.5, contrib=[k(b + 8 + ci) for ci in range(C)]))
    rad = _resolve_nee(dense_tab, nee, [k(O_RAD + ci) for ci in range(C)])
    return _finalize_k2(u, state, k2, a, rad)


def finalize_plain(u, state, k2, blks, a: RoundArgs):
    """K4 in plain torch: the finalize fed one blocked mask per NEE sample
    (`blks[si]` [>= 1, N], row 0 > 0.5 = blocked, as K3 writes it) instead
    of sweeping -> out [NK4, N] (the JAX package's `_finalize_kernel` ->
    `_finalize_body`). A sample's mask is read only where the sample was
    worth a ray. A dead lane passes its state through with zero counters."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    C = a.c_lanes
    rad = [k2[O_RAD + ci] for ci in range(C)]
    for si in range(a.light_samples):
        b = O_NEE + NEE_ROWS * si
        ok = (k2[b + 7] > 0.5) & ~(blks[si][0] > 0.5)
        rad = [rad[ci] + torch.where(ok, k2[b + 8 + ci], 0.0)
               for ci in range(C)]
    return _finalize_k2(u, state, k2, a, rad)


def _finalize_k2(u, state, k2, a: RoundArgs, rad):
    """The tail K34 and K4 share: `_finalize_core` on the K2 rows with the
    resolved radiance, and the dead lanes' pass-through."""
    C = a.c_lanes
    st = _lane_state(state, C)

    def k(i):
        return k2[i]

    med = None
    if a.medium:
        med = SimpleNamespace(scattered=k(O_SCAT) > 0.5,
                              medw=[k(O_MEDW + ci) for ci in range(C)],
                              mstk=[k(O_MSTK), k(O_MSTK + 1)])
    out = _finalize_core(
        state, st, a, rad, k(O_AT_SURF) > 0.5, k(O_FPDF),
        k(O_SAMPLE_OK) > 0.5, [k(O_RATIO + ci) for ci in range(C)],
        V3(k(O_ONEW), k(O_ONEW + 1), k(O_ONEW + 2)),
        V3(k(O_DNEW), k(O_DNEW + 1), k(O_DNEW + 2)),
        [k(O_PSCALE + ci) for ci in range(C)], u_rr=u[0],
        rnd=[u[1 + i] for i in range(5)], med=med)
    passthrough = torch.cat([state, torch.zeros_like(out[NS:])])
    return torch.where(st.alive[None, :], out, passthrough)


# ---------------------------------------------------------- CUDA wrappers


def _check_tensors(**named):
    dev = None
    for name, x in named.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        dev = dev or x.device
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check_round(u, state, scene: MegaScene, a: RoundArgs, u_rows: int,
                 max_prims: int, why: str):
    _check_tensors(u=u, state=state,
                   dense_tab=scene.dense_tab, prim_tab=scene.prim_tab,
                   mat_tab=scene.mat_tab, light_tab=scene.light_tab,
                   spec_tab=scene.spec_tab)
    n = state.shape[1]
    if state.shape[0] != NS:
        raise ValueError(f"state must be [{NS}, N], got {tuple(state.shape)}")
    if u.shape[1] != n or u.shape[0] < u_rows:
        raise ValueError(f"u must be [>= {u_rows}, {n}], got "
                         f"{tuple(u.shape)}")
    if a.c_lanes not in (1, C_LANES):
        raise ValueError(f"c_lanes must be 1 or {C_LANES}")
    dense = scene.dense_tab
    if dense.shape[1] != 128 or dense.shape[0] > max_prims \
            or dense.shape[0] % PBF:
        raise NotImplementedError(why)
    if scene.prim_tab.shape[0] != _NP_ROWS \
            or scene.prim_tab.shape[1] < dense.shape[0] \
            or scene.mat_tab.shape != (_NM_ROWS, 128) \
            or scene.light_tab.shape != (_NL_ROWS, 128) \
            or scene.spec_tab.shape[1] != SPEC_RES \
            or scene.spec_tab.shape[0] < 5 * a.n_mats + 1:
        raise ValueError("table shapes do not match the bake")


def _sweep_tab(scene: MegaScene):
    """The scene's compact sweep table, checked against its dense table."""
    tab = scene.sweep_tab
    if tab is None:
        raise ValueError("the scene carries no sweep_tab: bake it with "
                         "bake_mega_scene")
    check_sweep(tab, scene.dense_tab)
    if not 0 <= SWEEP_RESIDENT_ROWS <= 3584:
        raise ValueError("SWEEP_RESIDENT_ROWS must be in [0, 3584]")
    return tab


def _lib():
    from pathtracer_tpu_torch.kernels import _build

    lib = _build.library()
    if lib.round_args_size() != ctypes.sizeof(_CArgs):
        raise RuntimeError("_CArgs does not mirror struct RoundArgs of "
                           "csrc/round_common.cuh")
    return lib


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


def _raise_on(rc, name):
    if rc != 0:
        from pathtracer_tpu_torch.kernels import _build

        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({_build.error_string(rc)})")


def _tables(scene: MegaScene):
    return dict(dense_tab=scene.dense_tab, prim_tab=scene.prim_tab,
                mat_tab=scene.mat_tab, light_tab=scene.light_tab,
                spec_tab=scene.spec_tab)


def fused_round(u, state, scene: MegaScene, a: RoundArgs):
    """One bounce round -> out [NK4, N]: the CUDA kernel on CUDA tensors,
    the plain twin on CPU tensors."""
    global FUSED_LAUNCHES
    _check_round(u, state, scene, a, 3 * a.light_samples + 9,
                 PBF * FUSED_MAX_CHUNKS, _NOT_FUSED)
    if a.env_kind != ENV_CONSTANT:
        raise NotImplementedError(_NOT_FUSED)
    if state.device.type == "cpu":
        return fused_round_plain(u, state, a=a, **_tables(scene))
    sweep = _sweep_tab(scene)
    lib = _lib()
    n = state.shape[1]
    out = torch.empty((NK4, n), dtype=torch.float32, device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.fused_round_launch(
        _ptr(u), u.shape[0], _ptr(state), _ptr(out), n,
        _ptr(sweep), sweep.shape[0],
        _ptr(scene.prim_tab), scene.prim_tab.shape[1],
        _ptr(scene.mat_tab), _ptr(scene.light_tab), _ptr(scene.spec_tab),
        scene.spec_tab.shape[0], ctypes.byref(cargs),
        ctypes.c_void_p(stream))
    _raise_on(rc, "fused_round")
    FUSED_LAUNCHES += 1
    return out


def _check_feeds(state, a: RoundArgs, ef, mf, tp=None, tf=None):
    """The feed rows of K12 and K2: `ef` exactly for Sun and HDR
    environments, `mf` exactly under medium-aware settings, each (and K2's
    `tp` and `tf`) of its shape."""
    n = state.shape[1]
    if (a.env_kind != ENV_CONSTANT) != (ef is not None):
        raise ValueError("ef must be given exactly for Sun and HDR "
                         "environments")
    if a.medium != (mf is not None):
        raise ValueError("mf must be given exactly for medium-aware "
                         "settings")
    for name, x, rows in (("tp", tp, 8),
                          ("ef", ef, ef_rows(a.light_samples, a.c_lanes)),
                          ("tf", tf, tf_rows(a.c_lanes)),
                          ("mf", mf, mf_rows(a.c_lanes))):
        if x is None:
            continue
        _check_tensors(state=state, **{name: x})
        if x.shape != (rows, n):
            raise ValueError(f"{name} must be [{rows}, N], got "
                             f"{tuple(x.shape)}")


def _k12_u_rows(a: RoundArgs) -> int:
    return 3 * a.light_samples + 3 + (4 if a.medium else 0)


def shade_sweep(u, state, scene: MegaScene, a: RoundArgs, ef=None, mf=None):
    """K12 -> k2 [k2_rows(ls), N]: the CUDA kernel on CUDA tensors, the
    plain twin on CPU tensors. `ef` is `env_feed`'s rows for a Sun or HDR
    environment and None for a constant one; `mf` is `med_feed`'s rows
    under medium-aware settings and None otherwise."""
    global SHADE_LAUNCHES
    _check_round(u, state, scene, a, _k12_u_rows(a), MEGA_MAX_PRIMS,
                 _NOT_IN_GATE)
    _check_feeds(state, a, ef, mf)
    if state.device.type == "cpu":
        return shade_sweep_plain(u, state, a=a, ef=ef, mf=mf,
                                 **_tables(scene))
    sweep = _sweep_tab(scene)
    lib = _lib()
    n = state.shape[1]
    k2 = torch.empty((k2_rows(a.light_samples), n), dtype=torch.float32,
                     device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.shade_sweep_launch(
        _ptr(u), _ptr(state), _ptr(ef), _ptr(mf), _ptr(k2), n,
        _ptr(sweep), sweep.shape[0], SWEEP_RESIDENT_ROWS,
        _ptr(scene.prim_tab), scene.prim_tab.shape[1],
        _ptr(scene.mat_tab), _ptr(scene.light_tab), _ptr(scene.spec_tab),
        ctypes.byref(cargs), ctypes.c_void_p(stream))
    _raise_on(rc, "shade_sweep")
    SHADE_LAUNCHES += 1
    return k2


def shade(u, state, tp, scene: MegaScene, a: RoundArgs, ef=None, tf=None,
          mf=None):
    """K2 -> k2 [k2_rows(ls), N] from K1's rows tp [8, N]: the CUDA kernel
    on CUDA tensors, the plain twin on CPU tensors. `ef` and `mf` as for
    `shade_sweep`; `tf` is `tex_feed`'s rows, required for a scene with
    uv-textured lambertians."""
    global K2_LAUNCHES
    _check_round(u, state, scene, a, _k12_u_rows(a), MEGA_MAX_PRIMS,
                 _NOT_IN_GATE)
    n = state.shape[1]
    if scene.consts["tex_feed"] and tf is None:
        raise ValueError("a scene with uv-textured lambertians needs tf")
    _check_feeds(state, a, ef, mf, tp, tf)
    if state.device.type == "cpu":
        return shade_plain(u, state, tp, scene.prim_tab, scene.mat_tab,
                           scene.light_tab, scene.spec_tab, a, ef, tf, mf)
    lib = _lib()
    k2 = torch.empty((k2_rows(a.light_samples), n), dtype=torch.float32,
                     device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.shade_launch(
        _ptr(u), _ptr(state), _ptr(tp), _ptr(ef), _ptr(tf), _ptr(mf),
        _ptr(k2), n,
        _ptr(scene.prim_tab), scene.prim_tab.shape[1],
        _ptr(scene.mat_tab), _ptr(scene.light_tab), _ptr(scene.spec_tab),
        ctypes.byref(cargs), ctypes.c_void_p(stream))
    _raise_on(rc, "shade")
    K2_LAUNCHES += 1
    return k2


def finalize_sweep(u, state, k2, scene: MegaScene, a: RoundArgs):
    """K34 -> out [NK4, N]: the CUDA kernel on CUDA tensors, the plain twin
    on CPU tensors."""
    global FINALIZE_LAUNCHES
    _check_round(u, state, scene, a, 1 + 5, MEGA_MAX_PRIMS,  # RR, respawn
                 _NOT_IN_GATE)
    _check_tensors(state=state, k2=k2)
    if k2.shape != (k2_rows(a.light_samples), state.shape[1]):
        raise ValueError(f"k2 must be [{k2_rows(a.light_samples)}, N], got "
                         f"{tuple(k2.shape)}")
    if state.device.type == "cpu":
        return finalize_sweep_plain(u, state, k2, scene.dense_tab, a)
    sweep = _sweep_tab(scene)
    lib = _lib()
    n = state.shape[1]
    out = torch.empty((NK4, n), dtype=torch.float32, device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.finalize_sweep_launch(
        _ptr(u), _ptr(state), _ptr(k2), _ptr(out), n,
        _ptr(sweep), sweep.shape[0], SWEEP_RESIDENT_ROWS,
        ctypes.byref(cargs), ctypes.c_void_p(stream))
    _raise_on(rc, "finalize_sweep")
    FINALIZE_LAUNCHES += 1
    return out


def finalize(u, state, k2, blks, scene: MegaScene, a: RoundArgs):
    """K4 -> out [NK4, N]: the finalize fed the blocked masks of the NEE
    samples' shadow rays, `blks[si]` as K3 (`dense.sweep_any_rows`) writes
    sample si's ([>= 1, N], row 0 read): the CUDA kernel on CUDA tensors,
    the plain twin on CPU tensors."""
    global K4_LAUNCHES
    _check_round(u, state, scene, a, 1 + 5, MEGA_MAX_PRIMS,  # RR, respawn
                 _NOT_IN_GATE)
    _check_tensors(state=state, k2=k2)
    n = state.shape[1]
    if k2.shape != (k2_rows(a.light_samples), n):
        raise ValueError(f"k2 must be [{k2_rows(a.light_samples)}, N], got "
                         f"{tuple(k2.shape)}")
    blks = list(blks)
    if len(blks) != a.light_samples:
        raise ValueError(f"{a.light_samples} blocked masks expected, one "
                         f"per NEE sample, got {len(blks)}")
    for si, b in enumerate(blks):
        _check_tensors(state=state, **{f"blks[{si}]": b})
        if b.shape[0] < 1 or b.shape[1] != n:
            raise ValueError(f"blks[{si}] must be [>= 1, N], got "
                             f"{tuple(b.shape)}")
    if state.device.type == "cpu":
        return finalize_plain(u, state, k2, blks, a)
    lib = _lib()
    # the kernel reads row si of one [ls, N] block
    blk = (blks[0] if len(blks) == 1 else
           torch.cat([b[:1] for b in blks]) if blks else None)
    out = torch.empty((NK4, n), dtype=torch.float32, device=state.device)
    cargs = _c_args(a)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.finalize_launch(_ptr(u), _ptr(state), _ptr(k2), _ptr(blk),
                             _ptr(out), n, ctypes.byref(cargs),
                             ctypes.c_void_p(stream))
    _raise_on(rc, "finalize")
    K4_LAUNCHES += 1
    return out


# ------------------------------------------------------------ uniforms


class TorchUniforms:
    """Uniform source of a render: the initial spawn block and the
    `[rows, n_pad]` blocks of each round, drawn from one `torch.Generator`.
    A round draws one block (`stream` None: the fused round) or two
    (`stream` 0 for K12, 1 for K34); a replay of the JAX draws keys them by
    (it, stream) as the JAX package's `_k12_call`/`_k34_call` do. The light
    tracer (`kernels/lt_mega.py`) also draws per-lane columns and
    permutations of its strata."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def init(self, n_pad: int, device) -> torch.Tensor:
        return torch.rand((n_pad, 5), generator=self.generator,
                          device=device)

    def round(self, it: int, rows: int, n_pad: int, device,
              stream: int | None = None) -> torch.Tensor:
        return torch.rand((rows, n_pad), generator=self.generator,
                          device=device)

    def lanes(self, it: int, cols: int, n_pad: int, device,
              stream: int | None = None) -> torch.Tensor:
        """A `[n_pad, cols]` block: one row of uniforms per lane (the light
        tracer's spawn feed draws its columns so)."""
        return torch.rand((n_pad, cols), generator=self.generator,
                          device=device)

    def permutation(self, it: int, n: int, device,
                    stream: int | None = None) -> torch.Tensor:
        """A random permutation of range(n) (stratified spawning)."""
        return torch.randperm(n, generator=self.generator, device=device)


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
# counter slots of the fused round's out rows O4_BOUNCE_CT..O4_ENV_CT, and
# of the two-program round's out rows O4_BOUNCE_CT, O4_CAMERA_CT and K2 rows
# O_ENV_CT, O_SHADOW_CT
_FUSED_SLOTS = (prof.BOUNCE_RAYS, prof.CAMERA_RAYS, prof.SHADOW_RAYS,
                prof.ENV_HITS)
_TWO_PROG_SLOTS = (prof.BOUNCE_RAYS, prof.CAMERA_RAYS, prof.ENV_HITS,
                   prof.SHADOW_RAYS)


def per_round(max_iters: int, device):
    """While tracing is on, an f64 device accumulator with a slot for each
    round a render can run (filled on the device, read by
    `Recorder.resolve`); off, None."""
    if prof.recorder() is None:
        return None
    return torch.zeros(max_iters + ALIVE_CHECK_EVERY, dtype=torch.float64,
                       device=device)


def run_rounds(step, alive, pending, counters, slots, max_iters: int,
               stats=None) -> int:
    """The megakernel drivers' round loop -> the rounds run. `step(it)`
    runs round `it` on the driver's lane state and returns its counter
    rows [len(slots), N], whose lane sums add to `counters` at `slots`.
    Every ALIVE_CHECK_EVERY rounds the host fetches whether any lane is
    `pending()` (a `wait` span) and stops where none is, or once
    `max_iters` rounds have run. While tracing is on, each round counts its
    lanes as `lanes_launched` and the lanes `alive()` at its start as
    `lanes_live`. A `stats` dict gets the rounds added to "rounds". The
    driver keeps the state and rebinds it in `step`, so each round's input
    is freed once the next round has it."""
    slots = torch.tensor(slots, device=counters.device)
    live = per_round(max_iters, counters.device)
    it = 0
    while it < max_iters:
        for _ in range(ALIVE_CHECK_EVERY):
            if live is not None:
                torch.sum(alive(), 0, dtype=torch.float64, out=live[it])
            counts = step(it)
            counters.index_add_(0, slots,
                                counts.sum(dim=1, dtype=torch.float64))
            it += 1
        with prof.span("wait"):
            more = bool(pending().any())
        if not more:
            break
    if live is not None:
        prof.count("lanes_launched", [counts.shape[1]] * it)
        prof.count("lanes_live", live[:it])
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + it
    return it


def _k12_uniforms(state, scene: MegaScene, a: RoundArgs, uniforms, it: int):
    """K12's (or K2's) uniform block (stream 0) and the feeds computed from
    it: (u12, ef | None, mf | None)."""
    u12 = uniforms.round(it, n_u_rows(a.light_samples, a.medium),
                         state.shape[1], state.device, stream=0)
    ef = mf = None
    if scene.env is not None:
        with prof.span("feed"):
            ef = env_feed(scene.env, state, u12, a.light_samples, a.c_lanes)
    if scene.med is not None:
        with prof.span("feed"):
            mf = med_feed(scene.med, state, u12, a.light_samples, a.c_lanes)
    return u12, ef, mf


def two_prog_round(state, scene: MegaScene, a: RoundArgs, uniforms, it: int):
    """One bounce round of the two-program route -> (out [NK4, N], k2):
    K12 on its uniform block (stream 0), after the environment feed of a Sun
    or HDR environment and the medium feed of medium-aware settings, then
    K34 on its own (stream 1)."""
    u12, ef, mf = _k12_uniforms(state, scene, a, uniforms, it)
    k2 = shade_sweep(u12, state, scene, a, ef, mf)
    u34 = uniforms.round(it, NU4, state.shape[1], state.device, stream=1)
    return finalize_sweep(u34, state, k2, scene, a), k2


def texfeed_round(state, scene: MegaScene, a: RoundArgs, uniforms, it: int):
    """One bounce round of the texture-feed route -> (out [NK4, N], k2), as
    the JAX package's `_mega_step_texfeed`: K1 (the closest-hit rows), the
    environment feed of a Sun or HDR environment, the texture feed, K2 on
    the K12 uniform block (stream 0), then K34 on its own (stream 1)."""
    tp = sweep_closest_rows(state, scene.dense_tab, S_O, S_ALIVE,
                            _sweep_tab(scene))
    u12, ef, mf = _k12_uniforms(state, scene, a, uniforms, it)
    with prof.span("feed"):
        tf = tex_feed(scene.tex, state, tp, a.c_lanes)
    k2 = shade(u12, state, tp, scene, a, ef, tf, mf)
    u34 = uniforms.round(it, NU4, state.shape[1], state.device, stream=1)
    return finalize_sweep(u34, state, k2, scene, a), k2


def split_round(state, scene: MegaScene, a: RoundArgs, uniforms, it: int):
    """One bounce round of the split route -> (out [NK4, N], k2), the JAX
    package's five-program pipeline K1 | K2 | K3 x light_samples | K4: K1
    (the closest-hit rows), the environment, texture and medium feeds the
    scene needs, K2 on the K12 uniform block (stream 0), K3 (the any-hit
    rows sweep of each NEE sample's shadow ray, read in place from the K2
    rows) and K4 on the K34 block (stream 1). It takes every scene of the
    gate and writes what the scene's default round writes, bit for bit."""
    sweep = _sweep_tab(scene)
    tp = sweep_closest_rows(state, scene.dense_tab, S_O, S_ALIVE, sweep)
    u12, ef, mf = _k12_uniforms(state, scene, a, uniforms, it)
    tf = None
    if scene.tex is not None:
        with prof.span("feed"):
            tf = tex_feed(scene.tex, state, tp, a.c_lanes)
    k2 = shade(u12, state, tp, scene, a, ef, tf, mf)
    blks = []
    for si in range(a.light_samples):
        row0 = O_NEE + NEE_ROWS * si
        blks.append(sweep_any_rows(k2, scene.dense_tab, row0, row0 + 6,
                                   live_row=row0 + 7, sweep=sweep))
    u34 = uniforms.round(it, NU4, state.shape[1], state.device, stream=1)
    return finalize(u34, state, k2, blks, scene, a), k2


def pt_trace_regen_mega(world, camera, settings, width, height, spp,
                        uniforms, device=None, stats=None, stepper=None):
    """Render `spp` samples of every pixel with one lane per pixel ->
    (xyz sums [width * height, 3], counters f64[5]), on `device`
    (default: the world's). Each round is the fused round for scenes in its
    gate, the texture-feed round for scenes with uv-textured lambertians and
    the two-program round otherwise (medium-aware settings among them);
    `stepper="split"` takes every scene through `split_round` instead (the
    JAX render loop's PT_MEGA_3PROG lever, one step further: K3 and K4
    apart).
    The kernels launch on a card, the plain twins run on the CPU. A `stats`
    dict, if given, gets the number of rounds added to "rounds"."""
    why = gate_refusal(world, camera, settings)
    if why is not None:
        raise NotImplementedError(why)
    return _pt_trace_regen_mega(world, camera, settings, width, height, spp,
                                uniforms, device, stats, stepper)


def _pt_trace_regen_mega(world, camera, settings, width, height, spp,
                         uniforms, device, stats, stepper):
    """`pt_trace_regen_mega` on a scene that its gate has taken
    (`render_regen` evaluates the gate once a call)."""
    if stepper not in (None, "split"):
        raise ValueError(f"stepper must be None or 'split', got {stepper!r}")
    device = torch.device(device) if device is not None \
        else world.prims.pa.device
    with prof.span("bake"):
        scene = bake_mega_scene(world, camera, device,
                                medium=bool(settings.medium_aware))
        cam = camera.to(device)
    a = RoundArgs.make(scene.consts, settings, width, height)
    n = width * height
    n_pad = -(-n // TILE) * TILE
    state, counters = mega_init(cam, uniforms.init(n_pad, device), a, n,
                                n_pad, spp)
    if fused_ok(scene) and stepper is None:
        rows, slots = nu_rows(a.light_samples), _FUSED_SLOTS

        def step(it):
            nonlocal state
            out = fused_round(uniforms.round(it, rows, n_pad, device), state,
                              scene, a)
            state = out[:NS]
            return out[O4_BOUNCE_CT:O4_ENV_CT + 1]
    else:
        round_ = (split_round if stepper == "split" else
                  texfeed_round if scene.tex is not None else two_prog_round)
        slots = _TWO_PROG_SLOTS

        def step(it):
            nonlocal state
            out, k2 = round_(state, scene, a, uniforms, it)
            state = out[:NS]
            return torch.cat([out[O4_BOUNCE_CT:O4_CAMERA_CT + 1],
                              k2[O_ENV_CT:O_SHADOW_CT + 1]])

    def alive():
        return state[S_ALIVE] > 0.5

    run_rounds(step, alive, alive, counters, slots,
               int(spp * settings.max_bounces * 8 + 64), stats)
    return state[S_ACC:S_ACC + 3, :n].T, counters
