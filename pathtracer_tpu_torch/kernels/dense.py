"""Dense ray × primitive sweep, closest hit and any hit (counterpart of
`pathtracer_tpu.kernels.dense`).

The packed primitive table is the JAX package's `[P_pad, 128]` f32 layout
(`pack_prims_np`): columns 0..10 hold ptype, valid, pa, pb, pc; the rest is
zero. Rays are `[8, N]` rows: origin (3), direction (3), tmin, tmax.
`pack_sweep_np` packs the same prims as `[P_pad, 16]` rows with a rect's
normal and edge norms baked in: the table that the round kernels walk in
shared memory (`csrc/walk.cuh`), K1 and K3 among them.

`sweep_closest` / `sweep_any` launch the CUDA kernels of
`csrc/dense_sweep.cu` on CUDA tensors, which walk the sweep table
(`World.sweep_tab`), and run the plain torch twins (`sweep_closest_plain`,
`sweep_any_plain`) on the packed table on CPU tensors; they answer
`World.intersect` / `intersect_any` (`geometry/soa.py`), the regen
integrator's queries. `sweep_closest_rows` (K1 of the texture-feed round)
reads the rays in place from rows of the megakernel state and writes
`[8, N]` rows (t, prim id); its kernel is in `csrc/two_prog_round.cu` and
walks the sweep table, its twin `sweep_closest_rows_plain` the packed
table.
`sweep_any_rows` (K3 of the split round) reads each lane's shadow ray and
its tmax in place from the K2 rows and writes the blocked mask; its kernel
is in the same file and walks the sweep table too, its twin
`sweep_any_rows_plain` the packed table. The closest hit is the
minimum t, ties to the minimum prim id, exactly as the JAX sweep reduces its
chunks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pathtracer_tpu_torch.geometry.soa import PRIM_DISK, PRIM_RECT, PRIM_SPHERE
from pathtracer_tpu_torch.prelude import INTERSECTION_TIME_OFFSET, RAY_TMAX

# packed prim-table columns (table is [P_pad, 128]; cols 11.. are padding)
_C_PTYPE, _C_VALID = 0, 1
_C_PA, _C_PB, _C_PC = 2, 5, 8
_N_COLS = 128
PBF = 32  # prim rows are padded to a multiple of this block
# the compact sweep table's columns ([P_pad, 16]: 64-byte rows): 0..10 as
# the packed table's, then what a rect's test needs of the prim alone
_C_N, _C_BB, _C_CC = 11, 14, 15
SWEEP_COLS = 16

# kernel launches of the dense sweeps, closest hit and any hit; the plain
# twins never count
CLOSEST_LAUNCHES = 0
ANY_LAUNCHES = 0
# launches of the rows sweep's kernel, and calls of its plain twin
ROWS_LAUNCHES = 0
ROWS_PLAIN_CALLS = 0
# the same for the any-hit rows sweep (K3)
ANY_ROWS_LAUNCHES = 0
ANY_ROWS_PLAIN_CALLS = 0


def pack_prims_np(ptype, valid, pa, pb, pc):
    """[P_pad, 128] f32 transposed primitive table (P_pad a multiple of 32)."""
    p = len(ptype)
    p_pad = -(-p // 32) * 32
    tab = np.zeros((p_pad, _N_COLS), np.float32)
    tab[:p, _C_PTYPE] = ptype
    tab[:p, _C_VALID] = valid
    tab[:p, _C_PA:_C_PA + 3] = pa
    tab[:p, _C_PB:_C_PB + 3] = pb
    tab[:p, _C_PC:_C_PC + 3] = pc
    return tab


def pack_sweep_np(ptype, valid, pa, pb, pc):
    """[P_pad, 16] f32 compact sweep table (P_pad as `pack_prims_np`'s), the
    table the round kernels walk in shared memory: columns 0..10 are the
    packed table's; columns 11..15 hold, for a rect, its unit normal n (3),
    bb = max(pb . pb, 1e-20) and cc = max(pc . pc, 1e-20), and zeros for
    every other prim.

    n, bb and cc are computed in f32 by the expressions of `chunk_t`'s rect
    branch, in its order of operations, so they carry the bits the plain
    twin computes for every ray. bb and cc are stored, not their
    reciprocals: `x / bb` and `x * (1 / bb)` round differently, and the
    |ra| <= 1 edge decides a prim id."""
    p = len(ptype)
    tab = np.zeros((-(-p // PBF) * PBF, SWEEP_COLS), np.float32)
    tab[:p, :_C_PC + 3] = pack_prims_np(ptype, valid, pa, pb, pc)[
        :p, :_C_PC + 3]
    pb = np.asarray(pb, np.float32)
    pc = np.asarray(pc, np.float32)
    tiny = np.float32(1e-20)
    pbx, pby, pbz = pb[:, 0], pb[:, 1], pb[:, 2]
    pcx, pcy, pcz = pc[:, 0], pc[:, 1], pc[:, 2]
    with np.errstate(all="ignore"):
        nx = pby * pcz - pbz * pcy
        ny = pbz * pcx - pbx * pcz
        nz = pbx * pcy - pby * pcx
        nlen = np.sqrt(np.maximum(nx * nx + ny * ny + nz * nz, tiny))
        rect = np.stack([nx / nlen, ny / nlen, nz / nlen,
                         np.maximum(pbx * pbx + pby * pby + pbz * pbz, tiny),
                         np.maximum(pcx * pcx + pcy * pcy + pcz * pcz, tiny)],
                        axis=1)
    is_rect = np.asarray(ptype) == PRIM_RECT
    tab[:p, _C_N:] = np.where(is_rect[:, None], rect, np.float32(0.0))
    return tab


# ------------------------------------------------------------- plain twin


def chunk_t(ch, ox, oy, oz, dx, dy, dz, t_min, t_max):
    """t of every ray against every prim of a chunk -> [N, B] (inf = miss).

    `ch` maps the table's attribute names to [1, B] prim columns; rays are
    [N, 1] columns. Every prim type is evaluated and selected by ptype."""
    ptype = ch["ptype"]
    valid = ch["valid"] > 0.5
    pax, pay, paz = ch["pax"], ch["pay"], ch["paz"]
    pbx, pby, pbz = ch["pbx"], ch["pby"], ch["pbz"]
    pcx, pcy, pcz = ch["pcx"], ch["pcy"], ch["pcz"]
    inf = float("inf")

    # ---- watertight triangle: cyclic axis permutation, shear into ray
    # space, edge functions
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    kz_x = (ax > ay) & (ax > az)
    kz_y = ~kz_x & (ay > az)

    def cyc(vx, vy, vz):
        c_kz = torch.where(kz_x, vx, torch.where(kz_y, vy, vz))
        c_kx = torch.where(kz_x, vy, torch.where(kz_y, vz, vx))
        c_ky = torch.where(kz_x, vz, torch.where(kz_y, vx, vy))
        return c_kx, c_ky, c_kz

    dx_, dy_, dz_ = cyc(dx, dy, dz)
    inv_dz = 1.0 / torch.where(torch.abs(dz_) > 1e-30, dz_, 1.0)
    sx = -dx_ * inv_dz
    sy = -dy_ * inv_dz

    def project(vx, vy, vz):
        px, py, pz = cyc(vx - ox, vy - oy, vz - oz)
        return px + sx * pz, py + sy * pz, pz * inv_dz

    x0, y0, z0 = project(pax, pay, paz)
    x1, y1, z1 = project(pbx, pby, pbz)
    x2, y2, z2 = project(pcx, pcy, pcz)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    det = e0 + e1 + e2
    inside = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
               & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    t_tri = t_scaled / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    ok_tri = (inside & (torch.abs(det) > 1e-30) & (t_tri > t_min)
              & (t_tri < t_max))
    t_tri = torch.where(ok_tri, t_tri, inf)

    # ---- sphere: two-root quadratic
    ocx, ocy, ocz = ox - pax, oy - pay, oz - paz
    a = dx * dx + dy * dy + dz * dz
    half_b = ocx * dx + ocy * dy + ocz * dz
    r = pbx
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=1e-20)
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    t0_ok = (disc > 0.0) & (t0 > t_min) & (t0 < t_max)
    t1_ok = (disc > 0.0) & (t1 > t_min) & (t1 < t_max)
    t_sph = torch.where(t0_ok, t0, torch.where(t1_ok, t1, inf))

    # ---- rect: pa center, pb/pc half-edges
    nx = pby * pcz - pbz * pcy
    ny = pbz * pcx - pbx * pcz
    nz = pbx * pcy - pby * pcx
    nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen
    denom_r = dx * nx + dy * ny + dz * nz
    t_r = ((pax - ox) * nx + (pay - oy) * ny + (paz - oz) * nz) / torch.where(
        torch.abs(denom_r) > 1e-12, denom_r, 1.0)
    rx = ox + t_r * dx - pax
    ry = oy + t_r * dy - pay
    rz = oz + t_r * dz - paz
    bb = torch.clamp(pbx * pbx + pby * pby + pbz * pbz, min=1e-20)
    cc = torch.clamp(pcx * pcx + pcy * pcy + pcz * pcz, min=1e-20)
    ra = (rx * pbx + ry * pby + rz * pbz) / bb
    rb_ = (rx * pcx + ry * pcy + rz * pcz) / cc
    ok_r = ((torch.abs(denom_r) > 1e-12) & (torch.abs(ra) <= 1.0)
            & (torch.abs(rb_) <= 1.0) & (t_r > t_min) & (t_r < t_max))
    t_rec = torch.where(ok_r, t_r, inf)

    # ---- disk: pa center, pb unit normal, pc[0] radius
    denom_d = dx * pbx + dy * pby + dz * pbz
    t_d = ((pax - ox) * pbx + (pay - oy) * pby
           + (paz - oz) * pbz) / torch.where(
        torch.abs(denom_d) > 1e-12, denom_d, 1.0)
    qx = ox + t_d * dx - pax
    qy = oy + t_d * dy - pay
    qz = oz + t_d * dz - paz
    r2 = qx * qx + qy * qy + qz * qz
    rad = pcx
    ok_d = ((torch.abs(denom_d) > 1e-12) & (r2 <= rad * rad)
            & (t_d > t_min) & (t_d < t_max))
    t_dsk = torch.where(ok_d, t_d, inf)

    t = t_tri
    t = torch.where(ptype == PRIM_SPHERE, t_sph, t)
    t = torch.where(ptype == PRIM_RECT, t_rec, t)
    t = torch.where(ptype == PRIM_DISK, t_dsk, t)
    return torch.where(valid, t, inf)


def _chunk_cols(tab_blk):
    """[1, B] prim attribute columns of a [B, 128] table block."""
    def a(col):
        return tab_blk[:, col][None, :]

    return dict(
        ptype=a(_C_PTYPE), valid=a(_C_VALID),
        pax=a(_C_PA), pay=a(_C_PA + 1), paz=a(_C_PA + 2),
        pbx=a(_C_PB), pby=a(_C_PB + 1), pbz=a(_C_PB + 2),
        pcx=a(_C_PC), pcy=a(_C_PC + 1), pcz=a(_C_PC + 2),
    )


def _ray_cols(rays):
    return [rays[i][:, None] for i in range(8)]


def sweep_closest_cols(tab, ox, oy, oz, dx, dy, dz, t_min, t_max):
    """Closest hit of [N, 1] ray columns -> (t [N], prim id [N] f32, -1 on
    a miss). Prims are reduced in blocks of PBF: per block the minimum t and
    the minimum id among equal t; a later block wins only if strictly
    closer."""
    n = ox.shape[0]
    inf = float("inf")
    best_t = torch.full((n,), inf, dtype=torch.float32, device=ox.device)
    best_id = torch.full((n,), inf, dtype=torch.float32, device=ox.device)
    for b0 in range(0, tab.shape[0], PBF):
        blk = tab[b0:b0 + PBF]
        t = chunk_t(_chunk_cols(blk), ox, oy, oz, dx, dy, dz, t_min, t_max)
        ids = torch.arange(b0, b0 + blk.shape[0], dtype=torch.float32,
                           device=ox.device)[None, :]
        ct = torch.amin(t, dim=1)
        cid = torch.amin(torch.where(t == ct[:, None], ids, inf), dim=1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_id = torch.where(better, cid, best_id)
    return best_t, torch.where(torch.isfinite(best_t), best_id, -1.0)


def sweep_any_cols(tab, ox, oy, oz, dx, dy, dz, t_min, t_max):
    """Any hit within (t_min, t_max) of [N, 1] ray columns -> bool [N]."""
    blocked = torch.zeros((ox.shape[0],), dtype=torch.bool, device=ox.device)
    for b0 in range(0, tab.shape[0], PBF):
        t = chunk_t(_chunk_cols(tab[b0:b0 + PBF]), ox, oy, oz, dx, dy, dz,
                    t_min, t_max)
        blocked = blocked | torch.isfinite(t).any(dim=1)
    return blocked


def sweep_closest_plain(rays, tab):
    """rays [8, N], tab [P_pad, 128] -> [2, N] (t, prim id or -1)."""
    t, pid = sweep_closest_cols(tab, *_ray_cols(rays))
    return torch.stack([t, pid])


def sweep_any_plain(rays, tab, live=None):
    """rays [8, N], tab [P_pad, 128] -> [1, N] f32 0/1 blocked mask. With
    `live` (bool [N]), only the live lanes are swept and the others read 0,
    as the kernel writes them; None sweeps every lane."""
    if live is None:
        return sweep_any_cols(tab, *_ray_cols(rays)).to(
            torch.float32)[None, :]
    out = torch.zeros((1, rays.shape[1]), dtype=torch.float32,
                      device=rays.device)
    out[0, live] = sweep_any_cols(tab, *_ray_cols(rays[:, live])).float()
    return out


def sweep_closest_rows_plain(src, tab, row0: int, alive_row: int):
    """The closest hit of the rays in rows row0 .. row0 + 5 of src (origin,
    direction; t in (INTERSECTION_TIME_OFFSET, RAY_TMAX)) on the lanes whose
    row alive_row is > 0.5 -> [8, N]: t, prim id or -1, then zeros. A dead
    lane gets t = inf and id -1, as the kernel writes it."""
    global ROWS_PLAIN_CALLS
    ROWS_PLAIN_CALLS += 1
    n = src.shape[1]
    out = torch.zeros((8, n), dtype=torch.float32, device=src.device)
    out[0] = float("inf")
    out[1] = -1.0
    live = src[alive_row] > 0.5
    rays = src[row0:row0 + 6][:, live]
    t, pid = sweep_closest_cols(
        tab, *[rays[k][:, None] for k in range(6)],
        torch.full((rays.shape[1], 1), INTERSECTION_TIME_OFFSET,
                   device=src.device),
        torch.full((rays.shape[1], 1), RAY_TMAX, device=src.device))
    out[0, live] = t
    out[1, live] = pid
    return out


def sweep_any_rows_plain(src, tab, row0: int, tmax_row: int,
                         live_row: int | None = None):
    """Whether anything blocks the rays in rows row0 .. row0 + 5 of src
    (origin, direction) within (INTERSECTION_TIME_OFFSET, src[tmax_row]) ->
    [1, N] f32, 1 = blocked. With `live_row`, only the lanes whose row
    live_row is > 0.5 are swept and the others read 0, as the kernel
    writes them."""
    global ANY_ROWS_PLAIN_CALLS
    ANY_ROWS_PLAIN_CALLS += 1
    n = src.shape[1]
    out = torch.zeros((1, n), dtype=torch.float32, device=src.device)
    live = (src[live_row] > 0.5 if live_row is not None
            else torch.ones(n, dtype=torch.bool, device=src.device))
    rays = src[row0:row0 + 6][:, live]
    out[0, live] = sweep_any_cols(
        tab, *[rays[k][:, None] for k in range(6)],
        torch.full((rays.shape[1], 1), INTERSECTION_TIME_OFFSET,
                   device=src.device),
        src[tmax_row][live][:, None]).float()
    return out


# ---------------------------------------------------------------- wrappers


def _check(rays, tab, rows=8):
    """The ray rows (`rows` of them, unless None) and the table: f32,
    contiguous, 2-D, on one CPU or CUDA device."""
    for name, x in (("rays", rays), ("tab", tab)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if rows is not None and rays.shape[0] != rows:
        raise ValueError(f"rays must be [{rows}, N], got "
                         f"{tuple(rays.shape)}")
    if tab.shape[1] != _N_COLS or tab.shape[0] % PBF:
        raise ValueError(f"tab must be [P_pad (x{PBF}), {_N_COLS}], got "
                         f"{tuple(tab.shape)}")
    if rays.device != tab.device:
        raise ValueError("rays and tab must be on one device")
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")


# why a CUDA tensor's sweep is refused without the sweep table
_NO_SWEEP = ("the CUDA kernel walks the sweep table: pass sweep= "
             "(World.sweep_tab, MegaScene.sweep_tab baked by "
             "bake_mega_scene, or pack_sweep_np of the prims)")


def check_sweep(sweep, tab):
    """The compact sweep table packed beside the dense table `tab`: f32,
    contiguous, [tab rows, SWEEP_COLS], on tab's device."""
    if sweep.dtype != torch.float32:
        raise TypeError(f"sweep_tab must be float32, got {sweep.dtype}")
    if sweep.dim() != 2 or not sweep.is_contiguous():
        raise ValueError("sweep_tab must be a contiguous 2-D tensor")
    if sweep.shape != (tab.shape[0], SWEEP_COLS):
        raise ValueError(f"sweep_tab must be [{tab.shape[0]}, {SWEEP_COLS}], "
                         f"got {tuple(sweep.shape)}")
    if sweep.device != tab.device:
        raise ValueError(f"sweep_tab is on {sweep.device}, not {tab.device}")


def _check_live(live, rays):
    """The lanes to sweep: bool [N], contiguous, on the rays' device."""
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    if live.shape != (rays.shape[1],) or not live.is_contiguous():
        raise ValueError(f"live must be a contiguous [{rays.shape[1]}] "
                         f"tensor, got {tuple(live.shape)}")
    if live.device != rays.device:
        raise ValueError(f"live is on {live.device}, not {rays.device}")


def _launch(fn_name, rays, sweep, out, *flags):
    """Launch a dense sweep kernel on the sweep table `sweep` (`flags`: the
    any-hit kernel's lane-flag pointer)."""
    from pathtracer_tpu_torch.kernels import _build
    from pathtracer_tpu_torch.kernels import megakernel as mk

    stream = torch.cuda.current_stream(rays.device).cuda_stream
    rc = getattr(_build.library(), fn_name)(
        ctypes.c_void_p(rays.data_ptr()), *flags, rays.shape[1],
        ctypes.c_void_p(sweep.data_ptr()), sweep.shape[0],
        mk.SWEEP_RESIDENT_ROWS, ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    return out


def sweep_closest(rays, tab, sweep=None):
    """Closest hit -> [2, N] (t, prim id or -1): the CUDA kernel on a CUDA
    tensor, the plain twin on a CPU tensor. The kernel walks `sweep`, the
    compact table packed beside `tab` (`pack_sweep_np`; `World.sweep_tab`),
    resident in shared memory up to `megakernel.SWEEP_RESIDENT_ROWS` rows,
    else through the ring of tiles; the twin reads `tab`."""
    global CLOSEST_LAUNCHES
    _check(rays, tab)
    if sweep is not None:
        check_sweep(sweep, tab)
    if rays.device.type == "cpu":
        return sweep_closest_plain(rays, tab)
    if sweep is None:
        raise ValueError(_NO_SWEEP)
    out = torch.empty((2, rays.shape[1]), dtype=torch.float32,
                      device=rays.device)
    _launch("dense_sweep_closest", rays, sweep, out)
    CLOSEST_LAUNCHES += 1
    return out


def sweep_closest_rows(src, tab, row0: int, alive_row: int, sweep=None):
    """K1: the closest hit of the live lanes' rays, read in place from rows
    of src -> [8, N] (see `sweep_closest_rows_plain`): the CUDA kernel on a
    CUDA tensor, the plain twin on a CPU tensor. The kernel walks `sweep`,
    the compact table packed beside `tab` (`pack_sweep_np`;
    `MegaScene.sweep_tab`), resident in shared memory up to
    `megakernel.SWEEP_RESIDENT_ROWS` rows, else through the ring of tiles;
    the twin reads `tab`."""
    global ROWS_LAUNCHES
    _check(src, tab, rows=None)
    if not (0 <= row0 and row0 + 6 <= src.shape[0]
            and 0 <= alive_row < src.shape[0]):
        raise ValueError(f"rows {row0}..{row0 + 5} and {alive_row} are not "
                         f"all in src [{src.shape[0]}, N]")
    if sweep is not None:
        check_sweep(sweep, tab)
    if src.device.type == "cpu":
        return sweep_closest_rows_plain(src, tab, row0, alive_row)
    if sweep is None:
        raise ValueError(_NO_SWEEP)
    from pathtracer_tpu_torch.kernels import _build
    from pathtracer_tpu_torch.kernels import megakernel as mk

    out = torch.empty((8, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = _build.library().sweep_closest_rows_launch(
        ctypes.c_void_p(src.data_ptr()), row0, alive_row,
        ctypes.c_void_p(sweep.data_ptr()), sweep.shape[0],
        mk.SWEEP_RESIDENT_ROWS, ctypes.c_void_p(out.data_ptr()),
        src.shape[1], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sweep_closest_rows: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    ROWS_LAUNCHES += 1
    return out


def sweep_any_rows(src, tab, row0: int, tmax_row: int,
                   live_row: int | None = None, sweep=None):
    """K3: the any-hit sweep of the rays read in place from rows of src
    (the K2 rows: one NEE sample's shadow ray at row0 .. row0 + 5, its tmax
    at tmax_row) -> [1, N] f32, 1 = blocked: the CUDA kernel on a CUDA
    tensor, the plain twin on a CPU tensor. The kernel walks `sweep`, the
    compact table packed beside `tab`, as K1 does (see
    `sweep_closest_rows`); the twin reads `tab`.

    The Pallas kernel writes an [8, N] block whose rows 1-7 are zero, an
    alignment device of its compiler; the port writes row 0 alone. The
    Pallas kernel also sweeps every lane, though the finalize reads the
    mask only where the sample was worth a ray: with `live_row` (the
    sample's worth flag, row0 + 7) the port skips the other lanes and
    writes 0 there, as K1 skips dead lanes; None sweeps every lane."""
    global ANY_ROWS_LAUNCHES
    _check(src, tab, rows=None)
    rows = [row0, row0 + 5, tmax_row] + ([] if live_row is None
                                         else [live_row])
    if not all(0 <= r < src.shape[0] for r in rows):
        raise ValueError(f"rows {row0}..{row0 + 5}, {tmax_row} and "
                         f"{live_row} are not all in src [{src.shape[0]}, N]")
    if sweep is not None:
        check_sweep(sweep, tab)
    if src.device.type == "cpu":
        return sweep_any_rows_plain(src, tab, row0, tmax_row, live_row)
    if sweep is None:
        raise ValueError(_NO_SWEEP)
    from pathtracer_tpu_torch.kernels import _build
    from pathtracer_tpu_torch.kernels import megakernel as mk

    out = torch.empty((1, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = _build.library().sweep_any_rows_launch(
        ctypes.c_void_p(src.data_ptr()), row0, tmax_row,
        -1 if live_row is None else live_row,
        ctypes.c_void_p(sweep.data_ptr()), sweep.shape[0],
        mk.SWEEP_RESIDENT_ROWS, ctypes.c_void_p(out.data_ptr()),
        src.shape[1], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sweep_any_rows: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    ANY_ROWS_LAUNCHES += 1
    return out


def sweep_any(rays, tab, sweep=None, live=None):
    """Any hit -> [1, N] f32 0/1: the CUDA kernel on a CUDA tensor, the plain
    twin on a CPU tensor; `sweep` as `sweep_closest`'s. With `live` (bool
    [N]), only the live lanes are swept and the others read 0: the regen
    integrator reads a shadow ray's verdict only where the light sample was
    worth a ray. None sweeps every lane, as the JAX kernel does."""
    global ANY_LAUNCHES
    _check(rays, tab)
    if sweep is not None:
        check_sweep(sweep, tab)
    if live is not None:
        _check_live(live, rays)
    if rays.device.type == "cpu":
        return sweep_any_plain(rays, tab, live)
    if sweep is None:
        raise ValueError(_NO_SWEEP)
    out = torch.empty((1, rays.shape[1]), dtype=torch.float32,
                      device=rays.device)
    _launch("dense_sweep_any", rays, sweep, out, ctypes.c_void_p(
        None if live is None else live.data_ptr()))
    ANY_LAUNCHES += 1
    return out
