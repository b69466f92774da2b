#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from `pathtracer_tpu_torch/kernels/csrc`,
holds each against its plain PyTorch twin on the card, then drives the three
routes of the main path through `render_regen`: the Cornell chip scene
(Cornell box, a dispersive glass sphere, a rough conductor sphere and an
icosahedron) at 1080x1080, 16 spp, through the fused bounce-round kernel;
the two-program round (K12 `shade_sweep`, K34 `finalize_sweep`) on the
multi-chunk gem stand-in at 1080x1080, 8 spp, the 5,120-triangle mesh at
1080x1080, 2 spp, and the HDR blob environment at 512x512, 16 spp; and the
texture-feed round (K1 `sweep_closest_rows`, the torch texture feed, K2
`shade`, K34) on the uv-textured Cornell box at 1080x1080, 16 spp, whose
checker wall must come out resolved. Then the regen integrator without
kernels (`integrator/pt_regen.py`), whose closest-hit and shadow queries
launch `dense_sweep.cu`'s two kernels (the shadow query with the samples'
worth as its `live` mask): the gem at 1080x1080, 8 spp with
`use_megakernel=False` (its film within rtol 0.03 of the two-program
film, its counters within 0.08), `light_grid_cornell` (25 lights, outside
the megakernel's gate) at 1080x1080, 16 spp through the default route
(its film within 0.02 of `cornell_box`'s through the megakernel) and the
fog box at 512x512, 4 spp, medium-aware (within 0.05 of the medium
route's), with both sweep kernels held to their twins bit for bit on the
gem render's own first camera and shadow rays (every lane, and the
masked lanes) and a whole gem render's shadow queries timed with and
without the mask. Then the light-tracing wavefront (`integrator/lt.py:
lt_trace`, torch with `dense_sweep.cu`'s kernels for its closest hits and
lens connections): the textured Cornell box at 1080x1080, 4 light paths per
pixel, max bounces 8, stratified, through `render_splatted`'s default route
(the LT megakernel's gate refuses it; film mean within 0.15 of the path
tracer's at matched bounces), and the lens box at 512x512, 8 paths per
pixel through `lt_trace` and through the LT megakernel (means within 0.15,
particles equal, bounce rays within 0.08); and BDPT (`integrator/bdpt.py`)
through `render_bdpt` on the Cornell box at 512x512, 4 spp, max_depth 4
(film mean within 0.05 of the path tracer's at matched coverage) and 6;
both dense kernels held to their twins bit for bit on an lt_trace bounce's
and a BDPT pass's own rays. Films go to `output/`. Then the
dispersive hero-wavelength furnace and the HDR furnace must come out
uniform. Last, the light tracer: three chained rounds of K12-LT and K34-LT
(v2: in-kernel spawn, on the chip scene with its lens proxy at 1 and 2
camera samples; v1: from the torch spawn feed, on the HDR blob) against
their twins, the film splats the kernels add with atomics against the
`index_add_` of the twins' splat rows (rtol 1e-5), the `render_splatted`
renders of the chip scene with its lens proxy at 1080x1080, 16 light paths
per pixel (v2), and of the HDR blob at 512x512, 4 paths per pixel (v1,
with the device's busy share), and two
estimator checks: light against path tracing on the Cornell box, in-kernel
spawn against the spawn feed on a spike-emission box. Last of all,
participating media and the split round K1 | feeds | K2 | K3 | K4: K3
`sweep_any_rows` on the gem's K2 rows and on random rays over the random
table, each resident and through the ring, against its twin; three chained
medium-aware rounds of the fog box at 1080x1080 (the medium instantiations
of K12, K2, K34 and K4, K1 and K3, each against its twin, and the split
round's rows against the two-program round's, bit for bit; the registers,
spills and blocks an SM of the medium K2 and K12); the fog box
rendered at 1080x1080, 16 spp through the two-program round and again
through the split round, the two films equal; and the Beer-Lambert sphere
and the scattering furnace. Every phase prints
one JSON line; any failure raises and the script exits non-zero. Before
the last line, one JSON line lists every kernel with its launches on the
path that runs it, its agreement with its twin, its time, its twin's and
its bound (the least time the card could take: the larger of the f32
operations over 67 TFLOP/s and the bytes over 3.35 TB/s, the H100 SXM's
published peaks; the kernels are built without FMA contraction, so a sweep
of separate multiplies and adds cannot go under twice a bound by
operations). Every kernel that sweeps walks the compact sweep table from
shared memory: the dense sweeps are held to their twins bit for bit on the
chip table (resident), the 1,120-row random table and a 9,216-row one (the
ring), the first two also with the budget one row under the table, on rays
with per-ray bounds and degenerate lanes too. K12 and K34 are held to their
twins with the table
resident (the gem, the HDR blob), through the ring of tiles (the mesh's 41
tiles) and with the budget set one row under the gem's and the fog box's
tables, and the gem is rendered a second time through the split round (K1
and K3), which must give the same film. The fused round must
equal its twin on every row over three chained rounds at light samples 2
(C = 1 and 4, 1080x1080) and 1 and 3 (C = 1, 256x256); K1, K12-LT and
K34-LT (v2 and v1) their twins on every row of the kernel's own state, the
table resident and with the budget one row under it. The last line is the
device summary:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Run from the repository root:  python3 chip_smoke.py
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of `fn` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    return smi


# the least time the card could take (NVIDIA's H100 SXM data sheet): f32
# outside the tensor cores, and HBM3. The f32 rate counts an FMA as two
# operations; the kernels are built with --fmad=false (the watertight edge
# functions must round as the twins' separate multiplies and subtracts), so
# a sweep that issues one multiply or add an instruction cannot go under
# twice its bound by operations
PEAK_F32 = 67e12     # FLOP/s
PEAK_BYTES = 3.35e12  # B/s
# f32 arithmetic operations (add, sub, mul, div, sqrt) that the sweep needs,
# by prim type (triangle, sphere, rect, disk), counted from the tests of
# csrc/walk.cuh, which run only the prim's own test; an invalid (padding)
# prim costs none. What depends on the ray alone is counted once per ray
# (RAY_OPS: the triangle test's 1/dz and two shear products; the sphere
# test's d.d and its reciprocal), and what depends on the prim alone (a
# rect's unit normal and edge norms: 28 operations) not at all: a bake can
# hold it. Every kernel that sweeps reads the compact sweep table, all 16
# floats of a row (64 B)
PRIM_OPS = (41, 23, 35, 29)
RAY_OPS = (3, 6, 0, 0)
F32 = 4


def sweep_ops(tab):
    """f32 operations of one ray's sweep over every prim of a packed
    table (either table: the columns read here are common to both)."""
    ptype, valid = tab[:, 0].long(), tab[:, 1] > 0.5
    count = [int(((ptype == k) & valid).sum()) for k in range(4)]
    return sum(count[k] * PRIM_OPS[k] + (RAY_OPS[k] if count[k] else 0)
               for k in range(4))


def bound(ops, nbytes):
    """The least time for `ops` f32 operations and `nbytes` bytes moved,
    in ms, and which of the two bounds it."""
    t_ops = ops / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes",
                bound_ops=int(ops), bound_bytes=int(nbytes))


def table_bytes(scene):
    return F32 * sum(int(t.numel()) for t in (
        scene.prim_tab, scene.mat_tab, scene.light_tab, scene.spec_tab))


def shadow_rays(torch, mk, dense, k2, scene, ls):
    """Per NEE sample of a K2 block: (worth-tracing shadow rays, the unblocked
    ones among them), the blocks found by the any-hit sweep kernel."""
    out = []
    for si in range(ls):
        b = mk.O_NEE + mk.NEE_ROWS * si
        worth = k2[b + 7] > 0.5
        tmax = torch.where(worth, k2[b + 6], 0.0)[None]
        rays = torch.cat([k2[b:b + 6], torch.full_like(tmax, 1e-6),
                          tmax]).contiguous()
        blocked = dense.sweep_any(rays, scene.dense_tab,
                                  scene.sweep_tab)[0] > 0.5
        out.append((int(worth.sum()), int((worth & ~blocked).sum())))
    return out


def k34_bound(torch, mk, dense, k2, state, scene, a, sweeps=True):
    """K34: every lane's 32 state rows read and 40 out rows written; a live
    lane's K2 rows (medium-aware: and its scatter flag, C lane weights and 2
    stack rows) and RR/respawn uniforms; each unblocked shadow ray tests
    every prim, and a blocked one at least the cheapest single test. K4
    (`sweeps` False) reads a worth-tracing sample's blocked flag instead of
    its ray, and sweeps nothing."""
    n = state.shape[1]
    live = int((state[mk.S_ALIVE] > 0.5).sum())
    c, ls = a.c_lanes, a.light_samples
    # radiance, sample, ratios, pscale, worth
    k2_live = 3 * c + 9 + ls + ((3 + c) if a.medium else 0)
    nbytes = F32 * (72 * n + live * (k2_live + 6))
    ops = 0
    for worth, free in shadow_rays(torch, mk, dense, k2, scene, ls):
        nbytes += F32 * ((7 if sweeps else 1) * worth + c * free)
        if sweeps:
            ops += free * sweep_ops(scene.dense_tab) + (worth - free) * min(
                PRIM_OPS)
    if sweeps:
        nbytes += F32 * int(scene.sweep_tab.numel())
    return bound(ops, nbytes)


def any_rows_bound(n, worth, free, sweep):
    """K3 on one NEE sample of n lanes, `worth` of them with a shadow ray,
    `free` of those unblocked: every lane's worth flag read and blocked flag
    written, a worth-tracing lane's ray and tmax (7 rows), the sweep table
    (64 B a row); an unblocked ray tests every prim, a blocked one at least
    the cheapest single test."""
    return bound(free * sweep_ops(sweep) + (worth - free) * min(PRIM_OPS),
                 F32 * (2 * n + 7 * worth + int(sweep.numel())))


def k2_any_rows_bound(torch, mk, dense, k2, scene, si):
    """`any_rows_bound` of K3 on NEE sample si of a K2 block."""
    worth, free = shadow_rays(torch, mk, dense, k2, scene, si + 1)[si]
    return any_rows_bound(k2.shape[1], worth, free, scene.sweep_tab)


def rows_bound(mk, state, sweep):
    """K1: every lane's alive flag, a live lane's ray rows and sweep, every
    lane's 8 out rows, the sweep table (64 B a row)."""
    n = state.shape[1]
    live = int((state[mk.S_ALIVE] > 0.5).sum())
    return bound(live * sweep_ops(sweep),
                 F32 * (n + 6 * live + 8 * n + int(sweep.numel())))


def shade_bound(mk, state, scene, a, sweep, fed_rows):
    """K12 (sweep) or K2: a live lane reads its ray, λ, β, radiance, bounce,
    pdf (and HWSS pdf ratios) rows, the NEE and BSDF uniforms and
    `fed_rows` more (K2: t, prim id and the texture rows); every lane's K2
    rows are written. K12 sweeps the table for each live lane; the shading
    arithmetic is not counted, so the operations are a lower bound."""
    n = state.shape[1]
    live = int((state[mk.S_ALIVE] > 0.5).sum())
    c, ls = a.c_lanes, a.light_samples
    rows = 8 + 3 * c + (c if c > 1 else 0) + 3 * ls + 3 + fed_rows
    nbytes = F32 * (n + live * rows + mk.k2_rows(ls) * n) + table_bytes(scene)
    ops = 0
    if sweep:
        nbytes += F32 * int(scene.sweep_tab.numel())
        ops = live * sweep_ops(scene.dense_tab)
    return bound(ops, nbytes)


def phase_build(torch):
    from pathtracer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.library()
    secs = time.perf_counter() - t0
    import ctypes

    attrs = {}
    # kernel -> (two_prog_attrs's `which`, has C and medium instantiations)
    which = {"shade_sweep": (0, True), "finalize_sweep": (1, True),
             "shade": (2, True), "sweep_closest_rows": (3, False),
             "finalize": (4, True), "sweep_any_rows": (5, False)}
    two_prog = {name: {} for name in which}
    for c in (1, 4):
        regs, local = ctypes.c_int(), ctypes.c_int()
        shared, blocks = ctypes.c_int(), ctypes.c_int()
        rc = lib.fused_round_attrs(c, ctypes.byref(regs), ctypes.byref(local),
                                   ctypes.byref(shared), ctypes.byref(blocks))
        check(rc == 0, f"fused_round_attrs: CUDA error {rc}")
        attrs[f"C{c}"] = dict(regs=regs.value, local_bytes=local.value,
                              static_shared_bytes=shared.value,
                              blocks_per_sm=blocks.value)
        for name, (k, templated) in which.items():
            if not templated and c != 1:
                continue  # one instantiation
            for medium in ((False, True) if templated else (False,)):
                rc = lib.two_prog_attrs(k + (8 if medium else 0), c,
                                        ctypes.byref(regs),
                                        ctypes.byref(local))
                check(rc == 0, f"two_prog_attrs: CUDA error {rc}")
                two_prog[name][f"C{c}" + ("_medium" if medium else "")] = \
                    dict(regs=regs.value, local_bytes=local.value)
    # the dynamic shared memory of the kernels that walk the sweep table and
    # the blocks an SM holds: the gem's 352-row table (chip_lens's 32 rows
    # for the LT kernels) resident, the largest table the budget keeps
    # resident, and the ring. (walk_shared_bytes's which, or the LT kernel's
    # which and camera samples)
    from pathtracer_tpu_torch.kernels import megakernel as mk

    walk_shared = {}
    budget = mk.SWEEP_RESIDENT_ROWS
    for name, k, lt_cs in (("shade_sweep", 0, None),
                           ("finalize_sweep", 1, None),
                           ("sweep_closest_rows", 3, None),
                           ("sweep_any_rows", 5, None),
                           ("lt_shade", 0, 1), ("lt_finalize_spawn", 1, 1),
                           ("lt_finalize_spawn_cs2", 1, 2),
                           ("lt_finalize", 2, 1)):
        first = 352 if lt_cs is None else 32
        for label, rows in ((f"resident_{first}_rows", first),
                            (f"resident_{budget}_rows", budget),
                            ("ring", budget + 32)):
            stat, dyn, blocks = (ctypes.c_int(), ctypes.c_int(),
                                 ctypes.c_int())
            out = (ctypes.byref(stat), ctypes.byref(dyn), ctypes.byref(blocks))
            rc = (lib.walk_shared_bytes(k, 1, rows, budget, *out)
                  if lt_cs is None else
                  lib.lt_round_shared_bytes(k, lt_cs, rows, budget, *out))
            check(rc == 0, f"{name} shared bytes: CUDA error {rc}")
            walk_shared[f"{name}_{label}"] = dict(
                static_bytes=stat.value, dynamic_bytes=dyn.value,
                blocks_per_sm=blocks.value)
    # K34-LT v2 has one instantiation per camera-sample count it walks
    # jointly (1 and 2) and one for any other count
    lt_round = {}
    for which, name in enumerate(("lt_shade", "lt_finalize_spawn",
                                  "lt_finalize")):
        for cs in ((1, 2, 3) if which == 1 else (1,)):
            rc = lib.lt_round_attrs(which, cs, ctypes.byref(regs),
                                    ctypes.byref(local))
            check(rc == 0, f"lt_round_attrs: CUDA error {rc}")
            lt_round.setdefault(name, {})[f"cs{cs}"] = dict(
                regs=regs.value, local_bytes=local.value)
    rc = lib.tex_feed_attrs(ctypes.byref(regs), ctypes.byref(local))
    check(rc == 0, f"tex_feed_attrs: CUDA error {rc}")
    tex_feed = dict(regs=regs.value, local_bytes=local.value)
    log = _build.BUILD_INFO.get("log", "")
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln.lower() or "spill" in ln.lower()
             or "Function properties" in ln or "Compiling entry" in ln]
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    with open(os.path.join(ROOT, "output", "nvcc_resource_usage.txt"),
              "w") as f:
        f.write(log)
    emit("build", seconds=round(secs, 2), flags=_build.NVCC_FLAGS,
         fused_round=attrs, **two_prog, **lt_round, tex_feed=tex_feed,
         resident_rows=mk.SWEEP_RESIDENT_ROWS, walk_shared=walk_shared,
         resource_usage=usage[:90])


def occupancy(which, c, rows, budget):
    """Registers, local (spill) bytes and blocks an SM of a two-program
    kernel (`walk_shared_bytes`'s which: 0 K12, 2 K2, + 8 medium) at C lanes
    and a sweep table of `rows` rows."""
    import ctypes

    from pathtracer_tpu_torch.kernels import _build

    lib = _build.library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    stat, dyn, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.two_prog_attrs(which, c, ctypes.byref(regs), ctypes.byref(local))
    check(rc == 0, f"two_prog_attrs: CUDA error {rc}")
    rc = lib.walk_shared_bytes(which, c, rows, budget, ctypes.byref(stat),
                               ctypes.byref(dyn), ctypes.byref(blocks))
    check(rc == 0, f"walk_shared_bytes: CUDA error {rc}")
    return dict(regs=regs.value, local_bytes=local.value,
                blocks_per_sm=blocks.value)


def _rays(torch, n, gen, dev, tmax=None):
    o = torch.rand((3, n), generator=gen, device=dev) * 1.4 - 0.2
    d = torch.randn((3, n), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=0, keepdim=True)
    tmin = torch.full((1, n), 1e-6, device=dev)
    tm = torch.full((1, n), 1e9, device=dev) if tmax is None else tmax
    return torch.cat([o, d, tmin, tm]).contiguous()


def one_row_under(mk, rows, fn):
    """fn() with the residency budget one row under a sweep table of `rows`
    rows: the table goes through the ring of tiles."""
    budget0 = mk.SWEEP_RESIDENT_ROWS
    try:
        mk.SWEEP_RESIDENT_ROWS = rows - 1
        return fn()
    finally:
        mk.SWEEP_RESIDENT_ROWS = budget0


def sweep_tables(torch, dev):
    """The sweep phases' tables, each as (the [P_pad, 128] dense table, the
    compact sweep table packed beside it): the chip scene's (28 prims, 32
    rows: resident) and a random one of all four prim types (1,100 prims,
    1,120 rows: through the ring at the default budget)."""
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels.megakernel import build_mega_scene
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.parsing import SceneBuilder

    chip = build_mega_scene(
        scenes.chip_scene(SceneBuilder(), spectral).build(dev),
        make_projective_camera(**scenes.CORNELL_CAMERA, device=dev), dev)
    p = scenes.random_prims(SceneBuilder(), spectral, seed=1, grid=20,
                            n_each=100).build("cpu").prims
    cols = (p.ptype.numpy(), p.valid.numpy(), p.pa.numpy(), p.pb.numpy(),
            p.pc.numpy())
    return {
        "chip": (chip.dense_tab, chip.sweep_tab),
        "random": (torch.as_tensor(dense.pack_prims_np(*cols), device=dev),
                   torch.as_tensor(dense.pack_sweep_np(*cols), device=dev)),
    }


def big_table(torch, dev):
    """A random table of all four prim types over the round kernels'
    8192-row cap (an 800-triangle mesh and 2,800 each of spheres, rects and
    disks: 9,200 prims, 9,216 rows), which the dense sweeps walk through the
    ring -> (the [P_pad, 128] dense table, the sweep table)."""
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.parsing import SceneBuilder

    w = scenes.random_prims(SceneBuilder(), spectral, seed=1, grid=20,
                            n_each=2800).build(dev)
    return w.dense_tab, w.sweep_tab


def odd_rays(torch, n, gen, dev):
    """Rays with per-ray bounds and the degenerate lanes the regen
    integrator and the JAX padding hand the dense sweeps: t_min drawn in
    (0, 0.3) on a third of the lanes, t_max in (0.05, 1.5); t_min = t_max
    = 0 with a zero direction; NaN and inf origins; NaN and zero
    directions; t_min >= t_max."""
    rays = _rays(torch, n, gen, dev, torch.rand(
        (1, n), generator=gen, device=dev) * 1.45 + 0.05)
    pick = torch.rand(n, generator=gen, device=dev)
    rays[6] = torch.where(pick < 0.3, pick, rays[6])
    k = torch.arange(n, device=dev)
    rays[3:8, k % 97 == 1] = 0.0
    rays[0, k % 89 == 2] = float("nan")
    rays[1, k % 83 == 3] = float("inf")
    rays[4, k % 79 == 4] = float("nan")
    rays[3:6, k % 73 == 5] = 0.0
    swap = k % 71 == 6
    rays[6, swap], rays[7, swap] = rays[7, swap] + 0.01, rays[6, swap]
    return rays


def dense_equal(torch, mk, tab, sweep, rays, live=None):
    """Both dense sweeps on `rays` (the any-hit one also with the `live`
    mask) equal to their twins bit for bit, at the default residency budget
    and, for a table a budget can hold (3,584 rows), with the budget one row
    under it (the ring) -> (the closest hits, the masks, the largest |t -
    twin's t| over the hits)."""
    from pathtracer_tpu_torch.kernels import dense

    rows = int(sweep.shape[0])
    want = (dense.sweep_closest_plain(rays, tab),
            dense.sweep_any_plain(rays, tab),
            None if live is None else dense.sweep_any_plain(rays, tab, live))

    def run():
        return (dense.sweep_closest(rays, tab, sweep),
                dense.sweep_any(rays, tab, sweep),
                None if live is None else dense.sweep_any(rays, tab, sweep,
                                                          live))

    err = 0.0
    hit = want[0][1] >= 0
    runs = [("default", run())]
    # a budget holds at most 3584 rows: a larger table is always the ring's
    if rows - 1 <= 3584:
        runs.append(("one_row_under", one_row_under(mk, rows, run)))
    for staging, got in runs:
        for name, k, p in zip(("closest", "any", "any_live"), got, want):
            if p is None:
                continue
            check(torch.equal(k, p), f"dense_sweep_{name} on {rows} rows "
                  f"({staging} budget): differs from the twin on "
                  f"{int((k != p).any(dim=0).sum())} rays")
        if hit.any():
            err = max(err, float((got[0][0][hit] - want[0][0][hit]).abs()
                                 .max()))
    return want[0], want[1], err


def phase_sweep(torch, dev, n_rays):
    """dense_sweep_closest and dense_sweep_any (the walk on the sweep table)
    against their twins, bit for bit: on the chip table (resident), the
    random table (1,120 rows: the ring) and a 9,216-row one (over the round
    kernels' cap), each at the default budget and one row under the table,
    on random rays (t in (1e-6, 1e9); shadow rays with t_max in (0.05,
    1.5)) and on rays with per-ray bounds and degenerate lanes (with and
    without a `live` mask); then the kernels' and the twins' times and the
    bounds on the random rays."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk

    tabs = dict(sweep_tables(torch, dev), big=big_table(torch, dev))
    gen = torch.Generator(device=dev).manual_seed(11)
    res = {}
    for name, (tab, sweep) in tabs.items():
        # the twin sweeps the 9,216 rows in 288 blocks: fewer rays there
        n = n_rays // 8 if name == "big" else n_rays
        rays = _rays(torch, n, gen, dev)
        tmax = torch.rand((1, n), generator=gen, device=dev) * 1.45 + 0.05
        rays_a = _rays(torch, n, gen, dev, tmax)
        k, _, err = dense_equal(torch, mk, tab, sweep, rays)
        ka = dense_equal(torch, mk, tab, sweep, rays_a)[1]
        odd = odd_rays(torch, n, gen, dev)
        live = torch.rand(n, generator=gen, device=dev) < 0.6
        err = max(err, dense_equal(torch, mk, tab, sweep, odd, live)[2])
        hit = k[1] >= 0
        ms = cuda_ms(torch, lambda: dense.sweep_closest(rays, tab, sweep),
                     20)
        plain_ms = cuda_ms(torch, lambda: dense.sweep_closest_plain(rays, tab),
                           3)
        ms_any = cuda_ms(torch, lambda: dense.sweep_any(rays_a, tab, sweep),
                         20)
        plain_any = cuda_ms(torch, lambda: dense.sweep_any_plain(rays_a, tab),
                            3)
        rows = int(sweep.shape[0])
        res[name] = dict(prims=rows, rays=n,
                         staging=("resident" if rows <= mk.SWEEP_RESIDENT_ROWS
                                  else "ring"),
                         hit_frac=float(hit.float().mean()),
                         max_abs_err_t=err, closest_ms=ms,
                         closest_plain_ms=plain_ms, any_ms=ms_any,
                         any_plain_ms=plain_any,
                         any_frac=float(ka.mean()),
                         odd_rays_equal=True,
                         closest_bound=bound(
                             n * sweep_ops(sweep),
                             F32 * (10 * n + int(sweep.numel()))),
                         # an unblocked ray tests every prim, a blocked one
                         # at least the cheapest single test
                         any_bound=bound(
                             int((ka == 0).sum()) * sweep_ops(sweep)
                             + int(ka.sum()) * min(PRIM_OPS),
                             F32 * (9 * n + int(sweep.numel()))))
    emit("sweep", **res)
    return res


def phase_rows_sweep(torch, dev, n_lanes):
    """K1 on a state of `n_lanes` lanes (random rays in rows S_O..S_D+2,
    nine lanes in ten alive) against its twin, its rows equal to the twin's
    bit for bit (a dead lane reads as a miss), with the sweep table at the
    default budget (the chip table resident, the random one through the
    ring) and again with the budget one row under the table."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk

    gen = torch.Generator(device=dev).manual_seed(12)
    res = {}
    for name, (tab, sweep) in sweep_tables(torch, dev).items():
        state = torch.rand((mk.NS, n_lanes), generator=gen, device=dev)
        state[mk.S_O:mk.S_O + 6] = _rays(torch, n_lanes, gen, dev)[:6]
        state[mk.S_ALIVE] = (torch.rand(n_lanes, generator=gen, device=dev)
                             < 0.9).float()
        rows = int(sweep.shape[0])

        def run():
            return dense.sweep_closest_rows(state, tab, mk.S_O, mk.S_ALIVE,
                                            sweep)

        def twin():
            return dense.sweep_closest_rows_plain(state, tab, mk.S_O,
                                                  mk.S_ALIVE)

        k, pl = run(), twin()
        k_under = one_row_under(mk, rows, run)
        torch.cuda.synchronize()
        err = compare_hits(torch, k, pl, f"rows sweep {name}")
        for what, x in (("default budget", k), ("budget one row under", 
                                                  k_under)):
            check(torch.equal(x, pl), f"rows sweep {name}, {what}: the rows "
                  "differ from the twin's")
        res[name] = dict(
            prims=int(tab.shape[0]), lanes=n_lanes,
            live=int((state[mk.S_ALIVE] > 0.5).sum()),
            staging="resident" if rows <= mk.SWEEP_RESIDENT_ROWS else "ring",
            hit_frac=float((k[1] >= 0).float().mean()), max_abs_err_t=err,
            equal=True, under_budget_equal=True,
            ms=cuda_ms(torch, run, 20), plain_ms=cuda_ms(torch, twin, 3),
            **rows_bound(mk, state, sweep))
    emit("rows_sweep", **res)
    return res


def compare_hits(torch, k, p, what):
    """[8, N] hit rows of a kernel and its twin: prim ids equal on every
    lane, t within rtol 1e-5 where a prim was hit -> max abs t error."""
    check(torch.equal(k[1], p[1]), f"{what}: prim ids differ on "
          f"{int((k[1] != p[1]).sum())} lanes")
    hit = k[1] >= 0
    tk, tp = k[0][hit], p[0][hit]
    check(torch.allclose(tk, tp, rtol=1e-5, atol=0.0),
          f"{what}: t differs beyond rtol 1e-5")
    return float((tk - tp).abs().max()) if tk.numel() else 0.0


def compare_rows(torch, out_k, out_p, disc, rows):
    """Discrete rows `disc` must be equal on >= 99.99% of lanes; on those
    lanes the continuous `rows` must be within rtol 1e-4, atol 1e-5. A NaN
    on either side fails, and makes the max abs error NaN."""
    match = (out_k[disc] == out_p[disc]).all(dim=0)
    frac = float(match.float().mean())
    cont = [r for r in rows if r not in disc]
    a, b = out_k[cont][:, match], out_p[cont][:, match]
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5)
    bad_rows = {int(cont[i]): int((~close[i]).sum())
                for i in range(len(cont)) if not bool(close[i].all())}
    err = float((a - b).abs().max()) if a.numel() else 0.0
    rel = float(((a - b).abs() / b.abs().clamp(min=1e-30))[~close].max()) \
        if bad_rows else 0.0
    return frac, bad_rows, err, rel


def compare_round(torch, mk, out_k, out_p):
    """The fused round's discrete rows are alive, bounce, samples left and
    the counters; its continuous rows the other state rows."""
    disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.O4_BOUNCE_CT,
            mk.O4_CAMERA_CT, mk.O4_SHADOW_CT, mk.O4_ENV_CT]
    return compare_rows(torch, out_k, out_p, disc, range(mk.NS))


def phase_round(torch, dev, width, odd_width):
    """Three chained fused rounds of the chip scene against the twin, each
    side on its own state, which must be equal on every row: at `width`
    x `width`, light samples 2, C = 1 and 4 (then the kernel's and the
    twin's times on the first round's inputs, and the bound), and at
    `odd_width` x `odd_width`, C = 1, light samples 1 and 3."""
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.parsing import SceneBuilder

    world = scenes.chip_scene(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    res = {}
    for c, ls, w in ((1, 2, width), (4, 2, width), (1, 1, odd_width),
                     (1, 3, odd_width)):
        settings = PTSettings(max_bounces=12, min_bounces=1,
                              light_samples=ls, russian_roulette=True,
                              hwss=c == 4)
        scene = mk.build_mega_scene(world, cam, dev)
        a = mk.RoundArgs.make(scene.consts, settings, w, w)
        n = w * w
        n_pad = -(-n // mk.TILE) * mk.TILE
        gen = torch.Generator(device=dev).manual_seed(5 + c + 10 * ls)
        state0, _ = mk.mega_init(
            cam, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 16)
        nu = mk.nu_rows(a.light_samples)
        sk = sp = state0
        rounds = []
        for r in range(3):
            u = torch.rand((nu, n_pad), generator=gen, device=dev)
            ok = mk.fused_round(u, sk, scene, a)
            op = mk.fused_round_plain(u, sp, scene.dense_tab, scene.prim_tab,
                                      scene.mat_tab, scene.light_tab,
                                      scene.spec_tab, a)
            torch.cuda.synchronize()
            frac, bad, err, rel = compare_round(torch, mk, ok, op)
            rounds.append(dict(match_frac=frac, bad_rows=bad,
                               max_abs_err=err, max_rel_err_bad=rel,
                               equal=bool(torch.equal(ok, op)),
                               alive=float(ok[mk.S_ALIVE].sum()),
                               shadow_rays=float(ok[mk.O4_SHADOW_CT].sum())))
            sk, sp = ok[:mk.NS], op[:mk.NS]
        rec = dict(lanes=n_pad, light_samples=ls, rounds=rounds)
        if w == width:
            u = torch.rand((nu, n_pad), generator=gen, device=dev)
            rec["ms"] = cuda_ms(torch, lambda: mk.fused_round(u, state0,
                                                              scene, a), 10)
            rec["plain_ms"] = cuda_ms(torch, lambda: mk.fused_round_plain(
                u, state0, scene.dense_tab, scene.prim_tab, scene.mat_tab,
                scene.light_tab, scene.spec_tab, a), 2)
            # the bound of the timed call: every lane's state read and out
            # written, a live lane's uniforms, its closest-hit sweep, and
            # each shadow ray at least its cheapest single test; the sweep
            # table at 64 B a row
            live = int((state0[mk.S_ALIVE] > 0.5).sum())
            shadows = int(mk.fused_round(u, state0, scene, a)[
                mk.O4_SHADOW_CT].sum())
            rec.update(bound(live * sweep_ops(scene.dense_tab)
                             + shadows * min(PRIM_OPS),
                             F32 * (72 * n_pad + live * (nu - 1))
                             + table_bytes(scene)
                             + F32 * int(scene.sweep_tab.numel())))
            res[f"C{c}"] = rec
        else:
            res[f"C{c}_ls{ls}_{w}"] = rec
    emit("fused_round", **res)
    for key, r in res.items():
        for i, rd in enumerate(r["rounds"]):
            check(rd["equal"] and rd["match_frac"] == 1.0 and not
                  rd["bad_rows"] and rd["max_abs_err"] == 0.0,
                  f"fused round {key} #{i}: not equal to the twin: {rd}")
        check(r["rounds"][-1]["shadow_rays"] > 0,
              f"fused round {key}: no shadow ray was walked")
    return res


def _scene(torch, dev, recipe, cam, c_lanes, max_bounces=12, min_bounces=1):
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.parsing import SceneBuilder

    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**getattr(scenes, cam), device=dev)
    settings = PTSettings(max_bounces=max_bounces, min_bounces=min_bounces,
                          light_samples=2, russian_roulette=True,
                          hwss=c_lanes == 4)
    return world, camera, settings, mk.build_mega_scene(world, camera, dev)


def phase_two_prog(torch, dev, cases):
    """Three chained rounds of K12 + K34 against their plain twins, each
    route chained on its own state from one camera spawn; then the kernels'
    and the twins' times on the first round's inputs."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk

    res = {}
    for recipe, cam, c, width in cases:
        world, camera, settings, scene = _scene(torch, dev, recipe, cam, c)
        check(not mk.fused_ok(scene), f"{recipe} is in the fused gate")
        a = mk.RoundArgs.make(scene.consts, settings, width, width)
        n = width * width
        n_pad = -(-n // mk.TILE) * mk.TILE
        gen = torch.Generator(device=dev).manual_seed(17 + c)
        state0, _ = mk.mega_init(
            camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 8)
        ls = a.light_samples
        k2_disc = [mk.O_AT_SURF, mk.O_ENV_CT, mk.O_SHADOW_CT,
                   mk.O_SAMPLE_OK] + [mk.O_NEE + mk.NEE_ROWS * si + 7
                                      for si in range(ls)]
        out_disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.O4_BOUNCE_CT,
                    mk.O4_CAMERA_CT]

        def feed(st, u12):
            return (mk.env_feed(scene.env, st, u12, ls, c)
                    if scene.env is not None else None)

        sk = sp = state0
        rounds, first = [], None
        for r in range(3):
            u12 = torch.rand((mk.n_u_rows(ls), n_pad), generator=gen,
                             device=dev)
            u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
            k2k = mk.shade_sweep(u12, sk, scene, a, feed(sk, u12))
            k2p = mk.shade_sweep_plain(u12, sp, a=a, ef=feed(sp, u12),
                                       **mk._tables(scene))
            ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
            op = mk.finalize_sweep_plain(u34, sp, k2p, scene.dense_tab, a)
            torch.cuda.synchronize()
            f12, bad12, err12, rel12 = compare_rows(
                torch, k2k, k2p, k2_disc, range(k2k.shape[0]))
            f34, bad34, err34, rel34 = compare_rows(
                torch, ok, op, out_disc, range(mk.NS))
            rounds.append(dict(
                k12=dict(match_frac=f12, bad_rows=bad12, max_abs_err=err12,
                         max_rel_err_bad=rel12),
                k34=dict(match_frac=f34, bad_rows=bad34, max_abs_err=err34,
                         max_rel_err_bad=rel34),
                alive=float(ok[mk.S_ALIVE].sum()),
                at_surface=float(k2k[mk.O_AT_SURF].sum())))
            if first is None:
                first = (u12, u34, k2k)
            sk, sp = ok[:mk.NS], op[:mk.NS]
        u12, u34, k2_0 = first
        ef0 = feed(state0, u12)
        ms12 = cuda_ms(torch, lambda: mk.shade_sweep(u12, state0, scene, a,
                                                     ef0), 10)
        plain12 = cuda_ms(torch, lambda: mk.shade_sweep_plain(
            u12, state0, a=a, ef=ef0, **mk._tables(scene)), 2)
        ms34 = cuda_ms(torch, lambda: mk.finalize_sweep(u34, state0, k2_0,
                                                        scene, a), 10)
        plain34 = cuda_ms(torch, lambda: mk.finalize_sweep_plain(
            u34, state0, k2_0, scene.dense_tab, a), 2)
        fed = 0 if ef0 is None else int(ef0.shape[0])
        res[f"{recipe}_{width}_C{c}"] = dict(
            lanes=n_pad, prims=int(scene.dense_tab.shape[0]),
            env_kind=scene.consts["env_kind"], rounds=rounds,
            shade_sweep_ms=ms12, shade_sweep_plain_ms=plain12,
            finalize_sweep_ms=ms34, finalize_sweep_plain_ms=plain34,
            shade_sweep_bound=shade_bound(mk, state0, scene, a, True, fed),
            finalize_sweep_bound=k34_bound(torch, mk, dense, k2_0, state0,
                                           scene, a))
        del sk, sp, ok, op, k2k, k2p, first, k2_0
        torch.cuda.empty_cache()
    emit("two_prog_round", **res)
    for key, r in res.items():
        for i, rd in enumerate(r["rounds"]):
            for k in ("k12", "k34"):
                check(rd[k]["match_frac"] >= 0.9999,
                      f"{k} {key} #{i}: discrete rows match on only "
                      f"{rd[k]['match_frac']:.6f} of lanes")
                check(not rd[k]["bad_rows"],
                      f"{k} {key} #{i}: rows beyond rtol 1e-4 atol 1e-5: "
                      f"{rd[k]['bad_rows']}")
    return res


def phase_walk_ring(torch, dev, width):
    """K12 and K34 through the ring of tiles on tables that the default
    budget keeps resident: one round at `width` x `width` of the gem (352
    rows: three tiles through the three stages) and of the medium-aware fog
    box (32 rows: one short tile), C = 1 and 4, with the residency budget
    set one row under the table. The rows must equal the resident walk's
    bit for bit and agree with the plain twins'."""
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels import megakernel as mk

    res = {}
    budget0 = mk.SWEEP_RESIDENT_ROWS
    for recipe, medium in (("gem_cornell", False), ("fog_cornell", True)):
        for c in (1, 4):
            world, camera, _, _ = _scene(torch, dev, recipe, "CORNELL_CAMERA",
                                         c)
            settings = PTSettings(max_bounces=12, min_bounces=1,
                                  light_samples=2, russian_roulette=True,
                                  hwss=c == 4, medium_aware=medium)
            scene = mk.build_mega_scene(world, camera, dev, settings)
            rows = int(scene.sweep_tab.shape[0])
            check(rows <= budget0, f"{recipe}: {rows} rows are not resident")
            a = mk.RoundArgs.make(scene.consts, settings, width, width)
            n = width * width
            n_pad = -(-n // mk.TILE) * mk.TILE
            gen = torch.Generator(device=dev).manual_seed(29 + c)
            state, _ = mk.mega_init(
                camera, torch.rand((n_pad, 5), generator=gen, device=dev), a,
                n, n_pad, 8)
            ls = a.light_samples
            u12 = torch.rand((mk.n_u_rows(ls, medium), n_pad), generator=gen,
                             device=dev)
            u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
            mf = mk.med_feed(scene.med, state, u12, ls, c) if medium else None
            k2_disc = [mk.O_AT_SURF, mk.O_ENV_CT, mk.O_SHADOW_CT,
                       mk.O_SAMPLE_OK, mk.O_SCAT, mk.O_MSTK, mk.O_MSTK + 1
                       ] + [mk.O_NEE + mk.NEE_ROWS * si + 7
                            for si in range(ls)]
            out_disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.S_MSTK0,
                        mk.S_MSTK1, mk.O4_BOUNCE_CT, mk.O4_CAMERA_CT]
            k2r = mk.shade_sweep(u12, state, scene, a, None, mf)
            outr = mk.finalize_sweep(u34, state, k2r, scene, a)
            try:
                mk.SWEEP_RESIDENT_ROWS = rows - 1
                k2k = mk.shade_sweep(u12, state, scene, a, None, mf)
                outk = mk.finalize_sweep(u34, state, k2k, scene, a)
                torch.cuda.synchronize()
            finally:
                mk.SWEEP_RESIDENT_ROWS = budget0
            k2p = mk.shade_sweep_plain(u12, state, a=a, mf=mf,
                                       **mk._tables(scene))
            outp = mk.finalize_sweep_plain(u34, state, k2k, scene.dense_tab,
                                           a)
            f12, bad12, err12, _ = compare_rows(torch, k2k, k2p, k2_disc,
                                                range(k2k.shape[0]))
            f34, bad34, err34, _ = compare_rows(torch, outk, outp, out_disc,
                                                range(mk.NS))
            res[f"{recipe}_C{c}"] = dict(
                lanes=n_pad, rows=rows, budget_rows=rows - 1,
                tiles=-(-rows // 128),
                k12=dict(match_frac=f12, bad_rows=bad12, max_abs_err=err12,
                         equals_resident=bool(torch.equal(k2k, k2r))),
                k34=dict(match_frac=f34, bad_rows=bad34, max_abs_err=err34,
                         equals_resident=bool(torch.equal(outk, outr))),
                shadow_rays=float(k2k[mk.O_SHADOW_CT].sum()))
    emit("walk_ring", **res)
    for key, r in res.items():
        for k in ("k12", "k34"):
            check(r[k]["equals_resident"], f"{k} {key}: the ring's rows "
                  "differ from the resident table's")
            check(r[k]["match_frac"] >= 0.9999 and not r[k]["bad_rows"],
                  f"{k} {key} through the ring: {r[k]}")
        check(r["shadow_rays"] > 0, f"{key}: no shadow ray was walked")
    return res


def tex_feed_bound(mk, feed, tp, c):
    """The texture feed: every lane's t and prim id rows and its
    tf_rows(C) out rows; a lane that hit reads its o, d and C λ rows; the
    uv tables once, and of the pair table at most the 8 B a λ a hit lane
    gathers."""
    n = tp.shape[1]
    hit = int((tp[1] >= 0).sum())
    tables = (feed.uvtab.numel() + feed.mat2tex.numel()
              + feed.lut["meta"].numel())
    pairs = min(feed.lut["pairs"].numel(), 2 * c * hit)
    return bound(0, F32 * ((2 + mk.tf_rows(c)) * n + (6 + c) * hit + tables
                           + pairs))


def phase_texfeed(torch, dev, width):
    """Three chained texture-feed rounds of textured_cornell at C = 1 and 4:
    K1, the texture feed's kernel, K2 and K34 against their twins (each
    route chained on its own state from one camera spawn, the kernels' fed
    by the feed's kernel, the twins' by `tex_feed_plain`, each of its own
    hit rows), K1's rows and the feed's kernel's also equal to their twins'
    on the kernels' own inputs bit for bit, K1's sweep table resident and
    with the budget one row under it; then the kernels', the twins' and the
    feed's times on the first round's inputs, and the device kernels one
    feed and one round launch."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk

    res = {}
    for c in (1, 4):
        world, camera, settings, scene = _scene(
            torch, dev, "textured_cornell", "TEXTURED_CAMERA", c)
        check(scene.tex is not None and not mk.fused_ok(scene),
              "textured_cornell does not ride the texture-feed round")
        a = mk.RoundArgs.make(scene.consts, settings, width, width)
        n = width * width
        n_pad = -(-n // mk.TILE) * mk.TILE
        gen = torch.Generator(device=dev).manual_seed(23 + c)
        state0, _ = mk.mega_init(
            camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 16)
        ls = a.light_samples
        k2_disc = [mk.O_AT_SURF, mk.O_ENV_CT, mk.O_SHADOW_CT,
                   mk.O_SAMPLE_OK] + [mk.O_NEE + mk.NEE_ROWS * si + 7
                                      for si in range(ls)]
        out_disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.O4_BOUNCE_CT,
                    mk.O4_CAMERA_CT]

        def k1(st):
            return dense.sweep_closest_rows(st, scene.dense_tab, mk.S_O,
                                            mk.S_ALIVE, scene.sweep_tab)

        def k1_plain(st):
            return dense.sweep_closest_rows_plain(st, scene.dense_tab,
                                                  mk.S_O, mk.S_ALIVE)

        def k1_ring(st):
            return one_row_under(mk, int(scene.sweep_tab.shape[0]),
                                 lambda: k1(st))

        def k2_plain(u12, st, tp, tf):
            return mk.shade_plain(u12, st, tp, scene.prim_tab, scene.mat_tab,
                                  scene.light_tab, scene.spec_tab, a, None,
                                  tf)

        sk = sp = state0
        rounds, first = [], None
        for r in range(3):
            u12 = torch.rand((mk.n_u_rows(ls), n_pad), generator=gen,
                             device=dev)
            u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
            tpk, tpp = k1(sk), k1_plain(sp)
            tp_own, tp_ring = k1_plain(sk), k1_ring(sk)
            tfk = mk.tex_feed(scene.tex, sk, tpk, c)
            tfp = mk.tex_feed_plain(scene.tex, sp, tpp, c)
            tf_own = mk.tex_feed_plain(scene.tex, sk, tpk, c)
            k2k = mk.shade(u12, sk, tpk, scene, a, tf=tfk)
            k2p = k2_plain(u12, sp, tpp, tfp)
            ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
            op = mk.finalize_sweep_plain(u34, sp, k2p, scene.dense_tab, a)
            torch.cuda.synchronize()
            err1 = compare_hits(torch, tpk, tpp, f"K1 C{c} #{r}")
            f2, bad2, err2, rel2 = compare_rows(torch, k2k, k2p, k2_disc,
                                                range(k2k.shape[0]))
            f34, bad34, err34, rel34 = compare_rows(torch, ok, op, out_disc,
                                                    range(mk.NS))
            rounds.append(dict(
                k1=dict(max_abs_err_t=err1,
                        hit_frac=float((tpk[1] >= 0).float().mean()),
                        equal=bool(torch.equal(tpk, tp_own)),
                        ring_equal=bool(torch.equal(tp_ring, tp_own))),
                tf_equal=bool(torch.equal(tfk, tf_own)),
                k2=dict(match_frac=f2, bad_rows=bad2, max_abs_err=err2,
                        max_rel_err_bad=rel2),
                k34=dict(match_frac=f34, bad_rows=bad34, max_abs_err=err34,
                         max_rel_err_bad=rel34),
                alive=float(ok[mk.S_ALIVE].sum()),
                textured=float((tfk[0] > 0).sum())))
            if first is None:
                first = (u12, u34, tpk, tfk, k2k)
            sk, sp = ok[:mk.NS], op[:mk.NS]
        u12, u34, tp0, tf0, k2_0 = first
        kernels = dict(
            sweep_closest_rows=dict(
                ms=cuda_ms(torch, lambda: k1(state0), 10),
                plain_ms=cuda_ms(torch, lambda: k1_plain(state0), 2),
                ring_ms=cuda_ms(torch, lambda: k1_ring(state0), 10),
                sweep_rows=int(scene.sweep_tab.shape[0]),
                **rows_bound(mk, state0, scene.sweep_tab)),
            shade=dict(
                ms=cuda_ms(torch, lambda: mk.shade(u12, state0, tp0, scene, a,
                                                   tf=tf0), 10),
                plain_ms=cuda_ms(torch, lambda: k2_plain(u12, state0, tp0,
                                                         tf0), 2),
                **shade_bound(mk, state0, scene, a, False, 2 + c)),
            finalize_sweep=dict(
                ms=cuda_ms(torch, lambda: mk.finalize_sweep(
                    u34, state0, k2_0, scene, a), 10),
                plain_ms=cuda_ms(torch, lambda: mk.finalize_sweep_plain(
                    u34, state0, k2_0, scene.dense_tab, a), 2),
                **k34_bound(torch, mk, dense, k2_0, state0, scene, a)))
        kernels["tex_feed"] = dict(
            ms=cuda_ms(torch, lambda: mk.tex_feed(scene.tex, state0, tp0, c),
                       10),
            plain_ms=cuda_ms(torch, lambda: mk.tex_feed_plain(
                scene.tex, state0, tp0, c), 10),
            **tex_feed_bound(mk, scene.tex, tp0, c))
        # device kernels of one feed (the kernel, the chain) and of one
        # whole round
        unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(1))
        launches = {}
        for what, fn in (("tex_feed", lambda: mk.tex_feed(scene.tex, state0,
                                                          tp0, c)),
                         ("tex_feed_plain", lambda: mk.tex_feed_plain(
                             scene.tex, state0, tp0, c)),
                         ("round", lambda: mk.texfeed_round(
                             state0, scene, a, unif, 0))):
            launches[what] = device_kernels(torch, fn)
        res[f"C{c}"] = dict(lanes=n_pad, live=int(
            (state0[mk.S_ALIVE] > 0.5).sum()), rounds=rounds,
            device_kernels=launches, **kernels)
        del sk, sp, ok, op, k2k, k2p, first, k2_0, tp_own, tp_ring, tf_own
        torch.cuda.empty_cache()
    emit("texfeed_round", **res)
    for key, r in res.items():
        for i, rd in enumerate(r["rounds"]):
            check(rd["tf_equal"], f"tex_feed {key} #{i}: the kernel's rows "
                  "differ from tex_feed_plain's on the same inputs")
            check(rd["k1"]["equal"] and rd["k1"]["ring_equal"],
                  f"K1 {key} #{i}: the rows (resident: {rd['k1']['equal']}, "
                  f"ring: {rd['k1']['ring_equal']}) differ from the twin's "
                  "on the same state")
            for k in ("k2", "k34"):
                check(rd[k]["match_frac"] >= 0.9999,
                      f"{k} {key} #{i}: discrete rows match on only "
                      f"{rd[k]['match_frac']:.6f} of lanes")
                check(not rd[k]["bad_rows"],
                      f"{k} {key} #{i}: rows beyond rtol 1e-4 atol 1e-5: "
                      f"{rd[k]['bad_rows']}")
    return res


def device_spans(torch, prof):
    """(start ns, end ns, name) of every device activity (kernels, copies)
    of a finished torch.profiler run, read from the profiler's kineto
    results: building its Python event tree takes minutes for the millions
    of host ops of a torch-chain render."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def device_kernels(torch, fn, with_ms=False):
    """The device kernels (and copies) one call of `fn` launches, from
    torch.profiler; `with_ms`: and their device time in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = device_spans(torch, prof)
    if with_ms:
        return len(spans), sum(t1 - t0 for t0, t1, _ in spans) / 1e6
    return len(spans)


def busy_profile(torch, fn, prefixes=()):
    """One call of `fn` (which must end by waiting for the card) under
    torch.profiler, tracing the device alone (tracing every host op of a
    render of millions of small launches slows its wall by more than half)
    -> the profiled wall, the device time, the device's busy time (the
    union of the kernel intervals) and share, the device kernels, the eight
    kernels with the most device time, and the device time of the kernels
    whose names contain one of `prefixes`."""
    from torch.profiler import ProfilerActivity, profile as profiler

    with profiler(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(device_spans(torch, prof))
    busy, end, by_name = 0.0, float("-inf"), {}
    for t0_, t1_, name in spans:
        t0_, t1_ = t0_ / 1e3, t1_ / 1e3
        busy += max(0.0, t1_ - max(t0_, end))
        end = max(end, t1_)
        by_name[name] = by_name.get(name, 0.0) + (t1_ - t0_)
    top = dict(sorted(((k[:60], round(v / 1e3, 3)) for k, v in
                       by_name.items()), key=lambda kv: -kv[1])[:8])
    rec = dict(profiled_wall_ms=wall_us / 1e3,
               device_ms=sum(by_name.values()) / 1e3,
               device_busy_ms=busy / 1e3, device_busy_share=busy / wall_us,
               device_kernels=len(spans), device_ms_by_kernel=top)
    if prefixes:
        rec["round_kernels_ms"] = sum(
            v for k, v in by_name.items()
            if any(pre in k for pre in prefixes)) / 1e3
    return rec


def reset_counts(mk, dense, lt=None):
    mk.FUSED_LAUNCHES = mk.SHADE_LAUNCHES = mk.FINALIZE_LAUNCHES = 0
    mk.K2_LAUNCHES = mk.K4_LAUNCHES = mk.PLAIN_CALLS = 0
    mk.TEX_FEED_LAUNCHES = 0
    dense.CLOSEST_LAUNCHES = dense.ANY_LAUNCHES = 0
    dense.ROWS_LAUNCHES = dense.ROWS_PLAIN_CALLS = 0
    dense.ANY_ROWS_LAUNCHES = dense.ANY_ROWS_PLAIN_CALLS = 0
    if lt is not None:
        lt.SHADE_LAUNCHES = lt.FINALIZE_SPAWN_LAUNCHES = 0
        lt.FINALIZE_LAUNCHES = lt.PLAIN_CALLS = 0


def phase_render_two_prog(torch, dev, recipe, cam, width, spp, max_bounces,
                          c_lanes=1, split_too=False):
    """A render through the two-program round: K12 and K34 each launch once
    a round, the fused kernel and the plain twins never. `split_too`: a
    warm render, one more under torch.profiler (the device's busy share and
    the kernels' device time), then the same seed through the split round,
    whose K1 and K3 walk the sweep table one ray a lane: the film must equal
    the two-program film bit for bit."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.renderer.output import output_film
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.tonemap import Reinhard0

    world, camera, settings, _ = _scene(torch, dev, recipe, cam, c_lanes,
                                        max_bounces)
    gen = torch.Generator(device=dev).manual_seed(2026)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mk, dense)
    stats = {}
    film, profile, elapsed = render_regen(world, camera, settings, width,
                                          width, spp, generator=gen,
                                          device=dev, stats=stats)
    counts = dict(shade_sweep=mk.SHADE_LAUNCHES,
                  finalize_sweep=mk.FINALIZE_LAUNCHES,
                  fused_round=mk.FUSED_LAUNCHES, plain_calls=mk.PLAIN_CALLS)
    film_h = film.cpu()
    rounds = stats["rounds"]
    check(counts["shade_sweep"] == counts["finalize_sweep"] == rounds > 0,
          f"{recipe}: K12/K34 launches {counts} != rounds {rounds}")
    check(counts["fused_round"] == 0 and counts["plain_calls"] == 0,
          f"{recipe}: fused or plain rounds ran on the main path: {counts}")
    check(bool(torch.isfinite(film_h).all()), f"{recipe}: non-finite film")
    mean_y = float(film_h[..., 1].mean())
    check(mean_y > 0.0, f"{recipe}: film is black")
    exr, png = output_film(film_h, f"{recipe}_{width}", Reinhard0(),
                           output_dir=os.path.join(ROOT, "output"))
    rays = profile.total_rays
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    extra = {}
    if split_too:
        def render(seed, stepper=None, stats=None):
            g = torch.Generator(device=dev).manual_seed(seed)
            return render_regen(world, camera, settings, width, width, spp,
                                generator=g, device=dev, stats=stats,
                                stepper=stepper)

        _, warm_profile, warm_s = render(2027)
        extra = dict(warm_wall_s=warm_s,
                     warm_mrays_per_s=warm_profile.total_rays / warm_s / 1e6,
                     **busy_profile(torch, lambda: render(2028), prefixes=(
                         "shade_sweep_kernel", "finalize_sweep_kernel")))
        reset_counts(mk, dense)
        stats_s = {}
        film_s, profile_s, elapsed_s = render(2026, "split", stats_s)
        counts_s = dict(
            sweep_closest_rows=dense.ROWS_LAUNCHES, shade=mk.K2_LAUNCHES,
            sweep_any_rows=dense.ANY_ROWS_LAUNCHES, finalize=mk.K4_LAUNCHES,
            shade_sweep=mk.SHADE_LAUNCHES,
            finalize_sweep=mk.FINALIZE_LAUNCHES,
            plain_calls=(mk.PLAIN_CALLS + dense.ROWS_PLAIN_CALLS
                         + dense.ANY_ROWS_PLAIN_CALLS))
        check(counts_s["sweep_closest_rows"] == counts_s["shade"]
              == counts_s["finalize"] == stats_s["rounds"] == rounds
              and counts_s["sweep_any_rows"] == 2 * rounds
              and counts_s["shade_sweep"] == counts_s["finalize_sweep"]
              == counts_s["plain_calls"] == 0,
              f"{recipe} split: launches {counts_s} for {rounds} rounds")
        check(torch.equal(film_s, film)
              and profile_s.total_rays == profile.total_rays,
              f"{recipe}: the split film differs from the two-program film")
        extra.update(split=dict(wall_s=elapsed_s, launches=counts_s,
                                mrays_per_s=rays / elapsed_s / 1e6,
                                film_equals_two_prog=True))
    emit("main_path", scene=recipe, width=width, height=width, spp=spp,
         max_bounces=max_bounces, c_lanes=c_lanes, rounds=rounds,
         wall_s=elapsed, mrays_per_s=rays / elapsed / 1e6,
         camera_rays=profile.camera_rays, bounce_rays=profile.bounce_rays,
         shadow_rays=profile.shadow_rays, env_hits=profile.env_hits,
         mean_y=mean_y, peak_gb=peak_gb,
         launches=counts, exr=os.path.relpath(exr, ROOT),
         png=os.path.relpath(png, ROOT), **extra)
    return dict(counts, rounds=rounds,
                film_mean=film_h.double().mean(dim=(0, 1)).tolist(),
                counters=profile_counts(profile))


def profile_counts(profile):
    return [profile.camera_rays, profile.bounce_rays, profile.shadow_rays,
            profile.light_rays, profile.env_hits]


def close_rel(a, b, rtol):
    """Whether every element of a is within rtol of b's (b's zeros exact)."""
    return all(abs(x - y) <= rtol * abs(y) for x, y in zip(a, b))


def dense_rays(torch, fn, closest_at=0, any_at=0):
    """Run `fn` and return the closest-hit query number `closest_at` and
    the shadow query number `any_at` that it hands the dense sweep kernels,
    each as (rays, packed table, sweep table, live mask or None)."""
    from pathtracer_tpu_torch.kernels import dense

    got = {"closest": [], "any": []}
    real = dense.sweep_closest, dense.sweep_any

    def grab(name, at, fn):
        def wrapped(rays, tab, sweep=None, live=None):
            if len(got[name]) <= at:
                got[name].append((rays.clone(), tab, sweep, None if live is
                                  None else live.clone()))
            return fn(rays, tab, sweep, live) if name == "any" \
                else fn(rays, tab, sweep)
        return wrapped

    dense.sweep_closest = grab("closest", closest_at, real[0])
    dense.sweep_any = grab("any", any_at, real[1])
    try:
        fn()
    finally:
        dense.sweep_closest, dense.sweep_any = real
    return got["closest"][closest_at], got["any"][any_at]


def wavefront_render(torch, dev, name, render, n_closest, n_any, extra=None):
    """One render of a wavefront integrator without round kernels
    (`render(seed, stats)` -> (film, Profile, wall s)): the dense sweep
    kernels launch as `n_closest(stats)` and `n_any(stats)` say, no round
    kernel or plain twin runs; the film is finite and lit. Then a warm
    render and a third with the device traced alone: the busy share and
    the sweeps' share of device time."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import lt_mega as lt
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.renderer.output import output_film
    from pathtracer_tpu_torch.tonemap import Reinhard0

    reset_counts(mk, dense, lt)
    stats = {}
    film, profile, elapsed = render(2026, stats)
    counts = dict(dense_sweep_closest=dense.CLOSEST_LAUNCHES,
                  dense_sweep_any=dense.ANY_LAUNCHES,
                  round_kernels=(mk.FUSED_LAUNCHES + mk.SHADE_LAUNCHES
                                 + mk.K2_LAUNCHES + dense.ROWS_LAUNCHES
                                 + lt.SHADE_LAUNCHES),
                  plain_calls=(mk.PLAIN_CALLS + dense.ROWS_PLAIN_CALLS
                               + dense.ANY_ROWS_PLAIN_CALLS
                               + lt.PLAIN_CALLS))
    check(counts["dense_sweep_closest"] == n_closest(stats) > 0
          and counts["dense_sweep_any"] == n_any(stats)
          and counts["round_kernels"] == counts["plain_calls"] == 0,
          f"{name}: launches {counts} for {stats}")
    film_h = film.cpu()
    check(bool(torch.isfinite(film_h).all()), f"{name}: non-finite film")
    mean_y = float(film_h[..., 1].mean())
    check(mean_y > 0.0, f"{name}: film is black")
    exr, png = output_film(film_h, name, Reinhard0(),
                           output_dir=os.path.join(ROOT, "output"))
    _, warm, warm_s = render(2027, {})
    rec = dict(stats=stats, launches=counts, wall_s=elapsed,
               mrays_per_s=profile.total_rays / elapsed / 1e6,
               warm_wall_s=warm_s,
               warm_mrays_per_s=warm.total_rays / warm_s / 1e6,
               counters=profile_counts(profile), mean_y=mean_y,
               film_mean=film_h.double().mean(dim=(0, 1)).tolist(),
               png=os.path.relpath(png, ROOT), **(extra or {}))
    rec.update(busy_profile(torch, lambda: render(2028, {}),
                            prefixes=("dense_closest_kernel",
                                      "dense_any_kernel")))
    rec["sweep_share_of_device_ms"] = (rec["round_kernels_ms"]
                                       / rec["device_ms"])
    return rec


def regen_rays(torch, world, camera, settings, width, spp, seed):
    """The ray rows that one round of pt_trace_regen hands the dense sweep
    kernels: the first closest-hit query's (the camera rays) and the first
    shadow query's (the first NEE sample's), each as (rays, packed table,
    sweep table, live mask: None for the closest-hit query, the sample's
    worth for the shadow query)."""
    from pathtracer_tpu_torch.integrator.pt_regen import pt_trace_regen
    from pathtracer_tpu_torch.kernels.megakernel import TorchUniforms

    gen = torch.Generator(device=world.prims.pa.device).manual_seed(seed)
    return dense_rays(torch, lambda: pt_trace_regen(
        world, camera, settings, width, width, spp, TorchUniforms(gen),
        max_rounds=1))


def mask_effect(torch, world, camera, settings, width, spp, seed):
    """A whole pt_trace_regen render whose every shadow query is timed with
    the `worth` mask it passes and again without it (CUDA events around one
    launch each, after the render's own): per query, the share of lanes
    whose sample was not worth a ray, and the two times. The render's
    result is the masked sweep's, as in any render."""
    from pathtracer_tpu_torch.integrator.pt_regen import pt_trace_regen
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels.megakernel import TorchUniforms

    real = dense.sweep_any
    share, ms_masked, ms_all = [], [], []

    def timed(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)

    def wrapped(rays, tab, sweep=None, live=None):
        out = real(rays, tab, sweep, live)
        share.append(1.0 - float(live.float().mean()))
        ms_masked.append(timed(lambda: real(rays, tab, sweep, live)))
        ms_all.append(timed(lambda: real(rays, tab, sweep)))
        return out

    dense.sweep_any = wrapped
    try:
        gen = torch.Generator(device=world.prims.pa.device).manual_seed(seed)
        pt_trace_regen(world, camera, settings, width, width, spp,
                       TorchUniforms(gen))
    finally:
        dense.sweep_any = real
    ls = settings.light_samples
    per_round = [share[i:i + ls] for i in range(0, len(share), ls)]
    return dict(
        queries=len(share),
        non_worth_share_by_round=[[round(x, 4) for x in r]
                                  for r in per_round],
        non_worth_share_mean=sum(share) / len(share),
        any_ms_per_launch_masked=sum(ms_masked) / len(ms_masked),
        any_ms_per_launch_unmasked=sum(ms_all) / len(ms_all),
        any_ms_masked_sum=sum(ms_masked), any_ms_unmasked_sum=sum(ms_all),
        any_ms_by_round_masked=[round(sum(ms_masked[i:i + ls]), 3)
                                for i in range(0, len(ms_masked), ls)],
        any_ms_by_round_unmasked=[round(sum(ms_all[i:i + ls]), 3)
                                  for i in range(0, len(ms_all), ls)])


def dense_vs_plain(torch, rays, tab, sweep, live, closest):
    """A dense sweep kernel against its plain twin on the same rays (the
    any-hit one with the `live` mask, None: every lane): the ids and t
    (closest) or the masks (any) must be equal bit for bit -> the record
    with ms, plain ms and bound. The bound counts the rays swept: every
    lane's rays read and results written (and its live flag, 1 B), the
    sweep table (64 B a row); a swept closest-hit or unblocked ray tests
    every prim, a blocked one at least the cheapest single test."""
    from pathtracer_tpu_torch.kernels import dense

    n = int(rays.shape[1])
    table = F32 * int(sweep.numel())
    if closest:
        def fn():
            return dense.sweep_closest(rays, tab, sweep)

        def twin():
            return dense.sweep_closest_plain(rays, tab)
    else:
        def fn():
            return dense.sweep_any(rays, tab, sweep, live)

        def twin():
            return dense.sweep_any_plain(rays, tab, live)
    k, p = fn(), twin()
    torch.cuda.synchronize()
    name = "dense_sweep_closest" if closest else "dense_sweep_any"
    check(torch.equal(k, p), f"{name}: differs from the twin on "
          f"{int((k != p).any(dim=0).sum())} rays")
    if closest:
        hit = p[1] >= 0
        err = float((k[0][hit] - p[0][hit]).abs().max()) if hit.any() \
            else 0.0
        b = bound(n * sweep_ops(sweep), F32 * 10 * n + table)
        rec = dict(hit_frac=float(hit.float().mean()))
    else:
        err = float((k - p).abs().max())
        swept = n if live is None else int(live.sum())
        blocked = int(k.sum())
        b = bound((swept - blocked) * sweep_ops(sweep)
                  + blocked * min(PRIM_OPS),
                  F32 * (n + 8 * swept) + table
                  + (0 if live is None else n))
        rec = dict(swept=swept, blocked_frac_of_swept=blocked / max(swept, 1))
    ms = cuda_ms(torch, fn, 10)
    plain_ms = cuda_ms(torch, twin, 2)
    return dict(rays=n, prims=int(sweep.shape[0]), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound=b, **rec)


def dense_attrs(rows, budget):
    """Registers, local bytes, shared bytes and blocks an SM of the two
    dense sweep kernels walking a table of `rows` rows."""
    import ctypes

    from pathtracer_tpu_torch.kernels import _build

    lib = _build.library()
    out = {}
    for which, name in enumerate(("closest", "any")):
        v = [ctypes.c_int() for _ in range(5)]
        rc = lib.dense_sweep_attrs(which, rows, budget,
                                   *[ctypes.byref(x) for x in v])
        check(rc == 0, f"dense_sweep_attrs: CUDA error {rc}")
        out[name] = dict(zip(("regs", "local_bytes", "static_bytes",
                              "dynamic_bytes", "blocks_per_sm"),
                             [x.value for x in v]))
    return out


def phase_render_regen(torch, dev, gem_mega, width, gem_spp, grid_spp,
                       fog_width, fog_spp):
    """The regen integrator without kernels (integrator/pt_regen.py) through
    render_regen: the gem (use_megakernel=False; its film held to the
    megakernel film of the same size and spp), light_grid_cornell(n=5)
    (outside the gate: the default route must take it; its film held to
    cornell_box's through the megakernel, the same radiance field) and the
    fog box under medium-aware settings (held to the medium route's film).
    Every closest-hit query launches dense_sweep_closest and every shadow
    query dense_sweep_any (with the samples' worth as its `live` mask), once
    a round and once a round per light sample. The two kernels are held to
    their twins bit for bit and timed on the gem render's own first camera
    rays and first shadow rays, the shadow rays with every lane swept and
    with the mask; a whole gem render times each shadow query both ways
    (`mask_effect`); the kernels' registers, shared bytes and blocks an SM
    at the gem's table, resident and through the ring."""
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.parsing import SceneBuilder
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    def render(world, camera, settings, w, spp, seed, use=None, stats=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        return render_regen(world, camera, settings, w, w, spp, generator=g,
                            device=dev, stats=stats, use_megakernel=use)

    def regen_case(name, world, camera, settings, w, spp, use):
        ls = settings.light_samples
        rec = wavefront_render(
            torch, dev, f"{name}_regen_{w}",
            lambda seed, stats: render(world, camera, settings, w, spp, seed,
                                       use, stats),
            lambda stats: stats["rounds"],
            lambda stats: ls * stats["rounds"], dict(width=w, spp=spp))
        check(rec["stats"]["route"] == "regen",
              f"{name}: route {rec['stats']}")
        return rec

    res = {}
    # the gem: against its megakernel film
    world, camera, settings, _ = _scene(torch, dev, "gem_cornell",
                                        "CORNELL_CAMERA", 1, 12)
    closest, shadow = regen_rays(torch, world, camera, settings, width,
                                 gem_spp, 2026)
    res["kernels_on_regen_rays"] = {
        "dense_sweep_closest": dense_vs_plain(torch, *closest, True),
        "dense_sweep_any": dense_vs_plain(torch, *shadow[:3], None, False),
        "dense_sweep_any_masked": dense_vs_plain(torch, *shadow, False)}
    rows = int(closest[2].shape[0])
    res["dense_attrs"] = {
        f"resident_{rows}_rows": dense_attrs(rows, mk.SWEEP_RESIDENT_ROWS),
        "ring": dense_attrs(rows, rows - 1)}
    res["gem_mask_effect"] = mask_effect(torch, world, camera, settings,
                                         width, gem_spp, 2030)
    gem = regen_case("gem_cornell", world, camera, settings, width, gem_spp,
                     False)
    check(close_rel(gem["film_mean"], gem_mega["film_mean"], 0.03),
          f"gem: regen film mean {gem['film_mean']} not within 0.03 of the "
          f"megakernel's {gem_mega['film_mean']}")
    check(close_rel(gem["counters"], gem_mega["counters"], 0.08),
          f"gem: regen counters {gem['counters']} not within 0.08 of the "
          f"megakernel's {gem_mega['counters']}")
    res["gem_cornell"] = dict(gem, megakernel_film_mean=gem_mega["film_mean"])
    # the light grid (25 lights: outside the gate) against cornell_box
    grid = scenes.light_grid_cornell(SceneBuilder(), spectral, 5).build(dev)
    check(not mk.mega_available(grid, camera, settings),
          "light_grid_cornell(n=5) is inside the megakernel's gate")
    res["light_grid_cornell"] = regen_case("light_grid_cornell", grid, camera,
                                           settings, width, grid_spp, None)
    box = scenes.cornell_box(SceneBuilder(), spectral).build(dev)
    stats = {}
    film, _, _ = render(box, camera, settings, width, grid_spp, 2029,
                        None, stats)
    check(stats["route"] == "megakernel", "cornell_box left the megakernel")
    box_mean = film.double().mean(dim=(0, 1)).tolist()
    check(close_rel(res["light_grid_cornell"]["film_mean"], box_mean, 0.02),
          f"light grid: film mean {res['light_grid_cornell']['film_mean']} "
          f"not within 0.02 of cornell_box's {box_mean}")
    res["light_grid_cornell"]["cornell_box_megakernel_film_mean"] = box_mean
    # the fog box, medium-aware, against the medium route
    world, camera, settings = _medium_scene(torch, dev, "fog_cornell",
                                            "CORNELL_CAMERA", 1)[:3]
    fog = regen_case("fog_cornell", world, camera, settings, fog_width,
                     fog_spp, False)
    stats = {}
    film, _, _ = render(world, camera, settings, fog_width, fog_spp, 2029,
                        None, stats)
    check(stats["route"] == "megakernel", "fog_cornell left the megakernel")
    fog_mean = film.double().mean(dim=(0, 1)).tolist()
    check(close_rel(fog["film_mean"], fog_mean, 0.05),
          f"fog: regen film mean {fog['film_mean']} not within 0.05 of the "
          f"medium route's {fog_mean}")
    res["fog_cornell"] = dict(fog, medium_route_film_mean=fog_mean)
    emit("render_regen", **res)
    return res


def phase_lt_trace(torch, dev, width, ppp, lens_width, lens_ppp):
    """The light-tracing wavefront (integrator/lt.py:lt_trace) through
    render_splatted: the textured box at width² · ppp (outside the LT
    megakernel's gate: the default route takes lt_trace), its film held to
    the texture route's path-traced film at matched bounces (mean Y within
    0.15), exactly width² · ppp particles; the lens box at lens_width² ·
    lens_ppp through use_megakernel=False and through the LT megakernel
    (mean Y within 0.15, particles equal, bounce rays within 0.08; the two
    CAMERA_RAYS counts printed by their definitions). Every bounce launches
    dense_sweep_closest once, the light vertex and every camera sample of a
    bounce dense_sweep_any once. Both kernels are held to their twins bit
    for bit, and timed, on bounce 0's rays of the textured render."""
    from pathtracer_tpu_torch.integrator.lt import lt_trace
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels import lt_mega as lt
    from pathtracer_tpu_torch.kernels.megakernel import TorchUniforms
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.renderer.splatted import render_splatted

    def splatted(world, camera, settings, w, p, use=None):
        def render(seed, stats):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return render_splatted(world, camera, settings, w, w, p,
                                   generator=gen, device=dev, stats=stats,
                                   use_megakernel=use)
        return render

    def closest(stats):
        return stats["rounds"]

    def any_of(cs):
        return lambda stats: stats["chunks"] + cs * stats["rounds"]

    res = {}
    world, camera, settings = _lt_scene(dev, "textured_cornell",
                                        "TEXTURED_CAMERA", 1)
    check(not lt.lt_mega_available(world, camera, settings),
          "textured_cornell is inside the LT megakernel's gate")
    n_paths = width * width * ppp
    tex = wavefront_render(
        torch, dev, f"lt_trace_textured_cornell_{width}",
        splatted(world, camera, settings, width, ppp), closest, any_of(1),
        dict(width=width, paths_per_pixel=ppp, paths=n_paths,
             max_bounces=settings.max_bounces))
    check(tex["stats"]["route"] == "lt_trace"
          and tex["counters"][3] == n_paths,
          f"textured LT: route {tex['stats']}, {tex['counters'][3]} "
          f"particles for {n_paths}")
    pt_settings = PTSettings(max_bounces=settings.max_bounces,
                             min_bounces=settings.min_bounces,
                             light_samples=1, russian_roulette=True)
    stats = {}
    pt_film, _, _ = render_regen(
        world, camera, pt_settings, width, width, 4, device=dev, stats=stats,
        generator=torch.Generator(device=dev).manual_seed(7))
    check(stats["route"] == "megakernel", "textured PT left the megakernel")
    pt_y = float(pt_film[..., 1].mean())
    tex["pt_mean_y"] = pt_y
    check(abs(tex["mean_y"] - pt_y) / pt_y < 0.15,
          f"textured LT/PT mean Y {tex['mean_y']} / {pt_y}")
    gen = torch.Generator(device=dev).manual_seed(8)
    c_rays, a_rays = dense_rays(torch, lambda: lt_trace(
        world, camera, settings, width, width, width * width,
        TorchUniforms(gen)), 0, 1)
    res["kernels_on_lt_trace_rays"] = {
        "dense_sweep_closest": dense_vs_plain(torch, *c_rays, True),
        "dense_sweep_any": dense_vs_plain(torch, *a_rays, False)}
    res["textured_cornell"] = tex
    # the bench's LT configuration on both routes
    world, camera, settings = _lt_scene(dev, "lens_box", "LENS_BOX_CAMERA",
                                        1)
    wave = wavefront_render(
        torch, dev, f"lt_trace_lens_box_{lens_width}",
        splatted(world, camera, settings, lens_width, lens_ppp, False),
        closest, any_of(1), dict(width=lens_width, paths_per_pixel=lens_ppp))
    mega_render = splatted(world, camera, settings, lens_width, lens_ppp)
    stats = {}
    film, mega, mega_s = mega_render(2026, stats)
    check(stats["route"] == "lt_mega", f"lens box: route {stats}")
    _, mega_warm, mega_warm_s = mega_render(2027, {})
    mega_y = float(film[..., 1].mean())
    wc, mc = wave["counters"], profile_counts(mega)
    check(abs(wave["mean_y"] - mega_y) / mega_y < 0.15,
          f"lens box: lt_trace mean Y {wave['mean_y']} / LT megakernel "
          f"{mega_y}")
    check(wc[3] == mc[3] == lens_width * lens_width * lens_ppp,
          f"lens box: particles {wc[3]} / {mc[3]}")
    check(close_rel([wc[1]], [mc[1]], 0.08),
          f"lens box: bounce rays {wc[1]} / {mc[1]}")
    res["lens_box"] = dict(
        wave, lt_mega=dict(mean_y=mega_y, wall_s=mega_s,
                           mrays_per_s=mega.total_rays / mega_s / 1e6,
                           warm_wall_s=mega_warm_s,
                           warm_mrays_per_s=(mega_warm.total_rays
                                             / mega_warm_s / 1e6),
                           counters=mc),
        camera_rays_lt_trace_every_lane=wc[0],
        camera_rays_lt_mega_live_lanes=mc[0])
    emit("lt_trace", **res)
    return res


def phase_bdpt(torch, dev, width, spp, depths):
    """BDPT (integrator/bdpt.py) through render_bdpt on the Cornell box at
    width² · spp for each max_depth of `depths`: a pass launches
    dense_sweep_closest once a step of either subpath's walk and
    dense_sweep_any once for each strategy family with shadow rays
    (environment NEE, connections, lens splats); the films are finite and
    lit; the first depth's film mean Y within 0.05 of the path tracer's at
    matched coverage (max and min bounces 2 · max_depth - 2, no RR, light
    samples 1). Both kernels are held to their twins bit for bit, and
    timed, on one pass's light-walk and connection rays."""
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.integrator.bdpt import BDPTSettings, bdpt_trace
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels.megakernel import TorchUniforms
    from pathtracer_tpu_torch.parsing import SceneBuilder
    from pathtracer_tpu_torch.renderer.bdpt_renderer import (
        BDPT_LANE_BUDGET,
        render_bdpt,
    )
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    world = scenes.cornell_box(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    res = {}
    for md in depths:
        settings = BDPTSettings(max_depth=md)

        def render(seed, stats, settings=settings):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return render_bdpt(world, camera, settings, width, width, spp,
                               generator=gen, device=dev, stats=stats)

        n = width * width
        n_chunk = -(-n // max(-(-(n * md * md) // BDPT_LANE_BUDGET), 1))
        res[f"md{md}"] = wavefront_render(
            torch, dev, f"bdpt_cornell_box_{width}_md{md}", render,
            lambda stats, md=md: stats["passes"] * 2 * (md - 1),
            lambda stats: stats["passes"] * 3,
            dict(width=width, spp=spp, max_depth=md, pass_points=n_chunk,
                 pass_pair_lanes=n_chunk * md * (md - 1)))
    md = depths[0]
    pt = PTSettings(max_bounces=2 * md - 2, min_bounces=2 * md - 2,
                    light_samples=1, russian_roulette=False)
    pt_film, _, _ = render_regen(
        world, camera, pt, width, width, 16, device=dev,
        generator=torch.Generator(device=dev).manual_seed(9))
    pt_y = float(pt_film[..., 1].mean())
    bd_y = res[f"md{md}"]["mean_y"]
    res[f"md{md}"]["pt_mean_y"] = pt_y
    check(abs(bd_y - pt_y) / pt_y < 0.05,
          f"BDPT md {md} mean Y {bd_y} against PT {pt_y}")
    gen = torch.Generator(device=dev).manual_seed(10)
    n_chunk = res[f"md{md}"]["pass_points"]
    film_uv = torch.rand((n_chunk, 2), generator=gen, device=dev)
    c_rays, a_rays = dense_rays(torch, lambda: bdpt_trace(
        world, camera, BDPTSettings(max_depth=md), film_uv,
        TorchUniforms(gen)), 0, 1)
    res["kernels_on_bdpt_rays"] = {
        "dense_sweep_closest": dense_vs_plain(torch, *c_rays, True),
        "dense_sweep_any": dense_vs_plain(torch, *a_rays, False)}
    emit("bdpt", **res)
    return res


def phase_render_textured(torch, dev, width, spp):
    """The texture-feed route's render of textured_cornell: K1, K2 and K34
    each launch once a round, K12, the fused kernel and the plain twins
    never; the film is finite and lit and the checker wall's tiles are
    resolved. Then a warm render, and a third under torch.profiler: the
    device's busy share (the union of kernel intervals over the profiled
    wall) and the kernels' device time."""
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.renderer.output import output_film
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.tonemap import Reinhard0

    world, camera, settings, _ = _scene(torch, dev, "textured_cornell",
                                        "TEXTURED_CAMERA", 1)

    def render(seed, stats=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return render_regen(world, camera, settings, width, width, spp,
                            generator=gen, device=dev, stats=stats)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mk, dense)
    stats = {}
    film, profile, elapsed = render(2026, stats)
    counts = dict(sweep_closest_rows=dense.ROWS_LAUNCHES,
                  tex_feed=mk.TEX_FEED_LAUNCHES,
                  shade=mk.K2_LAUNCHES, finalize_sweep=mk.FINALIZE_LAUNCHES,
                  shade_sweep=mk.SHADE_LAUNCHES,
                  fused_round=mk.FUSED_LAUNCHES,
                  plain_calls=mk.PLAIN_CALLS + dense.ROWS_PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rounds = stats["rounds"]
    check(counts["sweep_closest_rows"] == counts["tex_feed"]
          == counts["shade"] == counts["finalize_sweep"] == rounds > 0,
          f"textured: K1/feed/K2/K34 launches {counts} != rounds {rounds}")
    check(counts["shade_sweep"] == counts["fused_round"]
          == counts["plain_calls"] == 0,
          f"textured: K12, fused or plain rounds ran on the main path: "
          f"{counts}")
    film_h = film.cpu()
    check(bool(torch.isfinite(film_h).all()), "textured: non-finite film")
    mean_y = float(film_h[..., 1].mean())
    check(mean_y > 0.0, "textured: film is black")
    odd, even, n_sel = scenes.checker_tiles(film_h[..., 1], camera)
    check(n_sel > 200 and max(odd, even) > 1.5 * min(odd, even),
          f"textured: checker not resolved ({odd:.4g} vs {even:.4g} over "
          f"{n_sel} pixels)")
    exr, png = output_film(film_h, f"textured_cornell_{width}", Reinhard0(),
                           output_dir=os.path.join(ROOT, "output"))
    rays = profile.total_rays
    _, warm_profile, warm_s = render(2027)
    emit("main_path", scene="textured_cornell", width=width, height=width,
         spp=spp, c_lanes=1, rounds=rounds, wall_s=elapsed,
         mrays_per_s=rays / elapsed / 1e6, warm_wall_s=warm_s,
         warm_mrays_per_s=warm_profile.total_rays / warm_s / 1e6,
         camera_rays=profile.camera_rays, bounce_rays=profile.bounce_rays,
         shadow_rays=profile.shadow_rays, env_hits=profile.env_hits,
         mean_y=mean_y, checker_odd_y=odd, checker_even_y=even,
         checker_pixels=n_sel, peak_gb=peak_gb, launches=counts,
         **busy_profile(torch, lambda: render(2028)),
         exr=os.path.relpath(exr, ROOT), png=os.path.relpath(png, ROOT))
    return dict(counts, rounds=rounds)


def phase_render(torch, dev, width, spp):
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.parsing import SceneBuilder
    from pathtracer_tpu_torch.renderer.output import output_film
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.tonemap import Reinhard0

    world = scenes.chip_scene(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    settings = PTSettings(max_bounces=12, min_bounces=1, light_samples=2,
                          russian_roulette=True, hwss=False)
    gen = torch.Generator(device=dev).manual_seed(2026)
    torch.cuda.synchronize()
    reset_counts(mk, dense)
    stats = {}
    film, profile, elapsed = render_regen(world, cam, settings, width, width,
                                          spp, generator=gen, device=dev,
                                          stats=stats)
    launches = mk.FUSED_LAUNCHES
    plain_calls = mk.PLAIN_CALLS
    film_h = film.cpu()
    check(launches > 0 and launches == stats["rounds"],
          f"fused kernel launches {launches} != rounds {stats.get('rounds')}")
    check(plain_calls == 0, f"the plain round ran {plain_calls} times on the "
          "main path")
    check(bool(torch.isfinite(film_h).all()), "film has non-finite pixels")
    mean_y = float(film_h[..., 1].mean())
    check(mean_y > 0.0, "film is black")
    exr, png = output_film(film_h, f"chip_cornell_{width}", Reinhard0(),
                           output_dir=os.path.join(ROOT, "output"))
    rays = profile.total_rays
    # a second render, warm (CUDA's lazy module loads paid)
    _, warm_profile, warm_s = render_regen(
        world, cam, settings, width, width, spp,
        generator=torch.Generator(device=dev).manual_seed(2027), device=dev)
    emit("main_path", width=width, height=width, spp=spp, rounds=stats[
        "rounds"], wall_s=elapsed, mrays_per_s=rays / elapsed / 1e6,
        warm_wall_s=warm_s,
        warm_mrays_per_s=warm_profile.total_rays / warm_s / 1e6,
        camera_rays=profile.camera_rays, bounce_rays=profile.bounce_rays,
        shadow_rays=profile.shadow_rays, env_hits=profile.env_hits,
        mean_y=mean_y, fused_launches=launches, plain_calls=plain_calls,
        exr=os.path.relpath(exr, ROOT), png=os.path.relpath(png, ROOT))
    return dict(launches=launches, rounds=stats["rounds"])


def phase_furnace(torch, dev):
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.parsing import SceneBuilder
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    world = scenes.dispersive_furnace(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.FURNACE_CAMERA, device=dev)
    settings = PTSettings(max_bounces=24, min_bounces=4, light_samples=0,
                          russian_roulette=False, hwss=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    film, _, elapsed = render_regen(world, cam, settings, 16, 16, 64,
                                    generator=gen, device=dev)
    y = film[..., 1].cpu()
    center = y[5:11, 5:11].mean()
    corner = torch.cat([y[:3, :3].reshape(-1), y[-3:, -3:].reshape(-1)]).mean()
    ratio = float(center / corner)
    emit("furnace", ratio=ratio, wall_s=elapsed)
    check(abs(ratio - 1.0) < 0.12, f"dispersive furnace ratio {ratio}")


def phase_hdr_furnace(torch, dev):
    """A constant-valued, importance-sampled HDR map around a unit-albedo
    sphere through the two-program round: sphere pixels (center) must equal
    direct-environment pixels (corners) within 0.05."""
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    world, camera, settings, _ = _scene(torch, dev, "hdr_furnace",
                                        "SPHERE_CAMERA", 4, max_bounces=10,
                                        min_bounces=3)
    gen = torch.Generator(device=dev).manual_seed(31)
    film, _, elapsed = render_regen(world, camera, settings, 64, 64, 256,
                                    generator=gen, device=dev)
    y = film[..., 1].cpu()
    center = y[24:40, 24:40].mean()
    corner = torch.cat([y[:6, :6].reshape(-1), y[-6:, -6:].reshape(-1)]).mean()
    ratio = float(center / corner)
    emit("hdr_furnace", ratio=ratio, wall_s=elapsed)
    check(abs(ratio - 1.0) < 0.05, f"HDR furnace ratio {ratio}")


def _lt_scene(dev, recipe, cam, cs, max_bounces=8, min_bounces=1, rr=True,
              stratified=True):
    from pathtracer_tpu_torch import scenes
    from pathtracer_tpu_torch.camera import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.integrator.lt import LTSettings
    from pathtracer_tpu_torch.parsing import SceneBuilder

    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**getattr(scenes, cam), device=dev)
    return world, camera, LTSettings(
        max_bounces=max_bounces, min_bounces=min_bounces, camera_samples=cs,
        russian_roulette=rr, stratified=stratified)


def lt_rays(torch, dense, t, so, sd, tmax, want):
    """(shadow rays swept, unblocked among them) of the rays `want` selects
    ([3, N] origins and directions), by the any-hit sweep kernel over the
    tables `t`."""
    rays = torch.cat([so, sd, torch.full_like(tmax, 1e-6)[None],
                      torch.where(want, tmax, 0.0)[None]]).contiguous()
    blocked = dense.sweep_any(rays, t.dense_tab, t.sweep_tab)[0] > 0.5
    return int(want.sum()), int((want & ~blocked).sum())


def lt_bounds(torch, lt, dense, scene, state, q, out, usp=None, feed=None):
    """The bounds of K12-LT and K34-LT on one round's inputs. K12-LT: every
    lane's alive flag, a live lane's 11 state rows, its uniforms and its
    closest-hit sweep, every lane's Q rows, the tables. K34-LT: every
    lane's state, its 10 continuation Q rows and RR uniform, a live lane's
    connection rows, a respawning lane's spawn uniforms (v2: 11) or feed
    rows (v1: 11, and the connection's 8 where valid), every out row; each
    unblocked shadow ray tests every prim, a blocked one at least the
    cheapest test. Both read the sweep table (64 B a row). Shading and
    spawning arithmetic is not counted."""
    n = state.shape[1]
    a, t = scene.a, scene.tabs
    cs, tab = a.cs, t.dense_tab
    alive0 = state[lt.LS_ALIVE] > 0.5
    live = int(alive0.sum())
    p_bytes = F32 * int(t.sweep_tab.numel())
    b12 = bound(live * sweep_ops(tab), F32 * (
        n + live * (11 + 2 * cs + 3) + lt.q2_rows(cs) * n)
        + table_bytes(t) + p_bytes)
    rays = []
    for ci in range(cs):
        b = lt.Q_CONN + lt.CONN_ROWS * ci
        rays.append(lt_rays(torch, dense, t, q[b:b + 3], q[b + 3:b + 6],
                            q[b + 6], alive0 & (q[b + 6] > 1e-6)))
    aux = lt.k4_aux_v2(cs) if usp is not None else lt.k4_aux(cs)
    hw = out[aux["resp"]] > 0.5
    if usp is not None:
        sp = lt._spawn_plain(a, usp, t.light_tab, t.spec_tab,
                             scene.lcdf_tab)
        want = hw & sp["lv_valid"]
        rays.append(lt_rays(torch, dense, t, torch.stack(list(
            sp["so_lv"])), torch.stack(list(sp["dir_lv"])), sp["tmax_lv"],
            want))
        spawn_bytes = F32 * 11 * int(hw.sum())
        extra = F32 * (t.light_tab.numel() + scene.lcdf_tab.numel())
    else:
        f = feed
        want = hw & (f[lt.F_LV_VALID] > 0.5)
        rays.append(lt_rays(torch, dense, t, f[lt.F_LV:lt.F_LV + 3],
                            f[lt.F_LV + 3:lt.F_LV + 6], f[lt.F_LV + 6], want))
        spawn_bytes = F32 * (11 * int(hw.sum()) + 8 * int(want.sum()))
        extra = 0
    ops = sum(free * sweep_ops(tab) + (swept - free) * min(PRIM_OPS)
              for swept, free in rays)
    b34 = bound(ops, F32 * (lt.NS_LT * n + 11 * n + 12 * cs * live
                            + out.shape[0] * n) + spawn_bytes + extra
                + p_bytes)
    return b12, b34, rays


def lt_splat_film(torch, lt, film, cs, v2, q=None, out=None, feed=None):
    """A zero film like `film` with the splat rows of a round's Q rows `q`
    (the direct hits) and K34-LT rows `out` (the connections and the light
    vertex; v1's from the spawn feed's rows under its gate) index-added, as
    the CPU wrappers add the twins' rows."""
    fams = []
    if q is not None:
        fams.append(q[lt.Q_HIT_PID:lt.Q_HIT_XYZ + 3])
    if out is not None:
        fams += [out[lt.K4_CONN + 4 * ci:lt.K4_CONN + 4 * ci + 4]
                 for ci in range(cs)]
        if v2:
            b = lt.k4_aux_v2(cs)["lv_pid"]
            fams.append(out[b:b + 4])
        else:
            fams.append(feed[lt.F_LV + 7:lt.F_LV + 11]
                        * out[lt.k4_aux(cs)["lv_ok"]])
    pid = torch.cat([f[0] for f in fams]).long()
    xyz = torch.cat([f[1:4].T for f in fams])
    return torch.zeros_like(film).index_add_(0, pid, xyz)


def film_rel_err(torch, film, ref):
    """The largest relative error of `film` against `ref` (the absolute
    error where `ref` is 0); a NaN on either side gives NaN."""
    err = (film - ref).abs() / ref.abs().where(ref != 0, torch.ones_like(ref))
    return float(err.max())


def phase_lt_round(torch, dev, cases):
    """Three chained LT rounds per case from a state of dead lanes with a
    budget of 2 particles: K12-LT and K34-LT (v2, or v1 after the torch
    spawn feed) against their twins, each side on its own state; K12-LT's
    Q rows and K34-LT's out rows must also equal the twins' on the kernel's
    own state on every row, with the sweep table resident and through the
    ring (the budget one row under the table), and the splats the kernels
    add to a zero film [width², 3] with atomics must equal the `index_add_`
    of those twins' splat rows within rtol 1e-5 (K12-LT's and K34-LT's, and
    both kernels' through the ring); then the kernels' times (each adding
    to a film, as on the render's path), the twins' and the feed's times
    and the bounds on the second round's inputs (the first round only
    spawns)."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import lt_mega as lt
    from pathtracer_tpu_torch.kernels import megakernel as mk

    res = {}
    for recipe, cam, cs, v2, lanes, width in cases:
        world, camera, settings = _lt_scene(dev, recipe, cam, cs)
        scene = lt.build_lt_scene(world, camera, settings, width, width, dev,
                                  v2)
        check(scene.spawn_inkernel == v2, f"{recipe}: route is not "
              f"{'v2' if v2 else 'v1'}")
        t, a = scene.tabs, scene.a
        state0 = torch.zeros((lt.NS_LT, lanes), device=dev)
        state0[lt.LS_BUDGET] = 2.0
        n = lanes
        unif = mk.TorchUniforms(
            torch.Generator(device=dev).manual_seed(41 + cs))
        q_disc, o_disc = lt.discrete_rows(cs, v2)
        aux = lt.k4_aux_v2(cs) if v2 else lt.k4_aux(cs)
        cells = settings.strata_uv ** 2 * settings.strata_lam
        sk = sp = state0
        rounds, inputs = [], None
        rows = int(t.sweep_tab.shape[0])
        check(rows <= mk.SWEEP_RESIDENT_ROWS,
              f"{recipe}: {rows} rows are not resident")
        film0 = torch.zeros((width * width, 3), device=dev)

        def ring(fn):
            return one_row_under(mk, rows, fn)

        for it in range(3):
            u = unif.round(it, lt.nu_lt(cs), n, dev)
            f12, f34, f_ring = (torch.zeros_like(film0) for _ in range(3))
            qk = lt.lt_shade(u, sk, scene, f12)
            q_ring = ring(lambda: lt.lt_shade(u, sk, scene, f_ring))
            q_own = lt.lt_shade_plain(u, sk, t.dense_tab, t.prim_tab,
                                      t.mat_tab, t.spec_tab, a)
            qp = lt.lt_shade_plain(u, sp, t.dense_tab, t.prim_tab, t.mat_tab,
                                   t.spec_tab, a)
            usp = feed = None
            if v2:
                usp = lt.stratify_usp(settings,
                                      unif.round(it, lt.NUSP, n, dev),
                                      unif.permutation(it, cells, dev))

                def k34(st, q, film):
                    return lt.lt_finalize_spawn(u, usp, st, q, scene, film)

                def k34_plain(st, q):
                    return lt.lt_finalize_spawn_plain(
                        u, usp, st, q, t.dense_tab, t.light_tab, t.spec_tab,
                        scene.lcdf_tab, a)
            else:
                feed = lt.spawn_feed_for(scene, settings, unif, it, n)

                def k34(st, q, film):
                    return lt.lt_finalize(u, st, q, feed, scene, film)

                def k34_plain(st, q):
                    return lt.lt_finalize_plain(u, st, q, feed, t.dense_tab,
                                                a)
            ok, op = k34(sk, qk, f34), k34_plain(sp, qp)
            o_ring = ring(lambda: k34(sk, qk, f_ring))
            o_own = k34_plain(sk, qk)
            torch.cuda.synchronize()
            m12, bad12, err12, rel12 = compare_rows(
                torch, qk, qp, q_disc, range(qk.shape[0]))
            m34, bad34, err34, rel34 = compare_rows(
                torch, ok, op, o_disc, range(ok.shape[0]))
            ref12 = lt_splat_film(torch, lt, film0, cs, v2, q=q_own)
            ref34 = lt_splat_film(torch, lt, film0, cs, v2, out=o_own,
                                  feed=feed)
            film_err = dict(k12=film_rel_err(torch, f12, ref12),
                            k34=film_rel_err(torch, f34, ref34),
                            ring=film_rel_err(torch, f_ring, ref12 + ref34))
            check(all(e <= 1e-5 for e in film_err.values()),
                  f"{recipe} cs {cs} round {it}: the kernels' film splat "
                  f"is off the index_add_ of the twins' rows: {film_err}")
            splats = (qk[lt.Q_HIT_XYZ + 1] > 0).sum() + sum(
                (ok[lt.K4_CONN + 4 * ci + 2] > 0).sum() for ci in range(cs))
            rounds.append(dict(
                k12=dict(match_frac=m12, bad_rows=bad12, max_abs_err=err12,
                         max_rel_err_bad=rel12,
                         equal=bool(torch.equal(qk, q_own)),
                         ring_equal=bool(torch.equal(q_ring, q_own))),
                k34=dict(match_frac=m34, bad_rows=bad34, max_abs_err=err34,
                         max_rel_err_bad=rel34,
                         equal=bool(torch.equal(ok, o_own)),
                         ring_equal=bool(torch.equal(o_ring, o_own))),
                film_max_rel_err=film_err,
                film_y=float((ref12 + ref34)[:, 1].sum()),
                alive=float(ok[lt.LS_ALIVE].sum()),
                walking=float(qk[lt.Q_ALIVE].sum()),
                spawned=float(ok[aux["resp"]].sum()), splats=int(splats)))
            if it == 1:
                inputs = (u, usp, feed, sk, qk, ok)
            sk, sp = ok[:lt.NS_LT], op[:lt.NS_LT]
        check(sum(r["film_y"] for r in rounds) > 0,
              f"{recipe} cs {cs}: the rounds splat nothing")
        u, usp, feed, s1, q1, o1 = inputs
        film = torch.zeros_like(film0)  # the timed kernels' splats
        rec = dict(
            lanes=n, prims=int(t.dense_tab.shape[0]), camera_samples=cs,
            sweep_rows=rows, ring_budget_rows=rows - 1,
            route="v2" if v2 else "v1", rounds=rounds,
            lt_shade_ms=cuda_ms(torch, lambda: lt.lt_shade(
                u, s1, scene, film), 10),
            lt_shade_plain_ms=cuda_ms(torch, lambda: lt.lt_shade_plain(
                u, s1, t.dense_tab, t.prim_tab, t.mat_tab, t.spec_tab, a), 2))
        if v2:
            rec["finalize_ms"] = cuda_ms(torch, lambda: lt.lt_finalize_spawn(
                u, usp, s1, q1, scene, film), 10)
            rec["finalize_plain_ms"] = cuda_ms(
                torch, lambda: lt.lt_finalize_spawn_plain(
                    u, usp, s1, q1, t.dense_tab, t.light_tab, t.spec_tab,
                    scene.lcdf_tab, a), 2)
        else:
            rec["finalize_ms"] = cuda_ms(torch, lambda: lt.lt_finalize(
                u, s1, q1, feed, scene, film), 10)
            rec["finalize_plain_ms"] = cuda_ms(
                torch, lambda: lt.lt_finalize_plain(u, s1, q1, feed,
                                                    t.dense_tab, a), 2)
            rec["spawn_feed_ms"] = cuda_ms(torch, lambda: lt.spawn_feed_for(
                scene, settings, unif, 1, n), 5)
            rec["spawn_feed_device_kernels"] = device_kernels(
                torch, lambda: lt.spawn_feed_for(scene, settings, unif, 1, n))
        b12, b34, rays = lt_bounds(torch, lt, dense, scene, s1, q1, o1, usp,
                                   feed)
        rec.update(lt_shade_bound=b12, finalize_bound=b34,
                   shadow_rays_swept_free=rays)
        res[f"{recipe}_{'v2' if v2 else 'v1'}_cs{cs}"] = rec
        del sk, sp, ok, op, qk, qp, q_ring, q_own, o_ring, o_own, inputs, \
            s1, q1, o1, film0, film, f12, f34, f_ring, ref12, ref34
        torch.cuda.empty_cache()
    emit("lt_round", **res)
    for key, r in res.items():
        for i, rd in enumerate(r["rounds"]):
            for k in ("k12", "k34"):
                check(rd[k]["match_frac"] >= 0.9999,
                      f"LT {k} {key} #{i}: discrete rows match on only "
                      f"{rd[k]['match_frac']:.6f} of lanes")
                check(not rd[k]["bad_rows"],
                      f"LT {k} {key} #{i}: rows beyond rtol 1e-4 atol 1e-5: "
                      f"{rd[k]['bad_rows']}")
                check(rd[k]["equal"] and rd[k]["ring_equal"],
                      f"LT {k} {key} #{i}: the rows (resident: "
                      f"{rd[k]['equal']}, ring: {rd[k]['ring_equal']}) "
                      "differ from the twin's on the same state")
        check(r["rounds"][0]["spawned"] > 0 and r["rounds"][1]["walking"] > 0
              and r["rounds"][1]["splats"] > 0, f"LT {key}: no work")
    return res


def phase_render_lt(torch, dev, recipe, cam, width, ppp, v2, busy=False):
    """A light-tracing render through render_splatted: K12-LT and the
    route's K34-LT each launch once a round, the other K34-LT and the plain
    twins never; exactly width² · ppp particles are spawned; the film is
    finite and lit. Then a warm render; with `busy`, a third under
    torch.profiler (the device's busy share and time by kernel); for v1,
    the spawn feed's time at the render's lane count."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import lt_mega as lt
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.renderer.output import output_film
    from pathtracer_tpu_torch.renderer.splatted import render_splatted
    from pathtracer_tpu_torch.tonemap import Reinhard0

    world, camera, settings = _lt_scene(dev, recipe, cam, 1)

    def render(seed, stats=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return render_splatted(world, camera, settings, width, width, ppp,
                               generator=gen, device=dev, stats=stats)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mk, dense, lt)
    stats = {}
    film, profile, elapsed = render(2026, stats)
    counts = dict(lt_shade=lt.SHADE_LAUNCHES,
                  lt_finalize_spawn=lt.FINALIZE_SPAWN_LAUNCHES,
                  lt_finalize=lt.FINALIZE_LAUNCHES,
                  plain_calls=lt.PLAIN_CALLS + mk.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rounds = stats["rounds"]
    k34, other = (("lt_finalize_spawn", "lt_finalize") if v2
                  else ("lt_finalize", "lt_finalize_spawn"))
    check(stats["route"] == "lt_mega"
          and stats["lt_round"] == ("v2" if v2 else "v1"),
          f"{recipe}: route {stats}")
    check(counts["lt_shade"] == counts[k34] == rounds > 0,
          f"{recipe}: K12-LT/K34-LT launches {counts} != rounds {rounds}")
    check(counts[other] == 0 and counts["plain_calls"] == 0,
          f"{recipe}: the other route or plain twins ran: {counts}")
    n_paths = width * width * ppp
    check(profile.light_rays == n_paths,
          f"{recipe}: {profile.light_rays} particles spawned, not {n_paths}")
    film_h = film.cpu()
    check(bool(torch.isfinite(film_h).all()), f"LT {recipe}: non-finite film")
    mean_y = float(film_h[..., 1].mean())
    check(mean_y > 0.0, f"LT {recipe}: film is black")
    exr, png = output_film(film_h, f"lt_{recipe}_{width}", Reinhard0(),
                           output_dir=os.path.join(ROOT, "output"))
    rays = profile.total_rays
    _, warm_profile, warm_s = render(2027)
    rec = dict(scene=recipe, width=width, height=width, paths_per_pixel=ppp,
               paths=n_paths, max_bounces=settings.max_bounces,
               route=stats["lt_round"], rounds=rounds, wall_s=elapsed,
               mrays_per_s=rays / elapsed / 1e6, warm_wall_s=warm_s,
               warm_mrays_per_s=warm_profile.total_rays / warm_s / 1e6,
               light_rays=profile.light_rays, camera_rays=profile.camera_rays,
               bounce_rays=profile.bounce_rays, mean_y=mean_y,
               peak_gb=peak_gb, launches=counts,
               exr=os.path.relpath(exr, ROOT), png=os.path.relpath(png, ROOT))
    if busy:
        rec.update(busy_profile(torch, lambda: render(2028)))
    n_pad = lt.lt_init(n_paths, dev)[0].shape[1]
    if not v2:
        scene = lt.build_lt_scene(world, camera, settings, width, width, dev)
        unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(3))
        rec.update(spawn_feed_lanes=n_pad, spawn_feed_ms=cuda_ms(
            torch, lambda: lt.spawn_feed_for(scene, settings, unif, 0, n_pad),
            5))
    emit("main_path", **rec)
    return dict(counts, rounds=rounds, lanes=n_pad)


def phase_lt_estimators(torch, dev):
    """Two estimator checks: the light tracer against the path tracer on
    the Cornell box at 256² (64 paths per pixel against 64 spp, max and min
    bounces 4, no RR: film mean Y within 0.15), and the in-kernel spawn
    (v2) against the spawn feed (v1) on the spike-emission box at 64² with
    4,194,304 particles each (film XYZ totals within rtol 0.15)."""
    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.kernels.lt_mega import lt_trace_mega
    from pathtracer_tpu_torch.kernels.megakernel import TorchUniforms
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.renderer.splatted import render_splatted
    from pathtracer_tpu_torch.utils.profile import Profile

    world, camera, lt_s = _lt_scene(dev, "cornell_box", "CORNELL_CAMERA", 1,
                                    max_bounces=4, min_bounces=4, rr=False,
                                    stratified=False)
    pt_s = PTSettings(max_bounces=4, min_bounces=4, light_samples=1,
                      russian_roulette=False)
    lt_film, _, lt_wall = render_splatted(
        world, camera, lt_s, 256, 256, 64,
        generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    pt_film, _, pt_wall = render_regen(
        world, camera, pt_s, 256, 256, 64,
        generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    lt_y, pt_y = float(lt_film[..., 1].mean()), float(pt_film[..., 1].mean())
    sums = {}
    world, camera, s = _lt_scene(dev, "spike_box", "SPIKE_CAMERA", 1,
                                 max_bounces=3, stratified=False)
    n_paths = 64 * 64 * 1024
    for tag, inkernel in (("v2", None), ("v1", False)):
        stats = {}
        film, counters = lt_trace_mega(
            world, camera, s, 64, 64, n_paths,
            TorchUniforms(torch.Generator(device=dev).manual_seed(11)),
            device=dev, spawn_inkernel=inkernel, stats=stats)
        light_rays = Profile().add_device_counts(
            counters.cpu().tolist()).light_rays
        check(stats["lt_round"] == tag and light_rays == n_paths,
              f"spike box {tag}: route {stats['lt_round']}, "
              f"{light_rays} particles")
        sums[tag] = film.sum(dim=0).cpu().tolist()
    ratios = [x / y for x, y in zip(sums["v2"], sums["v1"])]
    emit("lt_estimators", lt_mean_y=lt_y, pt_mean_y=pt_y,
         lt_over_pt=lt_y / pt_y, lt_wall_s=lt_wall, pt_wall_s=pt_wall,
         spike_xyz_v2=sums["v2"], spike_xyz_v1=sums["v1"],
         spike_v2_over_v1=ratios)
    check(abs(lt_y - pt_y) / pt_y < 0.15, f"LT/PT mean Y {lt_y / pt_y}")
    check(all(abs(r - 1.0) < 0.15 for r in ratios),
          f"spike box v2/v1 XYZ totals {ratios}")


def _medium_scene(torch, dev, recipe, cam, c_lanes, **kw):
    """`_scene` under medium-aware settings (the bake then carries the
    medium feed's tables)."""
    import dataclasses

    from pathtracer_tpu_torch.kernels import megakernel as mk

    world, camera, settings, _ = _scene(torch, dev, recipe, cam, c_lanes,
                                        **kw)
    settings = dataclasses.replace(settings, medium_aware=True)
    return world, camera, settings, mk.build_mega_scene(world, camera, dev,
                                                        settings)


def phase_any_rows(torch, dev, width, n_lanes):
    """K3 on the walk. On the K2 rows of the gem's first round at the film's
    lane count: each NEE sample's blocked mask against the twin's (equal on
    every lane, and 0 on every lane whose sample is not worth a ray), the
    sweep table resident (352 rows) and with the budget one row under it
    (the ring). Then on `n_lanes` random shadow rays (nine in ten worth a
    ray) over the random table (1,120 rows): through the ring at the
    default budget, and resident with the budget at the table. With each
    staging's time, the twin's and the bound."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk

    world, camera, settings, scene = _scene(torch, dev, "gem_cornell",
                                            "CORNELL_CAMERA", 1)
    a = mk.RoundArgs.make(scene.consts, settings, width, width)
    n = width * width
    n_pad = -(-n // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(61)
    state0, _ = mk.mega_init(
        camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
        n_pad, 8)
    ls = a.light_samples
    u12 = torch.rand((mk.n_u_rows(ls), n_pad), generator=gen, device=dev)
    k2 = mk.shade_sweep(u12, state0, scene, a)

    def stagings(src, tab, sweep, row0, tmax_row, live_row, what):
        """K3 at the default budget and at the other staging, each against
        the twin -> (mask, record of times)."""
        rows = int(sweep.shape[0])

        def run():
            return dense.sweep_any_rows(src, tab, row0, tmax_row, live_row,
                                        sweep)

        def other():
            budget0 = mk.SWEEP_RESIDENT_ROWS
            try:
                mk.SWEEP_RESIDENT_ROWS = (rows - 1 if rows <= budget0
                                          else rows)
                return run(), cuda_ms(torch, run, 10)
            finally:
                mk.SWEEP_RESIDENT_ROWS = budget0

        def twin():
            return dense.sweep_any_rows_plain(src, tab, row0, tmax_row,
                                              live_row)

        k, pl = run(), twin()
        k_other, other_ms = other()
        torch.cuda.synchronize()
        worth = src[live_row] > 0.5
        for staging, x in (("default budget", k), ("other staging",
                                                   k_other)):
            check(torch.equal(x, pl), f"K3 {what}, {staging}: masks differ "
                  f"on {int((x != pl).sum())} lanes")
        check(not bool(k[0][~worth].any()),
              f"K3 {what}: a lane without a shadow ray reads blocked")
        resident = rows <= mk.SWEEP_RESIDENT_ROWS
        n_worth = int(worth.sum())
        free = int((worth & (k[0] < 0.5)).sum())
        return k, dict(
            rows=rows, worth=n_worth, blocked=int(k.sum()),
            mismatches=int((k != pl).sum() + (k_other != pl).sum()),
            staging="resident" if resident else "ring",
            ms=cuda_ms(torch, run, 10),
            **{("ring_ms" if resident else "resident_ms"): other_ms},
            plain_ms=cuda_ms(torch, twin, 2),
            **any_rows_bound(int(src.shape[1]), n_worth, free, sweep))

    res = dict(lanes=n_pad, prims=int(scene.dense_tab.shape[0]), samples=[])
    for si in range(ls):
        row0 = mk.O_NEE + mk.NEE_ROWS * si
        _, rec = stagings(k2, scene.dense_tab, scene.sweep_tab, row0,
                          row0 + 6, row0 + 7, f"gem sample {si}")
        res["samples"].append(rec)
    tab, sweep = sweep_tables(torch, dev)["random"]
    src = torch.cat([_rays(torch, n_lanes, gen, dev)[:6],
                     torch.rand((1, n_lanes), generator=gen, device=dev)
                     * 1.45 + 0.05,
                     (torch.rand((1, n_lanes), generator=gen, device=dev)
                      < 0.9).float()]).contiguous()
    _, res["random"] = stagings(src, tab, sweep, 0, 6, 7, "random table")
    emit("any_rows_sweep", **res)
    return res


def phase_medium_rounds(torch, dev, width):
    """Three chained medium-aware rounds of fog_cornell at C = 1 and 4, each
    side on its own state from one camera spawn: the medium instantiations
    of K12 and K34 against their twins; on the kernels' state the split
    round's K1, K2 (fed the same medium rows), K3 and K4 against theirs, its
    K2 rows equal to K12's and its out rows equal to K34's bit for bit.
    Then the kernels', the twins' and the medium feed's times and the bounds
    on the third round's inputs (the camera spawn is in vacuum: the first
    round scatters nothing), the registers, spill bytes and blocks an SM of
    the medium K2 and K12, and the device kernels of one feed call."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk

    res = {}
    for c in (1, 4):
        world, camera, settings, scene = _medium_scene(
            torch, dev, "fog_cornell", "CORNELL_CAMERA", c)
        check(scene.med is not None and not mk.fused_ok(scene),
              "fog_cornell does not ride the medium branch")
        a = mk.RoundArgs.make(scene.consts, settings, width, width)
        n = width * width
        n_pad = -(-n // mk.TILE) * mk.TILE
        gen = torch.Generator(device=dev).manual_seed(71 + c)
        state0, _ = mk.mega_init(
            camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 16)
        ls = a.light_samples
        k2_disc = [mk.O_AT_SURF, mk.O_ENV_CT, mk.O_SHADOW_CT, mk.O_SAMPLE_OK,
                   mk.O_SCAT, mk.O_MSTK, mk.O_MSTK + 1] + [
            mk.O_NEE + mk.NEE_ROWS * si + 7 for si in range(ls)]
        out_disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.S_MSTK0,
                    mk.S_MSTK1, mk.O4_BOUNCE_CT, mk.O4_CAMERA_CT]
        medium_rows = list(range(mk.O_SCAT, mk.O_NEE))
        tabs = mk._tables(scene)

        def cmp(k, p, disc, rows):
            f, bad, err, rel = compare_rows(torch, k, p, disc, rows)
            return dict(match_frac=f, bad_rows=bad, max_abs_err=err,
                        max_rel_err_bad=rel)

        def k3(k2, si, plain=False):
            row0 = mk.O_NEE + mk.NEE_ROWS * si
            if plain:
                return dense.sweep_any_rows_plain(k2, scene.dense_tab, row0,
                                                  row0 + 6, row0 + 7)
            return dense.sweep_any_rows(k2, scene.dense_tab, row0, row0 + 6,
                                        row0 + 7, scene.sweep_tab)

        sk = sp = state0
        rounds, last = [], None
        for r in range(3):
            u12 = torch.rand((mk.n_u_rows(ls, True), n_pad), generator=gen,
                             device=dev)
            u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
            mfk = mk.med_feed(scene.med, sk, u12, ls, c)
            mfp = mk.med_feed(scene.med, sp, u12, ls, c)
            k2k = mk.shade_sweep(u12, sk, scene, a, None, mfk)
            k2p = mk.shade_sweep_plain(u12, sp, a=a, mf=mfp, **tabs)
            ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
            op = mk.finalize_sweep_plain(u34, sp, k2p, scene.dense_tab, a)
            # the split round on the kernels' state
            tp = dense.sweep_closest_rows(sk, scene.dense_tab, mk.S_O,
                                          mk.S_ALIVE, scene.sweep_tab)
            tpp = dense.sweep_closest_rows_plain(sk, scene.dense_tab, mk.S_O,
                                                 mk.S_ALIVE)
            k2s = mk.shade(u12, sk, tp, scene, a, None, None, mfk)
            k2sp = mk.shade_plain(u12, sk, tp, scene.prim_tab, scene.mat_tab,
                                  scene.light_tab, scene.spec_tab, a, None,
                                  None, mfk)
            blks = [k3(k2s, si) for si in range(ls)]
            blks_p = [k3(k2s, si, plain=True) for si in range(ls)]
            o4 = mk.finalize(u34, sk, k2s, blks, scene, a)
            o4p = mk.finalize_plain(u34, sk, k2s, blks, a)
            torch.cuda.synchronize()
            rec = dict(
                k12=cmp(k2k, k2p, k2_disc, range(k2k.shape[0])),
                k12_medium_rows=cmp(k2k, k2p, k2_disc, medium_rows),
                k34=cmp(ok, op, out_disc, range(mk.NS)),
                k1_max_abs_err_t=compare_hits(torch, tp, tpp,
                                              f"medium K1 C{c} #{r}"),
                k1_equal=bool(torch.equal(tp, tpp)),
                k2=cmp(k2s, k2sp, k2_disc, range(k2s.shape[0])),
                k3_mismatches=sum(int((b != bp).sum())
                                  for b, bp in zip(blks, blks_p)),
                k4=cmp(o4, o4p, out_disc, range(mk.NS)),
                split_k2_equal=bool(torch.equal(k2s, k2k)),
                split_out_equal=bool(torch.equal(o4, ok)),
                alive=float(ok[mk.S_ALIVE].sum()),
                scattered=float(k2k[mk.O_SCAT].sum()),
                in_medium=float((ok[mk.S_MSTK0] > 0).sum()),
                two_deep=float((ok[mk.S_MSTK0] > 256).sum()))
            rounds.append(rec)
            last = (sk, u12, u34, mfk, tp, k2k, blks)
            sk, sp = ok[:mk.NS], op[:mk.NS]
        s2, u12, u34, mf2, tp2, k2_2, blks2 = last
        fed = mk.mf_idx(c)["n"]

        def ms(fn, reps=10):
            return cuda_ms(torch, fn, reps)

        kernels = dict(
            shade_sweep=dict(
                ms=ms(lambda: mk.shade_sweep(u12, s2, scene, a, None, mf2)),
                plain_ms=ms(lambda: mk.shade_sweep_plain(
                    u12, s2, a=a, mf=mf2, **tabs), 2),
                **shade_bound(mk, s2, scene, a, True, fed + 6)),
            finalize_sweep=dict(
                ms=ms(lambda: mk.finalize_sweep(u34, s2, k2_2, scene, a)),
                plain_ms=ms(lambda: mk.finalize_sweep_plain(
                    u34, s2, k2_2, scene.dense_tab, a), 2),
                **k34_bound(torch, mk, dense, k2_2, s2, scene, a)),
            sweep_closest_rows=dict(
                ms=ms(lambda: dense.sweep_closest_rows(
                    s2, scene.dense_tab, mk.S_O, mk.S_ALIVE,
                    scene.sweep_tab)),
                plain_ms=ms(lambda: dense.sweep_closest_rows_plain(
                    s2, scene.dense_tab, mk.S_O, mk.S_ALIVE), 2),
                **rows_bound(mk, s2, scene.sweep_tab)),
            shade=dict(
                ms=ms(lambda: mk.shade(u12, s2, tp2, scene, a, None, None,
                                       mf2)),
                plain_ms=ms(lambda: mk.shade_plain(
                    u12, s2, tp2, scene.prim_tab, scene.mat_tab,
                    scene.light_tab, scene.spec_tab, a, None, None, mf2), 2),
                **shade_bound(mk, s2, scene, a, False, 2 + fed + 6)),
            sweep_any_rows=dict(
                ms=ms(lambda: k3(k2_2, 0)),
                plain_ms=ms(lambda: k3(k2_2, 0, plain=True), 2),
                **k2_any_rows_bound(torch, mk, dense, k2_2, scene, 0)),
            finalize=dict(
                ms=ms(lambda: mk.finalize(u34, s2, k2_2, blks2, scene, a)),
                plain_ms=ms(lambda: mk.finalize_plain(u34, s2, k2_2, blks2,
                                                      a), 2),
                **k34_bound(torch, mk, dense, k2_2, s2, scene, a,
                            sweeps=False)))
        feed_kernels, feed_device_ms = device_kernels(
            torch, lambda: mk.med_feed(scene.med, s2, u12, ls, c),
            with_ms=True)
        unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(1))
        rows = int(scene.sweep_tab.shape[0])
        res[f"C{c}"] = dict(
            lanes=n_pad, live=int((s2[mk.S_ALIVE] > 0.5).sum()),
            rounds=rounds,
            medium_occupancy=dict(
                shade=occupancy(2 + 8, c, rows, mk.SWEEP_RESIDENT_ROWS),
                shade_sweep=occupancy(0 + 8, c, rows,
                                      mk.SWEEP_RESIDENT_ROWS)),
            med_feed_ms=ms(lambda: mk.med_feed(scene.med, s2, u12, ls, c)),
            med_feed_device_ms=feed_device_ms,
            device_kernels=dict(
                med_feed=feed_kernels,
                two_prog_round=device_kernels(
                    torch, lambda: mk.two_prog_round(s2, scene, a, unif, 0)),
                split_round=device_kernels(
                    torch, lambda: mk.split_round(s2, scene, a, unif, 0))),
            **kernels)
        del sk, sp, ok, op, k2k, k2p, k2s, k2sp, o4, o4p, last, s2, k2_2
        torch.cuda.empty_cache()
    emit("medium_rounds", **res)
    for key, r in res.items():
        for i, rd in enumerate(r["rounds"]):
            for k in ("k12", "k34", "k2", "k4"):
                check(rd[k]["match_frac"] >= 0.9999,
                      f"medium {k} {key} #{i}: discrete rows match on only "
                      f"{rd[k]['match_frac']:.6f} of lanes")
                check(not rd[k]["bad_rows"],
                      f"medium {k} {key} #{i}: rows beyond rtol 1e-4 atol "
                      f"1e-5: {rd[k]['bad_rows']}")
            check(rd["k3_mismatches"] == 0,
                  f"medium K3 {key} #{i}: {rd['k3_mismatches']} lanes differ")
            check(rd["k1_equal"], f"medium K1 {key} #{i}: the rows differ "
                  "from the twin's on the same state")
            check(rd["split_k2_equal"] and rd["split_out_equal"],
                  f"medium {key} #{i}: the split round's rows differ from "
                  "the two-program round's")
        check(r["rounds"][-1]["scattered"] > 0
              and r["rounds"][-1]["two_deep"] > 0,
              f"medium {key}: no lane scattered or sat in both media")
    return res


def phase_render_medium(torch, dev, width, spp):
    """fog_cornell under medium-aware settings through render_regen: the
    two-program route (K12 and K34 once a round, after the medium feed),
    warm and under torch.profiler (the device's busy share, and the share
    of the device time outside K12 and K34: the feed, the uniform draws and
    the counter sums); then the split route from the same seed (K1, K2 and
    K4 once a round, K3 once per NEE sample). The fused kernel and the
    plain twins never run, and the two films are equal bit for bit."""
    from pathtracer_tpu_torch.kernels import dense
    from pathtracer_tpu_torch.kernels import megakernel as mk
    from pathtracer_tpu_torch.renderer.output import output_film
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.tonemap import Reinhard0

    world, camera, settings, _ = _medium_scene(torch, dev, "fog_cornell",
                                               "CORNELL_CAMERA", 1)

    def render(seed, stepper=None, stats=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return render_regen(world, camera, settings, width, width, spp,
                            generator=gen, device=dev, stats=stats,
                            stepper=stepper)

    def counted(stepper):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mk, dense)
        stats = {}
        film, profile, elapsed = render(2026, stepper, stats)
        counts = dict(
            shade_sweep=mk.SHADE_LAUNCHES, finalize_sweep=mk.FINALIZE_LAUNCHES,
            sweep_closest_rows=dense.ROWS_LAUNCHES, shade=mk.K2_LAUNCHES,
            sweep_any_rows=dense.ANY_ROWS_LAUNCHES, finalize=mk.K4_LAUNCHES,
            fused_round=mk.FUSED_LAUNCHES,
            plain_calls=(mk.PLAIN_CALLS + dense.ROWS_PLAIN_CALLS
                         + dense.ANY_ROWS_PLAIN_CALLS))
        return (film, profile, elapsed, counts, stats["rounds"],
                torch.cuda.max_memory_allocated() / 1e9)

    film, profile, elapsed, counts, rounds, peak_gb = counted(None)
    check(counts["shade_sweep"] == counts["finalize_sweep"] == rounds > 0,
          f"fog_cornell: K12/K34 launches {counts} != rounds {rounds}")
    check(all(counts[k] == 0 for k in (
        "sweep_closest_rows", "shade", "sweep_any_rows", "finalize",
        "fused_round", "plain_calls")),
        f"fog_cornell: another route or plain twins ran: {counts}")
    film_h = film.cpu()
    check(bool(torch.isfinite(film_h).all()), "fog_cornell: non-finite film")
    mean_y = float(film_h[..., 1].mean())
    check(mean_y > 0.0, "fog_cornell: film is black")
    exr, png = output_film(film_h, f"fog_cornell_{width}", Reinhard0(),
                           output_dir=os.path.join(ROOT, "output"))
    _, warm_profile, warm_s = render(2027)
    busy = busy_profile(torch, lambda: render(2028),
                        prefixes=("shade_sweep_kernel",
                                  "finalize_sweep_kernel"))
    rec = dict(scene="fog_cornell", width=width, height=width, spp=spp,
               c_lanes=1, medium_aware=True, rounds=rounds, wall_s=elapsed,
               mrays_per_s=profile.total_rays / elapsed / 1e6,
               warm_wall_s=warm_s,
               warm_mrays_per_s=warm_profile.total_rays / warm_s / 1e6,
               camera_rays=profile.camera_rays,
               bounce_rays=profile.bounce_rays,
               shadow_rays=profile.shadow_rays, env_hits=profile.env_hits,
               mean_y=mean_y, peak_gb=peak_gb, launches=counts, **busy,
               feed_share=1.0 - busy["round_kernels_ms"]
               / busy["device_ms"],
               exr=os.path.relpath(exr, ROOT), png=os.path.relpath(png, ROOT))
    emit("main_path", **rec)

    film_s, profile_s, elapsed_s, counts_s, rounds_s, peak_s = counted(
        "split")
    ls = settings.light_samples
    check(counts_s["sweep_closest_rows"] == counts_s["shade"]
          == counts_s["finalize"] == rounds_s > 0
          and counts_s["sweep_any_rows"] == ls * rounds_s,
          f"fog_cornell split: K1/K2/K3/K4 launches {counts_s} != rounds "
          f"{rounds_s} (K3: x{ls})")
    check(all(counts_s[k] == 0 for k in (
        "shade_sweep", "finalize_sweep", "fused_round", "plain_calls")),
        f"fog_cornell split: another route or plain twins ran: {counts_s}")
    check(rounds_s == rounds and torch.equal(film_s, film),
          "fog_cornell: the split film differs from the two-program film")
    check(profile_s.total_rays == profile.total_rays,
          "fog_cornell: the split render's counters differ")
    _, warm_ps, warm_ss = render(2027, "split")
    emit("main_path", scene="fog_cornell", stepper="split", width=width,
         height=width, spp=spp, c_lanes=1, medium_aware=True, rounds=rounds_s,
         wall_s=elapsed_s, mrays_per_s=profile_s.total_rays / elapsed_s / 1e6,
         warm_wall_s=warm_ss,
         warm_mrays_per_s=warm_ps.total_rays / warm_ss / 1e6,
         peak_gb=peak_s, launches=counts_s, film_equals_two_prog=True)
    return dict(two_prog=dict(counts, rounds=rounds),
                split=dict(counts_s, rounds=rounds_s))


def phase_medium_checks(torch, dev):
    """Two analytic answers through the medium branch on the card, at the
    bounds of the CPU tests (tests/test_torch_render_medium.py), 48 x 48 @
    64 spp with four λ lanes: the absorbing sphere's centre over its
    corners within 0.08 of exp(-1), and the pure scatterer in the unit
    furnace within 0.05 of unity."""
    import math

    from pathtracer_tpu_torch.integrator.pt import PTSettings
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    res = {}
    for recipe, bounces, want, tol in (
            ("absorbing_sphere", 6, math.exp(-1.0), 0.08),
            ("scattering_furnace", 64, 1.0, 0.05)):
        world, camera, _, _ = _scene(torch, dev, recipe, "MEDIUM_CAMERA", 4)
        settings = PTSettings(max_bounces=bounces, min_bounces=bounces,
                              light_samples=0, russian_roulette=False,
                              medium_aware=True, hwss=True)
        gen = torch.Generator(device=dev).manual_seed(81)
        film, _, elapsed = render_regen(world, camera, settings, 48, 48, 64,
                                        generator=gen, device=dev)
        y = film[..., 1].cpu()
        centre = y[20:28, 20:28].mean()
        corner = torch.cat([y[:8, :8].reshape(-1), y[:8, -8:].reshape(-1),
                            y[-8:, :8].reshape(-1),
                            y[-8:, -8:].reshape(-1)]).mean()
        res[recipe] = dict(ratio=float(centre / corner), expected=want,
                           wall_s=elapsed)
        check(abs(res[recipe]["ratio"] - want) < tol,
              f"{recipe}: centre/corner {res[recipe]['ratio']} is not "
              f"within {tol} of {want}")
    emit("medium_checks", **res)


WIDTH = 1080        # the headline film, 1080 x 1080
SPP = 16
SWEEP_RAYS = 1 << 20
# K12 + K34 against their twins: (recipe, camera, C, film width)
TWO_PROG_CASES = (("gem_cornell", "CORNELL_CAMERA", 1, 1080),
                  ("gem_cornell", "CORNELL_CAMERA", 4, 1080),
                  ("hdri_blob", "SPHERE_CAMERA", 4, 512),
                  ("hdri_blob", "SPHERE_CAMERA", 1, 512),
                  ("mesh_cornell", "CORNELL_CAMERA", 1, 256))
# K12-LT + K34-LT against their twins: (recipe, camera, camera samples,
# in-kernel spawn, lanes, film width)
LT_CASES = (("chip_lens", "CHIP_LENS_CAMERA", 1, True, 1 << 20, 1080),
            ("chip_lens", "CHIP_LENS_CAMERA", 2, True, 1 << 20, 1080),
            ("hdri_blob", "SPHERE_CAMERA", 1, False, 512 * 512 * 4, 512))
LT_PATHS = 16  # light paths per pixel of the LT render at 1080 x 1080
# light paths per pixel of the lt_trace render of the textured box
LT_TRACE_PATHS = 4
# light paths per pixel of the v1 render of hdri_blob at 512 x 512: its
# 2^20 particles fill 2^20 lanes, the count the v1 case above checks
LT_HDRI_PATHS = 4


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pathtracer_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build(torch)
    sweep = phase_sweep(torch, dev, SWEEP_RAYS)
    rows = phase_rows_sweep(torch, dev, SWEEP_RAYS)
    rnd = phase_round(torch, dev, WIDTH, 256)
    two = phase_two_prog(torch, dev, TWO_PROG_CASES)
    ring = phase_walk_ring(torch, dev, 256)
    tex = phase_texfeed(torch, dev, WIDTH)
    main_path = phase_render(torch, dev, WIDTH, SPP)
    gem = phase_render_two_prog(torch, dev, "gem_cornell", "CORNELL_CAMERA",
                                WIDTH, 8, 12, split_too=True)
    phase_render_two_prog(torch, dev, "mesh_cornell", "CORNELL_CAMERA",
                          WIDTH, 2, 8)
    phase_render_two_prog(torch, dev, "hdri_blob", "SPHERE_CAMERA", 512, 16,
                          12)
    textured = phase_render_textured(torch, dev, WIDTH, SPP)
    regen = phase_render_regen(torch, dev, gem, WIDTH, 8, SPP, 512, 4)
    lt_wave = phase_lt_trace(torch, dev, WIDTH, LT_TRACE_PATHS, 512, 8)
    bdpt = phase_bdpt(torch, dev, 512, 4, (4, 6))
    phase_furnace(torch, dev)
    phase_hdr_furnace(torch, dev)
    ltr = phase_lt_round(torch, dev, LT_CASES)
    lt_main = phase_render_lt(torch, dev, "chip_lens", "CHIP_LENS_CAMERA",
                              WIDTH, LT_PATHS, True, busy=True)
    lt_hdri = phase_render_lt(torch, dev, "hdri_blob", "SPHERE_CAMERA", 512,
                              LT_HDRI_PATHS, False, busy=True)
    phase_lt_estimators(torch, dev)
    k3 = phase_any_rows(torch, dev, WIDTH, SWEEP_RAYS)
    med = phase_medium_rounds(torch, dev, WIDTH)
    fog = phase_render_medium(torch, dev, WIDTH, SPP)
    phase_medium_checks(torch, dev)
    c1 = rnd["C1"]
    err = max(rd["max_abs_err"] for r in rnd.values() for rd in r["rounds"])
    gem1 = two["gem_cornell_1080_C1"]
    tex1 = tex["C1"]

    def two_err(k):
        """Resident (gem, HDR blob) and through the ring (mesh; gem and fog
        one row over the budget)."""
        return max([rd[k]["max_abs_err"] for r in two.values()
                    for rd in r["rounds"]]
                   + [r[k]["max_abs_err"] for r in ring.values()])

    def tex_err(k, key="max_abs_err"):
        return max(rd[k][key] for r in tex.values() for rd in r["rounds"])

    def lt_err(k, route):
        return max(rd[k]["max_abs_err"] for r in ltr.values()
                   for rd in r["rounds"] if route in (None, r["route"]))

    def med_err(k):
        return max(rd[k]["max_abs_err"] for r in med.values()
                   for rd in r["rounds"])

    # K3's masks are 0/1: its error is the count of lanes that differ
    k3_err = float(sum(s["mismatches"] for s in k3["samples"])
                   + k3["random"]["mismatches"]
                   + sum(rd["k3_mismatches"] for r in med.values()
                         for rd in r["rounds"]))
    med1 = med["C1"]
    lt1 = ltr["chip_lens_v2_cs1"]
    lt_v1 = ltr["hdri_blob_v1_cs1"]
    check(lt_v1["lanes"] == lt_hdri["lanes"],
          f"K34-LT v1 was checked at {lt_v1['lanes']} lanes, but the v1 "
          f"render runs {lt_hdri['lanes']}")

    def timed(d, prefix=""):
        """ms, plain_ms and the bound of a phase's record; no PyTorch call
        computes a closest-hit sweep or a bounce round (library_ms)."""
        b = d.get(f"{prefix}bound", d)
        return dict(ms=d[f"{prefix}ms"], plain_ms=d[f"{prefix}plain_ms"],
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=None)

    src = "pathtracer_tpu_torch/kernels/csrc/"

    def dense_record(which, line, regen, sweep):
        name = f"dense_sweep_{which}"
        kr = regen["kernels_on_regen_rays"]
        on_rays = kr[name]
        err = max([on_rays["max_abs_err"]] + [
            s["max_abs_err_t"] if which == "closest" else 0.0
            for s in sweep.values()] + [
            lt_wave["kernels_on_lt_trace_rays"][name]["max_abs_err"],
            bdpt["kernels_on_bdpt_rays"][name]["max_abs_err"]])
        extra = {}
        if which == "any":
            masked = kr["dense_sweep_any_masked"]
            extra = dict(masked_ms=masked["ms"],
                         masked_plain_ms=masked["plain_ms"],
                         masked_bound_ms=masked["bound"]["bound_ms"],
                         masked_max_abs_err=masked["max_abs_err"])
        return dict(
            name=name, route="cuda", source=src + "dense_sweep.cu",
            replaces="pathtracer_tpu/kernels/" + line,
            launches=regen["gem_cornell"]["launches"][name],
            light_grid_launches=regen["light_grid_cornell"]["launches"][name],
            lt_trace_launches=lt_wave["textured_cornell"]["launches"][name],
            lt_trace_lens_box_launches=lt_wave["lens_box"]["launches"][name],
            bdpt_md4_launches=bdpt["md4"]["launches"][name],
            bdpt_md6_launches=bdpt["md6"]["launches"][name],
            max_abs_err=err, **timed(on_rays), **extra)

    kernels = {"kernels": [
        dict(name="fused_round", route="cuda", source=src + "fused_round.cu",
             replaces="pathtracer_tpu/kernels/megakernel.py:3218",
             launches=main_path["launches"], max_abs_err=err, **timed(c1)),
        dict(name="shade_sweep", route="cuda", source=src + "two_prog_round.cu",
             replaces="pathtracer_tpu/kernels/megakernel.py:2137",
             launches=gem["shade_sweep"],
             medium_launches=fog["two_prog"]["shade_sweep"],
             max_abs_err=max(two_err("k12"), med_err("k12")),
             **timed(gem1, "shade_sweep_")),
        dict(name="finalize_sweep", route="cuda",
             source=src + "two_prog_round.cu",
             replaces="pathtracer_tpu/kernels/megakernel.py:2204",
             launches=gem["finalize_sweep"],
             medium_launches=fog["two_prog"]["finalize_sweep"],
             max_abs_err=max(two_err("k34"), tex_err("k34"), med_err("k34")),
             **timed(gem1, "finalize_sweep_")),
        dict(name="sweep_closest_rows", route="cuda",
             source=src + "two_prog_round.cu",
             replaces="pathtracer_tpu/kernels/dense.py:722",
             launches=textured["sweep_closest_rows"],
             max_abs_err=max([tex_err("k1", "max_abs_err_t")]
                             + [r["max_abs_err_t"] for r in rows.values()]),
             **timed(tex1["sweep_closest_rows"])),
        dict(name="shade", route="cuda", source=src + "two_prog_round.cu",
             replaces="pathtracer_tpu/kernels/megakernel.py:2091",
             launches=textured["shade"],
             medium_launches=fog["split"]["shade"],
             max_abs_err=max(tex_err("k2"), med_err("k2")),
             **timed(tex1["shade"])),
        dict(name="tex_feed", route="cuda", source=src + "tex_feed.cu",
             replaces=None, twin="pathtracer_tpu_torch/kernels/"
             "megakernel.py:tex_feed_plain",
             launches=textured["tex_feed"], max_abs_err=0.0,
             c4_ms=tex["C4"]["tex_feed"]["ms"],
             c4_plain_ms=tex["C4"]["tex_feed"]["plain_ms"],
             **timed(tex1["tex_feed"])),
        dict(name="sweep_any_rows", route="cuda",
             source=src + "two_prog_round.cu",
             replaces="pathtracer_tpu/kernels/dense.py:742",
             launches=fog["split"]["sweep_any_rows"], max_abs_err=k3_err,
             **timed(med1["sweep_any_rows"])),
        dict(name="finalize", route="cuda", source=src + "two_prog_round.cu",
             replaces="pathtracer_tpu/kernels/megakernel.py:2160",
             launches=fog["split"]["finalize"], max_abs_err=med_err("k4"),
             **timed(med1["finalize"])),
        dict(name="lt_shade", route="cuda", source=src + "lt_round.cu",
             replaces="pathtracer_tpu/kernels/lt_mega.py:1089",
             also_replaces="pathtracer_tpu/kernels/lt_mega.py:986",
             launches=lt_main["lt_shade"], max_abs_err=lt_err("k12", None),
             **timed(lt1, "lt_shade_")),
        dict(name="lt_finalize_spawn", route="cuda",
             source=src + "lt_round.cu",
             replaces="pathtracer_tpu/kernels/lt_mega.py:1106",
             launches=lt_main["lt_finalize_spawn"],
             max_abs_err=lt_err("k34", "v2"), **timed(lt1, "finalize_")),
        dict(name="lt_finalize", route="cuda", source=src + "lt_round.cu",
             replaces="pathtracer_tpu/kernels/lt_mega.py:1005",
             launches=lt_hdri["lt_finalize"],
             max_abs_err=lt_err("k34", "v1"), **timed(lt_v1, "finalize_")),
        # the regen integrator's closest-hit and shadow queries: launches on
        # the gem and light-grid renders, agreement over the sweep phase and
        # the gem render's own rays, time and bound on those rays (the
        # shadow rays with every lane swept; masked_*: with the render's
        # worth mask)
        dense_record("closest", "dense.py:608", regen, sweep),
        dense_record("any", "dense.py:624", regen, sweep)]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
