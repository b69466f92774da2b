"""Times of K12 (`shade_sweep`) and K34 (`finalize_sweep`) on the card, on a
first round's inputs from one camera spawn at 1080 x 1080 (the mesh at
256 x 256), by sweep-table size and residency budget; with `--rounds`, of
the fused round, K1, K3, the medium instantiations of K2 and K12 and the
light tracer's kernels too.

    python -m pathtracer_tpu_torch.tools.walk_bench
    python -m pathtracer_tpu_torch.tools.walk_bench --cases none \
        --rounds fused,k1,k3,k2m,lt,dense

Cases: the gem (352 table rows), a finer gem (1,312 rows: 82 KB, resident
only with the opt-in above 48 KB), the mesh (5,152 rows, always the ring)
and the medium-aware fog box (32 rows). Each case runs at each residency
budget of `--budgets` that changes its staging (0 forces the ring). K1 and
K3 are timed beside them on the same rays. Prints one JSON line per case
and budget, each with the card's name and power limit; CUDA events around
`--reps` launches after a warm-up.

`--rounds fused`: the fused round on the chip scene (1080 x 1080, a first
round's inputs, C = 1 and 4); `--rounds k1`: K1 on the textured box and the
gem (1080 x 1080, a first round's inputs), the table resident and through
the ring; `--rounds k3`: K3 on each NEE sample of the gem's first-round K2
rows and of the fog box's third-round rows (1080 x 1080), resident and
through the ring, with each mask's digest and the kernel's device time from
torch.profiler (the fog box's kernel is shorter than the host's time a
launch); `--rounds k2m`: on the fog box's third-round inputs (1080 x 1080,
C = 1 and 4) the medium instantiations of K2 and K12, and their surface
instantiations on the same lanes, with the digest of each kernel's rows and
the share of scattered lanes; `--rounds lt`: K12-LT and K34-LT on a second
round's inputs at 2^20 lanes (chip_lens v2 at 1 and 2 camera samples, the
HDR blob v1), as chip_smoke.py times them; `--rounds dense`: the dense
sweeps of `World.intersect` / `intersect_any` on the rays of the gem's
first regen round at 1080 x 1080, 8 spp (its camera rays; its first NEE
sample's shadow rays, every lane swept, and, where the tree has the mask,
only the lanes worth a ray) and on 2^20 random rays over the random
1,120-row table, resident and through the ring, with each result's
digest and the kernel's device time. With the registers and spill
bytes of each kernel, and where the tree reports them its shared bytes and
blocks per SM. The k3 and k2m rounds chain their rounds through the plain
twins, so that every tree times its kernels on the same inputs: `--against
FILE` reads the lines another tree printed (a parent's) and says of each
digest (k3, k2m and dense) whether the rows are equal bit for bit.

The script also runs on a tree from before a kernel's move onto the
shared-memory walk (copy it there): it then times that tree's kernel, under
`"walk": "tiles"`."""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import inspect
import json
import subprocess

import torch

from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.kernels import _build, dense
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.parsing import SceneBuilder

# name -> (recipe, recipe kwargs, camera, film width, medium-aware)
CASES = {
    "gem": ("gem_cornell", {}, "CORNELL_CAMERA", 1080, False),
    "gem_fine": ("gem_cornell", {"subdiv": 3}, "CORNELL_CAMERA", 1080, False),
    "mesh": ("mesh_cornell", {}, "CORNELL_CAMERA", 256, False),
    "fog": ("fog_cornell", {}, "CORNELL_CAMERA", 1080, True),
}


def cuda_ms(fn, reps):
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


def device_ms(fn, reps, name):
    """Mean device milliseconds of the kernel launches whose names contain
    `name` in `reps` calls of `fn` (torch.profiler): a kernel shorter than
    its wrapper's host time is timed without the host's gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name)
    return us / reps / 1e3


def blocks_per_sm(which, c, rows, budget, fn_name="walk_shared_bytes"):
    """(dynamic shared bytes, blocks an SM holds) of K12 (0), K34 (1) or K1
    (3) at C lanes; of K34-LT v2 (1) or v1 (2) at c camera samples with
    `fn_name` "lt_round_shared_bytes"."""
    dyn, stat, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(_build.library(), fn_name)(
        which, c, rows, budget, ctypes.byref(stat), ctypes.byref(dyn),
        ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")
    return dyn.value, blocks.value


def attrs(fn_name, *which):
    """(registers, local bytes) of a kernel from its attrs entry point, given
    as many of the int arguments `which` as it takes (a parent tree's may
    take fewer); whatever else the entry point reports is dropped."""
    sig = _build._SIGNATURES[fn_name]
    n_int = sig.index(ctypes.c_void_p)
    regs, local = ctypes.c_int(), ctypes.c_int()
    extra = len(sig) - n_int - 2
    rc = getattr(_build.library(), fn_name)(
        *which[:n_int], ctypes.byref(regs), ctypes.byref(local),
        *[ctypes.byref(ctypes.c_int()) for _ in range(extra)])
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")
    return regs.value, local.value


def k1_on_walk():
    """Whether this tree's K1 walks the sweep table (takes `sweep=`)."""
    return "sweep" in inspect.signature(dense.sweep_closest_rows).parameters


def k1(state, scene):
    """K1 on a state's rays, on the table this tree's kernel walks."""
    kw = dict(sweep=scene.sweep_tab) if k1_on_walk() else {}
    return dense.sweep_closest_rows(state, scene.dense_tab, mk.S_O,
                                    mk.S_ALIVE, **kw)


def k3_on_walk():
    """Whether this tree's K3 walks the sweep table (takes `sweep=`)."""
    return "sweep" in inspect.signature(dense.sweep_any_rows).parameters


def k3(k2, scene, si):
    """K3 on NEE sample si of a K2 block, on the table this tree's kernel
    walks."""
    row0 = mk.O_NEE + mk.NEE_ROWS * si
    kw = dict(sweep=scene.sweep_tab) if k3_on_walk() else {}
    return dense.sweep_any_rows(k2, scene.dense_tab, row0, row0 + 6,
                                live_row=row0 + 7, **kw)


WIDTH = 1080  # the film width of the k3 and k2m rounds' lanes
# case -> a line another tree printed (--against)
AGAINST: dict = {}


def emit(rec):
    """Print one line of the k3 or k2m round; with --against, say of each
    digest whether it equals the other tree's for the same case."""
    other = AGAINST.get(rec["case"])
    if other is not None:
        for key in ("mask", "rows", "out"):
            if key in rec and key in other:
                rec[f"{key}_equal_to_against"] = rec[key] == other[key]
    print(json.dumps(rec), flush=True)


def digest(x):
    """sha256 of a tensor's bytes (its bits), for comparing trees."""
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def occupancy(which, c, regs, rows=32):
    """Blocks an SM holds of K12 (0), K2 (2) or K3 (5) (+ 8 medium) at C
    lanes, from the tree's own report where it makes one, else from the
    registers alone (128-thread blocks, 65,536 registers an SM, allocated
    8 a thread at a time)."""
    try:
        return blocks_per_sm(which, c, rows, mk.SWEEP_RESIDENT_ROWS)[1]
    except RuntimeError:
        return 65536 // (-(-regs // 8) * 8 * 128)


def fog_rounds(dev, c, rounds=2):
    """The fog box under medium-aware settings at C lanes: (world, camera,
    settings, scene, round args, state) after `rounds` rounds chained
    through the plain twins from one camera spawn (the inputs of round
    rounds + 1, the same bits in every tree)."""
    world = scenes.fog_cornell(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    s = PTSettings(max_bounces=12, min_bounces=1, light_samples=2,
                   russian_roulette=True, hwss=c == 4, medium_aware=True)
    scene = mk.build_mega_scene(world, camera, dev, s)
    a = mk.RoundArgs.make(scene.consts, s, WIDTH, WIDTH)
    n = WIDTH * WIDTH
    n_pad = -(-n // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(71 + c)
    state, _ = mk.mega_init(
        camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
        n_pad, 16)
    tabs = mk._tables(scene)
    for _ in range(rounds):
        u12 = torch.rand((mk.n_u_rows(2, True), n_pad), generator=gen,
                         device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        mf = mk.med_feed(scene.med, state, u12, 2, c)
        k2 = mk.shade_sweep_plain(u12, state, a=a, mf=mf, **tabs)
        state = mk.finalize_sweep_plain(u34, state, k2, scene.dense_tab,
                                        a)[:mk.NS].contiguous()
    return world, camera, s, scene, a, state, gen


def bench_k3(dev, smi, reps):
    """K3 on each NEE sample of the gem's first-round K2 rows (the twin's,
    from one camera spawn) and of the fog box's third-round K2 rows, at
    1080 x 1080, resident and through the ring."""
    n = WIDTH * WIDTH
    n_pad = -(-n // mk.TILE) * mk.TILE
    regs, local = attrs("two_prog_attrs", 5, 1)
    world = scenes.gem_cornell(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    s = PTSettings(max_bounces=12, min_bounces=1, light_samples=2,
                   russian_roulette=True)
    gem = mk.build_mega_scene(world, camera, dev, s)
    a = mk.RoundArgs.make(gem.consts, s, WIDTH, WIDTH)
    gen = torch.Generator(device=dev).manual_seed(61)
    state, _ = mk.mega_init(
        camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
        n_pad, 8)
    u12 = torch.rand((mk.n_u_rows(2), n_pad), generator=gen, device=dev)
    gem_k2 = mk.shade_sweep_plain(u12, state, a=a, **mk._tables(gem))
    _, _, _, fog, a, state, gen = fog_rounds(dev, 1)
    u12 = torch.rand((mk.n_u_rows(2, True), n_pad), generator=gen,
                     device=dev)
    mf = mk.med_feed(fog.med, state, u12, 2, 1)
    fog_k2 = mk.shade_sweep_plain(u12, state, a=a, mf=mf, **mk._tables(fog))
    budget0 = mk.SWEEP_RESIDENT_ROWS
    for name, scene, k2 in (("gem", gem, gem_k2), ("fog", fog, fog_k2)):
        rows = int(scene.sweep_tab.shape[0])
        stagings = ((("resident", budget0), ("ring", rows - 1))
                    if k3_on_walk() else (("tiles", None),))
        for staging, budget in stagings:
            if budget is not None:
                mk.SWEEP_RESIDENT_ROWS = budget
            for si in range(2):
                worth = k2[mk.O_NEE + mk.NEE_ROWS * si + 7] > 0.5
                blk = k3(k2, scene, si)
                rec = dict(case=f"k3_{name}_sample{si}", rows=rows,
                           lanes=n_pad, card=smi, walk=staging,
                           budget_rows=budget, worth=int(worth.sum()),
                           blocked=int(blk.sum()), mask=digest(blk),
                           k3_ms=cuda_ms(lambda: k3(k2, scene, si), reps),
                           k3_device_ms=device_ms(
                               lambda: k3(k2, scene, si), reps,
                               "sweep_any_rows_kernel"),
                           regs=regs, local_bytes=local)
                if budget is not None:
                    rec["shared_bytes"], rec["blocks_per_sm"] = \
                        blocks_per_sm(5, 1, rows, budget)
                emit(rec)
            mk.SWEEP_RESIDENT_ROWS = budget0


def bench_k2m(dev, smi, reps):
    """The medium instantiations of K2 and K12 on the fog box's third-round
    inputs at 1080 x 1080 (C = 1 and 4), and their surface instantiations
    on the same lanes (the scene baked without medium-aware settings)."""
    for c in (1, 4):
        world, camera, s, scene, a, state, gen = fog_rounds(dev, c)
        n_pad = state.shape[1]
        u12 = torch.rand((mk.n_u_rows(2, True), n_pad), generator=gen,
                         device=dev)
        mf = mk.med_feed(scene.med, state, u12, 2, c)
        tp = k1(state, scene)
        s_surf = dataclasses.replace(s, medium_aware=False)
        surf = mk.build_mega_scene(world, camera, dev, s_surf)
        a_surf = mk.RoundArgs.make(surf.consts, s_surf, WIDTH, WIDTH)
        runs = dict(
            k2_medium=(lambda: mk.shade(u12, state, tp, scene, a, None, None,
                                        mf), 2 + 8),
            k12_medium=(lambda: mk.shade_sweep(u12, state, scene, a, None,
                                               mf), 0 + 8),
            k2_surface=(lambda: mk.shade(u12, state, tp, surf, a_surf), 2),
            k12_surface=(lambda: mk.shade_sweep(u12, state, surf, a_surf),
                         0))
        live = state[mk.S_ALIVE] > 0.5
        for name, (fn, which) in runs.items():
            k2 = fn()
            regs, local = attrs("two_prog_attrs", which, c)
            rec = dict(case=f"{name}_fog_C{c}", lanes=n_pad, c_lanes=c,
                       card=smi, live=int(live.sum()),
                       scattered=int((k2[mk.O_SCAT] > 0.5).sum()),
                       rows=digest(k2), ms=cuda_ms(fn, reps), regs=regs,
                       local_bytes=local,
                       blocks_per_sm=occupancy(which, c, regs))
            emit(rec)


def bench_fused(dev, smi, reps):
    """The fused round on the chip scene's first-round inputs at 1080 x
    1080, light samples 2, C = 1 and 4."""
    world = scenes.chip_scene(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    width = 1080
    n = width * width
    n_pad = -(-n // mk.TILE) * mk.TILE
    for c in (1, 4):
        s = PTSettings(max_bounces=12, min_bounces=1, light_samples=2,
                       russian_roulette=True, hwss=c == 4)
        scene = mk.build_mega_scene(world, cam, dev)
        a = mk.RoundArgs.make(scene.consts, s, width, width)
        gen = torch.Generator(device=dev).manual_seed(5 + c)
        state, _ = mk.mega_init(
            cam, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 16)
        u = torch.rand((mk.nu_rows(2), n_pad), generator=gen, device=dev)
        regs, local = attrs("fused_round_attrs", c)
        print(json.dumps(dict(
            case="fused_chip", lanes=n_pad, c_lanes=c, card=smi,
            fused_ms=cuda_ms(lambda: mk.fused_round(u, state, scene, a),
                             reps),
            regs=regs, local_bytes=local)), flush=True)


def bench_k1(dev, smi, reps):
    """K1 on the textured box's and the gem's first-round inputs at 1080 x
    1080, the sweep table resident and through the ring (the budget one row
    under the table)."""
    width = 1080
    n = width * width
    n_pad = -(-n // mk.TILE) * mk.TILE
    regs, local = attrs("two_prog_attrs", 3, 1)
    budget0 = mk.SWEEP_RESIDENT_ROWS
    for name, recipe, cam in (("textured", "textured_cornell",
                               "TEXTURED_CAMERA"),
                              ("gem", "gem_cornell", "CORNELL_CAMERA")):
        world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
        camera = make_projective_camera(**getattr(scenes, cam), device=dev)
        s = PTSettings(max_bounces=12, light_samples=2)
        scene = mk.build_mega_scene(world, camera, dev, s)
        a = mk.RoundArgs.make(scene.consts, s, width, width)
        gen = torch.Generator(device=dev).manual_seed(13)
        state, _ = mk.mega_init(
            camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 16)
        rows = int(scene.dense_tab.shape[0])
        stagings = ((("resident", budget0), ("ring", rows - 1))
                    if k1_on_walk() else (("tiles", None),))
        for staging, budget in stagings:
            if budget is not None:
                mk.SWEEP_RESIDENT_ROWS = budget
            rec = dict(case=f"k1_{name}", rows=rows, lanes=n_pad, card=smi,
                       walk=staging, budget_rows=budget,
                       live=int((state[mk.S_ALIVE] > 0.5).sum()),
                       k1_ms=cuda_ms(lambda: k1(state, scene), reps),
                       regs=regs, local_bytes=local)
            if budget is not None:
                rec["shared_bytes"], rec["blocks_per_sm"] = blocks_per_sm(
                    3, 1, rows, budget)
            print(json.dumps(rec), flush=True)
        mk.SWEEP_RESIDENT_ROWS = budget0


def dense_on_walk():
    """Whether this tree's dense sweeps walk the sweep table."""
    return "sweep" in inspect.signature(dense.sweep_closest).parameters


def regen_round_rays(world, camera, settings, seed):
    """The gem's first pt_trace_regen round's dense sweep calls: (camera
    rays, the first NEE sample's shadow rays, their worth mask or None)."""
    from pathtracer_tpu_torch.integrator.pt_regen import pt_trace_regen

    got = {}
    real = dense.sweep_closest, dense.sweep_any

    def grab(name, fn):
        def wrapped(rays, tab, *rest):
            got.setdefault(name, (rays.clone(), *rest))
            return fn(rays, tab, *rest)
        return wrapped

    dense.sweep_closest = grab("closest", real[0])
    dense.sweep_any = grab("any", real[1])
    try:
        gen = torch.Generator(device=world.prims.pa.device).manual_seed(seed)
        pt_trace_regen(world, camera, settings, WIDTH, WIDTH, 8,
                       mk.TorchUniforms(gen), max_rounds=1)
    finally:
        dense.sweep_closest, dense.sweep_any = real
    shadow = got["any"]
    return got["closest"][0], shadow[0], shadow[2] if len(shadow) > 2 \
        else None


def bench_dense(dev, smi, reps):
    """The dense sweeps on the gem's first regen round's rays at 1080 x 1080
    and on 2^20 random rays over the random table, resident and through the
    ring (the budget one row under the table)."""
    world = scenes.gem_cornell(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    s = PTSettings(max_bounces=12, min_bounces=1, light_samples=2,
                   russian_roulette=True)
    cam_rays, nee_rays, worth = regen_round_rays(world, camera, s, 2026)
    p = scenes.random_prims(SceneBuilder(), spectral, seed=1, grid=20,
                            n_each=100).build(dev).prims
    gen = torch.Generator(device=dev).manual_seed(11)
    n = 1 << 20
    d = torch.randn((3, n), generator=gen, device=dev)
    rnd = torch.cat([torch.rand((3, n), generator=gen, device=dev) * 1.4
                     - 0.2, d / torch.linalg.norm(d, dim=0, keepdim=True),
                     torch.full((1, n), 1e-6, device=dev),
                     torch.rand((1, n), generator=gen, device=dev) * 1.45
                     + 0.05]).contiguous()
    walk = dense_on_walk()
    budget0 = mk.SWEEP_RESIDENT_ROWS
    for table, prims, cases in (
            ("gem", world.prims, (("camera", cam_rays, "closest", None),
                                  ("nee0", nee_rays, "any", None),
                                  ("nee0_masked", nee_rays, "any", worth))),
            ("random", p, (("closest", rnd, "closest", None),
                           ("any", rnd, "any", None)))):
        cols = [x.cpu().numpy() for x in (prims.ptype, prims.valid, prims.pa,
                                          prims.pb, prims.pc)]
        tab = torch.as_tensor(dense.pack_prims_np(*cols), device=dev)
        sweep = torch.as_tensor(dense.pack_sweep_np(*cols), device=dev)
        rows = int(tab.shape[0])
        stagings = ((("resident", budget0), ("ring", rows - 1))
                    if walk else (("tiles", None),))
        for case, rays, which, live in cases:
            if case.endswith("masked") and (live is None or not walk):
                continue
            kw = dict(sweep=sweep) if walk else {}
            if live is not None:
                kw["live"] = live
            fn = dense.sweep_closest if which == "closest" else \
                dense.sweep_any
            for staging, budget in stagings:
                if staging == "resident" and rows > budget0:
                    continue
                if budget is not None:
                    mk.SWEEP_RESIDENT_ROWS = budget
                out = fn(rays, tab, **kw)
                rec = dict(case=f"dense_{table}_{case}_{staging}", rows=rows,
                           rays=int(rays.shape[1]), card=smi, walk=staging,
                           budget_rows=budget,
                           swept=int(rays.shape[1] if live is None
                                     else live.sum()),
                           hit_or_blocked=int((out[-1] >= 0.5).sum()
                                              if which == "any"
                                              else (out[1] >= 0).sum()),
                           out=digest(out),
                           ms=cuda_ms(lambda: fn(rays, tab, **kw), reps),
                           device_ms=device_ms(
                               lambda: fn(rays, tab, **kw), reps,
                               "dense_" if walk else "sweep_kernel"))
                if walk:
                    v = [ctypes.c_int() for _ in range(5)]
                    rc = _build.library().dense_sweep_attrs(
                        0 if which == "closest" else 1, rows,
                        mk.SWEEP_RESIDENT_ROWS, *[ctypes.byref(x) for x in v])
                    if rc != 0:
                        raise RuntimeError(f"dense_sweep_attrs: {rc}")
                    rec.update(zip(("regs", "local_bytes", "static_bytes",
                                    "shared_bytes", "blocks_per_sm"),
                                   [x.value for x in v]))
                mk.SWEEP_RESIDENT_ROWS = budget0
                emit(rec)


def bench_lt(dev, smi, reps):
    """K12-LT and K34-LT on a second round's inputs at 2^20 lanes, each
    adding its splats to a film as on the render's path."""
    from pathtracer_tpu_torch.integrator.lt import LTSettings
    from pathtracer_tpu_torch.kernels import lt_mega as lt

    lanes = 1 << 20
    for recipe, cam, cs, v2, width in (
            ("chip_lens", "CHIP_LENS_CAMERA", 1, True, 1080),
            ("chip_lens", "CHIP_LENS_CAMERA", 2, True, 1080),
            ("hdri_blob", "SPHERE_CAMERA", 1, False, 512)):
        world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
        camera = make_projective_camera(**getattr(scenes, cam), device=dev)
        s = LTSettings(max_bounces=8, min_bounces=1, camera_samples=cs,
                       russian_roulette=True, stratified=True)
        scene = lt.build_lt_scene(world, camera, s, width, width, dev, v2)
        state = torch.zeros((lt.NS_LT, lanes), device=dev)
        state[lt.LS_BUDGET] = 2.0
        unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(41))
        cells = s.strata_uv ** 2 * s.strata_lam
        film = torch.zeros((width * width, 3), device=dev)

        def finalize(it, u, st, q):
            if v2:
                usp = lt.stratify_usp(s, unif.round(it, lt.NUSP, lanes, dev),
                                      unif.permutation(it, cells, dev))
                return lambda: lt.lt_finalize_spawn(u, usp, st, q, scene,
                                                    film)
            feed = lt.spawn_feed_for(scene, s, unif, it, lanes)
            return lambda: lt.lt_finalize(u, st, q, feed, scene, film)

        u = unif.round(0, lt.nu_lt(cs), lanes, dev)
        state = finalize(0, u, state, lt.lt_shade(u, state, scene, film))()[
            :lt.NS_LT].contiguous()
        u = unif.round(1, lt.nu_lt(cs), lanes, dev)
        q = lt.lt_shade(u, state, scene, film)
        fin = finalize(1, u, state, q)
        rec = dict(case=f"lt_{recipe}_cs{cs}", lanes=lanes, card=smi,
                   route="v2" if v2 else "v1",
                   walking=int((state[lt.LS_ALIVE] > 0.5).sum()),
                   lt_shade_ms=cuda_ms(
                       lambda: lt.lt_shade(u, state, scene, film), reps),
                   finalize_ms=cuda_ms(fin, reps))
        for key, which in (("lt_shade", 0),
                           ("finalize", 1 if v2 else 2)):
            rec[f"{key}_regs"], rec[f"{key}_local_bytes"] = attrs(
                "lt_round_attrs", which, cs)
        if "lt_round_shared_bytes" in _build._SIGNATURES:
            rec["finalize_shared_bytes"], rec["finalize_blocks_per_sm"] = \
                blocks_per_sm(1 if v2 else 2, cs,
                              int(scene.tabs.sweep_tab.shape[0]),
                              mk.SWEEP_RESIDENT_ROWS, "lt_round_shared_bytes")
        print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="gem,gem_fine,mesh,fog",
                    help="K12/K34 cases, comma-separated, or none")
    ap.add_argument("--rounds", default="",
                    help="fused, k1, k3, k2m, lt and/or dense, "
                    "comma-separated")
    ap.add_argument("--against", default=None,
                    help="a file of the lines another tree printed: compare "
                    "the digests of the k3 and k2m rounds with its own")
    ap.add_argument("--budgets", default="576,0,1408")
    ap.add_argument("--c-lanes", type=int, default=1)
    ap.add_argument("--light-samples", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("walk_bench: no CUDA device")
    dev = torch.device("cuda:0")
    new_walk = hasattr(mk, "SWEEP_RESIDENT_ROWS")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    c, ls = args.c_lanes, args.light_samples
    if args.against:
        with open(args.against) as f:
            for line in f:
                if line.startswith("{"):
                    rec = json.loads(line)
                    AGAINST[rec.get("case")] = rec
    for name in args.rounds.split(","):
        if name:
            dict(fused=bench_fused, k1=bench_k1, k3=bench_k3, k2m=bench_k2m,
                 lt=bench_lt, dense=bench_dense)[name](dev, smi, args.reps)
    for name in args.cases.split(","):
        if name == "none":
            continue
        recipe, kw, cam, width, medium = CASES[name]
        world = getattr(scenes, recipe)(SceneBuilder(), spectral,
                                        **kw).build(dev)
        camera = make_projective_camera(**getattr(scenes, cam), device=dev)
        s = PTSettings(max_bounces=12, light_samples=ls, hwss=c == 4,
                       russian_roulette=True, medium_aware=medium)
        scene = mk.build_mega_scene(world, camera, dev, s)
        a = mk.RoundArgs.make(scene.consts, s, width, width)
        n = width * width
        n_pad = -(-n // mk.TILE) * mk.TILE
        gen = torch.Generator(device=dev).manual_seed(17 + c)
        state, _ = mk.mega_init(
            camera, torch.rand((n_pad, 5), generator=gen, device=dev), a, n,
            n_pad, 8)
        u12 = torch.rand((mk.n_u_rows(ls, medium), n_pad), generator=gen,
                         device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        mf = mk.med_feed(scene.med, state, u12, ls, c) if medium else None
        rows = int(scene.dense_tab.shape[0])
        budgets = [int(b) for b in args.budgets.split(",")] if new_walk \
            else [None]
        seen = set()
        for budget in budgets:
            if new_walk:
                staging = "resident" if rows <= budget else "ring"
                if staging in seen:
                    continue  # this budget stages the table as an earlier one
                seen.add(staging)
                mk.SWEEP_RESIDENT_ROWS = budget
            k2 = mk.shade_sweep(u12, state, scene, a, None, mf)
            rec = dict(
                case=name, rows=rows, lanes=n_pad, c_lanes=c,
                light_samples=ls, card=smi,
                walk=("tiles" if not new_walk else staging),
                budget_rows=budget,
                k12_ms=cuda_ms(lambda: mk.shade_sweep(u12, state, scene, a,
                                                      None, mf), args.reps),
                k34_ms=cuda_ms(lambda: mk.finalize_sweep(u34, state, k2,
                                                         scene, a),
                               args.reps))
            if new_walk:
                for key, which in (("k12", 0), ("k34", 1)):
                    dyn, blocks = blocks_per_sm(which + (8 if medium else 0),
                                                c, rows, budget)
                    rec[f"{key}_shared_bytes"] = dyn
                    rec[f"{key}_blocks_per_sm"] = blocks
            print(json.dumps(rec), flush=True)
        # on the same rays: K1 (at the default budget), and K3 on each NEE
        # sample
        if new_walk:
            mk.SWEEP_RESIDENT_ROWS = budgets[0]
        rec = dict(case=name, rows=rows, card=smi,
                   k1_walk="sweep_tab" if k1_on_walk() else "tiles",
                   k1_ms=cuda_ms(lambda: k1(state, scene), args.reps))
        rec["k3_walk"] = "sweep_tab" if k3_on_walk() else "tiles"
        for si in range(ls):
            rec[f"k3_sample{si}_ms"] = cuda_ms(lambda: k3(k2, scene, si),
                                               args.reps)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
