"""Times of K12 (`shade_sweep`) and K34 (`finalize_sweep`) on the card, on a
first round's inputs from one camera spawn at 1080 x 1080 (the mesh at
256 x 256), by sweep-table size and residency budget.

    python -m pathtracer_tpu_torch.tools.walk_bench

Cases: the gem (352 table rows), a finer gem (1,312 rows: 82 KB, resident
only with the opt-in above 48 KB), the mesh (5,152 rows, always the ring)
and the medium-aware fog box (32 rows). Each case runs at each residency
budget of `--budgets` that changes its staging (0 forces the ring). K1 and K3,
which keep the older walk of the [P_pad, 128] table, are timed beside them on
the same rays. Prints one JSON line per case and budget, each with the card's
name and power limit; CUDA events around `--reps` launches after a warm-up.

The script also runs on a tree from before the shared-memory walk (copy it
there): it then times that tree's kernels, under `"walk": "tiles"`."""

from __future__ import annotations

import argparse
import ctypes
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


def blocks_per_sm(which, c, rows, budget):
    """(dynamic shared bytes, blocks an SM holds) of K12 (0) or K34 (1)."""
    dyn, stat, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _build.library().walk_shared_bytes(
        which, c, rows, budget, ctypes.byref(stat), ctypes.byref(dyn),
        ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"walk_shared_bytes: CUDA error {rc}")
    return dyn.value, blocks.value


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="gem,gem_fine,mesh,fog")
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
    for name in args.cases.split(","):
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
        # the older walk on the same rays: K1, and K3 on each NEE sample
        rec = dict(case=name, rows=rows, card=smi, walk="tiles",
                   k1_ms=cuda_ms(lambda: dense.sweep_closest_rows(
                       state, scene.dense_tab, mk.S_O, mk.S_ALIVE),
                       args.reps))
        for si in range(ls):
            row0 = mk.O_NEE + mk.NEE_ROWS * si
            rec[f"k3_sample{si}_ms"] = cuda_ms(
                lambda: dense.sweep_any_rows(k2, scene.dense_tab, row0,
                                             row0 + 6, live_row=row0 + 7),
                args.reps)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
