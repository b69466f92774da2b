"""Readings for setting a cell's limits, in one process: the program's
windows on many seeds and the lower-precision control on a few, each
compared with a reference of its own seed exactly as a run compares.

    python3 ptbench/calibrate.py --workload <name> --seconds <s> \
        --seeds 11,12,... --control-seeds 21,22,23 [--out FILE]

Each reading is one JSON line on standard output (and appended to FILE):
{"workload", "side": "program" | "control", "seed", "values"}. The control
is the plain reference computed in bfloat16 (the configurations state
float32) in the program's place: `check.control_frames` frames of the
traffic's own samples a pixel at the cell's film size. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from ptbench import check, run as R  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = R.Cell(R.load_json(R.ROOT, "BENCHMARK.json"), a.workload)
    tr = cell.traffic
    asked = tr["width"] * tr["height"] * tr["samples"]

    def emit(side, seed, values, **extra):
        line = json.dumps(dict(workload=a.workload, side=side, seed=seed,
                               values=values, **extra))
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")

    data = None
    for seed in [int(s) for s in a.seeds.split(",") if s]:
        run, films, data = R.run_window(cell, seed, a.seconds, False, "cuda",
                                        t_start=time.perf_counter())
        prog = R.program_side(run, films)
        del films
        ref = R.reference_side(data, tr, seed, "cuda")
        emit("program", seed, check.readings(prog, ref, asked),
             frames=len(run.frames),
             routes=sorted({str(f["route"]) for f in run.frames}))
    if data is None:
        from ptbench.reference import loader

        data = loader.load(cell.config_dir, R.ROOT)
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        try:
            ctrl = R.reference_side(data, tr, seed, "cuda",
                                    dtype=torch.bfloat16,
                                    frames=tr["check"]["control_frames"])
            ref = R.reference_side(data, tr, seed, "cuda")
            values = check.readings(ctrl, ref, asked)
        except Exception as e:  # a control that crashes has failed
            values = {"error": repr(e)}
        emit("control", seed, values, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
