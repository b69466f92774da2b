"""What the benchmark's tests share: the cells at a film size a CPU test
run can hold, run through the harness on the CPU (the program's plain
twins)."""

from __future__ import annotations

import time

from ptbench import run as R


def small_cell(workload, size=24, samples=4, grid=4, reference_spp=64,
               reference_batches=16):
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    tr = R.load_json(R.HERE, "traffic", f"{w['traffic']}.json")
    tr = dict(tr, width=size, height=size, samples=samples,
              check=dict(tr["check"], grid=grid, reference_spp=reference_spp,
                         reference_batches=reference_batches))
    return R.Cell(bench, workload, tr)


def cpu_run(cell, seed=3000000123, frames=6, render=None):
    """One run of `cell` on the CPU, `frames` frames long."""
    return R.run_cell(cell, seed, float("inf"), False, "cpu",
                      t_start=time.perf_counter(), render=render,
                      max_frames=frames)
