"""One window of a benchmark cell with the program's own spans and counters
recorded, and the device's idle time put down to the innermost span that
covers it.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds 30

It runs the benchmark's set-up, warm-up frame and traced window
(`ptbench/run.py:run_window` with `trace` on: its device-only
torch.profiler trace, and `pathtracer_tpu_torch.utils.profile.tracing()`
around the window's frame loop), and prints one JSON line: the window's
rate, the device's idle share, the per-frame times of the program's spans,
the live-lane share of the megakernel rounds, the LT megakernel's splat
share, the idle time by innermost span (program spans `gate`, `bake`,
`feed`, `wait`, `render` for the call outside its child spans, split too
by the child span it follows; harness spans `render_call` for the call
outside `render`, `film_copy`, `between_frames`) and the longest idle gaps
by the span most of each falls in. It checks the clocks twice: every
program span lies inside its frame's `render_call` (`inside_calls`), and
each frame's counters' `Memcpy DtoH` lies inside the frame's last `wait`
span (`clock_check`). The breakdown is given again (`anchored`) with the
device trace moved, frame by frame, onto the counters' copies. The
arithmetic is the benchmark's own (`ptbench/spans.py`). No reference is
rendered and no film is compared: the benchmark's own runs decide
`correct`. It needs a CUDA card; `window` and `summary` also take the CPU
runs of the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = ("gate", "bake", "feed", "wait", "render")


def window(cell, seed, seconds, device, max_frames=None):
    """`run_window` with the trace on -> (Run, films, data). On the CPU the
    loop runs without the profiler."""
    from ptbench import run as R

    return R.run_window(cell, seed, seconds, True, device,
                        t_start=time.perf_counter(), max_frames=max_frames)


def _by_span(run):
    from ptbench import spans

    by, top, after = spans.idle_by_span(run)
    return dict(idle_by_span=dict(sorted(by.items(), key=lambda kv: -kv[1])),
                render_idle_after=dict(sorted(after.items(),
                                              key=lambda kv: -kv[1])),
                longest_gaps=top)


def summary(run):
    """What the JSON line carries, from a window's Run."""
    from ptbench import spans, tracing

    lo = run.window_start
    busy = tracing.busy_seconds(run.device_spans or [], lo,
                                lo + run.window_s)
    out = dict(frames=len(run.frames), window_s=run.window_s,
               msamples_per_s=len(run.frames) * run.samples_per_frame
               / run.window_s / 1e6,
               busy_s=busy, device_idle_share=100.0 * (1 - busy
                                                       / run.window_s),
               rounds=sorted({f["rounds"] for f in run.frames}),
               **_by_span(run))
    if run.program_spans:
        ms = {n: spans.per_frame_ms(run, n) for n in PROGRAM}
        out.update(
            bake_ms_per_frame=ms["bake"], gate_ms_per_frame=ms["gate"],
            host_wait_ms_per_frame=ms["wait"],
            feed_ms_per_frame=ms["feed"],
            render_self_ms_per_frame=ms["render"],
            live_lane_share=spans.live_lane_share(run),
            splat_share=spans.splat_share(run),
            spans_per_frame={n: sum(1 for s in run.program_spans
                                    if s[2] == n) / len(run.frames)
                             for n in PROGRAM},
            clock_check=spans.clock_check(run),
            clock_offsets_us=spans.clock_offsets_us(run),
            inside_calls=spans.inside_calls(run))
        fixed = spans.anchored(run)
        if fixed is not None:
            out["anchored"] = dict(clock_check=spans.clock_check(fixed),
                                   **_by_span(fixed))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from ptbench import run as R

    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    cell = R.Cell(R.load_json(ROOT, "BENCHMARK.json"), args.workload)
    run, films, _ = window(cell, args.seed, args.seconds, "cuda")
    del films
    out = dict(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0), setup_s=run.setup_s,
               **summary(run))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
