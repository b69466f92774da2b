"""The device trace of a window: torch.profiler over the device alone
(tracing every host op of a torch-chain render slows its wall by more than
half), its activities read from the profiler's kineto results, placed on
the host's `time.perf_counter` clock, and reduced to busy time and the
breakdown (the idle time by the innermost span, the program's own spans
among them: `spans`)."""

from __future__ import annotations

import sys
import time


def _kineto_spans(prof):
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def traced(loop, run):
    """Run `loop()` under the profiler -> device spans [(start s, end s,
    name)] on the perf_counter clock. The profiler's clock is matched to
    the host's by whichever of CLOCK_MONOTONIC or CLOCK_REALTIME puts the
    spans inside the window; failing both, the last activity's end is put
    at the last film's arrival on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():  # a CPU run (the tests): no trace
        loop()
        return []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop()
        torch.cuda.synchronize()
    pc = time.perf_counter_ns()
    offsets = {"monotonic": pc - time.monotonic_ns(),
               "realtime": pc - time.time_ns()}
    raw = _kineto_spans(prof)
    if not raw:
        return []
    lo = run.window_start - 0.5
    hi = run.window_start + run.window_s + 0.5
    chosen = None
    for name, off in offsets.items():
        inside = sum(1 for a, b, _ in raw
                     if lo <= (a + off) * 1e-9 and (b + off) * 1e-9 <= hi)
        if inside >= 0.99 * len(raw):
            chosen = (name, off)
            break
    if chosen is None:
        end = max(b for _, b, _ in raw)
        chosen = ("last_copy", int(run.frames[-1]["t_host"] * 1e9) - end)
    print(f"ptbench: {len(raw)} device activities, clock {chosen[0]}",
          file=sys.stderr)
    off = chosen[1]
    return sorted(((a + off) * 1e-9, (b + off) * 1e-9, n) for a, b, n in raw)


def busy_intervals(spans, lo, hi):
    """The union of the spans clipped to [lo, hi], as sorted intervals."""
    out = []
    for a, b, _ in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(spans, lo=None, hi=None):
    if not spans:
        return 0.0
    lo = min(a for a, _, _ in spans) if lo is None else lo
    hi = max(b for _, b, _ in spans) if hi is None else hi
    return sum(b - a for a, b in busy_intervals(sorted(spans), lo, hi))


def idle_gaps(busy, lo, hi):
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def breakdown(run):
    """The device operations that took most time; the idle time by the
    innermost span it falls in, the program's spans inside the harness's
    (`render_call`, `film_copy`, `between_frames`); then the longest single
    gaps by the span most of each falls in. With the program's spans the
    device trace is first moved onto each frame's counters' copy
    (`spans.anchored`), so that the slip of its mapping onto the host's
    clock files no gap under a neighbouring span; where there is nothing to
    anchor to, the mapping stands."""
    from ptbench import spans as sp

    by_name = {}
    for a, b, n in run.device_spans or []:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    fixed = sp.anchored(run) if run.program_spans else None
    by_what, longest, _ = sp.idle_by_span(fixed or run)
    out = sorted(([w, s] for w, s in by_what.items()), key=lambda x: -x[1])
    out += [[f"longest gap, in {w}", s] for s, w in longest[:10 - len(out)]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out[:10]}
