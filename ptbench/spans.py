"""The program's own spans and counters in a traced window, and their
arithmetic: each span's self time a frame, the lane and splat shares of
the megakernel rounds, the window cut by the innermost span (program or
harness) with the device's idle time filed under it, and the clock checks
and anchors that put the device trace on the host's clock frame by frame.

The program records them (`pathtracer_tpu_torch.utils.profile.tracing()`)
only in a `--trace 1` run's window (`run.run_window`); `attach` puts them
on the Run as `program_spans`, [(start s, end s, name, parent, render)] on
the perf_counter clock, and `program_counters`, {name: total}. Every reader
returns None where the window carries none.
"""

from __future__ import annotations

from ptbench.tracing import busy_intervals, idle_gaps


def attach(run, rec):
    """Put a resolved Recorder's spans on `run` as `program_spans`, [(start
    s, end s, name, parent, render)] on the perf_counter clock, and its
    counter totals as `program_counters`."""
    run.program_spans = [(s.start_ns * 1e-9, s.end_ns * 1e-9, s.name,
                          s.parent, s.render) for s in rec.spans]
    run.program_counters = {n: rec.total(n) for n in
                            dict.fromkeys(c[0] for c in rec.counts)}


def self_seconds(spans, name):
    """The time of the spans named `name` less that of their children."""
    total = 0.0
    for a, b, n, _, _ in spans:
        if n == name:
            total += b - a
    for a, b, n, parent, _ in spans:
        if parent is not None and spans[parent][2] == name:
            total -= b - a
    return total


def per_frame_ms(run, name):
    """Milliseconds a frame of the self time of the spans named `name`, or
    None without program spans."""
    spans = run.program_spans
    if not spans or not run.frames:
        return None
    return 1e3 * self_seconds(spans, name) / len(run.frames)


def live_lane_share(run):
    """100 x the lanes alive at their round's start over the lanes
    launched, or None without the counters."""
    c = run.program_counters or {}
    if not c.get("lanes_launched"):
        return None
    return 100.0 * c["lanes_live"] / c["lanes_launched"]


def splat_share(run):
    """100 x the valid splats the LT megakernel's kernels added over the
    splat rows' entries (camera samples + 2 a lane a round), or None
    without the counters (a PT cell)."""
    c = run.program_counters or {}
    if not c.get("splat_slots"):
        return None
    return 100.0 * c["splats_added"] / c["splat_slots"]


def frame_renders(run):
    """The `render` span of each frame of the window, in order."""
    spans = run.program_spans
    renders = [i for i, s in enumerate(spans) if s[2] == "render"
               and s[3] is None]
    if len(renders) != len(run.frames):
        raise ValueError(f"{len(renders)} render spans for "
                         f"{len(run.frames)} frames")
    return renders


def segments(run):
    """The window cut into (start, end, label, after) by the innermost span
    that covers each instant: the harness's spans, the program's inside
    them. `after` names the child span that ended last before a stretch of
    a program span's own time ("start" before its first child)."""
    spans = run.program_spans or []
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s[3], []).append(i)

    def inner(i, lo, hi, label):
        out, prev, after = [], lo, "start"
        for k in kids.get(i, []):
            a, b, name = spans[k][:3]
            if a > prev:
                out.append((prev, a, label, after))
            out += inner(k, a, b, name)
            prev, after = b, name
        if hi > prev:
            out.append((prev, hi, label, after))
        return out

    renders = frame_renders(run) if spans else [None] * len(run.frames)
    out, prev = [], run.window_start
    for f, r in zip(run.frames, renders):
        out.append((prev, f["t_call"], "between_frames", None))
        if r is None:
            out.append((f["t_call"], f["t_return"], "render_call", None))
        else:
            a, b = spans[r][:2]
            out.append((f["t_call"], a, "render_call", None))
            out += inner(r, a, b, "render")
            out.append((b, f["t_return"], "render_call", None))
        out.append((f["t_return"], f["t_host"], "film_copy", None))
        prev = f["t_host"]
    return [s for s in out if s[1] > s[0]]


def idle_by_span(run, longest=10):
    """({label: idle s}, [[idle s of a gap, label most of it falls in]] of
    the `longest` longest gaps, {span before: idle s} of the idle time in
    `render`'s own time, by the child span it follows)."""
    lo, hi = run.window_start, run.window_start + run.window_s
    gaps = idle_gaps(
        busy_intervals(run.device_spans or [], lo, hi), lo, hi)
    segs = segments(run)
    by, top, after, j = {}, [], {}, 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        part, k = {}, j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, label, prev = segs[k]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                part[label] = part.get(label, 0.0) + ov
                if label == "render":
                    after[prev] = after.get(prev, 0.0) + ov
            k += 1
        for w, s in part.items():
            by[w] = by.get(w, 0.0) + s
        if part:
            top.append([b - a, max(part, key=part.get)])
    top.sort(reverse=True)
    return by, top[:longest], after


def _last_waits(run):
    spans = run.program_spans
    out = []
    for r in frame_renders(run):
        waits = [s for s in spans if s[2] == "wait" and s[4] == r]
        if waits:
            out.append(waits[-1][:2])
    return out


def _copies(run):
    return [(a, b) for a, b, n in run.device_spans or []
            if "Memcpy DtoH" in n]


def clock_check(run):
    """The share of frames whose counters' fetch (a `Memcpy DtoH` device
    span) lies inside the frame's last `wait` span."""
    copies = _copies(run)
    hits = sum(any(a <= c0 and c1 <= b for c0, c1 in copies)
               for a, b in _last_waits(run))
    return hits / len(run.frames)


def clock_anchors(run):
    """Per frame, (host s, host - device s): the end of its last `wait`
    span against the end of its counters' copy, found by order on the
    device and not by the clock mapping: the last `Memcpy DtoH` before the
    frame's film copy (the window's len(frames) longest copies)."""
    copies, n = sorted(_copies(run)), len(run.frames)
    if len(copies) < 2 * n:
        return []
    film = sorted(sorted(copies, key=lambda c: c[1] - c[0])[-n:])
    out, k = [], 0
    for f, (_, b) in zip(film, _last_waits(run)):
        last = None
        while copies[k] != f:
            last, k = copies[k], k + 1
        k += 1
        if last is not None:
            out.append((b, b - last[1]))
    return out


def clock_offsets_us(run):
    """(min, median, max) over the frames of host - device at the anchors,
    in us, or None. On a sound mapping all read the host's return after
    the copy, some 20-40 us."""
    d = sorted(1e6 * x for _, x in clock_anchors(run))
    return (d[0], d[len(d) // 2], d[-1]) if d else None


def anchored(run):
    """A copy of `run` whose device spans are moved by the anchors'
    offsets less their median, linearly between anchors (the device
    trace's mapping onto the host clock slips in stretches of seconds, by
    up to ms), or None without anchors. The median has to be a sound
    frame's, the host's return some tens of us after the copy: where it
    reads over 0.1 ms, the whole window slipped and there is nothing to
    anchor to, so None."""
    import bisect
    import copy

    pts = clock_anchors(run)
    if not pts:
        return None
    med = sorted(x for _, x in pts)[len(pts) // 2]
    if med > 1e-4:
        return None
    xs = [h - x for h, x in pts]  # the copies' ends as the trace maps them
    ys = [x - med for _, x in pts]

    def move(t):
        i = bisect.bisect_left(xs, t)
        if i == 0:
            return t + ys[0]
        if i == len(xs):
            return t + ys[-1]
        w = (t - xs[i - 1]) / (xs[i] - xs[i - 1])
        return t + ys[i - 1] + w * (ys[i] - ys[i - 1])

    out = copy.copy(run)
    out.device_spans = [(move(a), move(b), n) for a, b, n in run.device_spans]
    return out


def inside_calls(run):
    """The share of program spans inside their frame's [t_call,
    t_return]."""
    spans = run.program_spans
    frame_of = dict(zip(frame_renders(run), run.frames))
    ok = sum(1 for a, b, _, _, r in spans if r in frame_of
             and frame_of[r]["t_call"] <= a <= b <= frame_of[r]["t_return"])
    return ok / len(spans)
