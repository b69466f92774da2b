"""The metric arithmetic on synthetic frames and device spans."""

import pytest

from ptbench import run as R, tracing

TRAFFIC = {"width": 10, "height": 10, "samples": 2}


def make_run(frame_times, spans=None, start=100.0):
    run = R.Run(TRAFFIC)
    run.window_start = t = start
    for k, (gap, call, copy) in enumerate(frame_times):
        t_call = t + gap
        run.frames.append(dict(t_call=t_call, t_return=t_call + call,
                               t_host=t_call + call + copy, route="x",
                               rounds=10 + k, counters={}, total_rays=1000))
        t = t_call + call + copy
    run.window_s = t - start
    run.device_spans = spans
    return run


def read(name, run):
    return R.load_metric(name).read(run)


def test_rates_and_tail():
    run = make_run([(0.0, 0.9, 0.1)] * 9 + [(0.0, 4.9, 0.1)])
    assert run.window_s == pytest.approx(14.0)
    assert read("msamples_per_s", run) == pytest.approx(10 * 200 / 14 / 1e6)
    assert read("mrays_per_s", run) == pytest.approx(10 * 1000 / 14 / 1e6)
    # the one stalled frame of ten lies beyond the 90th percentile
    assert read("frame_s_p90", run) == pytest.approx(1.0 + 0.1 * 4.0)
    assert read("rounds_per_frame", run) == pytest.approx(14.5)


def test_union_of_device_intervals():
    spans = [(0.0, 1.0, "a"), (0.5, 1.5, "b"), (1.4, 2.0, "a"),
             (3.0, 4.0, "c"), (3.5, 3.6, "c")]
    assert tracing.busy_seconds(spans) == pytest.approx(3.0)
    assert tracing.busy_seconds(spans, 0.5, 3.5) == pytest.approx(2.0)
    assert tracing.idle_gaps(tracing.busy_intervals(spans, 0.0, 5.0),
                             0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_idle_share_with_a_stall():
    # two frames of 1 s; the device busy 0.8 s of each, then a 2 s host
    # stall between frames with the device idle
    run = make_run([(0.0, 0.9, 0.1), (2.0, 0.9, 0.1)], start=0.0)
    run.device_spans = [(0.0, 0.8, "k"), (3.0, 3.8, "k")]
    assert run.window_s == pytest.approx(4.0)
    assert read("device_idle_share", run) == pytest.approx(60.0)
    assert read("launches_per_frame", run) == pytest.approx(1.0)
    assert read("device_ms_per_frame", run) == pytest.approx(800.0)
    b = tracing.breakdown(run)
    assert b["device_ops"] == [["k", pytest.approx(1.6)]]
    gaps = dict((k, v) for k, v in b["idle_gaps"] if not k.startswith("long"))
    assert gaps["between_frames"] == pytest.approx(2.0)
    assert gaps["render_call"] == pytest.approx(0.2)
    assert gaps["film_copy"] == pytest.approx(0.2)
    # the longest gap (0.8 to 3.0 s) is named by where most of it falls
    assert b["idle_gaps"][3] == ["longest gap, in between_frames",
                                 pytest.approx(2.2)]


def test_readers_without_a_trace_read_nothing():
    run = make_run([(0.0, 1.0, 0.1)])
    for name in ("launches_per_frame", "device_ms_per_frame",
                 "device_idle_share"):
        assert read(name, run) is None
    assert read("peak_mem_gib", run) is None
    run.peak_bytes = 2 ** 31
    assert read("peak_mem_gib", run) == 2.0


# ------------------------------------------- the program's spans and counters


def one_frame(shift=0.0):
    """A frame (call 1-9 s, film 9-10 s) whose render (1.1-8.9) holds a
    gate (1.2-1.4), a bake (2-4, holding a gate 2.5-3), a feed (4.2-4.5)
    and a wait (6-8); the device busy 4-6, the counters' copy 7.5-7.6
    (moved by `shift`) and the film's 9.2-9.8."""
    run = make_run([(1.0, 8.0, 1.0)], start=0.0)
    run.program_spans = [(1.1, 8.9, "render", None, 0),
                         (1.2, 1.4, "gate", 0, 0), (2.0, 4.0, "bake", 0, 0),
                         (2.5, 3.0, "gate", 2, 0), (4.2, 4.5, "feed", 0, 0),
                         (6.0, 8.0, "wait", 0, 0)]
    run.program_counters = dict(lanes_launched=8192, lanes_live=2048.0,
                                splat_slots=3 * 8192, splats_added=2457.6)
    run.device_spans = [(4.0, 6.0, "kernel"),
                        (7.5 + shift, 7.6 + shift, "Memcpy DtoH (Device)"),
                        (9.2, 9.8, "Memcpy DtoH (Device)")]
    return run


def test_program_span_and_counter_readers():
    run = one_frame()
    assert read("bake_ms_per_frame", run) == pytest.approx(1500.0)
    assert read("host_wait_ms_per_frame", run) == pytest.approx(2000.0)
    assert read("feed_ms_per_frame.host_bound", run) == pytest.approx(300.0)
    assert read("live_lane_share", run) == pytest.approx(25.0)
    assert read("splat_share", run) == pytest.approx(10.0)
    for name in ("bake_ms_per_frame", "host_wait_ms_per_frame",
                 "live_lane_share"):
        assert read(name + ".host_bound", run) == read(name, run)
    run.program_counters = {"lanes_launched": 8192, "lanes_live": 100.0}
    assert read("splat_share", run) is None  # a PT window splats nothing
    run.program_spans = run.program_counters = None  # a --trace 0 run
    for name in ("bake_ms_per_frame", "host_wait_ms_per_frame",
                 "feed_ms_per_frame.host_bound", "live_lane_share",
                 "splat_share"):
        assert read(name, run) is None


def test_breakdown_files_idle_under_the_innermost_span():
    b = tracing.breakdown(one_frame())
    gaps = dict((k, v) for k, v in b["idle_gaps"] if not k.startswith("long"))
    # the gaps 0-4, 6-7.5, 7.6-9.2 and 9.8-10 s, cut by the innermost span
    assert gaps == pytest.approx({
        "between_frames": 1.0, "render_call": 0.2, "render": 0.7 + 0.9,
        "gate": 0.2 + 0.5, "bake": 0.5 + 1.0, "wait": 1.5 + 0.4,
        "film_copy": 0.4})
    assert b["idle_gaps"][len(gaps)] == ["longest gap, in bake",
                                         pytest.approx(4.0)]


def test_breakdown_reads_the_anchored_trace():
    """Ten frames a second apart whose device trace the profiler maps 30 ms
    x t early for t from 2 to 5: on the anchored trace the kernel's idle
    time falls where the host was, as in the frames that did not slip."""
    run = make_run([(0.05, 0.9, 0.05)] * 10, start=0.0)
    run.program_spans, run.device_spans = [], []
    for t in range(10):
        r = len(run.program_spans)
        run.program_spans += [(t + 0.1, t + 0.9, "render", None, r),
                              (t + 0.5, t + 0.6, "wait", r, r)]
        d = 0.03 * t if 2 <= t <= 5 else 0.0
        run.device_spans += [
            (t + 0.2 - d, t + 0.45 - d, "kernel"),
            (t + 0.59997 - d, t + 0.59998 - d, "Memcpy DtoH (Device)"),
            (t + 0.96 - d, t + 0.99 - d, "Memcpy DtoH (Device)")]
    from ptbench import spans

    fixed = spans.anchored(run)
    assert spans.clock_check(run) == 0.8 and spans.clock_check(fixed) == 1.0
    b = dict(tracing.breakdown(run)["idle_gaps"])
    want, _, _ = spans.idle_by_span(fixed)
    for label, s in want.items():
        assert b[label] == pytest.approx(s)
    # every frame's render has 0.45 s of idle own time (0.1-0.2, 0.45-0.5,
    # 0.6-0.9); the slipped frames misfile part of it on the trace as
    # mapped, and less of it once anchored
    raw, _, _ = spans.idle_by_span(run)
    assert abs(b["render"] - 4.5) < 0.5 * abs(raw["render"] - 4.5)
