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
