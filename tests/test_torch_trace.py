"""The spans and counters a render records while tracing is on
(`pathtracer_tpu_torch/utils/profile.py`), on the CPU through the plain
twins: the textured box path-traced (the texture-feed round) at 24x24 @ 2
spp and the gem light-traced (the LT megakernel v2) at 16x16 @ 2 paths a
pixel. Each `render` holds one gate, one bake, a feed a texture-feed round
and a wait per alive check plus the counters' fetch; spans nest; the lane
counters add up; films and counters are bit-equal with tracing on and off;
off records nothing and issues no extra torch op and no extra host sync.
Then the benchmark's span arithmetic (`ptbench/spans.py`) on synthetic
spans, and one CPU window of a benchmark cell through `tools/trace_cell.py`
with every program span inside its frame's call."""

import collections
import importlib.util
import math
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.lt import LTSettings
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.renderer.splatted import render_splatted
from pathtracer_tpu_torch.utils import profile
from ptbench import spans as sp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_W, PT_SPP = 24, 2
LT_W, LT_PPP = 16, 2


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", os.path.join(ROOT, "tools", "trace_cell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def textured():
    world = scenes.textured_cornell(SceneBuilder(), spectral).build("cpu")
    cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device="cpu")

    def render(seed=0, stats=None):
        return render_regen(world, cam, PTSettings(light_samples=2), PT_W,
                            PT_W, PT_SPP,
                            generator=torch.Generator().manual_seed(seed),
                            stats=stats)
    return render


@pytest.fixture(scope="module")
def gem():
    world = scenes.gem_cornell(SceneBuilder(), spectral).build("cpu")
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")

    def render(seed=0, stats=None):
        return render_splatted(world, cam, LTSettings(max_bounces=3), LT_W,
                               LT_W, LT_PPP,
                               generator=torch.Generator().manual_seed(seed),
                               stats=stats)
    return render


def traced(render, **kw):
    stats = {}
    with profile.tracing() as rec:
        out = render(stats=stats, **kw)
    rec.resolve()
    return out, stats, rec


def names(rec):
    return collections.Counter(s.name for s in rec.spans)


def test_textured_render_spans(textured):
    _, stats, rec = traced(textured)
    assert stats["route"] == "megakernel"
    r = stats["rounds"]
    assert names(rec) == {"render": 1, "gate": 1, "bake": 1, "feed": r,
                          "wait": math.ceil(r / 4) + 1}
    # the one gate is the call's, ahead of the bake, which holds none
    gate = next(i for i, s in enumerate(rec.spans) if s.name == "gate")
    bake = next(i for i, s in enumerate(rec.spans) if s.name == "bake")
    assert rec.spans[gate].parent == 0 and gate < bake
    assert not any(s.parent == bake for s in rec.spans)


def test_gem_lt_render_spans(gem):
    _, stats, rec = traced(gem)
    assert stats["route"] == "lt_mega" and stats["lt_round"] == "v2"
    r = stats["rounds"]
    assert names(rec) == {"render": 1, "gate": 1, "bake": 1,
                          "wait": math.ceil(r / 4) + 1}


@pytest.mark.parametrize("which", ["textured", "gem"])
def test_spans_nest_under_their_render(which, request):
    render = request.getfixturevalue(which)
    with profile.tracing() as rec:
        render(seed=1)
        render(seed=2)
    spans = rec.spans
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == ["render", "render"]
    assert [spans[i].render for i in tops] == tops
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            continue
        p = spans[s.parent]
        assert s.parent < i and p.start_ns <= s.start_ns <= s.end_ns \
            <= p.end_ns
        assert s.render == p.render
    assert {s.render for s in spans} == set(tops)


@pytest.mark.parametrize("which", ["textured", "gem"])
def test_lane_counters(which, request):
    _, stats, rec = traced(request.getfixturevalue(which))
    r = stats["rounds"]
    launched, live = rec.values("lanes_launched"), rec.values("lanes_live")
    assert len(launched) == len(live) == r
    n_pad = launched[0]
    assert n_pad % mk.TILE == 0 and rec.total("lanes_launched") == r * n_pad
    assert all(0 <= v <= n_pad for v in live)
    assert 0 < rec.total("lanes_live") <= rec.total("lanes_launched")
    if which == "textured":
        assert live[0] == PT_W * PT_W  # every pixel's lane, alive at spawn
    else:
        assert live[0] == 0  # LT lanes spawn inside the first round
    assert {c[2] for c in rec.counts} == {0}  # the render span's index


@pytest.mark.parametrize("which", ["textured", "gem"])
def test_tracing_leaves_films_and_counters_alone(which, request):
    render = request.getfixturevalue(which)
    film0, prof0, _ = render(seed=3)
    (film1, prof1, _), _, _ = traced(render, seed=3)
    assert torch.equal(film0, film1) and prof0 == prof1


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


SYNCS = ("aten._local_scalar_dense", "aten._to_copy")


def test_off_records_nothing_and_adds_no_op(textured):
    assert profile.recorder() is None
    assert profile.span("render") is profile.NO_SPAN
    profile.count("lanes_launched", 4096)
    with _Ops() as off:
        textured(seed=4)
    with profile.tracing() as rec:
        with _Ops() as on:
            textured(seed=4)
    assert profile.recorder() is None and rec.spans
    # every op of the untraced render is one of the traced render's, and
    # the host syncs (bool of the alive checks, the counters' copy) agree
    assert not (off.ops - on.ops)
    for op in SYNCS:
        assert off.ops[op] == on.ops[op] > 0
    extra = set((on.ops - off.ops).keys())
    assert extra <= {"aten.gt", "aten.sum", "aten.select", "aten.slice",
                     "aten.zeros", "aten.zero_", "aten.fill_", "aten.empty"}


def test_nested_tracing_is_refused():
    with profile.tracing():
        with pytest.raises(RuntimeError):
            with profile.tracing():
                pass
    assert profile.recorder() is None


def test_resolve_turns_tensors_into_numbers():
    with profile.tracing() as rec:
        profile.count("a", torch.tensor(3.0, dtype=torch.float64))
        profile.count("b", torch.tensor([1.0, 2.0]))
        profile.count("b", [4])
        with profile.span("render"):
            profile.count("a", 5)
    rec.resolve()
    assert rec.counts == [["a", 3.0, None], ["b", [1.0, 2.0], None],
                          ["b", [4], None], ["a", 5, 0]]
    assert rec.total("a") == 8 and rec.values("b") == [1.0, 2.0, 4]


# ---------------------- ptbench/spans.py and tools/trace_cell.py


class _Run:
    """A window of frames (t_call, t_return, t_host) with program spans
    [(start, end, name, parent, render)] and device spans."""

    def __init__(self, frames, spans, device, counters=None):
        self.frames = [dict(t_call=a, t_return=b, t_host=c, rounds=4)
                       for a, b, c in frames]
        self.window_start = 0.0
        self.window_s = frames[-1][2]
        self.samples_per_frame = 100
        self.program_spans = spans
        self.program_counters = counters or {}
        self.device_spans = device


def _one_frame(shift=0.0):
    # call 1-9 s; render 1.1-8.9; its gate 1.2-1.4, bake 2-4 (a gate at
    # 2.5-3), a wait 6-8; the film 9-10; the device busy 4-6 and 7.5-7.6
    # (the counters' copy) and 9.2-9.8 (the film's)
    spans = [(1.1, 8.9, "render", None, 0), (1.2, 1.4, "gate", 0, 0),
             (2.0, 4.0, "bake", 0, 0), (2.5, 3.0, "gate", 2, 0),
             (6.0, 8.0, "wait", 0, 0)]
    device = [(4.0, 6.0, "kernel"),
              (7.5 + shift, 7.6 + shift, "Memcpy DtoH (Device -> Pageable)"),
              (9.2, 9.8, "Memcpy DtoH (Device -> Pageable)")]
    return _Run([(1.0, 9.0, 10.0)], spans, device,
                dict(lanes_launched=8192, lanes_live=2048.0,
                     splat_slots=3 * 8192, splats_added=2457.6))


def test_idle_goes_to_the_innermost_span():
    run = _one_frame()
    by, top, after = sp.idle_by_span(run)
    # the gaps 0-4, 6-7.5, 7.6-9.2 and 9.8-10 s, cut by the innermost span
    assert by == pytest.approx({
        "between_frames": 1.0, "render_call": 0.2, "render": 0.7 + 0.9,
        "gate": 0.2 + 0.5, "bake": 0.5 + 1.0, "wait": 1.5 + 0.4,
        "film_copy": 0.4})
    assert top == [[pytest.approx(4.0), "bake"],
                   [pytest.approx(1.6), "render"],
                   [pytest.approx(1.5), "wait"],
                   [pytest.approx(0.2), "film_copy"]]
    # render's own idle: 1.1-1.2 at its start, 1.4-2 after the first gate,
    # 4 s after the bake is busy, 8-8.9 after the wait
    assert after == pytest.approx({"start": 0.1, "gate": 0.6, "wait": 0.9})
    assert sp.per_frame_ms(run, "bake") == pytest.approx(1500.0)
    assert sp.per_frame_ms(run, "gate") == pytest.approx(700.0)
    assert sp.per_frame_ms(run, "wait") == pytest.approx(2000.0)
    assert sp.per_frame_ms(run, "feed") == 0.0
    assert sp.live_lane_share(run) == pytest.approx(25.0)
    assert sp.splat_share(run) == pytest.approx(10.0)


def test_clock_check():
    assert sp.clock_check(_one_frame()) == 1.0
    assert sp.clock_check(_one_frame(shift=0.45)) == 0.0
    assert sp.inside_calls(_one_frame()) == 1.0


def test_anchors_undo_a_slipping_device_clock():
    # ten frames a second apart; each frame's counters' copy ends 20 us
    # before its last wait does (t + 0.5 to t + 0.6), but the trace maps
    # the device 30 ms x t early for t from 2 to 5
    frames, spans, device = [], [], []
    for t in range(10):
        frames.append((t + 0.05, t + 0.95, t + 1.0))
        r = len(spans)
        spans += [(t + 0.1, t + 0.9, "render", None, r),
                  (t + 0.5, t + 0.6, "wait", r, r)]
        d = 0.03 * t if 2 <= t <= 5 else 0.0
        device += [(t + 0.2 - d, t + 0.3 - d, "kernel"),
                   (t + 0.59997 - d, t + 0.59998 - d, "Memcpy DtoH (Device)"),
                   (t + 0.96 - d, t + 0.99 - d, "Memcpy DtoH (Device)")]
    run = _Run(frames, spans, device)
    assert sp.clock_check(run) == 0.8  # t = 4, 5 start before the wait
    # four anchors of ten read late: the median is a sound frame's 20 us
    assert sp.clock_offsets_us(run) == pytest.approx((20.0, 20.0, 150020.0))
    fixed = sp.anchored(run)
    assert sp.clock_check(fixed) == 1.0
    assert fixed.device_spans[0] == pytest.approx((0.2, 0.3, "kernel"))
    assert fixed.device_spans[-3][:2] == pytest.approx((9.2, 9.3))
    # the same window slipped throughout by 1 ms: nothing to anchor to
    run.device_spans = [(a - 1e-3, b - 1e-3, n) for a, b, n in device]
    assert sp.anchored(run) is None


def test_readers_without_program_spans_read_nothing():
    run = _one_frame()
    run.program_spans, run.program_counters = [], {}
    assert sp.per_frame_ms(run, "bake") is None
    assert sp.live_lane_share(run) is None
    assert sp.splat_share(run) is None
    by, _, after = sp.idle_by_span(run)
    assert not after
    assert set(by) == {"between_frames", "render_call", "film_copy"}


def test_cpu_window_spans_inside_their_calls():
    import sys

    sys.path.insert(0, os.path.join(ROOT, "ptbench", "tests"))
    from bench_helpers import small_cell

    tc = _tool()
    cell = small_cell("textured_cornell.pt", size=16, samples=1)
    run, films, _ = tc.window(cell, 3000000123, float("inf"), "cpu",
                              max_frames=2)
    assert len(run.frames) == len(films) == 2
    assert sp.inside_calls(run) == 1.0
    s = tc.summary(run)
    assert s["spans_per_frame"]["render"] == 1.0
    assert s["spans_per_frame"]["gate"] == 1.0
    assert s["bake_ms_per_frame"] > 0 and 0 < s["live_lane_share"] <= 100
    assert s["splat_share"] is None  # a PT cell splats nothing
    rounds = run.frames[0]["rounds"]
    assert run.program_counters["lanes_launched"] == pytest.approx(
        sum(f["rounds"] for f in run.frames) * mk.TILE)
    assert rounds > 0
