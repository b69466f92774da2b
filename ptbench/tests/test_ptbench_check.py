"""The comparison that decides `correct`, driven through the harness on the
CPU (the program's plain twins) at a film a test run can hold: a sound run
passes; the run with its timed path broken underneath fails, once for each
fault a renderer's cell can have; the lower-precision control fails. (The
exchange between chips has no counterpart: every cell runs on one chip.)"""

import numpy as np
import pytest
import torch

from bench_helpers import cpu_run, small_cell
from ptbench import check, port, run as R
from ptbench.reference import loader

WORKLOAD = "textured_cornell.pt"
CONTROL_FILM = {"textured_cornell.pt": (96, 4)}  # (size, grid); else 48, 8


def entry():
    return port.entry(small_cell(WORKLOAD).traffic)


def stale_frames(*args, **kw):
    """A frame that returns the state of the first one unchanged."""
    if not hasattr(stale_frames, "first"):
        stale_frames.first = entry()(*args, **kw)
    return stale_frames.first


def half_the_samples(world, camera, settings, w, h, spp, **kw):
    """Half of each pixel's samples left out, the mean taken over the
    rest."""
    return entry()(world, camera, settings, w, h, spp // 2, **kw)


def one_frame_altered(*args, **kw):
    """One frame's film altered where it is produced."""
    one_frame_altered.calls = getattr(one_frame_altered, "calls", 0) + 1
    film, prof, t = entry()(*args, **kw)
    if one_frame_altered.calls == 4:  # the warm-up frame is call 1
        film = film * 4.0
    return film, prof, t


@pytest.fixture(scope="module")
def sound():
    return cpu_run(small_cell(WORKLOAD))


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] == 6
    assert sound["checks"]["sample_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault,failing", [
    (stale_frames, "repeated_frames"),
    (half_the_samples, "sample_gap"),
    (one_frame_altered, "frame_z_rms_max"),
])
def test_fault_is_not_correct(fault, failing):
    out = cpu_run(small_cell(WORKLOAD), render=fault)
    assert not out["correct"]
    c = out["checks"][failing]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("workload", [
    w["name"] for w in R.load_json(R.ROOT, "BENCHMARK.json")["workloads"]])
def test_control_is_not_correct(workload):
    """The plain reference in bfloat16 in the program's place, at a film
    large enough for its gap to stand out of the noise (the textured box's
    six rects need more samples a block than the gem's caustics)."""
    size, grid = CONTROL_FILM.get(workload, (48, 8))
    cell = small_cell(workload, size=size, samples=8, grid=grid,
                      reference_spp=128)
    tr = cell.traffic
    data = loader.load(cell.config_dir, R.ROOT)
    ctrl = R.reference_side(data, tr, 5, "cpu", dtype=torch.bfloat16,
                            frames=6)
    ref = R.reference_side(data, tr, 5, "cpu")
    values = check.readings(ctrl, ref, tr["width"] * tr["height"]
                            * tr["samples"])
    correct, checks = check.judge(values, cell.limits)
    assert not correct, checks


def test_perturbed_film_fails_the_film_check(sound):
    """The same comparison, with every frame's film 25% too bright (as a
    wrong spectral normalisation would make it)."""
    cell = small_cell(WORKLOAD)
    tr = cell.traffic
    data = loader.load(cell.config_dir, R.ROOT)
    ref = R.reference_side(data, tr, 7, "cpu")
    prog = R.reference_side(data, tr, 8, "cpu", frames=6)
    asked = tr["width"] * tr["height"] * tr["samples"]
    assert check.judge(check.readings(prog, ref, asked), cell.limits)[0]
    prog.blocks = [b * 1.25 for b in prog.blocks]
    ok, checks = check.judge(check.readings(prog, ref, asked), cell.limits)
    assert not ok and checks["film_z_rms"]["value"] > \
        checks["film_z_rms"]["limit"]


def test_z_is_zero_for_equal_sides_and_inf_for_a_noiseless_gap():
    assert check._z(0.0, 0.0) == 0.0
    assert check._z(1.0, 0.0) == np.inf
    assert check._z(3.0, 4.0) == pytest.approx(1.5)
