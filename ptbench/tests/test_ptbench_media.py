"""A configuration with participating media on both sides: the program's
scene as `port.build_scene` builds it (its media, and its boundaries naming
them), and the program's plain twins against the plain reference on a
small fog box (`fixtures/fog_cornell`, the port's `scenes.fog_cornell`
restated) under medium-aware path tracing: the comparison that decides
`correct` passes at the path-tracing cells' limits, and the reference in
bfloat16 in the program's place fails it."""

import math
import os
import time
from types import SimpleNamespace

import pytest
import torch

from ptbench import check, port, run as R
from ptbench.reference import loader, pt

torch.set_num_threads(4)

FOG = os.path.join(os.path.dirname(__file__), "fixtures", "fog_cornell")
LIMITS = R.load_json(R.HERE, "limits", "gem_cornell.pt.json")


def fog_traffic(size, samples, grid, reference_spp):
    tr = R.load_json(R.HERE, "traffic", "pt_1080_spp8.json")
    return dict(tr, width=size, height=size, samples=samples,
                settings=dict(tr["settings"], medium_aware=True),
                check=dict(tr["check"], grid=grid,
                           reference_spp=reference_spp))


@pytest.fixture(scope="module")
def data():
    return loader.load(FOG, R.ROOT)


def test_port_builds_the_media(data):
    """g in the scene file is the HG asymmetry: the program's phase of the
    built fog medium is HG(0.6); the haze's sigma_s is the reference's at
    every wavelength; each boundary names its own medium inside, vacuum
    outside."""
    from pathtracer_tpu_torch.mediums.tables import (medium_coefficients,
                                                      phase_eval)

    world, _ = port.build_scene(data, 8, 8, "cpu")
    meds, bank = world.mediums, world.bank
    assert meds.count == 3  # vacuum, fog, haze
    cos = torch.tensor([-0.9, -0.3, 0.0, 0.4, 0.95])
    lam = torch.full_like(cos, 550.0)
    fog = torch.ones(5, dtype=torch.int32)
    g = 0.6
    hg = (1 - g * g) / (4 * math.pi * (1 + g * g - 2 * g * cos) ** 1.5)
    torch.testing.assert_close(phase_eval(meds, bank, fog, lam, cos), hg,
                               rtol=1e-5, atol=0)
    haze = torch.full((5,), 2, dtype=torch.int32)
    torch.testing.assert_close(phase_eval(meds, bank, haze, lam, cos),
                               3 * (1 + cos * cos) / (16 * math.pi),
                               rtol=1e-6, atol=0)
    lam = torch.tensor([380.0, 450.0, 550.0, 650.0, 780.0])
    scene = pt.Scene(data, "cpu")
    cv = scene.curves_at(lam)
    ss_ref, sa_ref, _ = scene.media.coefficients(cv, lam)
    for k in (1, 2):
        ss, sa, _ = medium_coefficients(meds, bank,
                                        torch.full((5,), k,
                                                   dtype=torch.int32), lam)
        torch.testing.assert_close(ss, ss_ref[:, k - 1], rtol=1e-4, atol=0)
        torch.testing.assert_close(sa, sa_ref[:, k - 1], rtol=1e-5, atol=0)
    mats = world.mats
    names = list(data.materials)
    for shell, k in (("fog_shell", 1), ("haze_shell", 2)):
        i = names.index(shell)
        assert int(mats.inner_medium[i]) == k
        assert int(mats.outer_medium[i]) == 0
    assert int(mats.inner_medium[names.index("mw")]) == 0


def test_fog_box_program_against_the_reference(data):
    """32 x 32 at 4 samples a pixel, 6 frames, on the two-program round's
    medium branch (`med_feed`, the MEDIUM K12 and K34 twins)."""
    tr = fog_traffic(32, 4, 4, 64)
    cell = SimpleNamespace(traffic=tr, config_dir=FOG)
    run, films, _ = R.run_window(cell, 3100000123, float("inf"), False, "cpu",
                                 t_start=time.perf_counter(), max_frames=6)
    assert {f["route"] for f in run.frames} == {"megakernel"}
    prog = R.program_side(run, films)
    ref = R.reference_side(data, tr, 3100000123, "cpu")
    values = check.readings(prog, ref, 32 * 32 * 4)
    correct, checks = check.judge(values, LIMITS)
    assert correct, checks


def test_fog_box_control_is_not_correct(data):
    """The reference in bfloat16 in the program's place, at the program's
    size: 6 frames of 4 samples a pixel at 32 x 32."""
    tr = fog_traffic(32, 4, 4, 64)
    ctrl = R.reference_side(data, tr, 5, "cpu", dtype=torch.bfloat16,
                            frames=6)
    ref = R.reference_side(data, tr, 5, "cpu")
    values = check.readings(ctrl, ref, 32 * 32 * 4)
    correct, checks = check.judge(values, LIMITS)
    assert not correct, checks
