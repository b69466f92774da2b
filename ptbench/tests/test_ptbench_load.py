"""Every configuration, traffic mix, metric and limit that BENCHMARK.json
names loads by its name."""

import os

import numpy as np
import pytest

from ptbench import run as R
from ptbench.reference import loader

BENCH = R.load_json(R.ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_loads(config):
    c = {c["name"]: c for c in BENCH["configs"]}[config]
    data = loader.load(os.path.join(R.ROOT, os.path.dirname(c["file"])),
                       R.ROOT)
    assert data.name == config and data.precision == "float32"
    assert data.prims and data.materials and data.curves
    for layers in data.textures.values():
        for w, curve in layers:
            assert w.dtype == np.float32 and curve in data.curves
    meshes = [p for p in data.prims if p["kind"] == "mesh"]
    for m in meshes:
        assert loader.triangles(m).shape[1:] == (3, 3)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(workload):
    cell = R.Cell(BENCH, workload)
    tr = cell.traffic
    assert tr["width"] % tr["check"]["grid"] == 0
    assert {"film_z_rms", "frame_z_rms_max", "sample_gap",
            "repeated_frames", "nonfinite"} <= set(cell.limits) <= {
        "film_z_rms", "frame_z_rms_max", "frame_z_max", "bounce_z",
        "sample_gap", "repeated_frames", "nonfinite"}
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(R.load_metric(metric).read)


def test_textured_texels_match_the_png():
    c = {c["name"]: c for c in BENCH["configs"]}["textured_cornell"]
    data = loader.load(os.path.join(R.ROOT, os.path.dirname(c["file"])),
                       R.ROOT)
    checker = data.textures["checker"][0][0]
    assert checker.shape == (8, 8)
    assert 0.0 <= checker.min() < checker.max() <= 1.0
    alpha = data.textures["cloud"][3][0]
    assert alpha.shape == (64, 64) and alpha.max() <= 1.0


def test_icosphere_is_outward_wound():
    v, f = loader.generator("icosphere").generate([0.5, 0.5, 0.5], 0.25, 2)
    p = v[f]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    out = p.mean(axis=1) - np.array([0.5, 0.5, 0.5])
    assert f.shape == (320, 3) and ((n * out).sum(-1) > 0).all()
