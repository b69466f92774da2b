"""What a configuration or a traffic mix may say, and that nothing it says
is dropped: the loader refuses an unknown kind or key and a name that is
not there, the reference's side
refuses traffic settings it does not model, a configuration with media and
its medium-aware traffic go in as new files and entries alone, and the
program's recorder is on in a traced window and off otherwise."""

import copy
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from bench_helpers import small_cell
from ptbench import run as R
from ptbench.reference import loader

FOG = os.path.join(os.path.dirname(__file__), "fixtures", "fog_cornell")
def _fog():
    with open(os.path.join(FOG, "scene.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("where", [
    ("curves", "fog_g"), ("textures", "tw"), ("materials", "fog_shell"),
    ("mediums", "fog"), ("mediums", "haze"), ("prims", 7),
    ("environment", None), ("camera", None)])
@pytest.mark.parametrize("fault", ["key", "kind"])
def test_loader_refuses_what_it_does_not_take(tmp_path, where, fault):
    doc = _fog()
    if where[1] is None:
        spec = doc[where[0]]
    elif where[0] == "textures":
        spec = doc["textures"][where[1]][0]
    else:
        spec = doc[where[0]][where[1]]
    if fault == "key":
        spec["density"] = 1.0
    elif "kind" in spec:
        spec["kind"] = "heterogeneous"
    else:  # a camera and a texture layer have no kind: drop a key instead
        spec.pop(next(iter(spec)))
    d = tmp_path / "c"
    d.mkdir()
    (d / "scene.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        loader.load(str(d), R.ROOT)


@pytest.mark.parametrize("change", [
    lambda d: d["materials"]["fog_shell"].__setitem__("inner_medium", "mist"),
    lambda d: d["mediums"]["fog"].__setitem__("sigma_s", "nothing"),
    lambda d: d.__setitem__("volumes", {}),
    lambda d: d.__setitem__("precision", "bfloat16"),
], ids=["unknown medium", "unknown curve", "unknown section", "precision"])
def test_loader_refuses_names_and_sections_that_are_not_there(tmp_path,
                                                              change):
    doc = _fog()
    change(doc)
    d = tmp_path / "c"
    d.mkdir()
    (d / "scene.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        loader.load(str(d), R.ROOT)


PT = R.load_json(R.HERE, "traffic", "pt_1080_spp8.json")
LT = R.load_json(R.HERE, "traffic", "lt_1080_ppp4.json")


@pytest.mark.parametrize("traffic", [
    dict(PT, settings=dict(PT["settings"], hwss=True)),
    dict(PT, settings=dict(PT["settings"], only_direct=True)),
    dict(LT, settings=dict(LT["settings"], medium_aware=True)),
    dict(PT, stepper="split"),
    dict(PT, integrator="bdpt"),
], ids=["hwss", "unknown setting", "medium-aware LT", "unknown key",
        "unknown integrator"])
def test_reference_side_refuses_what_it_does_not_model(traffic):
    data = loader.load(FOG, R.ROOT)
    with pytest.raises(NotImplementedError):
        R.reference_side(data, traffic, 1, "cpu")


def test_reference_side_takes_medium_aware_settings():
    _, s = R.reference_settings(dict(PT, settings=dict(PT["settings"],
                                                       medium_aware=True)))
    assert s.medium_aware
    assert not R.reference_settings(PT)[1].medium_aware


def test_a_medium_aware_configuration_is_new_files_and_entries(tmp_path):
    """A copy of the benchmark gets the fog box as a configuration, a
    medium-aware traffic mix, limits and a cell, by new files and new
    entries of BENCHMARK.json only; its harness, unedited, loads the scene,
    builds it through the program, runs a short window and renders the
    reference with the media on both sides."""
    root = tmp_path / "checkout"
    shutil.copytree(R.HERE, root / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    shutil.copytree(FOG, root / "ptbench" / "configs" / "fog_cornell")
    (root / "ptbench" / "traffic" / "pt_medium_1080_spp8.json").write_text(
        json.dumps(dict(PT, settings=dict(PT["settings"], medium_aware=True))))
    shutil.copy(os.path.join(R.HERE, "limits", "gem_cornell.pt.json"),
                root / "ptbench" / "limits" / "fog_cornell.pt.json")
    new = copy.deepcopy(bench)
    new["configs"].append(dict(new["configs"][0], name="fog_cornell",
                               file="ptbench/configs/fog_cornell/scene.json",
                               reduced=[]))
    new["workloads"].append(dict(new["workloads"][0], name="fog_cornell.pt",
                                 config="fog_cornell",
                                 traffic="pt_medium_1080_spp8"))
    for m in new["end_to_end"] + new["per_layer"]:
        if "gem_cornell.pt" in m.get("workloads", []):
            m["workloads"].append("fog_cornell.pt")
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    for d, _, files in os.walk(R.HERE):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), R.HERE)
                assert filecmp.cmp(os.path.join(d, f),
                                   root / "ptbench" / rel, shallow=False)
    code = (
        "import json, sys, time\n"
        "sys.path.insert(0, 'ptbench/tests')\n"
        "from bench_helpers import small_cell\n"
        "from ptbench import port, run as R\n"
        "from ptbench.reference import loader\n"
        "cell = small_cell('fog_cornell.pt', size=12, samples=2, grid=2,\n"
        "                  reference_spp=8, reference_batches=4)\n"
        "data = loader.load(cell.config_dir, R.ROOT)\n"
        "world, _ = port.build_scene(data, 12, 12, 'cpu')\n"
        "out = R.run_cell(cell, 7, float('inf'), False, 'cpu',\n"
        "                 t_start=time.perf_counter(), max_frames=2)\n"
        "print(json.dumps(dict(\n"
        "    root=R.ROOT, media=int(world.mediums.count),\n"
        "    program=port.settings(cell.traffic).medium_aware,\n"
        "    reference=R.reference_settings(cell.traffic)[1].medium_aware,\n"
        "    reference_media=len(data.mediums),\n"
        "    frames=out['attempted'], checks=sorted(out['checks']))))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), R.ROOT]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          text=True, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["root"] == str(root)
    assert got["media"] == 3 and got["reference_media"] == 2
    assert got["program"] and got["reference"] and got["frames"] == 2
    assert "film_z_rms" in got["checks"]


def _watched(cell):
    """The cell's entry, noting whether the program's recorder is on at
    each call."""
    from pathtracer_tpu_torch.utils import profile
    from ptbench import port

    entry = port.entry(cell.traffic)
    seen = []

    def render(*args, **kw):
        seen.append(profile.recorder() is not None)
        return entry(*args, **kw)
    return render, seen


@pytest.mark.parametrize("trace", [0, 1])
def test_recorder_only_in_a_traced_window(trace):
    cell = small_cell("textured_cornell.pt", size=16, samples=1)
    render, seen = _watched(cell)
    out = R.run_cell(cell, 3000000321, float("inf"), bool(trace), "cpu",
                     t_start=time.perf_counter(), render=render, max_frames=2)
    run = out["run"]
    # the warm-up frame runs with the recorder off; the window's frames
    # with it on exactly when traced
    assert seen == [False] + [bool(trace)] * 2
    if not trace:
        assert run.program_spans is None and run.program_counters is None
        return
    names = {s[2] for s in run.program_spans}
    assert {"render", "gate", "bake", "feed", "wait"} <= names
    assert run.program_counters["lanes_launched"] > 0
    for name in ("bake_ms_per_frame.host_bound",
                 "host_wait_ms_per_frame.host_bound",
                 "live_lane_share.host_bound",
                 "feed_ms_per_frame.host_bound"):
        assert out["metrics"][name]["value"] > 0
    assert 0 < out["metrics"]["live_lane_share.host_bound"]["value"] <= 100
