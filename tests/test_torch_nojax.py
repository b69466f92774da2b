"""The port stands without JAX: in a fresh interpreter where `jax` and
`pathtracer_tpu` cannot be imported, every module of pathtracer_tpu_torch
imports, and a 16x16 @ 1 spp path-traced render, a 16x16 @ 2 paths per
pixel light-traced render (the LT megakernel's route), a 12x12 @ 1 light-traced
render of the textured box (the light-tracing wavefront `lt_trace`), a
12x12 @ 1 BDPT render and a 12x12 @ 2 spp medium-aware render of the fog
box (through the two-program and the split round, which must agree) run on
the CPU. And chip_smoke.py,
which drives the port on a GPU, exits non-zero and prints no result where
there is no CUDA device."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["pathtracer_tpu"] = None
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
import pathtracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "pathtracer_tpu."))
               for k, v in sys.modules.items() if v is not None)
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.renderer.persistent import render_regen
world = scenes.chip_scene(SceneBuilder(), spectral).build("cpu")
cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
film, profile, _ = render_regen(world, cam, PTSettings(light_samples=2), 16,
                                16, 1, generator=torch.Generator().manual_seed(0))
assert film.shape == (16, 16, 3) and bool(torch.isfinite(film).all())
assert float(film[..., 1].mean()) > 0 and profile.camera_rays == 256
from pathtracer_tpu_torch.integrator.lt import LTSettings
from pathtracer_tpu_torch.renderer.splatted import render_splatted
world = scenes.chip_lens(SceneBuilder(), spectral).build("cpu")
cam = make_projective_camera(**scenes.CHIP_LENS_CAMERA, device="cpu")
film, profile, _ = render_splatted(world, cam, LTSettings(max_bounces=4), 16,
                                   16, 2, generator=torch.Generator().manual_seed(0))
assert film.shape == (16, 16, 3) and bool(torch.isfinite(film).all())
assert float(film[..., 1].mean()) > 0 and profile.light_rays == 512
world = scenes.textured_cornell(SceneBuilder(), spectral).build("cpu")
cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device="cpu")
stats = {}
film, profile, _ = render_splatted(world, cam, LTSettings(max_bounces=3), 12,
                                   12, 1, generator=torch.Generator().manual_seed(0),
                                   stats=stats)
assert stats["route"] == "lt_trace" and bool(torch.isfinite(film).all())
assert float(film[..., 1].mean()) > 0 and profile.light_rays == 144
from pathtracer_tpu_torch.integrator.bdpt import BDPTSettings
from pathtracer_tpu_torch.renderer.bdpt_renderer import render_bdpt
world = scenes.cornell_box(SceneBuilder(), spectral).build("cpu")
cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
film, profile, _ = render_bdpt(world, cam, BDPTSettings(max_depth=3), 12, 12,
                               1, generator=torch.Generator().manual_seed(0))
assert film.shape == (12, 12, 3) and bool(torch.isfinite(film).all())
assert float(film[..., 1].mean()) > 0 and profile.light_rays == 144
world = scenes.fog_cornell(SceneBuilder(), spectral).build("cpu")
cam = make_projective_camera(**scenes.CORNELL_CAMERA, device="cpu")
medium = PTSettings(light_samples=2, medium_aware=True, hwss=True)
films = [render_regen(world, cam, medium, 12, 12, 2, stepper=stepper,
                      generator=torch.Generator().manual_seed(0))[0]
         for stepper in (None, "split")]
assert films[0].shape == (12, 12, 3) and bool(torch.isfinite(films[0]).all())
assert float(films[0][..., 1].mean()) > 0 and torch.equal(*films)
print("MODULES", len(names))
"""


def test_port_imports_and_renders_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _SCRIPT],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split("MODULES")[1]) >= 24


def test_port_sources_name_no_jax():
    pkg = os.path.join(ROOT, "pathtracer_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in src, f
                assert "from jax" not in src, f
                assert "import pathtracer_tpu\n" not in src, f
                assert "from pathtracer_tpu." not in src, f
                assert "from pathtracer_tpu import" not in src, f


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
