"""What a run loads: nothing whose top-level module name (the part before
the first dot, compared whole) is JAX's or the JAX package's, and for the
plain reference nothing of the program either."""

import json
import os
import subprocess
import sys

from ptbench import run as R

ROOT = R.ROOT


def test_forbidden_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax", "pathtracer_tpu",
             "pathtracer_tpu.kernels", "pathtracer_tpu_torch",
             "pathtracer_tpu_torch.kernels.dense", "jaxtyping", "flaxen"]
    assert R.forbidden_modules(names) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "pathtracer_tpu",
        "pathtracer_tpu.kernels"]


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    loaded = _python(
        "import json, sys\n"
        "sys.path.insert(0, 'ptbench/tests')\n"
        "from bench_helpers import cpu_run, small_cell\n"
        "from ptbench import run as R\n"
        "out = cpu_run(small_cell('textured_cornell.pt', size=12, grid=2,\n"
        "              samples=2, reference_spp=16), frames=3)\n"
        "print(json.dumps(R.forbidden_modules()))\n")
    assert loaded == []


def test_the_reference_loads_no_program():
    loaded = _python(
        "import json, sys, torch\n"
        "from ptbench.reference import loader, pt\n"
        "d = loader.load('ptbench/configs/gem_cornell', '.')\n"
        "film, cnt = pt.render(pt.Scene(d, 'cpu'), 8, 8, 1, pt.Settings(),\n"
        "                      torch.Generator().manual_seed(1))\n"
        "assert cnt['camera_rays'] == 64\n"
        "print(json.dumps(sorted(n for n in sys.modules\n"
        "      if n.split('.')[0] in ('pathtracer_tpu_torch', 'pathtracer_tpu',\n"
        "                             'jax', 'jaxlib'))))\n")
    assert loaded == []
