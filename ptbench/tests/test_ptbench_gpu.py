"""One short run of a cell on the card through the command the benchmark
names (marked `gpu`; skipped without a CUDA device):

    python -m pytest ptbench/tests -m gpu
"""

import json
import os
import subprocess
import sys

import pytest

from ptbench import run as R


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_smoke_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    cell = bench["workloads"][0]
    out = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload", cell["name"],
         "--seed", "2900000001", "--seconds", "5", "--trace", str(trace)],
        cwd=R.ROOT, text=True, capture_output=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    names = {m["name"] for m in (bench["per_layer"] if trace
                                 else bench["end_to_end"])
             if cell["name"] in m.get("workloads", [cell["name"]])}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"
