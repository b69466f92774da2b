"""The port's plain fused round against the JAX fused round on the Cornell
walls lit by a sharp (cosine-power) light disk, with a disk on the floor:
C = 1 and C = 4, light samples 2, three chained rounds at 64x64 from the
same state and uniforms. Same tolerances and reasons as
test_torch_fused_round.py; this scene exercises the sharp-light emission
(on hits and in NEE), disk intersections and disk light sampling, which the
chip scene does not."""

import pytest
import torch

from pathtracer_tpu_torch.kernels import megakernel as tm

from torch_ref_helpers import chained_rounds, check_round

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[1, 4], ids=["C1", "C4"])
def rounds(request):
    return chained_rounds("sharp", request.param)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_round_matches_jax(rounds, r):
    check_round(*rounds[r])


def test_sharp_light_rounds_do_work(rounds):
    out = rounds[-1][1]
    for row in (tm.O4_BOUNCE_CT, tm.O4_CAMERA_CT, tm.O4_SHADOW_CT):
        assert out[row].sum() > 0, row
    assert (out[tm.S_ACC + 1] > 0).any()
