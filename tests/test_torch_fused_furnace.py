"""The port's plain fused round against the JAX fused round on the
dispersive hero-wavelength furnace (light samples 0, no Russian roulette),
C = 1 and C = 4, three chained rounds at 64x64 from the same state and
uniforms. Same tolerances and reasons as test_torch_fused_round.py; this
scene exercises the constant-environment escape, the near-delta (α = 4e-4)
dispersive dielectric and the HWSS pdf-ratio rows."""

import pytest
import torch

from pathtracer_tpu_torch.kernels import megakernel as tm

from torch_ref_helpers import chained_rounds, check_round

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[1, 4], ids=["C1", "C4"])
def rounds(request):
    return chained_rounds("furnace", request.param)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_round_matches_jax(rounds, r):
    check_round(*rounds[r])


def test_furnace_rounds_escape_and_refract(rounds):
    out = rounds[-1][1]
    assert out[tm.O4_ENV_CT].sum() > 0
    assert out[tm.O4_BOUNCE_CT].sum() > 0
    assert out[tm.O4_SHADOW_CT].sum() == 0  # no NEE at light samples 0
