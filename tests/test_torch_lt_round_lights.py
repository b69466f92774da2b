"""Two light-tracing routes that the chip-scene and HDR-blob cases of
tests/test_torch_lt_round.py do not reach, twins against the JAX package's
pallas_calls (interpret mode) by that file's checks and tolerances:

- `cornell_sharp` through K34-LT v2: the in-kernel spawn samples a sharp
  (cosine-power) light disk, emission direction and pdf included;
- `sun_sphere` through the torch spawn feed and K34-LT v1: particles spawned
  from a Sun environment's disk of directions.

Three chained rounds from 2048 dead lanes with 2 particles each, on the
uniforms the JAX rounds draw, 1 camera sample, stratified."""

import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch.kernels import lt_mega as tlt

from test_torch_lt_round import _cont, _few, check_out, check_q
from torch_ref_helpers import chained_lt

torch.set_num_threads(2)

CASES = {"sharp_v2": ("sharp", True), "sun_v1": ("sun", False)}


@pytest.fixture(scope="module", params=sorted(CASES))
def rounds(request):
    recipe, v2 = CASES[request.param]
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        yield v2, chained_lt(recipe, dict(max_bounces=8, camera_samples=1,
                                          stratified=True), v2)
    finally:
        jm.TILE, jm.SUB = tile, sub


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_lt_shade_matches_jax(rounds, r):
    x = rounds[1][r]
    check_q(x["jq"], x["q"], x["tin"][tlt.LS_ALIVE] > 0.5, 1)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_lt_finalize_matches_jax(rounds, r):
    v2, rec = rounds
    x = rec[r]
    if v2:
        assert x["usp_equal"]
    else:
        disc = [tlt.F_ALIVE, tlt.F_ENV, tlt.F_LV + 7, tlt.F_LV_VALID]
        for row in range(tlt.NF):
            if row in disc:
                assert _few(x["jfeed"][row] != x["feed"][row], 1e-3), row
            else:
                _cont(x["jfeed"][row], x["feed"][row], f"feed row {row}")
    check_out(x["jout"], x["out"], 1, v2)


def test_rounds_do_work(rounds):
    """Every lane spawns in round 1; particles walk, and connect to the
    camera without being blocked."""
    v2, rec = rounds
    aux = tlt.k4_aux_v2(1) if v2 else tlt.k4_aux(1)
    assert rec[0]["out"][aux["resp"]].sum() == rec[0]["out"].shape[1]
    assert rec[1]["q"][tlt.Q_ALIVE].sum() > 0
    assert sum(x["out"][aux["conn_ct"]].sum() for x in rec) > 0
    if not v2:
        # the Sun's particles carry the environment flag
        assert rec[0]["feed"][tlt.F_ENV].sum() > 0
