"""Two branches of the bounce round that no recipe camera and no default
setting reach, twins against the JAX package's `_k12_call` and `_k34_call`
(Pallas interpret mode; `_finalize_core`'s respawn and continuation):

- a polygon aperture (`scenes.HEX_CAMERA`: diameter 0.3, six blades,
  sharpness 0.7): every respawn of K34 samples the hexagonal lens;
- `only_direct=True`: K34 ends every path after its first surface.

The Cornell box at 32x32, C = 1, light samples 2, 2 samples per pixel so that
lanes respawn within the three chained rounds; each side chains on its own
state from the JAX initial state (whose spawn already sampled the lens) with
the uniform blocks the JAX calls draw. The JAX kernels run at a 1024-lane
tile, which changes the grid, not the lanes' arithmetic. Tolerances are
`check_k2`'s and `check_round`'s (tests/test_torch_two_prog.py states them
and why)."""

import numpy as np
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch.kernels import megakernel as tm

from torch_ref_helpers import (
    NEE_SETTINGS,
    chained_two_prog,
    check_k2,
    check_round,
)

torch.set_num_threads(2)

CASES = {"hex_aperture": ("cornell_hex", NEE_SETTINGS),
         "only_direct": ("cornell", dict(NEE_SETTINGS, only_direct=True))}


@pytest.fixture(scope="module", params=sorted(CASES))
def rounds(request):
    recipe, settings = CASES[request.param]
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        yield request.param, chained_two_prog(recipe, 1, spp=2,
                                              settings=settings)
    finally:
        jm.TILE, jm.SUB = tile, sub


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_k12_matches_jax(rounds, r):
    x = rounds[1][r]
    check_k2(x["jk2"], x["k2"], x["alive"], NEE_SETTINGS["light_samples"])


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_k34_matches_jax(rounds, r):
    x = rounds[1][r]
    check_round(x["state"], x["out"], x["counts"])


def test_branch_is_reached(rounds):
    """The rounds do take the branch under test."""
    case, rec = rounds
    a = rec[0]["setup"].a
    respawned = sum(x["out"][tm.O4_CAMERA_CT].sum() for x in rec)
    assert respawned > 0
    if case == "hex_aperture":
        assert a.cam_blades == 6 and a.cam_lens_r == pytest.approx(0.15)
        # respawned lanes start on the lens, not at its centre
        x = rec[-1]
        o = x["out"][tm.S_O:tm.S_O + 3]
        off = np.linalg.norm(o - np.array([[-1.2], [0.5], [0.5]]), axis=0)
        new = x["out"][tm.O4_CAMERA_CT] > 0.5
        assert new.sum() > 50
        assert (off[new] > 1e-3).mean() > 0.9 and off[new].max() <= 0.151
    else:
        assert a.only_direct
        # no path goes past its first surface
        for x in rec:
            assert x["out"][tm.S_BOUNCE].max() <= 1.0
