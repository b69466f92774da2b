"""The port's plain fused bounce round (twin of csrc/fused_round.cu) against
the JAX package's fused round (_step_fused, Pallas interpret mode) on the
chip scene at 64x64, for C = 1 and C = 4 hero-wavelength lanes, light
samples 2, and at 32x32 for C = 1 at light samples 1 and 3 (1,024 live
lanes of the 4,096 a round pads to: at 64x64 one lane of 4,096 leaves rtol
5e-3 in a direction row by round 3 at light samples 3, through the
near-delta glass below).
Both chain three rounds on their own state from the JAX initial state with
the same uniform blocks.

Tolerances, and why:
- discrete rows (alive, bounce, samples left) equal on >= 99.9% of lanes,
  and the per-round counters within 0.1% of the lanes: only a lane whose
  RR or shadow decision flips on f32 op order may diverge;
- continuous rows on the lanes whose discrete rows match: >= 99.5% within
  rtol 1e-4, atol 1e-5, and all within rtol 5e-3, atol 1e-4. XLA's CPU
  backend contracts multiply-adds into FMAs and torch does not, and the
  near-delta glass (α = 0.001) amplifies a one-ulp direction difference;
- the previous-bounce pdf row (S_PREV_PDF) holds that near-delta lobe's pdf
  (∝ 1/α²): all within rtol 2e-2 there.
"""

import pytest
import torch

from pathtracer_tpu_torch.kernels import megakernel as tm

from torch_ref_helpers import CT_ROWS, chained_rounds, check_round

torch.set_num_threads(2)

RECIPE = "chip"


@pytest.fixture(scope="module", params=[1, 4], ids=["C1", "C4"])
def rounds(request):
    return chained_rounds(RECIPE, request.param)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_round_matches_jax(rounds, r):
    check_round(*rounds[r])


@pytest.fixture(scope="module", params=[1, 3], ids=["ls1", "ls3"])
def rounds_odd(request):
    return request.param, chained_rounds(RECIPE, 1, width=32,
                                         light_samples=request.param)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_round_matches_jax_odd_light_samples(rounds_odd, r):
    ls, rounds = rounds_odd
    check_round(*rounds[r])
    # every sample worth a ray is counted: at most ls a lane
    shadow = rounds[r][1][tm.O4_SHADOW_CT]
    assert shadow.max() <= ls and shadow.sum() > 0


def test_rounds_do_work(rounds):
    """The chip scene's rounds bounce, shadow-test, escape and respawn."""
    out = rounds[-1][1]
    for row in CT_ROWS:
        assert out[row].sum() > 0, row
    assert (out[tm.S_ACC + 1] > 0).any()


def test_wrapper_takes_plain_twin_on_cpu():
    from torch_ref_helpers import both_settings, both_worlds, NEE_SETTINGS

    _, tw, _, tc = both_worlds(RECIPE)
    _, ts = both_settings(**NEE_SETTINGS)
    scene = tm.build_mega_scene(tw, tc)
    a = tm.RoundArgs.make(scene.consts, ts, 16, 16)
    state = torch.zeros((tm.NS, 256))
    u = torch.rand((tm.nu_rows(2), 256), generator=torch.Generator()
                   .manual_seed(0))
    launches, calls = tm.FUSED_LAUNCHES, tm.PLAIN_CALLS
    out = tm.fused_round(u, state, scene, a)
    assert tm.FUSED_LAUNCHES == launches and tm.PLAIN_CALLS == calls + 1
    # all lanes dead: a pass-through with zero counters
    assert torch.equal(out[:tm.NS], state) and not out[tm.NS:].any()
    with pytest.raises(ValueError):
        tm.fused_round(u[:4], state, scene, a)
    with pytest.raises(TypeError):
        tm.fused_round(u.double(), state, scene, a)
