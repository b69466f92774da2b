"""The port's plain fused bounce round (twin of csrc/fused_round.cu) against
the JAX package's fused round (_step_fused, Pallas interpret mode) on the
chip scene at 64x64, for C = 1 and C = 4 hero-wavelength lanes, light
samples 2. Both chain three rounds on their own state from the JAX initial
state with the same uniform blocks.

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
