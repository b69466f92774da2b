"""The port's plain two-program round (K12 `shade_sweep_plain`, K34
`finalize_sweep_plain`; twins of csrc/two_prog_round.cu) against the JAX
package's `_k12_call` and `_k34_call` (Pallas interpret mode) on the gem
stand-in (`scenes.gem_cornell`: 11 chunks, a near-delta dispersive gem in
the Cornell box) at 32x32, for C = 1 and C = 4 hero-wavelength lanes, light
samples 2. Both chain three rounds on their own state from the JAX initial
state with the uniform blocks the JAX calls draw. The JAX kernels run at a
1024-lane tile here (pt_trace_regen_mega's module-level lever), which keeps
their interpret-mode compile short; the tile changes the grid, not the
lanes' arithmetic.

Tolerances, and why:
- the K2 rows on the lanes where K34 reads them: radiance, at-surface and
  the counter rows on live lanes, the rest on lanes at a surface. The port
  writes 0 to surface rows elsewhere, where the JAX kernel leaves values
  that nothing reads. Discrete rows (at surface, counters, sample ok, the
  NEE samples' worth) equal on >= 99.9% of those lanes; continuous rows
  >= 99.5% within rtol 1e-4, atol 1e-5 and all within rtol 5e-3, atol 1e-4
  (2e-2 on the sampled pdf, O_FPDF), as check_round holds the state: XLA's
  CPU backend contracts multiply-adds into FMAs, torch does not, and the
  near-delta gem (α = 0.001, pdf ∝ 1/α²) amplifies an ulp. Where few lanes
  are at a surface the fractions allow one lane: a bounce ray grazing the
  surface it left re-hits it at an ill-conditioned t;
- the state after K34: check_round.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch.kernels import megakernel as tm

from torch_ref_helpers import (
    NEE_SETTINGS,
    both_settings,
    both_worlds,
    chained_two_prog,
    check_k2,
    check_round,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[1, 4], ids=["C1", "C4"])
def rounds(request):
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        yield chained_two_prog("gem", request.param)
    finally:
        jm.TILE, jm.SUB = tile, sub


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_k12_matches_jax(rounds, r):
    x = rounds[r]
    check_k2(x["jk2"], x["k2"], x["alive"], NEE_SETTINGS["light_samples"])


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_k34_matches_jax(rounds, r):
    x = rounds[r]
    check_round(x["state"], x["out"], x["counts"])


def test_rounds_do_work(rounds):
    """The gem's rounds bounce, shadow-test, escape and respawn."""
    for row in (tm.O4_BOUNCE_CT, tm.O4_CAMERA_CT, tm.O4_SHADOW_CT,
                tm.O4_ENV_CT):
        assert sum(x["out"][row].sum() for x in rounds) > 0, row
    assert (rounds[-1]["out"][tm.S_ACC + 1] > 0).any()


def test_wrappers_take_plain_twins_on_cpu():
    """On CPU tensors both wrappers run their twins and count no launch; a
    dead lane gets all-zero K2 rows and passes its state through K34."""
    _, tw, _, tc = both_worlds("gem")
    _, ts = both_settings(**NEE_SETTINGS)
    scene = tm.build_mega_scene(tw, tc)
    assert not tm.fused_ok(scene) and scene.env is None
    a = tm.RoundArgs.make(scene.consts, ts, 16, 16)
    gen = torch.Generator().manual_seed(0)
    state = torch.rand((tm.NS, 256), generator=gen)
    state[tm.S_ALIVE] = 0.0
    u12 = torch.rand((tm.n_u_rows(2), 256), generator=gen)
    u34 = torch.rand((tm.NU4, 256), generator=gen)
    launches = (tm.SHADE_LAUNCHES, tm.FINALIZE_LAUNCHES, tm.FUSED_LAUNCHES)
    calls = tm.PLAIN_CALLS
    k2 = tm.shade_sweep(u12, state, scene, a)
    out = tm.finalize_sweep(u34, state, k2, scene, a)
    assert (tm.SHADE_LAUNCHES, tm.FINALIZE_LAUNCHES,
            tm.FUSED_LAUNCHES) == launches
    assert tm.PLAIN_CALLS == calls + 2
    assert k2.shape == (tm.k2_rows(2), 256) and not k2.any()
    assert torch.equal(out[:tm.NS], state) and not out[tm.NS:].any()
    with pytest.raises(ValueError):
        tm.shade_sweep(u12[:4], state, scene, a)
    with pytest.raises(ValueError):
        tm.shade_sweep(u12, state, scene, a, ef=torch.zeros((16, 256)))
    with pytest.raises(ValueError):
        tm.finalize_sweep(u34, state, k2[:8], scene, a)
    with pytest.raises(NotImplementedError):
        tm.fused_round(torch.rand((tm.nu_rows(2), 256)), state, scene, a)


def test_k2_layout_matches_jax():
    """The K2 row map is the JAX package's, the medium rows and the medium
    feed's included."""
    for name in ("O_RAD", "O_AT_SURF", "O_ENV_CT", "O_SHADOW_CT", "O_FPDF",
                 "O_SAMPLE_OK", "O_RATIO", "O_ONEW", "O_DNEW", "O_PSCALE",
                 "O_NEE", "NU4"):
        assert getattr(tm, name) == getattr(jm, name), name
    for name in ("O_SCAT", "O_MEDW", "O_MSTK", "S_MSTK0", "S_MSTK1"):
        assert getattr(tm, name) == getattr(jm, name), name
    for ls in range(5):
        assert tm.k2_rows(ls) == jm._k2_rows(ls)
        for medium in (False, True):
            assert tm.n_u_rows(ls, medium) == jm._n_u_rows(ls, medium)
        for c in (1, 4):
            assert tm.ef_rows(ls, c) == jm._ef_rows(ls, c)
            assert tm.mf_rows(c) == jm._mf_rows(c)
            assert tm.mf_idx(c) == jm._mf_idx(c)
    assert np.isclose(tm.MEGA_MAX_PRIMS, jm.MEGA_MAX_PRIMS)
