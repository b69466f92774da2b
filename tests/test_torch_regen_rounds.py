"""`pt_trace_regen` of the port against the JAX one, round by round, on
the JAX draws (`torch_ref_helpers.RegenReplay`): three rounds at 32x32,
each package chained on its own state from the same first spawn, on the
Cornell box at C = 1 and at C = 4 (HWSS) and on `fog_cornell` under
medium-aware settings.

Tolerances, fixed before the runs: the discrete rows (alive, done, bounce
count, medium stack) equal on >= 99.9% of lanes; on those lanes every
continuous row within rtol 1e-4, atol 1e-5 on >= 99.9% of them and within
rtol 5e-3, atol 1e-4 on all; the sampled pdf (prev_pdf) within rtol 2e-2,
as a near-delta GGX lobe's pdf of ~1e8 moves by 1e-3 with the ulps of its
half vector (XLA orders and contracts the f32 operations differently,
ROADMAP §3). These are the megakernel round tests' bounds for a grazing
re-hit (tests/torch_ref_helpers.check_round).
"""

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.pt_regen import pt_trace_regen as j_regen
from pathtracer_tpu_torch.integrator.pt_regen import pt_trace_regen as t_regen

from torch_ref_helpers import (
    NEE_SETTINGS,
    RegenReplay,
    both_settings,
    both_worlds,
    regen_state_to_jax,
    regen_state_to_torch,
)

torch.set_num_threads(2)

W = 32
SPP = 4
DISCRETE = ("alive", "done", "bounce_ct", "med_stack")


def _lane_rows(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.reshape(x.shape[0], -1)


def _check_state(ref, got):
    assert ref.rnd_i == got.rnd_i
    match = np.ones(W * W, bool)
    for f in DISCRETE:
        match &= (_lane_rows(getattr(ref, f))
                  == _lane_rows(getattr(got, f))).all(axis=1)
    assert match.mean() >= 0.999, f"discrete rows agree on {match.mean()}"
    for f in ("o", "d", "lam", "beta", "path_rad", "acc", "prev_pdf",
              "pdfr"):
        x = _lane_rows(getattr(ref, f))[match]
        y = _lane_rows(getattr(got, f))[match]
        if f == "prev_pdf":
            np.testing.assert_allclose(y, x, rtol=2e-2, atol=1e-5,
                                       err_msg=f)
            continue
        ok = np.isclose(y, x, rtol=1e-4, atol=1e-5).all(axis=1)
        assert ok.mean() >= 0.999, f"{f}: {ok.mean()} of lanes within 1e-4"
        np.testing.assert_allclose(y, x, rtol=5e-3, atol=1e-4, err_msg=f)
    np.testing.assert_allclose(got.counters.numpy(), ref.counters.numpy(),
                               rtol=0, atol=1e-3 * W * W)


@pytest.mark.parametrize("recipe,hwss,medium", [
    ("cornell", False, False), ("cornell", True, False),
    ("fog_cornell", False, True)])
def test_regen_rounds_match_jax(recipe, hwss, medium):
    """Three rounds of the port's pt_trace_regen against the JAX one on the
    JAX draws, each chained on its own state from the same first spawn."""
    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_settings(**NEE_SETTINGS, hwss=hwss, medium_aware=medium)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def j_round(world, cam, st):
        return j_regen(world, cam, js, W, W, SPP, key, init_state=st,
                       max_rounds=1, return_state=True)

    uni = RegenReplay(key)
    jst = j_regen(jw, jc, js, W, W, SPP, key, max_rounds=0, return_state=True)
    tst = t_regen(tw, tc, ts, W, W, SPP, uni, max_rounds=0, return_state=True)
    _check_state(regen_state_to_torch(jst), tst)
    back = regen_state_to_torch(regen_state_to_jax(tst))
    for f, x in zip(back._fields, back):
        assert f == "rnd_i" and x == tst.rnd_i or torch.equal(
            x, getattr(tst, f)), f
    for _ in range(3):
        jst = j_round(jw, jc, jst)
        tst = t_regen(tw, tc, ts, W, W, SPP, uni, init_state=tst,
                      max_rounds=1, return_state=True)
        _check_state(regen_state_to_torch(jst), tst)
    assert tst.alive.any() and tst.counters[2] > 0
