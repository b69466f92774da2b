"""The port's plain LT round (K12-LT `lt_shade_plain`, K34-LT v2
`lt_finalize_spawn_plain` and v1 `lt_finalize_plain` after the torch spawn
feed; twins of csrc/lt_round.cu) against the JAX package's pallas_calls of
`_lt_shade_kernel`, `_lt_finalize_spawn_kernel` and `_lt_finalize_kernel`
(interpret mode, built as `_lt_round_v2` and `_lt_step` build them), over
three chained rounds on the uniforms the JAX rounds draw (LTReplay): the
chip scene with its lens proxy at 1 and 2 camera samples, stratified (v2),
and the HDR blob (v1). Each side chains on its own state from 2048 dead
lanes with 2 particles each. The JAX kernels run at a 1024-lane tile, which
changes the grid, not the lanes' arithmetic.

Tolerances (those of torch_ref_helpers.check_round; the near-delta glass,
α = 0.001, amplifies the ulps of XLA's FMA contraction into the sampled
pdf): discrete rows (pixel ids, flags, alive, bounce, budget, counters)
equal on >= 99.9% of lanes; continuous rows, on the lanes whose discrete
rows match, >= 99.5% within rtol 1e-4, atol 1e-5 and all within rtol 5e-3,
atol 1e-4; the sampled pdf and the state's pdf row all within rtol 2e-2,
atol 1e-5. Rows the JAX K12-LT computes but nothing reads are compared
where they are read: the continuation rows on lanes still walking, the
connection rays on lanes alive at the round's start that hit something
(JAX leaves NaN rays on lanes that hit nothing, which its K34 counts as
unblocked; the port writes zero-length rays, which its K34 counts the same
way).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch.kernels import lt_mega as tlt

from torch_ref_helpers import chained_lt

torch.set_num_threads(2)

CASES = {"chip_cs1": ("chip_lens", 1, True),
         "chip_cs2": ("chip_lens", 2, True),
         "hdri_v1": ("hdri", 1, False)}


@pytest.fixture(scope="module", params=sorted(CASES))
def rounds(request):
    recipe, cs, v2 = CASES[request.param]
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        yield cs, v2, chained_lt(recipe, dict(max_bounces=8, camera_samples=cs,
                                              stratified=True), v2)
    finally:
        jm.TILE, jm.SUB = tile, sub


def _few(bad, frac):
    return bad.sum() <= max(1, frac * bad.size)


def _cont(x, y, name, pdf=False):
    if pdf:  # check_round's S_PREV_PDF tolerance
        np.testing.assert_allclose(y, x, rtol=2e-2, atol=1e-5, err_msg=name)
        return
    ok = np.isclose(y, x, rtol=1e-4, atol=1e-5)
    assert _few(~ok, 5e-3), f"{name}: {ok.mean()} within 1e-4"
    np.testing.assert_allclose(y, x, rtol=5e-3, atol=1e-4, err_msg=name)


def check_q(jq, q, alive0, cs):
    walking = jq[tlt.Q_ALIVE] > 0.5
    rays = alive0 & np.isfinite(jq[tlt.Q_CONN:tlt.Q_CONN + 7]).all(axis=0)
    disc = tlt.discrete_rows(cs, True)[0]
    for row in disc:
        m = walking if row == tlt.Q_SOK else slice(None)
        assert _few(jq[row][m] != q[row][m], 1e-3), f"q row {row}"
    for row in range(tlt.Q_CONN + tlt.CONN_ROWS * cs):
        if row in disc:
            continue
        if tlt.Q_FPDF <= row < tlt.Q_CONN:
            m = walking
        elif row >= tlt.Q_CONN and (row - tlt.Q_CONN) % tlt.CONN_ROWS < 7:
            m = rays
        else:
            m = slice(None)
        _cont(jq[row][m], q[row][m], f"q row {row}", pdf=row == tlt.Q_FPDF)


def check_out(jo, o, cs, v2):
    aux = tlt.k4_aux_v2(cs) if v2 else tlt.k4_aux(cs)
    disc = tlt.discrete_rows(cs, v2)[1]
    match = (jo[disc] == o[disc]).all(axis=0)
    assert match.mean() >= 0.999, f"discrete rows match on {match.mean()}"
    for row in range(o.shape[0]):
        if row not in disc:
            _cont(jo[row][match], o[row][match], f"out row {row}",
                  pdf=row == tlt.LS_PREV)
    for key in ("resp", "bounce", "conn_ct"):
        assert abs(jo[aux[key]].sum() - o[aux[key]].sum()) <= 1e-3 * o.shape[1]


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_lt_shade_matches_jax(rounds, r):
    cs, _, rec = rounds
    x = rec[r]
    check_q(x["jq"], x["q"], x["tin"][tlt.LS_ALIVE] > 0.5, cs)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_lt_finalize_matches_jax(rounds, r):
    cs, v2, rec = rounds
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
    check_out(x["jout"], x["out"], cs, v2)


def test_rounds_do_work(rounds):
    """The rounds spawn, walk, connect to the lens and splat."""
    cs, v2, rec = rounds
    aux = tlt.k4_aux_v2(cs) if v2 else tlt.k4_aux(cs)
    assert rec[0]["out"][aux["resp"]].sum() == rec[0]["out"].shape[1]
    assert rec[1]["q"][tlt.Q_ALIVE].sum() > 0
    assert (rec[1]["q"][tlt.Q_CONN + 11] > 0).sum() > 0
    assert sum(x["out"][aux["conn_ct"]].sum() for x in rec) > 0


def test_layouts_match_jax():
    """The row maps of the port's LT round are the JAX package's."""
    from pathtracer_tpu.kernels import lt_mega as jlt

    for name in ("LS_O", "LS_D", "LS_LAM", "LS_BETA", "LS_PREV", "LS_ALIVE",
                 "LS_BOUNCE", "LS_BUDGET", "LS_ENV", "NS_LT", "Q_HIT_PID",
                 "Q_HIT_XYZ", "Q_ALIVE", "Q_FPDF", "Q_RATIO", "Q_SOK",
                 "Q_ONEW",
                 "Q_DNEW", "Q_CONN", "F_O", "F_D", "F_LAM", "F_BETA", "F_PREV",
                 "F_ALIVE", "F_ENV", "F_LV", "F_LV_VALID", "NF", "K4_CONN",
                 "NUSP", "_SP_CDFLO", "_SP_CDFHI", "_SP_INTEG", "_NSP_ROWS"):
        assert getattr(tlt, name) == getattr(jlt, name), name
    for cs in range(1, 5):
        assert tlt.q2_rows(cs) == jlt._q2_rows(cs)
        assert tlt.k4_rows(cs) == jlt._k4_rows(cs)
        assert tlt.k4_rows_v2(cs) == jlt._k4_rows_v2(cs)
        assert tlt.nu_lt(cs) == jlt._nu_lt(cs)
        assert tlt.k4_aux(cs) == jlt._k4_aux(cs)
        assert tlt.k4_aux_v2(cs) == jlt._k4_aux_v2(cs)
