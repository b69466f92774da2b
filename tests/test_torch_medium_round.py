"""The medium branch of the port's plain two-program round (`med_feed`,
K12 `shade_sweep_plain`, K34 `finalize_sweep_plain`) against the JAX
package's `_med_feed`, `_k12_call` and `_k34_call` (Pallas interpret mode,
1024-lane tile) under medium-aware settings, at 32x32, light samples 2:
`fog_cornell` (an HG fog with a sloped σ_s and a Rayleigh ball around the
light, overlapping; C = 1 and C = 4) and `nested_media` (two overlapping
absorbers). Both chain three rounds on their own state from the JAX initial
state with the uniform blocks the JAX calls draw (16 rows at light samples
2, four of them the medium's).

Tolerances, and why:
- the K2 rows (`check_k2`): on the lanes K34 reads them, which under
  medium-aware settings are the lanes at a surface or scattered, and every
  live lane for the medium rows 23-29. The scatter flag and the packed
  stack rows are discrete (equal on >= 99.9% of lanes); the lane weights
  and the rest hold test_torch_two_prog.py's rule (>= 99.5% within rtol
  1e-4, all within rtol 5e-3): `exp` and FMA contraction differ by an ulp
  between XLA's CPU backend and torch. One row is wider: the sampled pdf
  O_FPDF must be within rtol 5e-3 on >= 99.5% of lanes (and within 2e-2 on
  all, as before). The media sit behind near-index-matched boundaries (η
  1.03 against 1, α 0.001): the transmission half-vector -(η_i w_i + η_o
  w_o) nearly cancels and the GGX D ∝ 1/α² takes its cosine, so one ulp of
  a direction moves the pdf by up to 4e-3 (measured: median 4e-4 over the
  quarter of the lanes beyond 1e-4), while the throughput ratios, which
  divide the pdf out, stay within 1e-4;
- the state after K34 (`check_round`), the packed stack rows S_MSTK0/1
  among the discrete rows that must be equal;
- `med_feed` against `_med_feed` on the JAX state three rounds in: the
  scatterer's kind and the in-medium flag equal; every other row >= 99.9%
  of lanes within rtol 1e-5 (atol 1e-6) and all within rtol 1e-3 (atol
  1e-5), the environment feed's rule: the free flight is a `log`, the
  Rayleigh direction a cube root through `pow`.
"""

import numpy as np
import jax.numpy as jnp
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

CASES = [("fog_cornell", 4), ("fog_cornell", 1), ("nested_media", 1)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{r}-C{c}" for r, c in CASES])
def rounds(request):
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        recipe, c = request.param
        out = chained_two_prog(recipe, c, medium=True)
        # the feeds of both packages on the JAX state after the rounds
        s = out[-1]["setup"]
        state = jnp.asarray(out[-1]["state"])
        u = np.random.default_rng(9).random(
            (tm.n_u_rows(2, True), s.n_pad)).astype(np.float32)
        jmf = jm._med_feed(s.jscene.med_args, state, jnp.asarray(u), 2, c)
        mf = tm.med_feed(s.tscene.med, torch.as_tensor(np.array(state)),
                         torch.as_tensor(u), 2, c)
        yield dict(rounds=out, jmf=np.asarray(jmf), mf=mf.numpy(), c=c,
                   recipe=recipe)
    finally:
        jm.TILE, jm.SUB = tile, sub


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_medium_k12_matches_jax(rounds, r):
    x = rounds["rounds"][r]
    check_k2(x["jk2"], x["k2"], x["alive"], NEE_SETTINGS["light_samples"],
             fpdf_rtol=5e-3)


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_medium_k34_matches_jax(rounds, r):
    x = rounds["rounds"][r]
    check_round(x["state"], x["out"], x["counts"])
    for row in (tm.S_MSTK0, tm.S_MSTK1):
        match = x["state"][row] == x["out"][row]
        assert match.mean() >= 0.999, (row, match.mean())


def test_medium_rounds_do_work(rounds):
    """The rounds enter media (non-empty stacks) and, in the fog, scatter
    with lane weights that differ between the λ lanes."""
    rs = rounds["rounds"]
    assert any((x["out"][tm.S_MSTK0] > 0).any() for x in rs)
    assert all(np.isfinite(x["out"][:tm.NS]).all() for x in rs)
    if rounds["recipe"] == "fog_cornell":
        assert sum(x["k2"][tm.O_SCAT].sum() for x in rs) > 0
        # both media on one stack somewhere: a packed row over 256
        assert any((x["out"][tm.S_MSTK0] > 256).any() for x in rs)
        if rounds["c"] == 4:
            w = rs[-1]["k2"][tm.O_MEDW:tm.O_MEDW + 4]
            assert (np.abs(w[1] - w[0]) > 1e-3).any()
    else:
        assert not any(x["k2"][tm.O_SCAT].any() for x in rs)
        assert any(((x["k2"][tm.O_MEDW] < 1.0) & x["alive"]).any()
                   for x in rs)


def test_med_feed_matches_jax(rounds):
    jmf, mf, c = rounds["jmf"], rounds["mf"], rounds["c"]
    i = tm.mf_idx(c)
    assert mf.shape == jmf.shape == (tm.mf_rows(c), jmf.shape[1])
    for row in (i["isray"], i["inmed"]):
        np.testing.assert_array_equal(mf[row], jmf[row])
    assert mf[i["inmed"]].any()
    for row in range(i["n"]):
        ok = np.isclose(mf[row], jmf[row], rtol=1e-5, atol=1e-6)
        assert ok.mean() >= 0.999, f"row {row}: {ok.mean()}"
        np.testing.assert_allclose(mf[row], jmf[row], rtol=1e-3, atol=1e-5,
                                   err_msg=f"row {row}")
    assert not mf[i["n"]:].any()
