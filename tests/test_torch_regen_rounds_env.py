"""`pt_trace_regen` of the port against the JAX one, round by round, on
the JAX draws, as test_torch_regen_rounds.py holds it (the same check,
`torch_ref_helpers.regen_rounds_match_jax`, and its tolerances): on
`hdri_blob` at C = 1 (the HDR map's importance-sampled NEE and its
escape emission) and on `chip_lens` at C = 1 (the lens proxy, a
`mat_kind == 2` absorber that the NEE and bounce rays can hit).

`chip_lens` is held at C = 1: at C = 4 its discrete rows agree on every
lane, but 0.3-0.8% of the lanes carry beta and the spectral-MIS ratios
2e-4 to 4e-4 apart from the first bounce on, as the chip scene without the
lens does. Both hold the near-delta dispersive glass sphere (alpha 0.001),
whose pdf ratios at the companion wavelengths turn the ulps of XLA's
contracted f32 arithmetic into relative changes of that size (ROADMAP
§3)."""

import pytest
import torch

from torch_ref_helpers import regen_rounds_match_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("recipe,hwss", [("hdri", False),
                                         ("chip_lens", False)])
def test_regen_rounds_match_jax_env_and_lens(recipe, hwss):
    regen_rounds_match_jax(recipe, hwss, False)
