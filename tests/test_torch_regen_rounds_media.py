"""`pt_trace_regen` of the port against the JAX one, round by round, on
the JAX draws, as test_torch_regen_rounds.py holds it (the same check,
`torch_ref_helpers.regen_rounds_match_jax`, and its tolerances): on
`cornell_sharp` at C = 4 (near-delta GGX) and on `nested_media` at C = 4
under medium-aware settings (overlapping media: the depth-4 stack)."""

import pytest
import torch

from torch_ref_helpers import regen_rounds_match_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("recipe,medium", [("sharp", False),
                                           ("nested_media", True)])
def test_regen_rounds_match_jax_sharp_and_media(recipe, medium):
    regen_rounds_match_jax(recipe, True, medium)
