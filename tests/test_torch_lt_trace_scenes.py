"""The port's light-tracing wavefront (`integrator/lt.py:lt_trace`) against
the JAX package's `lt_trace`, with the JAX draws replayed, on two scenes
the LT megakernel's route does not cover alike: the textured Cornell box
(multi-texel textures, outside the megakernel's gate) at two camera samples
and stratified, and the HDR blob (environment particles from the
importance map) at two camera samples
(`torch_ref_helpers.lt_trace_matches_jax`: film sums within rtol 1e-4,
pixels within rtol 1e-3 / atol 1e-5 on >= 99.9% of pixels, every counter
within 1e-6 relative)."""

import pytest
import torch

from torch_ref_helpers import lt_trace_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("recipe,cs,stratified", [("textured", 2, True),
                                                ("hdri", 2, False)])
def test_lt_trace_matches_jax(recipe, cs, stratified):
    lt_trace_matches_jax(recipe, cs, stratified)
