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
re-hit (tests/torch_ref_helpers.check_round). The shadow queries sweep
only the lanes whose light sample was worth a ray, where the JAX body
sweeps all; `blocked` is read only there. The check is
`torch_ref_helpers.regen_rounds_match_jax`, which
test_torch_regen_rounds_env.py and test_torch_regen_rounds_media.py run on
four more recipes.
"""

import pytest
import torch

from torch_ref_helpers import regen_rounds_match_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("recipe,hwss,medium", [
    ("cornell", False, False), ("cornell", True, False),
    ("fog_cornell", False, True)])
def test_regen_rounds_match_jax(recipe, hwss, medium):
    """Three rounds of the port's pt_trace_regen against the JAX one on the
    JAX draws, each chained on its own state from the same first spawn."""
    regen_rounds_match_jax(recipe, hwss, medium)
