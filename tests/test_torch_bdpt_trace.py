"""The port's `bdpt_trace` (`integrator/bdpt.py`) against the JAX
package's batched body, with the JAX draws replayed
(`torch_ref_helpers.bdpt_trace_matches_jax`: own-pixel and splat energies
within rtol 1e-4 on >= 99.9% of lanes, the lit splats' film uv, λ and every
counter): at max_depth 5 on the Cornell box (where the JAX package takes the
batched body unasked), and for one t = 1 strategy alone (the selected pair
(2, 1) at max_depth 3), whose splats must carry the whole film's
light-subpath splats of that strategy."""

import torch

from torch_ref_helpers import bdpt_trace_matches_jax

torch.set_num_threads(2)


def test_bdpt_trace_max_depth_5():
    own, _, splat_e = bdpt_trace_matches_jax("cornell", 5)[:3]
    assert own.sum() > 0 and splat_e.sum() > 0


def test_bdpt_trace_selected_pair():
    own, splat_uv, splat_e = bdpt_trace_matches_jax(
        "cornell", 3, selected_pair=(2, 1))[:3]
    assert own.sum() == 0 and splat_e.sum() > 0
    assert splat_uv.shape == (256, 2)
