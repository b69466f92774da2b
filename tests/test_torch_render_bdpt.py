"""The port's BDPT renderer (`renderer/bdpt_renderer.py:render_bdpt`) and
`bdpt_trace` on an environment scene, against the JAX package, with the
JAX draws replayed (BDPTReplay):

- `bdpt_trace` at max_depth 3 on the HDR blob (the environment family: s =
  0 escapes and importance-sampled environment NEE) against the JAX batched
  body (`torch_ref_helpers.bdpt_trace_matches_jax`);
- `render_bdpt` at 16x16, 2 samples per pixel, max_depth 3 on the Cornell
  box against the JAX `render_bdpt` (its batched body, PT_BDPT_BATCHED set
  while its pass is first traced): the film within rtol 1e-3 / atol 1e-5 on
  >= 99.9% of pixels, the counters equal, and a film outside the camera the
  port has refused with the ROADMAP item that ports it."""

import numpy as np
import jax
import pytest
import torch

from pathtracer_tpu.integrator.bdpt import BDPTSettings as JaxBDPT
from pathtracer_tpu.renderer import bdpt_renderer as jbr
from pathtracer_tpu_torch.integrator.bdpt import BDPTSettings
from pathtracer_tpu_torch.renderer.bdpt_renderer import render_bdpt

from torch_ref_helpers import BDPTReplay, bdpt_trace_matches_jax, both_worlds

torch.set_num_threads(2)


def test_bdpt_trace_environment():
    own = bdpt_trace_matches_jax("hdri", 3)[0]
    assert own.sum() > 0


def test_render_bdpt_matches_jax(monkeypatch):
    jw, tw, jc, tc = both_worlds("cornell")
    key = jax.random.PRNGKey(21)
    monkeypatch.setenv("PT_BDPT_BATCHED", "1")
    jfilm, jprofile, _ = jbr.render_bdpt(jw, jc, JaxBDPT(max_depth=3), 16,
                                         16, 2, key=key)
    monkeypatch.delenv("PT_BDPT_BATCHED")
    stats = {}
    film, profile, _ = render_bdpt(tw, tc, BDPTSettings(max_depth=3), 16, 16,
                                   2, uniforms=BDPTReplay(key), stats=stats)
    jfilm, film = np.asarray(jfilm), film.numpy()
    assert stats["passes"] == 2 and film.shape == (16, 16, 3)
    assert np.isfinite(film).all() and film[..., 1].mean() > 0
    close = np.isclose(film, jfilm, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.999, np.where(~close)
    for f in ("camera_rays", "bounce_rays", "shadow_rays", "light_rays"):
        assert getattr(profile, f) == getattr(jprofile, f), f
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 10"):
        render_bdpt(tw, object(), BDPTSettings(max_depth=3), 8, 8, 1)
