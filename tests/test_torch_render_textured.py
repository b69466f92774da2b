"""The texture-feed round and a textured render on the CPU, against the JAX
package: three chained rounds of the port's `texfeed_round` (K1 rows, the
texture feed, K2, K34; plain twins) against the JAX `_mega_step_texfeed`
(interpret mode) with the JAX uniform draws replayed (`JaxReplay`), a
replayed-uniform render of `textured_cornell` through `render_regen`
against `pt_trace_regen_mega`, the checker wall's tiles resolved in a port
render, the wrappers' CPU routes, and the card as the entry points' default.
The JAX kernels run at a 1024-lane tile (PT_MEGA_TILE).

Tolerances, and why:
- the chained rounds: check_round (test_torch_fused_round.py): the same
  uniforms drive both, and XLA's CPU backend contracts multiply-adds into
  FMAs where torch does not;
- the 48x48 @ 2 spp render: film mean within rtol 1e-2 and counters within
  rtol 1e-2: only the lanes whose RR or shadow decision flips on f32 op
  order diverge, and a lane that lands on the other side of a texel edge
  takes the other texel's reflectance for the rest of its path;
- the checker: the mean Y of the pixels that see the wall's odd tiles and
  of those that see its even tiles differ by more than 1.5x (the JAX
  package's tests/test_render_textured.py criterion).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.core import sampling
from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import camera_from_numpy
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.kernels import dense as tdense
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.world.world import world_from_numpy

from torch_ref_helpers import (
    NEE_SETTINGS,
    JaxReplay,
    both_settings,
    both_worlds,
    check_round,
    jax_settings_t,
)

torch.set_num_threads(2)

W = H = 48
SPP = 2


@pytest.fixture(scope="module")
def jax_tile():
    mp = pytest.MonkeyPatch()
    mp.setenv("PT_MEGA_TILE", "1024")
    mp.setattr(jm, "TILE", 1024)
    mp.setattr(jm, "SUB", 8)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def rounds(jax_tile):
    """Three texture-feed rounds of each package, each chained on its own
    state from the JAX initial state; the port's out carries the K2 counter
    rows, as check_round reads them."""
    jw, tw, jc, tc = both_worlds("textured")
    js, ts = both_settings(**NEE_SETTINGS)
    n = W * H
    n_pad = -(-n // tm.TILE) * tm.TILE
    jscene = jm.build_mega_scene(jw, jc, js)
    st_t = jax_settings_t(js, 1, W, H, n)
    ct_t = jm._freeze(jscene.consts)
    tabs = (jscene.prim_tab, jscene.dense_tab, jscene.mat_tab,
            jscene.light_tab, jscene.spec_tab, None, None, None)
    key = jax.random.PRNGKey(5)
    k_iter = sampling.fold(key, 2)
    state, counters = jm._mega_init(jc, key, st_t, n, n_pad,
                                    jnp.float32(SPP))
    scene = tm.build_mega_scene(tw, tc)
    a = tm.RoundArgs.make(scene.consts, ts, W, H)
    tstate = torch.as_tensor(np.array(state))
    replay = JaxReplay(key)
    it = jnp.int32(0)
    out_rounds = []
    for r in range(3):
        c0 = np.asarray(counters)
        state, counters, it = jm._mega_step_texfeed(
            state, counters, it, tabs, jscene.tex_args, k_iter, st_t, ct_t,
            True)
        out, k2 = tm.texfeed_round(tstate, scene, a, replay, r)
        tstate = out[:tm.NS]
        out = out.numpy().copy()
        out[tm.O4_SHADOW_CT] = k2[tm.O_SHADOW_CT].numpy()
        out[tm.O4_ENV_CT] = k2[tm.O_ENV_CT].numpy()
        out_rounds.append((np.asarray(state), out,
                           np.asarray(counters) - c0))
    return out_rounds


@pytest.mark.parametrize("r", [0, 1, 2], ids=["round1", "round2", "round3"])
def test_texfeed_round_matches_jax(rounds, r):
    check_round(*rounds[r])


def test_texfeed_rounds_do_work(rounds):
    """The rounds bounce, shadow-test, escape through the open front and
    respawn."""
    for row in (tm.O4_BOUNCE_CT, tm.O4_CAMERA_CT, tm.O4_SHADOW_CT,
                tm.O4_ENV_CT):
        assert sum(x[1][row].sum() for x in rounds) > 0, row


@pytest.fixture(scope="module")
def render(jax_tile):
    jw, tw, jc, tc = both_worlds("textured")
    js, ts = both_settings(**NEE_SETTINGS)
    key = jax.random.PRNGKey(5)
    acc, counters = jm.pt_trace_regen_mega(jw, jc, js, W, H, SPP, key,
                                           interpret=True)
    stats = {}
    film, profile, _ = render_regen(tw, tc, ts, W, H, SPP,
                                    uniforms=JaxReplay(key), stats=stats)
    return dict(ref=np.asarray(acc).reshape(H, W, 3) / SPP,
                ref_counters=np.asarray(counters), film=film.numpy(),
                profile=profile, stats=stats)


def test_textured_render_matches_jax(render):
    ref, film = render["ref"], render["film"]
    assert film.shape == (H, W, 3) and np.isfinite(film).all()
    assert film[..., 1].mean() > 0
    np.testing.assert_allclose(film.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-2)
    p = render["profile"]
    got = np.array([p.camera_rays, p.bounce_rays, p.shadow_rays,
                    p.light_rays, p.env_hits], np.float64)
    np.testing.assert_allclose(got, render["ref_counters"], rtol=1e-2)
    assert got[0] == W * H * SPP and render["stats"]["rounds"] > 0


def test_checker_tiles_resolve():
    """The checkered back wall is visibly non-uniform in a port render: the
    pixels whose centre ray meets the wall's odd tiles and those meeting its
    even tiles (away from tile edges) differ by more than 1.5x in Y."""
    _, tw, _, tc = both_worlds("textured")
    _, ts = both_settings(max_bounces=3, min_bounces=1, light_samples=1,
                          russian_roulette=False)
    film, _, _ = render_regen(tw, tc, ts, 64, 64, 8,
                              generator=torch.Generator().manual_seed(5))
    assert np.isfinite(film.numpy()).all()
    odd, even, n_sel = scenes.checker_tiles(film[..., 1], tc)
    hi, lo = max(odd, even), min(odd, even)
    assert n_sel > 200
    assert hi > lo * 1.5, f"checker not resolved: {hi:.4g} vs {lo:.4g}"


def test_wrappers_take_plain_twins_on_cpu():
    """On CPU tensors K1 and K2 run their twins and count no launch; a dead
    lane gets a miss from K1 and all-zero K2 rows."""
    _, tw, _, tc = both_worlds("textured")
    _, ts = both_settings(**NEE_SETTINGS)
    scene = tm.build_mega_scene(tw, tc)
    a = tm.RoundArgs.make(scene.consts, ts, 16, 16)
    gen = torch.Generator().manual_seed(0)
    state = torch.rand((tm.NS, 256), generator=gen)
    state[tm.S_ALIVE] = 0.0
    u12 = torch.rand((tm.n_u_rows(2), 256), generator=gen)
    launches = (tdense.ROWS_LAUNCHES, tm.K2_LAUNCHES, tm.SHADE_LAUNCHES)
    calls = (tdense.ROWS_PLAIN_CALLS, tm.PLAIN_CALLS)
    tp = tdense.sweep_closest_rows(state, scene.dense_tab, tm.S_O, tm.S_ALIVE)
    tf = tm.tex_feed(scene.tex, state, tp, 1)
    k2 = tm.shade(u12, state, tp, scene, a, tf=tf)
    assert (tdense.ROWS_LAUNCHES, tm.K2_LAUNCHES,
            tm.SHADE_LAUNCHES) == launches
    assert (tdense.ROWS_PLAIN_CALLS, tm.PLAIN_CALLS) == (calls[0] + 1,
                                                         calls[1] + 1)
    assert (tp[0] == np.inf).all() and (tp[1] == -1).all()
    assert not tp[2:].any() and not tf.any() and not k2.any()
    with pytest.raises(ValueError):
        tm.shade(u12, state, tp, scene, a)  # a textured scene needs tf
    with pytest.raises(ValueError):
        tm.shade(u12, state, tp[:2].contiguous(), scene, a, tf=tf)
    with pytest.raises(ValueError):
        tdense.sweep_closest_rows(state, scene.dense_tab, 30, tm.S_ALIVE)


def test_default_device_is_the_card():
    """Without a CUDA device the entry points' default raises instead of
    building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    b = scenes.textured_cornell(SceneBuilder(), spectral)
    fields = b.build_numpy()
    cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device="cpu")
    cam_fields = {k: v.numpy() for k, v in vars(cam).items()}
    for call in (lambda: scenes.cornell_box(SceneBuilder(), spectral).build(),
                 lambda: world_from_numpy(fields),
                 lambda: camera_from_numpy(cam_fields),
                 lambda: make_projective_camera(**scenes.TEXTURED_CAMERA)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
