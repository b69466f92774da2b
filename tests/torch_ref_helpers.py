"""Shared set-up of the port-versus-reference tests (test_torch_*.py): the
same scene recipe built by both packages' builders, and a uniform source
that replays the JAX megakernel's own draws into the port's render loop."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from pathtracer_tpu.camera import make_projective_camera as jax_camera
from pathtracer_tpu.core import sampling
from pathtracer_tpu.core import spectral as jax_spectral
from pathtracer_tpu.integrator.pt import PTSettings as JaxSettings
from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu.parsing.builder import SceneBuilder as JaxBuilder
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera as torch_camera
from pathtracer_tpu_torch.core import spectral as torch_spectral
from pathtracer_tpu_torch.integrator.pt import PTSettings as TorchSettings
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.parsing import SceneBuilder as TorchBuilder

RECIPES = {
    "chip": (scenes.chip_scene, scenes.CORNELL_CAMERA),
    "cornell": (scenes.cornell_box, scenes.CORNELL_CAMERA),
    "sharp": (scenes.cornell_sharp, scenes.CORNELL_CAMERA),
    "furnace": (scenes.dispersive_furnace, scenes.FURNACE_CAMERA),
}
# the headline render's estimator settings, and the HWSS furnace's
NEE_SETTINGS = dict(max_bounces=12, min_bounces=1, light_samples=2,
                    russian_roulette=True)
FURNACE_SETTINGS = dict(max_bounces=24, min_bounces=4, light_samples=0,
                        russian_roulette=False)


def both_worlds(recipe):
    """(jax World, port World, jax camera, port camera) of one recipe."""
    fn, cam = RECIPES[recipe]
    return (fn(JaxBuilder(), jax_spectral).build(),
            fn(TorchBuilder(), torch_spectral).build(),
            jax_camera(**cam), torch_camera(**cam))


def both_settings(**kw):
    return JaxSettings(**kw), TorchSettings(**kw)


def jax_world_fields(world, names):
    """The JAX World's leaves as numpy arrays under their field names."""
    out = {}
    for name in names:
        obj = world
        for part in name.split("."):
            obj = getattr(obj, part)
        out[name] = obj if isinstance(obj, float) else np.asarray(obj)
    return out


def jax_settings_t(settings, c_lanes, width, height, n):
    """The frozen settings tuple that pt_trace_regen_mega hands _step_fused."""
    wb = settings.wavelength_bounds
    return jm._freeze(dict(
        c_lanes=c_lanes, tile=jm.TILE, light_samples=settings.light_samples,
        lane_mod=float(n), max_bounces=float(settings.max_bounces),
        min_bounces=float(settings.min_bounces),
        russian_roulette=bool(settings.russian_roulette),
        only_direct=bool(settings.only_direct), width=float(width),
        height=float(height), start=0.0, wb_lo=float(wb.lower),
        wb_span=float(wb.span)))


class JaxReplay:
    """Uniform source for the port's render loop that yields exactly the blocks
    pt_trace_regen_mega(key) draws: rnd0 from fold(key, 1), and round `it`
    from fold_in(fold(key, 2), it)."""

    def __init__(self, key):
        self.key = key
        self.k_iter = sampling.fold(key, 2)

    def init(self, n_pad, device):
        u = jax.random.uniform(sampling.fold(self.key, 1), (n_pad, 5))
        return torch.as_tensor(np.array(u), device=device)

    def round(self, it, rows, n_pad, device):
        u = jax.random.uniform(jax.random.fold_in(self.k_iter, jnp.int32(it)),
                               (rows, n_pad))
        return torch.as_tensor(np.array(u), device=device)


def chained_rounds(recipe, c_lanes, rounds=3, width=64, spp=4):
    """`rounds` bounce rounds of the JAX fused round (_step_fused,
    interpret mode) and of the port's plain fused_round_plain, each chained
    on its own state, from the JAX initial state with the same uniform
    blocks (drawn as _step_fused draws them). Returns per round
    (jax state [NS, n_pad], port out [NK4, n_pad], jax counter delta [5])."""
    jw, tw, jc, tc = both_worlds(recipe)
    kw = FURNACE_SETTINGS if recipe == "furnace" else NEE_SETTINGS
    js, ts = both_settings(**kw, hwss=c_lanes == 4)
    n = width * width
    n_pad = -(-n // tm.TILE) * tm.TILE
    jscene = jm.build_mega_scene(jw, jc, js)
    st_t = jax_settings_t(js, c_lanes, width, width, n)
    ct_t = jm._freeze(jscene.consts)
    tabs = (jscene.prim_tab, jscene.dense_tab, jscene.mat_tab,
            jscene.light_tab, jscene.spec_tab, None, None, None)
    key = jax.random.PRNGKey(3)
    k_iter = sampling.fold(key, 2)
    state, counters = jm._mega_init(jc, key, st_t, n, n_pad,
                                    jnp.float32(spp))
    tscene = tm.build_mega_scene(tw, tc)
    a = tm.RoundArgs.make(tscene.consts, ts, width, width)
    tstate = torch.as_tensor(np.array(state))
    it = jnp.int32(0)
    out_rounds = []
    for _ in range(rounds):
        u = jax.random.uniform(jax.random.fold_in(k_iter, it),
                               (tm.nu_rows(a.light_samples), n_pad))
        c0 = np.asarray(counters)
        state, counters, it = jm._step_fused(state, counters, it, tabs,
                                             k_iter, st_t, ct_t, True)
        out = tm.fused_round(torch.as_tensor(np.array(u)), tstate, tscene, a)
        tstate = out[:tm.NS]
        out_rounds.append((np.asarray(state), out.numpy(),
                           np.asarray(counters) - c0))
    return out_rounds


# the fused round's discrete state rows and counter rows (see
# test_torch_fused_round.py for the tolerances check_round applies)
DISCRETE = (tm.S_ALIVE, tm.S_BOUNCE, tm.S_DONE)
CT_ROWS = {tm.O4_BOUNCE_CT: 1, tm.O4_CAMERA_CT: 0, tm.O4_SHADOW_CT: 2,
           tm.O4_ENV_CT: 4}  # out row -> counter slot


def check_round(ref_state, out, ref_counts):
    n = out.shape[1]
    match = (ref_state[list(DISCRETE)] == out[list(DISCRETE)]).all(axis=0)
    assert match.mean() >= 0.999, f"discrete rows match on {match.mean()}"
    for row, slot in CT_ROWS.items():
        assert abs(out[row].sum() - ref_counts[slot]) <= 1e-3 * n, row
    for row in range(tm.NS):
        if row in DISCRETE:
            continue
        x, y = ref_state[row][match], out[row][match]
        if row == tm.S_PREV_PDF:
            np.testing.assert_allclose(y, x, rtol=2e-2, atol=1e-5,
                                       err_msg=f"row {row}")
            continue
        ok = np.isclose(y, x, rtol=1e-4, atol=1e-5)
        assert ok.mean() >= 0.995, f"row {row}: {ok.mean()} within 1e-4"
        np.testing.assert_allclose(y, x, rtol=5e-3, atol=1e-4,
                                   err_msg=f"row {row}")
