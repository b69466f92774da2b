"""Shared set-up of the port-versus-reference tests (test_torch_*.py): the
same scene recipe built by both packages' builders, and a uniform source
that replays the JAX megakernel's own draws into the port's render loop.

The JAX `SceneBuilder` sets only constant environments (its parser builds
Sun and HDR environments from TOML), so `JaxBuilder` adds the two setters
the recipes call, by the steps of `parsing/construct.py:_build_environment`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from pathtracer_tpu.camera import make_projective_camera as jax_camera
from pathtracer_tpu.core import sampling
from pathtracer_tpu.core import spectral as jax_spectral
from pathtracer_tpu.integrator.pt import PTSettings as JaxSettings
from pathtracer_tpu.kernels import dense as jdense
from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu.parsing.builder import SceneBuilder as _JaxSceneBuilder
from pathtracer_tpu.world import importance_map as jax_imp
from pathtracer_tpu.world.environment import (
    ENV_HDR,
    ENV_SUN,
    Environment as JaxEnvironment,
)
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera as torch_camera
from pathtracer_tpu_torch.core import spectral as torch_spectral
from pathtracer_tpu_torch.integrator.pt import PTSettings as TorchSettings
from pathtracer_tpu_torch.kernels import dense as tdense
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.parsing import SceneBuilder as TorchBuilder



class JaxBuilder(_JaxSceneBuilder):
    """The JAX SceneBuilder with the parser's Sun and HDRI environments."""

    def set_environment_sun(self, curve_idx, strength, sun_direction,
                            angular_diameter):
        sd = np.asarray(sun_direction, np.float64)
        sd = sd / np.linalg.norm(sd)
        self.env = JaxEnvironment.constant(curve_idx, strength)._replace(
            kind=jnp.int32(ENV_SUN),
            sun_direction=jnp.asarray(sd, jnp.float32),
            sun_cos_angle=jnp.float32(np.cos(angular_diameter / 2.0)))

    def set_environment_hdr(self, tex_id, strength, imp_w, imp_h,
                            rotation=None):
        rot = np.eye(3) if rotation is None else np.asarray(rotation)
        fields = dict(kind=jnp.int32(ENV_HDR), tex_id=jnp.int32(tex_id),
                      rotation=jnp.asarray(np.linalg.inv(rot), jnp.float32),
                      rotation_inv=jnp.asarray(rot, jnp.float32))
        if imp_w and imp_h:
            start, count = self.tex_ranges[tex_id]
            marginal, row, pdf = jax_imp.bake_importance_tables(
                self.tex_layers[start:start + count], self.curves,
                int(imp_w), int(imp_h))
            fields.update(imp_marginal_cdf=jnp.asarray(marginal),
                          imp_row_cdf=jnp.asarray(row),
                          imp_pdf=jnp.asarray(pdf),
                          imp_baked=jnp.bool_(True))
        self.env = JaxEnvironment.constant(0, strength)._replace(**fields)


RECIPES = {
    "chip": (scenes.chip_scene, scenes.CORNELL_CAMERA),
    "cornell": (scenes.cornell_box, scenes.CORNELL_CAMERA),
    "sharp": (scenes.cornell_sharp, scenes.CORNELL_CAMERA),
    "furnace": (scenes.dispersive_furnace, scenes.FURNACE_CAMERA),
    "gem": (scenes.gem_cornell, scenes.CORNELL_CAMERA),
    "mesh": (scenes.mesh_cornell, scenes.CORNELL_CAMERA),
    "hdri": (scenes.hdri_blob, scenes.SPHERE_CAMERA),
    "hdr_furnace": (scenes.hdr_furnace, scenes.SPHERE_CAMERA),
    "sun": (scenes.sun_sphere, scenes.SPHERE_CAMERA),
    "textured": (scenes.textured_cornell, scenes.TEXTURED_CAMERA),
    "textured_sun": (scenes.textured_sun, scenes.SPHERE_CAMERA),
    "textured_fog": (scenes.textured_fog, scenes.TEXTURED_CAMERA),
    "chip_lens": (scenes.chip_lens, scenes.CHIP_LENS_CAMERA),
    "spike_box": (scenes.spike_box, scenes.SPIKE_CAMERA),
    "absorbing_sphere": (scenes.absorbing_sphere, scenes.MEDIUM_CAMERA),
    "scattering_furnace": (scenes.scattering_furnace, scenes.MEDIUM_CAMERA),
    "nested_media": (scenes.nested_media, scenes.MEDIUM_CAMERA),
    "fog_cornell": (scenes.fog_cornell, scenes.CORNELL_CAMERA),
    "cornell_hex": (scenes.cornell_box, scenes.HEX_CAMERA),
    "light_grid": (scenes.light_grid_cornell, scenes.CORNELL_CAMERA),
    "light_grid4": (lambda b, sp: scenes.light_grid_cornell(b, sp, n=4),
                    scenes.CORNELL_CAMERA),
    "lens_box": (scenes.lens_box, scenes.LENS_BOX_CAMERA),
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
            fn(TorchBuilder(), torch_spectral).build(device="cpu"),
            jax_camera(**cam), torch_camera(**cam, device="cpu"))


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
    pt_trace_regen_mega(key) draws: rnd0 from fold(key, 1); round `it` of the
    fused round from fold_in(fold(key, 2), it), and stream s of the
    two-program round from fold_in(fold_in(fold(key, 2), it), s)."""

    def __init__(self, key):
        self.key = key
        self.k_iter = sampling.fold(key, 2)

    def init(self, n_pad, device):
        u = jax.random.uniform(sampling.fold(self.key, 1), (n_pad, 5))
        return torch.as_tensor(np.array(u), device=device)

    def round(self, it, rows, n_pad, device, stream=None):
        k = jax.random.fold_in(self.k_iter, jnp.int32(it))
        if stream is not None:
            k = jax.random.fold_in(k, stream)
        u = jax.random.uniform(k, (rows, n_pad))
        return torch.as_tensor(np.array(u), device=device)


def chained_rounds(recipe, c_lanes, rounds=3, width=64, spp=4,
                   light_samples=None):
    """`rounds` bounce rounds of the JAX fused round (_step_fused,
    interpret mode) and of the port's plain fused_round_plain, each chained
    on its own state, from the JAX initial state with the same uniform
    blocks (drawn as _step_fused draws them). `light_samples` replaces the
    recipe's NEE sample count. Returns per round (jax state [NS, n_pad],
    port out [NK4, n_pad], jax counter delta [5])."""
    jw, tw, jc, tc = both_worlds(recipe)
    kw = dict(FURNACE_SETTINGS if recipe == "furnace" else NEE_SETTINGS)
    if light_samples is not None:
        kw["light_samples"] = light_samples
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


def two_prog_setup(recipe, c_lanes, width, spp, medium=False,
                   settings=NEE_SETTINGS):
    """Both packages' baked scenes and round arguments of one recipe, and
    the JAX initial state: a namespace with the JAX scene, tables tuple,
    frozen settings and consts, key, k_iter, state and counters, and the
    port's scene, RoundArgs and settings."""
    from types import SimpleNamespace

    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_settings(**settings, hwss=c_lanes == 4,
                           medium_aware=medium)
    n = width * width
    n_pad = -(-n // tm.TILE) * tm.TILE
    jscene = jm.build_mega_scene(jw, jc, js)
    st_t = jax_settings_t(js, c_lanes, width, width, n)
    key = jax.random.PRNGKey(3)
    state, counters = jm._mega_init(jc, key, st_t, n, n_pad,
                                    jnp.float32(spp))
    tscene = tm.build_mega_scene(tw, tc, settings=ts)
    return SimpleNamespace(
        jscene=jscene, st_t=st_t, ct_t=jm._freeze(jscene.consts),
        tabs=(jscene.prim_tab, jscene.dense_tab, jscene.mat_tab,
              jscene.light_tab, jscene.spec_tab, jscene.env_args,
              jscene.med_args, None),
        key=key, k_iter=sampling.fold(key, 2), state=state,
        counters=counters, n_pad=n_pad, tscene=tscene, ts=ts,
        a=tm.RoundArgs.make(tscene.consts, ts, width, width))


def chained_two_prog(recipe, c_lanes, rounds=3, width=32, spp=4,
                     medium=False, settings=NEE_SETTINGS):
    """`rounds` rounds of the JAX two-program round (_k12_call + _k34_call,
    interpret mode) and of the port's plain shade_sweep + finalize_sweep
    (after env_feed for Sun and HDR environments and med_feed for
    medium-aware settings), each chained on its own state from the JAX
    initial state, with the uniform blocks the JAX calls draw, under the
    estimator `settings` (keywords of both packages' PTSettings). Returns per
    round a dict: jax/port k2 rows, the alive mask going in, jax state, port
    out (with the K2 counter rows at O4_SHADOW_CT and O4_ENV_CT, as
    check_round reads them) and the jax counter delta."""
    s = two_prog_setup(recipe, c_lanes, width, spp, medium, settings)
    jscene, st_t, ct_t, tabs, k_iter = (s.jscene, s.st_t, s.ct_t, s.tabs,
                                        s.k_iter)
    state, counters, n_pad, tscene, a = (s.state, s.counters, s.n_pad,
                                         s.tscene, s.a)
    tstate = torch.as_tensor(np.array(state))
    it = jnp.int32(0)
    out_rounds = []
    for _ in range(rounds):
        ku = jax.random.fold_in(k_iter, it)
        u12 = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(ku, 0),
            (tm.n_u_rows(a.light_samples, a.medium), n_pad))))
        u34 = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(ku, 1), (tm.NU4, n_pad))))
        c0 = np.asarray(counters)
        jk2 = jm._k12_call(state, tabs, k_iter, it, st_t, ct_t, True)
        alive = np.asarray(state)[tm.S_ALIVE] > 0.5
        state, counters, it = jm._k34_call(state, jk2, jscene.dense_tab,
                                           counters, k_iter, it, st_t, ct_t,
                                           True)
        ef = (tm.env_feed(tscene.env, tstate, u12, a.light_samples, c_lanes)
              if tscene.env is not None else None)
        mf = (tm.med_feed(tscene.med, tstate, u12, a.light_samples, c_lanes)
              if tscene.med is not None else None)
        k2 = tm.shade_sweep(u12, tstate, tscene, a, ef, mf)
        out = tm.finalize_sweep(u34, tstate, k2, tscene, a)
        tstate = out[:tm.NS]
        out = out.numpy().copy()
        out[tm.O4_SHADOW_CT] = k2[tm.O_SHADOW_CT].numpy()
        out[tm.O4_ENV_CT] = k2[tm.O_ENV_CT].numpy()
        out_rounds.append(dict(jk2=np.asarray(jk2), k2=k2.numpy(),
                               alive=alive, state=np.asarray(state),
                               out=out, counts=np.asarray(counters) - c0,
                               setup=s))
    return out_rounds


def chained_split(recipe, c_lanes, rounds=2, width=32, spp=4, medium=False):
    """`rounds` split rounds of the JAX package (K1 `sweep_closest_rows`,
    `_k2_call`, K3 `sweep_any_rows` per NEE sample, `_k4_call`; interpret
    mode), chained on the JAX state, and on each round's JAX inputs the
    port's K3 twin (on the JAX K2 rows) and K4 twin (on the JAX state, K2
    rows and blocked blocks, with the uniform block `_k4_call` draws).
    Returns per round a dict: the JAX K2 rows, the jax/port blocked masks
    per NEE sample, the JAX state after the round, the port's K4 out (with
    the K2 counter rows, as check_round reads them) and the jax counter
    delta."""
    s = two_prog_setup(recipe, c_lanes, width, spp, medium)
    state, counters, a = s.state, s.counters, s.a
    nk2 = tm.k2_rows(a.light_samples)
    it = jnp.int32(0)
    out_rounds = []
    for _ in range(rounds):
        u34 = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(s.k_iter, it), 1),
            (tm.NU4, s.n_pad))))
        jtp = jax_rows_sweep(state, s.jscene.dense_tab, s.jscene.consts)
        jk2 = jm._k2_call(state, jtp, s.tabs, s.k_iter, it, s.st_t, s.ct_t,
                          True)
        jblks = [jdense.sweep_any_rows(
            jk2, s.jscene.dense_tab, row0=jm.O_NEE + 12 * si,
            tmin_c=jm.INTERSECTION_TIME_OFFSET,
            tmax_row=jm.O_NEE + 12 * si + 6, src_rows=nk2, interpret=True)
            for si in range(a.light_samples)]
        tin = torch.as_tensor(np.array(state))
        tk2 = torch.as_tensor(np.array(jk2))
        c0 = np.asarray(counters)
        state, counters, it = jm._k4_call(state, jk2, jblks, counters,
                                          s.k_iter, it, s.st_t, s.ct_t, True)
        blks = [tdense.sweep_any_rows(
            tk2, s.tscene.dense_tab, tm.O_NEE + tm.NEE_ROWS * si,
            tm.O_NEE + tm.NEE_ROWS * si + 6,
            live_row=tm.O_NEE + tm.NEE_ROWS * si + 7)
            for si in range(a.light_samples)]
        out = tm.finalize(u34, tin, tk2, [torch.as_tensor(np.array(b))
                                          for b in jblks], s.tscene, a)
        out = out.numpy().copy()
        out[tm.O4_SHADOW_CT] = tk2[tm.O_SHADOW_CT].numpy()
        out[tm.O4_ENV_CT] = tk2[tm.O_ENV_CT].numpy()
        out_rounds.append(dict(
            jk2=np.asarray(jk2), jblks=[np.asarray(b) for b in jblks],
            blks=[b.numpy() for b in blks], state=np.asarray(state),
            out=out, counts=np.asarray(counters) - c0))
    return out_rounds


def jax_rows_sweep(state, dense_tab, consts):
    """The JAX K1 rows sweep of the state's rays (interpret mode), as
    _mega_step_texfeed calls it."""
    return jdense.sweep_closest_rows(
        state, dense_tab, row0=jm.S_O, tmin_c=jm.INTERSECTION_TIME_OFFSET,
        tmax_c=jm.RAY_TMAX, src_rows=8, interpret=True,
        chunk_types=consts.get("ct8"))


def chained_texfeed(recipe, c_lanes, rounds=2, width=32, spp=4,
                    medium=False):
    """`rounds` texture-feed rounds of the JAX package (K1
    `sweep_closest_rows`, `_tex_feed`, `_k2_call`, `_k34_call`; interpret
    mode) and of the port's plain twins (`sweep_closest_rows`, `tex_feed`,
    `shade`, `finalize_sweep`, after `env_feed` for a Sun environment and
    `med_feed` under medium-aware settings), each chained on its own state
    from the JAX initial state, with the uniform blocks the JAX calls draw.
    Returns per round a dict: the jax state going in (jin) and its K12
    uniform block (u12), jax/port hit rows (tp), texture-feed rows (tf) and
    K2 rows, the alive mask going in, the jax state, the port out (with the
    K2 counter rows, as check_round reads them) and the jax counter delta,
    and the port scene and round args."""
    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_settings(**NEE_SETTINGS, hwss=c_lanes == 4,
                           medium_aware=medium)
    n = width * width
    n_pad = -(-n // tm.TILE) * tm.TILE
    jscene = jm.build_mega_scene(jw, jc, js)
    st_t = jax_settings_t(js, c_lanes, width, width, n)
    ct_t = jm._freeze(jscene.consts)
    tabs = (jscene.prim_tab, jscene.dense_tab, jscene.mat_tab,
            jscene.light_tab, jscene.spec_tab, jscene.env_args,
            jscene.med_args, None)
    key = jax.random.PRNGKey(3)
    k_iter = sampling.fold(key, 2)
    state, counters = jm._mega_init(jc, key, st_t, n, n_pad,
                                    jnp.float32(spp))
    tscene = tm.build_mega_scene(tw, tc, settings=ts)
    a = tm.RoundArgs.make(tscene.consts, ts, width, width)
    tstate = torch.as_tensor(np.array(state))
    replay = JaxReplay(key)
    it = jnp.int32(0)
    out_rounds = []
    for r in range(rounds):
        jin = np.array(state)
        jtp = jax_rows_sweep(state, jscene.dense_tab, jscene.consts)
        jtf = jm._tex_feed(jscene.tex_args, state, jtp, c_lanes)
        jk2 = jm._k2_call(state, jtp, tabs, k_iter, it, st_t, ct_t, True,
                          tf=jtf)
        alive = np.asarray(state)[tm.S_ALIVE] > 0.5
        c0 = np.asarray(counters)
        state, counters, it = jm._k34_call(state, jk2, jscene.dense_tab,
                                           counters, k_iter, it, st_t, ct_t,
                                           True)
        tp = tdense.sweep_closest_rows(tstate, tscene.dense_tab, tm.S_O,
                                       tm.S_ALIVE)
        u12 = replay.round(r, tm.n_u_rows(a.light_samples, a.medium), n_pad,
                           "cpu", 0)
        ef = (tm.env_feed(tscene.env, tstate, u12, a.light_samples, c_lanes)
              if tscene.env is not None else None)
        mf = (tm.med_feed(tscene.med, tstate, u12, a.light_samples, c_lanes)
              if tscene.med is not None else None)
        tf = tm.tex_feed(tscene.tex, tstate, tp, c_lanes)
        k2 = tm.shade(u12, tstate, tp, tscene, a, ef, tf, mf)
        out = tm.finalize_sweep(replay.round(r, tm.NU4, n_pad, "cpu", 1),
                                tstate, k2, tscene, a)
        tstate = out[:tm.NS]
        out = out.numpy().copy()
        out[tm.O4_SHADOW_CT] = k2[tm.O_SHADOW_CT].numpy()
        out[tm.O4_ENV_CT] = k2[tm.O_ENV_CT].numpy()
        out_rounds.append(dict(
            recipe=recipe, jin=jin, u12=u12, scene=tscene, a=a,
            jtp=np.array(jtp), tp=tp.numpy(), jtf=np.array(jtf),
            tf=tf.numpy(), jk2=np.asarray(jk2), k2=k2.numpy(), alive=alive,
            state=np.asarray(state), out=out,
            counts=np.asarray(counters) - c0))
    return out_rounds


# the fused round's discrete state rows and counter rows (see
# test_torch_fused_round.py for the tolerances check_round applies)
DISCRETE = (tm.S_ALIVE, tm.S_BOUNCE, tm.S_DONE, tm.S_MSTK0, tm.S_MSTK1)
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


def check_k2(jk2, k2, alive, light_samples, fpdf_rtol=1e-4):
    """K2 rows of the port's K12 against the JAX K12 on the lanes where K34
    reads them (see test_torch_two_prog.py for the tolerances). The lane
    fractions allow one lane where few lanes are at a surface: a bounce
    ray that grazes the surface it left re-hits it at an ill-conditioned t.
    `fpdf_rtol` is the tolerance most lanes' sampled pdf (O_FPDF) must meet;
    the medium scenes' near-index-matched boundaries widen it (see
    test_torch_medium_round.py)."""
    def few(bad, frac):
        return bad.sum() <= max(1, frac * bad.size)

    # the lanes K34 reads the sample rows on: at a surface or scattered in a
    # medium; the medium rows (the scatter flag, the lane weights and the
    # stack) it reads on every live lane. Outside medium-aware settings
    # both packages write the medium rows as zeros.
    surf = (jk2[tm.O_AT_SURF] > 0.5) | (jk2[tm.O_SCAT] > 0.5)
    disc = [tm.O_AT_SURF, tm.O_ENV_CT, tm.O_SHADOW_CT, tm.O_SAMPLE_OK] + [
        tm.O_NEE + tm.NEE_ROWS * si + 7 for si in range(light_samples)]
    disc += [tm.O_SCAT, tm.O_MSTK, tm.O_MSTK + 1]
    live_rows = [tm.O_RAD + ci for ci in range(4)] + disc[:3] + list(
        range(tm.O_SCAT, tm.O_NEE))
    for row in range(tm.O_NEE + tm.NEE_ROWS * light_samples):
        m = alive if row in live_rows else surf
        x, y = jk2[row][m], k2[row][m]
        if row in disc:
            assert few(x != y, 1e-3), f"k2 row {row}"
            continue
        ok = np.isclose(y, x, rtol=fpdf_rtol if row == tm.O_FPDF else 1e-4,
                        atol=1e-5)
        assert few(~ok, 5e-3), f"k2 row {row}: {ok.mean()} within 1e-4"
        np.testing.assert_allclose(
            y, x, rtol=2e-2 if row == tm.O_FPDF else 5e-3, atol=1e-4,
            err_msg=f"k2 row {row}")


# ------------------------------------------------------------- light tracing


class LTReplay:
    """Uniform source for the port's light tracer that yields exactly the
    blocks the JAX `lt_trace_mega(key)` draws in round `it`: the K12/K34
    block from fold_in(fold_in(key, it), 0); from kf = fold_in(fold_in(key,
    it), 2) the v2 spawn rows, the v1 spawn columns and the strata
    permutation (fold_in(kf, 7)); and the v1 lens columns from
    fold_in(kf, 1) (the port's stream 3)."""

    def __init__(self, key):
        self.key = key

    def _k(self, it, stream):
        k = jax.random.fold_in(jax.random.fold_in(self.key, jnp.int32(it)),
                               2 if stream == 3 else stream)
        return jax.random.fold_in(k, 1) if stream == 3 else k

    def round(self, it, rows, n_pad, device, stream=None):
        u = jax.random.uniform(self._k(it, stream), (rows, n_pad))
        return torch.as_tensor(np.array(u), device=device)

    def lanes(self, it, cols, n_pad, device, stream=None):
        u = jax.random.uniform(self._k(it, stream), (n_pad, cols))
        return torch.as_tensor(np.array(u), device=device)

    def permutation(self, it, n, device, stream=None):
        p = jax.random.permutation(sampling.fold(self._k(it, stream), 7), n)
        return torch.as_tensor(np.array(p), device=device).long()


def jax_lt_setup(jw, jc, lt_settings, width, height, spawn_inkernel):
    """The JAX tables, frozen consts and settings that `lt_trace_mega` hands
    its rounds (tables: prim, dense, mat, spec, light, lcdf)."""
    from pathtracer_tpu.kernels import lt_mega as jlt

    scene = jm.build_mega_scene(jw, jc, jlt._PTShim())
    consts = dict(scene.consts)
    consts["lt_a_lens"] = float(np.pi) * float(jc.lens_radius) ** 2
    consts["lt_a_film"] = float((2.0 * jc.half_width) * (2.0 * jc.half_height))
    consts["lt_has_proxy"] = bool((np.asarray(jw.prims.mat_kind) == 2).any())
    consts.pop("tex_feed", None)
    consts.pop("medium", None)
    wb = lt_settings.wavelength_bounds
    lcdf = None
    if spawn_inkernel:
        consts["lt_world_radius"] = float(np.asarray(jw.radius))
        consts["lt_world_center"] = tuple(float(x)
                                          for x in np.asarray(jw.center))
        lcdf = jnp.asarray(jlt.bake_lt_spawn_tab(jw, wb))
    settings = dict(camera_samples=int(lt_settings.camera_samples),
                    max_bounces=float(lt_settings.max_bounces),
                    min_bounces=float(lt_settings.min_bounces),
                    russian_roulette=bool(lt_settings.russian_roulette),
                    width=float(width), height=float(height),
                    wb_lo=float(wb.lower), wb_span=float(wb.span),
                    tile=jm.TILE)
    tabs = (scene.prim_tab, scene.dense_tab, scene.mat_tab, scene.spec_tab,
            scene.light_tab, lcdf)
    return tabs, consts, settings


def jax_lt_kernels(tabs, consts, settings):
    """Jitted interpret-mode K12-LT, K34-LT v2 and K34-LT v1 calls, built
    exactly as `_lt_round_v2` and `_lt_step` build their pallas_calls."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from pathtracer_tpu.kernels import lt_mega as jlt

    prim, dense, mat, spec, light, lcdf = tabs
    cs = settings["camera_samples"]
    nu, nq = jlt._nu_lt(cs), jlt._q2_rows(cs)
    interp = pltpu.InterpretParams()

    def call(kernel, rows_in, full, rows_out):
        def f(*args):
            n_pad = args[0].shape[1]
            return pl.pallas_call(
                functools.partial(kernel, consts, settings),
                grid=(n_pad // jm.TILE,),
                in_specs=[jm._row_spec(r) for r in rows_in]
                + [jm._full_block_spec(t) for t in full],
                out_specs=jm._row_spec(rows_out),
                out_shape=jax.ShapeDtypeStruct((rows_out, n_pad), jnp.float32),
                interpret=interp)(*args, *full)
        return jax.jit(f)

    k12 = call(jlt._lt_shade_kernel, [nu, jlt.NS_LT], [dense, prim, mat, spec],
               nq)
    k34v2 = (call(jlt._lt_finalize_spawn_kernel,
                  [nu, jlt.NUSP, jlt.NS_LT, nq], [dense, light, spec, lcdf],
                  jlt._k4_rows_v2(cs)) if lcdf is not None else None)
    k34v1 = call(jlt._lt_finalize_kernel, [nu, jlt.NS_LT, nq, jlt.NF], [dense],
                 jlt._k4_rows(cs))
    return k12, k34v2, k34v1


def both_lt_settings(**kw):
    from pathtracer_tpu.integrator.lt import LTSettings as JaxLT
    from pathtracer_tpu_torch.integrator.lt import LTSettings as TorchLT

    return JaxLT(**kw), TorchLT(**kw)


def chained_lt(recipe, lt_kw, spawn_inkernel, rounds=3, lanes=2048,
               budget=2, width=64, height=64):
    """`rounds` LT rounds of the JAX kernels (interpret mode) and of the
    port's plain twins, each chained on its own state from the same initial
    state (every lane dead with `budget` particles), on the uniforms the
    JAX round draws (LTReplay). v2 runs K12-LT + K34-LT v2; v1 runs K12-LT,
    the spawn feed and K34-LT v1 (the port's feed against `_lt_spawn_feed`).
    Returns per round a dict: the states going in, jax/port Q rows, jax/port
    K34-LT rows, and jax/port spawn-feed rows (v1)."""
    from pathtracer_tpu.kernels import lt_mega as jlt
    from pathtracer_tpu_torch.kernels import lt_mega as tlt

    jw, tw, jc, tc = both_worlds(recipe)
    jsettings, lt_settings = both_lt_settings(**lt_kw)
    tabs, consts, settings = jax_lt_setup(jw, jc, jsettings, width, height,
                                          spawn_inkernel)
    k12, k34v2, k34v1 = jax_lt_kernels(tabs, consts, settings)
    scene = tlt.build_lt_scene(tw, tc, lt_settings, width, height, "cpu",
                               spawn_inkernel)
    key = jax.random.PRNGKey(7)
    replay = LTReplay(key)
    cs = lt_settings.camera_samples
    state0 = np.zeros((tlt.NS_LT, lanes), np.float32)
    state0[tlt.LS_BUDGET] = budget
    jstate, tstate = jnp.asarray(state0), torch.as_tensor(state0)
    film = torch.zeros((width * height, 3))
    out = []
    for it in range(rounds):
        u = replay.round(it, tlt.nu_lt(cs), lanes, "cpu", 0)
        ju = jnp.asarray(u.numpy())
        jq = k12(ju, jstate)
        q = tlt.lt_shade(u, tstate, scene, film)
        rec = dict(jin=np.asarray(jstate), tin=tstate.numpy().copy(),
                   jq=np.asarray(jq), q=q.numpy())
        if spawn_inkernel:
            kf = jax.random.fold_in(jax.random.fold_in(key, jnp.int32(it)), 2)
            jusp = jax.random.uniform(kf, (jlt.NUSP, lanes))
            if lt_settings.stratified:
                jusp = jlt._stratify_usp(jsettings, jusp, kf)
            usp = replay.round(it, tlt.NUSP, lanes, "cpu", 2)
            if lt_settings.stratified:
                usp = tlt.stratify_usp(lt_settings, usp, replay.permutation(
                    it, lt_settings.strata_uv ** 2 * lt_settings.strata_lam,
                    "cpu", 2))
            rec["usp_equal"] = bool(np.array_equal(np.asarray(jusp),
                                                   usp.numpy()))
            jo = k34v2(ju, jusp, jstate, jq)
            o = tlt.lt_finalize_spawn(u, usp, tstate, q, scene, film)
        else:
            jfeed = jlt._lt_spawn_feed(jw, jsettings, key, jnp.int32(it),
                                       lanes, jc, width, height)
            feed = tlt.spawn_feed_for(scene, lt_settings, replay, it, lanes)
            rec.update(jfeed=np.asarray(jfeed), feed=feed.numpy())
            jo = k34v1(ju, jstate, jq, jfeed)
            o = tlt.lt_finalize(u, tstate, q, feed, scene, film)
        rec.update(jout=np.asarray(jo), out=o.numpy())
        out.append(rec)
        jstate, tstate = jo[:tlt.NS_LT], o[:tlt.NS_LT]
    return out


# ------------------------------------------------- regen without kernels


class RegenReplay:
    """Uniform source for the port's `pt_trace_regen` that yields exactly
    the blocks the JAX `pt_trace_regen(key)` draws: the first spawn from
    fold(key, 1), and at cursor `it` (the carry's rnd_i: the round block,
    rnd_i + 1: the respawn block) uniform(fold(key, it), (n, cols))."""

    def __init__(self, key):
        self.key = key

    def init(self, n, device):
        u = jax.random.uniform(sampling.fold(self.key, 1), (n, 5))
        return torch.as_tensor(np.array(u), device=device)

    def lanes(self, it, cols, n, device, stream=None):
        u = jax.random.uniform(sampling.fold(self.key, jnp.int32(it)),
                               (n, cols))
        return torch.as_tensor(np.array(u), device=device)


def regen_state_to_torch(state):
    """The JAX pt_trace_regen carry -> the port's RegenState (CPU)."""
    from pathtracer_tpu_torch.integrator.pt_regen import RegenState

    rnd_i, *rest = state
    out = [torch.as_tensor(np.array(x)) for x in rest]
    counters = RegenState._fields.index("counters") - 1
    out[counters] = out[counters].double()
    return RegenState(int(rnd_i), *out)


def regen_state_to_jax(state):
    """The port's RegenState -> the JAX pt_trace_regen carry."""
    rnd_i, *rest = state
    out = [jnp.asarray(x.cpu().numpy()) for x in rest]
    counters = len(out) - 2
    out[counters] = out[counters].astype(jnp.float32)
    return (jnp.int32(rnd_i), *out)


REGEN_DISCRETE = ("alive", "done", "bounce_ct", "med_stack")


def _lane_rows(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.reshape(x.shape[0], -1)


def check_regen_state(ref, got):
    """The port's RegenState `got` against the JAX carry's `ref` (both as
    RegenStates): the discrete rows equal on >= 99.9% of lanes; on those
    lanes every continuous row within rtol 1e-4, atol 1e-5 on >= 99.9% of
    them and within rtol 5e-3, atol 1e-4 on all; prev_pdf within rtol 2e-2;
    the counters within 1e-3 a lane (tests/test_torch_regen_rounds.py
    gives the reasons)."""
    n = got.alive.shape[0]
    assert ref.rnd_i == got.rnd_i
    match = np.ones(n, bool)
    for f in REGEN_DISCRETE:
        match &= (_lane_rows(getattr(ref, f))
                  == _lane_rows(getattr(got, f))).all(axis=1)
    assert match.mean() >= 0.999, f"discrete rows agree on {match.mean()}"
    for f in ("o", "d", "lam", "beta", "path_rad", "acc", "prev_pdf",
              "pdfr"):
        x = _lane_rows(getattr(ref, f))[match]
        y = _lane_rows(getattr(got, f))[match]
        if f == "prev_pdf":
            np.testing.assert_allclose(y, x, rtol=2e-2, atol=1e-5,
                                       err_msg=f)
            continue
        ok = np.isclose(y, x, rtol=1e-4, atol=1e-5).all(axis=1)
        assert ok.mean() >= 0.999, f"{f}: {ok.mean()} of lanes within 1e-4"
        np.testing.assert_allclose(y, x, rtol=5e-3, atol=1e-4, err_msg=f)
    np.testing.assert_allclose(got.counters.numpy(), ref.counters.numpy(),
                               rtol=0, atol=1e-3 * n)


def regen_rounds_match_jax(recipe, hwss, medium, width=32, spp=4,
                           rounds=3):
    """`rounds` rounds of the port's pt_trace_regen against the JAX one on
    the JAX draws (`RegenReplay`), each package chained on its own state
    from the same first spawn, every state held by `check_regen_state`."""
    from pathtracer_tpu.integrator.pt_regen import pt_trace_regen as j_regen
    from pathtracer_tpu_torch.integrator.pt_regen import (
        pt_trace_regen as t_regen,
    )

    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_settings(**NEE_SETTINGS, hwss=hwss, medium_aware=medium)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def j_round(world, cam, st):
        return j_regen(world, cam, js, width, width, spp, key,
                       init_state=st, max_rounds=1, return_state=True)

    uni = RegenReplay(key)
    jst = j_regen(jw, jc, js, width, width, spp, key, max_rounds=0,
                  return_state=True)
    tst = t_regen(tw, tc, ts, width, width, spp, uni, max_rounds=0,
                  return_state=True)
    check_regen_state(regen_state_to_torch(jst), tst)
    back = regen_state_to_torch(regen_state_to_jax(tst))
    for f, x in zip(back._fields, back):
        assert f == "rnd_i" and x == tst.rnd_i or torch.equal(
            x, getattr(tst, f)), f
    for _ in range(rounds):
        jst = j_round(jw, jc, jst)
        tst = t_regen(tw, tc, ts, width, width, spp, uni, init_state=tst,
                      max_rounds=1, return_state=True)
        check_regen_state(regen_state_to_torch(jst), tst)
    assert tst.alive.any() and tst.counters[2] > 0
    return tst


# ------------------------------------------- the wavefront integrators


class LTTraceReplay:
    """Uniform source for the port's `lt_trace` that yields exactly the
    blocks the JAX `lt_trace(key)` draws: k_init, k_walk = split(key); the
    spawn columns uniform(k_init, (n, 9)) and the strata permutation
    permutation(fold(k_init, 7), cells); the light vertex's lens columns
    from fold(k_walk, 999); bounce b's block from fold(k_walk, b). With
    `chunked`, call `chunk` c replays the key fold(key, 3000 + c) that the
    JAX `render_splatted` hands its chunk c."""

    def __init__(self, key, chunked=False):
        self.key, self.chunked = key, chunked

    def _keys(self, chunk):
        key = sampling.fold(self.key, 3000 + chunk) if self.chunked \
            else self.key
        return jax.random.split(key)

    def lanes(self, chunk, cols, n, device, stream=None):
        from pathtracer_tpu_torch.integrator import lt

        k_init, k_walk = self._keys(chunk)
        if stream == lt.LT_SPAWN:
            k = k_init
        elif stream == lt.LT_LENS:
            k = sampling.fold(k_walk, 999)
        else:
            k = sampling.fold(k_walk, stream - lt.LT_BOUNCE)
        u = jax.random.uniform(k, (n, cols))
        return torch.as_tensor(np.array(u), device=device)

    def permutation(self, chunk, n, device, stream=None):
        p = jax.random.permutation(sampling.fold(self._keys(chunk)[0], 7), n)
        return torch.as_tensor(np.array(p), device=device).long()


class BDPTReplay:
    """Uniform source for the port's BDPT that yields exactly the JAX
    draws. `render_bdpt`'s pass `it` (= 5000 + c · 7919 + start) keys
    fold(key, it): its jitter from fold(., 11), its `bdpt_trace` key from
    fold(., 13); with `direct`, `key` is the `bdpt_trace` key itself. Inside
    `bdpt_trace`, k_lam, k_light, k_eye, k_con = split(key, 4): λ from
    uniform(k_lam, (n,)), the light vertex from fold(k_light, 100), light
    walk step i from fold(fold(k_light, 200), i), the lens from
    fold(k_eye, 300), eye walk step i from fold(fold(k_eye, 400), i), the
    environment NEE columns from fold(k_con, 777)."""

    def __init__(self, key, direct=False):
        self.key, self.direct = key, direct

    def lanes(self, it, cols, n, device, stream=None):
        from pathtracer_tpu_torch.integrator import bdpt as tb

        if self.direct:
            tk = self.key
        else:
            ck = sampling.fold(self.key, it)
            if stream == tb.S_JITTER:
                u = jax.random.uniform(sampling.fold(ck, 11), (n, cols))
                return torch.as_tensor(np.array(u), device=device)
            tk = sampling.fold(ck, 13)
        k_lam, k_light, k_eye, k_con = jax.random.split(tk, 4)
        if stream == tb.S_LAM:
            k = k_lam  # uniform(k, (n,)) is uniform(k, (n, 1))'s column
        elif stream == tb.S_LIGHT:
            k = sampling.fold(k_light, 100)
        elif stream == tb.S_EYE:
            k = sampling.fold(k_eye, 300)
        elif stream == tb.S_ENV:
            k = sampling.fold(k_con, 777)
        elif stream >= tb.S_EYE_WALK:
            k = sampling.fold(sampling.fold(k_eye, 400),
                              stream - tb.S_EYE_WALK)
        else:
            k = sampling.fold(sampling.fold(k_light, 200),
                              stream - tb.S_LIGHT_WALK)
        u = jax.random.uniform(k, (n, cols))
        return torch.as_tensor(np.array(u), device=device)


def lt_trace_matches_jax(recipe, cs, stratified, n=512, width=16):
    """The port's `lt_trace` with the JAX draws replayed (LTTraceReplay)
    against the JAX `lt_trace` at max bounces 4: film sums within rtol
    1e-4, pixels within rtol 1e-3 / atol 1e-5 on >= 99.9% of pixels, every
    counter within 1e-6 relative (CAMERA_RAYS counts every lane's unblocked
    connections, as the JAX `lt_trace` does)."""
    from pathtracer_tpu.integrator.lt import lt_trace as jax_lt_trace
    from pathtracer_tpu_torch.integrator.lt import lt_trace
    from pathtracer_tpu_torch.utils import profile as prof

    jw, tw, jc, tc = both_worlds(recipe)
    js, ts = both_lt_settings(max_bounces=4, camera_samples=cs,
                              stratified=stratified)
    key = jax.random.PRNGKey(7)
    jfilm, jcount = jax.jit(jax_lt_trace, static_argnums=(2, 3, 4, 5))(
        jw, jc, js, width, width, n, key)
    jfilm, jcount = np.asarray(jfilm), np.asarray(jcount)
    stats = {}
    film, counters = lt_trace(tw, tc, ts, width, width, n,
                              LTTraceReplay(key), stats=stats)
    film, counters = film.numpy(), counters.numpy()
    assert stats["chunks"] == 1 and 0 < stats["rounds"] <= 4
    assert counters[prof.LIGHT_RAYS] == n
    assert np.isfinite(film).all() and jfilm.sum() > 0
    np.testing.assert_allclose(film.sum(0), jfilm.sum(0), rtol=1e-4)
    close = np.isclose(film, jfilm, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.999, np.where(~close)
    np.testing.assert_allclose(counters, jcount, rtol=1e-6)


def jax_bdpt_batched(jw, jc, settings, film_uv, key):
    """The JAX `bdpt_trace`'s batched body at any max_depth: PT_BDPT_BATCHED
    is set while a jit of a function of this call's own is first traced
    (the JAX package reads it at trace time and takes its per-pair loops at
    max_depth <= 4 without it)."""
    import os

    from pathtracer_tpu.integrator.bdpt import bdpt_trace as jax_bdpt_trace

    def batched(world, camera, film_uv, key):
        return jax_bdpt_trace(world, camera, settings, film_uv, key)

    old = os.environ.get("PT_BDPT_BATCHED")
    os.environ["PT_BDPT_BATCHED"] = "1"
    try:
        out = jax.jit(batched)(jw, jc, jnp.asarray(film_uv), key)
    finally:
        if old is None:
            del os.environ["PT_BDPT_BATCHED"]
        else:
            os.environ["PT_BDPT_BATCHED"] = old
    return [np.asarray(a) for a in out]


def _mostly_close(got, ref, rtol, atol):
    close = np.isclose(got, ref, rtol=rtol, atol=atol)
    assert close.size == 0 or close.mean() >= 0.999, (
        np.where(~close), got[~close], ref[~close])


def bdpt_trace_matches_jax(recipe, max_depth, selected_pair=None, n=256):
    """The port's `bdpt_trace` with the JAX draws replayed (BDPTReplay) on
    n random film points against the JAX batched body: own-pixel energy
    and splat energy within rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes and
    their sums within rtol 1e-4, the lit splats' film uv within rtol 1e-4,
    λ within rtol 1e-6, every counter within 1e-6 relative."""
    from pathtracer_tpu.integrator.bdpt import BDPTSettings as JaxBDPT
    from pathtracer_tpu_torch.integrator.bdpt import BDPTSettings, bdpt_trace

    jw, tw, jc, tc = both_worlds(recipe)
    key = jax.random.PRNGKey(5)
    film_uv = np.random.default_rng(0).uniform(size=(n, 2)) \
        .astype(np.float32)
    ref = jax_bdpt_batched(jw, jc, JaxBDPT(max_depth=max_depth,
                                           selected_pair=selected_pair),
                           film_uv, key)
    got = [a.numpy() for a in bdpt_trace(
        tw, tc, BDPTSettings(max_depth=max_depth,
                             selected_pair=selected_pair),
        torch.as_tensor(film_uv), BDPTReplay(key, direct=True))]
    (own, uv, e, lam, lam_s, counters) = got
    (j_own, j_uv, j_e, j_lam, j_lam_s, j_counters) = ref
    assert own.shape == j_own.shape and e.shape == j_e.shape
    assert np.isfinite(own).all() and np.isfinite(e).all()
    for a, b in ((own, j_own), (e, j_e)):
        _mostly_close(a, b, 1e-4, 1e-6)
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4, atol=1e-6)
    lit = j_e > 0.0
    np.testing.assert_allclose(uv[lit], j_uv[lit], rtol=1e-4)
    np.testing.assert_allclose(lam, j_lam, rtol=1e-6)
    np.testing.assert_allclose(lam_s, j_lam_s, rtol=1e-6)
    np.testing.assert_allclose(counters, j_counters, rtol=1e-6)
    return got
