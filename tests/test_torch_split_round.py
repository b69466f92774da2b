"""The split round K1 | feeds | K2 | K3 | K4 of the port (`split_round`,
`stepper="split"`) on the CPU, where every wrapper runs its plain twin.

Against the port's own default rounds, with `torch.equal`: the split round
must write the out rows and K2 rows that `two_prog_round` (or
`texfeed_round` for uv-textured scenes) writes from the same state and
uniforms, bit for bit, on the Cornell box, the gem, the textured Cornell
box (also under medium-aware settings: K2 then takes the texture and the
medium feed together, with no medium in the box and with `textured_fog`'s
two), a textured sphere under the Sun and the medium-aware `fog_cornell`;
and a render with
`stepper="split"` must equal the default render from the same seed, film
and counters (the JAX package's test_mega_2prog_bitidentical_3prog, one
step further). Exact because K2 shares `_shade` with K12, K3's twin is the
any-hit sweep `_resolve_nee` runs, and K4 shares `_finalize_k2` with K34.

Against the JAX package (Pallas interpret mode, 1024-lane tile), on the
medium-aware `fog_cornell` at C = 4 over two chained rounds:
- K3: the port's `sweep_any_rows` on the JAX K2 rows against the JAX
  `sweep_any_rows`: the blocked mask equal on every lane whose NEE sample
  is worth a ray, the only lanes K4 reads (the port writes 0 elsewhere,
  where the Pallas kernel sweeps rays nobody reads); allowing one lane in a
  thousand for a shadow ray that grazes a prim's edge, where FMA contraction
  decides the hit;
- K4: `finalize` fed the JAX state, K2 rows and blocked blocks against
  `_k4_call`, held by `check_round` as K34 is (test_torch_two_prog.py).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.kernels import megakernel as jm
from pathtracer_tpu_torch.kernels import dense as tdense
from pathtracer_tpu_torch.kernels import megakernel as tm
from pathtracer_tpu_torch.renderer.persistent import render_regen

from torch_ref_helpers import (
    NEE_SETTINGS,
    both_settings,
    both_worlds,
    chained_split,
    check_round,
)

torch.set_num_threads(2)

# (recipe, C, medium-aware)
CASES = [("cornell", 1, False), ("gem", 4, False), ("textured", 1, False),
         ("fog_cornell", 4, True), ("fog_cornell", 1, True),
         ("textured_sun", 4, False), ("textured", 1, True),
         ("textured_fog", 4, True), ("textured_fog", 1, True)]
IDS = [f"{r}-C{c}" + ("-medium" if m else "") for r, c, m in CASES]


def _port_scene(recipe, c, medium, width=24):
    _, tw, _, tc = both_worlds(recipe)
    _, ts = both_settings(**NEE_SETTINGS, hwss=c == 4, medium_aware=medium)
    scene = tm.build_mega_scene(tw, tc, settings=ts)
    a = tm.RoundArgs.make(scene.consts, ts, width, width)
    return tw, tc, ts, scene, a


@pytest.mark.parametrize("recipe,c,medium", CASES, ids=IDS)
def test_split_round_equals_default_round(recipe, c, medium):
    tw, tc, ts, scene, a = _port_scene(recipe, c, medium)
    n = 24 * 24
    n_pad = -(-n // tm.TILE) * tm.TILE
    default = tm.texfeed_round if scene.tex is not None else tm.two_prog_round

    def uniforms():
        return tm.TorchUniforms(torch.Generator().manual_seed(7))

    s_def, _ = tm.mega_init(tc, uniforms().init(n_pad, "cpu"), a, n, n_pad, 4)
    s_split = s_def.clone()
    u_def, u_split = uniforms(), uniforms()
    before = (tm.K4_LAUNCHES, tdense.ANY_ROWS_LAUNCHES)
    shadows = 0
    for it in range(3):
        out_d, k2_d = default(s_def, scene, a, u_def, it)
        out_s, k2_s = tm.split_round(s_split, scene, a, u_split, it)
        assert torch.equal(k2_s, k2_d), f"K2 rows differ in round {it}"
        assert torch.equal(out_s, out_d), f"out rows differ in round {it}"
        shadows += int(k2_s[tm.O_SHADOW_CT].sum())
        s_def, s_split = out_d[:tm.NS], out_s[:tm.NS]
    assert shadows > 0
    assert (tm.K4_LAUNCHES, tdense.ANY_ROWS_LAUNCHES) == before  # CPU: twins


@pytest.mark.parametrize("recipe,c,medium", [CASES[1], CASES[2], CASES[3]],
                         ids=[IDS[1], IDS[2], IDS[3]])
def test_split_render_equals_default_render(recipe, c, medium):
    tw, tc, ts, scene, _ = _port_scene(recipe, c, medium)
    assert not tm.fused_ok(scene)
    res = []
    for stepper in (None, "split"):
        stats = {}
        calls = (tm.PLAIN_CALLS, tdense.ANY_ROWS_PLAIN_CALLS,
                 tdense.ROWS_PLAIN_CALLS)
        film, profile, _ = render_regen(
            tw, tc, ts, 12, 12, 2, generator=torch.Generator().manual_seed(3),
            stats=stats, stepper=stepper)
        res.append((film, profile, stats["rounds"],
                    tm.PLAIN_CALLS - calls[0],
                    tdense.ANY_ROWS_PLAIN_CALLS - calls[1],
                    tdense.ROWS_PLAIN_CALLS - calls[2]))
    (f0, p0, r0, *_), (f1, p1, r1, plain, k3, k1) = res
    assert torch.equal(f0, f1)
    assert r0 == r1 > 0
    for name in ("camera_rays", "bounce_rays", "shadow_rays", "env_hits"):
        assert getattr(p0, name) == getattr(p1, name), name
    # the split render: K1, K2 and K4 once a round, K3 once per NEE sample
    assert (k1, plain, k3) == (r1, 2 * r1, NEE_SETTINGS["light_samples"] * r1)


def test_split_stepper_takes_the_fused_gate_too():
    """A scene the default routing gives the fused round renders through
    the split round when asked; any other stepper name is refused."""
    tw, tc, ts, scene, _ = _port_scene("cornell", 1, False)
    assert tm.fused_ok(scene)
    stats = {}
    k3 = tdense.ANY_ROWS_PLAIN_CALLS
    film, profile, _ = render_regen(
        tw, tc, ts, 8, 8, 2, generator=torch.Generator().manual_seed(1),
        stats=stats, stepper="split")
    assert tdense.ANY_ROWS_PLAIN_CALLS - k3 == 2 * stats["rounds"] > 0
    assert np.isfinite(film.numpy()).all() and profile.camera_rays == 128
    with pytest.raises(ValueError, match="stepper"):
        render_regen(tw, tc, ts, 8, 8, 1, stepper="3prog")


def test_k3_k4_wrappers_on_cpu():
    """On CPU tensors each wrapper makes one call of its plain twin and
    launches nothing; wrong shapes, dtypes and row indices raise."""
    _, tc, _, scene, a = _port_scene("cornell", 1, False)
    n_pad = tm.TILE
    unif = tm.TorchUniforms(torch.Generator().manual_seed(2))
    state, _ = tm.mega_init(tc, unif.init(n_pad, "cpu"), a, 576, n_pad, 2)
    out, k2 = tm.two_prog_round(state, scene, a, unif, 0)
    u34 = unif.round(0, tm.NU4, n_pad, "cpu", 1)
    counts = (tdense.ANY_ROWS_LAUNCHES, tdense.ANY_ROWS_PLAIN_CALLS,
              tm.K4_LAUNCHES, tm.PLAIN_CALLS)
    blks = [tdense.sweep_any_rows(k2, scene.dense_tab, tm.O_NEE + 12 * si,
                                  tm.O_NEE + 12 * si + 6,
                                  live_row=tm.O_NEE + 12 * si + 7)
            for si in range(2)]
    o4 = tm.finalize(u34, state, k2, blks, scene, a)
    assert (tdense.ANY_ROWS_LAUNCHES, tdense.ANY_ROWS_PLAIN_CALLS,
            tm.K4_LAUNCHES, tm.PLAIN_CALLS) == (
        counts[0], counts[1] + 2, counts[2], counts[3] + 1)
    assert blks[0].shape == (1, n_pad) and blks[0].dtype == torch.float32
    assert set(blks[0].unique().tolist()) <= {0.0, 1.0}
    assert not blks[0][0][k2[tm.O_NEE + 7] <= 0.5].any()
    assert o4.shape == (tm.NK4, n_pad)
    # an 8-row block, as the Pallas K3 writes, is read at row 0
    wide = [torch.cat([b, torch.ones((7, n_pad))]) for b in blks]
    assert torch.equal(tm.finalize(u34, state, k2, wide, scene, a), o4)
    # the sweep table the kernel walks changes nothing on the CPU route
    assert torch.equal(tdense.sweep_any_rows(
        k2, scene.dense_tab, tm.O_NEE, tm.O_NEE + 6, live_row=tm.O_NEE + 7,
        sweep=scene.sweep_tab), blks[0])
    # every lane swept without a worth row: a superset of the masked sweep
    full = tdense.sweep_any_rows(k2, scene.dense_tab, tm.O_NEE, tm.O_NEE + 6)
    assert (full >= blks[0]).all()
    with pytest.raises(ValueError):
        tdense.sweep_any_rows(k2, scene.dense_tab, k2.shape[0] - 3, 0)
    with pytest.raises(ValueError):
        tdense.sweep_any_rows(k2, scene.dense_tab, tm.O_NEE, k2.shape[0])
    with pytest.raises(TypeError):
        tdense.sweep_any_rows(k2.double(), scene.dense_tab, tm.O_NEE,
                              tm.O_NEE + 6)
    with pytest.raises(ValueError):
        tm.finalize(u34, state, k2, blks[:1], scene, a)
    with pytest.raises(ValueError):
        tm.finalize(u34, state, k2, [b[:, :8] for b in blks], scene, a)
    with pytest.raises(ValueError):
        tm.finalize(u34, state, k2[:8], blks, scene, a)
    with pytest.raises(TypeError):
        tm.finalize(u34, state, k2, [b.double() for b in blks], scene, a)


def test_medium_wrappers_want_their_feed():
    """Medium-aware round arguments need the medium feed's rows, others must
    not get them; the K12 uniform block has the medium's four rows."""
    _, tc, _, scene, a = _port_scene("fog_cornell", 1, True)
    n_pad = tm.TILE
    unif = tm.TorchUniforms(torch.Generator().manual_seed(2))
    state, _ = tm.mega_init(tc, unif.init(n_pad, "cpu"), a, 576, n_pad, 2)
    u12 = unif.round(0, tm.n_u_rows(2, True), n_pad, "cpu", 0)
    mf = tm.med_feed(scene.med, state, u12, 2, 1)
    assert mf.shape == (tm.mf_rows(1), n_pad)
    # a camera ray starts in vacuum: no flight ends, every weight is 1
    assert (mf[tm.mf_idx(1)["flight"]] == 3e38).all()
    k2 = tm.shade_sweep(u12, state, scene, a, None, mf)
    live = state[tm.S_ALIVE] > 0.5
    assert (k2[tm.O_MEDW:tm.O_MEDW + 4][:, live] == 1.0).all()
    assert not k2[tm.O_SCAT].any()
    with pytest.raises(ValueError, match="mf"):
        tm.shade_sweep(u12, state, scene, a)
    with pytest.raises(ValueError, match="mf"):
        tm.shade_sweep(u12, state, scene, a, None, mf[:8])
    with pytest.raises(ValueError):
        tm.shade_sweep(u12[:9], state, scene, a, None, mf)
    _, _, _, plain_scene, plain_a = _port_scene("cornell", 1, False)
    with pytest.raises(ValueError, match="mf"):
        tm.shade_sweep(u12, state, plain_scene, plain_a, None, mf)


@pytest.fixture(scope="module")
def jax_split():
    tile, sub = jm.TILE, jm.SUB
    jm.TILE, jm.SUB = 1024, 8
    try:
        yield chained_split("fog_cornell", 4, medium=True)
    finally:
        jm.TILE, jm.SUB = tile, sub


@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2"])
def test_k3_matches_jax(jax_split, r):
    x = jax_split[r]
    for si in range(NEE_SETTINGS["light_samples"]):
        worth = x["jk2"][tm.O_NEE + tm.NEE_ROWS * si + 7] > 0.5
        assert worth.any()
        jb, b = x["jblks"][si], x["blks"][si]
        assert jb.shape == (8, b.shape[1]) and b.shape[0] == 1
        assert not jb[1:].any()
        bad = (jb[0] != b[0]) & worth
        assert bad.sum() <= max(1, 1e-3 * worth.sum()), (si, bad.sum())
        assert not b[0][~worth].any()
    assert sum(bl[0].sum() for bl in x["blks"]) > 0


@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2"])
def test_k4_matches_jax(jax_split, r):
    x = jax_split[r]
    check_round(x["state"], x["out"], x["counts"])
    for row in (tm.S_MSTK0, tm.S_MSTK1):
        assert (x["state"][row] == x["out"][row]).mean() >= 0.999
    if r == 1:
        assert (x["out"][tm.S_MSTK0] > 0).any()
