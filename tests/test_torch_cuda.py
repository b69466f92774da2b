"""The CUDA kernels against their plain twins on the card (marker `gpu`;
skipped where torch sees no CUDA device). chip_smoke.py runs the same
checks at the main path's full shapes; these are the small-shape version:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

(`--noconftest`: tests/conftest.py configures JAX, which the card's machine
need not have.)

The sweep must match exactly (hit, prim id, t, any-hit mask). The round
kernels and their twins run the same operations in the same order (the
twins divide by constants as IEEE divisions, and the kernels are built
without FMA contraction). The fused round and K12-LT must equal their twins
on every row: the fused round at 0 to 3 NEE samples, C = 1 and 4, over
three chained rounds in which lanes die mid-warp; K1, K12-LT and K34-LT (v2
at 1, 2 and 3 camera samples, v1) with their sweep table resident and
through the ring, on the kernel's own state. Elsewhere the discrete rows must be
equal on >= 99.99% of lanes and the continuous rows within rtol 1e-4, atol
1e-5 on those lanes. That holds for K12 (shade_sweep, its K2 rows) and K34
(finalize_sweep) of the two-program round on the multi-chunk gem, the HDR
blob and the Sun scene, and for K2 (shade) and K34 of the texture-feed
round on the textured Cornell box, each chained over three rounds; and for the
medium instantiations of K12, K2, K34 and K4 and the split round's K3
(sweep_any_rows: mask equal) and K4 (finalize) on the fog and nested media
scenes. Every round kernel that sweeps walks the compact sweep table from
shared memory (csrc/walk.cuh). K12, K34 and K3 are held to their twins with
the table resident and through the ring of tiles (a table one row over the
residency budget, and the 41 tiles of the mesh), the two bit for bit equal
to each other, at 1, 2 and 3 NEE samples; and the split round renders the
film of the two-program round. The polygon-aperture respawn and the
direct-only cut, which no recipe reaches, have a case each (fused round,
K12, K34). The dense sweeps (dense_sweep.cu) walk the sweep table too, one
ray a lane with its own bounds, resident and through the ring, a table of
9,216 rows among them, equal to their twins bit for bit with and without
the any-hit sweep's `live` mask. `World.intersect` / `intersect_any` on a
CUDA world launch them and give the CPU twin's hit record, and a regen
render launches them once a round and once a round per light sample; the
light-tracing wavefront and BDPT launch them on every bounce and every
strategy family, and match CPU runs of the same uniforms. K12-LT and K34-LT
add the LT megakernel's valid splats to the film themselves: each
kernel's splats, and a render's film, equal the `index_add_` of the splat
rows written within rtol 1e-5 (v2 at 1 and 2 camera samples, v1). The
texture feed's kernel equals `tex_feed_plain` on the card bit for bit, on
every prim type at C = 1 and 4, and without a baked pair table the feed
stays on the chain. The pair table's bake kernel writes the table that
`_bake_tex_lut_plain` writes from the same layout bit for bit, on textures
of any size and layer count. With
tracing on
(utils/profile.py), the megakernel routes render the film and counters of
tracing off and count their lanes on the card."""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.kernels import dense
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.parsing import SceneBuilder

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _rays(n, gen, dev, tmax=None):
    o = torch.rand((3, n), generator=gen, device=dev) * 1.4 - 0.2
    d = torch.randn((3, n), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=0, keepdim=True)
    t0 = torch.full((1, n), 1e-6, device=dev)
    t1 = torch.full((1, n), 1e9, device=dev) if tmax is None else tmax
    return torch.cat([o, d, t0, t1]).contiguous()


def _dense_tables(table, dev):
    """(the packed table, the sweep table) of a dense sweep case: the chip
    scene (32 rows), the gem (352), the random table of all four prim types
    (1,120 rows: the ring at the default budget) and a random one of 9,216
    rows, over the round kernels' 8192-row cap."""
    if table == "chip":
        w = scenes.chip_scene(SceneBuilder(), spectral).build(dev)
    elif table == "gem":
        w = scenes.gem_cornell(SceneBuilder(), spectral).build(dev)
    else:
        w = scenes.random_prims(SceneBuilder(), spectral, seed=2, grid=20,
                                n_each=100 if table == "random"
                                else 2800).build(dev)
    return w.dense_tab, w.sweep_tab


@pytest.mark.parametrize("table", ["chip", "random"])
def test_sweep_kernel_matches_plain(dev, table):
    tab, sweep = _dense_tables(table, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    rays = _rays(1 << 16, gen, dev)
    launches = dense.CLOSEST_LAUNCHES
    k = dense.sweep_closest(rays, tab, sweep)
    pl = dense.sweep_closest_plain(rays, tab)
    assert dense.CLOSEST_LAUNCHES == launches + 1
    assert torch.equal(k, pl)
    assert (k[1] >= 0).float().mean() > 0.05
    rays_a = _rays(1 << 16, gen, dev,
                   torch.rand((1, 1 << 16), generator=gen, device=dev) + 0.05)
    assert torch.equal(dense.sweep_any(rays_a, tab, sweep),
                       dense.sweep_any_plain(rays_a, tab))
    with pytest.raises(ValueError, match="sweep="):
        dense.sweep_closest(rays, tab)
    with pytest.raises(ValueError, match="sweep="):
        dense.sweep_any(rays_a, tab)


def _odd_rays(n, gen, dev):
    """Rays with per-ray bounds and the degenerate lanes the regen
    integrator and the JAX padding hand the sweeps: t_min drawn in (0, 0.3)
    on a third of the lanes; t_min = t_max = 0 with a zero direction; NaN
    and inf origins; NaN and zero directions; t_min >= t_max."""
    rays = _rays(n, gen, dev, torch.rand((1, n), generator=gen, device=dev)
                 * 1.45 + 0.05)
    pick = torch.rand(n, generator=gen, device=dev)
    rays[6] = torch.where(pick < 0.3, pick, rays[6])
    k = torch.arange(n, device=dev)
    pad = k % 97 == 1
    rays[3:8, pad] = 0.0
    rays[0, k % 89 == 2] = float("nan")
    rays[1, k % 83 == 3] = float("inf")
    rays[4, k % 79 == 4] = float("nan")
    rays[3:6, k % 73 == 5] = 0.0
    swap = k % 71 == 6
    rays[6, swap], rays[7, swap] = rays[7, swap] + 0.01, rays[6, swap]
    return rays


@pytest.mark.parametrize("table,budget", [
    ("chip", "default"), ("gem", "default"), ("gem", "at_table"),
    ("gem", "one_row_under"), ("random", "default"), ("big", "default")])
def test_dense_sweeps_walk_equal_twins(dev, table, budget, monkeypatch):
    """dense_sweep_closest and dense_sweep_any walk the sweep table through
    walk.cuh, resident (the chip, the gem: the budget at the table) or
    through the ring (the gem with the budget one row under its table, the
    1,120-row random table, the 9,216-row one, which no round kernel
    takes): ids, t and masks equal to the twins' bit for bit on rays with
    per-ray bounds and degenerate lanes, and with the `live` mask the
    masked lanes read 0 and the others the unmasked verdict."""
    tab, sweep = _dense_tables(table, dev)
    rows = int(sweep.shape[0])
    if budget != "default":
        monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS",
                            rows if budget == "at_table" else rows - 1)
    assert (rows <= mk.SWEEP_RESIDENT_ROWS) == (
        table in ("chip", "gem") and budget != "one_row_under")
    n = (1 << 13) if table == "big" else (1 << 16)
    gen = torch.Generator(device=dev).manual_seed(5)
    rays = _odd_rays(n, gen, dev)
    launches = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
    k = dense.sweep_closest(rays, tab, sweep)
    assert torch.equal(k, dense.sweep_closest_plain(rays, tab))
    assert (k[1] >= 0).any()
    ka = dense.sweep_any(rays, tab, sweep)
    assert torch.equal(ka, dense.sweep_any_plain(rays, tab))
    assert 0.0 < float(ka.mean()) < 1.0
    live = torch.rand(n, generator=gen, device=dev) < 0.6
    km = dense.sweep_any(rays, tab, sweep, live)
    assert torch.equal(km, dense.sweep_any_plain(rays, tab, live))
    assert torch.equal(km[0][live], ka[0][live])
    assert not km[0][~live].any()
    assert (dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES) == (
        launches[0] + 1, launches[1] + 2)


@pytest.mark.parametrize("recipe", [scenes.chip_scene, scenes.cornell_sharp],
                         ids=["chip", "sharp"])
@pytest.mark.parametrize("c_lanes", [1, 4])
@pytest.mark.parametrize("ls", [0, 1, 2, 3])
def test_fused_round_kernel_matches_plain(dev, ls, c_lanes, recipe):
    """Three chained fused rounds equal to the twin's on every row. One
    sample a pixel, so that lanes die and stay dead mid-warp from the
    second round on, and 91 lanes fewer than a whole number of blocks, so
    that the last block has threads past n: every thread still takes part
    in every walk."""
    world = recipe(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    s = PTSettings(max_bounces=12, light_samples=ls, hwss=c_lanes == 4)
    scene = mk.build_mega_scene(world, cam, dev)
    a = mk.RoundArgs.make(scene.consts, s, 128, 128)
    n_pad = -(-128 * 128 // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(4)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 128 * 128,
                            n_pad, 1)
    n = n_pad - 91
    sk = state[:, :n].contiguous()
    dead = 0
    for _ in range(3):
        u = torch.rand((mk.nu_rows(ls), n), generator=gen, device=dev)
        launches = mk.FUSED_LAUNCHES
        ok = mk.fused_round(u, sk, scene, a)
        op = mk.fused_round_plain(u, sk, scene.dense_tab, scene.prim_tab,
                                  scene.mat_tab, scene.light_tab,
                                  scene.spec_tab, a)
        assert mk.FUSED_LAUNCHES == launches + 1
        assert torch.equal(ok, op)
        dead += int((sk[mk.S_ALIVE] <= 0.5).sum())
        sk = ok[:mk.NS]
    assert dead > 0
    assert (int(ok[mk.O4_SHADOW_CT].sum()) > 0) == (ls > 0)
    assert np.isfinite(sk.cpu().numpy()).all()


def match_rows(k, p, disc):
    """Fraction of lanes whose discrete rows are equal, and whether the
    other rows agree within rtol 1e-4, atol 1e-5 on those lanes."""
    match = (k[disc] == p[disc]).all(dim=0)
    cont = [r for r in range(k.shape[0]) if r not in disc]
    close = torch.isclose(k[cont][:, match], p[cont][:, match], rtol=1e-4,
                          atol=1e-5)
    return float(match.float().mean()), bool(close.all())


def k2_discrete(ls):
    return [mk.O_AT_SURF, mk.O_ENV_CT, mk.O_SHADOW_CT, mk.O_SAMPLE_OK] + [
        mk.O_NEE + mk.NEE_ROWS * si + 7 for si in range(ls)]


@pytest.mark.parametrize("recipe,cam,c_lanes", [
    ("gem_cornell", "CORNELL_CAMERA", 1), ("gem_cornell", "CORNELL_CAMERA", 4),
    ("hdri_blob", "SPHERE_CAMERA", 4), ("hdri_blob", "SPHERE_CAMERA", 1),
    ("sun_sphere", "SPHERE_CAMERA", 1)])
def test_two_prog_kernels_match_plain(dev, recipe, cam, c_lanes):
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**getattr(scenes, cam), device=dev)
    s = PTSettings(max_bounces=12, light_samples=2, hwss=c_lanes == 4)
    scene = mk.build_mega_scene(world, cam, dev)
    assert not mk.fused_ok(scene)
    a = mk.RoundArgs.make(scene.consts, s, 128, 128)
    n_pad = -(-128 * 128 // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(4)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 128 * 128,
                            n_pad, 4)
    sk = state
    disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.O4_BOUNCE_CT,
            mk.O4_CAMERA_CT]
    for _ in range(3):
        u12 = torch.rand((mk.n_u_rows(2), n_pad), generator=gen, device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        ef = (mk.env_feed(scene.env, sk, u12, 2, c_lanes)
              if scene.env is not None else None)
        launches = (mk.SHADE_LAUNCHES, mk.FINALIZE_LAUNCHES)
        k2k = mk.shade_sweep(u12, sk, scene, a, ef)
        k2p = mk.shade_sweep_plain(u12, sk, a=a, ef=ef, **mk._tables(scene))
        frac, close = match_rows(k2k, k2p, k2_discrete(2))
        assert frac >= 0.9999 and close
        ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
        op = mk.finalize_sweep_plain(u34, sk, k2k, scene.dense_tab, a)
        assert (mk.SHADE_LAUNCHES, mk.FINALIZE_LAUNCHES) == (
            launches[0] + 1, launches[1] + 1)
        frac, close = match_rows(ok, op, disc)
        assert frac >= 0.9999 and close
        sk = ok[:mk.NS]
    assert np.isfinite(sk.cpu().numpy()).all()


def test_sweep_tab_rect_terms_match_twin_expressions(dev):
    """The baked n, bb and cc of every rect equal, bit for bit, what the
    twin's rect branch computes from pb and pc with torch on the card."""
    w = scenes.random_prims(SceneBuilder(), spectral, seed=4, grid=20,
                            n_each=400).build("cpu")
    p = w.prims
    sweep = torch.as_tensor(dense.pack_sweep_np(
        p.ptype.numpy(), p.valid.numpy(), p.pa.numpy(), p.pb.numpy(),
        p.pc.numpy()), device=dev)
    rect = sweep[:, 0] == 2.0
    assert int(rect.sum()) >= 400
    pbx, pby, pbz = sweep[rect, 5], sweep[rect, 6], sweep[rect, 7]
    pcx, pcy, pcz = sweep[rect, 8], sweep[rect, 9], sweep[rect, 10]
    nx = pby * pcz - pbz * pcy
    ny = pbz * pcx - pbx * pcz
    nz = pbx * pcy - pby * pcx
    nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    want = torch.stack([
        nx / nlen, ny / nlen, nz / nlen,
        torch.clamp(pbx * pbx + pby * pby + pbz * pbz, min=1e-20),
        torch.clamp(pcx * pcx + pcy * pcy + pcz * pcz, min=1e-20)], dim=1)
    assert torch.equal(sweep[rect, 11:].view(torch.int32),
                       want.view(torch.int32))
    assert not sweep[~rect, 11:].any()


@pytest.mark.parametrize("recipe,cam,c_lanes,medium,ls,width", [
    ("gem_cornell", "CORNELL_CAMERA", 1, False, 0, 128),
    ("gem_cornell", "CORNELL_CAMERA", 1, False, 1, 128),
    ("gem_cornell", "CORNELL_CAMERA", 1, False, 2, 128),
    ("gem_cornell", "CORNELL_CAMERA", 1, False, 3, 128),
    ("gem_cornell", "CORNELL_CAMERA", 4, False, 2, 128),
    ("fog_cornell", "CORNELL_CAMERA", 1, True, 2, 128),
    ("fog_cornell", "CORNELL_CAMERA", 4, True, 3, 128),
    ("mesh_cornell", "CORNELL_CAMERA", 1, False, 2, 64)])
def test_walk_resident_and_ring_match_plain(dev, monkeypatch, recipe, cam,
                                            c_lanes, medium, ls, width):
    """K12 and K34 against their twins over two chained rounds, with the
    sweep table resident in shared memory (where it fits) and through the
    ring (the budget set one row under the table, so the gem's 352 rows
    cycle three tiles through the three stages; the mesh's 5,152 rows 41
    tiles); the ring's rows equal the resident table's bit for bit. K3 on
    each NEE sample of K12's rows, resident and through the ring too, its
    mask equal to the twin's on every lane. With no light samples K34 walks
    nothing, and must leave no copy of the table in flight."""
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**getattr(scenes, cam), device=dev)
    s = PTSettings(max_bounces=12, light_samples=ls, hwss=c_lanes == 4,
                   medium_aware=medium)
    scene = mk.build_mega_scene(world, cam, dev, s)
    rows = scene.sweep_tab.shape[0]
    budgets = ([rows - 1, mk.SWEEP_RESIDENT_ROWS]
               if rows <= mk.SWEEP_RESIDENT_ROWS
               else [mk.SWEEP_RESIDENT_ROWS])
    assert (len(budgets) == 1) == (recipe == "mesh_cornell")
    a = mk.RoundArgs.make(scene.consts, s, width, width)
    n_pad = -(-width * width // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(6)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, width * width,
                            n_pad, 4)
    disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.S_MSTK0, mk.S_MSTK1,
            mk.O4_BOUNCE_CT, mk.O4_CAMERA_CT]
    k2_disc = k2_discrete(ls) + [mk.O_SCAT, mk.O_MSTK, mk.O_MSTK + 1]
    sk = state
    for _ in range(2):
        u12 = torch.rand((mk.n_u_rows(ls, medium), n_pad), generator=gen,
                         device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        mf = mk.med_feed(scene.med, sk, u12, ls, c_lanes) if medium else None
        k2s, outs, blks = [], [], []
        for budget in budgets:
            monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS", budget)
            k2s.append(mk.shade_sweep(u12, sk, scene, a, None, mf))
            outs.append(mk.finalize_sweep(u34, sk, k2s[0], scene, a))
            blks.append([dense.sweep_any_rows(
                k2s[0], scene.dense_tab, mk.O_NEE + mk.NEE_ROWS * si,
                mk.O_NEE + mk.NEE_ROWS * si + 6,
                live_row=mk.O_NEE + mk.NEE_ROWS * si + 7,
                sweep=scene.sweep_tab) for si in range(ls)])
        torch.cuda.synchronize()
        assert all(torch.equal(k2s[0], x) for x in k2s[1:])
        assert all(torch.equal(outs[0], x) for x in outs[1:])
        for si in range(ls):
            row0 = mk.O_NEE + mk.NEE_ROWS * si
            twin = dense.sweep_any_rows_plain(k2s[0], scene.dense_tab, row0,
                                              row0 + 6, row0 + 7)
            assert all(torch.equal(b[si], twin) for b in blks)
        k2p = mk.shade_sweep_plain(u12, sk, a=a, mf=mf, **mk._tables(scene))
        frac, close = match_rows(k2s[0], k2p, k2_disc)
        assert frac >= 0.9999 and close
        op = mk.finalize_sweep_plain(u34, sk, k2s[0], scene.dense_tab, a)
        frac, close = match_rows(outs[0], op, disc)
        assert frac >= 0.9999 and close
        assert (int((k2s[0][mk.O_SHADOW_CT] > 0).sum()) > 0) == (ls > 0)
        sk = outs[0][:mk.NS]
    assert np.isfinite(sk.cpu().numpy()).all()


@pytest.mark.parametrize("case", ["hex_aperture", "only_direct"])
def test_round_options_kernels_match_plain(dev, case):
    """The respawn's polygon-aperture lens sample (six rounded blades,
    diameter 0.3) and the direct-only cut of the continuation, which no
    recipe camera and no default setting reach: the fused round, K12 and K34
    against their twins over three chained rounds of the chip scene at 2
    samples per pixel, so that lanes respawn within them."""
    world = scenes.chip_scene(SceneBuilder(), spectral).build(dev)
    hexa = case == "hex_aperture"
    cam = make_projective_camera(
        **(scenes.HEX_CAMERA if hexa else scenes.CORNELL_CAMERA), device=dev)
    s = PTSettings(max_bounces=12, light_samples=2, only_direct=not hexa)
    scene = mk.build_mega_scene(world, cam, dev)
    a = mk.RoundArgs.make(scene.consts, s, 128, 128)
    assert a.cam_blades == (6 if hexa else 0) and a.only_direct == (not hexa)
    n_pad = -(-128 * 128 // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(8)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 128 * 128,
                            n_pad, 2)
    disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.O4_BOUNCE_CT,
            mk.O4_CAMERA_CT]
    sf = sk = state
    respawned = 0
    for _ in range(3):
        u = torch.rand((mk.nu_rows(2), n_pad), generator=gen, device=dev)
        of = mk.fused_round(u, sf, scene, a)
        frac, close = match_rows(of, mk.fused_round_plain(
            u, sf, a=a, **mk._tables(scene)),
            disc + [mk.O4_SHADOW_CT, mk.O4_ENV_CT])
        assert frac >= 0.9999 and close
        u12 = torch.rand((mk.n_u_rows(2), n_pad), generator=gen, device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        k2k = mk.shade_sweep(u12, sk, scene, a)
        frac, close = match_rows(k2k, mk.shade_sweep_plain(
            u12, sk, a=a, **mk._tables(scene)), k2_discrete(2))
        assert frac >= 0.9999 and close
        ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
        frac, close = match_rows(ok, mk.finalize_sweep_plain(
            u34, sk, k2k, scene.dense_tab, a), disc)
        assert frac >= 0.9999 and close
        respawned += int(ok[mk.O4_CAMERA_CT].sum()) + int(
            of[mk.O4_CAMERA_CT].sum())
        if not hexa:
            assert float(ok[mk.S_BOUNCE].max()) <= 1.0
        sf, sk = of[:mk.NS], ok[:mk.NS]
    assert respawned > 1000
    assert np.isfinite(sk.cpu().numpy()).all()


@pytest.mark.parametrize("budget", ["resident", "ring"])
def test_split_film_equals_two_prog_film_on_the_gem(dev, monkeypatch, budget):
    """The split round (K1 and K3) renders, from the same uniforms, the
    film of the two-program round (K12 and K34): every closest hit and every
    shadow verdict of a render agree between the routes, K3's one ray a walk
    against K34's two."""
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    world = scenes.gem_cornell(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    s = PTSettings(max_bounces=8, light_samples=2, russian_roulette=True)
    if budget == "ring":
        monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS", 0)
    films = []
    for stepper in (None, "split"):
        gen = torch.Generator(device=dev).manual_seed(12)
        launches = (mk.SHADE_LAUNCHES, dense.ANY_ROWS_LAUNCHES)
        film, profile, _ = render_regen(world, cam, s, 96, 96, 4,
                                        generator=gen, device=dev,
                                        stepper=stepper)
        films.append((film, profile.total_rays))
        assert (mk.SHADE_LAUNCHES > launches[0]) == (stepper is None)
        assert (dense.ANY_ROWS_LAUNCHES > launches[1]) == (stepper == "split")
    assert torch.equal(films[0][0], films[1][0])
    assert films[0][1] == films[1][1]
    assert bool(torch.isfinite(films[0][0]).all())
    assert float(films[0][0][..., 1].mean()) > 0.0


@pytest.mark.parametrize("table,budget", [("chip", "default"),
                                          ("random", "default"),
                                          ("chip", "one_under")])
def test_rows_sweep_kernel_matches_plain(dev, monkeypatch, table, budget):
    """K1 reads the rays from state rows in place and walks the sweep table
    (the chip table's 32 rows resident by default; the random table's 1,120
    rows through the ring by default; the chip table through the ring with
    the budget one row under it); dead lanes read as misses. Its rows equal
    the twin's bit for bit, on an odd lane count (the last block partial)."""
    if table == "chip":
        w = scenes.chip_scene(SceneBuilder(), spectral).build("cpu")
    else:
        w = scenes.random_prims(SceneBuilder(), spectral, seed=2, grid=20,
                                n_each=100).build("cpu")
    p = w.prims
    cols = (p.ptype.numpy(), p.valid.numpy(), p.pa.numpy(), p.pb.numpy(),
            p.pc.numpy())
    tab = torch.as_tensor(dense.pack_prims_np(*cols), device=dev)
    sweep = torch.as_tensor(dense.pack_sweep_np(*cols), device=dev)
    rows = sweep.shape[0]
    assert (rows <= mk.SWEEP_RESIDENT_ROWS) == (table == "chip")
    if budget == "one_under":
        monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS", rows - 1)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = (1 << 16) - 91
    state = torch.rand((mk.NS, n), generator=gen, device=dev)
    state[mk.S_O:mk.S_O + 6] = _rays(n, gen, dev)[:6]
    state[mk.S_ALIVE] = (torch.rand(n, generator=gen, device=dev)
                         < 0.9).float()
    launches = dense.ROWS_LAUNCHES
    k = dense.sweep_closest_rows(state, tab, mk.S_O, mk.S_ALIVE, sweep)
    pl = dense.sweep_closest_rows_plain(state, tab, mk.S_O, mk.S_ALIVE)
    assert dense.ROWS_LAUNCHES == launches + 1
    assert torch.equal(k, pl)
    assert int((k[1] >= 0).sum()) > n // 10
    with pytest.raises(ValueError):
        dense.sweep_closest_rows(state, tab, mk.S_O, mk.S_ALIVE)


def _texfeed_scene(dev, recipe, c_lanes, width):
    medium = recipe == "textured_fog"
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device=dev)
    s = PTSettings(max_bounces=12, light_samples=2, hwss=c_lanes == 4,
                   medium_aware=medium)
    scene = mk.build_mega_scene(world, cam, dev, s)
    a = mk.RoundArgs.make(scene.consts, s, width, width)
    n_pad = -(-width * width // mk.TILE) * mk.TILE
    return cam, scene, a, n_pad


@pytest.mark.parametrize("c_lanes", [1, 4])
@pytest.mark.parametrize("recipe", ["textured_cornell", "textured_fog"])
def test_texfeed_kernels_match_plain(dev, recipe, c_lanes):
    """K1, K2 and K34 of the texture-feed round against their twins over
    three chained rounds of the textured Cornell box, each fed by the
    texture feed of its own hit rows (the kernel's route by the texture
    feed's kernel, the twins' by `tex_feed_plain`); `textured_fog` under
    medium-aware
    settings, K2's and K34's medium instantiations fed the medium feed
    too (its lanes scatter from the second round on)."""
    medium = recipe == "textured_fog"
    cam, scene, a, n_pad = _texfeed_scene(dev, recipe, c_lanes, 128)
    assert scene.tex is not None and not mk.fused_ok(scene)
    assert (scene.med is not None) == medium
    gen = torch.Generator(device=dev).manual_seed(4)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 128 * 128,
                            n_pad, 4)
    sk = sp = state
    disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.S_MSTK0, mk.S_MSTK1,
            mk.O4_BOUNCE_CT, mk.O4_CAMERA_CT]
    k2_disc = k2_discrete(2) + [mk.O_SCAT, mk.O_MSTK, mk.O_MSTK + 1]
    scattered = 0
    for _ in range(3):
        u12 = torch.rand((mk.n_u_rows(2, medium), n_pad), generator=gen,
                         device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        launches = (dense.ROWS_LAUNCHES, mk.K2_LAUNCHES)
        tpk = dense.sweep_closest_rows(sk, scene.dense_tab, mk.S_O,
                                       mk.S_ALIVE, scene.sweep_tab)
        tpp = dense.sweep_closest_rows_plain(sp, scene.dense_tab, mk.S_O,
                                             mk.S_ALIVE)
        assert torch.equal(tpk, dense.sweep_closest_rows_plain(
            sk, scene.dense_tab, mk.S_O, mk.S_ALIVE))
        assert torch.equal(tpk[1], tpp[1])
        hit = tpk[1] >= 0
        assert torch.allclose(tpk[0][hit], tpp[0][hit], rtol=1e-5, atol=0.0)
        tfk = mk.tex_feed(scene.tex, sk, tpk, c_lanes)
        tfp = mk.tex_feed_plain(scene.tex, sp, tpp, c_lanes)
        mfk = mk.med_feed(scene.med, sk, u12, 2, c_lanes) if medium else None
        mfp = mk.med_feed(scene.med, sp, u12, 2, c_lanes) if medium else None
        k2k = mk.shade(u12, sk, tpk, scene, a, tf=tfk, mf=mfk)
        k2p = mk.shade_plain(u12, sp, tpp, scene.prim_tab, scene.mat_tab,
                             scene.light_tab, scene.spec_tab, a, None, tfp,
                             mfp)
        assert (dense.ROWS_LAUNCHES, mk.K2_LAUNCHES) == (launches[0] + 1,
                                                         launches[1] + 1)
        frac, close = match_rows(k2k, k2p, k2_disc)
        assert frac >= 0.9999 and close
        # K2 on the kernels' own inputs against its twin on the same inputs
        frac, close = match_rows(k2k, mk.shade_plain(
            u12, sk, tpk, scene.prim_tab, scene.mat_tab, scene.light_tab,
            scene.spec_tab, a, None, tfk, mfk), k2_disc)
        assert frac >= 0.9999 and close
        ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
        op = mk.finalize_sweep_plain(u34, sp, k2p, scene.dense_tab, a)
        frac, close = match_rows(ok, op, disc)
        assert frac >= 0.9999 and close
        scattered += int(k2k[mk.O_SCAT].sum())
        sk, sp = ok[:mk.NS], op[:mk.NS]
    assert np.isfinite(sk.cpu().numpy()).all()
    assert (scattered > 0) == medium


@pytest.mark.parametrize("c_lanes", [1, 4])
@pytest.mark.parametrize("recipe", ["textured_cornell", "textured_fog"])
def test_tex_feed_kernel_matches_plain(dev, recipe, c_lanes):
    """tex_feed_kernel (csrc/tex_feed.cu) against `tex_feed_plain` run on
    the card on the same state and hit rows, bit for bit (torch.equal, the
    padding rows included), over three chained texture-feed rounds: lanes
    on every prim type (the rects, the sphere, the icosahedron's triangles,
    the disk), on the untextured walls and light (whose index wraps around
    the pair table), lanes that missed and dead lanes; one launch a call."""
    medium = recipe == "textured_fog"
    cam, scene, a, n_pad = _texfeed_scene(dev, recipe, c_lanes, 128)
    assert scene.tex is not None and scene.tex.lut is not None
    gen = torch.Generator(device=dev).manual_seed(9)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 128 * 128,
                            n_pad, 4)
    uvtab, mat2tex = scene.tex.uvtab, scene.tex.mat2tex
    meta = scene.tex.lut["meta"]
    types, untextured, missed = set(), 0, 0
    for _ in range(3):
        u12 = torch.rand((mk.n_u_rows(2, medium), n_pad), generator=gen,
                         device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        tp = dense.sweep_closest_rows(state, scene.dense_tab, mk.S_O,
                                      mk.S_ALIVE, scene.sweep_tab)
        launches = mk.TEX_FEED_LAUNCHES
        tf = mk.tex_feed(scene.tex, state, tp, c_lanes)
        assert mk.TEX_FEED_LAUNCHES == launches + 1
        assert torch.equal(tf, mk.tex_feed_plain(scene.tex, state, tp,
                                                 c_lanes))
        hit = tp[1] >= 0
        pid = tp[1][hit].long()
        types |= set(uvtab[pid, 9].tolist())
        tw = meta[mat2tex[uvtab[pid, 10].long()].long(), 1]
        untextured += int((tw == 0).sum())
        missed += int(((state[mk.S_ALIVE] > 0.5) & ~hit).sum())
        assert (tf[:c_lanes][:, hit] > 0).any()
        assert not tf[:, ~hit].any() and not tf[c_lanes:].any()
        mf = mk.med_feed(scene.med, state, u12, 2, c_lanes) if medium \
            else None
        k2 = mk.shade(u12, state, tp, scene, a, tf=tf, mf=mf)
        state = mk.finalize_sweep(u34, state, k2, scene, a)[:mk.NS]
    assert types == {0.0, 1.0, 2.0, 3.0}
    assert untextured > 0 and missed > 0


def _baked_tex_ids(world, scene):
    """The texture ids whose pair rows the bake writes: those of the
    lambertians the texture feed serves (`_M_TEXF`), as the bake picks
    them."""
    texf = scene.mat_tab[mk._M_TEXF].cpu().numpy()
    tex_id = world.mats.tex_id.cpu().numpy()
    return sorted({max(int(tex_id[i]), 0) for i in range(int(world.mats.count))
                   if texf[i]})


@pytest.mark.parametrize("recipe", ["textured_cornell", "textured_fog",
                                    "textured_sizes"])
def test_tex_lut_bake_kernel_matches_plain(dev, recipe):
    """tex_lut_bake_kernel (csrc/tex_feed.cu) writes the pair table and
    `meta` of `_bake_tex_lut_plain` from the same layout on the same
    device-resident world bit for bit (the f32 bits compared, so signed
    zeros too), one launch a bake: the textured box and the fog box (an 8 x 8 one-layer and a
    64 x 64 four-layer texture among five), and `textured_sizes` (a 1 x 13
    strip, a four-layer texture with a flat-zero layer, a single texel in
    two layers)."""
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device=dev)
    launches = mk.TEX_LUT_LAUNCHES
    scene = mk.build_mega_scene(world, cam, dev)
    assert mk.TEX_LUT_LAUNCHES == launches + 1
    got = scene.tex.lut
    want = mk._bake_tex_lut_plain(world.bank, world.tex, mk._tex_lut_plan(
        mk._layer_tables(world.tex), _baked_tex_ids(world, scene),
        got["res"]), dev)
    assert got["pairs"].shape == want["pairs"].shape
    assert torch.equal(got["pairs"].view(torch.int32),
                       want["pairs"].view(torch.int32))
    assert torch.equal(got["meta"], want["meta"])
    assert all(got[k] == want[k] for k in ("res", "lam_lo", "lam_hi"))
    assert (got["pairs"] > 0).any()
    mk.build_mega_scene(world, cam, dev)
    assert mk.TEX_LUT_LAUNCHES == launches + 2


def test_tex_lut_bake_over_the_cap_launches_nothing(dev, monkeypatch):
    """Over TEX_LUT_MAX_TEXELS texels the layout refuses, and the bake
    leaves the pair table out without a launch."""
    monkeypatch.setattr(mk, "TEX_LUT_MAX_TEXELS", 0)
    world = scenes.textured_sizes(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    launches = mk.TEX_LUT_LAUNCHES
    scene = mk.build_mega_scene(world, cam, dev)
    assert scene.tex is not None and scene.tex.lut is None
    assert mk.TEX_LUT_LAUNCHES == launches
    assert mk._tex_lut_plan(mk._layer_tables(world.tex), _baked_tex_ids(
        world, scene), 512) is None


def test_tex_feed_without_a_table_stays_on_the_chain(dev, monkeypatch):
    """Over TEX_LUT_MAX_TEXELS texels the bake leaves the pair table out,
    and the feed runs `tex_feed_plain`'s `eval_texture` chain: no kernel
    launch."""
    monkeypatch.setattr(mk, "TEX_LUT_MAX_TEXELS", 0)
    cam, scene, a, n_pad = _texfeed_scene(dev, "textured_cornell", 1, 64)
    assert scene.tex.lut is None
    gen = torch.Generator(device=dev).manual_seed(10)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 64 * 64, n_pad,
                            1)
    tp = dense.sweep_closest_rows(state, scene.dense_tab, mk.S_O, mk.S_ALIVE,
                                  scene.sweep_tab)
    launches = mk.TEX_FEED_LAUNCHES
    tf = mk.tex_feed(scene.tex, state, tp, 1)
    assert mk.TEX_FEED_LAUNCHES == launches
    assert torch.equal(tf, mk.tex_feed_plain(scene.tex, state, tp, 1))
    assert (tf[0] > 0).any()


@pytest.mark.parametrize("recipe,cam,c_lanes,medium,budget", [
    ("fog_cornell", "CORNELL_CAMERA", 1, True, "resident"),
    ("fog_cornell", "CORNELL_CAMERA", 4, True, "resident"),
    ("fog_cornell", "CORNELL_CAMERA", 1, True, "ring"),
    ("nested_media", "MEDIUM_CAMERA", 1, True, "resident"),
    ("gem_cornell", "CORNELL_CAMERA", 4, False, "resident"),
    ("gem_cornell", "CORNELL_CAMERA", 1, False, "ring")])
def test_split_and_medium_kernels_match_plain(dev, monkeypatch, recipe, cam,
                                              c_lanes, medium, budget):
    """Three chained rounds, medium-aware or not: K12 and K34 (their medium
    instantiations where `medium`) and the split round's K1, K2, K3 and K4
    against their twins; K3's mask equal to its twin's on every lane; and
    the split round's K2 rows and out rows equal to K12's and K34's bit for
    bit. The walking kernels take the sweep table resident, or through the
    ring with the budget one row under it."""
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    cam = make_projective_camera(**getattr(scenes, cam), device=dev)
    s = PTSettings(max_bounces=12, light_samples=2, hwss=c_lanes == 4,
                   medium_aware=medium)
    scene = mk.build_mega_scene(world, cam, dev, s)
    assert (scene.med is not None) == medium
    if budget == "ring":
        monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS",
                            scene.sweep_tab.shape[0] - 1)
    a = mk.RoundArgs.make(scene.consts, s, 128, 128)
    n_pad = -(-128 * 128 // mk.TILE) * mk.TILE
    gen = torch.Generator(device=dev).manual_seed(4)
    state, _ = mk.mega_init(cam, torch.rand((n_pad, 5), generator=gen,
                                            device=dev), a, 128 * 128,
                            n_pad, 4)
    sk = state
    disc = [mk.S_ALIVE, mk.S_BOUNCE, mk.S_DONE, mk.S_MSTK0, mk.S_MSTK1,
            mk.O4_BOUNCE_CT, mk.O4_CAMERA_CT]
    k2_disc = k2_discrete(2) + [mk.O_SCAT, mk.O_MSTK, mk.O_MSTK + 1]
    scattered = 0
    for _ in range(3):
        u12 = torch.rand((mk.n_u_rows(2, medium), n_pad), generator=gen,
                         device=dev)
        u34 = torch.rand((mk.NU4, n_pad), generator=gen, device=dev)
        mf = mk.med_feed(scene.med, sk, u12, 2, c_lanes) if medium else None
        before = (mk.SHADE_LAUNCHES, mk.FINALIZE_LAUNCHES, mk.K2_LAUNCHES,
                  mk.K4_LAUNCHES, dense.ROWS_LAUNCHES,
                  dense.ANY_ROWS_LAUNCHES)
        k2k = mk.shade_sweep(u12, sk, scene, a, None, mf)
        k2p = mk.shade_sweep_plain(u12, sk, a=a, mf=mf, **mk._tables(scene))
        frac, close = match_rows(k2k, k2p, k2_disc)
        assert frac >= 0.9999 and close
        ok = mk.finalize_sweep(u34, sk, k2k, scene, a)
        op = mk.finalize_sweep_plain(u34, sk, k2k, scene.dense_tab, a)
        frac, close = match_rows(ok, op, disc)
        assert frac >= 0.9999 and close
        # the split round on the same inputs
        tp = dense.sweep_closest_rows(sk, scene.dense_tab, mk.S_O, mk.S_ALIVE,
                                      scene.sweep_tab)
        assert torch.equal(tp, dense.sweep_closest_rows_plain(
            sk, scene.dense_tab, mk.S_O, mk.S_ALIVE))
        k2s = mk.shade(u12, sk, tp, scene, a, None, None, mf)
        assert torch.equal(k2s, k2k)
        blks = []
        for si in range(2):
            row0 = mk.O_NEE + mk.NEE_ROWS * si
            blk = dense.sweep_any_rows(k2s, scene.dense_tab, row0, row0 + 6,
                                       live_row=row0 + 7,
                                       sweep=scene.sweep_tab)
            assert torch.equal(blk, dense.sweep_any_rows_plain(
                k2s, scene.dense_tab, row0, row0 + 6, row0 + 7))
            assert not blk[0][k2s[row0 + 7] <= 0.5].any()
            blks.append(blk)
        os_ = mk.finalize(u34, sk, k2s, blks, scene, a)
        frac, close = match_rows(os_, mk.finalize_plain(u34, sk, k2s, blks,
                                                        a), disc)
        assert frac >= 0.9999 and close
        assert torch.equal(os_, ok)
        after = (mk.SHADE_LAUNCHES, mk.FINALIZE_LAUNCHES, mk.K2_LAUNCHES,
                 mk.K4_LAUNCHES, dense.ROWS_LAUNCHES, dense.ANY_ROWS_LAUNCHES)
        assert [y - x for x, y in zip(before, after)] == [1, 1, 1, 1, 1, 2]
        scattered += int(k2k[mk.O_SCAT].sum())
        sk = ok[:mk.NS]
    assert np.isfinite(sk.cpu().numpy()).all()
    assert (scattered > 0) == (recipe == "fog_cornell")
    # every lane swept when no worth row is named; and no walk without the
    # sweep table
    row0 = mk.O_NEE
    assert torch.equal(
        dense.sweep_any_rows(k2s, scene.dense_tab, row0, row0 + 6,
                             sweep=scene.sweep_tab),
        dense.sweep_any_rows_plain(k2s, scene.dense_tab, row0, row0 + 6))
    with pytest.raises(ValueError, match="sweep"):
        dense.sweep_any_rows(k2s, scene.dense_tab, row0, row0 + 6)


def lt_budgets(scene):
    """The residency budgets of an LT scene's walks: the default, which keeps
    its sweep table resident, and one row under the table (the ring)."""
    rows = int(scene.tabs.sweep_tab.shape[0])
    assert rows <= mk.SWEEP_RESIDENT_ROWS
    return (mk.SWEEP_RESIDENT_ROWS, rows - 1)


@pytest.mark.parametrize("cs", [1, 2])
def test_lt_shade_resident_and_ring_match_plain(dev, monkeypatch, cs):
    """K12-LT and K34-LT v2 over three chained rounds of chip_lens (its
    32-row sweep table) from lanes with a budget of two particles, so that
    lanes die mid-warp and respawn: with the table resident in shared memory
    and through the ring (the budget one row under the table: one short
    tile), their rows equal the twins' bit for bit on every row of the
    kernels' own state, on an odd lane count, and the splats they add to
    the film equal the `index_add_` of the twins' splat rows within rtol
    1e-5."""
    from lt_splat_helpers import splat_film

    lt, s, scene, state = _lt_setup(dev, "chip_lens", "CHIP_LENS_CAMERA", cs,
                                    True)
    film0 = torch.zeros((128 * 128, 3), device=dev)
    unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(10))
    t, a = scene.tabs, scene.a
    n = state.shape[1] - 91
    sk = state[:, :n].contiguous()
    sk[lt.LS_BUDGET] = 2.0
    walking = respawned = 0.0
    budgets = lt_budgets(scene)
    for it in range(3):
        u = unif.round(it, lt.nu_lt(cs), n, dev)
        usp = unif.round(it, lt.NUSP, n, dev)
        qs, outs, films = [], [], []
        for budget in budgets:
            monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS", budget)
            launches = (lt.SHADE_LAUNCHES, lt.FINALIZE_SPAWN_LAUNCHES)
            films.append(torch.zeros_like(film0))
            qs.append(lt.lt_shade(u, sk, scene, films[-1]))
            outs.append(lt.lt_finalize_spawn(u, usp, sk, qs[0], scene,
                                             films[-1]))
            assert (lt.SHADE_LAUNCHES, lt.FINALIZE_SPAWN_LAUNCHES) == (
                launches[0] + 1, launches[1] + 1)
        qp = lt.lt_shade_plain(u, sk, t.dense_tab, t.prim_tab, t.mat_tab,
                               t.spec_tab, a)
        op = lt.lt_finalize_spawn_plain(u, usp, sk, qs[0], t.dense_tab,
                                        t.light_tab, t.spec_tab,
                                        scene.lcdf_tab, a)
        assert all(torch.equal(q, qp) for q in qs)
        assert all(torch.equal(o, op) for o in outs)
        ref = splat_film(film0, [(qp, op, None)], cs, True)
        for f in films:
            torch.testing.assert_close(f, ref, rtol=1e-5, atol=0)
        walking += float(qp[lt.Q_ALIVE].sum())
        if it > 0:
            respawned += float(op[lt.k4_aux_v2(cs)["resp"]].sum())
        sk = outs[0][:lt.NS_LT]
    assert walking > 0 and respawned > 0


def _lt_setup(dev, recipe, cam, cs, spawn_inkernel, lanes=1 << 15):
    from pathtracer_tpu_torch.integrator.lt import LTSettings
    from pathtracer_tpu_torch.kernels import lt_mega as lt

    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**getattr(scenes, cam), device=dev)
    s = LTSettings(max_bounces=8, camera_samples=cs, stratified=True)
    scene = lt.build_lt_scene(world, camera, s, 128, 128, dev,
                              spawn_inkernel)
    state, _ = lt.lt_init(2 * lanes, dev)
    return lt, s, scene, state


@pytest.mark.parametrize("recipe,cam,cs,v2", [
    ("chip_lens", "CHIP_LENS_CAMERA", 1, True),
    ("chip_lens", "CHIP_LENS_CAMERA", 2, True),
    ("chip_lens", "CHIP_LENS_CAMERA", 3, True),
    ("chip_lens", "CHIP_LENS_CAMERA", 1, False),
    ("hdri_blob", "SPHERE_CAMERA", 1, False)])
def test_lt_kernels_match_plain(dev, monkeypatch, recipe, cam, cs, v2):
    """K12-LT and K34-LT (v2: in-kernel spawn; v1: from the torch spawn
    feed) against their twins over three chained rounds from a state of
    dead lanes with budget, each side on its own state, on an odd lane
    count; and K34-LT on the kernels' state equal to its twin on every row,
    its sweep table resident and through the ring; the splats each kernel
    adds to the film equal the `index_add_` of its splat rows within rtol
    1e-5. Three camera samples take the instantiation that walks one shadow
    ray at a time."""
    from lt_splat_helpers import splat_film

    lt, s, scene, state = _lt_setup(dev, recipe, cam, cs, v2)
    film0 = torch.zeros((128 * 128, 3), device=dev)
    unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(9))
    t, a = scene.tabs, scene.a
    n = state.shape[1] - 91
    q_disc, o_disc = lt.discrete_rows(cs, v2)
    aux = lt.k4_aux_v2(cs) if v2 else lt.k4_aux(cs)
    sk = sp = state[:, :n].contiguous()
    spawned = 0.0
    budgets = lt_budgets(scene)
    for it in range(3):
        monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS", budgets[0])
        u = unif.round(it, lt.nu_lt(cs), n, dev)
        launches = (lt.SHADE_LAUNCHES, lt.FINALIZE_SPAWN_LAUNCHES,
                    lt.FINALIZE_LAUNCHES)
        f12 = torch.zeros_like(film0)
        qk = lt.lt_shade(u, sk, scene, f12)
        qp = lt.lt_shade_plain(u, sp, t.dense_tab, t.prim_tab, t.mat_tab,
                               t.spec_tab, a)
        frac, close = match_rows(qk, qp, q_disc)
        assert frac >= 0.9999 and close
        torch.testing.assert_close(
            f12, splat_film(film0, [(qk, None, None)], cs, v2), rtol=1e-5,
            atol=0)
        fk = None
        if v2:
            usp = unif.round(it, lt.NUSP, n, dev)

            def kernel(film):
                return lt.lt_finalize_spawn(u, usp, sk, qk, scene, film)

            def twin(st, q):
                return lt.lt_finalize_spawn_plain(u, usp, st, q, t.dense_tab,
                                                  t.light_tab, t.spec_tab,
                                                  scene.lcdf_tab, a)
        else:
            fk = lt.spawn_feed_for(scene, s, unif, it, n)

            def kernel(film):
                return lt.lt_finalize(u, sk, qk, fk, scene, film)

            def twin(st, q):
                return lt.lt_finalize_plain(u, st, q, fk, t.dense_tab, a)
        outs, films = [], []
        for budget in budgets:
            monkeypatch.setattr(mk, "SWEEP_RESIDENT_ROWS", budget)
            films.append(torch.zeros_like(film0))
            outs.append(kernel(films[-1]))
        ok, op = outs[0], twin(sp, qp)
        assert (lt.SHADE_LAUNCHES, lt.FINALIZE_SPAWN_LAUNCHES,
                lt.FINALIZE_LAUNCHES) == (launches[0] + 1,
                                          launches[1] + 2 * int(v2),
                                          launches[2] + 2 * int(not v2))
        own = twin(sk, qk)
        assert all(torch.equal(o, own) for o in outs)
        ref = splat_film(film0, [(None, own, fk)], cs, v2)
        for f in films:
            torch.testing.assert_close(f, ref, rtol=1e-5, atol=0)
        frac, close = match_rows(ok, op, o_disc)
        assert frac >= 0.9999 and close
        sk, sp = ok[:lt.NS_LT], op[:lt.NS_LT]
        spawned += float(ok[aux["resp"]].sum())
    assert spawned == n
    assert np.isfinite(sk.cpu().numpy()).all()


@pytest.mark.parametrize("recipe,cam,cs", [
    ("gem_cornell", "CORNELL_CAMERA", 1),
    ("gem_cornell", "CORNELL_CAMERA", 2),
    ("hdri_blob", "SPHERE_CAMERA", 1)])
def test_lt_film_splat_in_the_kernels(dev, monkeypatch, recipe, cam, cs):
    """`lt_trace_mega` on the card (the gem by v2 at 1 and 2 camera samples,
    the HDR blob by v1): K12-LT and K34-LT add the valid splats to the film
    themselves, and the film equals the `index_add_` of every splat row the
    rounds wrote within rtol 1e-5 (atomics add in any order); nothing
    index-adds into the film; `splats_added` counts the rows' non-zero
    entries and `splat_slots` every entry."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pathtracer_tpu_torch.integrator.lt import LTSettings
    from pathtracer_tpu_torch.kernels import lt_mega as lt
    from pathtracer_tpu_torch.utils import profile

    from lt_splat_helpers import record_rounds, splat_entries

    class IndexAdds(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.targets = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "index_add" in str(func.overloadpacket):
                self.targets.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    w = 128
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build(dev)
    camera = make_projective_camera(**getattr(scenes, cam), device=dev)
    s = LTSettings(max_bounces=8, camera_samples=cs, stratified=True)
    unif = mk.TorchUniforms(torch.Generator(device=dev).manual_seed(15))
    rounds, stats = record_rounds(monkeypatch), {}
    with profile.tracing() as rec, IndexAdds() as adds:
        film, _ = lt.lt_trace_mega(world, camera, s, w, w, w * w * 4, unif,
                                   device=dev, stats=stats)
        torch.cuda.synchronize()
    rec.resolve()
    v2 = recipe == "gem_cornell"
    assert stats["lt_round"] == ("v2" if v2 else "v1")
    assert (w * w, 3) not in adds.targets and len(rounds) == stats["rounds"]
    pid, xyz = splat_entries(rounds, cs, v2)
    every = torch.zeros_like(film).index_add_(0, pid.long(), xyz)
    torch.testing.assert_close(film, every, rtol=1e-5, atol=0)
    valid = (pid != 0) | (xyz != 0).any(1)
    assert rec.total("splats_added") == int(valid.sum()) > 0
    assert rec.total("splat_slots") == pid.shape[0] == (
        (cs + 2) * rounds[0][1].shape[1] * len(rounds))
    assert float(film[:, 1].sum()) > 0


@pytest.mark.parametrize("recipe", ["gem_cornell", "light_grid_cornell"])
def test_world_intersect_and_regen_launch_dense_sweeps(dev, recipe):
    """World.intersect / intersect_any on a CUDA world launch the dense
    sweep kernels on World.sweep_tab and give the CPU twin's hit record
    (ids and masks equal, attributes within rtol 1e-5), with and without
    the `live` mask; a regen render, whose shadow queries pass the samples'
    worth as the mask, launches the closest sweep once a round and the any
    sweep once a round per light sample."""
    from pathtracer_tpu_torch.renderer.persistent import render_regen

    fn = getattr(scenes, recipe)
    w_cpu = fn(SceneBuilder(), spectral).build("cpu")
    w_gpu = fn(SceneBuilder(), spectral).build(dev)
    gen = torch.Generator().manual_seed(3)
    n = 50_000
    o = torch.rand((n, 3), generator=gen) * 0.8 + 0.1
    d = torch.randn((n, 3), generator=gen)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    t0 = torch.full((n,), 1e-6)
    t1 = torch.where(torch.rand(n, generator=gen) < 0.5, 1e9, 0.7)
    before = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
    hk = w_gpu.intersect(*[x.to(dev) for x in (o, d, t0, t1)])
    bk = w_gpu.intersect_any(*[x.to(dev) for x in (o, d, t0, t1)])
    live = torch.rand(n, generator=gen) < 0.5
    bm = w_gpu.intersect_any(*[x.to(dev) for x in (o, d, t0, t1)],
                             live=live.to(dev))
    assert (dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES) == (
        before[0] + 1, before[1] + 2)
    hp, bp = w_cpu.intersect(o, d, t0, t1), w_cpu.intersect_any(o, d, t0, t1)
    assert torch.equal(bk.cpu(), bp)
    assert torch.equal(bm.cpu(), w_cpu.intersect_any(o, d, t0, t1, live))
    assert torch.equal(bm.cpu(), bp & live)
    for f in ("hit", "prim_id", "material_id", "mat_kind", "instance_id"):
        assert torch.equal(getattr(hk, f).cpu(), getattr(hp, f)), f
    hit = hp.hit
    for f in ("t", "point", "normal", "geo_normal", "uv"):
        torch.testing.assert_close(getattr(hk, f).cpu()[hit],
                                   getattr(hp, f)[hit], rtol=1e-5, atol=1e-5)
    cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
    settings = PTSettings(max_bounces=6, light_samples=2)
    before = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
    stats = {}
    film, profile, _ = render_regen(
        w_gpu, cam, settings, 64, 64, 2, use_megakernel=False, stats=stats,
        generator=torch.Generator(device=dev).manual_seed(1))
    rounds = stats["rounds"]
    assert stats["route"] == "regen" and rounds > 0
    assert dense.CLOSEST_LAUNCHES - before[0] == rounds
    assert dense.ANY_LAUNCHES - before[1] == 2 * rounds
    assert torch.isfinite(film).all() and float(film[..., 1].mean()) > 0.0
    assert profile.camera_rays == 64 * 64 * 2


class _CpuDrawn:
    """A uniform source that draws each block on the CPU from one generator
    and moves it to the lanes' device: a CPU run and a card run of the same
    integrator see the same numbers."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def lanes(self, it, cols, n, device, stream=None):
        return torch.rand((n, cols), generator=self.gen).to(device)

    def permutation(self, it, n, device, stream=None):
        return torch.randperm(n, generator=self.gen).to(device)


@pytest.mark.parametrize("recipe,cam", [("textured_cornell", "TEXTURED_CAMERA"),
                                        ("lens_box", "LENS_BOX_CAMERA")])
def test_lt_trace_launches_dense_sweeps(dev, recipe, cam):
    """The light-tracing wavefront on a CUDA world launches the closest
    sweep once a bounce and the any sweep once for the light vertex and
    once a bounce per camera sample; its film mean and counters match a
    CPU run of the same uniforms within 1e-3."""
    from pathtracer_tpu_torch.integrator.lt import LTSettings, lt_trace

    fn = getattr(scenes, recipe)
    settings = LTSettings(max_bounces=4, camera_samples=2, stratified=True)
    runs = {}
    for where in ("cpu", dev):
        world = fn(SceneBuilder(), spectral).build(where)
        camera = make_projective_camera(**getattr(scenes, cam), device=where)
        before = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
        stats = {}
        film, counters = lt_trace(world, camera, settings, 32, 32, 8192,
                                  _CpuDrawn(5), stats=stats)
        launches = (dense.CLOSEST_LAUNCHES - before[0],
                    dense.ANY_LAUNCHES - before[1])
        runs[str(where)] = (film.cpu(), counters.cpu(), launches,
                            stats["rounds"])
    film_c, cnt_c, launch_c, _ = runs["cpu"]
    film_g, cnt_g, launch_g, rounds = runs[str(dev)]
    assert launch_c == (0, 0) and rounds > 0
    assert launch_g == (rounds, 1 + 2 * rounds)
    assert torch.isfinite(film_g).all() and float(film_g[:, 1].mean()) > 0
    torch.testing.assert_close(film_g.double().mean(0),
                               film_c.double().mean(0), rtol=1e-3, atol=0)
    torch.testing.assert_close(cnt_g, cnt_c, rtol=1e-3, atol=0)


def test_bdpt_trace_launches_dense_sweeps(dev):
    """BDPT on a CUDA world launches the closest sweep once a walk step of
    either subpath and the any sweep once for each strategy family that
    casts shadow rays (environment NEE, connections, lens splats); its
    energies and counters match a CPU run of the same uniforms within
    1e-3, and `render_bdpt` renders a finite, lit film."""
    from pathtracer_tpu_torch.integrator.bdpt import BDPTSettings, bdpt_trace
    from pathtracer_tpu_torch.renderer.bdpt_renderer import render_bdpt

    settings = BDPTSettings(max_depth=4)
    film_uv = torch.rand((4096, 2), generator=torch.Generator().manual_seed(2))
    runs = {}
    for where in ("cpu", dev):
        world = scenes.cornell_box(SceneBuilder(), spectral).build(where)
        camera = make_projective_camera(**scenes.CORNELL_CAMERA,
                                        device=where)
        before = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
        out = bdpt_trace(world, camera, settings, film_uv.to(where),
                         _CpuDrawn(6))
        runs[str(where)] = ([x.cpu() for x in out],
                            (dense.CLOSEST_LAUNCHES - before[0],
                             dense.ANY_LAUNCHES - before[1]))
    (own_c, _, e_c, _, _, cnt_c), launch_c = runs["cpu"]
    (own_g, _, e_g, _, _, cnt_g), launch_g = runs[str(dev)]
    assert launch_c == (0, 0) and launch_g == (6, 3)
    for g, c in ((own_g, own_c), (e_g, e_c)):
        assert float(g.sum()) > 0
        torch.testing.assert_close(g.double().mean(), c.double().mean(),
                                   rtol=1e-3, atol=0)
    torch.testing.assert_close(cnt_g, cnt_c, rtol=1e-3, atol=0)
    film, profile, _ = render_bdpt(
        world, camera, settings, 64, 64, 2,
        generator=torch.Generator(device=dev).manual_seed(1))
    assert torch.isfinite(film).all() and float(film[..., 1].mean()) > 0
    assert profile.light_rays == 64 * 64 * 2


@pytest.mark.parametrize("integrator", ["pt", "lt"])
def test_tracing_on_the_card_changes_no_film(dev, integrator):
    """The textured box path-traced (the texture-feed round) and the gem
    light-traced (the LT megakernel v2), with tracing off and on: the same
    counters and film (bit for bit in PT; the LT kernels' splat atomics
    add in any order), and the lane counters of every round."""
    import collections

    from pathtracer_tpu_torch.integrator.lt import LTSettings
    from pathtracer_tpu_torch.renderer.persistent import render_regen
    from pathtracer_tpu_torch.renderer.splatted import render_splatted
    from pathtracer_tpu_torch.utils import profile

    if integrator == "pt":
        world = scenes.textured_cornell(SceneBuilder(), spectral).build(dev)
        cam = make_projective_camera(**scenes.TEXTURED_CAMERA, device=dev)
        render, s = render_regen, PTSettings(light_samples=2)
    else:
        world = scenes.gem_cornell(SceneBuilder(), spectral).build(dev)
        cam = make_projective_camera(**scenes.CORNELL_CAMERA, device=dev)
        render, s = render_splatted, LTSettings(max_bounces=8)

    def go(stats=None):
        gen = torch.Generator(device=dev).manual_seed(14)
        return render(world, cam, s, 128, 128, 2, generator=gen, device=dev,
                      stats=stats)

    film0, prof0, _ = go()
    stats = {}
    with profile.tracing() as rec:
        film1, prof1, _ = go(stats)
        torch.cuda.synchronize()
    rec.resolve()
    assert prof0 == prof1
    if integrator == "pt":
        assert torch.equal(film0, film1)
    else:  # the kernels' splat atomics add in the order they land
        torch.testing.assert_close(film1, film0, rtol=1e-4, atol=1e-7)
    r = stats["rounds"]
    names = collections.Counter(sp.name for sp in rec.spans)
    assert names["render"] == names["gate"] == names["bake"] == 1
    assert names["wait"] == -(-r // mk.ALIVE_CHECK_EVERY) + 1
    assert names["feed"] == (r if integrator == "pt" else 0)
    # every texture feed of the PT render served by the kernel
    assert rec.total("tex_feeds") == rec.total("tex_feeds_kernel") == (
        r if integrator == "pt" else 0)
    # the PT call's pair table baked once, by the kernel
    assert rec.values("tex_lut_bakes") == rec.values(
        "tex_lut_bakes_kernel") == ([1] if integrator == "pt" else [])
    live, launched = rec.values("lanes_live"), rec.values("lanes_launched")
    assert len(live) == len(launched) == r
    assert all(0 <= a <= b for a, b in zip(live, launched))
    assert live[0] == (128 * 128 if integrator == "pt" else 0)
