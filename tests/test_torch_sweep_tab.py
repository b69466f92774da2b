"""The compact sweep table that the round kernels walk (`dense.pack_sweep_np`,
`MegaScene.sweep_tab`): columns 0..10 are the packed dense table's, and a
rect's baked unit normal, bb and cc carry, bit for bit, what the plain twin's
rect branch (`dense.chunk_t`) computes in f32. The kernels read the baked
values where the twin recomputes them, so equality of the bits is what lets
kernel and twin agree on every lane.

One operation is held to its IEEE result instead of torch's CPU result: the
f32 `torch.sqrt` of this CPU build is off by one ulp on about 0.6% of inputs,
while numpy's, the CUDA `sqrtf` and `torch.sqrt` on a CUDA tensor round
correctly. The expressions here take the square root in f64 and round it to
f32, which is the correctly rounded f32 root; every other operation (multiply,
subtract, add, divide, clamp) is torch f32 on the CPU. The same comparison
with `torch.sqrt` itself runs on the card (tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.geometry.soa import PRIM_RECT
from pathtracer_tpu_torch.integrator.lt import LTSettings
from pathtracer_tpu_torch.kernels import dense
from pathtracer_tpu_torch.kernels import lt_mega as lt
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.parsing import SceneBuilder

RECIPES = [("chip_scene", "CORNELL_CAMERA"), ("gem_cornell", "CORNELL_CAMERA"),
           ("textured_cornell", "TEXTURED_CAMERA"),
           ("fog_cornell", "CORNELL_CAMERA"),
           ("mesh_cornell", "CORNELL_CAMERA")]


def sqrt_rn(x):
    """The correctly rounded f32 square root of an f32 tensor."""
    return torch.sqrt(x.double()).float()


def rect_terms_torch(pb, pc):
    """n (3), bb, cc of rects with half-edges pb, pc [P, 3], by the
    expressions of `dense.chunk_t`'s rect branch, in torch f32."""
    pbx, pby, pbz = (torch.as_tensor(pb[:, i]) for i in range(3))
    pcx, pcy, pcz = (torch.as_tensor(pc[:, i]) for i in range(3))
    nx = pby * pcz - pbz * pcy
    ny = pbz * pcx - pbx * pcz
    nz = pbx * pcy - pby * pcx
    nlen = sqrt_rn(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen
    bb = torch.clamp(pbx * pbx + pby * pby + pbz * pbz, min=1e-20)
    cc = torch.clamp(pcx * pcx + pcy * pcy + pcz * pcz, min=1e-20)
    return torch.stack([nx, ny, nz, bb, cc], dim=1).numpy()


def bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def check_table(sweep, dense_tab):
    """`sweep` [P_pad, 16] against the dense table it was packed beside."""
    assert sweep.dtype == np.float32
    assert sweep.shape == (dense_tab.shape[0], dense.SWEEP_COLS)
    assert np.array_equal(bits(sweep[:, :11]), bits(dense_tab[:, :11]))
    is_rect = (dense_tab[:, 0] == PRIM_RECT) & (dense_tab[:, 1] > 0.5)
    want = rect_terms_torch(dense_tab[:, 5:8], dense_tab[:, 8:11])
    assert np.array_equal(bits(sweep[is_rect, 11:]), bits(want[is_rect]))
    rows = dense_tab[:, 0] != PRIM_RECT
    assert not sweep[rows, 11:].any()
    return int(is_rect.sum())


@pytest.mark.parametrize("recipe,cam", RECIPES, ids=[r for r, _ in RECIPES])
def test_bake_carries_sweep_tab(recipe, cam):
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build("cpu")
    camera = make_projective_camera(**getattr(scenes, cam), device="cpu")
    scene = mk.bake_mega_scene(world, camera, device="cpu")
    assert scene.sweep_tab.device.type == "cpu"
    assert scene.sweep_tab.is_contiguous()
    assert scene.sweep_tab.shape[0] == scene.dense_tab.shape[0]
    assert scene.sweep_tab.shape[0] % dense.PBF == 0
    # every recipe here stands in a box of rect walls
    assert check_table(scene.sweep_tab.numpy(), scene.dense_tab.numpy()) > 0
    # the wrappers' check takes the baked pair and refuses a stale one
    assert mk._sweep_tab(scene) is scene.sweep_tab
    stale = dataclasses.replace(scene, sweep_tab=scene.sweep_tab[:-dense.PBF]
                                .contiguous())
    with pytest.raises(ValueError):
        mk._sweep_tab(stale)


WORLD_RECIPES = ["chip_scene", "gem_cornell", "light_grid_cornell"]


@pytest.mark.parametrize("recipe", WORLD_RECIPES)
def test_world_sweep_tab_packed_once(recipe, monkeypatch):
    """`World.sweep_tab`, the table the dense sweep kernels walk, is
    `pack_sweep_np` of the world's prims bit for bit, beside `dense_tab`,
    and packed once however many queries the world answers."""
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build("cpu")
    packs = []
    real = dense.pack_sweep_np
    monkeypatch.setattr(dense, "pack_sweep_np",
                        lambda *cols: packs.append(1) or real(*cols))
    o = torch.full((16, 3), 0.5)
    d = torch.nn.functional.normalize(torch.randn(
        (16, 3), generator=torch.Generator().manual_seed(2)), dim=1)
    t0, t1 = torch.full((16,), 1e-6), torch.full((16,), 1e9)
    for _ in range(2):
        world.intersect(o, d, t0, t1)
        world.intersect_any(o, d, t0, t1, live=torch.ones(16, dtype=bool))
    assert len(packs) == 1
    sweep = world.sweep_tab
    assert sweep is world.sweep_tab
    assert sweep.device.type == "cpu" and sweep.is_contiguous()
    p = world.prims
    want = real(p.ptype.numpy(), p.valid.numpy(), p.pa.numpy(),
                p.pb.numpy(), p.pc.numpy())
    assert np.array_equal(bits(sweep.numpy()), bits(want))
    check_table(sweep.numpy(), world.dense_tab.numpy())


def lt_bake(recipe, cam, v2):
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build("cpu")
    camera = make_projective_camera(**getattr(scenes, cam), device="cpu")
    return lt.build_lt_scene(world, camera, LTSettings(stratified=True), 64,
                             64, "cpu", v2)


LT_BAKES = [("chip_lens", "CHIP_LENS_CAMERA", True),
            ("hdri_blob", "SPHERE_CAMERA", False)]


@pytest.mark.parametrize("recipe,cam,v2", LT_BAKES,
                         ids=[r for r, _, _ in LT_BAKES])
def test_lt_bake_carries_sweep_tab(recipe, cam, v2):
    """The tables K12-LT and K34-LT walk: chip_lens with its lens proxy (the
    v2 route) and the HDR blob (v1)."""
    scene = lt_bake(recipe, cam, v2)
    assert scene.spawn_inkernel == v2
    t = scene.tabs
    rects = check_table(t.sweep_tab.numpy(), t.dense_tab.numpy())
    assert (rects > 0) == (recipe == "chip_lens")
    assert mk._sweep_tab(t) is t.sweep_tab


def test_random_table_packs_beside_dense():
    """The random table of all four prim types (1,100 prims, 1,120 rows:
    through the ring at the default budget) that the sweep checks walk."""
    p = scenes.random_prims(SceneBuilder(), spectral, seed=1, grid=20,
                            n_each=100).build("cpu").prims
    cols = (p.ptype.numpy(), p.valid.numpy(), p.pa.numpy(), p.pb.numpy(),
            p.pc.numpy())
    sweep = dense.pack_sweep_np(*cols)
    assert sweep.shape == (1120, dense.SWEEP_COLS)
    assert sweep.shape[0] > mk.SWEEP_RESIDENT_ROWS
    assert check_table(sweep, dense.pack_prims_np(*cols)) == 100


def bad_sweep(sweep, how):
    """A sweep table the kernels must not walk: stale (a block of rows
    short), mis-shaped (the dense table's 12 columns), f64, or not
    contiguous."""
    if how == "stale":
        return sweep[:-dense.PBF].contiguous()
    if how == "cols":
        return sweep[:, :12].contiguous()
    if how == "dtype":
        return sweep.double()
    return torch.cat([sweep, sweep], dim=1)[:, ::2]


@pytest.fixture(scope="module")
def lt_scenes():
    return {v2: lt_bake(r, c, v2) for r, c, v2 in LT_BAKES}


@pytest.mark.parametrize("how", ["stale", "cols", "dtype", "strided"])
@pytest.mark.parametrize("wrapper", ["k1", "k3", "lt_v2", "lt_v1",
                                     "dense_closest", "dense_any"])
def test_wrappers_refuse_a_bad_sweep_tab(lt_scenes, wrapper, how):
    """K1 (`dense.sweep_closest_rows`), K3 (`dense.sweep_any_rows`), K34-LT
    v2 and v1 and the dense sweeps (`dense.sweep_closest`, `sweep_any`)
    check the sweep table they would walk before the device branch: on CPU
    tensors, where the twins read the dense table, a stale or mis-shaped
    one is refused, and the baked one gives the twin's rows."""
    if wrapper.startswith("dense"):
        scene = lt_scenes[True].tabs
        gen = torch.Generator().manual_seed(10)
        d = torch.randn((3, 64), generator=gen)
        rays = torch.cat([torch.rand((3, 64), generator=gen),
                          d / torch.linalg.norm(d, dim=0),
                          torch.full((1, 64), 1e-6),
                          torch.full((1, 64), 1e9)]).contiguous()
        fn, twin = ((dense.sweep_closest, dense.sweep_closest_plain)
                    if wrapper == "dense_closest"
                    else (dense.sweep_any, dense.sweep_any_plain))
        bad = bad_sweep(scene.sweep_tab, how)
        with pytest.raises((ValueError, TypeError), match="sweep_tab"):
            fn(rays, scene.dense_tab, bad)
        before = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
        out = fn(rays, scene.dense_tab, scene.sweep_tab)
        assert (dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES) == before
        assert torch.equal(out, twin(rays, scene.dense_tab))
        assert (out[-1] >= 0.5).any()
        return
    if wrapper == "k3":
        scene = lt_scenes[True].tabs
        gen = torch.Generator().manual_seed(9)
        k2 = torch.rand((mk.k2_rows(1), 64), generator=gen)
        k2[mk.O_NEE + 3:mk.O_NEE + 6] -= 0.5
        k2[mk.O_NEE + 6] *= 4.0
        rows = (mk.O_NEE, mk.O_NEE + 6, mk.O_NEE + 7)
        bad = bad_sweep(scene.sweep_tab, how)
        with pytest.raises((ValueError, TypeError), match="sweep_tab"):
            dense.sweep_any_rows(k2, scene.dense_tab, *rows, sweep=bad)
        calls = dense.ANY_ROWS_PLAIN_CALLS
        out = dense.sweep_any_rows(k2, scene.dense_tab, *rows,
                                   sweep=scene.sweep_tab)
        assert dense.ANY_ROWS_PLAIN_CALLS == calls + 1
        assert torch.equal(out, dense.sweep_any_rows_plain(
            k2, scene.dense_tab, *rows))
        assert out.any() and not out[0][k2[rows[2]] <= 0.5].any()
        return
    if wrapper == "k1":
        scene = lt_scenes[True].tabs
        state = torch.zeros((mk.NS, 64))
        bad = bad_sweep(scene.sweep_tab, how)
        with pytest.raises((ValueError, TypeError), match="sweep_tab"):
            dense.sweep_closest_rows(state, scene.dense_tab, mk.S_O,
                                     mk.S_ALIVE, bad)
        out = dense.sweep_closest_rows(state, scene.dense_tab, mk.S_O,
                                       mk.S_ALIVE, scene.sweep_tab)
        assert not (out[1] >= 0).any()
        return
    v2 = wrapper == "lt_v2"
    scene = lt_scenes[v2]
    cs = scene.a.cs
    state, _ = lt.lt_init(64, "cpu")
    n = state.shape[1]
    u = torch.zeros((lt.nu_lt(cs), n))
    k2 = torch.zeros((lt.q2_rows(cs), n))
    stale = dataclasses.replace(scene, tabs=dataclasses.replace(
        scene.tabs, sweep_tab=bad_sweep(scene.tabs.sweep_tab, how)))
    film = torch.zeros((int(scene.a.width) * int(scene.a.height), 3))
    with pytest.raises((ValueError, TypeError), match="sweep_tab"):
        if v2:
            lt.lt_finalize_spawn(u, torch.zeros((lt.NUSP, n)), state, k2,
                                 stale, film)
        else:
            lt.lt_finalize(u, state, k2, torch.zeros((lt.NF, n)), stale,
                           film)


def test_pack_sweep_all_types_and_degenerate_rects():
    """Every prim type, padding rows, invalid prims, and rects whose edges
    vanish (the 1e-20 clamps) or are parallel (a zero cross product)."""
    p = scenes.random_prims(SceneBuilder(), spectral, seed=5, grid=6,
                            n_each=9).build("cpu").prims
    n = int(p.count)
    ptype = p.ptype.numpy()[:n].copy()
    valid = p.valid.numpy()[:n].astype(np.float32).copy()
    pa, pb, pc = (x.numpy()[:n].astype(np.float32).copy()
                  for x in (p.pa, p.pb, p.pc))
    rects = np.flatnonzero(ptype == PRIM_RECT)
    assert len(rects) >= 5
    pb[rects[0]] = 0.0                      # zero edge: bb clamps, n = 0/1e-10
    pc[rects[1]] = 0.0
    pb[rects[2]] = pc[rects[2]]             # parallel edges: zero normal
    pb[rects[3]] = np.float32(1e-12)        # squares underflow the clamp
    valid[rects[4]] = 0.0                   # an invalid rect keeps its terms
    tab = dense.pack_prims_np(ptype, valid, pa, pb, pc)
    sweep = dense.pack_sweep_np(ptype, valid, pa, pb, pc)
    assert sweep.shape[0] > n               # padding rows
    assert not sweep[n:].any()
    is_rect = tab[:, 0] == PRIM_RECT
    is_rect[n:] = False
    want = rect_terms_torch(tab[:, 5:8], tab[:, 8:11])
    assert np.array_equal(bits(sweep[:, :11]), bits(tab[:, :11]))
    assert np.array_equal(bits(sweep[is_rect, 11:]), bits(want[is_rect]))
    assert not sweep[~is_rect, 11:].any()
    assert sweep[rects[0], 14] == np.float32(1e-20)
    assert sweep[rects[1], 15] == np.float32(1e-20)
    assert not sweep[rects[2], 11:14].any()
    assert np.isfinite(sweep).all()


@settings(max_examples=60, deadline=None, database=None)
@given(hnp.arrays(np.float32, (24, 6), elements=st.floats(
    -8.0, 8.0, width=32, allow_nan=False, allow_infinity=False)),
    st.integers(0, 40))
def test_pack_sweep_random_rects_match_twin_bits(edges, shift):
    """Random rects over many magnitudes: the numpy bake and the twin's torch
    expressions round alike."""
    edges = (edges * np.float32(2.0 ** -shift)).astype(np.float32)
    pb, pc = edges[:, :3], edges[:, 3:]
    n = len(edges)
    sweep = dense.pack_sweep_np(np.full(n, PRIM_RECT, np.int32),
                                np.ones(n, np.float32),
                                np.zeros((n, 3), np.float32), pb, pc)
    assert np.array_equal(bits(sweep[:n, 11:]), bits(rect_terms_torch(pb, pc)))


def test_rect_twin_reads_the_same_terms():
    """`chunk_t`'s rect hits are unchanged by feeding it the baked terms:
    the twin's t, computed from n, bb and cc as the kernel reads them from
    the row, equals `chunk_t`'s on every ray."""
    g = np.random.default_rng(3)
    n_p, n_r = 32, 4096
    pb = g.uniform(-0.4, 0.4, (8 * n_p, 3)).astype(np.float32)
    pc = g.uniform(-0.4, 0.4, (8 * n_p, 3)).astype(np.float32)
    # `chunk_t` takes its root with torch.sqrt: keep the rects whose |n| this
    # build's CPU sqrt rounds correctly (see the module note)
    n2 = torch.as_tensor(np.cross(pb, pc))
    n2 = n2[:, 0] * n2[:, 0] + n2[:, 1] * n2[:, 1] + n2[:, 2] * n2[:, 2]
    keep = (torch.sqrt(n2) == sqrt_rn(n2)).numpy()
    pb, pc = pb[keep][:n_p], pc[keep][:n_p]
    assert len(pb) == n_p
    pa = g.uniform(0, 1, (n_p, 3)).astype(np.float32)
    ptype = np.full(n_p, PRIM_RECT, np.int32)
    tab = torch.as_tensor(dense.pack_prims_np(ptype, np.ones(n_p), pa, pb, pc))
    sw = torch.as_tensor(dense.pack_sweep_np(ptype, np.ones(n_p), pa, pb, pc))
    o = torch.as_tensor(g.uniform(-0.2, 1.2, (n_r, 3)).astype(np.float32))
    d = torch.as_tensor(g.normal(size=(n_r, 3)).astype(np.float32))
    cols = [o[:, i:i + 1] for i in range(3)] + [d[:, i:i + 1]
                                                for i in range(3)]
    t_min, t_max = 1e-6, 1e9
    t_twin = dense.chunk_t(dense._chunk_cols(tab), *cols, t_min, t_max)

    def c(k):
        return sw[:, k][None, :]

    ox, oy, oz, dx, dy, dz = cols
    denom = dx * c(11) + dy * c(12) + dz * c(13)
    dok = torch.abs(denom) > 1e-12
    t = ((c(2) - ox) * c(11) + (c(3) - oy) * c(12) + (c(4) - oz) * c(13)
         ) / torch.where(dok, denom, 1.0)
    rx, ry, rz = ox + t * dx - c(2), oy + t * dy - c(3), oz + t * dz - c(4)
    ra = (rx * c(5) + ry * c(6) + rz * c(7)) / c(14)
    rb = (rx * c(8) + ry * c(9) + rz * c(10)) / c(15)
    ok = (dok & (torch.abs(ra) <= 1.0) & (torch.abs(rb) <= 1.0)
          & (t > t_min) & (t < t_max))
    t_row = torch.where(ok, t, float("inf"))
    assert int(torch.isfinite(t_twin).sum()) > 1000
    assert np.array_equal(bits(t_row.numpy()), bits(t_twin.numpy()))
