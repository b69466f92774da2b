"""Scenes built in code, written once for any `SceneBuilder` with the same
interface: the port's own, or the JAX package's (which the tests use to
build the identical reference scene). Each recipe takes a fresh builder and
the matching `core.spectral` module and returns the builder, ready to
`build()`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pathtracer_tpu_torch.parsing.images import (
    load_hdr_rgba,
    load_png_rgba,
    srgb_to_linear,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a synthetic 64x32 RGBE map (data/scenes/hdri_blob_test.toml's texture)
HDR_BLOB = os.path.join(_ROOT, "data", "hdri", "test_blob.hdr")
# data/scenes/cornell_box_textured.toml's textures: an 8x8 checker (RGB)
# and a 64x64 RGBA cloud
CHECKER_PNG = os.path.join(_ROOT, "data", "textures", "checker.png")
CLOUD_PNG = os.path.join(_ROOT, "data", "textures", "test.png")

# light sidedness (materials/diffuse_light): emits on +normal / -normal
SIDE_FORWARD, SIDE_REVERSE = 0, 1

# camera keyword arguments for make_projective_camera
CORNELL_CAMERA = dict(look_from=[-1.2, 0.5, 0.5], look_at=[0.5, 0.5, 0.5],
                      vfov_degrees=40.0, focal_distance=1.7,
                      aperture_diameter=0.0, aspect_ratio=1.0)
# a unit sphere at the origin seen from -x (the HDRI and Sun test scenes)
SPHERE_CAMERA = dict(look_from=[-5.0, 0.0, 0.0], look_at=[0.0, 0.0, 0.0],
                     vfov_degrees=20.0, focal_distance=5.0,
                     aperture_diameter=0.0, aspect_ratio=1.0)
# the checkered back wall of textured_cornell: centre, half-edges u and v
CHECKER_WALL = ([1.0, 0.0, 0.0], [0, 1.0, 0], [0, 0, 1.0])
# data/scenes/cornell_box_textured.toml's camera (a box spanning [-1, 1]^3)
TEXTURED_CAMERA = dict(look_from=[-2.8, 0.0, 0.0], look_at=[0.0, 0.0, 0.0],
                       vfov_degrees=45.0, focal_distance=2.8,
                       aperture_diameter=0.0, aspect_ratio=1.0)
# the Cornell camera with a finite aperture (the light tracer's lens-hit
# scenes put its lens proxy in the scene), and the light-tracing test boxes'
CHIP_LENS_CAMERA = dict(CORNELL_CAMERA, aperture_diameter=0.12)
LENS_BOX_CAMERA = dict(CORNELL_CAMERA, vfov_degrees=45.0,
                       aperture_diameter=0.12)
SPIKE_CAMERA = dict(CORNELL_CAMERA, vfov_degrees=45.0,
                    aperture_diameter=0.01)
# the Cornell camera behind a wide hexagonal aperture with rounded blades:
# the respawn's polygon lens sample
HEX_CAMERA = dict(CORNELL_CAMERA, aperture_diameter=0.3, blades=6,
                  blade_sharpness=0.7)
# a unit medium sphere at the origin filling most of a 60 degree view
MEDIUM_CAMERA = dict(look_from=[-4.0, 0.0, 0.0], look_at=[0.0, 0.0, 0.0],
                     vfov_degrees=60.0, focal_distance=4.0,
                     aperture_diameter=0.0001, aspect_ratio=1.0)
FURNACE_CAMERA = dict(look_from=[0.0, -3.0, 0.0], look_at=[0.0, 0.0, 0.0],
                      vfov_degrees=35.0, focal_distance=3.0,
                      aperture_diameter=0.0, aspect_ratio=1.0)


def cornell_box(b, spectral):
    """Five lambertian walls and a downward diffuse area light in the unit
    box, black constant environment with NEE on lights only."""
    _cornell_walls(b, spectral)
    emit = b.add_curve(spectral.BlackbodyCurve(5500.0, 18.0), name="emit")
    b78 = b.add_curve(spectral.FlatCurve(0.78), name="b78")
    ml = b.add_diffuse_light(emit, b78, SIDE_REVERSE, name="ml")
    b.add_rect([0.5, 0.5, 1.0 - 1e-3], [0.15, 0, 0], [0, 0.15, 0], ml)
    _black_env(b, spectral)
    return b


def light_grid_cornell(b, spectral, n=5):
    """The Cornell box with its ceiling light split into n x n abutting
    rect lights of the same material that tile the same 0.3 x 0.3 square:
    the same radiance field as `cornell_box`, from n² luminaires. At n = 5
    (25 lights) the megakernel's gate refuses it, at n = 4 (16) it takes
    it."""
    _cornell_walls(b, spectral)
    emit = b.add_curve(spectral.BlackbodyCurve(5500.0, 18.0), name="emit")
    b78 = b.add_curve(spectral.FlatCurve(0.78), name="b78")
    ml = b.add_diffuse_light(emit, b78, SIDE_REVERSE, name="ml")
    half = 0.15 / n
    for i in range(n):
        for j in range(n):
            b.add_rect([0.35 + (2 * i + 1) * half, 0.35 + (2 * j + 1) * half,
                        1.0 - 1e-3], [half, 0, 0], [0, half, 0], ml)
    _black_env(b, spectral)
    return b


def cornell_sharp(b, spectral):
    """The Cornell walls lit by a sharp (cosine-power) light disk under the
    ceiling, facing down, with a white disk on the floor: sharp-light
    emission, disk hits and disk light sampling."""
    _cornell_walls(b, spectral)
    emit = b.add_curve(spectral.BlackbodyCurve(4500.0, 30.0), name="emit")
    b78 = b.add_curve(spectral.FlatCurve(0.78), name="b78")
    ms = b.add_sharp_light(emit, b78, SIDE_FORWARD, 6.0, name="ms")
    b.add_disk([0.5, 0.5, 1.0 - 1e-3], [0.0, 0.0, -1.0], 0.2, ms)
    b.add_disk([0.55, 0.45, 1e-3], [0.0, 0.0, 1.0], 0.25,
               b.material_index("mw"))
    _black_env(b, spectral)
    return b


def _black_env(b, spectral):
    zero = b.add_curve(spectral.FlatCurve(0.0), name="zero")
    b.set_environment_constant(zero, 0.0)
    b.env_sampling_probability = 0.0


def _cornell_walls(b, spectral):
    """The Cornell box's five lambertian walls (materials mw, mr, mg)."""
    white = b.add_curve(spectral.FlatCurve(0.73), name="white")
    red = b.add_curve(spectral.SpikeCurve(630.0, 60.0, 60.0, 0.65), name="red")
    green = b.add_curve(spectral.SpikeCurve(540.0, 50.0, 50.0, 0.65),
                        name="green")
    one_px = np.ones((1, 1), np.float32)
    tw = b.add_texture([(one_px, white)], name="tw")
    tr = b.add_texture([(one_px, red)], name="tr")
    tg = b.add_texture([(one_px, green)], name="tg")
    mw = b.add_lambertian(tw, name="mw")
    mr = b.add_lambertian(tr, name="mr")
    mg = b.add_lambertian(tg, name="mg")
    s = 0.5
    b.add_rect([s, s, 0.0], [s, 0, 0], [0, s, 0], mw)       # floor
    b.add_rect([s, s, 2 * s], [s, 0, 0], [0, s, 0], mw)     # ceiling
    b.add_rect([2 * s, s, s], [0, s, 0], [0, 0, s], mw)     # back wall
    b.add_rect([s, 2 * s, s], [s, 0, 0], [0, 0, s], mr)     # left wall
    b.add_rect([s, 0.0, s], [s, 0, 0], [0, 0, s], mg)       # right wall


def icosahedron(center, radius):
    """(vertices [12, 3], faces [20, 3]) of a regular icosahedron."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0],
                  [0, -1, g], [0, 1, g], [0, -1, -g], [0, 1, -g],
                  [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1]],
                 np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius + center
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    return v, f


def chip_scene(b, spectral):
    """The Cornell box plus a near-delta dispersive glass sphere, a rough
    conductor sphere and a 20-triangle icosahedron: 28 prims in one 32-prim
    chunk holding triangles, spheres and rects."""
    cornell_box(b, spectral)
    eta = b.add_curve(spectral.CauchyCurve(1.5, 4200.0), name="eta_glass")
    air = b.add_curve(spectral.FlatCurve(1.0), name="air")
    kz = b.add_curve(spectral.FlatCurve(0.0), name="kz")
    glass = b.add_ggx(0.001, eta, air, kz, permeability=1.0, name="glass")
    eta_m = b.add_curve(spectral.FlatCurve(0.2), name="eta_metal")
    kappa_m = b.add_curve(spectral.FlatCurve(3.0), name="kappa_metal")
    metal = b.add_ggx(0.2, eta_m, air, kappa_m, name="metal")
    b.add_sphere([0.6, 0.3, 0.2], 0.18, glass)
    b.add_sphere([0.6, 0.7, 0.15], 0.15, metal)
    v, f = icosahedron(np.array([0.3, 0.5, 0.12]), 0.12)
    b.add_mesh(v, f, None, b.material_index("mw"))
    return b


def dispersive_furnace(b, spectral, alpha=0.0004):
    """A near-delta dispersive dielectric sphere (diamond-like Cauchy η)
    under a unit constant environment: with hero-wavelength spectral MIS the
    image is uniform."""
    eta = b.add_curve(spectral.CauchyCurve(2.4, 34000.0), name="eta")
    air = b.add_curve(spectral.FlatCurve(1.0), name="air")
    kz = b.add_curve(spectral.FlatCurve(0.0), name="kz")
    mg = b.add_ggx(alpha, eta, air, kz, permeability=1.0, name="mg")
    b.add_sphere([0.0, 0.0, 0.0], 0.8, mg)
    one = b.add_curve(spectral.FlatCurve(1.0), name="one")
    b.set_environment_constant(one, 1.0)
    return b


def random_prims(b, spectral, seed=0, grid=8, n_each=16):
    """A sweep test table with all four prim types: a `grid` x `grid`
    triangle mesh whose neighbours share edges (a height field over the unit
    square), plus `n_each` random spheres, rects and disks, from `seed`."""
    rng = np.random.default_rng(seed)
    one = b.add_curve(spectral.FlatCurve(0.5), name="half")
    m = b.add_lambertian(b.add_texture([(np.ones((1, 1), np.float32), one)]))
    xs = np.linspace(-0.2, 1.2, grid + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = 0.3 + 0.2 * rng.random(gx.shape)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    faces = []
    for i in range(grid):
        for j in range(grid):
            v0 = i * (grid + 1) + j
            v1, v2, v3 = v0 + 1, v0 + grid + 1, v0 + grid + 2
            faces += [[v0, v2, v1], [v1, v2, v3]]
    b.add_mesh(verts, np.asarray(faces), None, m)
    for _ in range(n_each):
        b.add_sphere(rng.uniform(0.0, 1.0, 3), float(rng.uniform(0.03, 0.15)),
                     m)
        b.add_rect(rng.uniform(0.0, 1.0, 3), rng.normal(0, 0.1, 3),
                   rng.normal(0, 0.1, 3), m)
        b.add_disk(rng.uniform(0.0, 1.0, 3), rng.normal(size=3),
                   float(rng.uniform(0.03, 0.15)), m)
    return b


def icosphere(center, radius, subdiv):
    """(vertices, faces) of an icosahedron whose faces are split in four
    `subdiv` times, every vertex pushed onto the sphere: 20 * 4**subdiv
    faces."""
    v, f = icosahedron(np.zeros(3), 1.0)
    verts = [p for p in v]
    for _ in range(subdiv):
        mids = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = np.asarray(nf, np.int64)
    return np.asarray(verts) * radius + np.asarray(center, np.float64), f


def _gem_material(b, spectral):
    """A near-delta dispersive dielectric (diamond-like Cauchy η)."""
    eta = b.add_curve(spectral.CauchyCurve(2.4, 34000.0), name="eta_gem")
    air = b.add_curve(spectral.FlatCurve(1.0), name="air")
    kz = b.add_curve(spectral.FlatCurve(0.0), name="kz")
    return b.add_ggx(0.001, eta, air, kz, permeability=1.0, name="gem")


def gem_cornell(b, spectral, subdiv=2):
    """The Cornell box around a faceted dispersive gem: an icosphere split
    twice (320 triangles; 326 prims in 11 chunks of 32). It stands in for
    the JAX package's gem benchmark scene, whose OBJ and curve library are
    not in the repository; more than 4 chunks, so it rides the two-program
    round."""
    cornell_box(b, spectral)
    v, f = icosphere([0.55, 0.5, 0.26], 0.25, subdiv)
    b.add_mesh(v, f, None, _gem_material(b, spectral))
    return b


def mesh_cornell(b, spectral):
    """The gem split four times (5,120 triangles, 161 chunks, more than
    1,024 prims), standing in for the arrangement benchmark scene."""
    return gem_cornell(b, spectral, subdiv=4)


def _rgb_basis(b, spectral):
    """Three in-code R, G, B basis curves (the parser's srgb_* curves live
    in the curve library, which is not in the repository)."""
    return [b.add_curve(spectral.SpikeCurve(lam, lt, rt, 1.0), name=name)
            for name, lam, lt, rt in (("basis_r", 610.0, 40.0, 60.0),
                                      ("basis_g", 545.0, 40.0, 40.0),
                                      ("basis_b", 455.0, 50.0, 40.0))]


def _white_sphere(b, spectral, albedo):
    one_px = np.ones((1, 1), np.float32)
    c = b.add_curve(spectral.FlatCurve(albedo), name="white_sphere")
    m = b.add_lambertian(b.add_texture([(one_px, c)], name="white_tex"),
                         name="white")
    b.add_sphere([0.0, 0.0, 0.0], 1.0, m)


def _hdr_env(b, spectral, planes, imp_w, imp_h, p_env):
    curves = _rgb_basis(b, spectral)
    tex = b.add_texture(list(zip(planes, curves)), name="env_map")
    b.set_environment_hdr(tex, 1.0, imp_w, imp_h)
    b.env_sampling_probability = p_env


def hdri_blob(b, spectral):
    """`data/hdri/test_blob.hdr` as a 3-layer HDR environment with a 64x32
    importance map around a white Lambertian unit sphere,
    env_sampling_probability 0.9 (data/scenes/hdri_blob_test.toml minus its
    curve library)."""
    _white_sphere(b, spectral, 0.78)
    img = load_hdr_rgba(HDR_BLOB)
    _hdr_env(b, spectral, [img[..., k] for k in range(3)], 64, 32, 0.9)
    return b


def hdr_furnace(b, spectral):
    """A constant-valued 32x16 HDR map (with a 32x16 importance map) around
    a unit-albedo sphere: sphere pixels must equal direct-environment pixels
    in expectation (tests/test_kernels_pallas.py's HDR furnace)."""
    _white_sphere(b, spectral, 1.0)
    ones = np.ones((16, 32), np.float32)
    _hdr_env(b, spectral, [ones, ones, ones], 32, 16, 1.0)
    return b


def sun_sphere(b, spectral):
    """A Sun environment (strength 4, direction (0.3, 0.2, 1), angular
    diameter 0.6) over a white Lambertian unit sphere."""
    _white_sphere(b, spectral, 0.78)
    one = b.add_curve(spectral.FlatCurve(1.0), name="one")
    b.set_environment_sun(one, 4.0, [0.3, 0.2, 1.0], 0.6)
    b.env_sampling_probability = 1.0
    return b


def _texture1(b, path, curve, name):
    """The parser's Texture1: the linearised mean of a PNG's R, G and B
    over one curve."""
    img = load_png_rgba(path)
    return b.add_texture([(srgb_to_linear(img[..., :3].mean(axis=-1)),
                           curve)], name=name)


def _texture4(b, path, curves, name):
    """The parser's Texture4: a PNG's linearised R, G, B planes and its
    alpha plane (as stored), one curve each."""
    img = load_png_rgba(path)
    planes = [srgb_to_linear(img[..., k]) for k in range(3)] + [img[..., 3]]
    return b.add_texture(list(zip(planes, curves)), name=name)


def textured_cornell(b, spectral):
    """data/scenes/cornell_box_textured.toml without its curve library: the
    [-1, 1]^3 box with the 8x8 `checker.png` back wall (Texture1 over a flat
    white curve), the 64x64 RGBA `test.png` floor (Texture4: three
    linearised planes over in-code R, G, B basis curves, alpha over a flat
    zero curve), 1x1 white ceiling, red and green walls and a reverse-sided
    ceiling light. Beside the TOML's rects, a sphere (equirect uv), an
    icosahedron (barycentric uv) and a disk (uv (0, 0)) carry small
    multi-texel textures of their own: 28 prims in one 32-prim chunk."""
    white = b.add_curve(spectral.FlatCurve(0.73), name="white")
    red = b.add_curve(spectral.SpikeCurve(630.0, 60.0, 60.0, 0.65), name="red")
    green = b.add_curve(spectral.SpikeCurve(540.0, 50.0, 50.0, 0.65),
                        name="green")
    zero = b.add_curve(spectral.FlatCurve(0.0), name="zero")
    one_px = np.ones((1, 1), np.float32)
    mw = b.add_lambertian(b.add_texture([(one_px, white)], name="tw"),
                          name="mw")
    mr = b.add_lambertian(b.add_texture([(one_px, red)], name="tr"),
                          name="mr")
    mg = b.add_lambertian(b.add_texture([(one_px, green)], name="tg"),
                          name="mg")
    checker = b.add_lambertian(_texture1(b, CHECKER_PNG, white, "checker"),
                               name="checker")
    cloud = b.add_lambertian(
        _texture4(b, CLOUD_PNG, _rgb_basis(b, spectral) + [zero], "cloud"),
        name="cloud")
    emit = b.add_curve(spectral.BlackbodyCurve(5500.0, 18.0), name="emit")
    b78 = b.add_curve(spectral.FlatCurve(0.78), name="b78")
    light = b.add_diffuse_light(emit, b78, SIDE_REVERSE, name="light")
    b.add_rect([0.0, 0.0, 0.95], [0.35, 0, 0], [0, 0.35, 0], light)
    b.add_rect(*CHECKER_WALL, checker)                              # back
    b.add_rect([0.0, 0.0, -1.0], [1.0, 0, 0], [0, 1.0, 0], cloud)   # floor
    b.add_rect([0.0, 0.0, 1.0], [1.0, 0, 0], [0, 1.0, 0], mw)       # ceiling
    b.add_rect([0.0, 1.0, 0.0], [0, 0, 1.0], [1.0, 0, 0], mr)
    b.add_rect([0.0, -1.0, 0.0], [0, 0, 1.0], [1.0, 0, 0], mg)
    # stripes in u and v: 8 x 4 texels, two layers
    u_stripes = np.tile((np.arange(8) % 2).astype(np.float32), (4, 1))
    v_stripes = np.tile((np.arange(4) % 2)[:, None].astype(np.float32), (1, 8))
    stripes = b.add_lambertian(b.add_texture(
        [(0.2 + 0.6 * u_stripes, white), (0.5 * v_stripes, red)],
        name="stripes"), name="stripes")
    b.add_sphere([0.35, -0.4, -0.62], 0.38, stripes)
    ramp = np.linspace(0.1, 0.9, 16, dtype=np.float32).reshape(4, 4)
    tiles = b.add_lambertian(b.add_texture([(ramp, green), (ramp.T, white)],
                                           name="tiles"), name="tiles")
    v, f = icosahedron(np.array([0.2, 0.45, -0.7]), 0.3)
    b.add_mesh(v, f, None, tiles)
    dots = b.add_lambertian(b.add_texture(
        [(np.array([[0.8, 0.1], [0.1, 0.8]], np.float32), white)],
        name="dots"), name="dots")
    b.add_disk([0.7, 0.4, 0.4], [-1.0, 0.0, 0.0], 0.22, dots)
    b.set_environment_constant(zero, 0.0)
    b.env_sampling_probability = 0.0
    return b


def textured_sun(b, spectral):
    """The 8x8 `checker.png` (Texture1) on a unit sphere under the Sun of
    `sun_sphere`: the texture feed beside the environment feed."""
    white = b.add_curve(spectral.FlatCurve(0.78), name="white")
    m = b.add_lambertian(_texture1(b, CHECKER_PNG, white, "checker"),
                         name="checker")
    b.add_sphere([0.0, 0.0, 0.0], 1.0, m)
    one = b.add_curve(spectral.FlatCurve(1.0), name="one")
    b.set_environment_sun(one, 4.0, [0.3, 0.2, 1.0], 0.6)
    b.env_sampling_probability = 1.0
    return b


def textured_sizes(b, spectral):
    """`cornell_box` holding four uv-textured lambertians of unequal sizes,
    the pair-table bake's own cases: a 1 x 13 strip (one layer) on a
    sphere, a 3 x 5 four-layer texture whose last layer has the flat-zero
    curve (and whose first holds -0.0 and 0.0 weights) on the floor, a
    9 x 7 two-layer texture on a disk and a single texel in two layers on a
    second sphere."""
    cornell_box(b, spectral)
    white, red, green, zero = (b.curve_index(n) for n in
                               ("white", "red", "green", "zero"))
    rng = np.random.default_rng(21)

    def weights(h, w):
        return rng.uniform(0.05, 0.95, (h, w)).astype(np.float32)

    quad = weights(3, 5)
    quad[0, :2] = (-0.0, 0.0)
    textures = [
        [(weights(1, 13), white)],
        [(quad, red), (weights(3, 5), green), (weights(3, 5), white),
         (weights(3, 5), zero)],
        [(weights(9, 7), green), (weights(9, 7), red)],
        [(weights(1, 1), white), (weights(1, 1), red)]]
    mats = [b.add_lambertian(b.add_texture(layers, name=f"sizes{i}"),
                             name=f"sizes{i}")
            for i, layers in enumerate(textures)]
    b.add_sphere([0.3, 0.3, 0.2], 0.18, mats[0])
    b.add_rect([0.5, 0.5, 2e-3], [0.45, 0, 0], [0, 0.45, 0], mats[1])
    b.add_disk([0.95, 0.5, 0.5], [-1.0, 0.0, 0.0], 0.3, mats[2])
    b.add_sphere([0.65, 0.7, 0.25], 0.2, mats[3])
    return b


def checker_tiles(film_y, camera):
    """Whether `textured_cornell`'s checker wall is resolved in a film (the
    JAX package's tests/test_render_textured.py check): each pixel's centre
    ray meets the wall plane at the rect's uv; over the pixels that see the
    wall away from its rim and more than a quarter texel from a tile edge,
    -> (mean Y over odd tiles, mean Y over even tiles, pixel count)."""
    h, w = film_y.shape
    dev = camera.origin.device
    pix = torch.arange(h * w, device=dev)
    fu = ((pix % w).float() + 0.5) / w
    fv = (torch.div(pix, w, rounding_mode="floor").float() + 0.5) / h
    half = torch.full_like(fu, 0.5)
    o, d, _ = camera.get_ray(fu, fv, half, half)
    o, d = o.cpu().numpy(), d.cpu().numpy()
    pa, pb, pc = (np.asarray(x, np.float64) for x in CHECKER_WALL)
    t = (pa[0] - o[:, 0]) / d[:, 0]
    rel = o + t[:, None] * d - pa
    uu = 0.5 * (rel @ pb / (pb @ pb) + 1.0)
    vv = 0.5 * (rel @ pc / (pc @ pc) + 1.0)
    on_wall = (t > 0) & (np.abs(uu - 0.5) < 0.49) & (np.abs(vv - 0.5) < 0.49)
    th, tw = load_png_rgba(CHECKER_PNG).shape[:2]
    tu, tv = uu * tw, vv * th
    interior = ((np.abs(tu - np.round(tu)) > 0.25)
                & (np.abs(tv - np.round(tv)) > 0.25))
    odd = ((np.floor(tu) + np.floor(tv)) % 2).astype(bool)
    sel = on_wall & interior
    img = film_y.reshape(-1).cpu().numpy()
    return (float(img[sel & odd].mean()), float(img[sel & ~odd].mean()),
            int(sel.sum()))


def _lens_proxy(b, cam):
    """The camera's lens proxy disk (kind 2) in the scene, so that light
    paths can hit the lens."""
    look_from = np.asarray(cam["look_from"], np.float64)
    w = np.asarray(cam["look_at"], np.float64) - look_from
    b.add_camera_surface(0, look_from, w / np.linalg.norm(w),
                         cam["aperture_diameter"] / 2.0)


def chip_lens(b, spectral):
    """The chip scene seen through CHIP_LENS_CAMERA's finite aperture, with
    the lens proxy in the scene: the light tracer's direct lens hits,
    MIS-paired with its lens connections."""
    chip_scene(b, spectral)
    _lens_proxy(b, CHIP_LENS_CAMERA)
    return b


def _white_box(b, spectral, emit_curve, walls):
    """The unit box of the JAX package's light-tracing tests: white
    lambertian rects (`walls` of floor, ceiling, back, left, right) and a
    downward diffuse light under the ceiling."""
    white = b.add_curve(spectral.FlatCurve(0.7), name="white")
    emit = b.add_curve(emit_curve, name="emit")
    b78 = b.add_curve(spectral.FlatCurve(0.78), name="b78")
    zero = b.add_curve(spectral.FlatCurve(0.0), name="zero")
    tw = b.add_texture([(np.ones((1, 1), np.float32), white)], name="tw")
    mw = b.add_lambertian(tw, name="mw")
    ml = b.add_diffuse_light(emit, b78, SIDE_REVERSE, name="ml")
    s = 0.5
    for c, eu, ev in (([s, s, 0.0], [s, 0, 0], [0, s, 0]),
                      ([s, s, 2 * s], [s, 0, 0], [0, s, 0]),
                      ([2 * s, s, s], [0, s, 0], [0, 0, s]),
                      ([s, 2 * s, s], [s, 0, 0], [0, 0, s]),
                      ([s, 0.0, s], [s, 0, 0], [0, 0, s]))[:walls]:
        b.add_rect(c, eu, ev, mw)
    b.add_rect([s, s, 2 * s - 1e-3], [0.2, 0, 0], [0, 0.2, 0], ml)
    b.set_environment_constant(zero, 0.0)
    b.env_sampling_probability = 0.0
    return b


def lens_box(b, spectral):
    """tests/test_render_lt.py's lens-proxy scene: the white box lit by a
    flat 40 emitter, seen through LENS_BOX_CAMERA's 0.12 aperture with the
    lens proxy in the scene."""
    _white_box(b, spectral, spectral.FlatCurve(40.0), 5)
    _lens_proxy(b, LENS_BOX_CAMERA)
    return b


def spike_box(b, spectral):
    """tests/test_lt_mega.py's spike-emission box: floor, ceiling and back
    wall under a light whose spectrum is one narrow spike at 460 nm, so a
    wrong emission-λ inversion moves the film's chromaticity."""
    return _white_box(b, spectral, spectral.SpikeCurve(460.0, 8.0, 8.0, 30.0),
                      3)


def _boundary(b, spectral, inner_medium, name):
    """A near-index-matched smooth dielectric boundary (η 1.03 inside, 1
    outside, fully permeable) around `inner_medium`, vacuum outside. η of
    exactly 1 would make the transmission half-vector degenerate."""
    eta = b.add_curve(spectral.FlatCurve(1.03), name="eta_boundary")
    air = b.add_curve(spectral.FlatCurve(1.0), name="air")
    kz = b.add_curve(spectral.FlatCurve(0.0), name="kz")
    return b.add_ggx(0.001, eta, air, kz, permeability=1.0,
                     inner_medium=inner_medium, outer_medium=0, name=name)


def _unit_env(b, spectral):
    one = b.add_curve(spectral.FlatCurve(1.0), name="one")
    b.set_environment_constant(one, 1.0)
    b.env_sampling_probability = 1.0


def medium_sphere(b, spectral, sigma_s, sigma_a, g):
    """A unit sphere of a homogeneous HG medium behind a near-index-matched
    boundary, under a unit constant environment."""
    med = b.add_medium_hg(
        b.add_curve(spectral.FlatCurve(g), name="g"),
        b.add_curve(spectral.FlatCurve(sigma_s), name="ss"),
        b.add_curve(spectral.FlatCurve(sigma_a), name="sa"), name="fog")
    b.add_sphere([0.0, 0.0, 0.0], 1.0, _boundary(b, spectral, med, "shell"))
    _unit_env(b, spectral)
    return b


def absorbing_sphere(b, spectral):
    """σ_s = 0, σ_a = 0.5: a ray through the centre keeps exp(-1) of the
    environment's radiance (Beer-Lambert over the 2-unit chord)."""
    return medium_sphere(b, spectral, 0.0, 0.5, 1.0)


def scattering_furnace(b, spectral):
    """σ_s = 1, σ_a = 0, isotropic: a pure scatterer in a unit furnace
    conserves energy, so the sphere is invisible."""
    return medium_sphere(b, spectral, 1.0, 0.0, 0.0)


NESTED_SIGMA_A = (0.4, 0.7)


def nested_media(b, spectral):
    """Two absorbing media in overlapping unit spheres (centres at x = -0.4
    and 0.4, vacuum outside both): a ray along x sees each 2-unit chord in
    full, exp(-2 σ_A - 2 σ_B), with both media active in the lens-shaped
    overlap. Only a tracked stack of media gets that right; tracking the
    innermost medium alone gives exp(-0.8 σ_A - 1.2 σ_B)."""
    g = b.add_curve(spectral.FlatCurve(0.0), name="g")
    ssz = b.add_curve(spectral.FlatCurve(0.0), name="ssz")
    for tag, sa, x in zip("AB", NESTED_SIGMA_A, (-0.4, 0.4)):
        med = b.add_medium_hg(
            g, ssz, b.add_curve(spectral.FlatCurve(sa), name=f"sa{tag}"),
            name=tag)
        b.add_sphere([x, 0.0, 0.0], 1.0,
                     _boundary(b, spectral, med, f"shell{tag}"))
    _unit_env(b, spectral)
    return b


def _fog_and_haze(b, spectral, fog_centre, fog_radius, haze_centre,
                  haze_radius):
    """`fog_cornell`'s two media, each in a ball behind a near-index-matched
    boundary: the forward-scattering HG fog (g 0.6, σ_a 0.3, σ_s = 1.5 +
    6e5 / λ²) and the Rayleigh haze (σ_s ∝ λ⁻⁴)."""
    fog = b.add_medium_hg(
        b.add_curve(spectral.FlatCurve(0.6), name="fog_g"),
        b.add_curve(spectral.CauchyCurve(1.5, 600000.0), name="fog_ss"),
        b.add_curve(spectral.FlatCurve(0.3), name="fog_sa"), name="fog")
    haze = b.add_medium_rayleigh(
        b.add_curve(spectral.FlatCurve(1.5), name="haze_ior"), 1.2e7,
        name="haze")
    b.add_sphere(fog_centre, fog_radius,
                 _boundary(b, spectral, fog, "fog_shell"))
    b.add_sphere(haze_centre, haze_radius,
                 _boundary(b, spectral, haze, "haze_shell"))
    return b


def fog_cornell(b, spectral):
    """The Cornell box holding two overlapping balls of participating media
    behind near-index-matched boundaries: a forward-scattering HG fog
    (g 0.6, σ_a 0.3, σ_s = 1.5 + 6e5 / λ², so the four hero-wavelength
    lanes differ) in the middle of the box, and a Rayleigh medium (σ_s ∝
    λ⁻⁴) in a ball around the ceiling light, so that a scatter inside it
    sees the light unoccluded through the medium. The balls overlap between
    z = 0.7 and 0.85, where the tracked stack is two deep. It stands in for
    a Cornell box with media whose scene file is not in the repository."""
    cornell_box(b, spectral)
    return _fog_and_haze(b, spectral, [0.5, 0.5, 0.55], 0.3, [0.5, 0.5, 1.0],
                         0.3)


def textured_fog(b, spectral):
    """`textured_cornell` holding `fog_cornell`'s two media, scaled to its
    [-1, 1]^3 box: the HG fog in a ball of radius 0.5 left of the middle
    (clear of the textured sphere, icosahedron and disk) and the Rayleigh
    haze in a ball of radius 0.55 around the whole ceiling light,
    overlapping between z = 0.45 and 0.7. Under medium-aware settings the texture-feed
    round's K2 then takes the texture feed and the medium feed together."""
    textured_cornell(b, spectral)
    return _fog_and_haze(b, spectral, [-0.2, 0.0, 0.2], 0.5, [0.0, 0.0, 1.0],
                         0.55)
