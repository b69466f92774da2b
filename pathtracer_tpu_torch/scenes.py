"""Scenes built in code, written once for any `SceneBuilder` with the same
interface: the port's own, or the JAX package's (which the tests use to
build the identical reference scene). Each recipe takes a fresh builder and
the matching `core.spectral` module and returns the builder, ready to
`build()`.
"""

from __future__ import annotations

import numpy as np

# light sidedness (materials/diffuse_light): emits on +normal / -normal
SIDE_FORWARD, SIDE_REVERSE = 0, 1

# camera keyword arguments for make_projective_camera
CORNELL_CAMERA = dict(look_from=[-1.2, 0.5, 0.5], look_at=[0.5, 0.5, 0.5],
                      vfov_degrees=40.0, focal_distance=1.7,
                      aperture_diameter=0.0, aspect_ratio=1.0)
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
