"""The plain reference: its films and counters of the scenes without media
are those it rendered before it knew media (a fixed seed, kept in
`fixtures/reference_films.npz`), and its medium transport meets the
analytic cases: Beer-Lambert through an absorbing ball, two overlapping
absorbing balls (which only a tracked set of media gets right), a furnace
in which non-absorbing media are invisible, and phase functions that
integrate to one and are sampled as they evaluate."""

import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ptbench import run as R
from ptbench.reference import loader, lt, media, pt

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SEED = 20261018
FRESNEL_0 = (0.03 / 2.03) ** 2  # a boundary of eta 1.03 at normal incidence
BLACK = {"kind": "constant", "curve": "zero", "strength": 0.0,
         "sampling_probability": 0.0}


@pytest.mark.parametrize("case", ["gem_cornell.pt", "textured_cornell.pt",
                                  "gem_cornell.lt"])
def test_films_without_media_are_unchanged(case):
    """24 x 24 at 2 samples a pixel, as the reference rendered them before
    media: films to rtol 1e-6, counters exact."""
    want = np.load(os.path.join(FIXTURES, "reference_films.npz"))
    config, kind = case.split(".")
    data = loader.load(os.path.join(R.HERE, "configs", config), R.ROOT)
    g = torch.Generator().manual_seed(SEED)
    if kind == "pt":
        film, cnt = pt.render(pt.Scene(data, "cpu"), 24, 24, 2,
                              pt.Settings(12, 1, 2, True), g)
    else:
        film, cnt = lt.render(pt.Scene(data, "cpu"), 24, 24, 2,
                              lt.Settings(8, 1, 1, True), g)
    np.testing.assert_allclose(film.numpy(), want[case], rtol=1e-6, atol=0)
    assert [cnt[k] for k in sorted(cnt)] == want[f"{case}.counters"].tolist()


def _flat(v):
    return {"kind": "flat", "value": v}


def _shell(inner):
    return {"kind": "ggx", "alpha": 0.001, "eta": "eta_b", "eta_outer": "one",
            "kappa": "zero", "permeability": 1.0, "inner_medium": inner}


def _load(tmp_path, name, mediums, prims, materials, camera, curves=None):
    doc = {"name": name, "precision": "float32",
           "curves": {"zero": _flat(0.0), "one": _flat(1.0),
                      "eta_b": _flat(1.03), **(curves or {})},
           "textures": {}, "materials": {
               "emit": {"kind": "diffuse_light", "emission": "one",
                        "bounce": "zero", "side": "dual"}, **materials},
           "mediums": mediums, "prims": prims, "environment": BLACK,
           "camera": {"v_up": [0.0, 0.0, 1.0], "aperture_diameter": 0.0,
                      **camera}}
    d = tmp_path / name
    d.mkdir()
    (d / "scene.json").write_text(json.dumps(doc))
    return loader.load(str(d), R.ROOT)


def _render(data, size, spp, medium_aware=True, max_bounces=8, seed=SEED):
    film, cnt = pt.render(pt.Scene(data, "cpu"), size, size, spp,
                          pt.Settings(max_bounces, 1, 1, False, medium_aware),
                          torch.Generator().manual_seed(seed))
    return film.double(), cnt


# a pinhole on the x axis looking along +x through 0.2 degrees, and a large
# emitter behind x = 30: every pixel's ray runs within 0.1 of the axis, so
# through balls of radius 10 along chords within 1e-4 of their diameter
# (and the 1e-3 offsets off each boundary are as small beside them)
AXIS_CAMERA = {"look_from": [-40.0, 0.0, 0.0], "look_at": [0.0, 0.0, 0.0],
               "vfov_degrees": 0.2, "focal_distance": 40.0}
WALL = {"kind": "rect", "center": [30.0, 0.0, 0.0], "u": [0.0, 20.0, 0.0],
        "v": [0.0, 0.0, 20.0], "material": "emit"}


def _absorber(sa):
    return {"kind": "hg", "g": "zero", "sigma_s": "zero", "sigma_a": sa}


def test_beer_lambert_through_an_absorbing_ball(tmp_path):
    """A ball of radius 10 and sigma_a 0.05 before the emitter: the film is
    the clear film times exp(-2 sigma_a r) and the two interfaces' Fresnel
    transmission, on the same draws; without medium-aware settings the
    ball is a clear dielectric."""
    clear = _load(tmp_path, "clear", {}, [WALL], {}, AXIS_CAMERA)
    ball = _load(tmp_path, "ball", {"A": _absorber("sa")},
                 [WALL, {"kind": "sphere", "center": [0.0, 0.0, 0.0],
                         "radius": 10.0, "material": "shellA"}],
                 {"shellA": _shell("A")}, AXIS_CAMERA, {"sa": _flat(0.05)})
    ref, _ = _render(clear, 8, 256)
    got, _ = _render(ball, 8, 256)
    t2 = (1 - FRESNEL_0) ** 2
    assert float(got.sum() / ref.sum()) == pytest.approx(
        t2 * math.exp(-1.0), rel=1e-3)
    off, _ = _render(ball, 8, 256, medium_aware=False)
    assert float(off.sum() / ref.sum()) == pytest.approx(t2, rel=1e-3)


def test_overlapping_balls_add_their_media(tmp_path):
    """Balls of radius 10 and sigma_a 0.04 and 0.07 at x = -4 and 4: the
    axis crosses each in a chord of 20, both at once in the lens between,
    so exp(-20 (0.04 + 0.07)) through four interfaces. Tracking only the
    medium entered last would read exp(-8 0.04 - 12 0.07) = exp(-1.16)."""
    clear = _load(tmp_path, "clear", {}, [WALL], {}, AXIS_CAMERA)
    both = _load(tmp_path, "both",
                 {"A": _absorber("sa_a"), "B": _absorber("sa_b")},
                 [WALL, {"kind": "sphere", "center": [-4.0, 0.0, 0.0],
                         "radius": 10.0, "material": "shellA"},
                  {"kind": "sphere", "center": [4.0, 0.0, 0.0],
                   "radius": 10.0, "material": "shellB"}],
                 {"shellA": _shell("A"), "shellB": _shell("B")}, AXIS_CAMERA,
                 {"sa_a": _flat(0.04), "sa_b": _flat(0.07)})
    ref, _ = _render(clear, 8, 256)
    got, _ = _render(both, 8, 256)
    assert float(got.sum() / ref.sum()) == pytest.approx(
        (1 - FRESNEL_0) ** 4 * math.exp(-2.2), rel=1e-3)


def _furnace(tmp_path, name, sigma_a):
    """A closed [-1, 1]^3 box of dual-sided emitters of bounce 0 around an
    HG ball (g 0.6, sigma_s 3, sigma_a as given) and a Rayleigh ball, seen
    from inside the box."""
    walls = [{"kind": "rect", "center": c, "u": u, "v": v, "material": "emit"}
             for c, u, v in (
                 ([1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]),
                 ([-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]),
                 ([0, 1.0, 0], [1.0, 0, 0], [0, 0, 1.0]),
                 ([0, -1.0, 0], [1.0, 0, 0], [0, 0, 1.0]),
                 ([0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]),
                 ([0, 0, -1.0], [1.0, 0, 0], [0, 1.0, 0]))]
    camera = {"look_from": [0.0, -0.95, 0.0], "look_at": [0.0, 0.0, 0.0],
              "vfov_degrees": 70.0, "focal_distance": 1.0}
    if name == "empty":
        return _load(tmp_path, name, {}, walls, {}, camera)
    return _load(
        tmp_path, name,
        {"fog": {"kind": "hg", "g": "g", "sigma_s": "ss", "sigma_a": "sa"},
         "haze": {"kind": "rayleigh", "ior": "ior",
                  "corrective_factor": 1.2e7}},
        walls + [{"kind": "sphere", "center": [-0.42, 0.3, 0.0],
                  "radius": 0.4, "material": "shell_fog"},
                 {"kind": "sphere", "center": [0.42, 0.3, 0.0],
                  "radius": 0.4, "material": "shell_haze"}],
        {"shell_fog": _shell("fog"), "shell_haze": _shell("haze")}, camera,
        {"g": _flat(0.6), "ss": _flat(3.0), "sa": _flat(sigma_a),
         "ior": _flat(1.5)})


def test_furnace_hides_media_that_absorb_nothing(tmp_path):
    """In the furnace every direction carries the same radiance, so balls
    that absorb nothing are invisible: the film equals the empty box's on
    the same draws within its noise. With sigma_a 1 the fog ball darkens
    it."""
    empty, _ = _render(_furnace(tmp_path, "empty", 0.0), 16, 32,
                       max_bounces=64)
    clear, cnt = _render(_furnace(tmp_path, "clear", 0.0), 16, 32,
                         max_bounces=64)
    dark, _ = _render(_furnace(tmp_path, "dark", 1.0), 16, 32,
                      max_bounces=64)
    assert cnt["bounce_rays"] > cnt["camera_rays"]  # the balls scatter
    assert float(clear.sum() / empty.sum()) == pytest.approx(1.0, abs=2e-3)
    assert float(dark.sum() / empty.sum()) < 0.95


@pytest.mark.parametrize("g,rayleigh", [(0.0, False), (0.6, False),
                                        (-0.3, False), (0.0, True)])
def test_phase_functions_are_normalised_and_sampled_as_evaluated(g, rayleigh):
    """Each phase integrates to one over the sphere, HG's mean cosine is g,
    and the sampled directions' cosines have the phase's first two moments
    with the phase value as their pdf."""
    def flight(n, u=None):
        return SimpleNamespace(g=torch.full((n,), g, dtype=torch.float64),
                               is_ray=torch.full((n,), rayleigh), u_phase=u)

    c = torch.linspace(-1.0, 1.0, 20001, dtype=torch.float64)
    p = media.phase(flight(c.numel()), c)
    moments = [float(torch.trapezoid(c ** k * p, c)) * 2 * math.pi
               for k in range(3)]
    assert moments[0] == pytest.approx(1.0, rel=1e-4)
    if not rayleigh:
        assert moments[1] == pytest.approx(g, abs=1e-4)
    n = 1 << 18
    u = torch.rand((n, 2), generator=torch.Generator().manual_seed(3),
                   dtype=torch.float64)
    fl = flight(n, u)
    axes = torch.eye(3, dtype=torch.float64)[:, None, :].expand(3, n, 3)
    wo, pdf = media.sample_phase(fl, tuple(axes))  # about the z axis
    assert torch.allclose(wo.norm(dim=-1), torch.ones(n, dtype=torch.float64))
    assert torch.allclose(pdf, media.phase(fl, wo[:, 2]))
    assert float(wo[:, 2].mean()) == pytest.approx(moments[1], abs=4e-3)
    assert float((wo[:, 2] ** 2).mean()) == pytest.approx(moments[2],
                                                          abs=4e-3)
