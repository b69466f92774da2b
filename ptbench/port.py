"""The program under test, driven from the benchmark's data: the scene of a
configuration built through `pathtracer_tpu_torch`'s SceneBuilder and curve
classes (its media with `add_medium_hg` / `add_medium_rayleigh`, named by
GGX boundaries as their inner and outer medium), and one frame of a
traffic mix (one call of the renderer's entry, then the film copied to the
host)."""

from __future__ import annotations

import importlib

import numpy as np

SIDES = {"forward": 0, "reverse": 1, "dual": 2}


def _curve(spectral, spec):
    k = spec["kind"]
    if k == "flat":
        return spectral.FlatCurve(float(spec["value"]))
    if k == "spike":
        return spectral.SpikeCurve(float(spec["center"]), float(spec["left"]),
                                   float(spec["right"]), float(spec["value"]))
    if k == "blackbody":
        return spectral.BlackbodyCurve(float(spec["temperature"]),
                                       float(spec["value"]))
    if k == "cauchy":
        return spectral.CauchyCurve(float(spec["a"]), float(spec["b"]))
    raise ValueError(f"unknown curve kind {k!r}")


def load_kernels():
    """The program's CUDA kernel library, built with nvcc in a checkout's
    first run and loaded from its build directory after."""
    from pathtracer_tpu_torch.kernels import _build

    _build.library()


def build_scene(data, width, height, device):
    """The port's (World, camera) of a `loader.SceneData` on `device`."""
    from pathtracer_tpu_torch.camera.projective import make_projective_camera
    from pathtracer_tpu_torch.core import spectral
    from pathtracer_tpu_torch.parsing.builder import SceneBuilder

    b = SceneBuilder()
    cidx = {n: b.add_curve(_curve(spectral, s), name=n)
            for n, s in data.curves.items()}
    tidx = {n: b.add_texture([(w, cidx[c]) for w, c in layers], name=n)
            for n, layers in data.textures.items()}
    medidx = {}  # the builder's medium ids; 0 is vacuum
    for n, m in data.mediums.items():
        k = m["kind"]
        if k == "hg":  # the builder's g curve is the asymmetry itself
            medidx[n] = b.add_medium_hg(cidx[m["g"]], cidx[m["sigma_s"]],
                                        cidx[m["sigma_a"]], name=n)
        elif k == "rayleigh":
            medidx[n] = b.add_medium_rayleigh(
                cidx[m["ior"]], float(m["corrective_factor"]), name=n)
        else:
            raise ValueError(f"unknown medium kind {k!r}")
    midx = {}
    for n, m in data.materials.items():
        k = m["kind"]
        if k == "lambertian":
            midx[n] = b.add_lambertian(tidx[m["texture"]], name=n)
        elif k == "ggx":
            midx[n] = b.add_ggx(float(m["alpha"]), cidx[m["eta"]],
                                cidx[m["eta_outer"]], cidx[m["kappa"]],
                                permeability=float(m["permeability"]),
                                inner_medium=medidx.get(m.get("inner_medium"),
                                                        0),
                                outer_medium=medidx.get(m.get("outer_medium"),
                                                        0),
                                name=n)
        elif k == "diffuse_light":
            midx[n] = b.add_diffuse_light(cidx[m["emission"]],
                                          cidx[m["bounce"]], SIDES[m["side"]],
                                          name=n)
        else:
            raise ValueError(f"unknown material kind {k!r}")
    for p in data.prims:
        k, mat = p["kind"], midx[p["material"]]
        if k == "rect":
            b.add_rect(p["center"], p["u"], p["v"], mat)
        elif k == "sphere":
            b.add_sphere(p["center"], float(p["radius"]), mat)
        elif k == "disk":
            b.add_disk(p["center"], p["normal"], float(p["radius"]), mat)
        elif k == "mesh":
            b.add_mesh(np.asarray(p["vertices"], np.float64),
                       np.asarray(p["faces"], np.int64), None, mat)
        else:
            raise ValueError(f"unknown prim kind {k!r}")
    env = data.environment
    if env["kind"] != "constant":
        raise ValueError(f"unknown environment kind {env['kind']!r}")
    b.set_environment_constant(cidx[env["curve"]], float(env["strength"]))
    b.env_sampling_probability = float(env["sampling_probability"])
    cam = data.camera
    camera = make_projective_camera(
        cam["look_from"], cam["look_at"], v_up=tuple(cam["v_up"]),
        vfov_degrees=float(cam["vfov_degrees"]),
        focal_distance=float(cam["focal_distance"]),
        aperture_diameter=float(cam["aperture_diameter"]),
        aspect_ratio=width / height, device=device)
    return b.build(device), camera


def settings(traffic):
    """The integrator settings of a traffic mix."""
    if traffic["integrator"] == "pt":
        from pathtracer_tpu_torch.integrator.pt import PTSettings

        return PTSettings(**traffic["settings"])
    from pathtracer_tpu_torch.integrator.lt import LTSettings

    return LTSettings(**traffic["settings"])


def entry(traffic):
    """The renderer entry a traffic mix names ("module:function"), looked
    up at call time."""
    mod, fn = traffic["entry"].split(":")
    return getattr(importlib.import_module(mod), fn)
