"""The benchmark's loader of a configuration's scene file.

`load(config_dir, root)` reads `scene.json` and returns a `SceneData`:
plain numpy and Python values that both sides are built from. It expands
generated geometry once (`ptbench/generators/<name>.py`, found by name) and
decodes the PNG textures itself (`png.decode`), so the program under test
and the plain reference get the same triangles and the same texels.

The scene file's vocabulary: curves `flat` (value), `spike` (center, left,
right, value: value * exp(-|lam - center| / taper)), `blackbody`
(temperature, value: the Planck SPD normalised to its peak, times value)
and `cauchy` (a + b / lam^2); textures as lists of layers, each a weight
map times a curve (`texels` given inline, or a `png` plane: `r`, `g`, `b`,
`a` or `rgb_mean`, sRGB-linearised where `srgb`); materials `lambertian`
(texture), `ggx` (alpha, eta, eta_outer, kappa, permeability, and
optionally `inner_medium` and `outer_medium`, each a medium's name: the
media on the side against and along the geometric normal, vacuum where
absent) and `diffuse_light` (emission, bounce, side); mediums `hg`
(curves g, the Henyey-Greenstein asymmetry itself, sigma_s and sigma_a)
and `rayleigh` (an `ior` curve and a `corrective_factor` number), as
rust-pathtracer's MediumData; prims `rect` (center, half-edges u and v;
normal u x v), `sphere` (center, radius; normal outward), `disk` (center,
normal, radius) and `mesh` (a generator and its params; normal (v1 - v0) x
(v2 - v0)); a constant environment; a projective camera.

Every spec dict is checked against its kind's keys, and every name it
gives against the section it names: an unknown kind, an unknown or missing
key, or a name that is not there raises `ValueError`, so nothing a scene
file says is dropped on either side.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

import numpy as np

from . import png

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


@dataclasses.dataclass
class SceneData:
    name: str
    curves: dict  # name -> spec dict
    textures: dict  # name -> [(texels f32 [H, W], curve name)]
    materials: dict  # name -> spec dict
    prims: list  # rect / sphere / disk spec dicts, and meshes with
    # "vertices" f64 [V, 3] and "faces" i64 [F, 3] filled in
    environment: dict
    camera: dict
    precision: str
    mediums: dict = dataclasses.field(default_factory=dict)  # name -> spec


# kind -> (required keys, optional keys) of each section's spec dicts, the
# key "kind" aside; a name given under a key is checked against a section
CURVES = {"flat": ({"value"}, set()),
          "spike": ({"center", "left", "right", "value"}, set()),
          "blackbody": ({"temperature", "value"}, set()),
          "cauchy": ({"a", "b"}, set())}
MATERIALS = {"lambertian": ({"texture"}, set()),
             "ggx": ({"alpha", "eta", "eta_outer", "kappa", "permeability"},
                     {"inner_medium", "outer_medium"}),
             "diffuse_light": ({"emission", "bounce", "side"}, set())}
MEDIUMS = {"hg": ({"g", "sigma_s", "sigma_a"}, set()),
           "rayleigh": ({"ior", "corrective_factor"}, set())}
PRIMS = {"rect": ({"center", "u", "v", "material"}, set()),
         "sphere": ({"center", "radius", "material"}, set()),
         "disk": ({"center", "normal", "radius", "material"}, set()),
         "mesh": ({"generator", "params", "material"}, set())}
ENVIRONMENTS = {"constant": ({"curve", "strength", "sampling_probability"},
                             set())}
CAMERA_KEYS = {"look_from", "look_at", "v_up", "vfov_degrees",
               "focal_distance", "aperture_diameter"}
LAYERS = {"texels": ({"texels", "curve"}, set()),
          "png": ({"png", "plane", "curve"}, {"srgb"})}
PLANES = ("r", "g", "b", "a", "rgb_mean")
SIDES = ("forward", "reverse", "dual")
SECTIONS = {"curves", "textures", "materials", "mediums", "prims",
            "environment", "camera"}
# what a configuration file says of itself beside the scene
ABOUT = {"name", "source", "reduced", "assumed", "precision"}
NAMED = {"texture": "textures", "eta": "curves", "eta_outer": "curves",
         "kappa": "curves", "emission": "curves", "bounce": "curves",
         "inner_medium": "mediums", "outer_medium": "mediums",
         "g": "curves", "sigma_s": "curves", "sigma_a": "curves",
         "ior": "curves", "material": "materials", "curve": "curves"}


def _keys(where, spec, required, optional=frozenset()):
    if not isinstance(spec, dict):
        raise ValueError(f"{where}: expected an object, got {spec!r}")
    missing = sorted(required - set(spec))
    unknown = sorted(set(spec) - required - set(optional))
    if missing or unknown:
        raise ValueError(f"{where}: missing keys {missing}, unknown keys "
                         f"{unknown}")


def _kind(where, spec, kinds):
    kind = spec.get("kind") if isinstance(spec, dict) else None
    if kind not in kinds:
        raise ValueError(f"{where}: unknown kind {kind!r} (known: "
                         f"{sorted(kinds)})")
    required, optional = kinds[kind]
    _keys(where, spec, required | {"kind"}, optional)


def validate(doc: dict) -> None:
    """Raise ValueError on anything in a scene file that the loader, the
    program's builder or the reference would not take as it is written."""
    _keys("scene", doc, {"name", "curves", "textures", "materials", "prims",
                         "environment", "camera"}, SECTIONS | ABOUT)
    names = {s: set(doc.get(s, {})) for s in SECTIONS
             if isinstance(doc.get(s, {}), dict)}

    def refs(where, spec):
        for key, section in NAMED.items():
            if key in spec and spec[key] not in names[section]:
                raise ValueError(f"{where}: {key} {spec[key]!r} is not in "
                                 f"{section}")

    for n, c in doc["curves"].items():
        _kind(f"curve {n!r}", c, CURVES)
    for n, layers in doc["textures"].items():
        if not isinstance(layers, list) or not layers:
            raise ValueError(f"texture {n!r}: expected a list of layers")
        for i, layer in enumerate(layers):
            where = f"texture {n!r} layer {i}"
            _keys(where, layer, *LAYERS["png" if "png" in layer
                                        else "texels"])
            if "plane" in layer and layer["plane"] not in PLANES:
                raise ValueError(f"{where}: unknown plane {layer['plane']!r}")
            refs(where, layer)
    for section, kinds in (("materials", MATERIALS), ("mediums", MEDIUMS)):
        for n, m in doc.get(section, {}).items():
            where = f"{section[:-1]} {n!r}"
            _kind(where, m, kinds)
            if m.get("side", SIDES[0]) not in SIDES:
                raise ValueError(f"{where}: unknown side {m['side']!r}")
            refs(where, m)
    for i, p in enumerate(doc["prims"]):
        _kind(f"prim {i}", p, PRIMS)
        refs(f"prim {i}", p)
    _kind("environment", doc["environment"], ENVIRONMENTS)
    refs("environment", doc["environment"])
    _keys("camera", doc["camera"], CAMERA_KEYS)
    if doc.get("precision", "float32") != "float32":
        raise ValueError(f"precision {doc['precision']!r}: both sides "
                         f"render in float32")


def srgb_to_linear(x):
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _png_plane(path, plane, srgb):
    img = png.decode(path).astype(np.float32) / np.float32(255.0)
    h, w, ch = img.shape
    rgba = np.ones((h, w, 4), np.float32)
    rgba[..., :ch] = img
    if ch in (1, 2):  # grey fills R, G, B; grey+alpha keeps its alpha
        rgba[..., 3] = img[..., 1] if ch == 2 else 1.0
        rgba[..., 1] = rgba[..., 2] = rgba[..., 0]
    if plane == "rgb_mean":
        x = rgba[..., :3].mean(axis=-1)
    else:
        x = rgba[..., "rgba".index(plane)]
    return (srgb_to_linear(x) if srgb else x).astype(np.float32)


def generator(name):
    """`ptbench/generators/<name>.py`'s module."""
    path = os.path.join(BENCH, "generators", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ptbench_gen_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(config_dir: str, root: str) -> SceneData:
    """The configuration in `config_dir` (its `scene.json`); texture paths
    are relative to the checkout `root`."""
    with open(os.path.join(config_dir, "scene.json")) as f:
        doc = json.load(f)
    validate(doc)
    textures = {}
    for name, layers in doc["textures"].items():
        out = []
        for layer in layers:
            if "texels" in layer:
                w = np.asarray(layer["texels"], np.float32)
            else:
                w = _png_plane(os.path.join(root, layer["png"]),
                               layer["plane"], bool(layer.get("srgb")))
            out.append((w, layer["curve"]))
        textures[name] = out
    prims = []
    for p in doc["prims"]:
        p = dict(p)
        if p["kind"] == "mesh":
            v, f = generator(p["generator"]).generate(**p["params"])
            p["vertices"], p["faces"] = v, f
        prims.append(p)
    return SceneData(doc["name"], doc["curves"], textures, doc["materials"],
                     prims, doc["environment"], doc["camera"],
                     doc.get("precision", "float32"),
                     doc.get("mediums", {}))


def triangles(mesh: dict) -> np.ndarray:
    """A mesh's faces as f32 corners [F, 3, 3], degenerate faces (area
    under 1e-12) left out."""
    v, f = mesh["vertices"], mesh["faces"]
    p = v[f]  # [F, 3, 3] f64
    area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                                axis=-1)
    return p[area >= 1e-12].astype(np.float32)
