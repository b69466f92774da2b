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
(texture), `ggx` (alpha, eta, eta_outer, kappa, permeability) and
`diffuse_light` (emission, bounce, side); prims `rect` (center, half-edges
u and v; normal u x v), `sphere`, `disk` (center, normal, radius) and
`mesh` (a generator and its params; normal (v1 - v0) x (v2 - v0)); a
constant environment; a projective camera.
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
                     doc.get("precision", "float32"))


def triangles(mesh: dict) -> np.ndarray:
    """A mesh's faces as f32 corners [F, 3, 3], degenerate faces (area
    under 1e-12) left out."""
    v, f = mesh["vertices"], mesh["faces"]
    p = v[f]  # [F, 3, 3] f64
    area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                                axis=-1)
    return p[area >= 1e-12].astype(np.float32)
