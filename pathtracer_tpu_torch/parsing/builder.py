"""SceneBuilder (counterpart of `parsing/builder.py`) for every scene of the
path-tracing and light-tracing megakernels' gates.

It accumulates curves, layered textures, lambertian / GGX / diffuse-light /
sharp-light materials, spheres, rects, disks, world-space triangle meshes
and a Constant, Sun or HDR environment, then bakes them with numpy into the
fields `world_from_numpy` takes. The arrays equal the JAX builder's array
for array (for Sun and HDR, equal to what the JAX parser's
`_build_environment` sets). Transforms and mesh instancing raise
`NotImplementedError` naming ROADMAP §1 item 13 (the parser). HG and
Rayleigh media are table rows (id 0 is vacuum) that GGX boundaries name as
their inner and outer medium.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.core.bounds import EXTENDED_VISIBLE_RANGE
from pathtracer_tpu_torch.geometry.soa import (
    PRIM_DISK,
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
)
from pathtracer_tpu_torch.materials.tables import (
    MAT_DIFFUSE_LIGHT,
    MAT_GGX,
    MAT_LAMBERTIAN,
    MAT_PASSTHROUGH,
    MAT_SHARP_LIGHT,
)
from pathtracer_tpu_torch.mediums.tables import (
    MED_HG,
    MED_RAYLEIGH,
    MED_VACUUM,
)
from pathtracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pathtracer_tpu_torch.world.environment import (
    constant_env_numpy,
    hdr_env_numpy,
    sun_env_numpy,
)
from pathtracer_tpu_torch.world.importance_map import bake_importance_tables
from pathtracer_tpu_torch.world.world import World, world_from_numpy

_PAD = 16
_NOT_PORTED = "not ported yet (ROADMAP §1 item 13, parsing)"


@dataclasses.dataclass
class _Prim:
    ptype: int
    pa: np.ndarray
    pb: np.ndarray
    pc: np.ndarray
    na: np.ndarray
    nb: np.ndarray
    nc: np.ndarray
    material_id: int
    mat_kind: int
    instance_id: int
    area: float
    aabb_lo: np.ndarray
    aabb_hi: np.ndarray


class SceneBuilder:
    def __init__(self):
        self.curves: List[spectral.HostCurve] = []
        self._curve_names = {}
        self.tex_layers: List[Tuple[np.ndarray, int]] = []  # (weights HxW, curve)
        self.tex_ranges: List[Tuple[int, int]] = []
        self._tex_names = {}
        self.mat_rows: List[dict] = []
        self._mat_names = {}
        self.med_rows: List[dict] = [dict(mtype=MED_VACUUM, g=0, ss=0, sa=0,
                                          ior=0, corr=0.0)]
        self._med_names = {}
        self.prims: List[_Prim] = []
        self.env: Optional[dict] = None
        self.env_sampling_probability = 0.5
        self._next_instance = 0
        self._meshes: List[dict] = []  # baked at build(), after other prims

    # ------------------------------------------------------------- curves

    def add_curve(self, curve: spectral.HostCurve, name: Optional[str] = None) -> int:
        if name is not None and name in self._curve_names:
            return self._curve_names[name]
        self.curves.append(curve)
        idx = len(self.curves) - 1
        if name is not None:
            self._curve_names[name] = idx
        return idx

    def curve_index(self, name: str) -> int:
        return self._curve_names[name]

    # ------------------------------------------------------------ textures

    def add_texture(self, layers: Sequence[Tuple[np.ndarray, int]],
                    name: Optional[str] = None) -> int:
        """layers: list of (weight map HxW float, curve index)."""
        if name is not None and name in self._tex_names:
            return self._tex_names[name]
        start = len(self.tex_layers)
        for w, c in layers:
            self.tex_layers.append((np.asarray(w, np.float32), int(c)))
        self.tex_ranges.append((start, len(layers)))
        idx = len(self.tex_ranges) - 1
        if name is not None:
            self._tex_names[name] = idx
        return idx

    # ----------------------------------------------------------- materials

    def _add_mat(self, row: dict, name: Optional[str]) -> int:
        if name is not None and name in self._mat_names:
            return self._mat_names[name]
        self.mat_rows.append(row)
        idx = len(self.mat_rows) - 1
        if name is not None:
            self._mat_names[name] = idx
        return idx

    def material_index(self, name: str) -> int:
        return self._mat_names[name]

    def add_lambertian(self, tex_id: int, name=None) -> int:
        return self._add_mat(dict(mtype=MAT_LAMBERTIAN, tex_id=tex_id), name)

    def add_ggx(self, alpha: float, eta_idx: int, eta_o_idx: int,
                kappa_idx: int, permeability: float = 0.0,
                inner_medium: int = 0, outer_medium: int = 0,
                name=None) -> int:
        # metallic := kappa integral > 0
        kappa_integral = self.curves[kappa_idx].integral(EXTENDED_VISIBLE_RANGE, 128)
        return self._add_mat(
            dict(mtype=MAT_GGX, alpha=alpha, eta_idx=eta_idx,
                 eta_o_idx=eta_o_idx, kappa_idx=kappa_idx,
                 permeability=permeability, metallic=kappa_integral > 0.0,
                 inner_medium=inner_medium, outer_medium=outer_medium),
            name)

    def add_diffuse_light(self, emit_idx: int, bounce_idx: int,
                          sidedness: int, name=None) -> int:
        return self._add_mat(
            dict(mtype=MAT_DIFFUSE_LIGHT, emit_idx=emit_idx,
                 bounce_idx=bounce_idx, sidedness=sidedness), name)

    def add_sharp_light(self, emit_idx: int, bounce_idx: int, sidedness: int,
                        sharpness: float, name=None) -> int:
        return self._add_mat(
            dict(mtype=MAT_SHARP_LIGHT, emit_idx=emit_idx,
                 bounce_idx=bounce_idx, sidedness=sidedness,
                 sharpness=sharpness), name)

    # ------------------------------------------------------------- mediums

    def _add_med(self, row: dict, name: Optional[str]) -> int:
        self.med_rows.append(row)
        idx = len(self.med_rows) - 1
        if name is not None:
            self._med_names[name] = idx
        return idx

    def add_medium_hg(self, g_idx: int, sigma_s_idx: int, sigma_a_idx: int,
                      name=None) -> int:
        return self._add_med(dict(mtype=MED_HG, g=g_idx, ss=sigma_s_idx,
                                  sa=sigma_a_idx, ior=0, corr=0.0), name)

    def add_medium_rayleigh(self, ior_idx: int, corrective: float,
                            name=None) -> int:
        return self._add_med(dict(mtype=MED_RAYLEIGH, g=0, ss=0, sa=0,
                                  ior=ior_idx, corr=corrective), name)

    def medium_index(self, name: str) -> int:
        return self._med_names[name]

    def add_transform(self, m):
        raise NotImplementedError(f"transforms are {_NOT_PORTED}")

    # ------------------------------------------------------------ geometry

    def _mat_kind(self, material_id: int, kind: Optional[int]) -> int:
        if kind is not None:
            return kind
        mt = self.mat_rows[material_id]["mtype"]
        return 1 if mt in (MAT_DIFFUSE_LIGHT, MAT_SHARP_LIGHT) else 0

    def _new_instance(self) -> int:
        self._next_instance += 1
        return self._next_instance - 1

    @staticmethod
    def _no_transform(transform_id):
        if transform_id:
            raise NotImplementedError(f"transforms are {_NOT_PORTED}")

    def add_sphere(self, center, radius: float, material_id: int, kind=None,
                   transform_id: int = 0) -> int:
        self._no_transform(transform_id)
        c = np.asarray(center, np.float32)
        iid = self._new_instance()
        z3 = np.zeros(3, np.float32)
        self.prims.append(_Prim(
            PRIM_SPHERE, c, np.array([radius, 0, 0], np.float32), z3, z3, z3, z3,
            material_id, self._mat_kind(material_id, kind), iid,
            4.0 * np.pi * radius * radius, c - radius, c + radius))
        return iid

    def add_rect(self, center, edge_u, edge_v, material_id: int, kind=None,
                 transform_id: int = 0) -> int:
        """edge_u/edge_v: half-edge vectors."""
        self._no_transform(transform_id)
        c = np.asarray(center, np.float32)
        eu = np.asarray(edge_u, np.float32)
        ev = np.asarray(edge_v, np.float32)
        # corners in f32, then f64 for the area and bounds (as the reference
        # does through its f64 transform)
        wc = np.stack([(c + su * eu + sv * ev).astype(np.float64)
                       for su in (-1, 1) for sv in (-1, 1)])
        area = float(np.linalg.norm(np.cross(wc[2] - wc[0], wc[1] - wc[0])))
        iid = self._new_instance()
        z3 = np.zeros(3, np.float32)
        self.prims.append(_Prim(
            PRIM_RECT, c, eu, ev, z3, z3, z3, material_id,
            self._mat_kind(material_id, kind), iid, area,
            wc.min(0) - 1e-4, wc.max(0) + 1e-4))
        return iid

    def add_disk(self, center, normal, radius: float, material_id: int,
                 kind=None, transform_id: int = 0) -> int:
        self._no_transform(transform_id)
        c = np.asarray(center, np.float32)
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        iid = self._new_instance()
        z3 = np.zeros(3, np.float32)
        self.prims.append(_Prim(
            PRIM_DISK, c, n, np.array([radius, 0, 0], np.float32), z3, z3, z3,
            material_id, self._mat_kind(material_id, kind), iid,
            float(np.pi * radius * radius), c - radius, c + radius))
        return iid

    def add_camera_surface(self, camera_id: int, origin, direction,
                           lens_radius: float) -> int:
        """The camera's lens proxy: a disk of kind 2 (camera) at the lens,
        so that light paths can hit the lens directly (light tracing's
        direct lens hits). Returns the instance id, or -1 for a pinhole."""
        if lens_radius <= 0.0:
            return -1
        c = np.asarray(origin, np.float32)
        n = np.asarray(direction, np.float32)
        n = n / np.linalg.norm(n)
        iid = self._new_instance()
        z3 = np.zeros(3, np.float32)
        self.prims.append(_Prim(
            PRIM_DISK, c, n, np.array([lens_radius, 0, 0], np.float32), z3,
            z3, z3, camera_id, 2, iid,
            float(np.pi * lens_radius * lens_radius), c - lens_radius,
            c + lens_radius))
        return iid

    def add_mesh(self, vertices, indices, normals, material_ids,
                 transform=None, kind=None, mesh_key=None,
                 material_override: Optional[int] = None) -> int:
        """A single world-space triangle-mesh instance, baked to triangle
        rows at build() (after every other primitive, as the reference
        orders baked mesh rows)."""
        if transform is not None:
            raise NotImplementedError(f"mesh transforms are {_NOT_PORTED}")
        if mesh_key is not None:
            raise NotImplementedError(
                f"shared mesh instancing is {_NOT_PORTED}")
        iid = self._new_instance()
        self._meshes.append(dict(
            vertices=np.asarray(vertices, np.float64),
            indices=np.asarray(indices, np.int64).reshape(-1, 3),
            normals=(np.asarray(normals, np.float64)
                     if normals is not None and len(normals) else None),
            mat_ids=(material_override if material_override is not None
                     else np.asarray(material_ids, np.int64)),
            kind=kind, iid=iid))
        return iid

    def _expand_mesh_rows(self, df: dict):
        v, idx, vn = df["vertices"], df["indices"], df["normals"]
        mat_arr = np.broadcast_to(np.asarray(df["mat_ids"], np.int64), (len(idx),))
        for t in range(len(idx)):
            i0, i1, i2 = idx[t]
            p0, p1, p2 = v[i0], v[i1], v[i2]
            cr = np.cross(p1 - p0, p2 - p0)
            area = 0.5 * float(np.linalg.norm(cr))
            if area < 1e-12:
                continue
            gn = cr / np.linalg.norm(cr)
            n0 = vn[i0] if vn is not None else gn
            n1 = vn[i1] if vn is not None else gn
            n2 = vn[i2] if vn is not None else gn
            lo = np.minimum(np.minimum(p0, p1), p2) - 1e-5
            hi = np.maximum(np.maximum(p0, p1), p2) + 1e-5
            m = int(mat_arr[t])
            self.prims.append(_Prim(
                PRIM_TRIANGLE, p0.astype(np.float32), p1.astype(np.float32),
                p2.astype(np.float32), n0.astype(np.float32),
                n1.astype(np.float32), n2.astype(np.float32), m,
                self._mat_kind(m, df["kind"]), df["iid"], area,
                lo.astype(np.float32), hi.astype(np.float32)))

    # ---------------------------------------------------------------- env

    def set_environment_constant(self, curve_idx: int, strength: float):
        self.env = constant_env_numpy(curve_idx, strength)

    def set_environment_sun(self, curve_idx: int, strength: float,
                            sun_direction, angular_diameter: float):
        """The constant SPD `curve_idx` inside a cap of `angular_diameter`
        radians around `sun_direction` (the parser's "Sun" environment)."""
        self.env = sun_env_numpy(curve_idx, strength, sun_direction,
                                 angular_diameter)

    def set_environment_hdr(self, tex_id: int, strength: float,
                            imp_w: Optional[int], imp_h: Optional[int],
                            rotation=None):
        """The equirect texture `tex_id` as the environment (the parser's
        "HDRI" environment). With `imp_w` x `imp_h` it gets a baked
        importance map, else uniform-uv sampling; `rotation` is the 3x3
        env->world rotation."""
        tables = None
        if imp_w and imp_h:
            start, count = self.tex_ranges[tex_id]
            tables = bake_importance_tables(
                self.tex_layers[start:start + count], self.curves,
                int(imp_w), int(imp_h))
        self.env = hdr_env_numpy(tex_id, strength, rotation, tables)

    # -------------------------------------------------------------- build

    def build_numpy(self) -> dict:
        """The scene's arrays, keyed by JAX `World` field name."""
        if self.env is None:
            zero = self.add_curve(spectral.FlatCurve(0.0), name="__black__")
            self.set_environment_constant(zero, 0.0)
        if not self.tex_ranges:
            self.add_texture([(np.ones((1, 1), np.float32), 0)], name="__white__")
        for df in self._meshes:
            self._expand_mesh_rows(df)
        self._meshes = []  # consumed
        for label, count in (("primitives", len(self.prims)),
                             ("materials", len(self.mat_rows)),
                             ("curves", len(self.curves))):
            if count >= (1 << 24):
                raise ValueError(f"{label} count {count} >= 2^24: too large "
                                 f"for f32-packed hot-loop indices")
        p = len(self.prims)
        if p == 0:
            raise ValueError("scene has no primitives")
        f = {}
        for k, v in spectral.bake_curves_np(self.curves).items():
            f[f"bank.{k}"] = v

        offsets, ws, hs, curves, atlas = [], [], [], [], []
        acc = 0
        for w, c in self.tex_layers:
            offsets.append(acc)
            hs.append(w.shape[0])
            ws.append(w.shape[1])
            curves.append(c)
            atlas.append(w.ravel())
            acc += w.size
        i32 = lambda xs: np.asarray(xs, np.int32)  # noqa: E731
        f.update({
            "tex.layer_start": i32([r[0] for r in self.tex_ranges]),
            "tex.layer_count": i32([r[1] for r in self.tex_ranges]),
            "tex.layer_curve": i32(curves),
            "tex.layer_offset": i32(offsets),
            "tex.layer_w": i32(ws),
            "tex.layer_h": i32(hs),
            "tex.atlas": np.concatenate(atlas).astype(np.float32),
        })

        def col(key, default, dtype):
            return np.asarray([r.get(key, default) for r in self.mat_rows], dtype)

        for key, default, dtype in (
                ("mtype", MAT_PASSTHROUGH, np.int32), ("tex_id", -1, np.int32),
                ("alpha", 0.0, np.float32), ("eta_idx", 0, np.int32),
                ("eta_o_idx", 0, np.int32), ("kappa_idx", 0, np.int32),
                ("permeability", 0.0, np.float32), ("metallic", False, bool),
                ("inner_medium", 0, np.int32), ("outer_medium", 0, np.int32),
                ("emit_idx", -1, np.int32), ("bounce_idx", 0, np.int32),
                ("sharpness", 0.0, np.float32), ("sidedness", 2, np.int32)):
            f[f"mats.{key}"] = col(key, default, dtype)

        for field, key, dtype in (
                ("mtype", "mtype", np.int32), ("g_idx", "g", np.int32),
                ("sigma_s_idx", "ss", np.int32),
                ("sigma_a_idx", "sa", np.int32), ("ior_idx", "ior", np.int32),
                ("corrective", "corr", np.float32)):
            f[f"mediums.{field}"] = np.asarray(
                [r[key] for r in self.med_rows], dtype)

        pad = (-p) % _PAD

        def pv(get, fill=0.0):
            arr = np.stack([get(x) for x in self.prims]).astype(np.float32)
            if pad:
                arr = np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill, np.float32)])
            return arr

        def pi(get, fill=0):
            arr = np.asarray([get(x) for x in self.prims], np.int32)
            if pad:
                arr = np.concatenate([arr, np.full((pad,), fill, np.int32)])
            return arr

        eye = np.eye(4, dtype=np.float32)[None]
        f.update({
            "prims.ptype": pi(lambda x: x.ptype),
            "prims.pa": pv(lambda x: x.pa),
            "prims.pb": pv(lambda x: x.pb),
            "prims.pc": pv(lambda x: x.pc),
            "prims.na": pv(lambda x: x.na),
            "prims.nb": pv(lambda x: x.nb),
            "prims.nc": pv(lambda x: x.nc),
            "prims.material_id": pi(lambda x: x.material_id),
            "prims.mat_kind": pi(lambda x: x.mat_kind, -1),
            "prims.instance_id": pi(lambda x: x.instance_id, -1),
            "prims.transform_id": pi(lambda x: 0),
            "prims.area": pv(lambda x: x.area, 1.0),
            "prims.valid": np.concatenate([np.ones(p, bool), np.zeros(pad, bool)]),
            "prims.xf_fwd": eye,
            "prims.xf_inv": eye.copy(),
        })

        light_ids = [i for i, x in enumerate(self.prims) if x.mat_kind == 1]
        n_lights = len(light_ids)
        lights = np.zeros(max(1, n_lights), np.int32)
        lights[:n_lights] = light_ids
        lo = np.min(np.stack([x.aabb_lo for x in self.prims]), axis=0)
        hi = np.max(np.stack([x.aabb_hi for x in self.prims]), axis=0)
        center = (lo + hi) / 2.0
        radius = float(np.linalg.norm(hi - center))
        for k, v in self.env.items():
            f[f"env.{k}"] = v
        f.update({
            "lights": lights,
            "n_lights": np.int32(n_lights),
            "env_sampling_probability": np.float32(self.env_sampling_probability),
            "center": center.astype(np.float32),
            "radius": np.float32(max(radius, 1.0)),
        })
        return f

    def build(self, device=DEFAULT_DEVICE) -> World:
        """The scene as a `World` on `device` (the card by default; raises
        without one, before baking anything)."""
        device = resolve_device(device)
        return world_from_numpy(self.build_numpy(), device)
