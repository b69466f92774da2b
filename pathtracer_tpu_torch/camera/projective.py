"""Projective thin-lens camera (counterpart of `camera/projective.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracer_tpu_torch.camera.aperture import sample_aperture
from pathtracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _normalize(a, eps: float = 1e-20):
    """core/vecmath.normalize on [..., 3] tensors."""
    ls = torch.sum(a * a, dim=-1)
    return a * torch.sqrt(torch.clamp(1.0 / torch.clamp(ls, min=eps), min=0.0))[..., None]


@dataclasses.dataclass
class ProjectiveCamera:
    origin: torch.Tensor  # f32[3] lens center
    w: torch.Tensor  # f32[3] forward (unit, towards scene)
    u: torch.Tensor  # f32[3] right (unit)
    v: torch.Tensor  # f32[3] up (unit)
    half_width: torch.Tensor  # f32 focal-plane half extent (world units)
    half_height: torch.Tensor
    focal_distance: torch.Tensor  # f32
    lens_radius: torch.Tensor  # f32 (aperture_diameter / 2)
    blades: torch.Tensor  # i32; 0 = circular aperture
    blade_sharpness: torch.Tensor  # f32

    def get_ray(self, film_u, film_v, lens_u1, lens_u2):
        """Film (u,v) in [0,1)² (v=0 = top row) + lens samples -> (o, d, tau)."""
        lens_xy = sample_aperture(lens_u1, lens_u2, self.lens_radius,
                                  int(self.blades), float(self.blade_sharpness))
        o = (self.origin
             + lens_xy[..., 0:1] * self.u
             + lens_xy[..., 1:2] * self.v)
        focal_pt = (
            self.origin
            + self.focal_distance * self.w
            + ((film_u * 2.0 - 1.0) * self.half_width)[..., None] * self.u
            + ((1.0 - film_v * 2.0) * self.half_height)[..., None] * self.v
        )
        d = _normalize(focal_pt - o)
        return o, d, torch.ones(film_u.shape, dtype=torch.float32,
                                device=film_u.device)

    def to(self, device) -> "ProjectiveCamera":
        return ProjectiveCamera(**{f.name: getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)})


_FIELDS = {f.name for f in dataclasses.fields(ProjectiveCamera)}


def camera_from_numpy(fields: dict, device=DEFAULT_DEVICE) -> ProjectiveCamera:
    """The JAX `ProjectiveCamera`'s leaves (numpy, by field name) -> port,
    on `device` (the card by default; raises without one)."""
    device = resolve_device(device)
    kw = {}
    for name in _FIELDS:
        a = np.asarray(fields[name])
        a = a.astype(np.int32 if name == "blades" else np.float32)
        kw[name] = torch.as_tensor(a.copy(), device=device)
    return ProjectiveCamera(**kw)


def make_projective_camera(
    look_from,
    look_at,
    v_up=(0.0, 0.0, 1.0),
    vfov_degrees: float = 45.0,
    focal_distance: float = 1.0,
    aperture_diameter: float = 0.0,
    aspect_ratio: float = 1.0,
    blades: int = 0,
    blade_sharpness: float = 1.0,
    device=DEFAULT_DEVICE,
) -> ProjectiveCamera:
    lf = np.asarray(look_from, np.float64)
    la = np.asarray(look_at, np.float64)
    w = la - lf
    w = w / np.linalg.norm(w)
    up = np.asarray(v_up, np.float64)
    u = np.cross(w, up)
    if np.linalg.norm(u) < 1e-9:
        up = np.array([0.0, 1.0, 0.0])
        u = np.cross(w, up)
    u = u / np.linalg.norm(u)
    v = np.cross(u, w)
    half_height = np.tan(np.deg2rad(vfov_degrees) / 2.0) * focal_distance
    half_width = half_height * aspect_ratio
    return camera_from_numpy(dict(
        origin=lf, w=w, u=u, v=v, half_width=half_width,
        half_height=half_height, focal_distance=focal_distance,
        lens_radius=aperture_diameter / 2.0, blades=blades,
        blade_sharpness=blade_sharpness), device)
