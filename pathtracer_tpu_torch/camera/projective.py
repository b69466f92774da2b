"""Projective thin-lens camera (counterpart of `camera/projective.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracer_tpu_torch.camera.aperture import sample_aperture
from pathtracer_tpu_torch.core.vecmath import normalize
from pathtracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


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
        d = normalize(focal_pt - o)
        return o, d, torch.ones(film_u.shape, dtype=torch.float32,
                                device=film_u.device)

    def get_pixel_for_ray(self, o, d, lam=None):
        """The inverse of get_ray for splats: a ray from a lens point into
        the scene (V3s of per-lane tensors) -> (film u, film v, valid)."""
        w, org = [float(x) for x in self.w], [float(x) for x in self.origin]
        u, v = [float(x) for x in self.u], [float(x) for x in self.v]
        focal = float(self.focal_distance)
        cos_f = d.x * w[0] + d.y * w[1] + d.z * w[2]
        valid = cos_f > 1e-6
        t = focal / torch.where(valid, cos_f, 1.0)
        rel = [p + t * dd - org[i] - focal * w[i]
               for i, (p, dd) in enumerate(zip(o, d))]
        fu = rel[0] * u[0] + rel[1] * u[1] + rel[2] * u[2]
        fv = rel[0] * v[0] + rel[1] * v[1] + rel[2] * v[2]
        fu = fu / torch.full_like(fu, max(float(self.half_width), 1e-9))
        fv = fv / torch.full_like(fv, max(float(self.half_height), 1e-9))
        film_u = (fu + 1.0) * 0.5
        film_v = (1.0 - fv) * 0.5
        inside = ((film_u >= 0.0) & (film_u < 1.0) & (film_v >= 0.0)
                  & (film_v < 1.0))
        return film_u, film_v, valid & inside

    # the lens-connection protocol of light tracing: the connection point
    # is sampled on the lens disk; W_e = focal² / (cos³θ · A_film)
    def sample_lens_point(self, u1, u2):
        """A point on the lens disk -> V3 (the polar disk map, scaled)."""
        from pathtracer_tpu_torch.core.sampling import random_in_unit_disk
        from pathtracer_tpu_torch.kernels.cmath import V3

        xy = random_in_unit_disk(u1, u2) * float(self.lens_radius)
        org = [float(x) for x in self.origin]
        u, v = [float(x) for x in self.u], [float(x) for x in self.v]
        return V3(*[org[i] + xy[..., 0] * u[i] + xy[..., 1] * v[i]
                    for i in range(3)])

    def lens_area(self) -> float:
        return float(np.float32(np.pi) * self.lens_radius.cpu().numpy()
                     * self.lens_radius.cpu().numpy())

    def we_focal(self) -> float:
        return float(self.focal_distance)

    def we_film_area(self) -> float:
        hw = self.half_width.cpu().numpy()
        hh = self.half_height.cpu().numpy()
        return float((np.float32(2.0) * hw) * (np.float32(2.0) * hh))

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
