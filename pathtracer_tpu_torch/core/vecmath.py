"""Vector math on `[..., 3]` tensors (counterpart of `core/vecmath.py`).

The names and the operation order are the JAX module's. The round kernels'
plain twins work on `V3` tuples of per-lane tensors instead
(`kernels/cmath.py`); the regen integrator without kernels
(`integrator/pt_regen.py`) and the hit records (`geometry/soa.py`) use
these.
"""

from __future__ import annotations

import math

import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def length_squared(a):
    return torch.sum(a * a, dim=-1)


def normalize(a, eps: float = 1e-20):
    return a * torch.sqrt(torch.clamp(
        1.0 / torch.clamp(length_squared(a), min=eps), min=0.0))[..., None]


def vec(x, y, z):
    return torch.stack(torch.broadcast_tensors(
        torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32),
        torch.as_tensor(z, dtype=torch.float32)), dim=-1)


def reflect(w, n):
    """Mirror w about the unit normal n; w points away from the surface."""
    return -w + 2.0 * dot(w, n)[..., None] * n


def refract(w, n, eta_rel):
    """Refract w (unit, pointing away from the surface) about n with
    relative IOR eta_rel = eta_i / eta_t -> (wt, total internal reflection
    mask)."""
    cos_i = dot(w, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta_rel * eta_rel * sin2_i
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -w * eta_rel[..., None] + (eta_rel * cos_i - cos_t)[..., None] * n
    return wt, tir


def orthonormal_basis(n):
    """(tangent, bitangent) of the unit normal n: the branchless
    Frisvad / Duff et al. construction."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                     dim=-1)
    return t, bt


class TangentFrame:
    """Local shading frame with +z = normal."""

    def __init__(self, tangent, bitangent, normal):
        self.tangent = tangent
        self.bitangent = bitangent
        self.normal = normal

    @staticmethod
    def from_normal(n):
        t, b = orthonormal_basis(n)
        return TangentFrame(t, b, n)

    def to_local(self, v):
        return torch.stack([dot(v, self.tangent), dot(v, self.bitangent),
                            dot(v, self.normal)], dim=-1)

    def to_world(self, v):
        return (v[..., 0:1] * self.tangent + v[..., 1:2] * self.bitangent
                + v[..., 2:3] * self.normal)


def direction_to_uv(d):
    """Unit direction -> equirect (u, v): u in [0, 1) from atan2, v =
    acos(z) / π."""
    u = torch.remainder(torch.atan2(d[..., 1], d[..., 0]) / (2.0 * math.pi),
                        1.0)
    v = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0)) / math.pi
    return u, v


def uv_to_direction(u, v):
    phi = 2.0 * math.pi * u
    theta = math.pi * v
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)
