"""Participating media in the plain reference: homogeneous media inside
closed boundaries, tracked path by path, for medium-aware path tracing
(`pt.render` calls this module only when the settings are medium-aware and
the scene has media). Written from the physics and rust-pathtracer's
description of its media (`src/mediums/`), not from the program's code.

- Media. Henyey-Greenstein (`hg`): the phase (1 - g^2) / (4 pi (1 + g^2 -
  2 g cos t)^1.5), t the angle between the propagation directions before
  and after the scatter (forward-peaked for g > 0), with sigma_s(lambda)
  and sigma_a(lambda) from curves. Rayleigh: sigma_s = f (n(lambda)^2 -
  1)^2 / lambda^4 * 1e-32 with lambda in metres (a frozen copy of
  upstream's formula, `src/mediums/rayleigh.rs`), sigma_a = 0, the phase
  3 (1 + cos^2 t) / (16 pi).
- Tracking. A path carries the multiset of media it is in, empty at the
  camera. A transmission through a boundary whose inner and outer medium
  differ leaves the medium of the side it came from (one occurrence, if the
  path is in it) and enters the other side's: from the outer side (along
  the geometric normal) it enters `inner_medium`, from the inner side it
  leaves it. A reflection leaves the set as it is. The coefficients of the
  media a path is in add.
- Free flight. A distance drawn from the exponential at the summed sigma_s
  at the path's wavelength; where it ends before the surface hit the path
  scatters there, in a medium picked by its share of sigma_s, and either
  way the throughput takes the absorption exp(-sigma_a d) of the distance
  flown. Absorption thus ends no path, so the bounce rays a sample casts
  (continuations, scatters among them) have the same expectation as under
  the program's scheme of this kind; the film's expectation is that of any
  unbiased scheme.
- A scatter is a path vertex: it counts against `max_bounces`, takes the
  settings' next-event samples weighted by the phase function (MIS against
  the phase pdf, as a surface vertex weighs them against its BSDF's), and
  continues along a direction sampled from the phase function with weight
  1, so Russian roulette's continuation probability clamp(weight, 0.05, 1)
  is 1 there. A shadow ray carries the Beer-Lambert transmittance exp(-sigma_t
  d) of the media on the side it leaves into, and stops at any surface.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

T_CAP = 1e8  # the longest flight weighed: exp(-sigma_a d) stays finite


class Media:
    """A scene's media as tensors: kinds and curve columns by medium, and the
    inner and outer medium of each material (ids 1..K; 0 is vacuum)."""

    def __init__(self, data, curve_index: dict, material_names: list,
                 device):
        names = list(data.mediums)
        ids = {n: i + 1 for i, n in enumerate(names)}
        specs = [data.mediums[n] for n in names]
        self.count = len(specs)
        self.specs = specs
        self.cidx = curve_index

        def mat_ids(key):
            return torch.tensor(
                [ids.get(data.materials[m].get(key), 0)
                 for m in material_names], dtype=torch.long, device=device)

        self.inner, self.outer = mat_ids("inner_medium"), \
            mat_ids("outer_medium")
        self.is_ray = torch.tensor([s["kind"] == "rayleigh" for s in specs],
                                   dtype=torch.bool, device=device)

    def coefficients(self, cv, lam):
        """Each medium's sigma_s, sigma_a and g at each lane's wavelength
        (cv: every curve at it) -> three [m, K]."""
        ss, sa, g = [], [], []
        zero = torch.zeros_like(lam)
        for s in self.specs:
            if s["kind"] == "hg":
                ss.append(cv[:, self.cidx[s["sigma_s"]]])
                sa.append(cv[:, self.cidx[s["sigma_a"]]])
                g.append(cv[:, self.cidx[s["g"]]])
            else:
                n = cv[:, self.cidx[s["ior"]]]
                lam_m = lam * 1e-9
                ss.append(float(s["corrective_factor"]) * (n * n - 1.0) ** 2
                          / lam_m ** 4 * 1e-32)
                sa.append(zero)
                g.append(zero)
        return torch.stack(ss, -1), torch.stack(sa, -1), torch.stack(g, -1)

    def fly(self, inside, cv, lam, t_surface, u):
        """The free flight of each lane from its ray's origin: `inside`
        [m, K] the media it is in, `t_surface` its surface hit (inf for
        none), u [m, 4] its uniforms (flight, pick, and two for the
        phase sample) -> what the vertex needs."""
        ss_k, sa_k, g_k = self.coefficients(cv, lam)
        w = inside.to(ss_k.dtype)
        share = ss_k * w  # each medium's part of the path's sigma_s
        sigma_s, sigma_a = share.sum(-1), (sa_k * w).sum(-1)
        flight = torch.where(
            sigma_s > 0,
            -torch.log(torch.clamp(1.0 - u[:, 0], min=1e-12))
            / torch.where(sigma_s > 0, sigma_s, 1.0), math.inf)
        scattered = flight < t_surface
        travel = torch.clamp(torch.minimum(flight, t_surface), max=T_CAP)
        pick = torch.clamp((torch.cumsum(share, -1)
                            < (u[:, 1] * sigma_s)[:, None]).sum(-1),
                           max=self.count - 1)
        return SimpleNamespace(
            scattered=scattered, travel=travel,
            absorption=torch.exp(-sigma_a * travel),
            sigma_t_k=ss_k + sa_k,
            g=torch.gather(g_k, 1, pick[:, None])[:, 0],
            is_ray=self.is_ray[pick], u_phase=u[:, 2:4])

    def cross(self, inside, mat, wi_z, wo_z):
        """The media after leaving a surface vertex of material `mat` from
        local direction wi toward wo: a transmission (wi_z, wo_z of
        opposite signs) through a boundary whose two media differ leaves
        the side it came from and enters the other."""
        inner, outer = self.inner[mat], self.outer[mat]
        through = (wi_z * wo_z < 0) & (inner != outer)
        entering = wo_z < 0
        leave = torch.where(entering, outer, inner)
        enter = torch.where(entering, inner, outer)
        out = inside.clone()
        r = torch.nonzero(through & (leave > 0)).squeeze(1)
        out[r, leave[r] - 1] = torch.clamp(out[r, leave[r] - 1] - 1, min=0)
        r = torch.nonzero(through & (enter > 0)).squeeze(1)
        out[r, enter[r] - 1] += 1
        return out


def phase(fl, cos_t):
    """The picked medium's phase toward a direction at cosine `cos_t`
    to the propagation direction."""
    g = fl.g
    den = 1.0 + g * g - 2.0 * g * cos_t
    hg = (1.0 - g * g) / (4.0 * math.pi * den
                          * torch.sqrt(torch.clamp(den, min=1e-12)))
    ray = 3.0 * (1.0 + cos_t * cos_t) / (16.0 * math.pi)
    return torch.where(fl.is_ray, ray, hg)


def sample_phase(fl, frame):
    """A direction from the picked medium's phase about the propagation
    direction d, given the frame (t, b, d) -> (direction, pdf)."""
    u1, u2 = fl.u_phase[:, 0], fl.u_phase[:, 1]
    g = fl.g
    # HG by its inverse CDF (isotropic where |g| is tiny)
    small = g.abs() < 1e-3
    gs = torch.where(small, 0.5, g)
    sq = (1.0 - gs * gs) / (1.0 - gs + 2.0 * gs * u1)
    cos_hg = torch.where(small, 1.0 - 2.0 * u1,
                         (1.0 + gs * gs - sq * sq) / (2.0 * gs))
    # Rayleigh: the real root of (3c + c^3 + 4) / 8 = u1 (Cardano)
    z = 4.0 * u1 - 2.0
    a = (z + torch.sqrt(z * z + 1.0)) ** (1.0 / 3.0)
    cos_t = torch.clamp(torch.where(fl.is_ray, a - 1.0 / a, cos_hg),
                        -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    t, b, d = frame
    wo = (t * (sin_t * torch.cos(phi))[:, None]
          + b * (sin_t * torch.sin(phi))[:, None] + d * cos_t[:, None])
    return wo, phase(fl, cos_t)


def transmittance(inside, sigma_t_k, dist):
    """exp(-sigma_t dist) of the media `inside` [m, K]."""
    sigma_t = (inside.to(sigma_t_k.dtype) * sigma_t_k).sum(-1)
    return torch.exp(-sigma_t * torch.clamp(dist, max=T_CAP))
