"""The plain reference path tracer: plain PyTorch over the scene file's
data, written for the semantics and not for speed.

It renders the same estimator as the program's path tracer, so that the
two films have the same expectation: one wavelength a path, drawn
uniformly over [380, 780] nm; a box-filtered pixel sample through a
pinhole camera; at every surface vertex the emission of a light hit
(weighted against next-event estimation by the balance heuristic from the
second vertex on), `light_samples` next-event samples of a uniformly
picked light, each weighted against the BSDF's pdf, then a BSDF sample and
Russian roulette from bounce `min_bounces` on; at most `max_bounces`
vertices. The film is x-bar, y-bar, z-bar times the radiance times the
wavelength span, averaged over the pixel's samples.

The materials' equations: a lambertian reflects min(R, 1) / pi; a diffuse
light emits its SPD / pi on its emitting side and reflects as a lambertian
of its bounce curve; the GGX dielectric is Walter et al. 2007 (Smith
height-uncorrelated G2, Fresnel of the half vector, the transmission lobe
scaled by (eta_from / eta_to)^2 for radiance), sampled through Heitz's
visible normals. Rays leave a surface offset by 1e-3 along its geometric
normal, shadow rays stop at 0.99 of the distance to the light sample.

Under medium-aware settings, a scene's participating media are tracked
path by path (`media`: free flights, scatter vertices with next-event
estimation through the phase function, Beer-Lambert shadow rays); without
them, or in a scene without media, the surfaces are all there is.

Paths are traced in passes of `lanes` pixel samples; a pass compacts its
live paths every bounce. Every float of the path arithmetic is in `dtype`
(float32 as the configurations state; bfloat16 is the lower-precision
control); the film accumulates in float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import media, spectra
from .loader import SceneData, triangles

PI = math.pi
NORMAL_OFFSET = 1e-3
T_MIN = 1e-6
T_MAX = 1e9
TRI_CHUNK = 1 << 15  # rays a triangle test takes at a time

K_TRI, K_SPHERE, K_RECT, K_DISK = 0, 1, 2, 3
M_LAMBERT, M_GGX, M_LIGHT = 0, 1, 2
SIDES = {"forward": 0, "reverse": 1, "dual": 2}


@dataclasses.dataclass(frozen=True)
class Settings:
    max_bounces: int = 12
    min_bounces: int = 1
    light_samples: int = 2
    russian_roulette: bool = True
    medium_aware: bool = False


def _v(rows, dev, dt):
    return torch.tensor(rows, dtype=torch.float64).reshape(-1, 3).to(dev, dt)


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    return a / torch.sqrt(torch.clamp(_dot(a, a), min=1e-20))[..., None]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _bdot(o, rows):
    """o [N, 3] . rows [P, 3] -> [N, P], by components (no matmul, so no
    reduced-precision tensor-core path)."""
    return (o[:, 0:1] * rows[:, 0] + o[:, 1:2] * rows[:, 1]
            + o[:, 2:3] * rows[:, 2])


class Scene:
    """A configuration's scene as tensors on `device` in `dtype`."""

    def __init__(self, data: SceneData, device, dtype=torch.float32):
        dev, dt = torch.device(device), dtype
        self.device, self.dtype = dev, dt
        env = data.environment
        if (env["kind"] != "constant" or float(env["strength"]) != 0.0
                or float(env["sampling_probability"]) != 0.0):
            raise NotImplementedError("the reference renders scenes under a "
                                      "black constant environment, never "
                                      "sampled, only")
        cam = data.camera
        if float(cam.get("aperture_diameter", 0.0)) != 0.0:
            raise NotImplementedError("the reference's camera is a pinhole")
        self.curve_names = list(data.curves)
        self.curve_specs = [data.curves[n] for n in self.curve_names]
        cidx = {n: i for i, n in enumerate(self.curve_names)}
        tnames = list(data.textures)
        tidx = {n: i for i, n in enumerate(tnames)}
        self.textures = [[(torch.as_tensor(w).to(dev, dt), cidx[c])
                          for w, c in data.textures[n]] for n in tnames]
        mnames = list(data.materials)
        midx = {n: i for i, n in enumerate(mnames)}
        rows = []
        for n in mnames:
            m = data.materials[n]
            k = m["kind"]
            if k == "lambertian":
                rows.append((M_LAMBERT, tidx[m["texture"]], 0.0, 0, 0, 1.0,
                             0, 0, 0))
            elif k == "ggx":
                kappa = data.curves[m["kappa"]]
                if kappa["kind"] != "flat" or float(kappa["value"]) != 0.0:
                    raise NotImplementedError("conductors are not in the "
                                              "reference")
                rows.append((M_GGX, 0, max(float(m["alpha"]), 1e-4),
                             cidx[m["eta"]], cidx[m["eta_outer"]],
                             float(m["permeability"]), 0, 0, 0))
            elif k == "diffuse_light":
                rows.append((M_LIGHT, 0, 0.0, 0, 0, 1.0, cidx[m["emission"]],
                             cidx[m["bounce"]], SIDES[m["side"]]))
            else:
                raise NotImplementedError(f"material kind {k!r}")
        cols = list(zip(*rows))
        ii = lambda c: torch.tensor(c, dtype=torch.long, device=dev)  # noqa: E731
        self.m_kind, self.m_tex = ii(cols[0]), ii(cols[1])
        self.m_alpha = torch.tensor(cols[2], dtype=dt, device=dev)
        self.m_eta, self.m_eta_o = ii(cols[3]), ii(cols[4])
        self.m_perm = torch.tensor(cols[5], dtype=dt, device=dev)
        self.m_emit, self.m_bounce, self.m_side = ii(cols[6]), ii(cols[7]), \
            ii(cols[8])
        self.media = media.Media(data, cidx, mnames, dev)

        groups = {K_RECT: [], K_SPHERE: [], K_DISK: []}
        tris, meshes = [], []
        for p in data.prims:
            k, mat = p["kind"], midx[p["material"]]
            if k == "rect":
                groups[K_RECT].append((p["center"], p["u"], p["v"], mat))
            elif k == "sphere":
                groups[K_SPHERE].append((p["center"], p["radius"], mat))
            elif k == "disk":
                groups[K_DISK].append((p["center"], p["normal"], p["radius"],
                                       mat))
            elif k == "mesh":
                t = triangles(p)
                start = sum(len(x) for x, _ in tris)
                tris.append((t, mat))
                c = t.reshape(-1, 3).astype("float64")
                mid = c.mean(0)
                rad = float(((c - mid) ** 2).sum(-1).max() ** 0.5) * 1.001 + 1e-4
                meshes.append((mid.tolist(), rad, start, start + len(t)))
            else:
                raise NotImplementedError(f"prim kind {k!r}")
        r = groups[K_RECT]
        self.r_c = _v([x[0] for x in r], dev, dt)
        self.r_u = _v([x[1] for x in r], dev, dt)
        self.r_v = _v([x[2] for x in r], dev, dt)
        self.r_n = _normalize(_cross(self.r_u, self.r_v))
        self.r_nu = _cross(self.r_u, self.r_v)
        self.r_mat = ii([x[3] for x in r])
        s = groups[K_SPHERE]
        self.s_c = _v([x[0] for x in s], dev, dt)
        self.s_r = torch.tensor([x[1] for x in s], dtype=dt, device=dev)
        self.s_mat = ii([x[2] for x in s])
        dk = groups[K_DISK]
        self.d_c = _v([x[0] for x in dk], dev, dt)
        self.d_n = _normalize(_v([x[1] for x in dk], dev, torch.float64)).to(dt)
        self.d_r = torch.tensor([x[2] for x in dk], dtype=dt, device=dev)
        self.d_mat = ii([x[3] for x in dk])
        if tris:
            corners = np.concatenate([t for t, _ in tris])
            self.t_p = torch.as_tensor(corners).to(dev, dt)  # [T, 3, 3]
            self.t_mat = torch.cat([torch.full((len(t),), m, dtype=torch.long)
                                    for t, m in tris]).to(dev)
        else:
            self.t_p = torch.zeros((0, 3, 3), dtype=dt, device=dev)
            self.t_mat = ii([])
        self.meshes = meshes

        # lights: every prim of a light material, picked uniformly
        lights = []
        for kind, mats in ((K_RECT, self.r_mat), (K_SPHERE, self.s_mat),
                           (K_DISK, self.d_mat), (K_TRI, self.t_mat)):
            for i, m in enumerate(mats.tolist()):
                if rows[m][0] == M_LIGHT:
                    lights.append((kind, i))
        if not lights:
            raise NotImplementedError("the reference needs a light")
        self.lights = lights
        self.l_kind = ii([k for k, _ in lights])
        self.l_idx = ii([i for _, i in lights])
        self._areas = {
            k: torch.tensor([self._area(k, i) for i in range(len(mats))],
                            dtype=torch.float64).to(dev, dt)
            for k, mats in ((K_RECT, self.r_mat), (K_SPHERE, self.s_mat),
                            (K_DISK, self.d_mat), (K_TRI, self.t_mat))}
        self.l_area = torch.stack([self._areas[k][i] for k, i in lights])
        self.l_mat = ii([self._mat(k, i) for k, i in lights])

        # camera
        lf = np.asarray(cam["look_from"], np.float64)
        w = np.asarray(cam["look_at"], np.float64) - lf
        w /= np.linalg.norm(w)
        u = np.cross(w, np.asarray(cam.get("v_up", [0, 0, 1]), np.float64))
        u /= np.linalg.norm(u)
        v = np.cross(u, w)
        self.cam_o = torch.tensor(lf, dtype=torch.float32).to(dev, dt)
        self.cam_w = torch.tensor(w, dtype=torch.float32).to(dev, dt)
        self.cam_u = torch.tensor(u, dtype=torch.float32).to(dev, dt)
        self.cam_v = torch.tensor(v, dtype=torch.float32).to(dev, dt)
        self.cam_hh = float(np.float32(np.tan(np.deg2rad(cam["vfov_degrees"])
                                              / 2.0) * cam["focal_distance"]))
        self.cam_f = float(np.float32(cam["focal_distance"]))

    def _area(self, kind, i):
        if kind == K_RECT:
            return float(torch.linalg.norm(torch.cross(
                2 * self.r_u[i].double(), 2 * self.r_v[i].double(), dim=0)))
        if kind == K_SPHERE:
            return 4.0 * PI * float(self.s_r[i]) ** 2
        if kind == K_DISK:
            return PI * float(self.d_r[i]) ** 2
        p = self.t_p[i].double()
        return 0.5 * float(torch.linalg.norm(torch.cross(p[1] - p[0],
                                                         p[2] - p[0], dim=0)))

    def prim_area(self, kind, idx):
        """The surface area of each lane's hit prim."""
        out = torch.zeros(kind.shape, dtype=self.dtype, device=self.device)
        for k, mats in ((K_RECT, self.r_mat), (K_SPHERE, self.s_mat),
                        (K_DISK, self.d_mat), (K_TRI, self.t_mat)):
            if len(mats):
                areas = self._areas[k]
                out = torch.where(kind == k,
                                  areas[torch.clamp(idx, max=len(mats) - 1)],
                                  out)
        return out

    def _mat(self, kind, i):
        return int({K_RECT: self.r_mat, K_SPHERE: self.s_mat,
                    K_DISK: self.d_mat, K_TRI: self.t_mat}[kind][i])

    # ------------------------------------------------------------ spectra

    def curves_at(self, lam):
        """Every curve at each lane's wavelength -> [N, n_curves]."""
        return torch.stack([spectra.curve(s, lam) for s in self.curve_specs],
                           -1)

    def texture(self, tex_id, cv, uv):
        """Each lane's texture at its uv (nearest texel, uv clamped to
        [0, 1)), summed over the texture's layers."""
        out = torch.zeros_like(uv[:, 0])
        u = torch.clamp(uv[:, 0].float(), 0.0, 1.0 - 1e-6)
        v = torch.clamp(uv[:, 1].float(), 0.0, 1.0 - 1e-6)
        for t, layers in enumerate(self.textures):
            val = torch.zeros_like(out)
            for w, c in layers:
                h, wd = w.shape
                x = torch.clamp((u * wd).long(), max=wd - 1)
                y = torch.clamp((v * h).long(), max=h - 1)
                val = val + w[y, x] * cv[:, c]
            out = torch.where(tex_id == t, val, out)
        return out

    # -------------------------------------------------------- intersection

    def _rects(self, o, d, t_lo, t_hi):
        dn = _bdot(d, self.r_nu)
        t = (_bdot(-o, self.r_nu) + _dot(self.r_c, self.r_nu)) / dn
        ok = (dn != 0) & (t > t_lo[:, None]) & (t < t_hi[:, None])
        a = ((_bdot(o, self.r_u) - _dot(self.r_c, self.r_u))
             + t * _bdot(d, self.r_u)) / _dot(self.r_u, self.r_u)
        b = ((_bdot(o, self.r_v) - _dot(self.r_c, self.r_v))
             + t * _bdot(d, self.r_v)) / _dot(self.r_v, self.r_v)
        ok = ok & (a.abs() <= 1.0) & (b.abs() <= 1.0)
        return torch.where(ok, t, math.inf)

    def _spheres(self, o, d, t_lo, t_hi):
        ocd = _bdot(d, self.s_c)
        b = _dot(o, d)[:, None] - ocd  # (o - c) . d
        cc = (_dot(o, o)[:, None] - 2.0 * _bdot(o, self.s_c)
              + _dot(self.s_c, self.s_c) - self.s_r * self.s_r)
        a = _dot(d, d)[:, None]
        disc = b * b - a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = (-b - sq) / a, (-b + sq) / a
        lo = t_lo[:, None]
        t = torch.where(t0 > lo, t0, t1)
        ok = (disc >= 0) & (t > lo) & (t < t_hi[:, None])
        return torch.where(ok, t, math.inf)

    def _disks(self, o, d, t_lo, t_hi):
        dn = _bdot(d, self.d_n)
        t = (_dot(self.d_c, self.d_n) - _bdot(o, self.d_n)) / dn
        px = o[:, 0:1] + t * d[:, 0:1] - self.d_c[:, 0]
        py = o[:, 1:2] + t * d[:, 1:2] - self.d_c[:, 1]
        pz = o[:, 2:3] + t * d[:, 2:3] - self.d_c[:, 2]
        ok = ((dn != 0) & (t > t_lo[:, None]) & (t < t_hi[:, None])
              & (px * px + py * py + pz * pz <= self.d_r * self.d_r))
        return torch.where(ok, t, math.inf)

    def _tris(self, o, d, t_lo, t_hi, p):
        """Moller-Trumbore of rays [n] against triangles p [T, 3, 3] ->
        (t [n, T] with inf for a miss, u, v)."""
        p0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        pvx = dy * e2[:, 2] - dz * e2[:, 1]
        pvy = dz * e2[:, 0] - dx * e2[:, 2]
        pvz = dx * e2[:, 1] - dy * e2[:, 0]
        det = e1[:, 0] * pvx + e1[:, 1] * pvy + e1[:, 2] * pvz
        inv = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
        tx, ty, tz = o[:, 0:1] - p0[:, 0], o[:, 1:2] - p0[:, 1], \
            o[:, 2:3] - p0[:, 2]
        bu = (tx * pvx + ty * pvy + tz * pvz) * inv
        qx = ty * e1[:, 2] - tz * e1[:, 1]
        qy = tz * e1[:, 0] - tx * e1[:, 2]
        qz = tx * e1[:, 1] - ty * e1[:, 0]
        bv = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
        ok = ((det.abs() > 1e-12) & (bu >= 0) & (bv >= 0) & (bu + bv <= 1)
              & (t > t_lo[:, None]) & (t < t_hi[:, None]))
        return torch.where(ok, t, math.inf), bu, bv

    def _mesh_candidates(self, o, d, t_lo, t_hi, mesh):
        """Indices of the rays whose segment meets a mesh's bounding
        sphere."""
        c, r, _, _ = mesh
        c = torch.tensor(c, dtype=o.dtype, device=o.device)
        oc = o - c
        b = _dot(oc, d)
        a = _dot(d, d)
        disc = b * b - a * (_dot(oc, oc) - r * r)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        ok = (disc >= 0) & ((-b + sq) / a > t_lo) & ((-b - sq) / a < t_hi)
        return torch.nonzero(ok).squeeze(1)

    def closest(self, o, d):
        """The closest hit of rays o, d [N, 3] -> (t, kind, index, bu, bv),
        t inf where nothing is hit."""
        n = o.shape[0]
        t_lo = torch.full((n,), T_MIN, dtype=o.dtype, device=o.device)
        t_hi = torch.full((n,), T_MAX, dtype=o.dtype, device=o.device)
        best = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
        kind = torch.full((n,), -1, dtype=torch.long, device=o.device)
        idx = torch.zeros((n,), dtype=torch.long, device=o.device)
        bu = torch.zeros_like(best)
        bv = torch.zeros_like(best)
        for k, fn, count in ((K_RECT, self._rects, len(self.r_mat)),
                             (K_SPHERE, self._spheres, len(self.s_mat)),
                             (K_DISK, self._disks, len(self.d_mat))):
            if count == 0:
                continue
            t, i = fn(o, d, t_lo, t_hi).min(dim=1)
            better = t < best
            best = torch.where(better, t, best)
            kind = torch.where(better, k, kind)
            idx = torch.where(better, i, idx)
        for mesh in self.meshes:
            cand = self._mesh_candidates(o, d, t_lo, torch.minimum(t_hi, best),
                                         mesh)
            _, _, start, end = mesh
            for s in range(0, cand.shape[0], TRI_CHUNK):
                ci = cand[s:s + TRI_CHUNK]
                t, u, v = self._tris(o[ci], d[ci], t_lo[ci], t_hi[ci],
                                     self.t_p[start:end])
                tm, i = t.min(dim=1)
                better = tm < best[ci]
                ii = ci[better]
                j = i[better]
                best[ii] = tm[better]
                kind[ii] = K_TRI
                idx[ii] = start + j
                bu[ii] = u[better, j]
                bv[ii] = v[better, j]
        return best, kind, idx, bu, bv

    def blocked(self, o, d, t_hi):
        """Whether anything lies on each ray within (T_MIN, t_hi)."""
        n = o.shape[0]
        t_lo = torch.full((n,), T_MIN, dtype=o.dtype, device=o.device)
        hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
        for fn, count in ((self._rects, len(self.r_mat)),
                          (self._spheres, len(self.s_mat)),
                          (self._disks, len(self.d_mat))):
            if count:
                hit = hit | torch.isfinite(fn(o, d, t_lo, t_hi)).any(dim=1)
        for mesh in self.meshes:
            cand = self._mesh_candidates(o, d, t_lo, t_hi, mesh)
            _, _, start, end = mesh
            for s in range(0, cand.shape[0], TRI_CHUNK):
                ci = cand[s:s + TRI_CHUNK]
                t, _, _ = self._tris(o[ci], d[ci], t_lo[ci], t_hi[ci],
                                     self.t_p[start:end])
                hit[ci] = hit[ci] | torch.isfinite(t).any(dim=1)
        return hit

    def surface(self, o, d, t, kind, idx, bu, bv):
        """Hit attributes -> (point, geometric normal, uv, material)."""
        p = o + t[:, None] * d
        z3 = torch.zeros_like(p)
        n = z3
        uv = torch.zeros_like(p[:, :2])
        mat = torch.zeros_like(idx)
        if len(self.r_mat):
            i = torch.clamp(idx, max=len(self.r_mat) - 1)
            rel = p - self.r_c[i]
            ru, rv = self.r_u[i], self.r_v[i]
            r_uv = torch.stack([0.5 * (_dot(rel, ru) / _dot(ru, ru) + 1.0),
                                0.5 * (_dot(rel, rv) / _dot(rv, rv) + 1.0)], -1)
            m = (kind == K_RECT)
            n = torch.where(m[:, None], self.r_n[i], n)
            uv = torch.where(m[:, None], r_uv, uv)
            mat = torch.where(m, self.r_mat[i], mat)
        if len(self.s_mat):
            i = torch.clamp(idx, max=len(self.s_mat) - 1)
            sn = _normalize(p - self.s_c[i])
            s_u = torch.remainder(torch.atan2(sn[:, 1], sn[:, 0]) / (2 * PI),
                                  1.0)
            s_v = torch.acos(torch.clamp(sn[:, 2], -1.0, 1.0)) / PI
            m = (kind == K_SPHERE)
            n = torch.where(m[:, None], sn, n)
            uv = torch.where(m[:, None], torch.stack([s_u, s_v], -1), uv)
            mat = torch.where(m, self.s_mat[i], mat)
        if len(self.d_mat):
            i = torch.clamp(idx, max=len(self.d_mat) - 1)
            m = (kind == K_DISK)
            n = torch.where(m[:, None], self.d_n[i], n)
            mat = torch.where(m, self.d_mat[i], mat)
        if len(self.t_mat):
            i = torch.clamp(idx, max=len(self.t_mat) - 1)
            tp = self.t_p[i]
            tn = _normalize(_cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]))
            m = (kind == K_TRI)
            n = torch.where(m[:, None], tn, n)
            uv = torch.where(m[:, None], torch.stack([bu, bv], -1), uv)
            mat = torch.where(m, self.t_mat[i], mat)
        return p, n, uv, mat

    def sample_light(self, u0, u1, u2):
        """A uniformly picked light and a uniform point on it -> (point,
        unit normal, 1 / area, material)."""
        nl = len(self.lights)
        j = torch.clamp((u0 * nl).long(), max=nl - 1)
        kind, i = self.l_kind[j], self.l_idx[j]
        z = torch.zeros((u0.shape[0], 3), dtype=u1.dtype, device=u1.device)
        p, n = z, z
        if len(self.r_mat):
            ir = torch.clamp(i, max=len(self.r_mat) - 1)
            pr = (self.r_c[ir] + self.r_u[ir] * (2 * u1 - 1)[:, None]
                  + self.r_v[ir] * (2 * u2 - 1)[:, None])
            m = (kind == K_RECT)[:, None]
            p, n = torch.where(m, pr, p), torch.where(m, self.r_n[ir], n)
        if len(self.s_mat):
            i_s = torch.clamp(i, max=len(self.s_mat) - 1)
            zz = 1 - 2 * u1
            rr = torch.sqrt(torch.clamp(1 - zz * zz, min=0.0))
            ph = 2 * PI * u2
            sn = torch.stack([rr * torch.cos(ph), rr * torch.sin(ph), zz], -1)
            m = (kind == K_SPHERE)[:, None]
            p = torch.where(m, self.s_c[i_s] + sn * self.s_r[i_s][:, None], p)
            n = torch.where(m, sn, n)
        if len(self.d_mat):
            i_d = torch.clamp(i, max=len(self.d_mat) - 1)
            dn = self.d_n[i_d]
            t_ax, b_ax = _basis(dn)
            rr = torch.sqrt(u1) * self.d_r[i_d]
            ph = 2 * PI * u2
            pd = (self.d_c[i_d] + t_ax * (rr * torch.cos(ph))[:, None]
                  + b_ax * (rr * torch.sin(ph))[:, None])
            m = (kind == K_DISK)[:, None]
            p, n = torch.where(m, pd, p), torch.where(m, dn, n)
        if len(self.t_mat):
            i_t = torch.clamp(i, max=len(self.t_mat) - 1)
            tp = self.t_p[i_t]
            su = torch.sqrt(u1)
            pt = (tp[:, 0] * (1 - su)[:, None] + tp[:, 1] * (su * (1 - u2))[:, None]
                  + tp[:, 2] * (su * u2)[:, None])
            tn = _normalize(_cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]))
            m = (kind == K_TRI)[:, None]
            p, n = torch.where(m, pt, p), torch.where(m, tn, n)
        return p, n, 1.0 / self.l_area[j], self.l_mat[j], nl

    def camera_rays(self, fu, fv, aspect):
        """Pinhole rays through film points (u right, v down, in [0, 1))
        of a film `aspect` = width / height."""
        hw = float(torch.tensor(self.cam_hh * aspect, dtype=torch.float32))
        focal = (self.cam_f * self.cam_w
                 + ((fu * 2 - 1) * hw)[:, None] * self.cam_u
                 + ((1 - fv * 2) * self.cam_hh)[:, None] * self.cam_v)
        return self.cam_o.expand_as(focal), _normalize(focal)


def _basis(n):
    """An orthonormal tangent and bitangent of unit normals n [N, 3]
    (Duff et al. 2017)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                     -sign * n[:, 0]], -1)
    bt = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return t, bt


# ------------------------------------------------------------------ BSDFs


def _ggx_d(alpha, h):
    a2 = alpha * alpha
    den = h[:, 2] * h[:, 2] * a2 + h[:, 0] * h[:, 0] + h[:, 1] * h[:, 1]
    return a2 / torch.clamp(PI * den * den, min=1e-20)


def _lambda(alpha, z):
    c2 = z * z
    tan2 = torch.clamp(1 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    return 0.5 * (torch.sqrt(1 + alpha * alpha * tan2) - 1)


def _fresnel(eta_a, eta_b, cos_i):
    """Unpolarised dielectric Fresnel reflectance for light meeting the
    boundary from the side `cos_i` > 0 names (eta_a there)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    ent = cos_i > 0
    ei, et = torch.where(ent, eta_a, eta_b), torch.where(ent, eta_b, eta_a)
    ci = cos_i.abs()
    s2 = (ei / et) ** 2 * torch.clamp(1 - ci * ci, min=0.0)
    ct = torch.sqrt(torch.clamp(1 - s2, min=0.0))
    rpa = (et * ci - ei * ct) / (et * ci + ei * ct)
    rpe = (ei * ci - et * ct) / (ei * ci + et * ct)
    f = torch.nan_to_num(0.5 * (rpa * rpa + rpe * rpe))
    return torch.where(s2 >= 1, 1.0, torch.clamp(f, 0.0, 1.0))


def _sanitise(x):
    return torch.where(torch.isfinite(x) & (x >= 0), x, 0.0)


def ggx_eval(alpha, eta_in, eta_out, perm, wi, wo, radiance=True):
    """(f, pdf) of the GGX dielectric for local directions wi, wo; the
    transmission lobe carries (eta_from / eta_to)^2 for radiance only."""
    outside = wi[:, 2] > 0
    e_from = torch.where(outside, eta_out, eta_in)
    e_to = torch.where(outside, eta_in, eta_out)
    aci = torch.clamp(wi[:, 2].abs(), min=1e-7)
    aco = torch.clamp(wo[:, 2].abs(), min=1e-7)
    g2 = 1 / (1 + _lambda(alpha, wi[:, 2]) + _lambda(alpha, wo[:, 2]))
    g1 = 1 / (1 + _lambda(alpha, wi[:, 2].abs()))
    # reflection
    h = _normalize(wi + wo)
    h = torch.where((h[:, 2] * wi[:, 2] < 0)[:, None], -h, h)
    dr = _ggx_d(alpha, h)
    cih = _dot(wi, h)
    fr = _fresnel(e_from, e_to, cih)
    f_r = fr * dr * g2 / (4 * aci * aco)
    p_r = (g1 * dr * cih.abs() / wi[:, 2].abs()) / torch.clamp(4 * cih.abs(),
                                                               min=1e-7)
    pr_r = torch.clamp(1 - perm * (1 - fr), 0.0, 1.0)
    # transmission
    ht = _normalize(-(wi * e_from[:, None] + wo * e_to[:, None]))
    htu = torch.where((ht[:, 2] < 0)[:, None], -ht, ht)
    dt_ = _ggx_d(alpha, htu)
    ci_t, co_t = _dot(wi, ht), _dot(wo, ht)
    ft = _fresnel(e_from, e_to, ci_t)
    den = e_from * ci_t + e_to * co_t
    den2 = den * den
    f_t = ((ci_t * co_t).abs() * (1 - ft) * dt_ * g2 * e_to * e_to / den2
           / (aci * aco)) * perm
    if radiance:
        f_t = f_t * (e_from * e_from / (e_to * e_to))
    p_t = (g1 * dt_ * _dot(wi, htu).abs() / wi[:, 2].abs()
           * e_to * e_to * co_t.abs() / den2)
    pr_t = torch.clamp(1 - perm * (1 - ft), 0.0, 1.0)
    same = wi[:, 2] * wo[:, 2] > 0
    f = torch.where(same, f_r, f_t)
    pdf = torch.where(same, p_r * pr_r, p_t * (1 - pr_t))
    return _sanitise(f), _sanitise(pdf)


def ggx_sample(alpha, eta_in, eta_out, perm, wi, u1, u2, u_lobe,
               radiance=True):
    """A GGX dielectric sample -> (wo, pdf, weight = f |cos| / pdf)."""
    flip = wi[:, 2] < 0
    w = torch.where(flip[:, None], -wi, wi)
    v = _normalize(torch.stack([alpha * w[:, 0], alpha * w[:, 1], w[:, 2]], -1))
    lsq = v[:, 0] ** 2 + v[:, 1] ** 2
    big = lsq > 1e-12
    il = 1 / torch.sqrt(torch.clamp(lsq, min=1e-20))
    t1 = torch.stack([torch.where(big, -v[:, 1] * il, 1.0),
                      torch.where(big, v[:, 0] * il, 0.0),
                      torch.zeros_like(lsq)], -1)
    t2 = _cross(v, t1)
    r = torch.sqrt(u1)
    ph = 2 * PI * u2
    p1, p2 = r * torch.cos(ph), r * torch.sin(ph)
    s = 0.5 * (1 + v[:, 2])
    p2 = (1 - s) * torch.sqrt(torch.clamp(1 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1 - p1 * p1 - p2 * p2, min=0.0))
    nh = t1 * p1[:, None] + t2 * p2[:, None] + v * p3[:, None]
    h = _normalize(torch.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                                torch.clamp(nh[:, 2], min=1e-6)], -1))
    h = torch.where(flip[:, None], -h, h)

    cih = _dot(wi, h)
    outside = wi[:, 2] > 0
    e_from = torch.where(outside, eta_out, eta_in)
    e_to = torch.where(outside, eta_in, eta_out)
    fr = _fresnel(e_from, e_to, cih)
    p_refl = torch.clamp(1 - perm * (1 - fr), 0.0, 1.0)
    wo_r = -wi + h * (2 * cih)[:, None]
    hn = torch.where((cih < 0)[:, None], -h, h)
    eta = e_from / torch.clamp(e_to, min=1e-7)
    ci = _dot(wi, hn)
    s2t = eta * eta * torch.clamp(1 - ci * ci, min=0.0)
    tir = s2t >= 1
    ct = torch.sqrt(torch.clamp(1 - s2t, min=0.0))
    wo_t = -wi * eta[:, None] + hn * (eta * ci - ct)[:, None]
    refl = (u_lobe < p_refl) | tir
    wo = torch.where(refl[:, None], wo_r, wo_t)
    _, pdf = ggx_eval(alpha, eta_in, eta_out, perm, wi, wo, radiance)
    g2 = 1 / (1 + _lambda(alpha, wi[:, 2]) + _lambda(alpha, wo[:, 2]))
    g1 = 1 / (1 + _lambda(alpha, wi[:, 2].abs()))
    ratio = g2 / g1
    same = wi[:, 2] * wo[:, 2] > 0
    w_r = torch.where(p_refl != 0, fr * ratio / p_refl, 0.0)
    w_t = ratio * (e_from * e_from / (e_to * e_to) if radiance else 1.0)
    weight = torch.where(refl, torch.where(same, w_r, 0.0),
                         torch.where(same, 0.0, w_t))
    return wo, pdf, _sanitise(weight)


class Shading:
    """The material at each lane's surface point: its BSDF for local
    directions, and a sample of it."""

    def __init__(self, scene, mat, cv, uv, wi):
        mk = scene.m_kind[mat]
        self.wi = wi
        refl = torch.where(
            mk == M_LAMBERT, scene.texture(scene.m_tex[mat], cv, uv),
            torch.gather(cv, 1, scene.m_bounce[mat][:, None])[:, 0])
        self.refl = torch.clamp(refl, max=1.0)
        self.is_ggx = mk == M_GGX
        self.alpha = scene.m_alpha[mat]
        self.eta_in = torch.clamp(
            torch.gather(cv, 1, scene.m_eta[mat][:, None])[:, 0], min=1e-3)
        self.eta_out = torch.clamp(
            torch.gather(cv, 1, scene.m_eta_o[mat][:, None])[:, 0], min=1e-3)
        self.perm = scene.m_perm[mat]

    def _ggx(self):
        return self.alpha, self.eta_in, self.eta_out, self.perm, self.wi

    def eval(self, wo, radiance=True):
        """(f, solid-angle pdf) toward local directions wo."""
        same = self.wi[:, 2] * wo[:, 2] > 0
        f_l = torch.where(same, self.refl / PI, 0.0)
        p_l = torch.where(same, wo[:, 2].abs() / PI, 0.0)
        f_g, p_g = ggx_eval(*self._ggx(), wo, radiance)
        return (torch.where(self.is_ggx, f_g, f_l),
                torch.where(self.is_ggx, p_g, p_l))

    def sample(self, u, radiance=True):
        """A sampled local direction from uniforms u [n, 3+] -> (wo, pdf,
        weight = f |cos| / pdf): a lambertian's cosine lobe on wi's side,
        or the GGX sample."""
        r = torch.sqrt(u[:, 0])
        ph = 2 * PI * u[:, 1]
        wo_l = torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                            torch.sqrt(torch.clamp(1 - u[:, 0], min=0.0))], -1)
        flip = torch.tensor([1, 1, -1], dtype=wo_l.dtype, device=wo_l.device)
        wo_l = torch.where((self.wi[:, 2] < 0)[:, None], wo_l * flip, wo_l)
        wo_g, _, w_g = ggx_sample(*self._ggx(), u[:, 0], u[:, 1], u[:, 2],
                                  radiance)
        wo = torch.where(self.is_ggx[:, None], wo_g, wo_l)
        _, pdf = self.eval(wo, radiance)
        return wo, pdf, torch.where(self.is_ggx, w_g, self.refl)


# ------------------------------------------------------------- the tracer


def render(scene: Scene, width: int, height: int, spp: int,
           settings: Settings, generator: torch.Generator,
           lanes: int = 1 << 20):
    """`spp` samples of every pixel -> (film [H, W, 3] float32 XYZ,
    counters {"camera_rays", "bounce_rays", "shadow_rays"})."""
    dev, dt = scene.device, scene.dtype
    n_pix = width * height
    total = n_pix * spp
    film = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros(3, dtype=torch.float64, device=dev)
    span = spectra.LAMBDA_HI - spectra.LAMBDA_LO
    ls = settings.light_samples
    med = scene.media if settings.medium_aware and scene.media.count else None

    def rand(n, k):
        return torch.rand((n, k), generator=generator, device=dev).to(dt)

    for start in range(0, total, lanes):
        n = min(lanes, total - start)
        pix = torch.remainder(torch.arange(start, start + n, device=dev), n_pix)
        r0 = rand(n, 3)
        fu = ((pix % width).to(dt) + r0[:, 0]) / width
        fv = ((pix // width).to(dt) + r0[:, 1]) / height
        lam_all = spectra.LAMBDA_LO + r0[:, 2] * span
        o, d = scene.camera_rays(fu, fv, width / height)
        rad = torch.zeros((n,), dtype=dt, device=dev)
        live = torch.arange(n, device=dev)
        beta = torch.ones((n,), dtype=dt, device=dev)
        prev_pdf = torch.zeros((n,), dtype=dt, device=dev)
        if med is not None:  # the media each path is in, by medium
            inside = torch.zeros((n, med.count), dtype=torch.long, device=dev)
        cnt[0] += n
        for bounce in range(settings.max_bounces):
            if live.numel() == 0:
                break
            m = live.shape[0]
            lam = lam_all[live]
            t, kind, idx, bu, bv = scene.closest(o, d)
            hit = torch.isfinite(t)
            t_surface = t
            t = torch.where(hit, t, 0.0)
            p, gn, uv, mat = scene.surface(o, d, t, kind, idx, bu, bv)
            cv = scene.curves_at(lam)
            mk = scene.m_kind[mat]
            add = torch.zeros((m,), dtype=dt, device=dev)
            on_surface = at_vertex = hit
            if med is not None:
                # the free flight: a scatter before the surface, and the
                # absorption of the distance flown either way
                fl = med.fly(inside, cv, lam, t_surface, rand(m, 4))
                scat = fl.scattered
                on_surface, at_vertex = hit & ~scat, hit | scat
                beta = beta * fl.absorption
                sp = o + fl.travel[:, None] * d

            # a light hit, weighted against next-event estimation
            cos_l = _dot(gn, -d)
            side = scene.m_side[mat]
            gate = torch.where(side == 2, cos_l != 0,
                               torch.where(side == 0, cos_l > 0, cos_l < 0))
            spd = torch.gather(cv, 1, scene.m_emit[mat][:, None])[:, 0]
            le = torch.where(on_surface & (mk == M_LIGHT) & gate, spd / PI,
                             0.0)
            area = scene.prim_area(kind, idx)
            hyp = (1.0 / len(scene.lights)) * (t * t) / (cos_l.abs() * area)
            hyp = torch.where(cos_l.abs() * area != 0, hyp, 0.0)
            w_hit = torch.where(
                (bounce > 0) & (ls > 0) & (prev_pdf + hyp > 0),
                prev_pdf / (prev_pdf + torch.clamp(hyp, min=0.0)), 1.0)
            add = add + beta * le * w_hit

            # shading frame and the material at each lane
            tt, bt = _basis(gn)
            wi = torch.stack([_dot(-d, tt), _dot(-d, bt), _dot(-d, gn)], -1)
            sh = Shading(scene, mat, cv, uv, wi)

            # next-event estimation
            for _ in range(ls):
                u = rand(m, 3)
                lp, ln, inv_area, lmat, nl = scene.sample_light(
                    u[:, 0], u[:, 1], u[:, 2])
                src = p if med is None else torch.where(scat[:, None], sp, p)
                to_l = lp - src
                dist2 = torch.clamp(_dot(to_l, to_l), min=1e-12)
                dist = torch.sqrt(dist2)
                wl = to_l / dist[:, None]
                cos_at = _dot(ln, -wl)
                lside = scene.m_side[lmat]
                lgate = torch.where(lside == 2, cos_at != 0,
                                    torch.where(lside == 0, cos_at > 0,
                                                cos_at < 0))
                lspd = torch.gather(cv, 1, scene.m_emit[lmat][:, None])[:, 0]
                le_n = torch.where(lgate, lspd / PI, 0.0)
                pdf_l = (1.0 / nl) * inv_area * dist2 / cos_at.abs()
                pdf_l = torch.where(cos_at != 0, pdf_l, 0.0)
                wo = torch.stack([_dot(wl, tt), _dot(wl, bt), _dot(wl, gn)], -1)
                f, pdf_b = sh.eval(wo)
                thr = f * wo[:, 2].abs()
                if med is not None:  # at a scatter, the phase function
                    ph = media.phase(fl, _dot(d, wl))
                    thr = torch.where(scat, ph, thr)
                    pdf_b = torch.where(scat, ph, pdf_b)
                worth = at_vertex & (le_n > 0) & (pdf_l > 1e-12) & (thr > 0)
                so = p + gn * (NORMAL_OFFSET * torch.sign(
                    _dot(gn, wl) + 1e-9))[:, None]
                if med is not None:  # no offset at a scatter point
                    so = torch.where(scat[:, None], sp, so)
                wk = torch.nonzero(worth).squeeze(1)
                clear = torch.zeros((m,), dtype=torch.bool, device=dev)
                clear[wk] = ~scene.blocked(so[wk], wl[wk], (dist * 0.99)[wk])
                w_n = torch.where(pdf_l + pdf_b > 0,
                                  pdf_l / (pdf_l + torch.clamp(pdf_b, min=0)),
                                  1.0)
                contrib = beta * thr * le_n * torch.where(
                    pdf_l != 0, w_n / pdf_l, 0.0) / ls
                if med is not None:  # through the media on the ray's side
                    side = torch.where(scat[:, None], inside, med.cross(
                        inside, mat, wi[:, 2], wo[:, 2]))
                    contrib = contrib * media.transmittance(
                        side, fl.sigma_t_k, dist)
                add = add + torch.where(clear, contrib, 0.0)
                cnt[2] += wk.numel()
            rad[live] += add

            # the BSDF sample and Russian roulette
            u = rand(m, 4)
            wo, pdf_s, weight = sh.sample(u)
            d_new = _normalize(tt * wo[:, 0:1] + bt * wo[:, 1:2]
                               + gn * wo[:, 2:3])
            o_new = p + gn * (NORMAL_OFFSET * torch.sign(
                _dot(gn, d_new)))[:, None]
            if med is not None:
                # a scatter continues along the phase sample, weight 1; a
                # surface vertex moves the media across a boundary
                d_ph, pdf_ph = media.sample_phase(fl, (*_basis(d), d))
                d_new = torch.where(scat[:, None], d_ph, d_new)
                o_new = torch.where(scat[:, None], sp, o_new)
                pdf_s = torch.where(scat, pdf_ph, pdf_s)
                weight = torch.where(scat, 1.0, weight)
                inside_new = torch.where(scat[:, None], inside, med.cross(
                    inside, mat, wi[:, 2], wo[:, 2]))
            ok = (pdf_s > 1e-12) & (weight > 0)
            if settings.russian_roulette and bounce >= settings.min_bounces:
                p_cont = torch.clamp(weight, 0.05, 1.0)
            else:
                p_cont = torch.ones_like(weight)
            beta_next = beta * torch.where(ok, weight / p_cont, 0.0)
            go = (at_vertex & ok & (u[:, 3] < p_cont)
                  & torch.isfinite(beta_next)
                  & (bounce + 1 < settings.max_bounces))
            keep = torch.nonzero(go).squeeze(1)
            cnt[1] += keep.numel()
            live = live[keep]
            o, d = o_new[keep], d_new[keep]
            beta, prev_pdf = beta_next[keep], pdf_s[keep]
            if med is not None:
                inside = inside_new[keep]
        xyz = spectra.cmf(lam_all.float()) * (rad.float() * span)[:, None]
        film.index_add_(0, pix, xyz)
    counters = dict(zip(("camera_rays", "bounce_rays", "shadow_rays"),
                        cnt.tolist()))
    return (film / spp).reshape(height, width, 3), counters
