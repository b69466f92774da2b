"""The plain reference light tracer, on `pt.Scene`.

The same estimator as the program's light tracer under a pinhole camera:
a particle starts on a uniformly picked light, at a uniform point, with a
wavelength drawn from the light's emission SPD over [380, 780] nm and a
cosine-weighted direction on its emitting side. The light vertex and every
surface vertex it reaches (at most `max_bounces`) connect to the pinhole
through a shadow ray and splat W_e = focal^2 / (cos^3 theta A_film) times
the throughput, the 1 / d^2 and the BSDF toward the camera (for adjoint
transport: no (eta_from / eta_to)^2) onto the pixel the connection lands
in; the walk continues by a BSDF sample with Russian roulette from bounce
`min_bounces` on. The film is the splat sum times pixels / paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spectra
from .pt import (NORMAL_OFFSET, PI, Scene, Shading, _basis, _dot,
                 _normalize)

LAMBDA_BINS = 8192  # the emission SPD's tabulation, for sampling wavelengths


@dataclasses.dataclass(frozen=True)
class Settings:
    max_bounces: int = 8
    min_bounces: int = 1
    camera_samples: int = 1
    russian_roulette: bool = True


class _Spectra:
    """Wavelength sampling from each light material's emission SPD: bins
    of equal width with a piecewise-constant density, pdf exact."""

    def __init__(self, scene: Scene):
        edges = np.linspace(spectra.LAMBDA_LO, spectra.LAMBDA_HI,
                            LAMBDA_BINS + 1)
        mids = torch.tensor(0.5 * (edges[1:] + edges[:-1]))
        self.width = (spectra.LAMBDA_HI - spectra.LAMBDA_LO) / LAMBDA_BINS
        self.cdf, self.dens = {}, {}
        for m in sorted(set(scene.l_mat.tolist())):
            spec = scene.curve_specs[int(scene.m_emit[m])]
            v = torch.clamp(spectra.curve(spec, mids), min=0.0)
            total = float(v.sum()) * self.width
            self.dens[m] = (v / total).to(scene.device)
            self.cdf[m] = (torch.cumsum(v, 0) / v.sum()).to(scene.device)

    def sample(self, lmat, u_bin, u_in):
        lam = torch.zeros_like(u_bin, dtype=torch.float64)
        pdf = torch.zeros_like(lam)
        for m, cdf in self.cdf.items():
            k = torch.clamp(torch.searchsorted(cdf, u_bin.double()),
                            max=LAMBDA_BINS - 1)
            sel = lmat == m
            lam = torch.where(sel, spectra.LAMBDA_LO
                              + (k + u_in.double()) * self.width, lam)
            pdf = torch.where(sel, self.dens[m][k], pdf)
        return lam, pdf


def _camera_splat(scene, p, aspect, width, height):
    """The pinhole connection of points p [n, 3] -> (unit direction toward
    the camera, distance, pixel index, W_e, on the film)."""
    to_cam = scene.cam_o - p
    dist = torch.sqrt(torch.clamp(_dot(to_cam, to_cam), min=1e-12))
    dc = to_cam / dist[:, None]
    dd = -dc  # from the camera toward the point
    cos_f = _dot(dd, scene.cam_w.expand_as(dd))
    ok = cos_f > 1e-6
    hh = scene.cam_hh
    hw = float(torch.tensor(hh * aspect, dtype=torch.float32))
    t = scene.cam_f / torch.where(ok, cos_f, 1.0)
    rel = dd * t[:, None] - scene.cam_f * scene.cam_w
    fu = (_dot(rel, scene.cam_u.expand_as(rel)) / hw + 1) * 0.5
    fv = (1 - _dot(rel, scene.cam_v.expand_as(rel)) / hh) * 0.5
    ok = ok & (fu >= 0) & (fu < 1) & (fv >= 0) & (fv < 1)
    px = torch.clamp((fu * width).long(), 0, width - 1)
    py = torch.clamp((fv * height).long(), 0, height - 1)
    x = torch.clamp(cos_f.abs(), min=1e-6)
    a_film = (2 * hw) * (2 * hh)
    we = scene.cam_f * scene.cam_f / (x * x * x * a_film)
    return dc, dist, py * width + px, we, ok


def render(scene: Scene, width: int, height: int, paths_per_pixel: int,
           settings: Settings, generator: torch.Generator,
           lanes: int = 1 << 20):
    """`paths_per_pixel` light paths a pixel -> (film [H, W, 3] float32
    XYZ, counters {"light_rays", "bounce_rays", "camera_rays",
    "bounce_rays_traced"}).

    The two light-tracing routes of the program count bounce rays by two
    definitions: `bounce_rays` counts every walk that continues after a
    vertex, also after the last one (as the wavefront `lt_trace` does);
    `bounce_rays_traced` only those whose next ray is traced, within
    `max_bounces` (as the LT megakernel does)."""
    dev, dt = scene.device, scene.dtype
    n_pix = width * height
    total = n_pix * paths_per_pixel
    aspect = width / height
    film = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros(4, dtype=torch.float64, device=dev)
    lam_sampler = _Spectra(scene)
    cs = settings.camera_samples

    def rand(n, k):
        return torch.rand((n, k), generator=generator, device=dev).to(dt)

    def splat(p, n_geo, weight, lam, cv_lam_fn):
        """Connect points p to the camera, splat weight * cv_lam_fn(dir)
        (the vertex's factor toward the camera) where unblocked."""
        dc, dist, pix, we, ok = _camera_splat(scene, p, aspect, width,
                                              height)
        e = weight * we / (dist * dist) * cv_lam_fn(dc)
        ok = ok & (e > 0) & torch.isfinite(e)
        so = p + n_geo * (NORMAL_OFFSET * torch.sign(_dot(n_geo, dc)
                                                     + 1e-9))[:, None]
        wk = torch.nonzero(ok).squeeze(1)
        clear = torch.zeros_like(ok)
        clear[wk] = ~scene.blocked(so[wk], dc[wk], (dist * 0.99)[wk])
        cnt[2] += int(clear.sum())
        xyz = spectra.cmf(lam.float()) * torch.where(clear, e, 0.0).float()[:, None]
        film.index_add_(0, pix, xyz)

    for start in range(0, total, lanes):
        n = min(lanes, total - start)
        u = rand(n, 8)
        lp, ln, inv_area, lmat, nl = scene.sample_light(u[:, 0], u[:, 1],
                                                        u[:, 2])
        lam64, lam_pdf = lam_sampler.sample(lmat, u[:, 3], u[:, 7])
        lam, lam_pdf = lam64.to(dt), lam_pdf.to(dt)
        spd = torch.gather(scene.curves_at(lam), 1,
                           scene.m_emit[lmat][:, None])[:, 0]
        side = scene.m_side[lmat]
        rev = (side == 1) | ((side == 2) & (u[:, 6] < 0.5))
        nn = torch.where(rev[:, None], -ln, ln)
        r = torch.sqrt(u[:, 4])
        ph = 2 * PI * u[:, 5]
        lz = torch.sqrt(torch.clamp(1 - u[:, 4], min=0.0))
        ta, tb = _basis(nn)
        d = _normalize(ta * (r * torch.cos(ph))[:, None]
                       + tb * (r * torch.sin(ph))[:, None] + nn * lz[:, None])
        dir_pdf = lz / PI * torch.where(side == 2, 0.5, 1.0)
        pick = 1.0 / nl
        # the light vertex: W_e and Le toward the camera
        base = 1.0 / (pick * inv_area * lam_pdf)

        def light_factor(dc):
            c = _dot(ln, dc)
            gate = torch.where(side == 2, c != 0,
                               torch.where(side == 0, c > 0, c < 0))
            return torch.where(gate, spd / PI, 0.0) * c.abs()

        cnt[0] += n
        splat(lp, ln, base, lam, light_factor)
        beta = base * (spd / PI) * lz / dir_pdf
        beta = torch.where(torch.isfinite(beta) & (dir_pdf > 0), beta, 0.0)
        o = lp + ln * (NORMAL_OFFSET * torch.sign(_dot(ln, d)))[:, None]
        live = torch.nonzero(beta > 0).squeeze(1)
        o, d, beta, lam = o[live], d[live], beta[live], lam[live]
        for bounce in range(settings.max_bounces):
            if live.numel() == 0:
                break
            m = live.shape[0]
            t, kind, idx, bu, bv = scene.closest(o, d)
            hit = torch.isfinite(t)
            keep = torch.nonzero(hit).squeeze(1)
            o, d, beta, lam, t = o[keep], d[keep], beta[keep], lam[keep], \
                t[keep]
            kind, idx, bu, bv = kind[keep], idx[keep], bu[keep], bv[keep]
            p, gn, uv, mat = scene.surface(o, d, t, kind, idx, bu, bv)
            cv = scene.curves_at(lam)
            tt, bt = _basis(gn)
            wi = torch.stack([_dot(-d, tt), _dot(-d, bt), _dot(-d, gn)], -1)
            sh = Shading(scene, mat, cv, uv, wi)

            def vertex_factor(dc):
                wo = torch.stack([_dot(dc, tt), _dot(dc, bt), _dot(dc, gn)],
                                 -1)
                f, _ = sh.eval(wo, radiance=False)
                return f * wo[:, 2].abs()

            for _ in range(cs):
                splat(p, gn, beta / cs, lam, vertex_factor)
            uu = rand(m, 4)[keep]
            wo, pdf_s, weight = sh.sample(uu, radiance=False)
            ok = (pdf_s > 1e-12) & (weight > 0)
            if settings.russian_roulette and bounce >= settings.min_bounces:
                p_cont = torch.clamp(weight, 0.05, 1.0)
            else:
                p_cont = torch.ones_like(weight)
            beta_next = beta * torch.where(ok, weight / p_cont, 0.0)
            go = ok & (uu[:, 3] < p_cont) & torch.isfinite(beta_next)
            d_new = _normalize(tt * wo[:, 0:1] + bt * wo[:, 1:2]
                               + gn * wo[:, 2:3])
            o_new = p + gn * (NORMAL_OFFSET * torch.sign(
                _dot(gn, d_new)))[:, None]
            nxt = torch.nonzero(go).squeeze(1)
            cnt[1] += nxt.numel()
            if bounce + 1 < settings.max_bounces:
                cnt[3] += nxt.numel()
            live = live[keep][nxt]
            o, d, beta, lam = o_new[nxt], d_new[nxt], beta_next[nxt], lam[nxt]
    counters = dict(zip(("light_rays", "bounce_rays", "camera_rays",
                         "bounce_rays_traced"), cnt.tolist()))
    return (film * (n_pix / total)).reshape(height, width, 3), counters
