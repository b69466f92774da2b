"""Light tracing: particle emission and the light vertex's lens connection
(counterpart of `integrator/lt.py`).

A particle starts on an instance light (or, with the environment's
sampling probability, on a disk of the world bounds facing inward), with a
wavelength drawn from the light's emission spectrum and a direction from
its cosine or cosine-power lobe. `spawn_particles` and
`_connect_to_camera_values` are what the LT megakernel's spawn feed runs
(`kernels/lt_mega.py:lt_spawn_feed`, the route for Sun and HDR
environments). The XLA wavefront `lt_trace` is not ported: scenes outside
the megakernel's gate are refused (ROADMAP §1 item 11).

Vectors are `V3`s of per-lane tensors (`kernels/cmath.py`); uniforms are
`[n, k]` columns, as the JAX functions take them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracer_tpu_torch.core.bounds import BOUNDED_VISIBLE_RANGE, Bounds1D
from pathtracer_tpu_torch.core.sampling import (
    power_cosine_direction,
    random_in_unit_disk,
)
from pathtracer_tpu_torch.geometry.soa import sample_surface
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels.cmath import V3, fdiv
from pathtracer_tpu_torch.materials.tables import (
    MAT_SHARP_LIGHT,
    emission,
    emission_direction_pdf,
    sample_emission_spectrum,
)
from pathtracer_tpu_torch.prelude import NORMAL_OFFSET, safe_div
from pathtracer_tpu_torch.world.environment import env_emission, env_sample_uv


@dataclasses.dataclass(frozen=True)
class LTSettings:
    """The light tracer's settings (the reference's RenderSettings with
    IntegratorKind::LT). `stratified` jitters the emitter surface (u, v)
    over a strata_uv² grid and λ over strata_lam strata, cycled over the
    particles through a random permutation of the cells."""

    max_bounces: int = 8
    min_bounces: int = 1
    camera_samples: int = 1
    russian_roulette: bool = True
    wavelength_bounds: Bounds1D = BOUNDED_VISIBLE_RANGE
    stratified: bool = False
    strata_uv: int = 20
    strata_lam: int = 10


def _f32(x) -> float:
    return float(np.float32(x))


def _sample_emission_direction(world, mat_id, normal: V3, u1, u2, u_side):
    """A direction from a light surface point (diffuse: cosine lobe; sharp:
    cosine-power lobe of its sharpness), sidedness-aware -> (direction V3,
    solid-angle pdf, |cosθ|)."""
    mats = world.mats
    mid = mat_id.long()
    sharp = mats.mtype[mid] == MAT_SHARP_LIGHT
    nexp = torch.where(sharp, mats.sharpness[mid], 1.0)
    local = power_cosine_direction(u1, u2, nexp)
    side = mats.sidedness[mid]
    pick_rev = torch.where(side == 1, True,
                           torch.where(side == 0, False, u_side < 0.5))
    t_ax, b_ax = cmath.orthonormal_basis(normal)
    frame_n = cmath.where(pick_rev, -normal, normal)
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    d = t_ax.scale(lx) + b_ax.scale(ly) + frame_n.scale(lz)
    cos_t = torch.abs(lz)
    pdf = (nexp + 1.0) * cos_t ** nexp / (2.0 * math.pi)
    pdf = torch.where(side == 2, pdf * 0.5, pdf)
    return d, pdf, cos_t


def stratify_u0(settings: LTSettings, u0, perm):
    """Particle i lands in stratum perm[i mod cells] of the emitter (u, v)
    grid and the λ strata (columns 1, 2 and 3 of u0); `perm` is a random
    permutation of the cells, so any particle count covers a uniformly
    random subset of strata."""
    n = u0.shape[0]
    suv, slam = settings.strata_uv, settings.strata_lam
    cells = suv * suv * slam
    cid = perm[torch.arange(n, device=u0.device) % cells]
    cu = (cid % suv).float()
    cv = ((cid // suv) % suv).float()
    cl = (cid // (suv * suv)).float()
    u0 = u0.clone()
    u0[:, 1] = fdiv(cu + u0[:, 1], float(suv))
    u0[:, 2] = fdiv(cv + u0[:, 2], float(suv))
    u0[:, 3] = fdiv(cl + u0[:, 3], float(slam))
    return u0


def spawn_particles(world, settings: LTSettings, u0):
    """Light particles from 9 uniform columns [n, 9] -> dict of per-particle
    tensors: origin o and direction d (V3), λ, weight β, alive, the
    direction's pdf, the environment pick, and what the light vertex's lens
    connection needs."""
    wb = settings.wavelength_bounds
    p_env = float(world.env_sampling_probability)
    pick_env = u0[:, 8] < p_env

    # ---- instance-light branch
    light_prim, pick_pdf = world.pick_random_light(u0[:, 0])
    lp_i, ln, area_pdf = sample_surface(world.prims, light_prim, u0[:, 1],
                                        u0[:, 2])
    mat_id = world.prims.material_id[light_prim.long()]
    lam_i, _, lam_pdf = sample_emission_spectrum(world.mats, world.bank,
                                                 mat_id, u0[:, 3], wb)
    d0_i, dir_pdf, cos0 = _sample_emission_direction(
        world, mat_id, ln, u0[:, 4], u0[:, 5], u0[:, 6])
    le = emission(world.mats, world.bank, mat_id, lam_i, None,
                  cmath.dot(ln, d0_i))
    q_pick = _f32(max(1.0 - p_env, 1e-6) * pick_pdf)
    beta_i = safe_div(le * cos0, q_pick * area_pdf * dir_pdf * lam_pdf)
    alive_i = (beta_i > 0.0) & (int(world.n_lights) > 0)

    # ---- environment branch: a direction from the environment's sampler, a
    # point on the world-bounds disk facing inward, λ uniform over the
    # bounds; the weight divides out the disk's area pdf
    d_out, dir_pdf_env = env_sample_uv(world.env, u0[:, 1].contiguous(),
                                       u0[:, 2].contiguous())
    lam_e = wb.lower + u0[:, 3] * (wb.upper - wb.lower)
    le_env = env_emission(world.env, world.bank, world.tex, d_out, lam_e)
    radius = np.float32(world.radius.cpu().numpy())
    center = [float(x) for x in world.center]
    t_ax, b_ax = cmath.orthonormal_basis(d_out)
    disk = random_in_unit_disk(u0[:, 4], u0[:, 5]) * float(radius)
    lp_e = V3(*[center[i] + d_out[i] * float(radius) + disk[..., 0] * t_ax[i]
                + disk[..., 1] * b_ax[i] for i in range(3)])
    pos_pdf = _f32(np.float32(1.0) / (np.float32(np.pi) * radius * radius))
    beta_e = safe_div(le_env, p_env * dir_pdf_env * pos_pdf * (1.0 / wb.span))
    alive_e = beta_e > 0.0

    # ---- merge the branches
    lam = torch.where(pick_env, lam_e, lam_i)
    lp = cmath.where(pick_env, lp_e, lp_i)
    d0 = cmath.where(pick_env, -d_out, d0_i)
    beta = torch.where(pick_env, beta_e, beta_i)
    beta = torch.where(torch.isfinite(beta) & (beta > 0.0), beta, 0.0)
    alive = torch.where(pick_env, alive_e, alive_i) & (beta > 0.0)
    off = lp + ln.scale(NORMAL_OFFSET * torch.sign(cmath.dot(ln, d0)))
    o = cmath.where(pick_env, lp, off)
    prev_pdf0 = torch.where(pick_env, dir_pdf_env, dir_pdf)
    return dict(o=o, d=d0, lam=lam, beta=beta, alive=alive,
                prev_pdf0=prev_pdf0, pick_env=pick_env, lp_i=lp_i, ln=ln,
                mat_id=mat_id, lam_i=lam_i, pick_pdf=pick_pdf,
                area_pdf=area_pdf, lam_pdf=lam_pdf, p_env=p_env)


def _connect_to_camera_values(world, camera, sp, uc):
    """The light vertex's lens connection without its shadow test: from
    `spawn_particles`' output and lens uniforms uc [n, 2], the shadow ray
    (so, dir, tmax) and the splat's film (u, v), energy and validity."""
    lp_i, ln, mat_id, lam_i = sp["lp_i"], sp["ln"], sp["mat_id"], sp["lam_i"]
    p_env = sp["p_env"]
    lens_pt = camera.sample_lens_point(uc[:, 0], uc[:, 1])
    to_cam = lens_pt - lp_i
    dist2 = torch.clamp(cmath.length_squared(to_cam), min=1e-12)
    dist = torch.sqrt(dist2)
    dir_c = V3(to_cam.x / dist, to_cam.y / dist, to_cam.z / dist)
    film_u, film_v, on_film = camera.get_pixel_for_ray(lens_pt, -dir_c, lam_i)
    w = [float(x) for x in camera.w]
    cos_cam = torch.abs((-dir_c.x) * w[0] + (-dir_c.y) * w[1]
                        + (-dir_c.z) * w[2])
    focal = np.float32(camera.we_focal())
    x = torch.clamp(cos_cam, min=1e-6)
    we = safe_div(torch.full_like(x, _f32(focal * focal)),
                  x * (x * x) * camera.we_film_area())
    geo = safe_div(torch.ones_like(dist2), dist2)
    so = lp_i + ln.scale(NORMAL_OFFSET * torch.sign(cmath.dot(ln, dir_c)
                                                     + 1e-9))
    q = _f32(max(1.0 - p_env, 1e-6) * sp["pick_pdf"])
    den = q * sp["area_pdf"] * sp["lam_pdf"]
    beta_f = safe_div(torch.ones_like(den), den)
    cos_lc = cmath.dot(ln, dir_c)
    le_c = emission(world.mats, world.bank, mat_id, lam_i, None, cos_lc)
    energy = beta_f * geo * we * le_c * torch.abs(cos_lc)
    a_lens = camera.lens_area()
    has_proxy = bool((world.prims.mat_kind == 2).any())
    if a_lens > 0.0 and has_proxy:
        p_conn = _f32(np.float32(1.0) / np.float32(a_lens))
        p_hit = emission_direction_pdf(world.mats, mat_id, cos_lc) \
            * safe_div(cos_cam, dist2)
        energy = energy * safe_div(torch.full_like(p_hit, p_conn),
                                   p_conn + p_hit)
    valid = on_film & (energy > 0.0) & torch.isfinite(energy)
    return dict(so=so, dir=dir_c, tmax=dist * 0.99, film_u=film_u,
                film_v=film_v, energy=energy, valid=valid)
