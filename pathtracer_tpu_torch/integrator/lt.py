"""Light tracing (counterpart of `integrator/lt.py`): particle emission,
the lens connections, and the light-tracing wavefront `lt_trace`.

A particle starts on an instance light (or, with the environment's
sampling probability, on a disk of the world bounds facing inward), with a
wavelength drawn from the light's emission spectrum and a direction from
its cosine or cosine-power lobe. `spawn_particles` and
`_connect_to_camera_values` are what the LT megakernel's spawn feed runs
(`kernels/lt_mega.py:lt_spawn_feed`, the route for Sun and HDR
environments).

`lt_trace` walks `n_paths` particles in plain torch on `[n, ...]` tensors,
one bounce a step, for every scene the port builds
(`renderer/splatted.py:render_splatted` sends it the scenes the LT
megakernel's gate refuses): the light vertex's lens connection, then per
bounce the direct hit on the camera's lens proxy (MIS-weighted against the
lens connections), `camera_samples` lens connections of the vertex, and
the Importance-mode BSDF sample with Russian roulette. The closest hits
and the connections' shadow rays are `World.intersect` / `intersect_any`,
which launch the dense sweep kernels on the card
(`kernels/csrc/dense_sweep.cu`). Splats go into an `[H·W, 3]` film by one
`index_add_` a step. `CAMERA_RAYS` counts every unblocked connection of
every lane, dead lanes included, as the JAX `lt_trace` does, so those
shadow rays are swept on every lane (the LT megakernel counts the live
lanes' only).

Vectors of the emission helpers are `V3`s of per-lane tensors
(`kernels/cmath.py`); `lt_trace` and `_connect_to_camera` take `[n, 3]`
tensors, as `World.intersect` does. Uniforms are `[n, k]` columns, as the
JAX functions draw them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracer_tpu_torch.camera.projective import ProjectiveCamera
from pathtracer_tpu_torch.core import cie, vecmath
from pathtracer_tpu_torch.core.bounds import BOUNDED_VISIBLE_RANGE, Bounds1D
from pathtracer_tpu_torch.core.sampling import (
    power_cosine_direction,
    random_in_unit_disk,
)
from pathtracer_tpu_torch.geometry.soa import sample_surface
from pathtracer_tpu_torch.integrator.pt import _frame_arrays
from pathtracer_tpu_torch.integrator.pt_regen import _host_scalars, _stacked
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.kernels.cmath import V3, fdiv
from pathtracer_tpu_torch.kernels.megakernel import ALIVE_CHECK_EVERY
from pathtracer_tpu_torch.materials.tables import (
    MAT_SHARP_LIGHT,
    bsdf_eval,
    bsdf_sample,
    emission,
    emission_direction_pdf,
    sample_emission_spectrum,
)
from pathtracer_tpu_torch.prelude import (
    INTERSECTION_TIME_OFFSET,
    NORMAL_OFFSET,
    RAY_TMAX,
    TransportMode,
    safe_div,
)
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.world.environment import env_emission, env_sample_uv

# uniform streams of one lt_trace call, named for a uniform source (a replay
# keys the JAX draws by them): the spawn columns and the strata permutation,
# the light vertex's lens columns, and bounce b's block at LT_BOUNCE + b
LT_SPAWN, LT_LENS, LT_BOUNCE = 0, 1, 2

NOT_PROJECTIVE = ("the port has the projective thin-lens camera only; the "
                  "lens and panorama cameras are still to be ported (ROADMAP "
                  "§1 item 10)")


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
    d_out, dir_pdf_env = env_sample_uv(world.env, u0[:, 1], u0[:, 2])
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


def _connect_to_camera_values(world, camera, sp, uc, has_proxy=None):
    """The light vertex's lens connection without its shadow test: from
    `spawn_particles`' output and lens uniforms uc [n, 2], the shadow ray
    (so, dir, tmax) and the splat's film (u, v), energy and validity.
    `has_proxy` (`_has_proxy(world)`, read once a render) is read here
    where None."""
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
    if has_proxy is None:
        has_proxy = _has_proxy(world)
    if a_lens > 0.0 and has_proxy:
        p_conn = _f32(np.float32(1.0) / np.float32(a_lens))
        p_hit = emission_direction_pdf(world.mats, mat_id, cos_lc) \
            * safe_div(cos_cam, dist2)
        energy = energy * safe_div(torch.full_like(p_hit, p_conn),
                                   p_conn + p_hit)
    valid = on_film & (energy > 0.0) & torch.isfinite(energy)
    return dict(so=so, dir=dir_c, tmax=dist * 0.99, film_u=film_u,
                film_v=film_v, energy=energy, valid=valid)


# ------------------------------------------------------ the wavefront


def check_camera(camera):
    """Refuse a camera the port does not have (ROADMAP §1 item 10)."""
    if not isinstance(camera, ProjectiveCamera):
        raise NotImplementedError(NOT_PROJECTIVE)


def _has_proxy(world) -> bool:
    """Whether the camera's lens proxy disk (mat_kind 2) is in the scene."""
    return bool((world.prims.mat_kind == 2).any())


def host_world(world):
    """The world with every scalar the integrators read as a Python number
    on the host (`pt_regen._host_scalars`, and the environment pick and the
    world bounds), so that reading one waits for nothing on the card; the
    tables, packed sweep tables included, stay where they are."""
    w = _host_scalars(world)
    w = dataclasses.replace(
        w, env_sampling_probability=w.env_sampling_probability.cpu(),
        center=w.center.cpu(), radius=w.radius.cpu())
    w.__dict__.update(dense_tab=world.dense_tab, sweep_tab=world.sweep_tab)
    return w


def _v3(a) -> V3:
    return V3(*a.unbind(-1))


def _sample_lens_point(camera, u1, u2):
    """The connection point on the lens (the thin-lens aperture disk) ->
    [n, 3]."""
    return _stacked(camera.sample_lens_point(u1, u2))


def _lens_area(camera) -> float:
    return camera.lens_area()


def _dot_axis(d, camera):
    """d · w of directions d [..., 3] and the camera's forward axis."""
    w = [float(x) for x in camera.w]
    return d[..., 0] * w[0] + d[..., 1] * w[1] + d[..., 2] * w[2]


def _connect_to_camera(world, camera, point, normal_or_none, beta_f, lam,
                       u_lens, counters, bsdf_pdf_toward=None, n_conn=1,
                       has_proxy=None, count_if=None):
    """The lens connection of the vertices `point` [n, 3] (the reference's
    evaluate_direct_importance): a lens point from u_lens [n, 2], the thin
    lens's W_e = focal² / (cos³θ · A_film), the 1/d² Jacobian and the shadow
    ray, offset along `normal_or_none` [n, 3] where given. With
    `bsdf_pdf_toward` (world direction toward the lens -> the vertex's own
    solid-angle pdf of it; always called) the energy carries the balance
    heuristic against the direct lens hit, `n_conn` connections a vertex,
    where the lens proxy is in the scene (`has_proxy`, read here where
    None) and the lens has area. Every lane's unblocked connection adds to
    counters[CAMERA_RAYS] (times the 0/1 tensor `count_if` where given) ->
    (film u, film v, energy, valid, counters)."""
    if has_proxy is None:
        has_proxy = _has_proxy(world)
    n = point.shape[0]
    lens_pt = _sample_lens_point(camera, u_lens[:, 0], u_lens[:, 1])
    to_cam = lens_pt - point
    dist2 = torch.clamp(vecmath.length_squared(to_cam), min=1e-12)
    dist = torch.sqrt(dist2)
    dir_c = to_cam / dist[..., None]
    film_u, film_v, on_film = camera.get_pixel_for_ray(_v3(lens_pt),
                                                       _v3(-dir_c), lam)
    cos_cam = torch.abs(_dot_axis(-dir_c, camera))
    focal = np.float32(camera.we_focal())
    x = torch.clamp(cos_cam, min=1e-6)
    we = safe_div(torch.full_like(x, _f32(focal * focal)),
                  x * (x * x) * camera.we_film_area())
    geo = safe_div(torch.ones_like(dist2), dist2)
    if normal_or_none is None:
        so = point
    else:
        so = point + normal_or_none * (NORMAL_OFFSET * torch.sign(
            vecmath.dot(normal_or_none, dir_c) + 1e-9))[..., None]
    blocked = world.intersect_any(
        so, dir_c, torch.full((n,), INTERSECTION_TIME_OFFSET,
                              dtype=torch.float32, device=point.device),
        dist * 0.99)
    unblocked = (~blocked).sum()
    counters[prof.CAMERA_RAYS] += (unblocked if count_if is None
                                   else unblocked * count_if)
    energy = beta_f * geo * we
    if bsdf_pdf_toward is not None:
        pdf = bsdf_pdf_toward(dir_c)
        a_lens = _lens_area(camera)
        if a_lens > 0.0 and has_proxy:
            p_conn = _f32(np.float32(n_conn) / np.float32(a_lens))
            p_hit = pdf * safe_div(cos_cam, dist2)
            energy = energy * safe_div(torch.full_like(p_hit, p_conn),
                                       p_conn + p_hit)
    valid = on_film & ~blocked & (energy > 0.0) & torch.isfinite(energy)
    return film_u, film_v, energy, valid, counters


def lt_trace(world, camera, settings: LTSettings, width: int, height: int,
             n_paths: int, uniforms, chunk: int = 0, device=None,
             stats: dict | None = None):
    """Trace `n_paths` light paths on the world's device, splatting their
    lens connections -> (film [width * height, 3] XYZ splat sum, counters
    f64[5]); the caller divides by the paths a pixel (n_paths / (W·H)).

    Uniforms come from `uniforms` (`kernels/megakernel.TorchUniforms` or a
    replay of the JAX draws): `lanes(chunk, 9, n, dev, stream=LT_SPAWN)`
    and, when stratified, `permutation(chunk, cells, dev, stream=LT_SPAWN)`
    for the particles, `lanes(chunk, 2, n, dev, stream=LT_LENS)` for the
    light vertex's lens point, and `lanes(chunk, 4 + 2 · camera_samples, n,
    dev, stream=LT_BOUNCE + b)` for bounce b. `chunk` names the call to the
    source. The JAX `while_loop` is a host loop that checks for a live lane
    every `ALIVE_CHECK_EVERY` bounces; a bounce that starts with no live
    lane adds nothing to the film or the counters. A `stats` dict, if
    given, gets the bounces run added to "rounds" and one to "chunks"."""
    check_camera(camera)
    dev = world.prims.pa.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"the world lives on {dev}, not {device}")
    return _lt_trace(host_world(world), camera.to("cpu"), _has_proxy(world),
                     settings, width, height, n_paths, uniforms, chunk, stats)


def _lt_trace(world, camera, has_proxy, settings, width, height, n_paths,
              uniforms, chunk, stats):
    """`lt_trace` on `host_world(world)`, the camera on the host and
    `_has_proxy(world)`, which a render reads once for all its chunks."""
    dev = world.prims.pa.device
    n, cs = n_paths, settings.camera_samples
    mats, bank, tex = world.mats, world.bank, world.tex
    importance = TransportMode.Importance
    t_lo = torch.full((n,), INTERSECTION_TIME_OFFSET, dtype=torch.float32,
                      device=dev)
    t_hi = torch.full((n,), RAY_TMAX, dtype=torch.float32, device=dev)
    film = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    counters = torch.zeros(prof.N_COUNTERS, dtype=torch.float64, device=dev)
    counters[prof.LIGHT_RAYS].fill_(float(n))

    def pixels(film_u, film_v, energy, valid, lam):
        """Film pixel ids and XYZ of one splat family; an invalid splat adds
        zero to its clipped pixel, so no lane waits on one address."""
        px = torch.clamp((film_u * width).to(torch.int32), 0, width - 1)
        py = torch.clamp((film_v * height).to(torch.int32), 0, height - 1)
        xyz = cie.wavelength_to_xyz(lam, torch.where(valid, energy, 0.0))
        return py * width + px, torch.where(valid[:, None], xyz, 0.0)

    def splat(families):
        film.index_add_(0, torch.cat([f[0] for f in families]).long(),
                        torch.cat([f[1] for f in families]))

    u0 = uniforms.lanes(chunk, 9, n, dev, stream=LT_SPAWN)
    if settings.stratified:
        cells = settings.strata_uv ** 2 * settings.strata_lam
        u0 = stratify_u0(settings, u0, uniforms.permutation(
            chunk, cells, dev, stream=LT_SPAWN))
    sp = spawn_particles(world, settings, u0)
    pick_env, lam, beta, alive = sp["pick_env"], sp["lam"], sp["beta"], \
        sp["alive"]
    o, d, prev_pdf = _stacked(sp["o"]), _stacked(sp["d"]), sp["prev_pdf0"]

    # the light vertex's own lens connection (s = 1; instance particles
    # only: an environment particle reaches the lens by the direct hit)
    uc = uniforms.lanes(chunk, 2, n, dev, stream=LT_LENS)
    lv = _connect_to_camera_values(world, camera, sp, uc, has_proxy)
    blocked = world.intersect_any(_stacked(lv["so"]), _stacked(lv["dir"]),
                                  t_lo, lv["tmax"])
    counters[prof.CAMERA_RAYS] += (~blocked).sum()
    valid = lv["valid"] & ~blocked & ~pick_env & (int(world.n_lights) > 0)
    splat([pixels(lv["film_u"], lv["film_v"], lv["energy"], valid,
                  sp["lam_i"])])

    a_film = camera.we_film_area()
    a_lens = _lens_area(camera)
    focal = np.float32(camera.we_focal())
    focal2 = _f32(focal * focal)
    inv_cs = 1.0 / cs

    def body(bounce, o, d, beta, alive, prev_pdf):
        u = uniforms.lanes(chunk, 4 + 2 * cs, n, dev,
                           stream=LT_BOUNCE + bounce)
        ran = alive.any()  # whether the JAX loop runs this bounce
        hr = world.intersect(o, d, t_lo, t_hi)

        # the direct light-to-lens hit on the camera's lens proxy, from the
        # front, MIS-paired with the lens connection of the previous vertex
        d_w = _dot_axis(d, camera)
        hit_cam = alive & hr.hit & (hr.mat_kind == 2) & (d_w < 0.0)
        fu_h, fv_h, on_film_h = camera.get_pixel_for_ray(_v3(hr.point),
                                                         _v3(-d))
        cos_cam_h = torch.abs(d_w)
        x = torch.clamp(cos_cam_h, min=1e-6)
        xx = x * x
        we_area = safe_div(torch.full_like(x, focal2),
                           a_lens * (xx * xx) * a_film)
        th = torch.clamp(hr.t, min=1e-6)
        p_hit_area = prev_pdf * safe_div(cos_cam_h, th * th)
        n_comp = 1.0 if bounce == 0 else float(cs)
        p_comp = _f32(np.float32(n_comp) / np.float32(a_lens)) \
            if a_lens != 0.0 else 0.0
        w_hit = safe_div(p_hit_area, p_hit_area + p_comp)
        if bounce == 0:
            # an environment particle's first segment has no lens
            # connection to compete with
            w_hit = torch.where(pick_env, 1.0, w_hit)
        e_hit = beta * we_area * w_hit
        families = [pixels(fu_h, fv_h, torch.where(hit_cam, e_hit, 0.0),
                           hit_cam & on_film_h & torch.isfinite(e_hit), lam)]
        alive = alive & hr.hit & (hr.mat_kind != 2)
        frame = vecmath.TangentFrame(*_frame_arrays(hr.normal))
        wi_local = frame.to_local(-d)
        mat_id = torch.clamp(hr.material_id, min=0)

        # the vertex's lens connections, the BSDF evaluated toward the
        # sampled lens point (its pdf is the MIS competitor)
        for c in range(cs):
            held = {}

            def pdf_toward(dir_w):
                wo_l = frame.to_local(dir_w)
                held["f"], pdf_c = bsdf_eval(mats, bank, tex, mat_id, lam,
                                             hr.uv, wi_local, wo_l,
                                             importance)
                held["cos"] = torch.abs(wo_l[..., 2])
                return pdf_c

            fu, fv, energy, valid, _ = _connect_to_camera(
                world, camera, hr.point, hr.geo_normal, beta * inv_cs, lam,
                u[:, 4 + 2 * c:6 + 2 * c], counters,
                bsdf_pdf_toward=pdf_toward, n_conn=cs, has_proxy=has_proxy,
                count_if=ran)
            energy = energy * held["f"] * held["cos"]
            valid = valid & (energy > 0.0) & torch.isfinite(energy)
            families.append(pixels(fu, fv, torch.where(alive, energy, 0.0),
                                   valid & alive, lam))
        splat(families)

        # continue the walk (Importance transport)
        wo_local, _, f_pdf, ratio = bsdf_sample(
            mats, bank, tex, mat_id, lam, hr.uv, wi_local, u[:, 0], u[:, 1],
            u[:, 2], importance)
        if settings.russian_roulette and bounce >= settings.min_bounces:
            p_cont = torch.clamp(ratio, 0.05, 1.0)
        else:
            p_cont = torch.ones_like(ratio)
        survive = u[:, 3] < p_cont
        sample_ok = (f_pdf > 1e-12) & (ratio > 0.0)
        beta = beta * torch.where(sample_ok, ratio / p_cont, 0.0)
        alive = alive & sample_ok & survive & torch.isfinite(beta)
        d_new = vecmath.normalize(frame.to_world(wo_local))
        o_new = hr.point + hr.geo_normal * (NORMAL_OFFSET * torch.sign(
            vecmath.dot(hr.geo_normal, d_new)))[..., None]
        counters[prof.BOUNCE_RAYS] += alive.sum()
        keep = alive[:, None]
        return (torch.where(keep, o_new, o), torch.where(keep, d_new, d),
                beta, alive, torch.where(alive, f_pdf, prev_pdf))

    bounce = 0
    while bounce < settings.max_bounces:
        for _ in range(ALIVE_CHECK_EVERY):
            if bounce >= settings.max_bounces:
                break
            o, d, beta, alive, prev_pdf = body(bounce, o, d, beta, alive,
                                               prev_pdf)
            bounce += 1
        if not bool(alive.any()):
            break
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + bounce
        stats["chunks"] = stats.get("chunks", 0) + 1
    return film, counters
