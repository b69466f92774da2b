"""Bidirectional path tracing with Veach's balance-heuristic MIS
(counterpart of `integrator/bdpt.py`).

Each film point builds a light subpath and an eye subpath of `max_depth`
vertices by masked random walks (`_walk_subpath`: lists of per-depth
tensors, stacked to `[N, D]` vertex arrays; a step backfills the previous
vertex's reverse pdf), then forms every strategy: the environment family
(an eye path escaping, MIS-paired with environment NEE from each eye
vertex), s = 0 (the eye path hits a light), the s >= 1, t >= 2 vertex
connections, and the t = 1 lens splats. Each family is one batched pass
over its (s, t) pairs: `[N, P]` lanes through shared BSDF and emission
evaluations, one shadow query, and `_mis_weight_batched`, the masked
suffix-product form of the sequential ratio walk `_mis_weight`. Vertex
pdfs are kept in area measure, forward and reverse.

The port runs the JAX package's batched body at every `max_depth`; the
per-pair loops that the JAX package takes at `max_depth` <= 4 split its
compile time and are not ported. The closest hits and the shadow queries
are `World.intersect` / `intersect_any`, the dense sweep kernels on the
card (`kernels/csrc/dense_sweep.cu`); each shadow query sweeps only the
lanes whose verdict is read (`live`): the environment NEE and vertex
connections their `worth`, the lens splats `valid & on_film`.

Uniforms come from a uniform source, named by the pass `it` and a stream
(`S_*`): λ, the light vertex's 6 columns, 3 a light walk step, the lens
point's 2, 3 an eye walk step, the environment NEE's 2 · max_depth.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from pathtracer_tpu_torch.core import vecmath
from pathtracer_tpu_torch.core.bounds import BOUNDED_VISIBLE_RANGE, Bounds1D
from pathtracer_tpu_torch.geometry.soa import sample_surface
from pathtracer_tpu_torch.integrator.lt import (
    _dot_axis,
    _f32,
    _sample_emission_direction,
    _v3,
    check_camera,
    host_world,
)
from pathtracer_tpu_torch.integrator.pt import _frame_arrays, camera_ray
from pathtracer_tpu_torch.integrator.pt_regen import _stacked
from pathtracer_tpu_torch.kernels import cmath
from pathtracer_tpu_torch.materials.tables import (
    bsdf_eval,
    bsdf_sample,
    emission,
    emission_direction_pdf,
)
from pathtracer_tpu_torch.prelude import (
    INTERSECTION_TIME_OFFSET,
    NORMAL_OFFSET,
    RAY_TMAX,
    TransportMode,
    safe_div,
)
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.world.environment import (
    env_emission,
    env_pdf_for,
    env_sample_uv,
)

# uniform streams of one pass (a replay keys the JAX draws by them): the
# renderer's film jitter, λ, the light vertex, the lens point, the
# environment NEE, and walk step i at S_LIGHT_WALK + i / S_EYE_WALK + i
S_JITTER, S_LAM, S_LIGHT, S_EYE, S_ENV = 0, 1, 2, 3, 4
S_LIGHT_WALK, S_EYE_WALK = 100, 200


@dataclasses.dataclass(frozen=True)
class BDPTSettings:
    max_depth: int = 4  # vertices a subpath
    russian_roulette: bool = False  # fixed-length subpaths
    wavelength_bounds: Bounds1D = BOUNDED_VISIBLE_RANGE
    selected_pair: Optional[Tuple[int, int]] = None  # one (s, t) only


class Subpath(NamedTuple):
    """[N, D] vertex arrays (the reference's SurfaceVertex)."""

    pos: torch.Tensor  # f32[N, D, 3]
    ns: torch.Tensor  # shading normal
    gn: torch.Tensor  # geometric normal
    wi: torch.Tensor  # unit direction from the previous vertex to this one
    mat_id: torch.Tensor  # i32[N, D]
    prim_id: torch.Tensor  # i32[N, D]
    is_light: torch.Tensor  # bool
    beta: torch.Tensor  # throughput up to (and with) the previous scatter
    pdf_fwd: torch.Tensor  # area pdf of generating this vertex
    pdf_rev: torch.Tensor  # area pdf of the reverse direction
    valid: torch.Tensor  # bool


def host_cameras(camera):
    """The camera twice: on the host, whose scalars the lens connections
    read as Python floats without waiting for the card, and on its device
    with the aperture's blade count and sharpness on the host (`get_ray`
    reads those as Python numbers)."""
    return camera.to("cpu"), dataclasses.replace(
        camera, blades=camera.blades.cpu(),
        blade_sharpness=camera.blade_sharpness.cpu())


def _to_area_pdf(pdf_sa, from_pos, to_pos, to_ns):
    d = to_pos - from_pos
    dist2 = torch.clamp(vecmath.length_squared(d), min=1e-12)
    dir_ = d * torch.rsqrt(dist2)[..., None]
    return pdf_sa * safe_div(torch.abs(vecmath.dot(to_ns, dir_)), dist2)


def _walk_subpath(world, o0, d0, beta0, lam, mode, uniforms, it, stream,
                  depth, pdf_dir_sa0, vert0=None, counters=None):
    """A masked random walk collecting vertices 1 .. depth - 1 (vertex 0 is
    the caller's; its pdf_rev is backfilled), step i's uniforms from
    `stream` + i -> (vertex dicts, escape dicts a step, counters). The
    escape records carry the throughput and pdf at environment misses for
    the s = 0 environment strategy."""
    n, dev = o0.shape[0], o0.device
    mats, bank, tex = world.mats, world.bank, world.tex
    t_lo = torch.full((n,), INTERSECTION_TIME_OFFSET, dtype=torch.float32,
                      device=dev)
    t_hi = torch.full((n,), RAY_TMAX, dtype=torch.float32, device=dev)
    verts, escapes = [], []
    o, d, beta = o0, d0, beta0
    alive = beta0 > 0.0
    pdf_sa = pdf_dir_sa0
    prev_pos = o0
    for i in range(depth - 1):
        u = uniforms.lanes(it, 3, n, dev, stream=stream + i)
        hr = world.intersect(o, d, t_lo, t_hi)
        if counters is not None:
            counters[prof.BOUNCE_RAYS] += alive.sum()
        escapes.append(dict(escaped=alive & ~hr.hit, beta=beta, dir=d,
                            pdf_sa=pdf_sa))
        alive_here = alive & hr.hit
        mat_id = torch.clamp(hr.material_id, min=0)
        vert = dict(
            pos=hr.point, ns=hr.normal, gn=hr.geo_normal, wi=d,
            mat_id=mat_id, prim_id=torch.clamp(hr.prim_id, min=0),
            is_light=hr.mat_kind == 1, beta=beta,
            pdf_fwd=_to_area_pdf(pdf_sa, prev_pos, hr.point, hr.normal),
            pdf_rev=torch.zeros((n,), device=dev), valid=alive_here)
        frame = vecmath.TangentFrame(*_frame_arrays(hr.normal))
        wi_local = frame.to_local(-d)
        wo_local, _, f_pdf, ratio = bsdf_sample(
            mats, bank, tex, mat_id, lam, hr.uv, wi_local, u[:, 0], u[:, 1],
            u[:, 2], mode)
        # the reverse pdf: this vertex's BSDF sampling back toward the last
        _, rev_pdf_sa = bsdf_eval(mats, bank, tex, mat_id, lam, hr.uv,
                                  wo_local, wi_local, mode)
        prev_vert = verts[-1] if verts else vert0
        if prev_vert is not None:
            prev_vert["pdf_rev"] = _to_area_pdf(rev_pdf_sa, hr.point,
                                                prev_vert["pos"],
                                                prev_vert["ns"])
        d_new = vecmath.normalize(frame.to_world(wo_local))
        sample_ok = (f_pdf > 1e-12) & (ratio > 0.0)
        beta = beta * torch.where(sample_ok, ratio, 0.0)
        alive = alive_here & sample_ok
        o = hr.point + hr.geo_normal * (NORMAL_OFFSET * torch.sign(
            vecmath.dot(hr.geo_normal, d_new)))[..., None]
        prev_pos = hr.point
        d = d_new
        pdf_sa = f_pdf
        verts.append(vert)
    return verts, escapes, counters


def _stack_subpath(vert0: dict, verts: list) -> Subpath:
    all_v = [vert0] + verts
    return Subpath(*[torch.stack([v[f] for v in all_v], dim=1)
                     for f in Subpath._fields])


def generate_light_subpath(world, settings, lam, lam_pdf, uniforms, it, n,
                           counters):
    """The light subpath: a uniform light pick, an area sample on it, an
    emission direction, then the Importance-mode walk -> (Subpath, the
    light's prim index, counters)."""
    dev = lam.device
    u0 = uniforms.lanes(it, 6, n, dev, stream=S_LIGHT)
    light_prim, pick_pdf = world.pick_random_light(u0[:, 0])
    lp, ln, area_pdf = sample_surface(world.prims, light_prim, u0[:, 1],
                                      u0[:, 2])
    mat_id = world.prims.material_id[light_prim.long()]
    d0, dir_pdf_sa, cos0 = _sample_emission_direction(
        world, mat_id, ln, u0[:, 3], u0[:, 4], u0[:, 5])
    le = emission(world.mats, world.bank, mat_id, lam, None,
                  cmath.dot(ln, d0))
    lp, ln, d0 = _stacked(lp), _stacked(ln), _stacked(d0)
    pdf_pos = pick_pdf * area_pdf
    beta0 = safe_div(torch.ones_like(pdf_pos), pdf_pos * lam_pdf)
    beta0 = torch.where((int(world.n_lights) > 0) & torch.isfinite(beta0),
                        beta0, 0.0)
    zeros = torch.zeros((n,), device=dev)
    vert0 = dict(pos=lp, ns=ln, gn=ln, wi=torch.zeros_like(lp),
                 mat_id=mat_id, prim_id=light_prim,
                 is_light=torch.ones((n,), dtype=torch.bool, device=dev),
                 beta=beta0, pdf_fwd=pdf_pos, pdf_rev=zeros,
                 valid=beta0 > 0.0)
    counters[prof.LIGHT_RAYS] += (beta0 > 0.0).sum()
    beta1 = beta0 * safe_div(le * cos0, dir_pdf_sa)
    o0 = lp + ln * (NORMAL_OFFSET * torch.sign(vecmath.dot(ln, d0)))[..., None]
    verts, _, counters = _walk_subpath(
        world, o0, d0, beta1, lam, TransportMode.Importance, uniforms, it,
        S_LIGHT_WALK, settings.max_depth, dir_pdf_sa, vert0=vert0,
        counters=counters)
    return _stack_subpath(vert0, verts), light_prim, counters


def generate_eye_subpath(world, cameras, settings, film_uv, lam, uniforms, it,
                         counters):
    """The eye subpath: a camera ray through film_uv [N, 2] from a lens
    sample, then the Radiance-mode walk -> (Subpath, escape records,
    counters). `cameras` is `host_cameras(camera)`."""
    cam_h, cam_d = cameras
    n, dev = film_uv.shape[0], film_uv.device
    ul = uniforms.lanes(it, 2, n, dev, stream=S_EYE)
    o0, d0, tau = camera_ray(cam_d, film_uv[:, 0], film_uv[:, 1], ul[:, 0],
                             ul[:, 1], lam)
    cos_cam = torch.abs(_dot_axis(d0, cam_h))
    focal = _f32(cam_h.we_focal())
    pdf_dir_sa = safe_div(torch.full_like(cos_cam, _f32(focal * focal)),
                          cos_cam * (cos_cam * cos_cam) * cam_h.we_film_area())
    w = cam_d.w.to(dev).expand(n, 3)
    zeros = torch.zeros((n,), device=dev)
    izeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    vert0 = dict(pos=o0, ns=w, gn=w, wi=torch.zeros_like(o0), mat_id=izeros,
                 prim_id=izeros, is_light=zeros > 0.0, beta=tau,
                 pdf_fwd=torch.ones((n,), device=dev), pdf_rev=zeros,
                 valid=tau > 0.0)
    counters[prof.CAMERA_RAYS] += (tau > 0.0).sum()
    verts, escapes, counters = _walk_subpath(
        world, o0, d0, tau, lam, TransportMode.Radiance, uniforms, it,
        S_EYE_WALK, settings.max_depth, pdf_dir_sa, vert0=vert0,
        counters=counters)
    return _stack_subpath(vert0, verts), escapes, counters


def _remap0(x):
    """PBRT's remap: a zero (or delta) pdf counts as 1 in the ratio
    products."""
    if not isinstance(x, torch.Tensor):
        return x if x > 1e-18 else 1.0
    return torch.where(x > 1e-18, x, 1.0)


def _mis_weight(world, lam, y: Subpath, z: Subpath, s: int, t: int,
                max_depth: int, pdf_rev_y_end, pdf_rev_y_prev, pdf_rev_z_end,
                pdf_rev_z_prev):
    """The balance-heuristic weight of strategy (s, t) over the strategies
    of the same path length, by the sequential pdf-ratio walk (Veach 10.9;
    the reference's eval_mis). The *_end / *_prev arguments are the reverse
    area pdfs at the junction. The denominator counts only the strategies
    the integrator evaluates (s' <= max_depth, 1 <= t' <= max_depth)."""
    n_verts = s + t
    sum_ri = torch.zeros_like(z.pdf_fwd[:, 0])
    # the eye side: z_{t-1} .. z_1 (z_0, the camera, is a delta position);
    # term i is strategy (n - i, i)
    ri = 1.0
    for i in range(t - 1, 0, -1):
        rev = pdf_rev_z_end if i == t - 1 else (
            pdf_rev_z_prev if i == t - 2 else z.pdf_rev[:, i])
        ri = ri * safe_div(_remap0(rev), _remap0(z.pdf_fwd[:, i]))
        if n_verts - i <= max_depth:
            sum_ri = sum_ri + torch.where(z.valid[:, i], ri, 0.0)
    # the light side: y_{s-1} .. y_0; term i is strategy (i, n - i)
    ri = 1.0
    for i in range(s - 1, -1, -1):
        rev = pdf_rev_y_end if i == s - 1 else (
            pdf_rev_y_prev if i == s - 2 else y.pdf_rev[:, i])
        ri = ri * safe_div(_remap0(rev), _remap0(y.pdf_fwd[:, i]))
        if n_verts - i <= max_depth:
            sum_ri = sum_ri + torch.where(y.valid[:, i], ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _suffix_prod(a):
    """Products of a [..., D] from each index to the end, multiplied from
    the end as a reversed cumprod does. D is the subpath length: one
    multiply a step over the leading dimensions beats torch's scan kernel
    over a short last dimension, which took 43-47% of a BDPT render's
    device time on an H100 (PERF.md §6)."""
    out = [a[..., -1]]
    for k in range(a.shape[-1] - 2, -1, -1):
        out.append(out[-1] * a[..., k])
    return torch.stack(out[::-1], dim=-1)


def _mis_weight_batched(y: Subpath, z: Subpath, s_arr, t_arr, max_depth,
                        pdf_rev_y_end, pdf_rev_y_prev, pdf_rev_z_end,
                        pdf_rev_z_prev):
    """[N, P] balance-heuristic weights of P strategies at once: the ratio
    walks of `_mis_weight` as masked suffix products over [N, P, D]. s_arr,
    t_arr: [P] int tensors; the junction reverse pdfs [N, P]."""
    D = max_depth
    k = torch.arange(D, device=s_arr.device)[None, None, :]
    s_b = s_arr[None, :, None]
    t_b = t_arr[None, :, None]
    nv = s_b + t_b
    # the eye side: terms i = t - 1 .. 1, the junction's reverse pdfs in
    # place of the stored ones
    rev_z = torch.where(k == t_b - 1, pdf_rev_z_end[:, :, None],
                        torch.where(k == t_b - 2, pdf_rev_z_prev[:, :, None],
                                    z.pdf_rev[:, None, :]))
    a_z = safe_div(_remap0(rev_z), _remap0(z.pdf_fwd[:, None, :]))
    in_z = (k >= 1) & (k <= t_b - 1)
    c_z = _suffix_prod(torch.where(in_z, a_z, 1.0))
    ok_z = in_z & (nv - k <= D) & z.valid[:, None, :]
    sum_ri = torch.sum(torch.where(ok_z, c_z, 0.0), -1)
    # the light side: terms i = s - 1 .. 0
    rev_y = torch.where(k == s_b - 1, pdf_rev_y_end[:, :, None],
                        torch.where(k == s_b - 2, pdf_rev_y_prev[:, :, None],
                                    y.pdf_rev[:, None, :]))
    a_y = safe_div(_remap0(rev_y), _remap0(y.pdf_fwd[:, None, :]))
    in_y = k <= s_b - 1
    c_y = _suffix_prod(torch.where(in_y, a_y, 1.0))
    ok_y = in_y & (nv - k <= D) & y.valid[:, None, :]
    sum_ri = sum_ri + torch.sum(torch.where(ok_y, c_y, 0.0), -1)
    return 1.0 / (1.0 + sum_ri)


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device) -> torch.Tensor:
    """A static index list as an int32 tensor on `device`, copied there once
    a process: a copy from the host waits for the card."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _gather_pairs(sp: Subpath, idx):
    """[N, P(, 3)] vertex gather for a static index list."""
    idx = _index(tuple(idx), sp.pos.device)
    return Subpath(*[a.index_select(1, idx) for a in sp])


def _light_pos_pdf(world, zv):
    """The area pdf with which the light subpath starts at the light vertex
    the eye path hit: the uniform pick times that prim's area pdf."""
    area = world.prims.area[zv.prim_id.long()]
    return safe_div(torch.ones_like(area), float(int(world.n_lights)) * area)


def bdpt_trace(world, camera, settings: BDPTSettings, film_uv, uniforms,
               it: int = 0):
    """One BDPT sample a film point film_uv [N, 2], on the world's device
    -> (own-pixel energy f32[N], splat film uv f32[M, 2], splat energy
    f32[M], λ f32[N], the splats' λ f32[M], counters f64[5]); the splats
    are the t = 1 strategies, M = N · (strategies with t = 1), strategy
    major. Uniforms from `uniforms` as pass `it` (see the module)."""
    check_camera(camera)
    return _bdpt_trace(host_world(world), host_cameras(camera), settings,
                       film_uv, uniforms, it)


def _bdpt_trace(world, cameras, settings, film_uv, uniforms, it):
    """`bdpt_trace` on `host_world(world)` and `host_cameras(camera)`."""
    cam_h = cameras[0]
    n, dev = film_uv.shape[0], film_uv.device
    mats, bank, tex, env = world.mats, world.bank, world.tex, world.env
    radiance, importance = TransportMode.Radiance, TransportMode.Importance
    wb = settings.wavelength_bounds
    lam = wb.lower + uniforms.lanes(it, 1, n, dev, stream=S_LAM)[:, 0] \
        * (wb.upper - wb.lower)
    # λ is uniform; the renderer applies its 1/pdf (the span) once
    lam_pdf = torch.ones((n,), device=dev)
    counters = torch.zeros(prof.N_COUNTERS, dtype=torch.float64, device=dev)
    y, _, counters = generate_light_subpath(world, settings, lam, lam_pdf,
                                            uniforms, it, n, counters)
    z, z_escapes, counters = generate_eye_subpath(world, cameras, settings,
                                                  film_uv, lam, uniforms, it,
                                                  counters)
    # every camera-side connection starts at the eye path's own lens point
    lens_pt = z.pos[:, 0]

    D = settings.max_depth
    own = torch.zeros((n,), device=dev)
    splat_uv, splat_e = [], []

    def pair_enabled(s, t):
        return settings.selected_pair in (None, (s, t))

    a_film = cam_h.we_film_area()
    focal = _f32(cam_h.we_focal())
    focal2 = _f32(focal * focal)

    def flat(a):
        return a.reshape((-1,) + a.shape[2:])

    def unflat(a, P):
        return a.reshape((n, P) + a.shape[1:])

    def lam_for(P):
        return flat(lam[:, None].expand(n, P))

    def zero_uv(P):
        return torch.zeros((n * P, 2), device=dev)

    def bsdf_eval_b(mat_id, wi_local, wo_local, mode, P):
        f, pdf = bsdf_eval(mats, bank, tex, flat(mat_id), lam_for(P),
                           zero_uv(P), flat(wi_local), flat(wo_local), mode)
        return unflat(f, P), unflat(pdf, P)

    def emission_b(mat_id, cos, P):
        return unflat(emission(mats, bank, flat(mat_id), lam_for(P), None,
                               flat(cos)), P)

    def edir_pdf_b(mat_id, cos, P):
        return unflat(emission_direction_pdf(mats, flat(mat_id), flat(cos)),
                      P)

    def offset(pos, gn, dir_):
        return pos + gn * (NORMAL_OFFSET * torch.sign(
            vecmath.dot(gn, dir_) + 1e-9))[..., None]

    def blocked_b(so, dir_, t_max, live, P):
        t_lo = torch.full((n * P,), INTERSECTION_TIME_OFFSET,
                          dtype=torch.float32, device=dev)
        return unflat(world.intersect_any(flat(so), flat(dir_), t_lo,
                                          flat(t_max), live=flat(live)), P)

    # ---- the environment family (disjoint from the instance-light paths):
    # s = 0 escapes at each eye depth, MIS-paired with environment NEE from
    # the same vertex
    if settings.selected_pair is None and D >= 2:
        Pe = len(z_escapes)
        esc_dir = torch.stack([e["dir"] for e in z_escapes], dim=1)
        esc_beta = torch.stack([e["beta"] for e in z_escapes], dim=1)
        esc_pdf = torch.stack([e["pdf_sa"] for e in z_escapes], dim=1)
        esc_on = torch.stack([e["escaped"] for e in z_escapes], dim=1)
        env_e = unflat(env_emission(env, bank, tex, _v3(flat(esc_dir)),
                                    lam_for(Pe)), Pe)
        env_pdf_esc = unflat(env_pdf_for(env, _v3(flat(esc_dir))), Pe)
        first = torch.arange(Pe, device=dev)[None, :] == 0
        w_esc = torch.where(first, 1.0,
                            safe_div(esc_pdf, esc_pdf + env_pdf_esc))
        own = own + torch.sum(torch.where(esc_on, esc_beta * env_e * w_esc,
                                          0.0), dim=1)
        # environment NEE from eye vertices 1 .. D - 1
        Pn = D - 1
        zv = _gather_pairs(z, list(range(1, D)))
        u_env = uniforms.lanes(it, 2 * D, n, dev, stream=S_ENV)
        env_dir, env_pdf = env_sample_uv(env, flat(u_env[:, 2:2 * D:2]),
                                         flat(u_env[:, 3:2 * D:2]))
        env_dir, env_pdf = unflat(_stacked(env_dir), Pn), unflat(env_pdf, Pn)
        env_e = unflat(env_emission(env, bank, tex, _v3(flat(env_dir)),
                                    lam_for(Pn)), Pn)
        frame_z = vecmath.TangentFrame(*_frame_arrays(zv.ns))
        fz, fz_pdf = bsdf_eval_b(zv.mat_id, frame_z.to_local(-zv.wi),
                                 frame_z.to_local(env_dir), radiance, Pn)
        cos_z = torch.abs(vecmath.dot(zv.ns, env_dir))
        w_nee = safe_div(env_pdf, env_pdf + fz_pdf)
        contrib = safe_div(zv.beta * fz * cos_z * env_e * w_nee, env_pdf)
        worth = (zv.valid & ~zv.is_light & (contrib > 0.0)
                 & torch.isfinite(contrib))
        blocked = blocked_b(offset(zv.pos, zv.gn, env_dir), env_dir,
                            torch.full((n, Pn), RAY_TMAX, device=dev), worth,
                            Pn)
        counters[prof.SHADOW_RAYS] += worth.sum()
        own = own + torch.sum(torch.where(worth & ~blocked, contrib, 0.0),
                              dim=1)

    # ---- s = 0: the eye path hits a light, over t = 2 .. D
    t0_list = [t for t in range(2, D + 1) if pair_enabled(0, t)]
    if t0_list:
        P0 = len(t0_list)
        zv = _gather_pairs(z, [t - 1 for t in t0_list])
        zprev = _gather_pairs(z, [t - 2 for t in t0_list])
        cos_l = vecmath.dot(zv.gn, -zv.wi)
        le = emission_b(zv.mat_id, cos_l, P0)
        ok = zv.valid & zv.is_light & (le > 0.0)
        pdf_rev_z_end = torch.where(ok, _light_pos_pdf(world, zv), 0.0)
        pdf_rev_z_prev = torch.where(ok, _to_area_pdf(
            edir_pdf_b(zv.mat_id, cos_l, P0), zv.pos, zprev.pos, zprev.ns),
            0.0)
        zero_p = torch.zeros((n, P0), device=dev)
        w = _mis_weight_batched(
            y, z, torch.zeros((P0,), dtype=torch.int32, device=dev),
            _index(tuple(t0_list), dev), D, zero_p, zero_p, pdf_rev_z_end,
            pdf_rev_z_prev)
        own = own + torch.sum(torch.where(ok, zv.beta * le * w, 0.0), dim=1)

    # ---- s >= 1, t >= 2: the vertex connections, one pass over the grid
    pairs = [(s, t) for s in range(1, D + 1) for t in range(2, D + 1)
             if pair_enabled(s, t)]
    if pairs:
        P = len(pairs)
        s_np = _index(tuple(s for s, _ in pairs), dev)
        t_np = _index(tuple(t for _, t in pairs), dev)
        s_is1 = (s_np == 1)[None, :]
        yv = _gather_pairs(y, [s - 1 for s, _ in pairs])
        zv = _gather_pairs(z, [t - 1 for _, t in pairs])
        yprev = _gather_pairs(y, [max(s - 2, 0) for s, _ in pairs])
        zprev = _gather_pairs(z, [t - 2 for _, t in pairs])
        con = zv.pos - yv.pos
        dist2 = torch.clamp(vecmath.length_squared(con), min=1e-12)
        dist = torch.sqrt(dist2)
        dir_yz = con / dist[..., None]
        cos_y = vecmath.dot(yv.ns, dir_yz)
        cos_z = vecmath.dot(zv.ns, -dir_yz)
        geo = safe_div(torch.abs(cos_y) * torch.abs(cos_z), dist2)
        frame_y = vecmath.TangentFrame(*_frame_arrays(yv.ns))
        frame_z = vecmath.TangentFrame(*_frame_arrays(zv.ns))
        cos_gy = vecmath.dot(yv.gn, dir_yz)
        # the light end (s = 1) emits toward z; other y vertices scatter
        le = emission_b(yv.mat_id, cos_gy, P)
        edir_pdf = edir_pdf_b(yv.mat_id, cos_gy, P)
        fy_b, fy_pdf_b = bsdf_eval_b(yv.mat_id, frame_y.to_local(-yv.wi),
                                     frame_y.to_local(dir_yz), importance, P)
        fy = torch.where(s_is1, le, fy_b)
        fz, fz_pdf = bsdf_eval_b(zv.mat_id, frame_z.to_local(-zv.wi),
                                 frame_z.to_local(-dir_yz), radiance, P)
        contrib = yv.beta * fy * geo * fz * zv.beta
        worth = (yv.valid & zv.valid & (contrib > 0.0)
                 & torch.isfinite(contrib))
        so = yv.pos + yv.gn * (NORMAL_OFFSET
                               * torch.sign(cos_gy + 1e-9))[..., None]
        blocked = blocked_b(so, dir_yz, dist * 0.99, worth, P)
        counters[prof.SHADOW_RAYS] += worth.sum()
        # the junction's reverse area pdfs: z_{t-1} from y_{s-1} (fy's
        # evaluation), z_{t-2} from z_{t-1} reached from y, y_{s-1} from
        # z_{t-1} (fz's evaluation), y_{s-2} from y_{s-1} reached from z
        pdf_z_end_sa = torch.where(s_is1, edir_pdf, fy_pdf_b)
        pdf_rev_z_end = _to_area_pdf(pdf_z_end_sa, yv.pos, zv.pos, zv.ns)
        _, pdf_z_prev_sa = bsdf_eval_b(zv.mat_id, frame_z.to_local(-dir_yz),
                                       frame_z.to_local(-zv.wi), radiance, P)
        pdf_rev_z_prev = _to_area_pdf(pdf_z_prev_sa, zv.pos, zprev.pos,
                                      zprev.ns)
        pdf_rev_y_end = _to_area_pdf(fz_pdf, zv.pos, yv.pos, yv.ns)
        _, pdf_y_prev_sa = bsdf_eval_b(yv.mat_id, frame_y.to_local(dir_yz),
                                       frame_y.to_local(-yv.wi), importance,
                                       P)
        pdf_rev_y_prev = torch.where(s_is1, 0.0, _to_area_pdf(
            pdf_y_prev_sa, yv.pos, yprev.pos, yprev.ns))
        w = _mis_weight_batched(y, z, s_np, t_np, D, pdf_rev_y_end,
                                pdf_rev_y_prev, pdf_rev_z_end, pdf_rev_z_prev)
        own = own + torch.sum(torch.where(worth & ~blocked, contrib * w, 0.0),
                              dim=1)

    # ---- t = 1: splats through the lens over s = 1 .. D (s = 1: the light
    # vertex itself)
    s1_list = [s for s in range(1, D + 1) if pair_enabled(s, 1)]
    if s1_list:
        P1 = len(s1_list)
        s_np = _index(tuple(s1_list), dev)
        s_is1 = (s_np == 1)[None, :]
        yv = _gather_pairs(y, [s - 1 for s in s1_list])
        yprev = _gather_pairs(y, [max(s - 2, 0) for s in s1_list])
        lens_b = lens_pt[:, None, :].expand(n, P1, 3)
        to_cam = lens_b - yv.pos
        dist2 = torch.clamp(vecmath.length_squared(to_cam), min=1e-12)
        dist = torch.sqrt(dist2)
        dir_c = to_cam / dist[..., None]
        fu, fv, on_film = cam_h.get_pixel_for_ray(_v3(flat(lens_b)),
                                                  _v3(flat(-dir_c)),
                                                  lam_for(P1))
        fu, fv, on_film = unflat(fu, P1), unflat(fv, P1), unflat(on_film, P1)
        cos_cam = torch.abs(_dot_axis(-dir_c, cam_h))
        x = torch.clamp(cos_cam, min=1e-6)
        xx = x * x
        we = safe_div(torch.full_like(x, focal2), (xx * xx) * a_film)
        cos_gy = vecmath.dot(yv.gn, dir_c)
        frame_y = vecmath.TangentFrame(*_frame_arrays(yv.ns))
        le = emission_b(yv.mat_id, cos_gy, P1)
        fy_b, _ = bsdf_eval_b(yv.mat_id, frame_y.to_local(-yv.wi),
                              frame_y.to_local(dir_c), importance, P1)
        fy = torch.where(s_is1, le, fy_b)
        geo = safe_div(torch.abs(vecmath.dot(yv.ns, dir_c)) * cos_cam, dist2)
        contrib = yv.beta * fy * geo * we
        so = yv.pos + yv.gn * (NORMAL_OFFSET
                               * torch.sign(cos_gy + 1e-9))[..., None]
        seen = yv.valid & on_film
        blocked = blocked_b(so, dir_c, dist * 0.99, seen, P1)
        counters[prof.CAMERA_RAYS] += seen.sum()
        # the junction pdfs: y_{s-1} from the camera, y_{s-2} from y_{s-1}
        cam_dir_pdf_sa = safe_div(torch.full_like(cos_cam, focal2),
                                  cos_cam * (cos_cam * cos_cam) * a_film)
        pdf_rev_y_end = _to_area_pdf(cam_dir_pdf_sa, lens_pt[:, None, :],
                                     yv.pos, yv.ns)
        _, pdf_y_prev_sa = bsdf_eval_b(yv.mat_id, frame_y.to_local(dir_c),
                                       frame_y.to_local(-yv.wi), importance,
                                       P1)
        pdf_rev_y_prev = torch.where(s_is1, 0.0, _to_area_pdf(
            pdf_y_prev_sa, yv.pos, yprev.pos, yprev.ns))
        zero_p = torch.zeros((n, P1), device=dev)
        w = _mis_weight_batched(y, z, s_np, torch.ones_like(s_np), D,
                                pdf_rev_y_end, pdf_rev_y_prev, zero_p, zero_p)
        ok = seen & ~blocked & (contrib > 0.0) & torch.isfinite(contrib)
        # strategy-major, as the splats' λ below repeats λ a strategy
        splat_uv.append(torch.stack([fu, fv], dim=-1).transpose(0, 1)
                        .reshape(-1, 2))
        splat_e.append(torch.where(ok, contrib * w, 0.0).T.reshape(-1))

    splat_uv = torch.cat(splat_uv) if splat_uv else torch.zeros((0, 2),
                                                                device=dev)
    splat_e = torch.cat(splat_e) if splat_e else torch.zeros((0,),
                                                             device=dev)
    lam_splat = lam.repeat(splat_e.shape[0] // max(n, 1))
    return own, splat_uv, splat_e, lam, lam_splat, counters
