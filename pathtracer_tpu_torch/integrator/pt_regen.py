"""The regen integrator without kernels (counterpart of
`integrator/pt_regen.py`): one lane per pixel, and a lane whose path ends
adds its XYZ to its pixel and starts the same pixel's next sample at once.

It takes every scene the port can build: `renderer/persistent.py:
render_regen` sends it the scenes the megakernel's gate refuses (more than
8192 prims, 24 materials or 16 lights, more than 16 media under
medium-aware settings, multi-texel textures outside a lambertian's
reflectance or the HDR map). Each round follows the JAX body statement for
statement in plain torch on `[N, ...]` tensors: the closest hit
(`World.intersect`), the medium-aware free flight over the tracked-medium
stack, emission and environment adds with MIS, next-event estimation with
one shadow query per light sample (`World.intersect_any`), BSDF or phase
sampling with hero-wavelength spectral MIS, Russian roulette, and the
respawn. On the card the two queries launch the hand-written dense sweep
kernels (`kernels/csrc/dense_sweep.cu`); everything else is torch. A shadow
ray is swept only where its light sample was worth a ray (`worth`): the
verdict is read nowhere else, and the JAX body sweeps every lane for the
same radiance.

The JAX `while_loop` is a host loop that checks for a live lane every
`ALIVE_CHECK_EVERY` rounds; a round with no live lane changes nothing but
the uniform cursor.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import cie, sampling, vecmath
from pathtracer_tpu_torch.geometry.soa import sample_surface
from pathtracer_tpu_torch.integrator.pt import (
    HWSS_LANES,
    MEDIUM_STACK_K,
    PTSettings,
    _frame_arrays,
    _stack_push,
    _stack_remove,
    camera_ray_hwss,
)
from pathtracer_tpu_torch.kernels.cmath import V3
from pathtracer_tpu_torch.kernels.megakernel import ALIVE_CHECK_EVERY
from pathtracer_tpu_torch.materials.tables import (
    bsdf_eval,
    bsdf_sample,
    emission,
)
from pathtracer_tpu_torch.mediums.tables import (
    medium_coefficients,
    phase_eval,
    phase_sample,
)
from pathtracer_tpu_torch.prelude import (
    INTERSECTION_TIME_OFFSET,
    NORMAL_OFFSET,
    RAY_TMAX,
    TransportMode,
    power_heuristic,
    safe_div,
)
from pathtracer_tpu_torch.utils import profile as prof
from pathtracer_tpu_torch.world.environment import (
    env_emission,
    env_pdf_for,
    env_sample_uv,
)

RND_START = 10  # the uniform cursor of the first round, as in the JAX carry


class RegenState(NamedTuple):
    """The integrator's carry, in the JAX tuple's order."""

    rnd_i: int  # uniform cursor: round block at rnd_i, respawn at rnd_i + 1
    o: torch.Tensor  # f32[N, 3]
    d: torch.Tensor  # f32[N, 3]
    lam: torch.Tensor  # f32[N, C]
    beta: torch.Tensor  # f32[N, C]
    path_rad: torch.Tensor  # f32[N, C]
    acc: torch.Tensor  # f32[N, 3] XYZ sums
    done: torch.Tensor  # i32[N] finished samples
    alive: torch.Tensor  # bool[N]
    bounce_ct: torch.Tensor  # i32[N]
    prev_pdf: torch.Tensor  # f32[N]
    med_stack: torch.Tensor  # i32[N, MEDIUM_STACK_K]
    counters: torch.Tensor  # f64[5]
    pdfr: torch.Tensor  # f32[N, C] spectral-MIS pdf-ratio products


def _stacked(v: V3):
    return torch.stack(tuple(v), dim=-1)


def _host_scalars(world):
    """The world with the scalars that the environment functions and the
    light pick read on the host (kind, strength, sun, rotation, light
    count) on the CPU, so that reading them waits for nothing on the card;
    the tables stay on the world's device."""
    env = world.env
    host = {f: getattr(env, f).cpu() for f in (
        "kind", "strength", "curve_idx", "sun_direction", "sun_cos_angle",
        "tex_id", "rotation", "rotation_inv", "imp_baked")}
    return dataclasses.replace(world, env=dataclasses.replace(env, **host),
                               n_lights=world.n_lights.cpu())


def pt_trace_regen(world, camera, settings: PTSettings, width: int,
                   height: int, spp: int, uniforms, start: int = 0,
                   batch_n: int | None = None, init_state=None,
                   max_rounds: int | None = None, return_state: bool = False,
                   device=None, stats: dict | None = None):
    """Render `spp` samples of pixels [start, start + batch_n) with one lane
    a pixel -> (XYZ sums [batch_n, 3], divide by spp; counters f64[5]), or
    the final `RegenState` with `return_state`.

    Uniforms come from `uniforms` (`kernels/megakernel.TorchUniforms` or a
    replay of the JAX draws): `init(n, device)` for the first spawn, then
    per round `lanes(rnd_i, n_u, n, device)` and `lanes(rnd_i + 1, 5, n,
    device)` for the respawn, where rnd_i is the JAX carry's cursor.
    `max_rounds` bounds the rounds of this call, `init_state` resumes a
    returned state. The render runs on the world's device (`device`, if
    given, must name it). A `stats` dict, if given, gets the rounds run
    added to "rounds"."""
    dev = world.prims.pa.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"the world lives on {dev}, not {device}")
    world = _host_scalars(world)
    n = batch_n or (width * height)
    medium_aware = settings.medium_aware
    C = HWSS_LANES if settings.hwss else 1
    wb = settings.wavelength_bounds
    env_prob = torch.clamp(world.env_sampling_probability.cpu(), 0.0, 1.0)
    have_lights = int(world.n_lights) > 0
    p_env = env_prob if have_lights else torch.tensor(1.0)
    p_env_pos = bool(p_env > 0.0)
    nee_enabled = settings.light_samples > 0
    inv_res = torch.tensor([1.0 / width, 1.0 / height], dtype=torch.float32,
                           device=dev)
    pix = start + torch.arange(n, dtype=torch.int32, device=dev)
    xy = torch.stack([(pix % width).float(), (pix // width).float()], dim=-1)
    t_lo = torch.full((n,), INTERSECTION_TIME_OFFSET, dtype=torch.float32,
                      device=dev)
    t_hi = torch.full((n,), RAY_TMAX, dtype=torch.float32, device=dev)
    area = world.prims.area
    mats, bank, tex, env = world.mats, world.bank, world.tex, world.env
    radiance = TransportMode.Radiance

    def mis_or_one(use_mis, pdf_a, pdf_b):
        w = power_heuristic(pdf_a, torch.clamp(pdf_b, min=0.0))
        return torch.where(use_mis & (pdf_a + pdf_b > 0.0), w, 1.0)

    def lanes(x):
        return x.reshape(n, C)

    def rep(x):
        return torch.repeat_interleave(x, C, dim=0)

    def env_e_of(d, lam_f):
        return lanes(env_emission(env, bank, tex, V3(*rep(d).unbind(-1)),
                                  lam_f))

    def spawn(rnd):
        film_uv = (xy + rnd[:, 0:2]) * inv_res
        offs = torch.arange(C, dtype=torch.float32, device=dev) / C
        lam = wb.lower + torch.remainder(rnd[:, 4:5] + offs[None, :],
                                         1.0) * wb.span
        o, d, tau, lane_w, pdfr0 = camera_ray_hwss(
            camera, film_uv[:, 0], film_uv[:, 1], rnd[:, 2], rnd[:, 3], lam)
        return o, d, lam, tau, lane_w, pdfr0

    n_u = 7 + 3 * max(settings.light_samples, 1) + 5

    def body(st: RegenState) -> RegenState:
        (rnd_i, o, d, lam, beta, path_rad, acc, done, alive, bounce_ct,
         prev_pdf, med_stack, counters, pdfr) = st
        # hero-wavelength spectral MIS: pdfr lane c carries the product of
        # p_c / p_0 along the path; contributions scale by C / Σ pdfr
        s_mis = (C / torch.sum(pdfr, dim=-1))[:, None] if C > 1 else 1.0
        u = uniforms.lanes(rnd_i, n_u, n, dev)
        lam_f = lam.reshape(-1)
        hr = world.intersect(o, d, t_lo, t_hi)

        # free flight over the tracked-medium stack: one exponential at the
        # hero Σσs, then a σ-share pick of the scattering medium
        if medium_aware:
            sigma_s = torch.zeros((n, C), device=dev)
            sigma_a = torch.zeros((n, C), device=dev)
            ss_hero_slots = []
            for k in range(MEDIUM_STACK_K):
                ss_k, sa_k, _ = [lanes(x) for x in medium_coefficients(
                    world.mediums, bank, rep(med_stack[:, k]), lam_f)]
                sigma_s = sigma_s + ss_k
                sigma_a = sigma_a + sa_k
                ss_hero_slots.append(ss_k[:, 0])
            sigma_t = sigma_s + sigma_a
            ss_hero = sigma_s[:, 0]
            flight = torch.where(
                ss_hero > 1e-12,
                -torch.log(torch.clamp(1.0 - u[:, 4], min=1e-12))
                / torch.clamp(ss_hero, min=1e-12), float("inf"))
            surf_t = torch.where(hr.hit, hr.t, RAY_TMAX)
            scattered = alive & (flight < surf_t)
            travel = torch.clamp(torch.minimum(flight, surf_t), max=1e8)
            ss_slots = torch.stack(ss_hero_slots, dim=-1)
            cum = torch.cumsum(ss_slots, dim=-1)
            pick = u[:, n_u - 1] * torch.clamp(ss_hero, min=1e-20)
            slot = torch.sum((cum < pick[:, None]).to(torch.int32), dim=-1)
            slot = torch.clamp(slot, max=MEDIUM_STACK_K - 1)
            scat_med = torch.gather(med_stack, 1, slot[:, None].long())[:, 0]
            in_med = alive & (med_stack != 0).any(dim=-1)
            w_exp = torch.exp(-(sigma_t - ss_hero[:, None]) * travel[:, None])
            w_scat = safe_div(sigma_s, ss_hero[:, None]) * w_exp
            lane_w = torch.where(scattered[:, None], w_scat, w_exp)
            beta = beta * torch.where(in_med[:, None], lane_w, 1.0)
        else:
            scattered = torch.zeros((n,), dtype=torch.bool, device=dev)

        # camera lens proxies absorb the path (MaterialId::Camera)
        at_surface = alive & hr.hit & (hr.mat_kind != 2) & ~scattered

        escaped = alive & ~hr.hit & ~scattered
        env_e = env_e_of(d, lam_f)
        env_nee_pdf = env_pdf_for(env, V3(*d.unbind(-1))) * p_env
        use_mis_env = (bounce_ct > 0) & (nee_enabled and p_env_pos)
        w_env = mis_or_one(use_mis_env, prev_pdf, env_nee_pdf)
        path_rad = path_rad + torch.where(
            escaped[:, None], beta * s_mis * env_e * w_env[:, None], 0.0)
        counters[prof.ENV_HITS] += escaped.sum()

        wi_world = -d
        cos_at_light = vecmath.dot(hr.geo_normal, wi_world)
        mat_id = torch.clamp(hr.material_id, min=0)
        le = lanes(emission(mats, bank, rep(mat_id), lam_f, rep(hr.uv),
                            rep(cos_at_light)))
        pick_pdf = safe_div(1.0 - p_env, world.n_lights.float())
        hyp_nee_pdf = pick_pdf * safe_div(
            hr.t * hr.t,
            torch.abs(cos_at_light)
            * area[torch.clamp(hr.prim_id, min=0).long()])
        use_mis_light = (bounce_ct > 0) & (nee_enabled and have_lights)
        w_light = mis_or_one(use_mis_light, prev_pdf, hyp_nee_pdf)
        is_light_hit = at_surface & (hr.mat_kind == 1)
        path_rad = path_rad + torch.where(
            is_light_hit[:, None], beta * s_mis * le * w_light[:, None], 0.0)

        frame = vecmath.TangentFrame(*_frame_arrays(hr.normal))
        wi_local = frame.to_local(wi_world)
        if medium_aware:
            scatter_p = o + travel[..., None] * d
            point = torch.where(scattered[..., None], scatter_p, hr.point)
        else:
            point = hr.point

        if nee_enabled:
            inv_ls = 1.0 / settings.light_samples
            for s_i in range(settings.light_samples):
                base = 7 + 3 * s_i
                chose_env, u_pick2 = sampling.choose(u[:, base], p_env)
                light_prim, lp_pdf = world.pick_random_light(u_pick2)
                lp, ln, area_pdf = sample_surface(
                    world.prims, light_prim, u[:, base + 1], u[:, base + 2])
                lp, ln = _stacked(lp), _stacked(ln)
                to_l = lp - point
                dist2 = torch.clamp(vecmath.length_squared(to_l), min=1e-12)
                dist = torch.sqrt(dist2)
                dir_l = to_l / dist[..., None]
                cos_l = vecmath.dot(ln, -dir_l)
                light_mat = world.prims.material_id[light_prim.long()]
                le_nee = lanes(emission(
                    mats, bank, rep(light_mat), lam_f,
                    rep(torch.zeros((n, 2), device=dev)), rep(cos_l)))
                sa_pdf_light = (1.0 - p_env) * lp_pdf * area_pdf * safe_div(
                    dist2, torch.abs(cos_l))
                env_dir, env_pdf = env_sample_uv(env, u[:, base + 1],
                                                 u[:, base + 2])
                env_dir = _stacked(env_dir)
                sa_pdf_env = env_pdf * p_env
                le_env = env_e_of(env_dir, lam_f)
                nee_dir = torch.where(chose_env[..., None], env_dir, dir_l)
                nee_pdf = torch.where(chose_env, sa_pdf_env, sa_pdf_light)
                nee_le = torch.where(chose_env[:, None], le_env, le_nee)
                nee_tmax = torch.where(chose_env, RAY_TMAX, dist * 0.99)
                wo_local = frame.to_local(nee_dir)
                f_s, pdf_s = bsdf_eval(mats, bank, tex, rep(mat_id), lam_f,
                                       rep(hr.uv), rep(wi_local),
                                       rep(wo_local), radiance)
                f_s, pdf_s = lanes(f_s), lanes(pdf_s)
                thr_surf = f_s * torch.abs(wo_local[..., 2])[:, None]
                if medium_aware:
                    # the scattering medium's phase toward the NEE direction
                    ph = lanes(phase_eval(world.mediums, bank, rep(scat_med),
                                          lam_f, rep(vecmath.dot(d, nee_dir))))
                    thr = torch.where(scattered[:, None], ph, thr_surf)
                    fwd_pdf_hero = torch.where(scattered, ph[:, 0],
                                               pdf_s[:, 0])
                    nee_src = at_surface | scattered
                else:
                    thr = thr_surf
                    fwd_pdf_hero = pdf_s[:, 0]
                    nee_src = at_surface
                worth = (nee_src & (torch.amax(nee_le, -1) > 0.0)
                         & (nee_pdf > 1e-12) & (torch.amax(thr, -1) > 0.0))
                if medium_aware:
                    offset_n = torch.where(scattered[..., None],
                                           torch.zeros_like(hr.geo_normal),
                                           hr.geo_normal)
                else:
                    offset_n = hr.geo_normal
                so = point + offset_n * (NORMAL_OFFSET * torch.sign(
                    vecmath.dot(offset_n, nee_dir) + 1e-9))[..., None]
                blocked = world.intersect_any(so, nee_dir, t_lo, nee_tmax,
                                              live=worth)
                if medium_aware:
                    tr_dist = torch.where(chose_env, 2.0 * world.radius, dist)
                    tr = torch.where(
                        in_med[:, None],
                        torch.exp(-sigma_t
                                  * torch.clamp(tr_dist, max=1e8)[:, None]),
                        1.0)
                else:
                    tr = 1.0
                w_nee = mis_or_one(torch.ones((n,), dtype=torch.bool,
                                              device=dev),
                                   nee_pdf, fwd_pdf_hero)
                contrib = (beta * s_mis * thr * nee_le * tr
                           * safe_div(w_nee, nee_pdf)[:, None] * inv_ls)
                path_rad = path_rad + torch.where(
                    (worth & ~blocked)[:, None], contrib, 0.0)
                counters[prof.SHADOW_RAYS] += worth.sum()

        wo_local, f_h, f_pdf, ratio_hero = bsdf_sample(
            mats, bank, tex, mat_id, lam[:, 0], hr.uv, wi_local, u[:, 0],
            u[:, 1], u[:, 2], radiance)
        if C > 1:
            f_lanes, p_lanes = bsdf_eval(mats, bank, tex, rep(mat_id), lam_f,
                                         rep(hr.uv), rep(wi_local),
                                         rep(wo_local), radiance)
            f_lanes, p_lanes = lanes(f_lanes), lanes(p_lanes)
            # spectral-MIS pdf ratios p_c / p_0 at the sampled direction
            pscale = torch.cat([torch.ones((n, 1), device=dev),
                                safe_div(p_lanes, p_lanes[:, :1])[:, 1:]], 1)
            scale = safe_div(f_lanes, f_lanes[:, :1])
            ratio_stable = ratio_hero[:, None] * scale
            ratio_direct = safe_div(
                f_lanes * torch.abs(wo_local[..., 2])[:, None],
                f_pdf[:, None])
            hero_dead = (f_lanes[:, :1] <= 0.0) & (f_pdf[:, None] > 1e-12)
            ratio_lanes = torch.where(hero_dead, ratio_direct, ratio_stable)
            ratio_lanes = torch.cat([ratio_hero[:, None], ratio_lanes[:, 1:]],
                                    1)
        else:
            ratio_lanes = ratio_hero[:, None]
        d_surf = vecmath.normalize(frame.to_world(wo_local))
        if medium_aware:
            # phase sampling at medium scatter events
            wo_med, ph_pdf_f = phase_sample(world.mediums, bank, scat_med,
                                            lam[:, 0], d, u[:, 5], u[:, 6])
            if C > 1:
                ph_lanes = lanes(phase_eval(world.mediums, bank,
                                            rep(scat_med), lam_f,
                                            rep(vecmath.dot(d, wo_med))))
                ph_scale = safe_div(ph_lanes, ph_lanes[:, :1])
                ph_scale = torch.cat([torch.ones((n, 1), device=dev),
                                      ph_scale[:, 1:]], 1)
            else:
                ph_scale = torch.ones((n, 1), device=dev)
            ratio_lanes = torch.where(scattered[:, None], ph_scale,
                                      ratio_lanes)
            f_pdf = torch.where(scattered, ph_pdf_f, f_pdf)
            d_new = torch.where(scattered[..., None], wo_med, d_surf)
            if C > 1:
                # a phase value is its solid-angle pdf: ph_scale is the ratio
                pscale = torch.where(scattered[:, None], ph_scale, pscale)
        else:
            d_new = d_surf
        ratio_best = torch.amax(ratio_lanes, dim=-1)
        if medium_aware:
            ratio_best = torch.where(scattered, 1.0, ratio_best)
        sample_ok = scattered | ((f_pdf > 1e-12) & (ratio_best > 0.0))
        if settings.russian_roulette:
            rr_on = bounce_ct >= settings.min_bounces
            p_cont = torch.where(rr_on, torch.clamp(ratio_best, 0.05, 1.0),
                                 1.0)
        else:
            p_cont = torch.ones((n,), device=dev)
        survive = u[:, 3] < p_cont
        beta_next = beta * torch.where(sample_ok[:, None],
                                       ratio_lanes / p_cont[:, None], 0.0)
        hit_depth_cap = (bounce_ct + 1) >= settings.max_bounces
        direct_stop = settings.only_direct & (bounce_ct >= 1)
        continue_path = ((at_surface | scattered) & sample_ok & survive
                         & ~hit_depth_cap & ~direct_stop
                         & torch.isfinite(beta_next).all(dim=-1))
        if medium_aware:
            o_new = torch.where(
                scattered[..., None], point,
                hr.point + hr.geo_normal * (NORMAL_OFFSET * torch.sign(
                    vecmath.dot(hr.geo_normal, d_new)))[..., None])
            # medium boundary transitions
            crossed = at_surface & (wo_local[..., 2] * wi_local[..., 2] < 0.0)
            entering = wo_local[..., 2] < 0.0
            inner = mats.inner_medium[mat_id.long()]
            outer = mats.outer_medium[mat_id.long()]
            do_tr = crossed & (inner != outer)
            rm_id = torch.where(entering, outer, inner)
            add_id = torch.where(entering, inner, outer)
            med_stack = _stack_remove(med_stack, rm_id, do_tr)
            med_stack = _stack_push(med_stack, add_id, do_tr)
        else:
            o_new = hr.point + hr.geo_normal * (NORMAL_OFFSET * torch.sign(
                vecmath.dot(hr.geo_normal, d_new)))[..., None]
        counters[prof.BOUNCE_RAYS] += continue_path.sum()

        # an ended path adds its XYZ and regenerates the same pixel
        died = alive & ~continue_path
        xyz = torch.sum(cie.wavelength_to_xyz(lam, path_rad), dim=1) \
            * (wb.span / C)
        acc = acc + torch.where(died[:, None], xyz, 0.0)
        done = done + died.to(torch.int32)
        has_work = died & (done < spp)
        rnd = uniforms.lanes(rnd_i + 1, 5, n, dev)
        o_s, d_s, lam_s, tau_s, lane_w_s, pdfr0_s = spawn(rnd)
        counters[prof.CAMERA_RAYS] += has_work.sum()

        cont, work = continue_path[:, None], has_work[:, None]
        o = torch.where(cont, o_new, torch.where(work, o_s, o))
        d = torch.where(cont, d_new, torch.where(work, d_s, d))
        lam = torch.where(work, lam_s, lam)
        beta = torch.where(cont, beta_next,
                           torch.where(work, tau_s[:, None] * lane_w_s, beta))
        path_rad = torch.where(died[:, None], 0.0, path_rad)
        bounce_ct = torch.where(continue_path, bounce_ct + 1,
                                torch.where(has_work, 0, bounce_ct))
        prev_pdf = torch.where(continue_path, f_pdf,
                               torch.where(has_work, 0.0, prev_pdf))
        if C > 1:
            pdfr = torch.where(cont, pdfr * pscale,
                               torch.where(work, pdfr0_s, pdfr))
        # a respawned camera path starts in vacuum
        med_stack = torch.where(work & ~cont, 0, med_stack)
        alive = continue_path | has_work
        return RegenState(rnd_i + 2, o, d, lam, beta, path_rad, acc, done,
                          alive, bounce_ct.to(torch.int32), prev_pdf,
                          med_stack, counters, pdfr)

    if init_state is not None:
        st = RegenState(*init_state)
        st = st._replace(counters=st.counters.clone())
    else:
        rnd0 = uniforms.init(n, dev)
        o0, d0, lam0, tau0, lane_w0, pdfr00 = spawn(rnd0)
        counters0 = torch.zeros(prof.N_COUNTERS, dtype=torch.float64,
                                device=dev)
        counters0[prof.CAMERA_RAYS] = float(n)
        st = RegenState(
            RND_START, o0, d0, lam0, tau0[:, None] * lane_w0,
            torch.zeros((n, C), device=dev), torch.zeros((n, 3), device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev), tau0 >= 0.0,
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((n,), device=dev),
            torch.zeros((n, MEDIUM_STACK_K), dtype=torch.int32, device=dev),
            counters0, pdfr00)
    rounds = 0
    limit = max_rounds if max_rounds is not None else float("inf")
    every = 1 if max_rounds is not None else ALIVE_CHECK_EVERY
    while rounds < limit and bool(st.alive.any()):
        for _ in range(every):
            if rounds >= limit:
                break
            st = body(st)
            rounds += 1
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
    if return_state:
        return st
    return st.acc, st.counters
