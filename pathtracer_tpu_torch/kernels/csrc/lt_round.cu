// The light tracer's bounce round: K12-LT (closest-hit sweep + LT shading)
// and K34-LT (the connections' shadow sweeps + finalize), the latter with
// the respawn in the kernel (v2) or from the spawn feed's rows (v1).
//
// Replaces pathtracer_tpu/kernels/lt_mega.py's Pallas calls of
// _lt_shade_kernel (_lt_round_v2 1089, _lt_step 986), of
// _lt_finalize_spawn_kernel with _spawn_inkernel (_lt_round_v2 1106) and
// of _lt_finalize_kernel (_lt_step 1005). Their plain twins are
// kernels/lt_mega.py:lt_shade_plain, lt_finalize_spawn_plain and
// lt_finalize_plain, in the same operation order (the library is built
// without FMA contraction).
//
// K12-LT writes the Q rows [q2_rows(cs), n]: the direct lens-hit splat
// (pid, xyz), whether the walk goes on, the BSDF sample (pdf, throughput
// ratio, ok, new origin and direction), and per camera sample the lens
// connection's shadow ray, splat and validity. K34-LT writes the new state
// [16, n], the resolved connection splats and counter rows; v2 also the
// light vertex's resolved splat. Every splat is written as a row (zeros
// where it is not valid), so each row can be held against the twin's; the
// kernel that settles a valid splat also adds it to the film [width *
// height, 3] with one atomicAdd a component (the direct hit in K12-LT; the
// unblocked connections and the light vertex in K34-LT), and skips the rest,
// which would add +0.0.
//
// One thread runs one lane. All three kernels walk the compact sweep table
// (kernels/dense.py:pack_sweep_np, MegaScene.sweep_tab) from shared memory
// through walk.cuh, as K12 and K34 do: resident up to the caller's budget of
// rows, copied there once per block by one bulk copy on an mbarrier, else
// through walk.cuh's ring of bulk-copied tiles; the ray's terms once per
// ray, a rect's normal and edge norms read from its row. K12-LT walks for
// the closest hit, two rows a loop turn. K34-LT walks all the shadow rays
// of a lane: v2 walks its cs connection rays and its light vertex's lens
// connection together, each row read once and tested against every one of
// them, a warp leaving the rows when none of its lanes has a ray unresolved
// (cs 1 and 2 are instantiated; any other cs, and v1, walk one ray at a
// time). The walks need every thread of the block, so a lane reads its walk
// state, samples its respawn (v2) and writes its new state rows, which read
// no verdict, before them; only the splat and counter rows wait for the
// verdicts, and the lane holds no more than them across the walks.
//
// What bounds the kernels on the H100: instruction issue in the walks (a
// live lane's closest-hit walk in K12-LT; in K34-LT up to cs + 1 shadow rays
// over the table) and in the shading and the spawn (its powf, sincos and
// dependent CDF loads, which must keep their bits), against about 0.3 KB of
// memory traffic a lane. The Pallas one-hot fetches (_prim_attr_fetch,
// _sel_rows, the light rows) are indexed loads, _spectral_fetch the f32
// lerp of round_common.cuh, and the [knot, lane] compare-and-sum inversion
// of the emission CDF a per-lane binary search over the picked light's
// column of the spawn table (the same knot count, the CDF being monotone).
// A lane dead at the round's start gets zero Q rows and sweeps nothing in
// K12-LT; a live lane that hits nothing
// gets zero Q rows too, which leaves zero-length connection rays that K34-LT
// counts as unblocked, as the JAX kernels count their NaN rays. K34-LT
// sweeps the connection rays of lanes alive at the round's start (the
// counter counts them) and the light vertex's ray only where a particle is
// spawned with a valid connection; it samples particles only for lanes
// that respawn.
#include <cuda_runtime.h>

#include "round_common.cuh"
#include "walk.cuh"

// mirrors kernels/lt_mega.py:_CLtArgs (all fields 4 bytes, same order)
struct LtArgs {
  int cs, n_mats, n_lights, nl1, has_ggx, has_sharp, has_proxy, lens_on;
  int env_on, rr_enabled;
  float lam_lo, lam_span, lam_step, max_bounces, min_bounces, width, height;
  float wb_lo, wb_hi, wb_span, inv_wb_span, p_env, q_pick, nl_f, inv_cs;
  float p_conn_cs, p_conn_1, a_lens_div, a_film, focal, focal2, half_w_div;
  float half_h_div, lens_r, world_radius, pos_pdf;
  float env_rot_inv[9], cam_origin[3], cam_u[3], cam_v[3], cam_w[3];
  float cam_fw[3], world_center[3];
};

namespace {

using pt::V3;
using rc::LamPos;

constexpr int BLOCK = 128;
constexpr int MAX_PRIMS = 8192;  // the megakernel gate

// LT state rows [16, n], Q rows, spawn-feed rows, K34-LT rows
constexpr int LS_O = 0, LS_D = 3, LS_LAM = 6, LS_BETA = 7, LS_PREV = 8;
constexpr int LS_ALIVE = 9, LS_BOUNCE = 10, LS_BUDGET = 11, LS_ENV = 12;
constexpr int NS_LT = 16;
constexpr int Q_HIT_PID = 0, Q_HIT_XYZ = 1, Q_ALIVE = 4, Q_FPDF = 5;
constexpr int Q_RATIO = 6, Q_SOK = 7, Q_ONEW = 8, Q_DNEW = 11, Q_CONN = 14;
constexpr int CONN_ROWS = 12;
constexpr int F_O = 0, F_D = 3, F_LAM = 6, F_BETA = 7, F_PREV = 8;
constexpr int F_ALIVE = 9, F_ENV = 10, F_LV = 11, F_LV_VALID = 22;
constexpr int K4_CONN = NS_LT;
constexpr int SP_CDFLO = 512, SP_CDFHI = 513, SP_INTEG = 514;

__device__ __forceinline__ int q2_rows(int cs) {
  return (Q_CONN + CONN_ROWS * cs + 7) / 8 * 8;
}

__device__ __forceinline__ LamPos lam_pos(float lam, const LtArgs& a) {
  float u = (lam - a.lam_lo) / a.lam_span * (float)(rc::SPEC_RES - 1);
  u = pt::clampf(u, 0.0f, (float)(rc::SPEC_RES - 1 - 1e-4));
  float f0 = floorf(u);
  return LamPos{(int)f0, u - f0};
}

// thin-lens get_pixel_for_ray of a ray from lens point o travelling dn into
// the scene -> film pixel id (f32); *ok: it lands on the film
__device__ __forceinline__ float film_pid_for(const LtArgs& a, V3 o, V3 dn,
                                              bool* ok) {
  const float* cw = a.cam_w;
  const float* co = a.cam_origin;
  const float cos_f = dn.x * cw[0] + dn.y * cw[1] + dn.z * cw[2];
  const bool valid = cos_f > 1e-6f;
  const float tt = a.focal / (valid ? cos_f : 1.0f);
  const float px = o.x + tt * dn.x - co[0] - a.cam_fw[0];
  const float py = o.y + tt * dn.y - co[1] - a.cam_fw[1];
  const float pz = o.z + tt * dn.z - co[2] - a.cam_fw[2];
  const float fu = (px * a.cam_u[0] + py * a.cam_u[1] + pz * a.cam_u[2]) /
                   a.half_w_div;
  const float fv = (px * a.cam_v[0] + py * a.cam_v[1] + pz * a.cam_v[2]) /
                   a.half_h_div;
  const float film_u = (fu + 1.0f) * 0.5f;
  const float film_v = (1.0f - fv) * 0.5f;
  *ok = valid && film_u >= 0.0f && film_u < 1.0f && film_v >= 0.0f &&
        film_v < 1.0f;
  const float pxi = pt::minf(floorf(film_u * a.width), a.width - 1.0f);
  const float pyi = pt::minf(floorf(film_v * a.height), a.height - 1.0f);
  return pyi * a.width + pxi;
}

// a point on the thin-lens aperture disk (polar map: √u1, 2πu2)
__device__ __forceinline__ V3 lens_point_for(const LtArgs& a, float u1,
                                             float u2) {
  const float r_d = sqrtf(u1);
  const float phi = pt::TWO_PI_F * u2;
  const float lx = r_d * cosf(phi) * a.lens_r;
  const float ly = r_d * sinf(phi) * a.lens_r;
  const float* co = a.cam_origin;
  return V3{co[0] + lx * a.cam_u[0] + ly * a.cam_v[0],
            co[1] + lx * a.cam_u[1] + ly * a.cam_v[1],
            co[2] + lx * a.cam_u[2] + ly * a.cam_v[2]};
}

// a valid splat's XYZ added to film pixel `pid` (an f32 pixel id, exact
// below 2^24)
__device__ __forceinline__ void splat(float* __restrict__ film, float pid,
                                      float x, float y, float z) {
  float* px = film + 3 * (size_t)pid;
  atomicAdd(px, x);
  atomicAdd(px + 1, y);
  atomicAdd(px + 2, z);
}

// the lens importance focal² / (cos³θ · A_film)
__device__ __forceinline__ float lens_we(const LtArgs& a, float cos_cam) {
  const float x = pt::maxf(cos_cam, 1e-6f);
  return a.focal2 / (x * (x * x) * a.a_film);
}

__device__ __forceinline__ float cam_cos(const LtArgs& a, V3 d) {
  return fabsf(d.x * a.cam_w[0] + d.y * a.cam_w[1] + d.z * a.cam_w[2]);
}

// materials.tables.emission_direction_pdf on light-table values
__device__ __forceinline__ float emission_dir_pdf(float mtype, float side,
                                                  float sharp, float cos_t,
                                                  bool has_sharp) {
  if (!(mtype == rc::MAT_DIFFUSE_LIGHT || mtype == rc::MAT_SHARP_LIGHT))
    return 0.0f;
  float fwd = cos_t > 0.0f ? 1.0f : 0.0f;
  float rev = cos_t < 0.0f ? 1.0f : 0.0f;
  float dual = cos_t != 0.0f ? 1.0f : 0.0f;
  float gate = side == 2.0f ? dual : (side == 0.0f ? fwd : rev);
  float p = fabsf(cos_t) / pt::PI_F * gate;
  if (has_sharp && mtype == rc::MAT_SHARP_LIGHT)
    p = (sharp + 1.0f) * powf(fabsf(cos_t), sharp) / pt::TWO_PI_F * gate;
  return side == 2.0f ? p * 0.5f : p;
}

// --------------------------------------------------------------- K12-LT

__global__ void __launch_bounds__(BLOCK) lt_shade_kernel(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ q, float* __restrict__ film, int n,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    const float* __restrict__ prim, int p_pad, const float* __restrict__ mat,
    const float* __restrict__ spec, const LtArgs a) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  auto S = [&](int r) { return state[r * N + i]; };
  const bool live = i < n && S(LS_ALIVE) > 0.5f;
  V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  if (live) {
    o = V3{S(LS_O), S(LS_O + 1), S(LS_O + 2)};
    d = V3{S(LS_D), S(LS_D + 1), S(LS_D + 2)};
  }
  float t_hit = INFINITY;
  int pid = -1;
  walk::closest(T, live, o, d, &t_hit, &pid);
  if (i >= n) return;
  const int cs = a.cs;
  auto Q = [&](int r, float v) { q[r * N + i] = v; };
  auto U = [&](int r) { return u[r * N + i]; };
  if (!live || pid < 0) {
    for (int r = 0; r < q2_rows(cs); ++r) Q(r, 0.0f);
    return;
  }
  const float lam = S(LS_LAM), beta = S(LS_BETA), prev_pdf = S(LS_PREV);
  const float bounce = S(LS_BOUNCE);
  const bool from_env = S(LS_ENV) > 0.5f;
  V3 point, normal, gn;
  rc::hit_geometry(prim, p_pad, pid, o, d, t_hit, &point, &normal, &gn);
  const float kind = __ldg(prim + rc::R_KIND * p_pad + pid);
  const int mid = (int)__ldg(prim + rc::R_MAT * p_pad + pid);
  const LamPos lp = lam_pos(lam, a);

  // ---- the direct light -> lens hit (a hit on the lens proxy from the
  // scene's side)
  const float d_dot_w = d.x * a.cam_w[0] + d.y * a.cam_w[1] + d.z * a.cam_w[2];
  float fpid_h = 0.0f, e_hit = 0.0f;
  bool hit_ok = false;
  if (kind == 2.0f && d_dot_w < 0.0f) {
    bool on_film_h;
    fpid_h = film_pid_for(a, point, -d, &on_film_h);
    const float cos_cam_h = fabsf(d_dot_w);
    float we_area = 0.0f;
    if (a.lens_on) {
      const float x = pt::maxf(cos_cam_h, 1e-6f);
      we_area = a.focal2 / (a.a_lens_div * ((x * x) * (x * x)) * a.a_film);
    }
    const float tm = pt::maxf(t_hit, 1e-6f);
    const float p_hit_area = prev_pdf * cos_cam_h / (tm * tm);
    const float n_comp = bounce < 0.5f ? 1.0f : (float)cs;
    const float denom = p_hit_area + n_comp / a.a_lens_div;
    float w_hit = denom > 0.0f ? p_hit_area / denom : 0.0f;
    if (bounce < 0.5f && from_env) w_hit = 1.0f;
    e_hit = beta * we_area * w_hit;
    hit_ok = on_film_h && isfinite(e_hit) && e_hit > 0.0f;
  }
  const float eh = hit_ok ? e_hit : 0.0f;
  const float hx = eh * pt::x_bar(lam), hy = eh * pt::y_bar(lam);
  const float hz = eh * pt::z_bar(lam);
  Q(Q_HIT_PID, hit_ok ? fpid_h : 0.0f);
  Q(Q_HIT_XYZ, hx);
  Q(Q_HIT_XYZ + 1, hy);
  Q(Q_HIT_XYZ + 2, hz);
  if (hit_ok) splat(film, fpid_h, hx, hy, hz);
  const bool alive = kind != 2.0f;

  // ---- shading frame and material
  V3 tgt, btg;
  pt::orthonormal_basis(normal, &tgt, &btg);
  const V3 wi_local = pt::to_local(tgt, btg, normal, -d);
  auto M = [&](int r) { return __ldg(mat + r * 128 + mid); };
  const float mtype = M(rc::M_TYPE), alpha = M(rc::M_ALPHA);
  const float metal = M(rc::M_METAL), perm = M(rc::M_PERM);
  const float eta_i = rc::spec_at(spec, 5 * mid + 0, lp);
  const float eta_o = rc::spec_at(spec, 5 * mid + 1, lp);
  const float kappa = rc::spec_at(spec, 5 * mid + 2, lp);
  const float refl = M(rc::M_RSCALE) * rc::spec_at(spec, 5 * mid + 3, lp);

  // ---- the lens connections
  for (int ci = 0; ci < cs; ++ci) {
    const V3 lens = lens_point_for(a, U(2 * ci), U(2 * ci + 1));
    const V3 to_cam = lens - point;
    const float dist2 = pt::maxf(pt::length_squared(to_cam), 1e-12f);
    const float dist = sqrtf(dist2);
    const V3 dir_c = pt::scale(to_cam, 1.0f / dist);
    const V3 so = point + pt::scale(gn, rc::NORMAL_OFFSET *
                                            pt::signf(pt::dot(gn, dir_c) +
                                                      1e-9f));
    float fpid = 0.0f, energy = 0.0f;
    bool valid = false;
    if (alive) {
      bool on_film;
      fpid = film_pid_for(a, lens, -dir_c, &on_film);
      const float cos_cam = cam_cos(a, dir_c);
      const V3 wo_l = pt::to_local(tgt, btg, normal, dir_c);
      float f_c, pdf_c;
      rc::bsdf_eval_lanes<1, false>(mtype, alpha, metal, perm, &eta_i,
                                    &eta_o, &kappa, &refl, wi_local, wo_l,
                                    a.has_ggx, true, &f_c, &pdf_c);
      energy = beta * a.inv_cs / dist2 * lens_we(a, cos_cam) * f_c *
               fabsf(wo_l.z);
      if (a.has_proxy && a.lens_on) {
        const float den = a.p_conn_cs + pdf_c * cos_cam / dist2;
        energy = energy * (den > 0.0f ? a.p_conn_cs / den : 1.0f);
      }
      valid = on_film && energy > 0.0f && isfinite(energy);
    }
    const int b = Q_CONN + CONN_ROWS * ci;
    Q(b + 0, so.x);
    Q(b + 1, so.y);
    Q(b + 2, so.z);
    Q(b + 3, dir_c.x);
    Q(b + 4, dir_c.y);
    Q(b + 5, dir_c.z);
    Q(b + 6, dist * 0.99f);
    Q(b + 7, valid ? fpid : 0.0f);
    const float e = valid ? energy : 0.0f;
    Q(b + 8, e * pt::x_bar(lam));
    Q(b + 9, e * pt::y_bar(lam));
    Q(b + 10, e * pt::z_bar(lam));
    Q(b + 11, valid ? 1.0f : 0.0f);
  }
  for (int r = Q_CONN + CONN_ROWS * cs; r < q2_rows(cs); ++r) Q(r, 0.0f);

  // ---- the continuation sample (Importance transport)
  if (!alive) {
    for (int r = Q_ALIVE; r < Q_CONN; ++r) Q(r, 0.0f);
    return;
  }
  const float ub0 = U(2 * cs), ub1 = U(2 * cs + 1), ub2 = U(2 * cs + 2);
  V3 wo_s;
  float ratio;
  if (a.has_ggx && mtype == rc::MAT_GGX) {
    wo_s = pt::sample_ggx_dir<false>(
        pt::maxf(alpha, 1e-4f), pt::maxf(eta_i, 1e-3f),
        pt::maxf(eta_o, 1e-3f), kappa, metal > 0.5f, perm, wi_local, ub0,
        ub1, ub2, true, &ratio);
  } else {
    float f_l, p_l;
    wo_s = pt::sample_lambertian(refl, wi_local, ub0, ub1, &f_l, &p_l);
    ratio = pt::minf(refl, 1.0f);
  }
  // the sampled lobe's pdf is its eval pdf at wo_s (0 for a passthrough)
  float f_s, f_pdf;
  rc::bsdf_eval_lanes<1, false>(mtype, alpha, metal, perm, &eta_i, &eta_o,
                                &kappa, &refl, wi_local, wo_s, a.has_ggx,
                                true, &f_s, &f_pdf);
  if (mtype == rc::MAT_PASSTHROUGH) ratio = 0.0f;
  const bool sample_ok = f_pdf > 1e-12f && ratio > 0.0f;
  const V3 d_new = pt::normalize(pt::to_world(tgt, btg, normal, wo_s));
  const V3 o_new =
      point + pt::scale(gn, rc::NORMAL_OFFSET * pt::signf(pt::dot(gn, d_new)));
  Q(Q_ALIVE, 1.0f);
  Q(Q_FPDF, f_pdf);
  Q(Q_RATIO, ratio);
  Q(Q_SOK, sample_ok ? 1.0f : 0.0f);
  Q(Q_ONEW, o_new.x);
  Q(Q_ONEW + 1, o_new.y);
  Q(Q_ONEW + 2, o_new.z);
  Q(Q_DNEW, d_new.x);
  Q(Q_DNEW + 1, d_new.y);
  Q(Q_DNEW + 2, d_new.z);
}

// --------------------------------------------------------------- K34-LT

// what a lane reads of its state and its Q rows, and whether its walk goes
// on (Russian roulette, depth cap)
struct Walk {
  V3 o, d, o_new, d_new;
  float lam, beta, prev, bounce, budget, env, f_pdf, beta_next;
  bool cp, hw;
};

__device__ __forceinline__ void walk_in(const float* __restrict__ state,
                                        const float* __restrict__ k2,
                                        float u_rr, size_t N, int i,
                                        const LtArgs& a, Walk& w) {
  auto S = [&](int r) { return state[r * N + i]; };
  auto K = [&](int r) { return k2[r * N + i]; };
  w.o = V3{S(LS_O), S(LS_O + 1), S(LS_O + 2)};
  w.d = V3{S(LS_D), S(LS_D + 1), S(LS_D + 2)};
  w.lam = S(LS_LAM);
  w.beta = S(LS_BETA);
  w.prev = S(LS_PREV);
  w.bounce = S(LS_BOUNCE);
  w.budget = S(LS_BUDGET);
  w.env = S(LS_ENV);
  w.o_new = V3{K(Q_ONEW), K(Q_ONEW + 1), K(Q_ONEW + 2)};
  w.d_new = V3{K(Q_DNEW), K(Q_DNEW + 1), K(Q_DNEW + 2)};
  w.f_pdf = K(Q_FPDF);
  const float ratio = K(Q_RATIO);
  const bool sample_ok = K(Q_SOK) > 0.5f;
  float p_cont = 1.0f;
  if (a.rr_enabled && w.bounce >= a.min_bounces)
    p_cont = pt::clampf(ratio, 0.05f, 1.0f);
  const bool survive = u_rr < p_cont;
  w.beta_next = w.beta * (sample_ok ? ratio / pt::maxf(p_cont, 1e-6f) : 0.0f);
  w.cp = K(Q_ALIVE) > 0.5f && sample_ok && survive &&
         !(w.bounce + 1.0f >= a.max_bounces) && isfinite(w.beta_next);
  w.hw = !w.cp && w.budget >= 0.5f;
}

// connection ci's shadow ray of a lane alive at the round's start, from its
// Q rows (zeros on any other lane) -> whether it is walked: a zero-length
// ray (tmax <= T_MIN) is never blocked, as the JAX kernels count their NaN
// rays
__device__ __forceinline__ bool conn_ray(const float* __restrict__ k2,
                                         size_t N, int i, int ci,
                                         bool alive0, V3* so, V3* sd,
                                         float* tmax) {
  auto K = [&](int r) { return k2[r * N + i]; };
  const int b = Q_CONN + CONN_ROWS * ci;
  *so = *sd = V3{0.f, 0.f, 0.f};
  *tmax = 0.0f;
  if (alive0) {
    *so = V3{K(b), K(b + 1), K(b + 2)};
    *sd = V3{K(b + 3), K(b + 4), K(b + 5)};
    *tmax = K(b + 6);
  }
  return alive0 && *tmax > walk::T_MIN;
}

// connection ci's verdict: its splat rows into out and, if it is valid and
// unblocked, its splat into the film (a lane < n); -> 1 if it counts as an
// unblocked ray of a lane alive at the round's start
__device__ __forceinline__ float conn_out(const float* __restrict__ k2,
                                          float* __restrict__ out,
                                          float* __restrict__ film, size_t N,
                                          int i, int ci, bool in, bool alive0,
                                          bool blocked) {
  if (in) {
    auto K = [&](int r) { return k2[r * N + i]; };
    const int b = Q_CONN + CONN_ROWS * ci;
    const bool ok = K(b + 11) > 0.5f && !blocked;
    const int o = K4_CONN + 4 * ci;
    float v[4];
    for (int k = 0; k < 4; ++k) {
      v[k] = ok ? K(b + 7 + k) : 0.0f;
      out[(o + k) * N + i] = v[k];
    }
    if (ok) splat(film, v[0], v[1], v[2], v[3]);
  }
  return (alive0 && !blocked) ? 1.0f : 0.0f;
}

// the shadow walks of a lane (every thread of the block calls it): its cs
// connection rays and its light vertex's lens connection (lv_want false
// where it has none). CS = cs (1 or 2): all cs + 1 rays in one walk of the
// table, each row tested against all of them; CS = 0 (any other cs): one
// ray a walk. Writes the connections' splat rows and adds their valid
// splats to the film; -> the unblocked connections of a lane alive at the
// round's start
template <int CS>
__device__ __forceinline__ float shadow_walks(
    walk::Table& T, const float* __restrict__ k2, float* __restrict__ out,
    float* __restrict__ film, size_t N, int i, bool in, bool alive0, int cs,
    bool lv_want, V3 lv_o, V3 lv_d, float lv_tmax, bool* lv_blocked) {
  float conn_ct = 0.0f;
  if constexpr (CS > 0) {
    bool want[CS + 1], blocked[CS + 1];
    V3 so[CS + 1], sd[CS + 1];
    float tmax[CS + 1];
#pragma unroll
    for (int ci = 0; ci < CS; ++ci)
      want[ci] = conn_ray(k2, N, i, ci, alive0, &so[ci], &sd[ci], &tmax[ci]);
    want[CS] = lv_want;
    so[CS] = lv_o;
    sd[CS] = lv_d;
    tmax[CS] = lv_tmax;
    walk::any_hit<CS + 1>(T, want, so, sd, tmax, blocked);
#pragma unroll
    for (int ci = 0; ci < CS; ++ci)
      conn_ct += conn_out(k2, out, film, N, i, ci, in, alive0, blocked[ci]);
    *lv_blocked = blocked[CS];
  } else {
    for (int ci = 0; ci < cs; ++ci) {
      V3 so, sd;
      float tmax;
      bool blocked;
      const bool want = conn_ray(k2, N, i, ci, alive0, &so, &sd, &tmax);
      walk::any_hit<1>(T, &want, &so, &sd, &tmax, &blocked);
      conn_ct += conn_out(k2, out, film, N, i, ci, in, alive0, blocked);
    }
    walk::any_hit<1>(T, &lv_want, &lv_o, &lv_d, &lv_tmax, lv_blocked);
  }
  return conn_ct;
}

// the new state rows of a lane: a continuing walk steps, a lane with
// budget left takes the new particle, any other lane keeps its state
__device__ __forceinline__ void write_state(
    const float* __restrict__ state, float* __restrict__ out, size_t N, int i,
    const Walk& w, V3 sp_o, V3 sp_d, float sp_lam, float sp_beta,
    float sp_prev, bool resp_ok, float sp_env) {
  auto O = [&](int r, float v) { out[r * N + i] = v; };
  const V3 o = w.cp ? w.o_new : (w.hw ? sp_o : w.o);
  const V3 d = w.cp ? w.d_new : (w.hw ? sp_d : w.d);
  O(LS_O, o.x);
  O(LS_O + 1, o.y);
  O(LS_O + 2, o.z);
  O(LS_D, d.x);
  O(LS_D + 1, d.y);
  O(LS_D + 2, d.z);
  O(LS_LAM, w.hw ? sp_lam : w.lam);
  O(LS_BETA, w.cp ? w.beta_next : (w.hw ? sp_beta : w.beta));
  O(LS_PREV, w.cp ? w.f_pdf : (w.hw ? sp_prev : w.prev));
  O(LS_ALIVE, (w.cp || resp_ok) ? 1.0f : 0.0f);
  O(LS_BOUNCE, w.cp ? w.bounce + 1.0f : (w.hw ? 0.0f : w.bounce));
  O(LS_BUDGET, w.hw ? w.budget - 1.0f : w.budget);
  O(LS_ENV, w.hw ? sp_env : w.env);
  for (int r = LS_ENV + 1; r < NS_LT; ++r) O(r, state[r * N + i]);
}

// a new particle and its light vertex's lens connection (the JAX
// package's _spawn_inkernel)
struct Spawn {
  V3 o, d, so_lv, dir_lv;
  float lam, beta, prev0, tmax_lv, lv_pid, lv_xyz[3];
  bool alive, pick_env, lv_valid;
};

__device__ __forceinline__ void spawn_v2(const LtArgs& a,
                                         const float* __restrict__ usp,
                                         size_t N, int i,
                                         const float* __restrict__ light,
                                         const float* __restrict__ spec,
                                         const float* __restrict__ lcdf,
                                         Spawn& sp) {
  auto U = [&](int r) { return usp[r * N + i]; };
  // ---- the light pick and its surface sample
  const int li = (int)pt::minf(floorf(U(0) * a.nl_f), a.nl_f - 1.0f);
  auto Lr = [&](int r) { return __ldg(light + r * 128 + li); };
  auto Cd = [&](int r) { return __ldg(lcdf + r * 128 + li); };
  V3 lpa{Lr(rc::L_PA), Lr(rc::L_PA + 1), Lr(rc::L_PA + 2)};
  V3 lpb{Lr(rc::L_PB), Lr(rc::L_PB + 1), Lr(rc::L_PB + 2)};
  V3 lpc{Lr(rc::L_PC), Lr(rc::L_PC + 1), Lr(rc::L_PC + 2)};
  V3 lp, ln;
  rc::sample_surface_light(Lr(rc::L_PTYPE), lpa, lpb, lpc, U(1), U(2), &lp,
                           &ln);
  const float area_pdf = 1.0f / pt::maxf(Lr(rc::L_AREA), 1e-20f);
  const float l_mat = Lr(rc::L_MAT), l_mtype = Lr(rc::L_MTYPE);
  const float l_side = Lr(rc::L_SIDE), l_sharp = Lr(rc::L_SHARP);

  // ---- the emission-λ CDF inversion: i1 = the number of knots whose CDF
  // is below the target, by binary search over the light's column
  const float cdf_lo = Cd(SP_CDFLO), cdf_hi = Cd(SP_CDFHI);
  const float span = pt::maxf(cdf_hi - cdf_lo, 1e-9f);
  const float target = cdf_lo + U(3) * span;
  int i1 = 0;
  for (int s = rc::SPEC_RES >> 1; s; s >>= 1) {
    const int probe = i1 + s;
    if (Cd(probe - 1) < target) i1 = probe;
  }
  i1 = min(max(i1, 1), rc::SPEC_RES - 1);
  const float c0 = Cd(i1 - 1), c1 = Cd(i1);
  const float frac =
      pt::clampf((target - c0) / pt::maxf(c1 - c0, 1e-12f), 0.0f, 1.0f);
  float lam_i = a.lam_lo + ((float)(i1 - 1) + frac) * a.lam_step;
  lam_i = pt::clampf(lam_i, a.wb_lo, a.wb_hi);
  sp.pick_env = a.env_on && U(8) < a.p_env;
  sp.lam = sp.pick_env ? a.wb_lo + U(3) * a.wb_span : lam_i;
  const LamPos lpos = lam_pos(sp.lam, a);
  const float spd = rc::spec_at(spec, 5 * (int)l_mat + 4, lpos);
  const float lam_pdf = spd / pt::maxf(Cd(SP_INTEG) * span, 1e-20f);

  // ---- the emission direction (cosine or cosine-power lobe)
  const float nexp =
      (a.has_sharp && l_mtype == rc::MAT_SHARP_LIGHT) ? l_sharp : 1.0f;
  const float cos_t = powf(U(4), 1.0f / (nexp + 1.0f));
  const float sin_t = sqrtf(pt::maxf(1.0f - cos_t * cos_t, 0.0f));
  const float phi_d = pt::TWO_PI_F * U(5);
  const bool pick_rev = l_side == 1.0f || (l_side == 2.0f && U(6) < 0.5f);
  V3 t_ax, b_ax;
  pt::orthonormal_basis(ln, &t_ax, &b_ax);
  const V3 fn = pick_rev ? -ln : ln;
  const float lx = sin_t * cosf(phi_d), ly = sin_t * sinf(phi_d);
  const V3 d0{lx * t_ax.x + ly * b_ax.x + cos_t * fn.x,
              lx * t_ax.y + ly * b_ax.y + cos_t * fn.y,
              lx * t_ax.z + ly * b_ax.z + cos_t * fn.z};
  float dir_pdf = (nexp + 1.0f) * powf(cos_t, nexp) / pt::TWO_PI_F;
  if (l_side == 2.0f) dir_pdf = dir_pdf * 0.5f;
  const float le = rc::emission_value(spd, l_mtype, l_side, l_sharp,
                                      pt::dot(ln, d0), a.has_sharp);
  const float den_i = a.q_pick * area_pdf * dir_pdf * lam_pdf;
  float beta = den_i != 0.0f ? le * fabsf(cos_t) / den_i : 0.0f;
  bool alive = a.n_lights > 0 && beta > 0.0f;
  sp.o = lp + pt::scale(ln, rc::NORMAL_OFFSET * pt::signf(pt::dot(ln, d0)));
  sp.d = d0;
  sp.prev0 = dir_pdf;

  // ---- the constant environment: a direction, and a point on the world
  // disk facing inward
  if (a.env_on) {
    const V3 duv = pt::uv_to_direction(U(1), U(2));
    const float* ri = a.env_rot_inv;
    const V3 d_out{ri[0] * duv.x + ri[1] * duv.y + ri[2] * duv.z,
                   ri[3] * duv.x + ri[4] * duv.y + ri[5] * duv.z,
                   ri[6] * duv.x + ri[7] * duv.y + ri[8] * duv.z};
    const float jac_s = rc::TWO_PI2 * sinf(pt::PI_F * U(2)) + 0.001f;
    const float dir_pdf_env = 1.0f / jac_s;
    const float le_env = rc::spec_at(spec, 5 * a.n_mats, lpos);
    const float r = a.world_radius;
    V3 te, be;
    pt::orthonormal_basis(d_out, &te, &be);
    const float dr = sqrtf(U(4)), dphi = pt::TWO_PI_F * U(5);
    const float dx = dr * cosf(dphi) * r, dy = dr * sinf(dphi) * r;
    const float* c = a.world_center;
    const V3 lp_e{c[0] + d_out.x * r + dx * te.x + dy * be.x,
                  c[1] + d_out.y * r + dx * te.y + dy * be.y,
                  c[2] + d_out.z * r + dx * te.z + dy * be.z};
    const float den_e = a.p_env * dir_pdf_env * a.pos_pdf * a.inv_wb_span;
    const float beta_e = den_e != 0.0f ? le_env / den_e : 0.0f;
    if (sp.pick_env) {
      beta = beta_e;
      sp.o = lp_e;
      sp.d = -d_out;
      alive = beta_e > 0.0f;
      sp.prev0 = dir_pdf_env;
    }
  }
  sp.beta = (isfinite(beta) && beta > 0.0f) ? beta : 0.0f;
  sp.alive = alive && sp.beta > 0.0f;

  // ---- the light vertex's lens connection
  const V3 lens = lens_point_for(a, U(9), U(10));
  const V3 to_cam = lens - lp;
  const float dist2 = pt::maxf(pt::length_squared(to_cam), 1e-12f);
  const float dist = sqrtf(dist2);
  sp.dir_lv = pt::scale(to_cam, 1.0f / dist);
  bool on_film;
  sp.lv_pid = film_pid_for(a, lens, -sp.dir_lv, &on_film);
  const float cos_cam = cam_cos(a, sp.dir_lv);
  const float den_f = a.q_pick * area_pdf * lam_pdf;
  const float beta_f = den_f != 0.0f ? 1.0f / den_f : 0.0f;
  const float cos_lc = pt::dot(ln, sp.dir_lv);
  const float le_c = rc::emission_value(spd, l_mtype, l_side, l_sharp, cos_lc,
                                        a.has_sharp);
  float energy =
      beta_f / dist2 * lens_we(a, cos_cam) * le_c * fabsf(cos_lc);
  if (a.has_proxy && a.lens_on) {
    const float den =
        a.p_conn_1 + emission_dir_pdf(l_mtype, l_side, l_sharp, cos_lc,
                                      a.has_sharp) *
                         cos_cam / dist2;
    energy = energy * (den > 0.0f ? a.p_conn_1 / den : 1.0f);
  }
  sp.lv_valid = a.n_lights > 0 && on_film && energy > 0.0f &&
                isfinite(energy) && !sp.pick_env;
  sp.so_lv = lp + pt::scale(ln, rc::NORMAL_OFFSET * pt::signf(cos_lc + 1e-9f));
  sp.tmax_lv = dist * 0.99f;
  const float e = sp.lv_valid ? energy : 0.0f;
  sp.lv_xyz[0] = e * pt::x_bar(lam_i);
  sp.lv_xyz[1] = e * pt::y_bar(lam_i);
  sp.lv_xyz[2] = e * pt::z_bar(lam_i);
}

// K34-LT v2: the respawn sampled in the kernel; CS as shadow_walks'. The
// joint walk keeps cs + 1 rays' terms live beside the lane's walk and spawn
// (86 registers at cs 1, 110 at cs 2: five and four blocks an SM); capped at
// six blocks an SM (80 registers, a few bytes spilled) it ran 3-10% faster
// on the H100 than uncapped and than one ray a walk
template <int CS>
__global__ void __launch_bounds__(BLOCK, 6) lt_finalize_spawn_kernel(
    const float* __restrict__ u, const float* __restrict__ usp,
    const float* __restrict__ state, const float* __restrict__ k2,
    float* __restrict__ out, float* __restrict__ film, int n,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    const float* __restrict__ light, const float* __restrict__ spec,
    const float* __restrict__ lcdf, const LtArgs a) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  // cs >= 1 (args_ok): a walk always follows
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool in = i < n;
  const bool alive0 = in && state[LS_ALIVE * N + i] > 0.5f;
  const int cs = CS > 0 ? CS : a.cs;
  Walk w;
  Spawn sp{};
  w.hw = w.cp = false;
  if (in) {
    walk_in(state, k2, u[(2 * cs + 3) * N + i], N, i, a, w);
    if (w.hw) spawn_v2(a, usp, N, i, light, spec, lcdf, sp);
    // the state rows read no verdict: written before the walk, which then
    // holds neither the lane's walk nor its new particle
    write_state(state, out, N, i, w, sp.o, sp.d, sp.lam, sp.beta, sp.prev0,
                w.hw && sp.alive, sp.pick_env ? 1.0f : 0.0f);
  }
  const bool lv_want = in && w.hw && sp.lv_valid;
  bool lv_blocked;
  const float conn_ct =
      shadow_walks<CS>(T, k2, out, film, N, i, in, alive0, cs, lv_want,
                       sp.so_lv, sp.dir_lv, sp.tmax_lv, &lv_blocked);
  if (!in) return;
  auto O = [&](int r, float v) { out[r * N + i] = v; };
  const bool lv_gate = lv_want && !lv_blocked;
  const int base = K4_CONN + 4 * cs;
  O(base, lv_gate ? sp.lv_pid : 0.0f);
  for (int k = 0; k < 3; ++k) O(base + 1 + k, lv_gate ? sp.lv_xyz[k] : 0.0f);
  if (lv_gate) splat(film, sp.lv_pid, sp.lv_xyz[0], sp.lv_xyz[1], sp.lv_xyz[2]);
  O(base + 4, w.hw ? 1.0f : 0.0f);
  O(base + 5, w.cp ? 1.0f : 0.0f);
  O(base + 6, conn_ct);
  O(base + 7, lv_gate ? 1.0f : 0.0f);
  for (int r = base + 8; r < (base + 8 + 7) / 8 * 8; ++r) O(r, 0.0f);
}

// K34-LT v1: the respawn copied from the spawn feed's rows; one shadow ray
// a walk (shadow_walks<0>): the joint walk's registers cost v1 a block an
// SM, and on the H100 it ran 1-2% slower than this. Capped at eight blocks
// an SM: uncapped, nvcc gives it the same 64 registers and 8 blocks with a
// larger stack frame, and on the H100 it ran 3.8% slower with the film splat
__global__ void __launch_bounds__(BLOCK, 8) lt_finalize_kernel(
    const float* __restrict__ u, const float* __restrict__ state,
    const float* __restrict__ k2, const float* __restrict__ feed,
    float* __restrict__ out, float* __restrict__ film, int n,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    const LtArgs a) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool in = i < n;
  const bool alive0 = in && state[LS_ALIVE * N + i] > 0.5f;
  const int cs = a.cs;
  auto F = [&](int r) { return feed[r * N + i]; };
  Walk w;
  w.hw = w.cp = false;
  if (in) {
    walk_in(state, k2, u[(2 * cs + 3) * N + i], N, i, a, w);
    write_state(state, out, N, i, w, V3{F(F_O), F(F_O + 1), F(F_O + 2)},
                V3{F(F_D), F(F_D + 1), F(F_D + 2)}, F(F_LAM), F(F_BETA),
                F(F_PREV), w.hw && F(F_ALIVE) > 0.5f, F(F_ENV));
  }
  const bool lv_want = in && w.hw && F(F_LV_VALID) > 0.5f;
  V3 so{0.f, 0.f, 0.f}, sd{0.f, 0.f, 0.f};
  float tmax = 0.0f;
  if (lv_want) {
    so = V3{F(F_LV), F(F_LV + 1), F(F_LV + 2)};
    sd = V3{F(F_LV + 3), F(F_LV + 4), F(F_LV + 5)};
    tmax = F(F_LV + 6);
  }
  bool lv_blocked;
  const float conn_ct = shadow_walks<0>(T, k2, out, film, N, i, in, alive0,
                                        cs, lv_want, so, sd, tmax,
                                        &lv_blocked);
  if (!in) return;
  auto O = [&](int r, float v) { out[r * N + i] = v; };
  const int base = K4_CONN + 4 * cs;
  const bool lv_gate = lv_want && !lv_blocked;
  if (lv_gate) splat(film, F(F_LV + 7), F(F_LV + 8), F(F_LV + 9), F(F_LV + 10));
  O(base, lv_gate ? 1.0f : 0.0f);
  O(base + 1, w.hw ? 1.0f : 0.0f);
  O(base + 2, w.cp ? 1.0f : 0.0f);
  O(base + 3, conn_ct);
  for (int r = base + 4; r < (base + 4 + 7) / 8 * 8; ++r) O(r, 0.0f);
}

// K34-LT v2 (v2 true) at cs camera samples, or K34-LT v1
const void* finalize_fn(bool v2, int cs) {
  if (!v2) return (const void*)lt_finalize_kernel;
  return cs == 1   ? (const void*)lt_finalize_spawn_kernel<1>
         : cs == 2 ? (const void*)lt_finalize_spawn_kernel<2>
                   : (const void*)lt_finalize_spawn_kernel<0>;
}

// the LT round kernel `which` (0 K12-LT, 1 K34-LT v2, 2 K34-LT v1) at cs
// camera samples
const void* kernel_of(int which, int cs) {
  return which == 0 ? (const void*)lt_shade_kernel
                    : finalize_fn(which == 1, cs);
}

// launch fn over n lanes, `smem` bytes of dynamic shared memory a block,
// with the kernel arguments `args`
int launch(const void* fn, int n, int smem, void** args,
           cudaStream_t stream) {
  int rc = walk::allow_shared(fn, smem);
  if (rc != 0) return rc;
  return (int)cudaLaunchKernel(fn, dim3((n + BLOCK - 1) / BLOCK), dim3(BLOCK),
                               args, (size_t)smem, stream);
}

int attrs(const void* fn, int* regs, int* local_bytes) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

bool args_ok(const LtArgs* a, int p_rows, int resident_rows) {
  return walk::table_ok(p_rows, MAX_PRIMS, resident_rows) && a->cs >= 1 &&
         a->n_lights <= 128;
}

}  // namespace

extern "C" {

// K12-LT: u [>= 2 cs + 4, n], state [16, n] -> q [q2_rows(cs), n], and the
// valid direct-hit splats added to film [width * height, 3];
// tables as baked by kernels/megakernel.py:bake_mega_scene, sweep [p_rows,
// 16] its compact sweep table, resident in shared memory where p_rows <=
// resident_rows. Returns a cudaError_t.
int lt_shade_launch(const float* u, const float* state, float* q, float* film,
                    int n, const float* sweep, int p_rows, int resident_rows,
                    const float* prim, int p_pad, const float* mat,
                    const float* spec, const LtArgs* args,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!args_ok(args, p_rows, resident_rows) || p_pad < p_rows)
    return (int)cudaErrorInvalidValue;
  const int smem = walk::shared_bytes(p_rows, resident_rows);
  int rc = walk::allow_shared((const void*)lt_shade_kernel, smem);
  if (rc != 0) return rc;
  int grid = (n + BLOCK - 1) / BLOCK;
  lt_shade_kernel<<<grid, BLOCK, smem, stream>>>(u, state, q, film, n, sweep,
                                                 p_rows, resident_rows, prim,
                                                 p_pad, mat, spec, *args);
  return (int)cudaGetLastError();
}

// K34-LT v2: u, usp [16, n], state, q -> out [k4_rows_v2(cs), n], and the
// valid connection and light-vertex splats added to film;
// light [16, 128], spec, lcdf [520, 128]
// (kernels/lt_mega.py:bake_lt_spawn_tab); sweep as K12-LT's
int lt_finalize_spawn_launch(const float* u, const float* usp,
                             const float* state, const float* q, float* out,
                             float* film, int n, const float* sweep,
                             int p_rows,
                             int resident_rows, const float* light,
                             const float* spec, const float* lcdf,
                             const LtArgs* args, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!args_ok(args, p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  void* kargs[] = {&u,      &usp,   &state,         &q,
                   &out,    &film,  &n,             &sweep,
                   &p_rows, &resident_rows,         &light,
                   &spec,   &lcdf,  const_cast<LtArgs*>(args)};
  return launch(finalize_fn(true, args->cs), n,
                walk::shared_bytes(p_rows, resident_rows), kargs, stream);
}

// K34-LT v1: u, state, q, feed [24, n] (kernels/lt_mega.py:lt_spawn_feed)
// -> out [k4_rows(cs), n], and the valid splats added to film as v2's;
// sweep as K12-LT's
int lt_finalize_launch(const float* u, const float* state, const float* q,
                       const float* feed, float* out, float* film, int n,
                       const float* sweep, int p_rows, int resident_rows,
                       const LtArgs* args, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!args_ok(args, p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  void* kargs[] = {&u,      &state,         &q,     &feed,
                   &out,    &film,          &n,     &sweep,
                   &p_rows, &resident_rows, const_cast<LtArgs*>(args)};
  return launch(finalize_fn(false, args->cs), n,
                walk::shared_bytes(p_rows, resident_rows), kargs, stream);
}

// registers per thread and local (spill) bytes of K12-LT (which 0),
// K34-LT v2 (1) or K34-LT v1 (2) at cs camera samples
int lt_round_attrs(int which, int cs, int* regs, int* local_bytes) {
  return attrs(kernel_of(which, cs), regs, local_bytes);
}

// the shared memory of one block of K12-LT (which 0), K34-LT v2 (1) or v1
// (2) at cs camera samples walking a table of p_rows rows: its static
// bytes, the dynamic bytes the launcher asks for, and the blocks of it one
// SM holds at once
int lt_round_shared_bytes(int which, int cs, int p_rows, int resident_rows,
                          int* static_bytes, int* dynamic_bytes,
                          int* blocks_per_sm) {
  if (!walk::table_ok(p_rows, MAX_PRIMS, resident_rows))
    return (int)cudaErrorInvalidValue;
  *dynamic_bytes = walk::shared_bytes(p_rows, resident_rows);
  return walk::occupancy(kernel_of(which, cs), BLOCK, *dynamic_bytes,
                         static_bytes, blocks_per_sm);
}

// sizeof(LtArgs), for the caller's check of its mirror of the struct
int lt_args_size() { return (int)sizeof(LtArgs); }

}  // extern "C"
