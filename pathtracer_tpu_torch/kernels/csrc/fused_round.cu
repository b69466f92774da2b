// The regen path tracer's whole bounce round in one kernel.
//
// Replaces pathtracer_tpu/kernels/megakernel.py:_step_fused, the Pallas call
// of _all_kernel (_all_kernel_body + _finalize_core): closest hit, emission
// and constant-environment adds with MIS, NEE with inline shadow sweeps,
// BSDF sampling with hero-wavelength spectral MIS, Russian roulette, XYZ
// accumulation on death and the thin-lens respawn.
//
// One thread runs one lane. What bounds it on the H100: arithmetic and
// registers. A live lane does three sweeps over at most 128 prims plus the
// shading, against about 350 B of memory traffic (32 state rows and up to
// 16 uniform rows read, 40 rows written), so the kernel is compute-bound;
// with C = 4 spectral lanes the per-thread
// state is large, so the block is capped at 128 threads and spills are
// accepted for now. The design: the prim table (<= 128 prims, 6 KB) is
// staged once per block in shared memory and shared by all three sweeps;
// the Pallas one-hot MXU fetches become plain indexed loads of the other
// tables (read-only cache); a lane that is not on a surface skips all
// shading; a dead lane is a copy. Each thread touches only its own column
// of state (read) and out (write): the output is a second buffer.
#include <cuda_runtime.h>

#include "cmath.cuh"
#include "sweep.cuh"

// mirrors kernels/megakernel.py:_CArgs (all fields 4 bytes, same order);
// at namespace scope so the extern "C" entry point taking it keeps external
// linkage
struct RoundArgs {
  int c_lanes, light_samples, n_mats, n_lights, has_ggx, has_metal, has_sharp;
  int rr_enabled, only_direct, cam_blades;
  float p_env, p_env_div, q_env_div, pick_pdf, sa_scale, n_lights_f, inv_ls;
  float lam_lo, lam_span, env_rz0, env_rz1, env_rz2;
  float env_rot_inv[9];
  float max_bounces, min_bounces, width, height, wb_lo, wb_span, xyz_scale;
  float cam_origin[3], cam_u[3], cam_v[3], cam_fw[3];
  float cam_half_w, cam_half_h, cam_lens_r, cam_sharp, cam_seg, cam_half_seg;
  float cam_cos_pi_bl;
};

namespace {

using pt::V3;

constexpr int BLOCK = 128;
constexpr int MAX_DENSE_PRIMS = 128;  // 4 chunks of 32 (the fused gate)
constexpr int SPEC_RES = 512;

// state rows [NS, n] and output rows [NK4, n]
constexpr int S_O = 0, S_D = 3, S_LAM = 6, S_BETA = 10, S_RAD = 14;
constexpr int S_ACC = 18, S_DONE = 21, S_ALIVE = 22, S_BOUNCE = 23;
constexpr int S_PREV_PDF = 24, S_PIX = 25, S_PDFR = 26, NS = 32;
constexpr int O4_BOUNCE_CT = NS, O4_CAMERA_CT = NS + 1, O4_SHADOW_CT = NS + 2;
constexpr int O4_ENV_CT = NS + 3, NK4 = NS + 8;
constexpr int C_LANES = 4;

// prim_tab / mat_tab / light_tab rows
constexpr int R_NA = 11, R_NB = 14, R_NC = 17, R_MAT = 20, R_KIND = 21;
constexpr int R_AREA = 22;
constexpr int M_TYPE = 0, M_ALPHA = 1, M_METAL = 2, M_PERM = 3, M_SIDE = 4;
constexpr int M_SHARP = 5, M_RSCALE = 6;
constexpr int L_PA = 0, L_PB = 3, L_PC = 6, L_PTYPE = 9, L_AREA = 10;
constexpr int L_MAT = 11, L_MTYPE = 12, L_SIDE = 13, L_SHARP = 14;
constexpr float MAT_GGX = 1.f, MAT_DIFFUSE_LIGHT = 2.f, MAT_SHARP_LIGHT = 3.f;
constexpr float MAT_PASSTHROUGH = 4.f;

constexpr float NORMAL_OFFSET = 1e-3f;
constexpr float T_MIN = 1e-6f;  // INTERSECTION_TIME_OFFSET
constexpr float RAY_TMAX = 1e9f;
constexpr float TWO_PI2 = (float)(2.0 * 3.14159265358979323846 *
                                  3.14159265358979323846);

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float balance(float a, float b) {
  float s = a + b;
  return s > 0.0f ? a / s : 1.0f;
}

// spectral lerp position of one λ (u clipped to [0, RES-1-1e-4])
struct LamPos {
  int i0;
  float frac;
};
__device__ __forceinline__ LamPos lam_pos(float lam, const RoundArgs& a) {
  float u = (lam - a.lam_lo) / a.lam_span * (float)(SPEC_RES - 1);
  u = pt::clampf(u, 0.0f, (float)(SPEC_RES - 1 - 1e-4));
  float f0 = floorf(u);
  return LamPos{(int)f0, u - f0};
}
__device__ __forceinline__ float spec_at(const float* __restrict__ spec,
                                         int row, LamPos p) {
  const float* r = spec + (size_t)row * SPEC_RES + p.i0;
  return __ldg(r) * (1.0f - p.frac) + __ldg(r + 1) * p.frac;
}

__device__ __forceinline__ float emission_value(float spd, float mtype,
                                                float side, float sharp,
                                                float cos_t, bool has_sharp) {
  if (!(mtype == MAT_DIFFUSE_LIGHT || mtype == MAT_SHARP_LIGHT)) return 0.0f;
  float fwd = cos_t > 0.0f ? 1.0f : 0.0f;
  float rev = cos_t < 0.0f ? 1.0f : 0.0f;
  float dual = cos_t != 0.0f ? 1.0f : 0.0f;
  float gate = side == 2.0f ? dual : (side == 0.0f ? fwd : rev);
  if (has_sharp && mtype == MAT_SHARP_LIGHT) {
    return spd * (sharp + 1.0f) * powf(fabsf(cos_t), sharp) / pt::TWO_PI_F *
           gate;
  }
  return spd / pt::PI_F * gate;
}

template <int C>
__device__ __forceinline__ void bsdf_eval_lanes(
    float mtype, float alpha, float metal, float perm, const float* eta_i,
    const float* eta_o, const float* kappa, const float* refl, V3 wi, V3 wo,
    bool has_ggx, bool has_metal, float* f, float* pdf) {
  if (mtype == MAT_PASSTHROUGH) {
#pragma unroll
    for (int ci = 0; ci < C; ++ci) f[ci] = pdf[ci] = 0.0f;
    return;
  }
  if (has_ggx && mtype == MAT_GGX) {
    float al = pt::maxf(alpha, 1e-4f);
    pt::GgxGeom g = pt::ggx_geom(al, wi, wo);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      pt::ggx_lane(g, al, metal > 0.5f, perm, wi, wo,
                   pt::maxf(eta_i[ci], 1e-3f), pt::maxf(eta_o[ci], 1e-3f),
                   kappa[ci], has_metal, &f[ci], &pdf[ci]);
    }
    return;
  }
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    pt::eval_lambertian(refl[ci], wi, wo, &f[ci], &pdf[ci]);
  }
}

// a point and normal on a light prim (identity transforms)
__device__ __forceinline__ void sample_surface_light(float lp_type, V3 pa,
                                                     V3 pb, V3 pc, float u1,
                                                     float u2, V3* p, V3* n) {
  if (lp_type == (float)pt::PRIM_TRIANGLE) {
    float su = sqrtf(u1);
    float w0 = 1.0f - su, w1 = su * (1.0f - u2), w2 = su * u2;
    *p = pt::scale(pa, w0) + pt::scale(pb, w1) + pt::scale(pc, w2);
    *n = pt::normalize(pt::cross(pb - pa, pc - pa));
    return;
  }
  float phi = pt::TWO_PI_F * u2;
  if (lp_type == (float)pt::PRIM_SPHERE) {
    float z = 1.0f - 2.0f * u1;
    float r_xy = sqrtf(pt::maxf(1.0f - z * z, 0.0f));
    V3 sn = V3{r_xy * cosf(phi), r_xy * sinf(phi), z};
    *p = pa + pt::scale(sn, pb.x);
    *n = sn;
    return;
  }
  if (lp_type == (float)pt::PRIM_RECT) {
    *p = pa + pt::scale(pb, 2.0f * u1 - 1.0f) + pt::scale(pc, 2.0f * u2 - 1.0f);
    *n = pt::normalize(pt::cross(pb, pc));
    return;
  }
  float rr = sqrtf(u1) * pc.x;
  V3 t_ax, b_ax;
  pt::orthonormal_basis(pb, &t_ax, &b_ax);
  *p = pa + pt::scale(t_ax, rr * cosf(phi)) + pt::scale(b_ax, rr * sinf(phi));
  *n = pb;
}

template <int C>
__global__ void __launch_bounds__(BLOCK) fused_round_kernel(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ dense,
    int p_dense, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs a) {
  __shared__ __align__(16) float prims[MAX_DENSE_PRIMS * pt::PRIM_FLOATS];
  pt::stage_prims(dense, 0, p_dense, prims);
  __syncthreads();
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  auto S = [&](int r) { return state[r * N + i]; };
  auto O = [&](int r, float v) { out[r * N + i] = v; };
  auto U = [&](int r) { return u[r * N + i]; };

  if (!(S(S_ALIVE) > 0.5f)) {  // a dead lane passes through
    for (int r = 0; r < NS; ++r) O(r, S(r));
    for (int r = NS; r < NK4; ++r) O(r, 0.0f);
    return;
  }
  const int ls = a.light_samples;
  const bool has_ggx = a.has_ggx, has_metal = a.has_metal;
  const bool has_sharp = a.has_sharp;
  V3 o{S(S_O), S(S_O + 1), S(S_O + 2)};
  V3 d{S(S_D), S(S_D + 1), S(S_D + 2)};
  float lam[C], beta[C], rad[C];
  LamPos lp[C];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    lam[ci] = S(S_LAM + ci);
    beta[ci] = S(S_BETA + ci);
    rad[ci] = S(S_RAD + ci);
    lp[ci] = lam_pos(lam[ci], a);
  }
  float done = S(S_DONE);
  const float bounce_ct = S(S_BOUNCE);
  const float prev_pdf = S(S_PREV_PDF);
  float s_mis = 1.0f;
  if (C > 1) {
    float sum = S(S_PDFR);
#pragma unroll
    for (int ci = 1; ci < C; ++ci) sum = sum + S(S_PDFR + ci);
    s_mis = (float)C / pt::maxf(sum, 1e-30f);
  }
  const int env_row = 5 * a.n_mats;

  // ---- closest hit straight off the live ray state
  float t_hit = INFINITY;
  int pid = -1;
  pt::sweep_closest_dev(prims, p_dense, 0, o, d, T_MIN, RAY_TMAX, &t_hit,
                        &pid);
  const bool hit = t_hit < INFINITY;
  const float kind = hit ? __ldg(prim + R_KIND * p_pad + pid) : 0.0f;
  const bool at_surface = hit && kind != 2.0f;
  const bool nee_enabled = ls > 0;

  // ---- escape into the constant environment, with MIS against NEE
  if (!hit) {
    float w_env = 1.0f;
    if (nee_enabled && a.p_env > 0.0f) {
      float dz = a.env_rz0 * d.x + a.env_rz1 * d.y + a.env_rz2 * d.z;
      // sqrt identity instead of arccos: sin(acos(z)) = sqrt(1 - z^2)
      float jac = TWO_PI2 * sqrtf(pt::maxf(1.0f - dz * dz, 0.0f)) + 0.001f;
      float env_nee_pdf = (1.0f / jac) * a.p_env;
      if (bounce_ct > 0.5f && env_nee_pdf + prev_pdf > 0.0f)
        w_env = balance(prev_pdf, pt::maxf(env_nee_pdf, 0.0f));
    }
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      float env_e = spec_at(spec, env_row, lp[ci]);
      rad[ci] = rad[ci] + beta[ci] * s_mis * env_e * w_env;
    }
  }

  // ---- surface interaction: emission, NEE, BSDF sample, RR
  bool cp = false;
  V3 o_new{0.f, 0.f, 0.f}, d_new{0.f, 0.f, 0.f};
  float f_pdf = 0.0f, shadow_ct = 0.0f;
  float beta_next[C], pscale[C];
  if (at_surface) {
    auto A = [&](int r) { return __ldg(prim + r * p_pad + pid); };
    V3 pa{A(2), A(3), A(4)}, pb{A(5), A(6), A(7)}, pc{A(8), A(9), A(10)};
    const float ptype = A(0);
    const float mat_idf = A(R_MAT), area = A(R_AREA);
    const int mid = (int)mat_idf;
    V3 point = o + pt::scale(d, t_hit);
    V3 normal, gn;
    if (ptype == (float)pt::PRIM_TRIANGLE) {
      V3 na{A(R_NA), A(R_NA + 1), A(R_NA + 2)};
      V3 nb{A(R_NB), A(R_NB + 1), A(R_NB + 2)};
      V3 nc{A(R_NC), A(R_NC + 1), A(R_NC + 2)};
      V3 e1 = pb - pa, e2 = pc - pa;
      gn = pt::normalize(pt::cross(e1, e2));
      V3 pvec = pt::cross(d, e2);
      float det = pt::dot(e1, pvec);
      float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
      V3 tvec = o - pa;
      float bu = pt::dot(tvec, pvec) * inv_det;
      float bv = pt::dot(d, pt::cross(tvec, e1)) * inv_det;
      normal = pt::normalize(pt::scale(na, 1.0f - bu - bv) +
                             pt::scale(nb, bu) + pt::scale(nc, bv));
    } else if (ptype == (float)pt::PRIM_SPHERE) {
      gn = normal = pt::normalize(point - pa);
    } else if (ptype == (float)pt::PRIM_RECT) {
      gn = normal = pt::normalize(pt::cross(pb, pc));
    } else {
      gn = normal = pb;
    }
    auto M = [&](int r) { return __ldg(mat + r * 128 + mid); };
    const float mtype = M(M_TYPE);
    V3 wi_world = -d;
    // emission at a light hit, with MIS against NEE
    if (a.n_lights > 0 && kind == 1.0f) {
      float cos_at_light = pt::dot(gn, wi_world);
      float ca = fabsf(cos_at_light) * area;
      float hyp = a.pick_pdf * t_hit * t_hit / pt::maxf(ca, 1e-30f);
      hyp = ca > 0.0f ? hyp : 0.0f;
      float w_light = 1.0f;
      if (bounce_ct > 0.5f && nee_enabled && prev_pdf + hyp > 0.0f)
        w_light = balance(prev_pdf, pt::maxf(hyp, 0.0f));
      const float side = M(M_SIDE), sharp = M(M_SHARP);
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        float spd = spec_at(spec, 5 * mid + 4, lp[ci]);
        float le = emission_value(spd, mtype, side, sharp, cos_at_light,
                                  has_sharp);
        rad[ci] = rad[ci] + beta[ci] * s_mis * le * w_light;
      }
    }
    V3 tgt, btg;
    pt::orthonormal_basis(normal, &tgt, &btg);
    V3 wi_local = pt::to_local(tgt, btg, normal, wi_world);
    const float alpha = M(M_ALPHA), metal = M(M_METAL), perm = M(M_PERM);
    const float rscale = M(M_RSCALE);
    float eta_i[C], eta_o[C], kappa[C], refl[C];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      eta_i[ci] = spec_at(spec, 5 * mid + 0, lp[ci]);
      eta_o[ci] = spec_at(spec, 5 * mid + 1, lp[ci]);
      kappa[ci] = spec_at(spec, 5 * mid + 2, lp[ci]);
      refl[ci] = rscale * spec_at(spec, 5 * mid + 3, lp[ci]);
    }

    // ---- NEE with immediate shadow resolution
    for (int si = 0; si < ls; ++si) {
      const float u_pick = U(3 * si), u1 = U(3 * si + 1), u2 = U(3 * si + 2);
      bool chose_env = false;
      float u_pick2 = u_pick;
      if (a.p_env > 0.0f) {
        chose_env = u_pick < a.p_env;
        u_pick2 = chose_env ? u_pick / a.p_env_div
                            : (u_pick - a.p_env) / a.q_env_div;
        u_pick2 = pt::clampf(u_pick2, 0.0f, (float)(1.0 - 1e-7));
      }
      float li_f = pt::minf(floorf(u_pick2 * a.n_lights_f), a.n_lights_f - 1.0f);
      const int li = (int)li_f;
      auto L = [&](int r) { return __ldg(light + r * 128 + li); };
      V3 lpa{L(L_PA), L(L_PA + 1), L(L_PA + 2)};
      V3 lpb{L(L_PB), L(L_PB + 1), L(L_PB + 2)};
      V3 lpc{L(L_PC), L(L_PC + 1), L(L_PC + 2)};
      V3 lpt, ln;
      sample_surface_light(L(L_PTYPE), lpa, lpb, lpc, u1, u2, &lpt, &ln);
      float area_pdf = 1.0f / pt::maxf(L(L_AREA), 1e-20f);
      V3 to_l = lpt - point;
      float dist2 = pt::maxf(pt::length_squared(to_l), 1e-12f);
      float dist = sqrtf(dist2);
      V3 dir_l = pt::scale(to_l, 1.0f / dist);
      float cos_l = pt::dot(ln, -dir_l);
      float sa_pdf_light =
          a.sa_scale * area_pdf *
          (fabsf(cos_l) > 0.0f ? dist2 / pt::maxf(fabsf(cos_l), 1e-30f) : 0.0f);
      V3 nee_dir = dir_l;
      float nee_pdf = sa_pdf_light;
      float nee_tmax = dist * 0.99f;
      if (a.p_env > 0.0f && chose_env) {
        V3 e = pt::uv_to_direction(u1, u2);
        const float* ri = a.env_rot_inv;
        nee_dir = V3{ri[0] * e.x + ri[1] * e.y + ri[2] * e.z,
                     ri[3] * e.x + ri[4] * e.y + ri[5] * e.z,
                     ri[6] * e.x + ri[7] * e.y + ri[8] * e.z};
        float jac_s = TWO_PI2 * sinf(pt::PI_F * u2) + 0.001f;
        nee_pdf = (1.0f / jac_s) * a.p_env;
        nee_tmax = RAY_TMAX;
      }
      V3 wo_local = pt::to_local(tgt, btg, normal, nee_dir);
      float nee_f[C], nee_p[C], le[C];
      bsdf_eval_lanes<C>(mtype, alpha, metal, perm, eta_i, eta_o, kappa, refl,
                         wi_local, wo_local, has_ggx, has_metal, nee_f, nee_p);
      const float l_mat = L(L_MAT), l_mtype = L(L_MTYPE);
      const float l_side = L(L_SIDE), l_sharp = L(L_SHARP);
      float max_le = 0.0f, max_thr = 0.0f;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        if (chose_env) {
          le[ci] = spec_at(spec, env_row, lp[ci]);
        } else {
          float spd_l = spec_at(spec, 5 * (int)l_mat + 4, lp[ci]);
          le[ci] = emission_value(spd_l, l_mtype, l_side, l_sharp, cos_l,
                                  has_sharp);
        }
        nee_f[ci] = nee_f[ci] * fabsf(wo_local.z);  // throughput
        max_le = max_nan(max_le, le[ci]);
        max_thr = max_nan(max_thr, nee_f[ci]);
      }
      bool worth = max_le > 0.0f && nee_pdf > 1e-12f && max_thr > 0.0f;
      if (!worth) continue;
      shadow_ct += 1.0f;
      float w_nee = balance(nee_pdf, pt::maxf(nee_p[0], 0.0f));
      V3 so = point + pt::scale(gn, NORMAL_OFFSET *
                                        pt::signf(pt::dot(gn, nee_dir) + 1e-9f));
      if (pt::sweep_any_dev(prims, p_dense, so, nee_dir, T_MIN, nee_tmax))
        continue;
      float inv_pdf = 1.0f / pt::maxf(nee_pdf, 1e-12f);
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        rad[ci] = rad[ci] + beta[ci] * s_mis * nee_f[ci] * le[ci] * w_nee *
                                inv_pdf * a.inv_ls;
      }
    }

    // ---- BSDF sample + HWSS pdf ratios
    const float ub0 = U(3 * ls), ub1 = U(3 * ls + 1), ub2 = U(3 * ls + 2);
    const bool is_ggx = has_ggx && mtype == MAT_GGX;
    V3 wo_s;
    float ratio_hero;
    if (is_ggx) {
      wo_s = pt::sample_ggx_dir(pt::maxf(alpha, 1e-4f),
                                pt::maxf(eta_i[0], 1e-3f),
                                pt::maxf(eta_o[0], 1e-3f), kappa[0],
                                metal > 0.5f, perm, wi_local, ub0, ub1, ub2,
                                has_metal, &ratio_hero);
    } else {
      float f_l, p_l;
      wo_s = pt::sample_lambertian(refl[0], wi_local, ub0, ub1, &f_l, &p_l);
      ratio_hero = pt::minf(refl[0], 1.0f);
    }
    if (mtype == MAT_PASSTHROUGH) ratio_hero = 0.0f;
    float f_l[C], p_l[C];
    bsdf_eval_lanes<C>(mtype, alpha, metal, perm, eta_i, eta_o, kappa, refl,
                       wi_local, wo_s, has_ggx, has_metal, f_l, p_l);
    // the sampled lobe's pdf is the hero lane's eval pdf at wo_s (same
    // inputs as the sampler's own eval; 0 for a passthrough)
    f_pdf = p_l[0];
    const bool sample_ok0 = f_pdf > 1e-12f;
    const bool hero_dead = f_l[0] <= 0.0f && sample_ok0;
    const float inv_hero = f_l[0] > 0.0f ? 1.0f / f_l[0] : 0.0f;
    const float inv_fpdf = sample_ok0 ? 1.0f / pt::maxf(f_pdf, 1e-12f) : 0.0f;
    float ratios[C];
    ratios[0] = ratio_hero;
#pragma unroll
    for (int ci = 1; ci < C; ++ci) {
      ratios[ci] = hero_dead ? f_l[ci] * fabsf(wo_s.z) * inv_fpdf
                             : ratio_hero * f_l[ci] * inv_hero;
    }
    d_new = pt::normalize(pt::to_world(tgt, btg, normal, wo_s));
    o_new = point + pt::scale(gn, NORMAL_OFFSET * pt::signf(pt::dot(gn, d_new)));
    const float inv_p0 = p_l[0] > 0.0f ? 1.0f / p_l[0] : 0.0f;
    pscale[0] = 1.0f;
#pragma unroll
    for (int ci = 1; ci < C; ++ci) pscale[ci] = p_l[ci] * inv_p0;

    // ---- Russian roulette + continuation
    float ratio_best = ratios[0];
#pragma unroll
    for (int ci = 1; ci < C; ++ci) ratio_best = max_nan(ratio_best, ratios[ci]);
    const bool sample_ok = sample_ok0 && ratio_best > 0.0f;
    float p_cont = 1.0f;
    if (a.rr_enabled && bounce_ct >= a.min_bounces)
      p_cont = pt::clampf(ratio_best, 0.05f, 1.0f);
    const bool survive = U(3 * ls + 3) < p_cont;
    const float inv_pc = 1.0f / pt::maxf(p_cont, 1e-6f);
    bool finite_ok = true;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      beta_next[ci] = beta[ci] * (sample_ok ? ratios[ci] * inv_pc : 0.0f);
      finite_ok = finite_ok && isfinite(beta_next[ci]);
    }
    cp = sample_ok && survive && !(bounce_ct + 1.0f >= a.max_bounces) &&
         finite_ok;
    if (a.only_direct && bounce_ct >= 1.0f) cp = false;
  }

  // ---- death -> XYZ accumulate, respawn at the lane's owning pixel
  const bool died = !cp;
  float acc[3] = {S(S_ACC), S(S_ACC + 1), S(S_ACC + 2)};
  bool hw = false;
  if (died) {
    float xyz[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      float e = rad[ci] * a.xyz_scale;
      xyz[0] = xyz[0] + e * pt::x_bar(lam[ci]);
      xyz[1] = xyz[1] + e * pt::y_bar(lam[ci]);
      xyz[2] = xyz[2] + e * pt::z_bar(lam[ci]);
    }
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + xyz[k];
    done = done - 1.0f;
    hw = done > 0.5f;
  }
  V3 o_out = o, d_out = d;
  float lam_out[C];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) lam_out[ci] = lam[ci];
  if (cp) {
    o_out = o_new;
    d_out = d_new;
  } else if (hw) {
    const float r0 = U(3 * ls + 4), r1 = U(3 * ls + 5), r2 = U(3 * ls + 6);
    const float r3 = U(3 * ls + 7), r4 = U(3 * ls + 8);
    const float pix = S(S_PIX);
    const float px = pix - floorf(pix / a.width) * a.width;
    const float py = floorf(pix / a.width);
    const float film_u = (px + r0) / a.width;
    const float film_v = (py + r1) / a.height;
    const float r_d = sqrtf(r2);
    const float phi_d = pt::TWO_PI_F * r3;
    const float dx_l = r_d * cosf(phi_d), dy_l = r_d * sinf(phi_d);
    float r_scale = 1.0f;
    if (a.cam_blades >= 3) {
      float phi_a = atan2f(dy_l, dx_l);
      float a_ = pt::fmod_floor(phi_a, a.cam_seg) - a.cam_half_seg;
      float poly = a.cam_cos_pi_bl / cosf(a_);
      r_scale = (1.0f - a.cam_sharp) + a.cam_sharp * poly;
    }
    const float lx = dx_l * r_scale * a.cam_lens_r;
    const float ly = dy_l * r_scale * a.cam_lens_r;
    const float* co = a.cam_origin;
    const float* cu = a.cam_u;
    const float* cv = a.cam_v;
    V3 o_s{co[0] + lx * cu[0] + ly * cv[0], co[1] + lx * cu[1] + ly * cv[1],
           co[2] + lx * cu[2] + ly * cv[2]};
    const float fpx = (film_u * 2.0f - 1.0f) * a.cam_half_w;
    const float fpy = (1.0f - film_v * 2.0f) * a.cam_half_h;
    V3 focal{co[0] + a.cam_fw[0] + fpx * cu[0] + fpy * cv[0],
             co[1] + a.cam_fw[1] + fpx * cu[1] + fpy * cv[1],
             co[2] + a.cam_fw[2] + fpx * cu[2] + fpy * cv[2]};
    o_out = o_s;
    d_out = pt::normalize(focal - o_s);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      lam_out[ci] = a.wb_lo +
                    pt::fmod_floor(r4 + (float)ci / (float)C, 1.0f) * a.wb_span;
    }
  }

  // ---- write-out
  O(S_O, o_out.x);
  O(S_O + 1, o_out.y);
  O(S_O + 2, o_out.z);
  O(S_D, d_out.x);
  O(S_D + 1, d_out.y);
  O(S_D + 2, d_out.z);
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    O(S_LAM + ci, lam_out[ci]);
    O(S_BETA + ci, cp ? beta_next[ci] : (hw ? 1.0f : beta[ci]));
    O(S_RAD + ci, died ? 0.0f : rad[ci]);
    float pr = S(S_PDFR + ci);
    O(S_PDFR + ci, cp ? pr * pscale[ci] : (hw ? 1.0f : pr));
  }
  for (int ci = C; ci < C_LANES; ++ci) {
    O(S_LAM + ci, S(S_LAM + ci));
    O(S_BETA + ci, S(S_BETA + ci));
    O(S_RAD + ci, S(S_RAD + ci));
    O(S_PDFR + ci, S(S_PDFR + ci));
  }
  O(S_ACC, acc[0]);
  O(S_ACC + 1, acc[1]);
  O(S_ACC + 2, acc[2]);
  O(S_DONE, done);
  O(S_ALIVE, (cp || hw) ? 1.0f : 0.0f);
  O(S_BOUNCE, cp ? bounce_ct + 1.0f : (hw ? 0.0f : bounce_ct));
  O(S_PREV_PDF, cp ? f_pdf : (hw ? 0.0f : prev_pdf));
  O(S_PIX, S(S_PIX));
  for (int r = S_PDFR + C_LANES; r < NS; ++r) O(r, S(r));
  O(O4_BOUNCE_CT, cp ? 1.0f : 0.0f);
  O(O4_CAMERA_CT, hw ? 1.0f : 0.0f);
  O(O4_SHADOW_CT, shadow_ct);
  O(O4_ENV_CT, hit ? 0.0f : 1.0f);
  for (int r = O4_ENV_CT + 1; r < NK4; ++r) O(r, 0.0f);
}

template <int C>
int launch(const float* u, const float* state, float* out, int n,
           const float* dense, int p_dense, const float* prim, int p_pad,
           const float* mat, const float* light, const float* spec,
           const RoundArgs& a, cudaStream_t stream) {
  int grid = (n + BLOCK - 1) / BLOCK;
  fused_round_kernel<C><<<grid, BLOCK, 0, stream>>>(
      u, state, out, n, dense, p_dense, prim, p_pad, mat, light, spec, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u [nu, n], state [32, n] -> out [40, n]; tables as baked by
// kernels/megakernel.py:build_mega_scene. Returns a cudaError_t.
int fused_round_launch(const float* u, int nu, const float* state, float* out,
                       int n, const float* dense, int p_dense,
                       const float* prim, int p_pad, const float* mat,
                       const float* light, const float* spec, int spec_rows,
                       const RoundArgs* args, cudaStream_t stream) {
  (void)nu;
  (void)spec_rows;
  if (n <= 0) return 0;
  if (p_dense > MAX_DENSE_PRIMS) return (int)cudaErrorInvalidValue;
  if (args->c_lanes == 1)
    return launch<1>(u, state, out, n, dense, p_dense, prim, p_pad, mat, light,
                     spec, *args, stream);
  if (args->c_lanes == 4)
    return launch<4>(u, state, out, n, dense, p_dense, prim, p_pad, mat, light,
                     spec, *args, stream);
  return (int)cudaErrorInvalidValue;
}

// sizeof(RoundArgs), for the caller's check of its mirror of the struct
int fused_round_args_size() { return (int)sizeof(RoundArgs); }

// registers per thread and local (spill) bytes of the C-lane kernel
int fused_round_attrs(int c, int* regs, int* local_bytes) {
  cudaFuncAttributes fa;
  cudaError_t rc = c == 1 ? cudaFuncGetAttributes(&fa, fused_round_kernel<1>)
                          : cudaFuncGetAttributes(&fa, fused_round_kernel<4>);
  if (rc != cudaSuccess) return (int)rc;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

}  // extern "C"
