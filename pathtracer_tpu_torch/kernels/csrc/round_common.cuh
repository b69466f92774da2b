// Device code of the bounce round, shared by the fused round
// (fused_round.cu) and the two-program round (two_prog_round.cu: K12 and
// K34); the light tracer's round (lt_round.cu) takes the hit geometry, the
// spectral lerp, the emission, the light-surface sample and the BSDF eval
// (in Importance transport: bsdf_eval_lanes<C, false>) from it.
//
// It is the per-lane body of pathtracer_tpu/kernels/megakernel.py's
// _all_kernel_body, _shade_body and _finalize_core: hit attributes,
// emission and environment adds with MIS, the NEE light sample, BSDF eval
// and sample with the HWSS pdf ratios, Russian roulette, XYZ accumulation on
// death, the thin-lens respawn and the state write-out, with the medium
// branch of medium-aware transport (the free flight against the surface
// hit, the Beer-Lambert lane weights, the phase function at a scatter, the
// tracked medium stack) as the template parameter MEDIUM of the functions
// it touches, so the surface instantiations compile without it. The Pallas
// one-hot MXU fetches (_prim_attr_fetch, _sel_rows, the light rows) are indexed
// loads through the read-only cache, and _spectral_fetch is an f32 lerp of
// each curve row at the lane's λ. The plain twins are
// kernels/megakernel.py:_shade and _finalize_core, in the same operation
// order (the library is built without FMA contraction).
#pragma once

#include <cuda_runtime.h>

#include "cmath.cuh"
#include "sweep.cuh"

// mirrors kernels/megakernel.py:_CArgs (all fields 4 bytes, same order);
// at namespace scope so the extern "C" entry points taking it keep external
// linkage
struct RoundArgs {
  int c_lanes, light_samples, env_kind, n_mats, n_lights, has_ggx, has_metal;
  int has_sharp, rr_enabled, only_direct, cam_blades, medium;
  float p_env, p_env_div, q_env_div, pick_pdf, sa_scale, n_lights_f, inv_ls;
  float lam_lo, lam_span, env_rz0, env_rz1, env_rz2;
  float env_rot_inv[9];
  float max_bounces, min_bounces, width, height, wb_lo, wb_span, xyz_scale;
  float cam_origin[3], cam_u[3], cam_v[3], cam_fw[3];
  float cam_half_w, cam_half_h, cam_lens_r, cam_sharp, cam_seg, cam_half_seg;
  float cam_cos_pi_bl;
  float env_tr_dist;  // 2 x the scene bound's radius (environment NEE's Tr)
};

namespace rc {

using pt::V3;

constexpr int SPEC_RES = 512;
constexpr int C_LANES = 4;
constexpr int ENV_CONSTANT = 0;

// state rows [NS, n] and round output rows [NK4, n]
constexpr int S_O = 0, S_D = 3, S_LAM = 6, S_BETA = 10, S_RAD = 14;
constexpr int S_ACC = 18, S_DONE = 21, S_ALIVE = 22, S_BOUNCE = 23;
constexpr int S_PREV_PDF = 24, S_PIX = 25, S_PDFR = 26, NS = 32;
constexpr int S_MSTK0 = 30, S_MSTK1 = 31;  // the packed medium stack
constexpr int O4_BOUNCE_CT = NS, O4_CAMERA_CT = NS + 1, O4_SHADOW_CT = NS + 2;
constexpr int O4_ENV_CT = NS + 3, NK4 = NS + 8;

// K2 rows [k2_rows(ls), n] (kernels/megakernel.py O_*)
constexpr int O_RAD = 0, O_AT_SURF = 4, O_ENV_CT = 5, O_SHADOW_CT = 6;
constexpr int O_FPDF = 7, O_SAMPLE_OK = 8, O_RATIO = 9, O_ONEW = 13;
constexpr int O_DNEW = 16, O_PSCALE = 19, O_NEE = 30, NEE_ROWS = 12;
constexpr int O_SCAT = 23, O_MEDW = 24, O_MSTK = 28;  // the medium rows

// prim_tab / mat_tab / light_tab rows
constexpr int R_NA = 11, R_NB = 14, R_NC = 17, R_MAT = 20, R_KIND = 21;
constexpr int R_AREA = 22;
constexpr int M_TYPE = 0, M_ALPHA = 1, M_METAL = 2, M_PERM = 3, M_SIDE = 4;
constexpr int M_SHARP = 5, M_RSCALE = 6, M_TEXF = 7, M_INNER = 8, M_OUTER = 9;
constexpr int L_PA = 0, L_PB = 3, L_PC = 6, L_PTYPE = 9, L_AREA = 10;
constexpr int L_MAT = 11, L_MTYPE = 12, L_SIDE = 13, L_SHARP = 14;
constexpr float MAT_GGX = 1.f, MAT_DIFFUSE_LIGHT = 2.f, MAT_SHARP_LIGHT = 3.f;
constexpr float MAT_PASSTHROUGH = 4.f;

constexpr float NORMAL_OFFSET = 1e-3f;
constexpr float T_MIN = 1e-6f;  // INTERSECTION_TIME_OFFSET
constexpr float RAY_TMAX = 1e9f;
constexpr float TWO_PI2 = (float)(2.0 * 3.14159265358979323846 *
                                  3.14159265358979323846);
constexpr float FOUR_PI = (float)(4.0 * 3.14159265358979323846);
constexpr float RAYLEIGH_NORM = (float)(3.0 / (16.0 * 3.14159265358979323846));

__device__ __forceinline__ int k2_rows(int ls) {
  return (O_NEE + NEE_ROWS * ls + 7) / 8 * 8;
}

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

// kRadiance: the transport mode of pt::ggx_lane (false: Importance)
template <int C, bool kRadiance = true>
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
      pt::ggx_lane<kRadiance>(g, al, metal > 0.5f, perm, wi, wo,
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

// ---------------------------------------------------------------- the lane

// what a round reads of one lane's state
template <int C>
struct Lane {
  V3 o, d;
  float lam[C], beta[C], rad[C];
  LamPos lp[C];
  float done, bounce_ct, prev_pdf, s_mis;
};

template <int C>
__device__ __forceinline__ void load_lane(const float* __restrict__ state,
                                          size_t N, int i, const RoundArgs& a,
                                          Lane<C>& L) {
  auto S = [&](int r) { return state[r * N + i]; };
  L.o = V3{S(S_O), S(S_O + 1), S(S_O + 2)};
  L.d = V3{S(S_D), S(S_D + 1), S(S_D + 2)};
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    L.lam[ci] = S(S_LAM + ci);
    L.beta[ci] = S(S_BETA + ci);
    L.rad[ci] = S(S_RAD + ci);
    L.lp[ci] = lam_pos(L.lam[ci], a);
  }
  L.done = S(S_DONE);
  L.bounce_ct = S(S_BOUNCE);
  L.prev_pdf = S(S_PREV_PDF);
  L.s_mis = 1.0f;
  if (C > 1) {  // hero-wavelength spectral MIS weight
    float sum = S(S_PDFR);
#pragma unroll
    for (int ci = 1; ci < C; ++ci) sum = sum + S(S_PDFR + ci);
    L.s_mis = (float)C / pt::maxf(sum, 1e-30f);
  }
}

// escape into the environment, with MIS against NEE: the constant
// environment in-kernel (arccos-free Jacobian), Sun and HDR from the
// environment-feed rows ef (C emission rows, then the escape pdf)
template <int C>
__device__ __forceinline__ void escape_add(Lane<C>& L,
                                           const float* __restrict__ spec,
                                           const float* __restrict__ ef,
                                           size_t N, int i,
                                           const RoundArgs& a) {
  const bool fed = a.env_kind != ENV_CONSTANT;
  float w_env = 1.0f;
  if (a.light_samples > 0 && a.p_env > 0.0f) {
    float env_nee_pdf;
    if (fed) {
      env_nee_pdf = ef[C * N + i] * a.p_env;
    } else {
      const V3 d = L.d;
      float dz = a.env_rz0 * d.x + a.env_rz1 * d.y + a.env_rz2 * d.z;
      // sqrt identity instead of arccos: sin(acos(z)) = sqrt(1 - z^2)
      float jac = TWO_PI2 * sqrtf(pt::maxf(1.0f - dz * dz, 0.0f)) + 0.001f;
      env_nee_pdf = (1.0f / jac) * a.p_env;
    }
    if (L.bounce_ct > 0.5f && env_nee_pdf + L.prev_pdf > 0.0f)
      w_env = balance(L.prev_pdf, pt::maxf(env_nee_pdf, 0.0f));
  }
  const int env_row = 5 * a.n_mats;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    float env_e = fed ? ef[ci * N + i] : spec_at(spec, env_row, L.lp[ci]);
    L.rad[ci] = L.rad[ci] + L.beta[ci] * L.s_mis * env_e * w_env;
  }
}

// ------------------------------------------------------------- the surface

template <int C>
struct Surface {
  V3 point, normal, gn, tgt, btg, wi_local;
  int mid;  // material id
  float mtype, alpha, metal, perm;
  float eta_i[C], eta_o[C], kappa[C], refl[C];
};

// hit attributes of prim `pid` (an indexed load of its prim_tab column),
// the emission add at a light hit with MIS against NEE, the shading frame
// and the material's parameters and spectra at the lane's λs. A lambertian
// flagged M_TEXF takes its reflectance from the texture-feed rows tf (C
// rows; null outside the texture-feed round), any other from its baked row
// the hit point, shading normal and geometric normal of a ray (o, d) on
// prim `pid` at t_hit (an indexed load of its prim_tab column)
__device__ __forceinline__ void hit_geometry(const float* __restrict__ prim,
                                             int p_pad, int pid, V3 o, V3 d,
                                             float t_hit, V3* point,
                                             V3* normal, V3* gn) {
  auto A = [&](int r) { return __ldg(prim + r * p_pad + pid); };
  V3 pa{A(2), A(3), A(4)}, pb{A(5), A(6), A(7)}, pc{A(8), A(9), A(10)};
  const float ptype = A(0);
  *point = o + pt::scale(d, t_hit);
  if (ptype == (float)pt::PRIM_TRIANGLE) {
    V3 na{A(R_NA), A(R_NA + 1), A(R_NA + 2)};
    V3 nb{A(R_NB), A(R_NB + 1), A(R_NB + 2)};
    V3 nc{A(R_NC), A(R_NC + 1), A(R_NC + 2)};
    V3 e1 = pb - pa, e2 = pc - pa;
    *gn = pt::normalize(pt::cross(e1, e2));
    V3 pvec = pt::cross(d, e2);
    float det = pt::dot(e1, pvec);
    float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
    V3 tvec = o - pa;
    float bu = pt::dot(tvec, pvec) * inv_det;
    float bv = pt::dot(d, pt::cross(tvec, e1)) * inv_det;
    *normal = pt::normalize(pt::scale(na, 1.0f - bu - bv) +
                            pt::scale(nb, bu) + pt::scale(nc, bv));
  } else if (ptype == (float)pt::PRIM_SPHERE) {
    *gn = *normal = pt::normalize(*point - pa);
  } else if (ptype == (float)pt::PRIM_RECT) {
    *gn = *normal = pt::normalize(pt::cross(pb, pc));
  } else {
    *gn = *normal = pb;
  }
}

template <int C>
__device__ __forceinline__ void surface_at(
    Lane<C>& L, const float* __restrict__ prim, int p_pad, int pid,
    float t_hit, float kind, const float* __restrict__ mat,
    const float* __restrict__ spec, const float* __restrict__ tf, size_t N,
    int i, const RoundArgs& a, Surface<C>& S) {
  const V3 d = L.d;
  const float area = __ldg(prim + R_AREA * p_pad + pid);
  const int mid = (int)__ldg(prim + R_MAT * p_pad + pid);
  hit_geometry(prim, p_pad, pid, L.o, d, t_hit, &S.point, &S.normal, &S.gn);
  auto M = [&](int r) { return __ldg(mat + r * 128 + mid); };
  S.mid = mid;
  S.mtype = M(M_TYPE);
  V3 wi_world = -d;
  if (a.n_lights > 0 && kind == 1.0f) {
    float cos_at_light = pt::dot(S.gn, wi_world);
    float ca = fabsf(cos_at_light) * area;
    float hyp = a.pick_pdf * t_hit * t_hit / pt::maxf(ca, 1e-30f);
    hyp = ca > 0.0f ? hyp : 0.0f;
    float w_light = 1.0f;
    if (L.bounce_ct > 0.5f && a.light_samples > 0 && L.prev_pdf + hyp > 0.0f)
      w_light = balance(L.prev_pdf, pt::maxf(hyp, 0.0f));
    const float side = M(M_SIDE), sharp = M(M_SHARP);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      float spd = spec_at(spec, 5 * mid + 4, L.lp[ci]);
      float le = emission_value(spd, S.mtype, side, sharp, cos_at_light,
                                a.has_sharp);
      L.rad[ci] = L.rad[ci] + L.beta[ci] * L.s_mis * le * w_light;
    }
  }
  pt::orthonormal_basis(S.normal, &S.tgt, &S.btg);
  S.wi_local = pt::to_local(S.tgt, S.btg, S.normal, wi_world);
  S.alpha = M(M_ALPHA);
  S.metal = M(M_METAL);
  S.perm = M(M_PERM);
  const float rscale = M(M_RSCALE);
  const bool fed = tf != nullptr && M(M_TEXF) > 0.5f;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    S.eta_i[ci] = spec_at(spec, 5 * mid + 0, L.lp[ci]);
    S.eta_o[ci] = spec_at(spec, 5 * mid + 1, L.lp[ci]);
    S.kappa[ci] = spec_at(spec, 5 * mid + 2, L.lp[ci]);
    S.refl[ci] = fed ? tf[ci * N + i]
                     : rscale * spec_at(spec, 5 * mid + 3, L.lp[ci]);
  }
}

// ---------------------------------------------------------------- the media

// what the medium branch keeps of one lane: whether its free flight ended
// before the surface (a scatter at scat_p), and of the medium feed the σ_t
// sums, the scatterer's g per λ and kind, and the lane weights
template <int C>
struct MedLane {
  bool scattered, in_med, is_ray;
  V3 scat_p;
  float sig_t[C], g[C], medw[C];
};

// medium-feed rows (kernels/megakernel.py:mf_idx)
template <int C>
struct Mf {
  static constexpr int FLIGHT = 0, SIGT = 1, SIGS = 1 + C, SSH = 1 + 2 * C;
  static constexpr int WO = SSH + 1, PHPDF = WO + 3, PHS = PHPDF + 1;
  static constexpr int G = PHS + C, ISRAY = G + C, INMED = ISRAY + 1;
};

// the free flight against the surface hit: scatter or not, the travelled
// distance, and the hero-divide-out Beer-Lambert lane weights, applied to
// the throughput before any radiance add
template <int C>
__device__ __forceinline__ void med_flight(Lane<C>& L,
                                           const float* __restrict__ mf,
                                           size_t N, int i, bool hit,
                                           float t_hit, MedLane<C>& M) {
  auto F = [&](int r) { return mf[r * N + i]; };
  const float flight = F(Mf<C>::FLIGHT), ss_hero = F(Mf<C>::SSH);
  M.in_med = F(Mf<C>::INMED) > 0.5f;
  M.is_ray = F(Mf<C>::ISRAY) > 0.5f;
  const float surf_t = hit ? t_hit : RAY_TMAX;
  M.scattered = flight < surf_t;
  const float travel = pt::minf(pt::minf(flight, surf_t), 1e8f);
  const float inv_ssh = ss_hero > 0.0f ? 1.0f / ss_hero : 0.0f;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    M.sig_t[ci] = F(Mf<C>::SIGT + ci);
    M.g[ci] = F(Mf<C>::G + ci);
    const float w_exp = expf(-(M.sig_t[ci] - ss_hero) * travel);
    float lane_w =
        M.scattered ? F(Mf<C>::SIGS + ci) * inv_ssh * w_exp : w_exp;
    if (!M.in_med) lane_w = 1.0f;
    M.medw[ci] = lane_w;
    L.beta[ci] = L.beta[ci] * lane_w;
  }
  M.scat_p = L.o + pt::scale(L.d, travel);
}

// the closed-form HG or Rayleigh phase toward a direction at cosine cos_sc
// to the ray, with the scatterer's fed g
__device__ __forceinline__ float phase_toward(float g, bool is_ray,
                                              float cos_sc) {
  if (is_ray) return RAYLEIGH_NORM * (1.0f + cos_sc * cos_sc);
  const float g2 = g * g;
  const float den = 1.0f + g2 - 2.0f * g * cos_sc;
  return (1.0f - g2) /
         pt::maxf(FOUR_PI * den * sqrtf(pt::maxf(den, 1e-12f)), 1e-12f);
}

// the 4 medium ids of the two packed state rows
__device__ __forceinline__ void unpack_stack(float r0, float r1, float* stk) {
  stk[0] = fmodf(floorf(r0 + 0.5f), 256.0f);
  stk[1] = floorf((r0 + 0.5f) / 256.0f);
  stk[2] = fmodf(floorf(r1 + 0.5f), 256.0f);
  stk[3] = floorf((r1 + 0.5f) / 256.0f);
}

// a transmission through a boundary whose two media differ: the first
// occurrence of the departed medium leaves the stack, the entered one
// takes the first empty slot
__device__ __forceinline__ void stack_cross(float* stk, bool entering,
                                            float inner, float outer) {
  if (inner == outer) return;
  const float rm_id = entering ? outer : inner;
  const float add_id = entering ? inner : outer;
  if (rm_id > 0.5f) {
    for (int k = 0; k < 4; ++k) {
      if (stk[k] == rm_id) {
        stk[k] = 0.0f;
        break;
      }
    }
  }
  if (add_id > 0.5f) {
    for (int k = 0; k < 4; ++k) {
      if (stk[k] < 0.5f) {
        stk[k] = add_id;
        break;
      }
    }
  }
}

// one NEE sample: the shadow ray, whether it is worth tracing, and its
// contribution if unblocked
template <int C>
struct NeeSample {
  V3 so, dir;
  float tmax;
  bool worth;
  float contrib[C];
};

// MEDIUM: at a scatter (M.scattered; S is then not set) the sample leaves
// the scatter point without a normal offset, the phase toward the light is
// the throughput and the hero pdf, and every sample is weighted by the
// transmittance of the tracked media over the shadow distance
template <int C, bool MEDIUM>
__device__ __forceinline__ void nee_sample_m(
    const Lane<C>& L, const Surface<C>& S, const MedLane<C>& M, int si,
    float u_pick, float u1, float u2, const float* __restrict__ light,
    const float* __restrict__ spec, const float* __restrict__ ef, size_t N,
    int i, const RoundArgs& a, NeeSample<C>& r) {
  const bool fed = a.env_kind != ENV_CONSTANT;
  const bool scat = MEDIUM && M.scattered;
  const V3 src_p = scat ? M.scat_p : S.point;
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
  auto Lr = [&](int row) { return __ldg(light + row * 128 + li); };
  V3 lpa{Lr(L_PA), Lr(L_PA + 1), Lr(L_PA + 2)};
  V3 lpb{Lr(L_PB), Lr(L_PB + 1), Lr(L_PB + 2)};
  V3 lpc{Lr(L_PC), Lr(L_PC + 1), Lr(L_PC + 2)};
  V3 lpt, ln;
  sample_surface_light(Lr(L_PTYPE), lpa, lpb, lpc, u1, u2, &lpt, &ln);
  float area_pdf = 1.0f / pt::maxf(Lr(L_AREA), 1e-20f);
  V3 to_l = lpt - src_p;
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
  const int eb = C + 1 + si * (4 + C);  // this sample's environment rows
  if (a.p_env > 0.0f && chose_env) {
    if (fed) {
      nee_dir = V3{ef[eb * N + i], ef[(eb + 1) * N + i], ef[(eb + 2) * N + i]};
      nee_pdf = ef[(eb + 3) * N + i] * a.p_env;
    } else {
      V3 e = pt::uv_to_direction(u1, u2);
      const float* ri = a.env_rot_inv;
      nee_dir = V3{ri[0] * e.x + ri[1] * e.y + ri[2] * e.z,
                   ri[3] * e.x + ri[4] * e.y + ri[5] * e.z,
                   ri[6] * e.x + ri[7] * e.y + ri[8] * e.z};
      float jac_s = TWO_PI2 * sinf(pt::PI_F * u2) + 0.001f;
      nee_pdf = (1.0f / jac_s) * a.p_env;
    }
    nee_tmax = RAY_TMAX;
  }
  float thr[C], nee_p[C], le[C];
  float abs_wo_z = 1.0f;
  if (scat) {
    const float cos_sc = pt::dot(L.d, nee_dir);
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
      thr[ci] = nee_p[ci] = phase_toward(M.g[ci], M.is_ray, cos_sc);
  } else {
    V3 wo_local = pt::to_local(S.tgt, S.btg, S.normal, nee_dir);
    bsdf_eval_lanes<C>(S.mtype, S.alpha, S.metal, S.perm, S.eta_i, S.eta_o,
                       S.kappa, S.refl, S.wi_local, wo_local, a.has_ggx,
                       a.has_metal, thr, nee_p);
    abs_wo_z = fabsf(wo_local.z);
  }
  const float l_mat = Lr(L_MAT), l_mtype = Lr(L_MTYPE);
  const float l_side = Lr(L_SIDE), l_sharp = Lr(L_SHARP);
  const int env_row = 5 * a.n_mats;
  float max_le = 0.0f, max_thr = 0.0f;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    if (chose_env) {
      le[ci] = fed ? ef[(eb + 4 + ci) * N + i]
                   : spec_at(spec, env_row, L.lp[ci]);
    } else {
      float spd_l = spec_at(spec, 5 * (int)l_mat + 4, L.lp[ci]);
      le[ci] = emission_value(spd_l, l_mtype, l_side, l_sharp, cos_l,
                              a.has_sharp);
    }
    if (!scat) thr[ci] = thr[ci] * abs_wo_z;
    max_le = max_nan(max_le, le[ci]);
    max_thr = max_nan(max_thr, thr[ci]);
  }
  r.worth = max_le > 0.0f && nee_pdf > 1e-12f && max_thr > 0.0f;
  float w_nee = balance(nee_pdf, pt::maxf(nee_p[0], 0.0f));
  if (scat) {
    r.so = src_p;
  } else {
    r.so = S.point +
           pt::scale(S.gn, NORMAL_OFFSET * pt::signf(pt::dot(S.gn, nee_dir) +
                                                     1e-9f));
  }
  r.dir = nee_dir;
  r.tmax = nee_tmax;
  float inv_pdf = nee_pdf > 1e-12f ? 1.0f / pt::maxf(nee_pdf, 1e-12f) : 0.0f;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    r.contrib[ci] = L.beta[ci] * L.s_mis * thr[ci] * le[ci] * w_nee *
                    inv_pdf * a.inv_ls;
  }
  if (MEDIUM) {
    const float tr_dist =
        pt::minf((a.p_env > 0.0f && chose_env) ? a.env_tr_dist : dist, 1e8f);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      r.contrib[ci] = r.contrib[ci] *
                      (M.in_med ? expf(-M.sig_t[ci] * tr_dist) : 1.0f);
    }
  }
}

template <int C>
__device__ __forceinline__ void nee_sample(
    const Lane<C>& L, const Surface<C>& S, int si, float u_pick, float u1,
    float u2, const float* __restrict__ light, const float* __restrict__ spec,
    const float* __restrict__ ef, size_t N, int i, const RoundArgs& a,
    NeeSample<C>& r) {
  MedLane<C> none;
  nee_sample_m<C, false>(L, S, none, si, u_pick, u1, u2, light, spec, ef, N, i,
                         a, r);
}

// the BSDF sample of the hero lane and the HWSS throughput and pdf ratios
template <int C>
struct Bounce {
  V3 o_new, d_new;
  float f_pdf;
  bool sample_ok;  // f_pdf > 1e-12
  float ratios[C], pscale[C];
  float wo_z;  // the sampled direction's local z (a boundary crossing's side)
};

template <int C>
__device__ __forceinline__ void bsdf_sample(const Surface<C>& S, float ub0,
                                            float ub1, float ub2,
                                            const RoundArgs& a, Bounce<C>& B) {
  const bool is_ggx = a.has_ggx && S.mtype == MAT_GGX;
  V3 wo_s;
  float ratio_hero;
  if (is_ggx) {
    wo_s = pt::sample_ggx_dir(pt::maxf(S.alpha, 1e-4f),
                              pt::maxf(S.eta_i[0], 1e-3f),
                              pt::maxf(S.eta_o[0], 1e-3f), S.kappa[0],
                              S.metal > 0.5f, S.perm, S.wi_local, ub0, ub1,
                              ub2, a.has_metal, &ratio_hero);
  } else {
    float f_l, p_l;
    wo_s = pt::sample_lambertian(S.refl[0], S.wi_local, ub0, ub1, &f_l, &p_l);
    ratio_hero = pt::minf(S.refl[0], 1.0f);
  }
  if (S.mtype == MAT_PASSTHROUGH) ratio_hero = 0.0f;
  B.wo_z = wo_s.z;
  float f_l[C], p_l[C];
  bsdf_eval_lanes<C>(S.mtype, S.alpha, S.metal, S.perm, S.eta_i, S.eta_o,
                     S.kappa, S.refl, S.wi_local, wo_s, a.has_ggx, a.has_metal,
                     f_l, p_l);
  // the sampled lobe's pdf is the hero lane's eval pdf at wo_s (same
  // inputs as the sampler's own eval; 0 for a passthrough)
  B.f_pdf = p_l[0];
  B.sample_ok = B.f_pdf > 1e-12f;
  const bool hero_dead = f_l[0] <= 0.0f && B.sample_ok;
  const float inv_hero = f_l[0] > 0.0f ? 1.0f / f_l[0] : 0.0f;
  const float inv_fpdf =
      B.sample_ok ? 1.0f / pt::maxf(B.f_pdf, 1e-12f) : 0.0f;
  B.ratios[0] = ratio_hero;
#pragma unroll
  for (int ci = 1; ci < C; ++ci) {
    B.ratios[ci] = hero_dead ? f_l[ci] * fabsf(wo_s.z) * inv_fpdf
                             : ratio_hero * f_l[ci] * inv_hero;
  }
  B.d_new = pt::normalize(pt::to_world(S.tgt, S.btg, S.normal, wo_s));
  B.o_new = S.point +
            pt::scale(S.gn, NORMAL_OFFSET * pt::signf(pt::dot(S.gn, B.d_new)));
  const float inv_p0 = p_l[0] > 0.0f ? 1.0f / p_l[0] : 0.0f;
  B.pscale[0] = 1.0f;
#pragma unroll
  for (int ci = 1; ci < C; ++ci) B.pscale[ci] = p_l[ci] * inv_p0;
}

// the continuation of a scatter: along the fed phase-sampled direction from
// the scatter point; phase value = pdf, so the hero ratio is 1 and the
// companions' throughput and pdf ratios are the fed phase ratios
template <int C>
__device__ __forceinline__ void scatter_bounce(const float* __restrict__ mf,
                                               size_t N, int i,
                                               const MedLane<C>& M,
                                               Bounce<C>& B) {
  auto F = [&](int r) { return mf[r * N + i]; };
  B.d_new = V3{F(Mf<C>::WO), F(Mf<C>::WO + 1), F(Mf<C>::WO + 2)};
  B.o_new = M.scat_p;
  B.f_pdf = F(Mf<C>::PHPDF);
  B.sample_ok = true;
  B.wo_z = 0.0f;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    B.ratios[ci] = F(Mf<C>::PHS + ci);
    B.pscale[ci] = ci == 0 ? 1.0f : B.ratios[ci];
  }
}

// ----------------------------------------------------------- the finalize

// Russian roulette and continuation of a lane at a surface (MEDIUM: or at a
// scatter, which always has a sample, with hero ratio 1) -> whether the
// path continues, and its next throughput
template <int C, bool MEDIUM = false>
__device__ __forceinline__ bool continue_path(const Lane<C>& L,
                                              const Bounce<C>& B, float u_rr,
                                              const RoundArgs& a,
                                              float* beta_next,
                                              bool scattered = false) {
  float ratio_best = B.ratios[0];
#pragma unroll
  for (int ci = 1; ci < C; ++ci) ratio_best = max_nan(ratio_best, B.ratios[ci]);
  if (MEDIUM && scattered) ratio_best = 1.0f;
  const bool sample_ok =
      (MEDIUM && scattered) || (B.sample_ok && ratio_best > 0.0f);
  float p_cont = 1.0f;
  if (a.rr_enabled && L.bounce_ct >= a.min_bounces)
    p_cont = pt::clampf(ratio_best, 0.05f, 1.0f);
  const bool survive = u_rr < p_cont;
  const float inv_pc = 1.0f / pt::maxf(p_cont, 1e-6f);
  bool finite_ok = true;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    beta_next[ci] = L.beta[ci] * (sample_ok ? B.ratios[ci] * inv_pc : 0.0f);
    finite_ok = finite_ok && isfinite(beta_next[ci]);
  }
  bool cp = sample_ok && survive && !(L.bounce_ct + 1.0f >= a.max_bounces) &&
            finite_ok;
  if (a.only_direct && L.bounce_ct >= 1.0f) cp = false;
  return cp;
}

// death -> XYZ accumulate, the respawn at the lane's owning pixel (uniform
// rows u_row0 + 1 .. + 5) and the write-out of the state rows and the
// counter rows of a live lane. MEDIUM: the packed medium stack rows become
// mstk_new on a continuation and 0 (vacuum) on a respawn
template <int C, bool MEDIUM = false>
__device__ __forceinline__ void finalize_write(
    const float* __restrict__ state, const float* __restrict__ u,
    float* __restrict__ out, size_t N, int i, const Lane<C>& L,
    const float* rad, bool cp, const float* beta_next, const Bounce<C>& B,
    int u_row0, const RoundArgs& a, float shadow_ct, float env_ct,
    const float* mstk_new = nullptr) {
  auto S = [&](int r) { return state[r * N + i]; };
  auto O = [&](int r, float v) { out[r * N + i] = v; };
  auto U = [&](int r) { return u[r * N + i]; };
  const bool died = !cp;
  float done = L.done;
  float acc[3] = {S(S_ACC), S(S_ACC + 1), S(S_ACC + 2)};
  bool hw = false;
  if (died) {
    float xyz[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      float e = rad[ci] * a.xyz_scale;
      xyz[0] = xyz[0] + e * pt::x_bar(L.lam[ci]);
      xyz[1] = xyz[1] + e * pt::y_bar(L.lam[ci]);
      xyz[2] = xyz[2] + e * pt::z_bar(L.lam[ci]);
    }
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + xyz[k];
    done = done - 1.0f;
    hw = done > 0.5f;
  }
  V3 o_out = L.o, d_out = L.d;
  float lam_out[C];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) lam_out[ci] = L.lam[ci];
  if (cp) {
    o_out = B.o_new;
    d_out = B.d_new;
  } else if (hw) {
    const float r0 = U(u_row0 + 1), r1 = U(u_row0 + 2), r2 = U(u_row0 + 3);
    const float r3 = U(u_row0 + 4), r4 = U(u_row0 + 5);
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

  O(S_O, o_out.x);
  O(S_O + 1, o_out.y);
  O(S_O + 2, o_out.z);
  O(S_D, d_out.x);
  O(S_D + 1, d_out.y);
  O(S_D + 2, d_out.z);
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    O(S_LAM + ci, lam_out[ci]);
    O(S_BETA + ci, cp ? beta_next[ci] : (hw ? 1.0f : L.beta[ci]));
    O(S_RAD + ci, died ? 0.0f : rad[ci]);
    float pr = S(S_PDFR + ci);
    O(S_PDFR + ci, cp ? pr * B.pscale[ci] : (hw ? 1.0f : pr));
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
  O(S_BOUNCE, cp ? L.bounce_ct + 1.0f : (hw ? 0.0f : L.bounce_ct));
  O(S_PREV_PDF, cp ? B.f_pdf : (hw ? 0.0f : L.prev_pdf));
  O(S_PIX, S(S_PIX));
  for (int r = S_PDFR + C_LANES; r < (MEDIUM ? S_MSTK0 : NS); ++r) O(r, S(r));
  if (MEDIUM) {
    for (int k = 0; k < 2; ++k)
      O(S_MSTK0 + k, cp ? mstk_new[k] : (hw ? 0.0f : S(S_MSTK0 + k)));
  }
  O(O4_BOUNCE_CT, cp ? 1.0f : 0.0f);
  O(O4_CAMERA_CT, hw ? 1.0f : 0.0f);
  O(O4_SHADOW_CT, shadow_ct);
  O(O4_ENV_CT, env_ct);
  for (int r = O4_ENV_CT + 1; r < NK4; ++r) O(r, 0.0f);
}

// a dead lane passes through, with zero counters
__device__ __forceinline__ void pass_through(const float* __restrict__ state,
                                             float* __restrict__ out,
                                             size_t N, int i) {
  for (int r = 0; r < NS; ++r) out[r * N + i] = state[r * N + i];
  for (int r = NS; r < NK4; ++r) out[r * N + i] = 0.0f;
}

}  // namespace rc
