// Per-lane vector and BSDF math for the port's CUDA kernels.
//
// Replaces pathtracer_tpu/kernels/cmath.py, the device-math library that the
// Pallas kernels inline. Its plain twin is kernels/cmath.py (same function
// names, same guards, same operation order); the library is built with
// --fmad=false, so each multiply and add rounds as in the twin.
#pragma once

#include <math.h>

#define PT_DEV __device__ __forceinline__

namespace pt {

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

struct V3 {
  float x, y, z;
};

PT_DEV V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
PT_DEV V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
PT_DEV V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
PT_DEV V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }

PT_DEV float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PT_DEV V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
PT_DEV float length_squared(V3 a) { return dot(a, a); }
PT_DEV V3 normalize(V3 a) {
  float inv = 1.0f / sqrtf(fmaxf(dot(a, a), 1e-20f));
  return scale(a, inv);
}

// num/den with den == 0 mapped to `def`
PT_DEV float safe_div(float num, float den, float def = 0.0f) {
  return den != 0.0f ? num / den : def;
}
// jnp.maximum / jnp.clip propagate NaN; fmaxf/fminf do not
PT_DEV float maxf(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
PT_DEV float minf(float x, float hi) { return x != x ? x : fminf(x, hi); }
PT_DEV float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
PT_DEV float finite_nonneg(float x) {
  return (isfinite(x) && x >= 0.0f) ? x : 0.0f;
}
// floored modulo (jnp.mod / torch.remainder)
PT_DEV float fmod_floor(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}
PT_DEV float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

PT_DEV V3 reflect(V3 w, V3 n) { return (-w) + scale(n, 2.0f * dot(w, n)); }

PT_DEV V3 refract(V3 w, V3 n, float eta_rel, bool* tir) {
  float cos_i = dot(w, n);
  float sin2_i = maxf(1.0f - cos_i * cos_i, 0.0f);
  float sin2_t = eta_rel * eta_rel * sin2_i;
  *tir = sin2_t >= 1.0f;
  float cos_t = sqrtf(maxf(1.0f - sin2_t, 0.0f));
  return scale(-w, eta_rel) + scale(n, eta_rel * cos_i - cos_t);
}

PT_DEV void orthonormal_basis(V3 n, V3* t, V3* bt) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float b = n.x * n.y * a;
  *t = V3{1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  *bt = V3{b, sign + n.y * n.y * a, -n.y};
}

PT_DEV V3 to_local(V3 t, V3 b, V3 n, V3 w) {
  return V3{dot(w, t), dot(w, b), dot(w, n)};
}
PT_DEV V3 to_world(V3 t, V3 b, V3 n, V3 wl) {
  return V3{t.x * wl.x + b.x * wl.y + n.x * wl.z,
            t.y * wl.x + b.y * wl.y + n.y * wl.z,
            t.z * wl.x + b.z * wl.y + n.z * wl.z};
}

PT_DEV V3 uv_to_direction(float u, float v) {
  float phi = TWO_PI_F * u;
  float theta = PI_F * v;
  float st = sinf(theta);
  return V3{st * cosf(phi), st * sinf(phi), cosf(theta)};
}

// ------------------------------------------------------------ sampling

PT_DEV V3 random_cosine_direction(float u, float v) {
  float r = sqrtf(u);
  float phi = TWO_PI_F * v;
  return V3{r * cosf(phi), r * sinf(phi), sqrtf(maxf(1.0f - u, 0.0f))};
}

// ---------------------------------------------------------- lambertian

PT_DEV void eval_lambertian(float refl, V3 wi, V3 wo, float* f, float* pdf) {
  bool same = wi.z * wo.z > 0.0f;
  *f = same ? minf(refl, 1.0f) / PI_F : 0.0f;
  *pdf = same ? fabsf(wo.z) / PI_F : 0.0f;
}

PT_DEV V3 sample_lambertian(float refl, V3 wi, float u1, float u2, float* f,
                            float* pdf) {
  V3 wo = random_cosine_direction(u1, u2);
  wo.z = wi.z < 0.0f ? -wo.z : wo.z;
  eval_lambertian(refl, wi, wo, f, pdf);
  return wo;
}

// ----------------------------------------------------------------- ggx

// stable a2*cos2 + sin2 denominator (the nz2*(a2-1)+1 form cancels
// catastrophically for near-delta lobes)
PT_DEV float ggx_d(float alpha, V3 wh) {
  float a2 = alpha * alpha;
  float nz2 = wh.z * wh.z;
  float sx2 = wh.x * wh.x + wh.y * wh.y;
  float denom = nz2 * a2 + sx2;
  return a2 / maxf(PI_F * denom * denom, 1e-20f);
}

PT_DEV float smith_lambda(float alpha, float w_z) {
  float cos2 = w_z * w_z;
  float tan2 = maxf(1.0f - cos2, 0.0f) / maxf(cos2, 1e-12f);
  return 0.5f * (sqrtf(1.0f + alpha * alpha * tan2) - 1.0f);
}
PT_DEV float smith_g1(float alpha, float w_z) {
  return 1.0f / (1.0f + smith_lambda(alpha, w_z));
}
PT_DEV float smith_g2(float alpha, float wi_z, float wo_z) {
  return 1.0f / (1.0f + smith_lambda(alpha, wi_z) + smith_lambda(alpha, wo_z));
}

PT_DEV V3 sample_vndf(float alpha, V3 wi, float u1, float u2) {
  bool flip = wi.z < 0.0f;
  V3 wi_u = flip ? -wi : wi;
  V3 v = normalize(V3{alpha * wi_u.x, alpha * wi_u.y, wi_u.z});
  float lensq = v.x * v.x + v.y * v.y;
  float inv_len = 1.0f / sqrtf(maxf(lensq, 1e-20f));
  bool big = lensq > 1e-12f;
  V3 t1 = V3{big ? -v.y * inv_len : 1.0f, big ? v.x * inv_len : 0.0f, 0.0f};
  V3 t2 = cross(v, t1);
  float r = sqrtf(u1);
  float phi = TWO_PI_F * u2;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = 0.5f * (1.0f + v.z);
  p2 = (1.0f - s) * sqrtf(maxf(1.0f - p1 * p1, 0.0f)) + s * p2;
  float p3 = sqrtf(maxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
  V3 n_h = scale(t1, p1) + scale(t2, p2) + scale(v, p3);
  V3 wh = normalize(V3{alpha * n_h.x, alpha * n_h.y, maxf(n_h.z, 1e-6f)});
  return flip ? -wh : wh;
}

PT_DEV float fresnel_dielectric(float eta_i, float eta_t, float cos_i) {
  cos_i = clampf(cos_i, -1.0f, 1.0f);
  bool entering = cos_i > 0.0f;
  float ei = entering ? eta_i : eta_t;
  float et = entering ? eta_t : eta_i;
  float ci = fabsf(cos_i);
  float r = ei / et;
  float sin_t2 = r * r * maxf(1.0f - ci * ci, 0.0f);
  bool tir = sin_t2 >= 1.0f;
  float ct = sqrtf(maxf(1.0f - sin_t2, 0.0f));
  float r_par = safe_div(et * ci - ei * ct, et * ci + ei * ct);
  float r_perp = safe_div(ei * ci - et * ct, ei * ci + et * ct);
  float f = 0.5f * (r_par * r_par + r_perp * r_perp);
  return tir ? 1.0f : clampf(f, 0.0f, 1.0f);
}

PT_DEV float fresnel_conductor(float eta_rel, float k_rel, float cos_i) {
  float ci = fabsf(clampf(cos_i, -1.0f, 1.0f));
  float ci2 = ci * ci;
  float si2 = 1.0f - ci2;
  float e2 = eta_rel * eta_rel, k2 = k_rel * k_rel;
  float t0 = e2 - k2 - si2;
  float a2b2 = sqrtf(maxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  float t1 = a2b2 + ci2;
  float a = sqrtf(maxf(0.5f * (a2b2 + t0), 0.0f));
  float t2 = 2.0f * a * ci;
  float rs = safe_div(t1 - t2, t1 + t2);
  float t3 = ci2 * a2b2 + si2 * si2;
  float t4 = t2 * si2;
  float rp = rs * safe_div(t3 - t4, t3 + t4);
  return clampf(0.5f * (rs + rp), 0.0f, 1.0f);
}

PT_DEV float reflect_probability(float fres, bool metallic, float perm) {
  float p = 1.0f - perm * (1.0f - fres);
  return metallic ? 1.0f : clampf(p, 0.0f, 1.0f);
}

// λ-independent part of a GGX eval at (wi, wo), shared by the C lanes
struct GgxGeom {
  bool same_hemi, outside;
  float abs_ci, abs_co, cos_ih_r, refl_fac, g_r, g1_i, refl_pdf;
};

PT_DEV GgxGeom ggx_geom(float alpha, V3 wi, V3 wo) {
  GgxGeom g;
  g.same_hemi = wi.z * wo.z > 0.0f;
  float cos_i = wi.z;
  g.abs_ci = maxf(fabsf(cos_i), 1e-7f);
  g.abs_co = maxf(fabsf(wo.z), 1e-7f);
  g.outside = cos_i > 0.0f;
  V3 wh_r = normalize(wi + wo);
  if (wh_r.z * cos_i < 0.0f) wh_r = -wh_r;
  float d_r = ggx_d(alpha, wh_r);
  g.g_r = smith_g2(alpha, wi.z, wo.z);
  g.cos_ih_r = dot(wi, wh_r);
  g.refl_fac = d_r * g.g_r / (4.0f * g.abs_ci * g.abs_co);
  g.g1_i = smith_g1(alpha, fabsf(wi.z));
  g.refl_pdf = safe_div(g.g1_i * d_r * fabsf(g.cos_ih_r), fabsf(wi.z)) /
               maxf(4.0f * fabsf(g.cos_ih_r), 1e-7f);
  return g;
}

// one spectral lane of eval_ggx_lanes. kRadiance: Radiance transport (the
// path tracer), whose transmission carries the η² factor; false: Importance
// transport (the light tracer), without it
template <bool kRadiance = true>
PT_DEV void ggx_lane(const GgxGeom& g, float alpha, bool metallic, float perm,
                     V3 wi, V3 wo, float eta_i, float eta_o, float kappa,
                     bool has_metal, float* f, float* pdf) {
  float eta_from = g.outside ? eta_o : eta_i;
  float eta_to = g.outside ? eta_i : eta_o;
  float f_diel = fresnel_dielectric(eta_from, eta_to, g.cos_ih_r);
  float fres_r = f_diel;
  if (has_metal && metallic) {
    fres_r = fresnel_conductor(safe_div(eta_to, eta_from, 1.0f),
                               safe_div(kappa, eta_from), g.cos_ih_r);
  }
  float f_out, pdf_out;
  if (g.same_hemi) {
    f_out = fres_r * g.refl_fac;
    pdf_out = g.refl_pdf * reflect_probability(fres_r, metallic, perm);
  } else {
    // transmission lobe (Walter 2007 eq. 21): ht depends on λ
    V3 ht = normalize(-(scale(wi, eta_from) + scale(wo, eta_to)));
    V3 ht_u = ht.z < 0.0f ? -ht : ht;
    float d_t = ggx_d(alpha, ht_u);
    float cos_ih_t = dot(wi, ht);
    float cos_oh_t = dot(wo, ht);
    float fres_t = fresnel_dielectric(eta_from, eta_to, cos_ih_t);
    float denom_t = eta_from * cos_ih_t + eta_to * cos_oh_t;
    float trans_f = fabsf(cos_ih_t * cos_oh_t) * (1.0f - fres_t) * d_t *
                    g.g_r * safe_div(eta_to * eta_to, denom_t * denom_t) /
                    (g.abs_ci * g.abs_co);
    float eta_scale =
        kRadiance ? safe_div(eta_from * eta_from, eta_to * eta_to, 1.0f)
                  : 1.0f;
    float jac_t = safe_div(eta_to * eta_to * fabsf(cos_oh_t),
                           denom_t * denom_t);
    trans_f = trans_f * eta_scale * perm;
    float trans_pdf =
        safe_div(g.g1_i * d_t * fabsf(dot(wi, ht_u)), fabsf(wi.z)) * jac_t;
    f_out = trans_f;
    pdf_out = trans_pdf * (1.0f - reflect_probability(fres_t, metallic, perm));
  }
  *f = finite_nonneg(f_out);
  *pdf = finite_nonneg(pdf_out);
}

// sample_ggx (kRadiance as for ggx_lane) -> wo, weight; the caller
// evaluates f/pdf
template <bool kRadiance = true>
PT_DEV V3 sample_ggx_dir(float alpha, float eta_i, float eta_o, float kappa,
                         bool metallic, float perm, V3 wi, float u1, float u2,
                         float u_lobe, bool has_metal, float* weight) {
  V3 wh = sample_vndf(alpha, wi, u1, u2);
  float cos_ih = dot(wi, wh);
  bool outside = wi.z > 0.0f;
  float eta_from = outside ? eta_o : eta_i;
  float eta_to = outside ? eta_i : eta_o;
  float fres = fresnel_dielectric(eta_from, eta_to, cos_ih);
  if (has_metal && metallic) {
    fres = fresnel_conductor(safe_div(eta_to, eta_from, 1.0f),
                             safe_div(kappa, eta_from), cos_ih);
  }
  float refl_prob = reflect_probability(fres, metallic, perm);
  V3 wo_r = reflect(wi, wh);
  V3 wh_towards = cos_ih < 0.0f ? -wh : wh;
  bool tir;
  V3 wo_t = refract(wi, wh_towards, eta_from / maxf(eta_to, 1e-7f), &tir);
  bool choose_reflect = (u_lobe < refl_prob) || tir || metallic;
  V3 wo = choose_reflect ? wo_r : wo_t;
  float g2 = smith_g2(alpha, wi.z, wo.z);
  float g1 = smith_g1(alpha, fabsf(wi.z));
  float g_ratio = safe_div(g2, g1);
  float eta_scale =
      kRadiance ? safe_div(eta_from * eta_from, eta_to * eta_to, 1.0f) : 1.0f;
  float w_reflect = safe_div(fres * g_ratio, refl_prob);
  float w_trans = g_ratio * eta_scale;
  bool same_hemi = wi.z * wo.z > 0.0f;
  float w = choose_reflect ? (same_hemi ? w_reflect : 0.0f)
                           : (same_hemi ? 0.0f : w_trans);
  *weight = finite_nonneg(w);
  return wo;
}

// CIE 1931 x̄ȳz̄: Wyman, Sloan & Shirley (JCGT 2013) multi-lobe fits
PT_DEV float cie_g(float x, float mu, float t1, float t2) {
  float t = x < mu ? t1 : t2;
  float a = t * (x - mu);
  return expf(-0.5f * (a * a));
}
PT_DEV float x_bar(float l) {
  return 1.056f * cie_g(l, 599.8f, 0.0264f, 0.0323f) +
         0.362f * cie_g(l, 442.0f, 0.0624f, 0.0374f) -
         0.065f * cie_g(l, 501.1f, 0.0490f, 0.0382f);
}
PT_DEV float y_bar(float l) {
  return 0.821f * cie_g(l, 568.8f, 0.0213f, 0.0247f) +
         0.286f * cie_g(l, 530.9f, 0.0613f, 0.0322f);
}
PT_DEV float z_bar(float l) {
  return 1.217f * cie_g(l, 437.0f, 0.0845f, 0.0278f) +
         0.681f * cie_g(l, 459.0f, 0.0385f, 0.0725f);
}

}  // namespace pt
