// Ray × primitive intersection and the dense sweeps, as device functions.
//
// Replaces the device code that the Pallas sweeps inline:
// pathtracer_tpu/kernels/dense.py:_chunk_t (watertight triangle, sphere,
// rect, disk) and sweep_rowgroup (closest: min t, ties to min prim id;
// any: first hit within tmax). dense_sweep.cu runs them, the independent
// check of walk.cuh's tests, which compute prim_t's bits from the compact
// sweep table. A prim is 12 floats: ptype, valid, pa[3], pb[3],
// pc[3], pad (columns 0..11 of the packed [P_pad, 128] table row).
#pragma once

#include "cmath.cuh"

namespace pt {

constexpr int PRIM_TRIANGLE = 0, PRIM_SPHERE = 1, PRIM_RECT = 2, PRIM_DISK = 3;
constexpr int PRIM_FLOATS = 12;

// t of one ray against one prim (INFINITY = miss)
PT_DEV float prim_t(const float* p, V3 o, V3 d, float t_min, float t_max) {
  if (!(p[1] > 0.5f)) return INFINITY;
  int ptype = (int)p[0];
  float pax = p[2], pay = p[3], paz = p[4];
  float pbx = p[5], pby = p[6], pbz = p[7];
  float pcx = p[8], pcy = p[9], pcz = p[10];
  if (ptype == PRIM_SPHERE) {
    float ocx = o.x - pax, ocy = o.y - pay, ocz = o.z - paz;
    float a = d.x * d.x + d.y * d.y + d.z * d.z;
    float half_b = ocx * d.x + ocy * d.y + ocz * d.z;
    float r = pbx;
    float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
    float disc = half_b * half_b - a * c;
    float sq = sqrtf(maxf(disc, 0.0f));
    float inv_a = 1.0f / maxf(a, 1e-20f);
    float t0 = (-half_b - sq) * inv_a;
    float t1 = (-half_b + sq) * inv_a;
    if (disc > 0.0f && t0 > t_min && t0 < t_max) return t0;
    if (disc > 0.0f && t1 > t_min && t1 < t_max) return t1;
    return INFINITY;
  }
  if (ptype == PRIM_RECT) {
    float nx = pby * pcz - pbz * pcy;
    float ny = pbz * pcx - pbx * pcz;
    float nz = pbx * pcy - pby * pcx;
    float nlen = sqrtf(maxf(nx * nx + ny * ny + nz * nz, 1e-20f));
    nx = nx / nlen;
    ny = ny / nlen;
    nz = nz / nlen;
    float denom = d.x * nx + d.y * ny + d.z * nz;
    bool dok = fabsf(denom) > 1e-12f;
    float t = ((pax - o.x) * nx + (pay - o.y) * ny + (paz - o.z) * nz) /
              (dok ? denom : 1.0f);
    float rx = o.x + t * d.x - pax;
    float ry = o.y + t * d.y - pay;
    float rz = o.z + t * d.z - paz;
    float bb = maxf(pbx * pbx + pby * pby + pbz * pbz, 1e-20f);
    float cc = maxf(pcx * pcx + pcy * pcy + pcz * pcz, 1e-20f);
    float ra = (rx * pbx + ry * pby + rz * pbz) / bb;
    float rb = (rx * pcx + ry * pcy + rz * pcz) / cc;
    bool ok = dok && fabsf(ra) <= 1.0f && fabsf(rb) <= 1.0f && t > t_min &&
              t < t_max;
    return ok ? t : INFINITY;
  }
  if (ptype == PRIM_DISK) {
    float denom = d.x * pbx + d.y * pby + d.z * pbz;
    bool dok = fabsf(denom) > 1e-12f;
    float t = ((pax - o.x) * pbx + (pay - o.y) * pby + (paz - o.z) * pbz) /
              (dok ? denom : 1.0f);
    float qx = o.x + t * d.x - pax;
    float qy = o.y + t * d.y - pay;
    float qz = o.z + t * d.z - paz;
    float r2 = qx * qx + qy * qy + qz * qz;
    float rad = pcx;
    bool ok = dok && r2 <= rad * rad && t > t_min && t < t_max;
    return ok ? t : INFINITY;
  }
  // PRIM_TRIANGLE (and any other code, as the Pallas where-chain does):
  // watertight test — cyclic axis permutation, shear, edge functions
  float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  bool kz_x = (ax > ay) && (ax > az);
  bool kz_y = !kz_x && (ay > az);
  // (kx, ky, kz) = kz_x ? (y, z, x) : kz_y ? (z, x, y) : (x, y, z)
#define PT_CYC(vx, vy, vz, cx, cy, cz)         \
  float cx = kz_x ? (vy) : (kz_y ? (vz) : (vx)); \
  float cy = kz_x ? (vz) : (kz_y ? (vx) : (vy)); \
  float cz = kz_x ? (vx) : (kz_y ? (vy) : (vz));
  PT_CYC(d.x, d.y, d.z, dx_, dy_, dz_)
  float inv_dz = 1.0f / (fabsf(dz_) > 1e-30f ? dz_ : 1.0f);
  float sx = -dx_ * inv_dz;
  float sy = -dy_ * inv_dz;
  PT_CYC(pax - o.x, pay - o.y, paz - o.z, p0x, p0y, p0z)
  PT_CYC(pbx - o.x, pby - o.y, pbz - o.z, p1x, p1y, p1z)
  PT_CYC(pcx - o.x, pcy - o.y, pcz - o.z, p2x, p2y, p2z)
#undef PT_CYC
  float x0 = p0x + sx * p0z, y0 = p0y + sy * p0z, z0 = p0z * inv_dz;
  float x1 = p1x + sx * p1z, y1 = p1y + sy * p1z, z1 = p1z * inv_dz;
  float x2 = p2x + sx * p2z, y2 = p2y + sy * p2z, z2 = p2z * inv_dz;
  float e0 = x1 * y2 - y1 * x2;
  float e1 = x2 * y0 - y2 * x0;
  float e2 = x0 * y1 - y0 * x1;
  float det = e0 + e1 + e2;
  bool inside = !(((e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f)) &&
                  ((e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f)));
  float t_scaled = e0 * z0 + e1 * z1 + e2 * z2;
  bool dok = fabsf(det) > 1e-30f;
  float t = t_scaled / (dok ? det : 1.0f);
  bool ok = inside && dok && t > t_min && t < t_max;
  return ok ? t : INFINITY;
}

// closest hit over prims [0, n): strict '<' keeps the lowest id among
// equal t, which is the Pallas "min t, then min id" reduction
PT_DEV void sweep_closest_dev(const float* prims, int n, int id0, V3 o, V3 d,
                              float t_min, float t_max, float* best_t,
                              int* best_id) {
  for (int i = 0; i < n; ++i) {
    float t = prim_t(prims + i * PRIM_FLOATS, o, d, t_min, t_max);
    if (t < *best_t) {
      *best_t = t;
      *best_id = id0 + i;
    }
  }
}

PT_DEV bool sweep_any_dev(const float* prims, int n, V3 o, V3 d, float t_min,
                          float t_max) {
  for (int i = 0; i < n; ++i) {
    if (prim_t(prims + i * PRIM_FLOATS, o, d, t_min, t_max) < INFINITY)
      return true;
  }
  return false;
}

// copy prims [p0, p0+n) of the packed [P_pad, 128] table into a compact
// [n][12] block (shared memory), cooperatively over the block's threads
PT_DEV void stage_prims(const float* __restrict__ tab, int p0, int n,
                        float* dst) {
  for (int k = threadIdx.x; k < n * 3; k += blockDim.x) {
    int i = k / 3, q = k % 3;
    const float4* row = reinterpret_cast<const float4*>(tab + (size_t)(p0 + i) * 128);
    reinterpret_cast<float4*>(dst + i * PRIM_FLOATS)[q] = __ldg(row + q);
  }
}

}  // namespace pt
