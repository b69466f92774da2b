// The texture feed of the texture-feed round (tex_feed_kernel): from K1's
// hit rows, each lane's uv on the prim it hit and the reflectance of the hit
// material's uv texture at each of the lane's λs, the rows K2 reads.
//
// Replaces no Pallas kernel: pathtracer_tpu/kernels/megakernel.py:_tex_feed
// is plain JAX between the Pallas K1 and K2. Its plain twin is
// kernels/megakernel.py:tex_feed_plain, a chain of about 170 torch launches
// a round (11 column gathers, the uv of every prim type on every lane, the
// texel index, a pair gather and a lerp per λ), each issued from the host;
// the kernel is one launch. It runs wherever the bake produced the
// (texel, λ-knot) pair table; without one (over TEX_LUT_MAX_TEXELS texels,
// or layers of unequal size) the feed stays on the twin's eval_texture
// chain.
//
// Per lane, in the twin's order and formulas (the library is built with
// --fmad=false and IEEE division and square root, so every row equals the
// twin's on the card bit for bit): p = o + d t; the uv by prim type
// (triangle barycentrics, sphere equirect through atan2f/acosf, rect
// parametric, disk (0, 0)); the material's texture id (mat2tex), its
// (base, w, h) meta row; the nearest texel of the clamped uv; per λ the
// knot and its fraction, the pair (E[k], E[k + 1]) and their lerp. An
// untextured material has no meta row (w = h = 0): its index goes negative
// and wraps around the pair table, as the twin's and the JAX gather's do
// (K2 never reads the value). A lane that hit nothing writes 0, and so do
// the padding rows C..tf_rows-1.
//
// What bounds it on the H100: bytes. A lane reads tp rows 0-1 (8 B) and the
// state rows o, d and its C λs (24 + 4C B), and writes tf_rows(C) = 8 rows
// (32 B): 68 B at C = 1, 80 B at C = 4, 79-93 MB at 1080² lanes, about
// 0.024-0.028 ms at 3.35 TB/s. Every row is read and written coalesced, one
// thread a lane, and a lane that missed reads nothing more. The tables are
// gathered per hit lane through the read-only cache: uvtab columns 0-10,
// mat2tex and meta (a few KB, in L1), and 8 B of the pair table a λ, whose
// 512 knots of a texel lie in 4 KB and whose whole (17 MB for the
// benchmark's textured box) stays in the 50 MB L2. A few dozen flops a
// lane do not matter.
//
// The pair table itself is written on the device too (tex_lut_bake_kernel),
// in place of kernels/megakernel.py:_bake_tex_lut_plain's numpy body and its
// pageable copy to the card, which every call's bake paid. One thread per E
// element (texel, λ-knot) of the baked textures: element r = base + texel ·
// res + knot is also the row of its pair. The thread sums weight(texel) ·
// curve(knot) over its texture's layers in the twin's order, from +0.0f,
// each term a rounded f32 multiply and then a rounded add, as numpy's
// `e += a * v` on zeros does (signed zeros included), and writes the sum to
// both slots that hold it: its own row's [0], the row before's [1] (knot >
// 0) and, at the last knot, its own [1] (the twin's clamp). So the table
// equals the twin's bit for bit. The host's tables say where each texture's
// rows start and which layers it sums: per texture (row base, texel count,
// first layer, layer count), per layer (atlas offset, curve row).
//
// What bounds it on the H100: bytes. It writes the whole table once, 8 B a
// row and coalesced (thread r writes floats 2r - 1 and 2r): 16.25 MiB for
// the benchmark's textured box (4,160 texels × 512 knots), and reads each
// layer's texel weight (the atlas, about 66 KB) and curve knot (9 curves ×
// 512 knots) through L1 and L2: about 5 µs at 3.35 TB/s.
#include <cuda_runtime.h>

#include "round_common.cuh"

namespace {

using pt::clampf;
using pt::cross;
using pt::dot;
using pt::fmod_floor;
using pt::maxf;
using pt::PRIM_RECT;
using pt::PRIM_SPHERE;
using pt::PRIM_TRIANGLE;
using pt::V3;

constexpr int BLOCK = 256;
constexpr int META_ROWS = 128;  // meta i32[128, 4]: (base, w, h, 0)
constexpr float UV_HI = (float)(1.0 - 1e-6);

// the uv of the hit point p = o + d t on the prim of uvtab row `r` (pa 0-2,
// pb 3-5, pc 6-8, ptype 9), as tex_feed_plain computes each prim type's
PT_DEV void hit_uv(const float* __restrict__ r, V3 o, V3 d, float t,
                   float* u, float* v) {
  const V3 pa{__ldg(r), __ldg(r + 1), __ldg(r + 2)};
  const V3 pb{__ldg(r + 3), __ldg(r + 4), __ldg(r + 5)};
  const float ptype = __ldg(r + 9);
  const V3 p = o + pt::scale(d, t);
  const V3 rel = p - pa;
  *u = 0.0f;
  *v = 0.0f;
  if (ptype == (float)PRIM_TRIANGLE) {
    const V3 pc{__ldg(r + 6), __ldg(r + 7), __ldg(r + 8)};
    const V3 e1 = pb - pa, e2 = pc - pa;
    const V3 pvec = cross(d, e2);
    const float det = dot(e1, pvec);
    const float inv_det =
        fabsf(det) > 1e-12f ? 1.0f / (det != 0.0f ? det : 1.0f) : 0.0f;
    const V3 tvec = o - pa;
    *u = dot(tvec, pvec) * inv_det;
    *v = dot(d, cross(tvec, e1)) * inv_det;
  } else if (ptype == (float)PRIM_SPHERE) {
    const float nrm = maxf(sqrtf(dot(rel, rel)), 1e-20f);
    const V3 sn{rel.x / nrm, rel.y / nrm, rel.z / nrm};
    *u = fmod_floor(atan2f(sn.y, sn.x) / pt::TWO_PI_F, 1.0f);
    *v = acosf(clampf(sn.z, -1.0f, 1.0f)) / pt::PI_F;
  } else if (ptype == (float)PRIM_RECT) {
    const V3 pc{__ldg(r + 6), __ldg(r + 7), __ldg(r + 8)};
    *u = 0.5f * (dot(rel, pb) / maxf(dot(pb, pb), 1e-20f) + 1.0f);
    *v = 0.5f * (dot(rel, pc) / maxf(dot(pc, pc), 1e-20f) + 1.0f);
  }
}

// the nearest texel's index along one axis of `size` texels (size 0, an
// untextured material: -1)
PT_DEV long long texel_axis(float uv, long long size) {
  const long long x = (long long)(clampf(uv, 0.0f, UV_HI) * (float)size);
  return x < size - 1 ? x : size - 1;
}

// state [>= S_LAM + C, n], tp [>= 2, n] -> tf [tf_rows, n]
__global__ void __launch_bounds__(BLOCK) tex_feed_kernel(
    const float* __restrict__ state, const float* __restrict__ tp, int n,
    const float* __restrict__ uvtab, int uv_stride,
    const float* __restrict__ mat2tex, const int* __restrict__ meta,
    const float* __restrict__ pairs, long long n_pairs, int res, float lam_lo,
    float lam_span, float res_m1, float uu_hi, int c_lanes, int tf_rows,
    float* __restrict__ tf) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const float t = tp[i], pid = tp[N + i];
  int c = 0;
  if (pid >= 0.0f) {
    const float* r = uvtab + (long long)pid * uv_stride;
    const V3 o{state[rc::S_O * N + i], state[(rc::S_O + 1) * N + i],
               state[(rc::S_O + 2) * N + i]};
    const V3 d{state[rc::S_D * N + i], state[(rc::S_D + 1) * N + i],
               state[(rc::S_D + 2) * N + i]};
    float u, v;
    hit_uv(r, o, d, t, &u, &v);
    const long long tid = (long long)__ldg(mat2tex + (long long)__ldg(r + 10));
    const bool tid_ok = tid >= 0 && tid < META_ROWS;
    const int* m = meta + 4 * (tid_ok ? tid : 0);
    const long long tw = __ldg(m + 1), th = __ldg(m + 2);
    const long long texel =
        __ldg(m) + (texel_axis(v, th) * tw + texel_axis(u, tw)) * res;
    for (; c < c_lanes; ++c) {
      const float lam = state[(rc::S_LAM + c) * N + i];
      const float uu = clampf((lam - lam_lo) / lam_span * res_m1, 0.0f, uu_hi);
      const long long i0 = (long long)uu;
      const float frac = uu - (float)i0;
      long long k = texel + i0;
      if (k < 0) k += n_pairs;
      // an index outside the table (a NaN uv, a bad texture id) makes the
      // twin's gather raise; here the row reads NaN
      float val = __int_as_float(0x7fc00000);
      if (tid_ok && k >= 0 && k < n_pairs)
        val = __ldg(pairs + 2 * k) * (1.0f - frac) +
              __ldg(pairs + 2 * k + 1) * frac;
      tf[c * N + i] = val;
    }
  }
  for (; c < tf_rows; ++c) tf[c * N + i] = 0.0f;
}

// atlas f32[A], values f32[curves, res], texs i32[n_tex, 4] (row base,
// texel count, first layer, layer count; bases ascending), layers i32[L, 2]
// (atlas offset, curve row) -> pairs [n_pairs, 2]
__global__ void __launch_bounds__(BLOCK) tex_lut_bake_kernel(
    const float* __restrict__ atlas, const float* __restrict__ values,
    int res, const int* __restrict__ texs, int n_tex,
    const int* __restrict__ layers, long long n_pairs,
    float* __restrict__ pairs) {
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (r >= n_pairs) return;
  // the texture whose rows hold r: the last one whose base is <= r
  int lo = 0, hi = n_tex - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(texs + 4 * mid) <= r)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int* t = texs + 4 * lo;
  const long long local = r - __ldg(t);
  const long long texel = local / res;
  const int knot = (int)(local - texel * res);
  const int l0 = __ldg(t + 2), l1 = l0 + __ldg(t + 3);
  float acc = 0.0f;
  for (int l = l0; l < l1; ++l) {
    const float w = __ldg(atlas + __ldg(layers + 2 * l) + texel);
    const float v =
        __ldg(values + (long long)__ldg(layers + 2 * l + 1) * res + knot);
    acc = acc + w * v;
  }
  pairs[2 * r] = acc;
  if (knot > 0) pairs[2 * r - 1] = acc;
  if (knot == res - 1) pairs[2 * r + 1] = acc;
}

}  // namespace

extern "C" {

// state [>= S_LAM + c_lanes, n], tp [>= 2, n] (K1's t, prim id | -1),
// uvtab [P_pad, uv_stride], mat2tex [128], meta i32 [128, 4], pairs
// [n_pairs, 2]; lam_lo, lam_span, res_m1 (res - 1) and uu_hi (the largest
// knot coordinate) as the twin rounds them to f32 -> tf [tf_rows, n]
int tex_feed_launch(const float* state, const float* tp, int n,
                    const float* uvtab, int uv_stride, const float* mat2tex,
                    const int* meta, const float* pairs, long long n_pairs,
                    int res, float lam_lo, float lam_span, float res_m1,
                    float uu_hi, int c_lanes, int tf_rows, float* tf,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (c_lanes < 1 || c_lanes > tf_rows || uv_stride < 11 || n_pairs < 1 ||
      res < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  tex_feed_kernel<<<grid, BLOCK, 0, stream>>>(
      state, tp, n, uvtab, uv_stride, mat2tex, meta, pairs, n_pairs, res,
      lam_lo, lam_span, res_m1, uu_hi, c_lanes, tf_rows, tf);
  return (int)cudaGetLastError();
}

// registers per thread and local (spill) bytes of tex_feed_kernel
int tex_feed_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)tex_feed_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

// atlas f32[A], values f32[curves, res], texs i32[n_tex, 4], layers
// i32[L, 2], as tex_lut_bake_kernel takes them -> pairs [n_pairs, 2],
// n_pairs the texels of all the textures times res
int tex_lut_bake_launch(const float* atlas, const float* values, int res,
                        const int* texs, int n_tex, const int* layers,
                        long long n_pairs, float* pairs,
                        cudaStream_t stream) {
  if (n_pairs <= 0) return 0;
  const long long grid = (n_pairs + BLOCK - 1) / BLOCK;
  if (n_tex < 1 || res < 1 || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tex_lut_bake_kernel<<<(unsigned)grid, BLOCK, 0, stream>>>(
      atlas, values, res, texs, n_tex, layers, n_pairs, pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
