// The two-program bounce round, K12 (closest-hit sweep + shading) and K34
// (NEE shadow sweeps + finalize), the texture-feed round's K1 (the
// closest-hit rows sweep) and K2 (shading from K1's rows), and the split
// round's K3 (the any-hit rows sweep of one NEE sample's shadow rays) and
// K4 (the finalize, fed K3's blocked masks).
//
// Replaces pathtracer_tpu/kernels/megakernel.py:_k12_call (the Pallas call
// of _shade_sweep_kernel -> _shade_body), _k34_call (the Pallas call of
// _finalize_sweep_kernel -> _finalize_body -> _finalize_core) and _k2_call
// (the Pallas call of _shade_kernel -> _shade_body), and
// pathtracer_tpu/kernels/dense.py:sweep_closest_rows (the Pallas call of
// _closest_rows_kernel), sweep_any_rows (the Pallas call of
// _any_rows_kernel) and megakernel.py:_k4_call (the Pallas call of
// _finalize_kernel -> _finalize_body -> _finalize_core): the rounds of every
// megakernel scene outside the fused gate, up to 8192 prims, with constant,
// Sun and HDR environments and with medium-aware transport. K12 writes the
// K2 rows that K34 reads ([k2_rows(ls), n]: radiance after the emission
// adds, the BSDF sample and its ratios, and per light sample the shadow ray,
// its worth and its contribution); K34 writes
// the new state and counter rows ([40, n]). Scenes with uv-textured
// lambertians split K12 in two, because the texture feed between them
// (kernels/megakernel.py:tex_feed, csrc/tex_feed.cu) needs the hit: K1
// writes [8, n] rows (t, prim id | -1, zeros) and K2 the same K2 rows as
// K12, taking a textured lambertian's reflectance from the feed's rows. The per-lane
// device code is round_common.cuh, shared with the fused round.
//
// K3 reads a sample's shadow ray and tmax in place from the K2 rows and
// writes one row, 1 where the ray is blocked; it resolves the ray with the
// any-hit walk K34 runs inline (walk::any_hit, one ray a lane), so the two
// agree lane for lane, and like K34 it sweeps only the lanes whose sample is
// worth a ray (the Pallas kernel sweeps all and writes an 8-row block, 7
// rows of it zero). K4 is K34's finalize (finalize_lane, shared) with the
// masks read instead of swept. It is bound by its bytes: the state in, the
// K2 rows, the out rows.
//
// One thread runs one lane. The medium branch is the template parameter MEDIUM
// of K12, K2, K34 and K4 (round_common.cuh): the surface instantiations compile
// without it. The medium K12 and K2 at C = 4 are kernels of their own, capped
// at MEDIUM_C4_BLOCKS blocks an SM. The hit prim's record is an indexed load of
// its prim_tab column through the read-only cache (the JAX package's one-hot
// MXU fetch, _prim_attr_fetch). The JAX package skips whole dead tiles; here
// each dead lane skips: K12 writes 0 to every K2 row of a dead lane, K34 passes
// its state through, exactly as the plain twins do. K1 skips dead lanes too (t
// = inf, id = -1 there), where the Pallas rows sweep sweeps every lane. K2
// sweeps nothing: it is bound by its state, K2-row and table reads, about 0.6
// KB per lane.
//
// What bounds K12, K34, K1 and K3 on the H100: the sweeps' f32 operations,
// as instructions issued. A live lane tests every prim of the table for its
// closest hit and for each unblocked shadow ray (up to 8192 prims x 23 to
// 41 operations), against ~1 KB of memory traffic per lane and round. The
// edge functions must round as the twin's separate multiplies and
// subtracts do, so the library is built with --fmad=false and nothing
// contracts to an FMA: the card's data-sheet f32 rate counts an FMA as two
// operations, and a sweep of separate multiplies and adds cannot go under
// twice its bound by operations.
//
// K12 (shade_sweep_kernel, replaces megakernel.py:_k12_call), K34
// (finalize_sweep_kernel, replaces megakernel.py:_k34_call), K1
// (sweep_closest_rows_kernel, replaces dense.py:sweep_closest_rows) and K3
// (sweep_any_rows_kernel, replaces dense.py:sweep_any_rows) walk the table
// through walk.cuh, the walk designed for this card: the compact baked
// sweep table (64-byte rows, a rect's normal and edge norms precomputed) is
// brought into shared memory by asynchronous bulk copies, whole and once
// per block where it fits the residency budget, through a ring of tiles
// otherwise; the ray's permutation, shear and reciprocals are computed once
// per ray, not once per prim; and K34 tests each row against two NEE
// samples' shadow rays of the lane at once (pairs of samples, in order; the
// radiance is still summed in sample order), leaving the rows per warp when
// no lane has a ray unresolved. K1's walk is K12's, the closest hit of a
// live lane's ray, two rows a loop turn; K3's is K34's for one ray a lane.
#include <cuda_runtime.h>

#include "round_common.cuh"
#include "walk.cuh"

namespace {

using namespace rc;
using pt::V3;

constexpr int BLOCK = 128;
constexpr int MAX_PRIMS = 8192;  // the megakernel gate

__device__ __forceinline__ void load_ray(const float* __restrict__ src,
                                         size_t N, int i, int row0, V3* o,
                                         V3* d) {
  *o = V3{src[row0 * N + i], src[(row0 + 1) * N + i],
          src[(row0 + 2) * N + i]};
  *d = V3{src[(row0 + 3) * N + i], src[(row0 + 4) * N + i],
          src[(row0 + 5) * N + i]};
}

// K1: the closest hit of every live lane's ray, read in place from rows
// row0 .. row0 + 5 of src -> out [8, n]: t, prim id (-1 on a miss and on a
// dead lane, whose t is inf), zeros; the sweep table as K12's
__global__ void __launch_bounds__(BLOCK) sweep_closest_rows_kernel(
    const float* __restrict__ src, int row0, int alive_row,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    float* __restrict__ out, int n) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool live = i < n && src[alive_row * N + i] > 0.5f;
  V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  if (live) load_ray(src, N, i, row0, &o, &d);
  float t_hit = INFINITY;
  int pid = -1;
  walk::closest(T, live, o, d, &t_hit, &pid);
  if (i >= n) return;
  out[i] = t_hit;
  out[N + i] = (float)pid;
  for (int r = 2; r < 8; ++r) out[r * N + i] = 0.0f;
}

// the K2 rows of one lane from its closest hit (pid -1: none): shading, the
// NEE samples and the BSDF sample; all 0 for a dead lane. MEDIUM: from the
// medium-feed rows mf, a lane whose free flight ends before the hit
// scatters there (NEE and continuation from the scatter point), and the
// medium rows (scattered, lane weights, the stack after a crossing) are
// written for every live lane.
//
// Every row that all live lanes write is written where the warp is not
// divided between scattered and surface lanes: the scatter flag and the
// lane weights right after the free flight, the radiance once the emission
// and environment adds are done (the NEE samples add nothing to it), the
// stack rows after the branch; only the rows of the NEE and BSDF samples are
// written inside it. The f32 operations and their order are the twin's
template <int C, bool MEDIUM>
__device__ __forceinline__ void shade_lane(
    bool live, float t_hit, int pid, const float* __restrict__ u,
    const float* __restrict__ state, const float* __restrict__ ef,
    const float* __restrict__ tf, const float* __restrict__ mf,
    float* __restrict__ k2, size_t N, int i, const float* __restrict__ prim,
    int p_pad, const float* __restrict__ mat,
    const float* __restrict__ light, const float* __restrict__ spec,
    const RoundArgs& a) {
  const int ls = a.light_samples;
  const int nk2 = k2_rows(ls);
  auto K = [&](int r, float v) { k2[r * N + i] = v; };
  if (!live) {
    for (int r = 0; r < nk2; ++r) K(r, 0.0f);
    return;
  }
  auto U = [&](int r) { return u[r * N + i]; };
  Lane<C> L;
  load_lane<C>(state, N, i, a, L);
  const bool hit = pid >= 0;
  const float kind = hit ? __ldg(prim + R_KIND * p_pad + pid) : 0.0f;
  MedLane<C> M;
  M.scattered = false;
  Surface<C> S;
  if (MEDIUM) {
    med_flight<C>(L, mf, N, i, hit, t_hit, M);
    K(O_SCAT, M.scattered ? 1.0f : 0.0f);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) K(O_MEDW + ci, M.medw[ci]);
    for (int ci = C; ci < C_LANES; ++ci) K(O_MEDW + ci, 1.0f);
  }
  const bool scattered = MEDIUM && M.scattered;
  const bool at_surface = hit && kind != 2.0f && !scattered;
  const bool escaped = !hit && !scattered;
  if (escaped) escape_add<C>(L, spec, ef, N, i, a);
  if (at_surface)
    surface_at<C>(L, prim, p_pad, pid, t_hit, kind, mat, spec, tf, N, i, a,
                  S);
  // the radiance is final: the NEE samples add nothing to it
#pragma unroll
  for (int ci = 0; ci < C; ++ci) K(O_RAD + ci, L.rad[ci]);
  for (int ci = C; ci < C_LANES; ++ci) K(O_RAD + ci, 0.0f);

  float shadow_ct = 0.0f;
  // a transmission through a boundary of material S.mid, entering (to its
  // inner side) or leaving: the tracked stack changes
  bool cross = false, entering = false;
  if (at_surface || scattered) {
    for (int si = 0; si < ls; ++si) {
      NeeSample<C> r;
      nee_sample_m<C, MEDIUM>(L, S, M, si, U(3 * si), U(3 * si + 1),
                              U(3 * si + 2), light, spec, ef, N, i, a, r);
      const int b = O_NEE + NEE_ROWS * si;
      K(b + 0, r.so.x);
      K(b + 1, r.so.y);
      K(b + 2, r.so.z);
      K(b + 3, r.dir.x);
      K(b + 4, r.dir.y);
      K(b + 5, r.dir.z);
      K(b + 6, r.tmax);
      K(b + 7, r.worth ? 1.0f : 0.0f);
#pragma unroll
      for (int ci = 0; ci < C; ++ci) K(b + 8 + ci, r.contrib[ci]);
      for (int ci = C; ci < C_LANES; ++ci) K(b + 8 + ci, 0.0f);
      if (r.worth) shadow_ct += 1.0f;
    }
    Bounce<C> B;
    if (at_surface) {
      bsdf_sample<C>(S, U(3 * ls), U(3 * ls + 1), U(3 * ls + 2), a, B);
      cross = MEDIUM && B.wo_z * S.wi_local.z < 0.0f;
      entering = B.wo_z < 0.0f;
    } else {
      scatter_bounce<C>(mf, N, i, M, B);
    }
    K(O_FPDF, B.f_pdf);
    K(O_SAMPLE_OK, B.sample_ok ? 1.0f : 0.0f);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      K(O_RATIO + ci, B.ratios[ci]);
      K(O_PSCALE + ci, B.pscale[ci]);
    }
    K(O_ONEW, B.o_new.x);
    K(O_ONEW + 1, B.o_new.y);
    K(O_ONEW + 2, B.o_new.z);
    K(O_DNEW, B.d_new.x);
    K(O_DNEW + 1, B.d_new.y);
    K(O_DNEW + 2, B.d_new.z);
  } else {
    for (int r = O_FPDF; r < O_SCAT; ++r) K(r, 0.0f);
    for (int r = O_NEE; r < O_NEE + NEE_ROWS * ls; ++r) K(r, 0.0f);
  }
  if (MEDIUM) {
    // the packed stack rows, after a crossing
    float stk[4];
    unpack_stack(state[S_MSTK0 * N + i], state[S_MSTK1 * N + i], stk);
    if (cross)
      stack_cross(stk, entering, __ldg(mat + M_INNER * 128 + S.mid),
                  __ldg(mat + M_OUTER * 128 + S.mid));
    K(O_MSTK, stk[0] + 256.0f * stk[1]);
    K(O_MSTK + 1, stk[2] + 256.0f * stk[3]);
  }
  for (int ci = C; ci < C_LANES; ++ci) {
    K(O_RATIO + ci, 0.0f);
    K(O_PSCALE + ci, 0.0f);
  }
  K(O_AT_SURF, at_surface ? 1.0f : 0.0f);
  K(O_ENV_CT, escaped ? 1.0f : 0.0f);
  K(O_SHADOW_CT, shadow_ct);
  if (!MEDIUM)
    for (int r = O_SCAT; r < O_NEE; ++r) K(r, 0.0f);
  for (int r = O_NEE + NEE_ROWS * ls; r < nk2; ++r) K(r, 0.0f);
}

// K12: the closest hit, then the shading
template <int C, bool MEDIUM>
__device__ __forceinline__ void shade_sweep_body(
    const float* __restrict__ u, const float* __restrict__ state,
    const float* __restrict__ ef, const float* __restrict__ mf,
    float* __restrict__ k2, int n,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    const float* __restrict__ prim, int p_pad, const float* __restrict__ mat,
    const float* __restrict__ light, const float* __restrict__ spec,
    const RoundArgs& a, float* walk_rows, uint64_t* walk_bars) {
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool live = i < n && state[S_ALIVE * N + i] > 0.5f;
  V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  if (live) load_ray(state, N, i, S_O, &o, &d);
  float t_hit = INFINITY;
  int pid = -1;
  walk::closest(T, live, o, d, &t_hit, &pid);
  if (i >= n) return;
  shade_lane<C, MEDIUM>(live, t_hit, pid, u, state, ef, nullptr, mf, k2, N, i,
                        prim, p_pad, mat, light, spec, a);
}

// K2: the shading from K1's rows tp [8, n] (t, prim id | -1), with the
// texture-feed rows tf [tf_rows(C), n] (null: every reflectance baked)
template <int C, bool MEDIUM>
__device__ __forceinline__ void shade_body(
    const float* __restrict__ u, const float* __restrict__ state,
    const float* __restrict__ tp, const float* __restrict__ ef,
    const float* __restrict__ tf, const float* __restrict__ mf,
    float* __restrict__ k2, int n,
    const float* __restrict__ prim, int p_pad, const float* __restrict__ mat,
    const float* __restrict__ light, const float* __restrict__ spec,
    const RoundArgs& a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const bool live = state[S_ALIVE * N + i] > 0.5f;
  shade_lane<C, MEDIUM>(live, tp[i], live ? (int)tp[N + i] : -1, u, state, ef,
                        tf, mf, k2, N, i, prim, p_pad, mat, light, spec, a);
}

#define SHADE_SWEEP_PARAMS                                                   \
  const float *__restrict__ u, const float *__restrict__ state,              \
      const float *__restrict__ ef, const float *__restrict__ mf,            \
      float *__restrict__ k2, int n, const float *__restrict__ sweep,        \
      int p_rows, int resident_rows, const float *__restrict__ prim,         \
      int p_pad, const float *__restrict__ mat,                              \
      const float *__restrict__ light, const float *__restrict__ spec,       \
      const RoundArgs a
#define SHADE_SWEEP_ARGS                                                     \
  u, state, ef, mf, k2, n, sweep, p_rows, resident_rows, prim, p_pad, mat,   \
      light, spec, a
#define SHADE_PARAMS                                                         \
  const float *__restrict__ u, const float *__restrict__ state,              \
      const float *__restrict__ tp, const float *__restrict__ ef,            \
      const float *__restrict__ tf, const float *__restrict__ mf,            \
      float *__restrict__ k2, int n, const float *__restrict__ prim,         \
      int p_pad, const float *__restrict__ mat,                              \
      const float *__restrict__ light, const float *__restrict__ spec,       \
      const RoundArgs a
#define SHADE_ARGS \
  u, state, tp, ef, tf, mf, k2, n, prim, p_pad, mat, light, spec, a

template <int C, bool MEDIUM>
__global__ void __launch_bounds__(BLOCK) shade_sweep_kernel(
    SHADE_SWEEP_PARAMS) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  shade_sweep_body<C, MEDIUM>(SHADE_SWEEP_ARGS, walk_rows, walk_bars);
}

template <int C, bool MEDIUM>
__global__ void __launch_bounds__(BLOCK) shade_kernel(SHADE_PARAMS) {
  shade_body<C, MEDIUM>(SHADE_ARGS);
}

// The medium instantiations at C = 4 are held to MEDIUM_C4_BLOCKS blocks an
// SM (128 registers a thread): on an NVIDIA H100 80GB HBM3 (700 W), on the
// fog box's third round at 1080 x 1080, K2 took 0.81 ms capped against
// 1.17-1.22 at the three blocks of its uncapped 149-160 registers, K12 0.97
// against 1.02-1.03, though the cap spills 48-56 bytes a thread. At C = 1
// the cap (five blocks) gained nothing, and any cap, even of one block,
// changes the code and the time of the instantiations it is put on, so the
// others keep the plain bound
constexpr int MEDIUM_C4_BLOCKS = 4;

__global__ void __launch_bounds__(BLOCK, MEDIUM_C4_BLOCKS)
    shade_sweep_kernel_c4_medium(SHADE_SWEEP_PARAMS) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  shade_sweep_body<4, true>(SHADE_SWEEP_ARGS, walk_rows, walk_bars);
}

__global__ void __launch_bounds__(BLOCK, MEDIUM_C4_BLOCKS)
    shade_kernel_c4_medium(SHADE_PARAMS) {
  shade_body<4, true>(SHADE_ARGS);
}

#undef SHADE_SWEEP_PARAMS
#undef SHADE_SWEEP_ARGS
#undef SHADE_PARAMS
#undef SHADE_ARGS

// the kernel functions of K12 and K2 at <C, MEDIUM>
template <int C, bool MEDIUM>
constexpr auto shade_sweep_fn() {
  if constexpr (C == 4 && MEDIUM)
    return &shade_sweep_kernel_c4_medium;
  else
    return &shade_sweep_kernel<C, MEDIUM>;
}

template <int C, bool MEDIUM>
constexpr auto shade_fn() {
  if constexpr (C == 4 && MEDIUM)
    return &shade_kernel_c4_medium;
  else
    return &shade_kernel<C, MEDIUM>;
}

// the finalize of one live lane from its K2 rows and its radiance after the
// NEE samples: RR, death -> XYZ, respawn, write-out (uniform rows 0 .. 5).
// MEDIUM: the lane weights go on the throughput, a scatter continues like a
// surface sample, and the stack rows follow. Shared by K34 and K4.
template <int C, bool MEDIUM>
__device__ __forceinline__ void finalize_lane(
    const float* __restrict__ u, const float* __restrict__ state,
    const float* __restrict__ k2, float* __restrict__ out, size_t N, int i,
    const RoundArgs& a, const float* rad) {
  auto K = [&](int r) { return k2[r * N + i]; };
  Lane<C> L;
  load_lane<C>(state, N, i, a, L);
  bool scattered = false;
  float mstk[2] = {0.0f, 0.0f};
  if (MEDIUM) {
    scattered = K(O_SCAT) > 0.5f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) L.beta[ci] = L.beta[ci] * K(O_MEDW + ci);
    mstk[0] = K(O_MSTK);
    mstk[1] = K(O_MSTK + 1);
  }
  Bounce<C> B;
  B.f_pdf = K(O_FPDF);
  B.sample_ok = K(O_SAMPLE_OK) > 0.5f;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    B.ratios[ci] = K(O_RATIO + ci);
    B.pscale[ci] = K(O_PSCALE + ci);
  }
  B.o_new = V3{K(O_ONEW), K(O_ONEW + 1), K(O_ONEW + 2)};
  B.d_new = V3{K(O_DNEW), K(O_DNEW + 1), K(O_DNEW + 2)};
  float beta_next[C];
  bool cp = false;
  if (K(O_AT_SURF) > 0.5f || scattered)
    cp = continue_path<C, MEDIUM>(L, B, u[i], a, beta_next, scattered);
  finalize_write<C, MEDIUM>(state, u, out, N, i, L, rad, cp, beta_next, B, 0, a,
                            0.0f, 0.0f, mstk);
}

// the shadow walks of NEE samples si0 .. si0 + NR - 1 of one lane, together,
// then each resolved into the radiance in sample order
template <int C, int NR>
__device__ __forceinline__ void nee_walk(walk::Table& T, bool live,
                                         const float* __restrict__ k2,
                                         size_t N, int i, int si0,
                                         float* rad) {
  auto K = [&](int r) { return k2[r * N + i]; };
  bool worth[NR], blocked[NR];
  V3 so[NR], sd[NR];
  float tmax[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int b = O_NEE + NEE_ROWS * (si0 + j);
    worth[j] = live && K(b + 7) > 0.5f;
    so[j] = sd[j] = V3{0.f, 0.f, 0.f};
    tmax[j] = 0.0f;
    if (worth[j]) {
      so[j] = V3{K(b), K(b + 1), K(b + 2)};
      sd[j] = V3{K(b + 3), K(b + 4), K(b + 5)};
      tmax[j] = K(b + 6);
    }
  }
  walk::any_hit<NR>(T, worth, so, sd, tmax, blocked);
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    if (worth[j] && !blocked[j]) {
      const int b = O_NEE + NEE_ROWS * (si0 + j);
#pragma unroll
      for (int ci = 0; ci < C; ++ci) rad[ci] = rad[ci] + K(b + 8 + ci);
    }
  }
}

// K34: the NEE shadow walks, then the finalize
template <int C, bool MEDIUM>
__global__ void __launch_bounds__(BLOCK) finalize_sweep_kernel(
    const float* __restrict__ u, const float* __restrict__ state,
    const float* __restrict__ k2, float* __restrict__ out, int n,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    const RoundArgs a) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  // with no light samples no walk follows
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows,
                                   a.light_samples > 0, walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool live = i < n && state[S_ALIVE * N + i] > 0.5f;
  float rad[C];
#pragma unroll
  for (int ci = 0; ci < C; ++ci)
    rad[ci] = live ? k2[(O_RAD + ci) * N + i] : 0.0f;

  // ---- NEE shadow walks: the samples two at a time through one walk of
  // the table (a last odd one alone)
  for (int si = 0; si < a.light_samples;) {
    if (si + 1 < a.light_samples) {
      nee_walk<C, 2>(T, live, k2, N, i, si, rad);
      si += 2;
    } else {
      nee_walk<C, 1>(T, live, k2, N, i, si, rad);
      si += 1;
    }
  }
  if (i >= n) return;
  if (!live) {
    pass_through(state, out, N, i);
    return;
  }
  finalize_lane<C, MEDIUM>(u, state, k2, out, N, i, a, rad);
}

// K3: whether anything blocks the ray read in place from rows row0 ..
// row0 + 5 of src within (T_MIN, src[tmax_row]) -> out [1, n], 1 = blocked.
// Only lanes whose row live_row is > 0.5 are swept (live_row < 0: all);
// the others read 0. The sweep table as K34's; every thread of the block
// reaches the walk (open_table's barrier, the walk's warp vote), a lane
// with no ray to sweep passing want = false
__global__ void __launch_bounds__(BLOCK) sweep_any_rows_kernel(
    const float* __restrict__ src, int row0, int tmax_row, int live_row,
    const float* __restrict__ sweep, int p_rows, int resident_rows,
    float* __restrict__ out, int n) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool want =
      i < n && (live_row < 0 || src[live_row * N + i] > 0.5f);
  V3 so{0.f, 0.f, 0.f}, sd{0.f, 0.f, 0.f};
  float tmax = 0.0f;
  if (want) {
    load_ray(src, N, i, row0, &so, &sd);
    tmax = src[tmax_row * N + i];
  }
  bool blocked;
  walk::any_hit<1>(T, &want, &so, &sd, &tmax, &blocked);
  if (i < n) out[i] = blocked ? 1.0f : 0.0f;
}

// K4: the finalize fed the blocked masks blk [light_samples, n] (row si:
// NEE sample si, read only where the sample was worth a ray)
template <int C, bool MEDIUM>
__global__ void __launch_bounds__(BLOCK) finalize_kernel(
    const float* __restrict__ u, const float* __restrict__ state,
    const float* __restrict__ k2, const float* __restrict__ blk,
    float* __restrict__ out, int n, const RoundArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  if (!(state[S_ALIVE * N + i] > 0.5f)) {
    pass_through(state, out, N, i);
    return;
  }
  auto K = [&](int r) { return k2[r * N + i]; };
  float rad[C];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) rad[ci] = K(O_RAD + ci);
  for (int si = 0; si < a.light_samples; ++si) {
    const int b = O_NEE + NEE_ROWS * si;
    if (K(b + 7) > 0.5f && !(blk[si * N + i] > 0.5f)) {
#pragma unroll
      for (int ci = 0; ci < C; ++ci) rad[ci] = rad[ci] + K(b + 8 + ci);
    }
  }
  finalize_lane<C, MEDIUM>(u, state, k2, out, N, i, a, rad);
}

// calls `fn.template operator()<C, MEDIUM>()` for the arguments' C and
// medium flag; cudaErrorInvalidValue for any other C
template <typename F>
int dispatch(const RoundArgs& a, F fn) {
  const bool m = a.medium != 0;
  if (a.c_lanes == 1)
    return m ? fn.template operator()<1, true>()
             : fn.template operator()<1, false>();
  if (a.c_lanes == 4)
    return m ? fn.template operator()<4, true>()
             : fn.template operator()<4, false>();
  return (int)cudaErrorInvalidValue;
}

struct LaunchShadeSweep {
  const float *u, *state, *ef, *mf;
  float* k2;
  int n;
  const float* sweep;
  int p_rows, resident_rows;
  const float* prim;
  int p_pad;
  const float *mat, *light, *spec;
  const RoundArgs& a;
  cudaStream_t stream;
  template <int C, bool MEDIUM>
  int operator()() const {
    const int smem = walk::shared_bytes(p_rows, resident_rows);
    const auto fn = shade_sweep_fn<C, MEDIUM>();
    int rc = walk::allow_shared((const void*)fn, smem);
    if (rc != 0) return rc;
    fn<<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(
        u, state, ef, mf, k2, n, sweep, p_rows, resident_rows, prim, p_pad,
        mat, light, spec, a);
    return (int)cudaGetLastError();
  }
};

struct LaunchShade {
  const float *u, *state, *tp, *ef, *tf, *mf;
  float* k2;
  int n;
  const float* prim;
  int p_pad;
  const float *mat, *light, *spec;
  const RoundArgs& a;
  cudaStream_t stream;
  template <int C, bool MEDIUM>
  int operator()() const {
    shade_fn<C, MEDIUM>()<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        u, state, tp, ef, tf, mf, k2, n, prim, p_pad, mat, light, spec, a);
    return (int)cudaGetLastError();
  }
};

struct LaunchFinalizeSweep {
  const float *u, *state, *k2;
  float* out;
  int n;
  const float* sweep;
  int p_rows, resident_rows;
  const RoundArgs& a;
  cudaStream_t stream;
  template <int C, bool MEDIUM>
  int operator()() const {
    const int smem = walk::shared_bytes(p_rows, resident_rows);
    int rc = walk::allow_shared(
        (const void*)finalize_sweep_kernel<C, MEDIUM>, smem);
    if (rc != 0) return rc;
    finalize_sweep_kernel<C, MEDIUM><<<(n + BLOCK - 1) / BLOCK, BLOCK, smem,
                                       stream>>>(
        u, state, k2, out, n, sweep, p_rows, resident_rows, a);
    return (int)cudaGetLastError();
  }
};

struct LaunchFinalize {
  const float *u, *state, *k2, *blk;
  float* out;
  int n;
  const RoundArgs& a;
  cudaStream_t stream;
  template <int C, bool MEDIUM>
  int operator()() const {
    finalize_kernel<C, MEDIUM><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        u, state, k2, blk, out, n, a);
    return (int)cudaGetLastError();
  }
};

// the kernel function of (which: 0 K12, 1 K34, 2 K2, 4 K4) at <C, MEDIUM>
struct KernelOf {
  int which;
  const void** fn;
  template <int C, bool MEDIUM>
  int operator()() const {
    *fn = which == 0   ? (const void*)shade_sweep_fn<C, MEDIUM>()
          : which == 1 ? (const void*)finalize_sweep_kernel<C, MEDIUM>
          : which == 2 ? (const void*)shade_fn<C, MEDIUM>()
                       : (const void*)finalize_kernel<C, MEDIUM>;
    return 0;
  }
};

bool walk_ok(int p_rows, int resident_rows) {
  return walk::table_ok(p_rows, MAX_PRIMS, resident_rows);
}

int attrs(const void* fn, int* regs, int* local_bytes) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// K12: u [n_u_rows(ls, medium), n], state [32, n], ef [ef_rows(ls, C), n]
// (null for a constant environment), mf [mf_rows(C), n] (null unless
// medium-aware) -> k2 [k2_rows(ls), n]; tables as baked by
// kernels/megakernel.py:build_mega_scene, sweep [p_rows, 16] its compact
// sweep table, resident in shared memory where p_rows <= resident_rows.
// Returns a cudaError_t.
int shade_sweep_launch(const float* u, const float* state, const float* ef,
                       const float* mf, float* k2, int n, const float* sweep,
                       int p_rows, int resident_rows, const float* prim,
                       int p_pad, const float* mat, const float* light,
                       const float* spec, const RoundArgs* args,
                       cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!walk_ok(p_rows, resident_rows) || p_pad < p_rows ||
      (args->env_kind != ENV_CONSTANT) != (ef != nullptr) ||
      (args->medium != 0) != (mf != nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch(*args, LaunchShadeSweep{u, state, ef, mf, k2, n, sweep,
                                          p_rows, resident_rows, prim, p_pad,
                                          mat, light, spec, *args, stream});
}

// K1: src [>= row0 + 6, n] (rays in rows row0 .. row0 + 5, alive flag in
// row alive_row), sweep [p_rows, 16] (as K12's) -> out [8, n]
int sweep_closest_rows_launch(const float* src, int row0, int alive_row,
                              const float* sweep, int p_rows,
                              int resident_rows, float* out, int n,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!walk_ok(p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  const int smem = walk::shared_bytes(p_rows, resident_rows);
  int rc = walk::allow_shared((const void*)sweep_closest_rows_kernel, smem);
  if (rc != 0) return rc;
  int grid = (n + BLOCK - 1) / BLOCK;
  sweep_closest_rows_kernel<<<grid, BLOCK, smem, stream>>>(
      src, row0, alive_row, sweep, p_rows, resident_rows, out, n);
  return (int)cudaGetLastError();
}

// K3: src (rays in rows row0 .. row0 + 5, tmax in row tmax_row, the lanes
// to sweep flagged in row live_row, or live_row < 0 for all), sweep
// [p_rows, 16] (as K34's) -> out [1, n]
int sweep_any_rows_launch(const float* src, int row0, int tmax_row,
                          int live_row, const float* sweep, int p_rows,
                          int resident_rows, float* out, int n,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!walk_ok(p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  const int smem = walk::shared_bytes(p_rows, resident_rows);
  int rc = walk::allow_shared((const void*)sweep_any_rows_kernel, smem);
  if (rc != 0) return rc;
  int grid = (n + BLOCK - 1) / BLOCK;
  sweep_any_rows_kernel<<<grid, BLOCK, smem, stream>>>(
      src, row0, tmax_row, live_row, sweep, p_rows, resident_rows, out, n);
  return (int)cudaGetLastError();
}

// K2: u [n_u_rows(ls, medium), n], state [32, n], tp [8, n], ef and mf as
// K12's, tf [tf_rows(C), n] or null -> k2 [k2_rows(ls), n]
int shade_launch(const float* u, const float* state, const float* tp,
                 const float* ef, const float* tf, const float* mf, float* k2,
                 int n, const float* prim, int p_pad, const float* mat,
                 const float* light, const float* spec, const RoundArgs* args,
                 cudaStream_t stream) {
  if (n <= 0) return 0;
  if ((args->env_kind != ENV_CONSTANT) != (ef != nullptr) ||
      (args->medium != 0) != (mf != nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch(*args, LaunchShade{u, state, tp, ef, tf, mf, k2, n, prim,
                                     p_pad, mat, light, spec, *args, stream});
}

// K34: u [8, n], state [32, n], k2 [k2_rows(ls), n], sweep [p_rows, 16]
// (as K12's) -> out [40, n]
int finalize_sweep_launch(const float* u, const float* state, const float* k2,
                          float* out, int n, const float* sweep, int p_rows,
                          int resident_rows, const RoundArgs* args,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!walk_ok(p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  return dispatch(*args,
                  LaunchFinalizeSweep{u, state, k2, out, n, sweep, p_rows,
                                      resident_rows, *args, stream});
}

// K4: u [8, n], state [32, n], k2 [k2_rows(ls), n], blk [ls, n] (null only
// for ls = 0) -> out [40, n]
int finalize_launch(const float* u, const float* state, const float* k2,
                    const float* blk, float* out, int n,
                    const RoundArgs* args, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (args->light_samples > 0 && blk == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch(*args,
                  LaunchFinalize{u, state, k2, blk, out, n, *args, stream});
}

// registers per thread and local (spill) bytes of K12 (which 0), K34 (1),
// K2 (2) or K4 (4) at C lanes (+ 8: the medium instantiation), or of K1 (3)
// or K3 (5)
int two_prog_attrs(int which, int c, int* regs, int* local_bytes) {
  const int k = which & 7;
  const void* fn = nullptr;
  if (k == 3) {
    fn = (const void*)sweep_closest_rows_kernel;
  } else if (k == 5) {
    fn = (const void*)sweep_any_rows_kernel;
  } else {
    RoundArgs a{};
    a.c_lanes = c;
    a.medium = (which & 8) ? 1 : 0;
    int rc = dispatch(a, KernelOf{k, &fn});
    if (rc != 0) return rc;
  }
  return attrs(fn, regs, local_bytes);
}

// the shared memory of one block of K12 (which 0), K34 (1) or K2 (2; + 8:
// the medium instantiation) at C lanes, or of K1 (3) or K3 (5; c unread),
// walking a table of p_rows rows (K2 walks none): its static bytes, the
// dynamic bytes the launcher asks for, and the blocks of it one SM holds at
// once
int walk_shared_bytes(int which, int c, int p_rows, int resident_rows,
                      int* static_bytes, int* dynamic_bytes,
                      int* blocks_per_sm) {
  const int k = which & 7;
  if (k == 4 || k > 5 || !walk_ok(p_rows, resident_rows))
    return (int)cudaErrorInvalidValue;
  const void* fn = k == 3 ? (const void*)sweep_closest_rows_kernel
                          : (const void*)sweep_any_rows_kernel;
  if (k < 3) {
    RoundArgs a{};
    a.c_lanes = c;
    a.medium = (which & 8) ? 1 : 0;
    int rc = dispatch(a, KernelOf{k, &fn});
    if (rc != 0) return rc;
  }
  *dynamic_bytes = k == 2 ? 0 : walk::shared_bytes(p_rows, resident_rows);
  return walk::occupancy(fn, BLOCK, *dynamic_bytes, static_bytes,
                         blocks_per_sm);
}

// sizeof(RoundArgs), for the caller's check of its mirror of the struct
int round_args_size() { return (int)sizeof(RoundArgs); }

}  // extern "C"
