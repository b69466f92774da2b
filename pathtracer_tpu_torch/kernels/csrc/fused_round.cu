// The regen path tracer's whole bounce round in one kernel.
//
// Replaces pathtracer_tpu/kernels/megakernel.py:_step_fused, the Pallas call
// of _all_kernel (_all_kernel_body + _finalize_core): closest hit, emission
// and constant-environment adds with MIS, NEE with inline shadow sweeps,
// BSDF sampling with hero-wavelength spectral MIS, Russian roulette, XYZ
// accumulation on death and the thin-lens respawn.
//
// The per-lane device code is round_common.cuh, shared with the
// two-program round (two_prog_round.cu); the table walks are walk.cuh's,
// shared with K12 and K34.
//
// One thread runs one lane. What bounds it on the H100: instruction issue,
// in the walks and in the shading. A live lane walks the table three times
// (its closest hit, then its two NEE samples' shadow rays) over at most 128
// rows, and shades, against about 350 B of memory traffic (32 state rows
// and up to 16 uniform rows read, 40 rows written); with C = 4 spectral
// lanes the per-thread state is large, so registers bound the blocks an SM
// holds. The design:
//   - the compact baked sweep table (kernels/dense.py:pack_sweep_np, at
//     most 128 rows of 64 B: 8 KB) is copied into a static shared array by
//     one bulk copy on an mbarrier, issued once per block, and all three
//     walks read it there;
//   - the walks compute the ray's terms once per ray, not once per row, and
//     read a rect's normal and edge norms from its row (walk.cuh);
//   - each NEE sample's shadow ray is walked as soon as the sample is
//     drawn, and a warp leaves the rows when none of its lanes has its ray
//     unresolved; the contributions are added in sample order, as the
//     twin's are. One sample a walk, not two as in K34: the fused round
//     holds the lane's surface across its walks, and a second sample's
//     shadow ray, contribution and ray terms took it to 128 registers with
//     spills at both C. Measured (chip scene at 1080^2, light samples 2):
//     C = 1 0.517 ms one at a time (96 registers) against 0.583 in pairs
//     (128, 64 B of stack); C = 4 0.866 against 0.970 (128 registers,
//     104 B of stack against 288; tools/walk_bench.py);
//   - the walks take every thread of the block (a block barrier in
//     open_table, a warp vote in the any-hit walk), so a dead lane and a
//     lane past n walk with nothing to test, and branch off only after the
//     last walk: a dead lane is then a copy;
//   - the Pallas one-hot MXU fetches are plain indexed loads of the other
//     tables (read-only cache).
// Each thread touches only its own column of state (read) and out (write):
// the output is a second buffer.
#include <cuda_runtime.h>

#include "round_common.cuh"
#include "walk.cuh"

namespace {

using namespace rc;
using pt::V3;

constexpr int BLOCK = 128;
constexpr int MAX_ROWS = 128;  // 4 chunks of 32 (the fused gate)

// NEE sample si of one lane: its shadow ray (only at a surface), one walk
// of the table, then the contribution into the radiance if unblocked
template <int C>
__device__ __forceinline__ void nee_walk(
    walk::Table& T, bool at_surface, Lane<C>& L, const Surface<C>& S, int si,
    const float* __restrict__ u, size_t N, int i,
    const float* __restrict__ light, const float* __restrict__ spec,
    const RoundArgs& a, float* shadow_ct) {
  NeeSample<C> r;
  bool worth = false, blocked;
  V3 so{0.f, 0.f, 0.f}, sd{0.f, 0.f, 0.f};
  float tmax = 0.0f;
  if (at_surface) {
    nee_sample<C>(L, S, si, u[3 * si * N + i], u[(3 * si + 1) * N + i],
                  u[(3 * si + 2) * N + i], light, spec, nullptr, N, i, a, r);
    worth = r.worth;
    so = r.so;
    sd = r.dir;
    tmax = r.tmax;
  }
  walk::any_hit<1>(T, &worth, &so, &sd, &tmax, &blocked);
  if (!worth) return;
  *shadow_ct += 1.0f;
  if (blocked) return;
#pragma unroll
  for (int ci = 0; ci < C; ++ci) L.rad[ci] = L.rad[ci] + r.contrib[ci];
}

template <int C>
__device__ __forceinline__ void fused_round_body(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ sweep,
    int p_rows, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs& a) {
  __shared__ __align__(128) float walk_rows[MAX_ROWS * walk::ROW];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  // every thread opens the table and takes part in every walk
  walk::Table T = walk::open_table(sweep, p_rows, MAX_ROWS, true, walk_rows,
                                   walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool live = i < n && state[S_ALIVE * N + i] > 0.5f;
  const int ls = a.light_samples;
  Lane<C> L;
  V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  if (live) {
    load_lane<C>(state, N, i, a, L);
    o = L.o;
    d = L.d;
  }

  // ---- closest hit straight off the live ray state
  float t_hit = INFINITY;
  int pid = -1;
  walk::closest(T, live, o, d, &t_hit, &pid);
  const bool hit = live && t_hit < INFINITY;
  const float kind = hit ? __ldg(prim + R_KIND * p_pad + pid) : 0.0f;
  const bool at_surface = hit && kind != 2.0f;
  if (live && !hit) escape_add<C>(L, spec, nullptr, N, i, a);

  // ---- surface interaction: emission, then NEE with immediate shadow
  // resolution, one sample a walk
  Surface<C> S;
  if (at_surface)
    surface_at<C>(L, prim, p_pad, pid, t_hit, kind, mat, spec, nullptr, N, i,
                  a, S);
  float shadow_ct = 0.0f;
  for (int si = 0; si < ls; ++si)
    nee_walk<C>(T, at_surface, L, S, si, u, N, i, light, spec, a,
                &shadow_ct);
  if (i >= n) return;
  if (!live) {
    pass_through(state, out, N, i);
    return;
  }

  // ---- BSDF sample, RR, death -> XYZ accumulate, respawn, write-out
  auto U = [&](int r) { return u[r * N + i]; };
  bool cp = false;
  float beta_next[C];
  Bounce<C> B{};
  if (at_surface) {
    bsdf_sample<C>(S, U(3 * ls), U(3 * ls + 1), U(3 * ls + 2), a, B);
    cp = continue_path<C>(L, B, U(3 * ls + 3), a, beta_next);
  }
  finalize_write<C>(state, u, out, N, i, L, L.rad, cp, beta_next, B,
                    3 * ls + 3, a, shadow_ct, hit ? 0.0f : 1.0f);
}

__global__ void __launch_bounds__(BLOCK) fused_round_kernel1(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ sweep,
    int p_rows, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs a) {
  fused_round_body<1>(u, state, out, n, sweep, p_rows, prim, p_pad, mat,
                      light, spec, a);
}

// C = 4: at least 4 blocks of 128 threads an SM, which caps the kernel at
// 128 registers (104 B of stack): measured 0.866 ms on the chip scene at
// 1080^2 against 0.960 with the 148 registers and 3 blocks an SM it takes
// unbounded. C = 1 needs no bound: 96 registers, 5 blocks an SM.
__global__ void __launch_bounds__(BLOCK, 4) fused_round_kernel4(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ sweep,
    int p_rows, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs a) {
  fused_round_body<4>(u, state, out, n, sweep, p_rows, prim, p_pad, mat,
                      light, spec, a);
}

const void* kernel_of(int c) {
  return c == 1 ? (const void*)fused_round_kernel1
                : (const void*)fused_round_kernel4;
}

}  // namespace

extern "C" {

// u [nu, n], state [32, n] -> out [40, n]; tables as baked by
// kernels/megakernel.py:build_mega_scene, sweep [p_rows, 16] its compact
// sweep table (at most 128 rows). Returns a cudaError_t.
int fused_round_launch(const float* u, int nu, const float* state, float* out,
                       int n, const float* sweep, int p_rows,
                       const float* prim, int p_pad, const float* mat,
                       const float* light, const float* spec, int spec_rows,
                       const RoundArgs* args, cudaStream_t stream) {
  (void)nu;
  (void)spec_rows;
  if (n <= 0) return 0;
  if (!walk::table_ok(p_rows, MAX_ROWS, MAX_ROWS) || p_pad < p_rows)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  if (args->c_lanes == 1)
    fused_round_kernel1<<<grid, BLOCK, 0, stream>>>(
        u, state, out, n, sweep, p_rows, prim, p_pad, mat, light, spec,
        *args);
  else if (args->c_lanes == 4)
    fused_round_kernel4<<<grid, BLOCK, 0, stream>>>(
        u, state, out, n, sweep, p_rows, prim, p_pad, mat, light, spec,
        *args);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// registers per thread, local (spill) bytes, static shared bytes and the
// blocks one SM holds of the C-lane kernel
int fused_round_attrs(int c, int* regs, int* local_bytes, int* shared_bytes,
                      int* blocks_per_sm) {
  if (c != 1 && c != 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel_of(c));
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return walk::occupancy(kernel_of(c), BLOCK, 0, shared_bytes, blocks_per_sm);
}

}  // extern "C"
