// The regen path tracer's whole bounce round in one kernel.
//
// Replaces pathtracer_tpu/kernels/megakernel.py:_step_fused, the Pallas call
// of _all_kernel (_all_kernel_body + _finalize_core): closest hit, emission
// and constant-environment adds with MIS, NEE with inline shadow sweeps,
// BSDF sampling with hero-wavelength spectral MIS, Russian roulette, XYZ
// accumulation on death and the thin-lens respawn.
//
// The per-lane device code is round_common.cuh, shared with the
// two-program round (two_prog_round.cu).
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

#include "round_common.cuh"

namespace {

using namespace rc;
using pt::V3;

constexpr int BLOCK = 128;
constexpr int MAX_DENSE_PRIMS = 128;  // 4 chunks of 32 (the fused gate)

template <int C>
__device__ __forceinline__ void fused_round_body(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ dense,
    int p_dense, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs& a) {
  __shared__ __align__(16) float prims[MAX_DENSE_PRIMS * pt::PRIM_FLOATS];
  pt::stage_prims(dense, 0, p_dense, prims);
  __syncthreads();
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  auto U = [&](int r) { return u[r * N + i]; };
  if (!(state[S_ALIVE * N + i] > 0.5f)) {
    pass_through(state, out, N, i);
    return;
  }
  const int ls = a.light_samples;
  Lane<C> L;
  load_lane<C>(state, N, i, a, L);

  // ---- closest hit straight off the live ray state
  float t_hit = INFINITY;
  int pid = -1;
  pt::sweep_closest_dev(prims, p_dense, 0, L.o, L.d, T_MIN, RAY_TMAX, &t_hit,
                        &pid);
  const bool hit = t_hit < INFINITY;
  const float kind = hit ? __ldg(prim + R_KIND * p_pad + pid) : 0.0f;
  const bool at_surface = hit && kind != 2.0f;
  if (!hit) escape_add<C>(L, spec, nullptr, N, i, a);

  // ---- surface interaction: emission, NEE with immediate shadow
  // resolution, BSDF sample, RR
  bool cp = false;
  float shadow_ct = 0.0f;
  float beta_next[C];
  Bounce<C> B{};
  if (at_surface) {
    Surface<C> S;
    surface_at<C>(L, prim, p_pad, pid, t_hit, kind, mat, spec, nullptr, N, i,
                  a, S);
    for (int si = 0; si < ls; ++si) {
      NeeSample<C> r;
      nee_sample<C>(L, S, si, U(3 * si), U(3 * si + 1), U(3 * si + 2), light,
                    spec, nullptr, N, i, a, r);
      if (!r.worth) continue;
      shadow_ct += 1.0f;
      if (pt::sweep_any_dev(prims, p_dense, r.so, r.dir, T_MIN, r.tmax))
        continue;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) L.rad[ci] = L.rad[ci] + r.contrib[ci];
    }
    bsdf_sample<C>(S, U(3 * ls), U(3 * ls + 1), U(3 * ls + 2), a, B);
    cp = continue_path<C>(L, B, U(3 * ls + 3), a, beta_next);
  }

  // ---- death -> XYZ accumulate, respawn, write-out
  finalize_write<C>(state, u, out, N, i, L, L.rad, cp, beta_next, B,
                    3 * ls + 3, a, shadow_ct, hit ? 0.0f : 1.0f);
}

__global__ void __launch_bounds__(BLOCK) fused_round_kernel1(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ dense,
    int p_dense, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs a) {
  fused_round_body<1>(u, state, out, n, dense, p_dense, prim, p_pad, mat,
                      light, spec, a);
}

// C = 4: at least 4 blocks of 128 threads an SM, which caps the kernel at
// 128 registers (a few spill bytes; measured faster than the 152 registers
// and 3 blocks an SM it takes unbounded). C = 1 stays unbounded: the same
// bound costs it 4 registers and 10%.
__global__ void __launch_bounds__(BLOCK, 4) fused_round_kernel4(
    const float* __restrict__ u, const float* __restrict__ state,
    float* __restrict__ out, int n, const float* __restrict__ dense,
    int p_dense, const float* __restrict__ prim, int p_pad,
    const float* __restrict__ mat, const float* __restrict__ light,
    const float* __restrict__ spec, const RoundArgs a) {
  fused_round_body<4>(u, state, out, n, dense, p_dense, prim, p_pad, mat,
                      light, spec, a);
}

template <int C>
int launch(const float* u, const float* state, float* out, int n,
           const float* dense, int p_dense, const float* prim, int p_pad,
           const float* mat, const float* light, const float* spec,
           const RoundArgs& a, cudaStream_t stream) {
  int grid = (n + BLOCK - 1) / BLOCK;
  auto kernel = C == 1 ? fused_round_kernel1 : fused_round_kernel4;
  kernel<<<grid, BLOCK, 0, stream>>>(u, state, out, n, dense, p_dense, prim,
                                     p_pad, mat, light, spec, a);
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

// registers per thread and local (spill) bytes of the C-lane kernel
int fused_round_attrs(int c, int* regs, int* local_bytes) {
  cudaFuncAttributes fa;
  cudaError_t err = c == 1 ? cudaFuncGetAttributes(&fa, fused_round_kernel1)
                           : cudaFuncGetAttributes(&fa, fused_round_kernel4);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

}  // extern "C"
