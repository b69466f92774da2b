// Dense ray × primitive sweep: closest hit and any hit.
//
// Replaces pathtracer_tpu/kernels/dense.py:_sweep_closest (_closest_kernel)
// and _sweep_any (_any_kernel), Pallas kernels that held the packed table
// in VMEM and swept 8-prim sublane blocks against 512-ray lane tiles.
//
// On the H100 one thread traces one ray through every prim in order. The
// bound is arithmetic and the table read: each ray does ~60 flops per prim
// and re-reads every prim record, so the table is staged through shared
// memory in tiles of TILE_P prims (48 KB), read by all threads of the block,
// instead of once per thread from device memory. Rays are read and results
// written once, coalesced ([8, N] and [k, N] rows). Divergence between prim
// types is low because the scene bake sorts prims by type.
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int TILE_P = 1024;  // 1024 prims x 12 floats = 48 KB of shared memory

template <bool CLOSEST>
__global__ void __launch_bounds__(BLOCK)
    sweep_kernel(const float* __restrict__ rays, const float* __restrict__ tab,
                 int n, int p_rows, float* __restrict__ out) {
  __shared__ __align__(16) float prims[TILE_P * pt::PRIM_FLOATS];
  int i = blockIdx.x * BLOCK + threadIdx.x;
  bool live = i < n;
  pt::V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  float t_min = 0.f, t_max = 0.f;
  if (live) {
    o = pt::V3{rays[i], rays[n + i], rays[2 * n + i]};
    d = pt::V3{rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
    t_min = rays[6 * n + i];
    t_max = rays[7 * n + i];
  }
  float best_t = INFINITY;
  int best_id = -1;
  bool blocked = false;
  // every thread walks every tile (the syncs need the whole block)
  for (int p0 = 0; p0 < p_rows; p0 += TILE_P) {
    int cnt = min(TILE_P, p_rows - p0);
    __syncthreads();
    pt::stage_prims(tab, p0, cnt, prims);
    __syncthreads();
    if (!live) continue;
    if (CLOSEST) {
      pt::sweep_closest_dev(prims, cnt, p0, o, d, t_min, t_max, &best_t,
                            &best_id);
    } else if (!blocked) {
      blocked = pt::sweep_any_dev(prims, cnt, o, d, t_min, t_max);
    }
  }
  if (!live) return;
  if (CLOSEST) {
    out[i] = best_t;
    out[n + i] = best_t < INFINITY ? (float)best_id : -1.0f;
  } else {
    out[i] = blocked ? 1.0f : 0.0f;
  }
}

template <bool CLOSEST>
int launch(const float* rays, const float* tab, int n, int p_rows, float* out,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  int grid = (n + BLOCK - 1) / BLOCK;
  sweep_kernel<CLOSEST><<<grid, BLOCK, 0, stream>>>(rays, tab, n, p_rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rays [8, n] (o, d, tmin, tmax), tab [p_rows, 128] -> out [2, n] (t, id|-1)
int dense_sweep_closest(const float* rays, const float* tab, int n,
                        int p_rows, float* out, cudaStream_t stream) {
  return launch<true>(rays, tab, n, p_rows, out, stream);
}

// same -> out [1, n] 0/1 blocked mask
int dense_sweep_any(const float* rays, const float* tab, int n, int p_rows,
                    float* out, cudaStream_t stream) {
  return launch<false>(rays, tab, n, p_rows, out, stream);
}

const char* pt_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
