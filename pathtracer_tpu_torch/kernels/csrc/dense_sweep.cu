// Dense ray × primitive sweep: closest hit and any hit, the queries of
// World.intersect / intersect_any (geometry/soa.py).
//
// Replaces pathtracer_tpu/kernels/dense.py:_sweep_closest (_closest_kernel)
// and _sweep_any (_any_kernel), Pallas kernels that held the packed table
// in VMEM and swept 8-prim sublane blocks against 512-ray lane tiles.
//
// On the H100 one thread traces one ray, read from the [8, n] ray rows
// (origin, direction, t_min, t_max), over the compact sweep table
// (kernels/dense.py:pack_sweep_np, World.sweep_tab) through walk.cuh, as K1
// and K3 walk it: the table resident in the block's shared memory up to the
// residency budget (one bulk copy a block), through the ring of tiles above
// it; the ray's permutation, shear and reciprocals once per ray, a rect's
// normal and edge norms from the row. The any-hit walk leaves the rows per
// warp once no lane has its ray unresolved, and skips the lanes whose
// verdict nothing reads (the `live` flags, where given): they read 0. Every
// thread of a block reaches the walk, a lane past n or with nothing to
// sweep passing live / want = false (open_table's barrier, the ring's
// block votes, the any-hit walk's warp vote). Unlike the round kernels
// these take any table an int row count and an f32 id hold: the regen
// integrator answers the scenes that the megakernel gate refuses, more than
// 8192 prims among them.
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

using pt::V3;

constexpr int BLOCK = 128;
// the ids go out as f32, exact up to 2^24
constexpr int MAX_ROWS = 1 << 24;

__device__ __forceinline__ void load_ray(const float* __restrict__ rays,
                                         size_t N, int i, V3* o, V3* d,
                                         float* t_min, float* t_max) {
  *o = V3{rays[i], rays[N + i], rays[2 * N + i]};
  *d = V3{rays[3 * N + i], rays[4 * N + i], rays[5 * N + i]};
  *t_min = rays[6 * N + i];
  *t_max = rays[7 * N + i];
}

// out [2, n]: t (inf on a miss), prim id (-1 on a miss)
__global__ void __launch_bounds__(BLOCK) dense_closest_kernel(
    const float* __restrict__ rays, int n, const float* __restrict__ sweep,
    int p_rows, int resident_rows, float* __restrict__ out) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool live = i < n;
  V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  float t_min = 0.0f, t_max = 0.0f;
  if (live) load_ray(rays, N, i, &o, &d, &t_min, &t_max);
  float t_hit = INFINITY;
  int pid = -1;
  walk::closest(T, live, o, d, t_min, t_max, &t_hit, &pid);
  if (!live) return;
  out[i] = t_hit;
  out[N + i] = (float)pid;
}

// out [1, n]: 1 where something blocks the ray in (t_min, t_max); only the
// lanes with live[i] != 0 are swept (live null: all), the others read 0
__global__ void __launch_bounds__(BLOCK) dense_any_kernel(
    const float* __restrict__ rays, const unsigned char* __restrict__ live,
    int n, const float* __restrict__ sweep, int p_rows, int resident_rows,
    float* __restrict__ out) {
  extern __shared__ __align__(128) float walk_rows[];
  __shared__ uint64_t walk_bars[walk::RING_STAGES];
  walk::Table T = walk::open_table(sweep, p_rows, resident_rows, true,
                                   walk_rows, walk_bars);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t N = (size_t)n;
  const bool want = i < n && (live == nullptr || live[i] != 0);
  V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  float t_min = 0.0f, t_max = 0.0f;
  if (want) load_ray(rays, N, i, &o, &d, &t_min, &t_max);
  bool blocked;
  walk::any_hit<1>(T, &want, &o, &d, t_min, &t_max, &blocked);
  if (i < n) out[i] = blocked ? 1.0f : 0.0f;
}

bool table_ok(int p_rows, int resident_rows) {
  return walk::table_ok(p_rows, MAX_ROWS, resident_rows);
}

}  // namespace

extern "C" {

// rays [8, n] (o, d, t_min, t_max), sweep [p_rows, 16] resident in shared
// memory where p_rows <= resident_rows -> out [2, n] (t, id | -1).
// Returns a cudaError_t.
int dense_sweep_closest(const float* rays, int n, const float* sweep,
                        int p_rows, int resident_rows, float* out,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!table_ok(p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  const int smem = walk::shared_bytes(p_rows, resident_rows);
  int rc = walk::allow_shared((const void*)dense_closest_kernel, smem);
  if (rc != 0) return rc;
  const int grid = (n + BLOCK - 1) / BLOCK;
  dense_closest_kernel<<<grid, BLOCK, smem, stream>>>(
      rays, n, sweep, p_rows, resident_rows, out);
  return (int)cudaGetLastError();
}

// the same rays, live [n] (0: not swept, reads 0) or null (all swept), the
// same table -> out [1, n] 0/1 blocked mask
int dense_sweep_any(const float* rays, const unsigned char* live, int n,
                    const float* sweep, int p_rows, int resident_rows,
                    float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!table_ok(p_rows, resident_rows)) return (int)cudaErrorInvalidValue;
  const int smem = walk::shared_bytes(p_rows, resident_rows);
  int rc = walk::allow_shared((const void*)dense_any_kernel, smem);
  if (rc != 0) return rc;
  const int grid = (n + BLOCK - 1) / BLOCK;
  dense_any_kernel<<<grid, BLOCK, smem, stream>>>(
      rays, live, n, sweep, p_rows, resident_rows, out);
  return (int)cudaGetLastError();
}

// the closest-hit (which 0) or any-hit (1) kernel walking a table of p_rows
// rows: registers per thread, local (spill) bytes, static shared bytes, the
// dynamic bytes the launcher asks for, and the blocks of it one SM holds
int dense_sweep_attrs(int which, int p_rows, int resident_rows, int* regs,
                      int* local_bytes, int* static_bytes,
                      int* dynamic_bytes, int* blocks_per_sm) {
  if (which < 0 || which > 1 || !table_ok(p_rows, resident_rows))
    return (int)cudaErrorInvalidValue;
  const void* fn = which == 0 ? (const void*)dense_closest_kernel
                              : (const void*)dense_any_kernel;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *dynamic_bytes = walk::shared_bytes(p_rows, resident_rows);
  return walk::occupancy(fn, BLOCK, *dynamic_bytes, static_bytes,
                         blocks_per_sm);
}

const char* pt_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
