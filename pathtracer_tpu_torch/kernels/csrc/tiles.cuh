// The block-wide walks of the [P_pad, 128] dense table that K1 and K3
// (two_prog_round.cu) and K34-LT v2 and v1 (lt_round.cu) keep; K12, K34,
// the fused round and K12-LT walk the compact sweep table through walk.cuh.
// The dense table is staged in shared-memory tiles of TILE_P prims (12 KB)
// that every thread of the block walks together, so every thread of the
// block must call them (the syncs need the whole block); a lane that has no
// ray passes `live` false.
#pragma once

#include "sweep.cuh"

namespace tiles {

using pt::V3;

constexpr int TILE_P = 256;  // prims per staged tile: 256 x 12 floats = 12 KB
constexpr float T_MIN = 1e-6f;  // INTERSECTION_TIME_OFFSET
constexpr float RAY_TMAX = 1e9f;

// the closest hit of a live lane's ray (o, d) over the dense table; ids
// rise with the tiles, so strict '<' keeps the lowest id among equal t. A
// miss leaves t_hit = inf, pid = -1
__device__ __forceinline__ void closest_tiles(const float* __restrict__ dense,
                                              int p_dense, float* prims,
                                              bool live, V3 o, V3 d,
                                              float* t_hit, int* pid) {
  for (int p0 = 0; p0 < p_dense; p0 += TILE_P) {
    const int cnt = min(TILE_P, p_dense - p0);
    __syncthreads();
    pt::stage_prims(dense, p0, cnt, prims);
    __syncthreads();
    if (live)
      pt::sweep_closest_dev(prims, cnt, p0, o, d, T_MIN, RAY_TMAX, t_hit,
                            pid);
  }
}

// whether anything blocks a wanted shadow ray (so, sd) in (T_MIN, tmax);
// the walk stops as soon as no shadow ray of the block is unresolved
__device__ __forceinline__ bool any_hit_tiles(const float* __restrict__ dense,
                                              int p_dense, float* prims,
                                              bool want, V3 so, V3 sd,
                                              float tmax) {
  bool blocked = false;
  for (int p0 = 0; p0 < p_dense; p0 += TILE_P) {
    if (!__syncthreads_or(want && !blocked)) break;
    const int cnt = min(TILE_P, p_dense - p0);
    pt::stage_prims(dense, p0, cnt, prims);
    __syncthreads();
    if (want && !blocked)
      blocked = pt::sweep_any_dev(prims, cnt, so, sd, T_MIN, tmax);
  }
  return blocked;
}

}  // namespace tiles
