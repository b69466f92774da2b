// The block-wide any-hit walk of the [P_pad, 128] dense table, K3's alone
// (two_prog_round.cu:sweep_any_rows_kernel, the split round's test route):
// every other round kernel walks the compact sweep table through walk.cuh,
// and K3's masks, equal to K34's verdicts lane for lane, hold the two walks
// to each other. The dense table is staged in shared-memory tiles of TILE_P
// prims (12 KB) that every thread of the block walks together, so every
// thread of the block must call it (the syncs need the whole block); a lane
// that has no ray passes `want` false.
#pragma once

#include "sweep.cuh"

namespace tiles {

using pt::V3;

constexpr int TILE_P = 256;  // prims per staged tile: 256 x 12 floats = 12 KB
constexpr float T_MIN = 1e-6f;  // INTERSECTION_TIME_OFFSET

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
