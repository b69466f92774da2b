// The prim type codes of the sweep tables (column 0 of a row), as the
// bake (kernels/dense.py:pack_prims_np, pack_sweep_np) writes them and
// pathtracer_tpu/kernels/dense.py:_chunk_t reads them. The ray × prim tests
// themselves are walk.cuh's; the plain twin (kernels/dense.py:chunk_t) is
// their independent check.
#pragma once

#include "cmath.cuh"

namespace pt {

constexpr int PRIM_TRIANGLE = 0, PRIM_SPHERE = 1, PRIM_RECT = 2, PRIM_DISK = 3;

}  // namespace pt
