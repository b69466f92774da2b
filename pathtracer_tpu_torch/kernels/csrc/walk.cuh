// The table walks of the kernels designed for the H100: K12, K34, K1 and K3
// (two_prog_round.cu), the fused round (fused_round.cu), K12-LT and K34-LT
// v2 and v1 (lt_round.cu), and the dense closest-hit and any-hit sweeps of
// World.intersect / intersect_any (dense_sweep.cu). A compact baked sweep
// table in shared memory, brought there by the TMA unit's asynchronous bulk
// copies, and a walk that computes what depends only on the ray once per ray
// and what depends only on the prim once per scene.
//
// The table is kernels/dense.py:pack_sweep_np's f32[P_pad, 16]: 64-byte
// rows of ptype, valid, pa[3], pb[3], pc[3], and for a rect its unit normal
// n[3], bb and cc (zeros for other prims). Every f32 expression below is
// the plain twin's (kernels/dense.py:chunk_t) with its operands, order and
// rounding (the library is built with --fmad=false and IEEE divide and
// sqrt), so a walk returns the twin's bits; the twin, torch on the card, is
// the independent check of every walk.
// What is not in the per-prim loop here:
//   - the triangle test's axis permutation, sheared direction, 1/dz and the
//     permuted origin are RayTerms of the ray; the prim's vertices are
//     fetched in permuted order by indexed shared-memory loads (a selection,
//     as the twin's select chains are);
//   - the sphere test's a = d.d and 1/a are RayTerms too;
//   - the rect test's normal, bb and cc come from the row: the bake computed
//     them by the twin's expressions (there a cross product, a sqrt and
//     three divides of every test);
//   - the triangle test's divide runs only where the ray passes inside the
//     three edges (t is read nowhere else), so a warp whose lanes all miss a
//     row skips it; triangles come first in the branch on the row's type.
// What bounds the walks: instruction issue. A triangle row costs about 58
// instructions (9 of them shared-memory loads) against the 41 f32
// operations the bound counts, and nothing contracts to an FMA (see the
// note in two_prog_round.cu), so twice the bound by operations is the floor.
// Staging: a table of at most `resident_rows` rows is copied whole into the
// block's shared memory (dynamic; the fused round's table of at most 128
// rows into a static array) by one cp.async.bulk that completes on an
// mbarrier, once per block, and every walk of the block reads it there; the
// exit test of an any-hit walk is then per warp. A larger table cycles
// through a ring of RING_STAGES tiles of RING_ROWS rows: one elected thread
// keeps RING_STAGES - 1 bulk copies in flight ahead of the tile the block
// tests, each completing on its stage's mbarrier, and one block barrier a
// tile both frees the stage last tested and takes the block's vote on going
// on (an any-hit walk stops asking for tiles when no ray of the block is
// unresolved; the copies still in flight are waited for before the ring is
// used again or the block exits).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

namespace walk {

using pt::V3;

constexpr int ROW = 16;         // floats per row (64 B)
constexpr int RING_ROWS = 128;  // rows per ring tile (8 KB)
constexpr int RING_STAGES = 3;
constexpr int MAX_RESIDENT_ROWS = 3584;  // 224 KB of the 227 KB a block gets
constexpr float T_MIN = 1e-6f;  // INTERSECTION_TIME_OFFSET
constexpr float RAY_TMAX = 1e9f;

// dynamic shared memory of a block for a table of `rows` rows
__host__ __device__ inline int shared_bytes(int rows, int resident_rows) {
  return (rows <= resident_rows ? rows : RING_STAGES * RING_ROWS) * ROW * 4;
}

// a table the walks take: up to max_rows rows, 32 to a chunk, resident up
// to what one block's shared memory holds
inline bool table_ok(int rows, int max_rows, int resident_rows) {
  return rows > 0 && rows <= max_rows && rows % 32 == 0 &&
         resident_rows >= 0 && resident_rows <= MAX_RESIDENT_ROWS;
}

// a kernel that asks for more than 48 KB of dynamic shared memory must be
// allowed it first; the attribute stays set on the function
inline int allow_shared(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the shared memory of one block of kernel `fn` (`block` threads) that
// asks for `dynamic_bytes`: its static bytes, and the blocks of it one SM
// holds at once
inline int occupancy(const void* fn, int block, int dynamic_bytes,
                     int* static_bytes, int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  *static_bytes = (int)fa.sharedSizeBytes;
  int rc = allow_shared(fn, dynamic_bytes);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, block, (size_t)dynamic_bytes);
}

// ------------------------------------------------------------ ray terms

// what the prim tests need of the ray alone
struct RayTerms {
  V3 o, d;
  int kx, ky, kz;       // the triangle test's cyclic axis permutation
  float okx, oky, okz;  // the origin, permuted
  float sx, sy, inv_dz;  // the shear
  float a, inv_a;       // the sphere test's d.d and its guarded reciprocal
};

PT_DEV RayTerms ray_terms(V3 o, V3 d) {
  RayTerms q;
  q.o = o;
  q.d = d;
  float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  bool kz_x = (ax > ay) && (ax > az);
  bool kz_y = !kz_x && (ay > az);
  // (kx, ky, kz) = kz_x ? (y, z, x) : kz_y ? (z, x, y) : (x, y, z)
  q.kx = kz_x ? 1 : (kz_y ? 2 : 0);
  q.ky = kz_x ? 2 : (kz_y ? 0 : 1);
  q.kz = kz_x ? 0 : (kz_y ? 1 : 2);
  float dx_ = kz_x ? d.y : (kz_y ? d.z : d.x);
  float dy_ = kz_x ? d.z : (kz_y ? d.x : d.y);
  float dz_ = kz_x ? d.x : (kz_y ? d.y : d.z);
  q.okx = kz_x ? o.y : (kz_y ? o.z : o.x);
  q.oky = kz_x ? o.z : (kz_y ? o.x : o.y);
  q.okz = kz_x ? o.x : (kz_y ? o.y : o.z);
  q.inv_dz = 1.0f / (fabsf(dz_) > 1e-30f ? dz_ : 1.0f);
  q.sx = -dx_ * q.inv_dz;
  q.sy = -dy_ * q.inv_dz;
  q.a = d.x * d.x + d.y * d.y + d.z * d.z;
  q.inv_a = 1.0f / pt::maxf(q.a, 1e-20f);
  return q;
}

// ----------------------------------------------------------- prim tests
// t of the ray against the prim of row r (INFINITY = miss); the row is
// valid and of the test's type

PT_DEV float triangle_t(const float* r, const RayTerms& q, float t_min,
                        float t_max) {
  float p0x = r[2 + q.kx] - q.okx, p0y = r[2 + q.ky] - q.oky,
        p0z = r[2 + q.kz] - q.okz;
  float p1x = r[5 + q.kx] - q.okx, p1y = r[5 + q.ky] - q.oky,
        p1z = r[5 + q.kz] - q.okz;
  float p2x = r[8 + q.kx] - q.okx, p2y = r[8 + q.ky] - q.oky,
        p2z = r[8 + q.kz] - q.okz;
  float x0 = p0x + q.sx * p0z, y0 = p0y + q.sy * p0z, z0 = p0z * q.inv_dz;
  float x1 = p1x + q.sx * p1z, y1 = p1y + q.sy * p1z, z1 = p1z * q.inv_dz;
  float x2 = p2x + q.sx * p2z, y2 = p2y + q.sy * p2z, z2 = p2z * q.inv_dz;
  float e0 = x1 * y2 - y1 * x2;
  float e1 = x2 * y0 - y2 * x0;
  float e2 = x0 * y1 - y0 * x1;
  float det = e0 + e1 + e2;
  bool inside = !(((e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f)) &&
                  ((e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f)));
  // the divide only where the ray passes inside the edges (t is read
  // nowhere else): most rows miss, and a warp whose lanes all miss skips it
  if (!(inside && fabsf(det) > 1e-30f)) return INFINITY;
  float t_scaled = e0 * z0 + e1 * z1 + e2 * z2;
  float t = t_scaled / det;
  return (t > t_min && t < t_max) ? t : INFINITY;
}

PT_DEV float sphere_t(const float* r, const RayTerms& q, float t_min,
                      float t_max) {
  float ocx = q.o.x - r[2], ocy = q.o.y - r[3], ocz = q.o.z - r[4];
  float half_b = ocx * q.d.x + ocy * q.d.y + ocz * q.d.z;
  float rad = r[5];
  float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float disc = half_b * half_b - q.a * c;
  float sq = sqrtf(pt::maxf(disc, 0.0f));
  float t0 = (-half_b - sq) * q.inv_a;
  float t1 = (-half_b + sq) * q.inv_a;
  if (disc > 0.0f && t0 > t_min && t0 < t_max) return t0;
  if (disc > 0.0f && t1 > t_min && t1 < t_max) return t1;
  return INFINITY;
}

PT_DEV float rect_t(const float* r, const RayTerms& q, float t_min,
                    float t_max) {
  float pax = r[2], pay = r[3], paz = r[4];
  float pbx = r[5], pby = r[6], pbz = r[7];
  float pcx = r[8], pcy = r[9], pcz = r[10];
  float nx = r[11], ny = r[12], nz = r[13], bb = r[14], cc = r[15];
  float denom = q.d.x * nx + q.d.y * ny + q.d.z * nz;
  bool dok = fabsf(denom) > 1e-12f;
  float t = ((pax - q.o.x) * nx + (pay - q.o.y) * ny + (paz - q.o.z) * nz) /
            (dok ? denom : 1.0f);
  float rx = q.o.x + t * q.d.x - pax;
  float ry = q.o.y + t * q.d.y - pay;
  float rz = q.o.z + t * q.d.z - paz;
  float ra = (rx * pbx + ry * pby + rz * pbz) / bb;
  float rb = (rx * pcx + ry * pcy + rz * pcz) / cc;
  bool ok = dok && fabsf(ra) <= 1.0f && fabsf(rb) <= 1.0f && t > t_min &&
            t < t_max;
  return ok ? t : INFINITY;
}

PT_DEV float disk_t(const float* r, const RayTerms& q, float t_min,
                    float t_max) {
  float pax = r[2], pay = r[3], paz = r[4];
  float pbx = r[5], pby = r[6], pbz = r[7];
  float denom = q.d.x * pbx + q.d.y * pby + q.d.z * pbz;
  bool dok = fabsf(denom) > 1e-12f;
  float t = ((pax - q.o.x) * pbx + (pay - q.o.y) * pby + (paz - q.o.z) * pbz) /
            (dok ? denom : 1.0f);
  float qx = q.o.x + t * q.d.x - pax;
  float qy = q.o.y + t * q.d.y - pay;
  float qz = q.o.z + t * q.d.z - paz;
  float r2 = qx * qx + qy * qy + qz * qz;
  float rad = r[8];
  bool ok = dok && r2 <= rad * rad && t > t_min && t < t_max;
  return ok ? t : INFINITY;
}

// t of NR rays against the prim of row r: the row's type is the same for
// every thread, so the branch on it never diverges, and the NR tests of a
// type are independent work in flight together
template <int NR>
PT_DEV void row_t(const float* r, const RayTerms* q, float t_min,
                  const float* t_max, float* t) {
  const float2 head = *reinterpret_cast<const float2*>(r);  // ptype, valid
  const int ptype = (int)head.x;
  if (!(head.y > 0.5f)) {
#pragma unroll
    for (int j = 0; j < NR; ++j) t[j] = INFINITY;
  } else if ((unsigned)(ptype - pt::PRIM_SPHERE) > 2u) {
    // PRIM_TRIANGLE, and any code that is no other type's, as the twin's
    // chain does; first, for most rows are triangles
#pragma unroll
    for (int j = 0; j < NR; ++j) t[j] = triangle_t(r, q[j], t_min, t_max[j]);
  } else if (ptype == pt::PRIM_SPHERE) {
#pragma unroll
    for (int j = 0; j < NR; ++j) t[j] = sphere_t(r, q[j], t_min, t_max[j]);
  } else if (ptype == pt::PRIM_RECT) {
#pragma unroll
    for (int j = 0; j < NR; ++j) t[j] = rect_t(r, q[j], t_min, t_max[j]);
  } else {
#pragma unroll
    for (int j = 0; j < NR; ++j) t[j] = disk_t(r, q[j], t_min, t_max[j]);
  }
}

// ------------------------------------------- mbarriers and the bulk copy

PT_DEV uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

PT_DEV void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of copies to come
PT_DEV void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the phase of the given parity to complete. A copy lands within
// microseconds; a wait that has not ended after 2^24 tries is a broken
// protocol, and traps instead of hanging the card
PT_DEV void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  for (int tries = 0; tries < (1 << 24); ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// global -> shared, `bytes` a multiple of 16 and both addresses 16-byte
// aligned; completes on `bar`
PT_DEV void bulk_copy(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------- table

// a block's view of the sweep table; every thread of the block holds one
// and makes the same calls in the same order
struct Table {
  const float* tab;  // [rows, 16] in device memory
  int rows;
  bool resident;
  float* smem;     // shared memory, shared_bytes(rows, ...) of it
  uint64_t* bars;  // RING_STAGES mbarriers (the resident table's: bars[0])
  uint32_t phase;  // bit s: the parity of stage s's next wait
};

// set the barriers up and, for a resident table, start its one copy; every
// thread of the block calls it, once, before any walk. `walks` (the same for
// the whole block) says that at least one walk follows: the copy is started
// only then, because only a walk waits for it, and a block must not exit
// with a copy in flight into shared memory that the next block reuses
PT_DEV Table open_table(const float* __restrict__ tab, int rows,
                        int resident_rows, bool walks, float* smem,
                        uint64_t* bars) {
  Table T{tab, rows, rows <= resident_rows, smem, bars, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (T.resident && walks && threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)rows * ROW * 4;
    mbar_expect(&bars[0], bytes);
    bulk_copy(smem, tab, bytes, &bars[0]);
  }
  return T;
}

// thread 0: start the copy of ring tile k into its stage
PT_DEV void ring_issue(const Table& T, int k) {
  const int s = k % RING_STAGES;
  const int row0 = k * RING_ROWS;
  const uint32_t bytes = (uint32_t)min(RING_ROWS, T.rows - row0) * ROW * 4;
  // the stage was read through the generic proxy; order those reads before
  // the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(&T.bars[s], bytes);
  bulk_copy(T.smem + s * RING_ROWS * ROW, T.tab + (size_t)row0 * ROW, bytes,
            &T.bars[s]);
}

PT_DEV void ring_wait(Table& T, int k) {
  const int s = k % RING_STAGES;
  mbar_wait(&T.bars[s], (T.phase >> s) & 1u);
  T.phase ^= 1u << s;
}

// body(rows_in_shared_memory, first_row, row_count) over the whole table.
// Resident: one call. Ring: one call a tile while `pending()` holds for
// some thread of the block; a thread with nothing to test passes through
// the barriers all the same. Every thread of the block must call this.
template <typename Pending, typename Body>
PT_DEV void for_tiles(Table& T, Pending pending, Body body) {
  if (T.resident) {
    mbar_wait(&T.bars[0], 0u);
    body(T.smem, 0, T.rows);
    return;
  }
  const int n_tiles = (T.rows + RING_ROWS - 1) / RING_ROWS;
  // the block is done with the ring's previous walk, and wants this one
  if (!__syncthreads_or(pending())) return;
  if (threadIdx.x == 0)
    for (int k = 0; k < min(RING_STAGES, n_tiles); ++k) ring_issue(T, k);
  int k = 0;
  for (; k < n_tiles; ++k) {
    if (k > 0) {
      // every thread is done with tile k - 1: its stage is free
      if (!__syncthreads_or(pending())) break;
      if (threadIdx.x == 0 && k - 1 + RING_STAGES < n_tiles)
        ring_issue(T, k - 1 + RING_STAGES);
    }
    ring_wait(T, k);
    body(T.smem + (k % RING_STAGES) * RING_ROWS * ROW, k * RING_ROWS,
         min(RING_ROWS, T.rows - k * RING_ROWS));
  }
  // after an early exit, the copies still in flight
  for (int j = k; j < min(n_tiles, k + RING_STAGES - 1); ++j) ring_wait(T, j);
}

// ---------------------------------------------------------------- walks

// the closest hit of a live lane's ray in (t_min, t_max) over the table:
// ids rise with the rows, so strict '<' keeps the lowest id among equal t.
// A miss leaves t_hit = inf, pid = -1
PT_DEV void closest(Table& T, bool live, V3 o, V3 d, float t_min,
                    float t_max, float* t_hit, int* pid) {
  const RayTerms q = ray_terms(o, d);
  float best_t = INFINITY;
  int best_id = -1;
  for_tiles(
      T, [&]() { return live; },
      [&](const float* rows, int row0, int cnt) {
        if (!live) return;
        // two rows a turn: their tests are independent until the compares
#pragma unroll 2
        for (int i = 0; i < cnt; ++i) {
          float t;
          row_t<1>(rows + i * ROW, &q, t_min, &t_max, &t);
          if (t < best_t) {
            best_t = t;
            best_id = row0 + i;
          }
        }
      });
  *t_hit = best_t;
  *pid = best_id;
}

// the same in the round kernels' bounds, (T_MIN, RAY_TMAX)
PT_DEV void closest(Table& T, bool live, V3 o, V3 d, float* t_hit, int* pid) {
  closest(T, live, o, d, T_MIN, RAY_TMAX, t_hit, pid);
}

// whether anything blocks each of a lane's NR shadow rays (so[j], sd[j]) in
// (t_min, tmax[j]), for the rays with want[j]: every row read from shared
// memory is tested against all NR rays before the next, and a warp leaves
// the rows when none of its lanes has a wanted ray unresolved
template <int NR>
PT_DEV void any_hit(Table& T, const bool* want, const V3* so, const V3* sd,
                    float t_min, const float* tmax, bool* blocked) {
  RayTerms q[NR];
  bool unres[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    q[j] = ray_terms(so[j], sd[j]);
    unres[j] = want[j];
  }
  auto pending = [&]() {
    bool p = false;
#pragma unroll
    for (int j = 0; j < NR; ++j) p = p || unres[j];
    return p;
  };
  for_tiles(T, pending, [&](const float* rows, int row0, int cnt) {
#pragma unroll 1
    for (int i = 0; i < cnt; ++i) {
      if (!__any_sync(0xffffffffu, pending())) break;
      float t[NR];
      row_t<NR>(rows + i * ROW, q, t_min, tmax, t);
#pragma unroll
      for (int j = 0; j < NR; ++j) unres[j] = unres[j] && !(t[j] < INFINITY);
    }
  });
#pragma unroll
  for (int j = 0; j < NR; ++j) blocked[j] = want[j] && !unres[j];
}

// the same from the round kernels' T_MIN
template <int NR>
PT_DEV void any_hit(Table& T, const bool* want, const V3* so, const V3* sd,
                    const float* tmax, bool* blocked) {
  any_hit<NR>(T, want, so, sd, T_MIN, tmax, blocked);
}

}  // namespace walk
