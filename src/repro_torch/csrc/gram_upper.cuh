// The upper triangle of a Gram matrix A^T A over a range of rows, f32,
// shared by the xtx and segment_linregr kernels.  A is read in place:
//
//     A = [x | y]              (width k + 1; xtx)
//     A = [x m | y m | m]      (width k + 2; segment_linregr, m the 0/1
//                               validity of each row)
//
// xtx runs this routine only past K_NARROW (kernels/xtx/ops.py), where
// its operations bound it (k > 78 in f32 on the H100); narrower xtx runs
// csrc/xtx_narrow.cu, bound by bytes below k = 78, which gives every
// thread of a CTA rows of its own rather than a 176-column tile that
// would leave all but a few of 256 threads idle.  segment_linregr runs
// this routine at every width.
//
// Work plan.  A is cut into column tiles of 176 (22 blocks of 8).  A CTA
// of 256 threads takes one row range and one unit: the triangle of a
// tile (22 x 23 / 2 = 253 micro-tiles) or half of a tile pair ti < tj
// (11 x 22 = 242), each thread one 8 x 8 register micro-tile; micro-tiles
// past the width are skipped.  At k = 160 there is one tile and 231
// micro-tiles.  Each row of a micro-tile costs 4 LDS.128 for 64 FFMA:
// staged rows keep the first four columns of every 8-column block
// together, then the last four, so lanes reading neighbouring blocks
// read consecutive bytes.  Chunks of 32 rows are staged by cp.async into
// a two-stage ring, so the next chunk's copy overlaps this chunk's FFMA:
// 16-byte copies of x when k % 4 == 0 and x is 16-byte aligned (the
// caller checks), 4-byte copies otherwise; y, the ragged edge and rows
// past the range are 4-byte copies or zero fill.  For A = [x m | y m | m]
// each thread multiplies the elements it copied by their row's m, as the
// reference does (x * m, not a select), once its copies have landed, and
// writes the m column.
//
// Every entry is one f32 FMA chain over the rows in ascending order; the
// caller adds the ranges' partials in a fixed order and mirrors the
// triangle, so the Gram comes out deterministic and bitwise symmetric,
// and bitwise the plain version's on dyadic inputs.  No TF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace madlib {
namespace gram {

constexpr int MT = 8;                  // micro-tile edge
constexpr int NB = 22;                 // micro-tiles along a column tile
constexpr int TW = NB * MT;            // column tile of A: 176 columns
constexpr int HALF = NB / 2;           // micro-tile rows of a half unit
constexpr int THREADS = 256;           // >= NB (NB + 1) / 2 and HALF NB
constexpr int ROWS = 32;               // rows of A per staged chunk
constexpr int STAGES = 2;
static_assert(NB * (NB + 1) / 2 <= THREADS && HALF * NB <= THREADS,
              "a unit's micro-tiles fit the CTA");

// column tiles of a width-w A; a row range has tiles^2 units
__host__ __device__ inline int tiles_of(int w) { return (w + TW - 1) / TW; }

// shared memory of a CTA: the ring of staged chunks of one or two tiles,
// then each stage's row masks
__host__ inline int smem_bytes(int w) {
  return STAGES * ((tiles_of(w) > 1 ? 2 : 1) * ROWS * TW + ROWS) * 4;
}

// Unit u of T column tiles -> (ti, tj, half): for each ti in order, the
// triangle of tile ti (half = -1), then for each tj > ti the two halves
// (micro-tile rows 0-10 and 11-21 of tile ti) of the pair (ti, tj).
__device__ __forceinline__ void unit_of(int u, int T, int& ti, int& tj,
                                        int& half) {
  for (ti = 0;; ++ti) {
    const int here = 1 + 2 * (T - 1 - ti);
    if (u < here) break;
    u -= here;
  }
  tj = ti + (u + 1) / 2;
  half = u == 0 ? -1 : (u - 1) % 2;
}

// thread i -> micro-tile (a, b) of its unit (a in tile ti, b in tile tj);
// false when the unit has fewer micro-tiles than threads
__device__ __forceinline__ bool micro_of(int i, int half, int& a, int& b) {
  if (half < 0) {  // the triangle a <= b, row major
    for (a = 0; a < NB && i >= NB - a; ++a) i -= NB - a;
    b = a + i;
    return a < NB;
  }
  a = HALF * half + i / NB;
  b = i % NB;
  return i < HALF * NB;
}

// where column c (0 .. TW - 1) of a tile lies in a staged row: columns 0-3
// of the NB 8-column blocks first, then their columns 4-7
__device__ __forceinline__ int slot(int c) {
  return (c & 4) * NB + (c >> 3) * 4 + (c & 3);
}

// rows r .. r + ROWS - 1 (zero at and past r1) of [x | y]'s columns ct ..
// ct + TW - 1 (zero past column k, which is y) into dst, laid out by
// slot().  With the chunk's row masks mv (m of each row, 0 past r1), the
// result has a bit set for each of this thread's copies (its i-th unit,
// i counted from 0) that mask_tile() must visit: rows with m = 0, whose x
// and y become x * 0, and the unit of columns k and k + 1 (y * m and m);
// a row with m = 1 keeps its x and y (x * 1 is x).
template <int WIDTH>
__device__ __forceinline__ unsigned stage_units(float* dst,
                                                const float* __restrict__ x,
                                                const float* __restrict__ y,
                                                const float* mv, long long r,
                                                long long r1, int k, int ct) {
  constexpr int UNITS = TW / WIDTH;
  unsigned need = 0;
  int i = 0;
  for (int e = threadIdx.x; e < ROWS * UNITS; e += THREADS, ++i) {
    const int rr = e / UNITS, c = ct + WIDTH * (e % UNITS);
    const long long row = r + rr;
    const bool in = row < r1;
    float* d = dst + rr * TW + slot(c - ct);
    if (WIDTH == 4 && c < k) {
      cp16(d, in ? x + row * k + c : x, in);
    } else {
#pragma unroll
      for (int u = 0; u < WIDTH; ++u) {
        const bool is_x = in && c + u < k, is_y = in && c + u == k;
        cp4(d + u, is_x ? x + row * k + c + u : (is_y ? y + row : x),
            is_x || is_y);
      }
    }
    if (mv != nullptr &&
        ((mv[rr] == 0.f && c <= k) || (c <= k + 1 && c + WIDTH > k)))
      need |= 1u << i;
  }
  return need;
}

__device__ __forceinline__ unsigned stage_tile(float* dst,
                                               const float* __restrict__ x,
                                               const float* __restrict__ y,
                                               const float* mv, long long r,
                                               long long r1, int k, int ct,
                                               bool vec) {
  return vec ? stage_units<4>(dst, x, y, mv, r, r1, k, ct)
             : stage_units<1>(dst, x, y, mv, r, r1, k, ct);
}

// The units that stage_tile() flagged in need: x and y times their row's
// m, column k + 1 set to m.  Call after this thread's copies have landed.
template <int WIDTH>
__device__ __forceinline__ void mask_units(float* dst, const float* mv,
                                           int k, int ct, unsigned need) {
  constexpr int UNITS = TW / WIDTH;
  while (need) {
    const int e = threadIdx.x + THREADS * (__ffs(need) - 1);
    need &= need - 1;
    const int rr = e / UNITS, c = ct + WIDTH * (e % UNITS);
    const float m = mv[rr];
    float* d = dst + rr * TW + slot(c - ct);
#pragma unroll
    for (int u = 0; u < WIDTH; ++u) {
      if (c + u <= k)
        d[u] = __fmul_rn(d[u], m);
      else if (c + u == k + 1)
        d[u] = m;
    }
  }
}

__device__ __forceinline__ void mask_tile(float* dst, const float* mv, int k,
                                          int ct, bool vec, unsigned need) {
  if (vec)
    mask_units<4>(dst, mv, k, ct, need);
  else
    mask_units<1>(dst, mv, k, ct, need);
}

// acc (this thread's micro-tile (a, b) of unit (ti, tj)) += the Gram of
// A's rows r0 .. r1 - 1; A = [x | y], or [x m | y m | m] when valid is
// not null.  Every thread of the CTA calls it: it synchronises.  buf:
// smem_bytes(w) of dynamic shared memory.  One barrier per chunk: chunk
// c + 1 is copied while chunk c is summed, then each thread waits for
// its own copies of chunk c + 1 and masks them.  The row masks of chunk
// c + 2 are loaded into registers of the first ROWS threads meanwhile
// and stored beside the ring before the barrier.
__device__ __forceinline__ void gram_rows(float (&acc)[MT][MT], float* buf,
                                          const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          const uint8_t* __restrict__ valid,
                                          long long r0, long long r1, int k,
                                          int ti, int tj, bool two,
                                          bool active, int a, int b,
                                          bool vec) {
  const bool diag = ti == tj;
  const int tiles = two ? 2 : 1;  // tiles a stage holds
  const int chunks = static_cast<int>((r1 - r0 + ROWS - 1) / ROWS);
  const int tid = threadIdx.x;
  float* mv_rows = buf + STAGES * tiles * ROWS * TW;  // [STAGES][ROWS]
  auto mv_of = [&](int c) {  // m of row tid of chunk c
    const long long row = r0 + static_cast<long long>(c) * ROWS + tid;
    return row < r1 && valid[row] ? 1.f : 0.f;
  };
  unsigned need[2] = {0u, 0u};  // mask_tile's units of the staged chunk
  auto stage = [&](int c) {
    const long long r = r0 + static_cast<long long>(c) * ROWS;
    float* d = buf + (c % STAGES) * tiles * ROWS * TW;
    const float* mv =
        valid != nullptr ? mv_rows + (c % STAGES) * ROWS : nullptr;
    need[0] = stage_tile(d, x, y, mv, r, r1, k, ti * TW, vec);
    if (!diag)
      need[1] = stage_tile(d + ROWS * TW, x, y, mv, r, r1, k, tj * TW, vec);
    cp_commit();
  };
  auto mask = [&](int c) {
    float* d = buf + (c % STAGES) * tiles * ROWS * TW;
    const float* mv = mv_rows + (c % STAGES) * ROWS;
    mask_tile(d, mv, k, ti * TW, vec, need[0]);
    if (!diag) mask_tile(d + ROWS * TW, mv, k, tj * TW, vec, need[1]);
  };
  if (chunks == 0) return;
  if (valid != nullptr) {
    if (tid < ROWS) {
      mv_rows[tid] = mv_of(0);
      if (chunks > 1) mv_rows[ROWS + tid] = mv_of(1);
    }
    __syncthreads();  // the masks of chunks 0 and 1 are stored
  }
  stage(0);
  cp_wait<0>();
  if (valid != nullptr) mask(0);
  __syncthreads();  // chunk 0 is in shared memory, every thread's part
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage(c + 1);
    const bool next_mv = valid != nullptr && tid < ROWS && c + 2 < chunks;
    const float mv_next = next_mv ? mv_of(c + 2) : 0.f;
    const float* as = buf + (c % STAGES) * tiles * ROWS * TW;
    const float* bs = diag ? as : as + ROWS * TW;
    if (active) {
#pragma unroll 2
      for (int q = 0; q < ROWS; ++q) {
        const float* ar = as + q * TW + 4 * a;
        const float* br = bs + q * TW + 4 * b;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 4 * NB);
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 4 * NB);
        const float av[MT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[MT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < MT; ++u)
#pragma unroll
          for (int v = 0; v < MT; ++v)
            acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
    }
    if (c + 1 < chunks) {
      cp_wait<0>();
      if (valid != nullptr) mask(c + 1);
    }
    if (next_mv) mv_rows[(c % STAGES) * ROWS + tid] = mv_next;
    // chunk c is read and its buffer free; chunk c + 1 is in shared
    // memory, masked, every thread's part
    __syncthreads();
  }
}

}  // namespace gram
}  // namespace madlib
