// xtx: X^T X (k, k) and X^T y (k,) of one row block, f32.
//
// Replaces the TPU kernel src/repro/kernels/xtx/kernel.py:29 (`_xtx_kernel`,
// launched through `pl.pallas_call` at :56 by xtx_xty_padded), the inner
// update of the OLS transition.
//
// Bound on the H100: X^T X is symmetric, so the function needs a multiply
// and an add per row for each of its k (k + 1) / 2 distinct entries and
// the k of X^T y, n k (k + 3) operations in f32 on the CUDA cores
// (67 TFLOP/s), against 4 n (k + 1) bytes read (3.35 TB/s).  At the main
// path's n = 10M, k = 160 that is 2.6e11 FLOP, about 3.9 ms, to 6.4 GB,
// about 1.9 ms: bound by operations.
//
// Design.  The TPU kernel carries one accumulator across a sequential
// grid; CTAs on the H100 run in parallel and in no fixed order.  So each
// CTA sums one row split of at most 8192 rows (ops.py; the cap bounds each
// f32 accumulation chain and so the rounding error on Gaussian data) into
// its own partial, and a second launch adds the partials of every split in
// the fixed order s = 0 .. S - 1: deterministic, no float atomics, no TF32.
//   * Only the upper triangle, packed into full warps.  A = [x | y] (width
//     w = k + 1) is cut into column tiles of 176 (22 blocks of 8).  A CTA
//     of 256 threads takes one split and one unit: the triangle of a tile
//     (22 x 23 / 2 = 253 micro-tiles) or half of a tile pair ti < tj (11 x
//     22 = 242), each thread one 8 x 8 register micro-tile; micro-tiles
//     past w are skipped.  The units of a split are numbered next to each
//     other, so they run side by side and share its rows in L2.  At k =
//     160 there is one tile: each CTA reads its split's rows of x once and
//     computes ceil(w / 8) (ceil(w / 8) + 1) / 2 = 231 micro-tiles with
//     256 threads, 1.13x the 13,041 distinct entries.
//   * Each row of a micro-tile costs 4 LDS.128 for 64 FFMA.  Staged rows
//     keep the first four columns of every 8-column block together, then
//     the last four, so lanes reading neighbouring blocks read
//     consecutive bytes.
//   * Chunks of 32 rows are staged by cp.async into a two-stage ring, so
//     the next chunk's copy overlaps this chunk's FFMA: 16-byte copies of x
//     when k % 4 == 0 and x is 16-byte aligned (madlib_xtx checks),
//     4-byte copies otherwise; y, the ragged edge and rows past the split
//     are 4-byte copies or zero fill.
//   * Every output entry is one f32 FMA chain over the split's rows in
//     ascending order, then the splits in order: on dyadic inputs, where
//     every partial sum is exact, the result is bitwise the plain
//     version's, and the reduce writes xtx[a][b] and xtx[b][a] from one
//     sum, so xtx is bitwise symmetric.
// segment_linregr keeps gram.cuh's full-tile routine.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;                  // micro-tile edge
constexpr int NB = 22;                 // micro-tiles along a column tile
constexpr int TW = NB * MT;            // column tile of A: 176 columns
constexpr int HALF = NB / 2;           // micro-tile rows of a half unit
constexpr int THREADS = 256;           // >= NB (NB + 1) / 2 and HALF NB
constexpr int ROWS = 32;               // rows of A per staged chunk
constexpr int STAGES = 2;
constexpr int REDUCE_THREADS = 256;
static_assert(NB * (NB + 1) / 2 <= THREADS && HALF * NB <= THREADS,
              "a unit's micro-tiles fit the CTA");

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

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// rows r .. r + ROWS - 1 (zero at and past r1) of A's columns ct .. ct +
// TW - 1 (zero past column k, which is y) into dst, laid out by slot()
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           long long r, long long r1, int k,
                                           int ct, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int e = tid; e < ROWS * (TW / 4); e += THREADS) {
      const int rr = e / (TW / 4), c = ct + 4 * (e % (TW / 4));
      const long long row = r + rr;
      const bool in = row < r1;
      float* d = dst + rr * TW + slot(c - ct);
      if (c < k) {
        cp16(d, in ? x + row * k + c : x, in);
      } else {
        for (int i = 0; i < 4; ++i) {
          const bool is_y = in && c + i == k;
          cp4(d + i, is_y ? y + row : y, is_y);
        }
      }
    }
  } else {
    for (int e = tid; e < ROWS * TW; e += THREADS) {
      const int rr = e / TW, c = ct + e % TW;
      const long long row = r + rr;
      const bool in = row < r1 && c <= k;
      const float* src = !in ? x : (c < k ? x + row * k + c : y + row);
      cp4(dst + rr * TW + slot(c - ct), src, in);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
xtx_upper_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ partials, long long n, int k,
                 long long rows_per_split, int vec) {
  // [stage][tile ti, then tile tj unless they are one][ROWS][TW]
  extern __shared__ __align__(16) float buf[];
  const int w = k + 1;
  const int T = (w + TW - 1) / TW;
  const int units = T * T;  // T triangles and T (T - 1) halves
  int ti, tj, half;
  unit_of(static_cast<int>(blockIdx.x % units), T, ti, tj, half);
  const bool diag = half < 0;
  const int tiles = T > 1 ? 2 : 1;  // tiles a stage holds
  const long long s = blockIdx.x / units;
  const long long r0 = s * rows_per_split;
  const long long r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  int a, b;
  const bool mine = micro_of(threadIdx.x, half, a, b);
  const int ga = ti * TW + a * MT, gb = tj * TW + b * MT;
  const bool active = mine && ga < w && gb < w;

  float acc[MT][MT];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = 0.f;

  const int chunks = static_cast<int>((r1 - r0 + ROWS - 1) / ROWS);
  auto stage = [&](int c) {
    const long long r = r0 + static_cast<long long>(c) * ROWS;
    float* d = buf + (c % STAGES) * tiles * ROWS * TW;
    stage_tile(d, x, y, r, r1, k, ti * TW, vec);
    if (!diag) stage_tile(d + ROWS * TW, x, y, r, r1, k, tj * TW, vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      stage(c + 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // chunk c is in shared memory, every thread's part
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
    __syncthreads();  // chunk c is read: its buffer takes chunk c + 2
  }
  if (!active) return;
  float* out = partials + s * w * w;
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v)
      if (ga + u < w && gb + v < w)
        out[static_cast<long long>(ga + u) * w + gb + v] = acc[u][v];
}

// entry (a, b), a <= b, of the upper triangle: the splits' partials added
// in order s = 0 .. S - 1, written to xtx[a][b] and xtx[b][a] (or xty[a])
__global__ void __launch_bounds__(REDUCE_THREADS)
xtx_reduce_kernel(const float* __restrict__ partials, float* __restrict__ xtx,
                  float* __restrict__ xty, int k, int splits) {
  const int w = k + 1;
  const long long e =
      static_cast<long long>(blockIdx.x) * REDUCE_THREADS + threadIdx.x;
  if (e >= static_cast<long long>(k) * w) return;  // rows a < k
  const int a = static_cast<int>(e / w), b = static_cast<int>(e % w);
  if (b < a) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i)
    s += partials[static_cast<long long>(i) * w * w + e];
  if (b < k) {
    xtx[static_cast<long long>(a) * k + b] = s;
    xtx[static_cast<long long>(b) * k + a] = s;
  } else {
    xty[a] = s;
  }
}

}  // namespace

// x (n, k) and y (n,) contiguous f32; partials (splits, k + 1, k + 1)
// scratch.  Returns cudaGetLastError().
extern "C" int madlib_xtx(const void* x, const void* y, void* partials,
                          void* xtx, void* xty, long long n, int k,
                          int splits, long long rows_per_split,
                          void* stream) {
  const int w = k + 1;
  // 16-byte copies of x need 16-byte rows and base; else 4-byte copies
  const int vec =
      k % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
  const int T = (w + TW - 1) / TW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = STAGES * (T > 1 ? 2 : 1) * ROWS * TW * 4;
  cudaError_t err = cudaFuncSetAttribute(
      xtx_upper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(T * T) * static_cast<unsigned>(splits);
  xtx_upper_kernel<<<grid, THREADS, bytes, st>>>(static_cast<const float*>(x),
                           static_cast<const float*>(y),
                           static_cast<float*>(partials), n, k,
                           rows_per_split, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outs = static_cast<long long>(k) * w;
  const unsigned blocks =
      static_cast<unsigned>((outs + REDUCE_THREADS - 1) / REDUCE_THREADS);
  if (blocks > 0)
    xtx_reduce_kernel<<<blocks, REDUCE_THREADS, 0, st>>>(
        static_cast<const float*>(partials), static_cast<float*>(xtx),
        static_cast<float*>(xty), k, splits);
  return static_cast<int>(cudaGetLastError());
}
