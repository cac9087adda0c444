// segment_linregr: the whole grouped OLS fold over a group-aligned layout.
// For every block b whose group id g = bgids[b] is below G, the masked
// x^T x, x^T y, sum(y), sum(y^2) and row count of its rows are added into
// group slot g.  Groups without blocks come out zero: the result is the
// fold from zero, which the caller merges with the per-group inits.
//
// Replaces the TPU kernel
// src/repro/kernels/segment_fold/kernel.py:_linregr_kernel (called through
// segment_linregr_padded), the grouped hot path of linregr_grouped.
//
// Bound on the H100: per valid row, a multiply and an add for each of the
// (k + 1) (k + 2) / 2 distinct entries of the symmetric Gram of [x | y]
// (x^T x, x^T y and y^2), and one add each for sum(y) and n: that is
// n_valid ((k + 1) (k + 2) + 2) operations in f32 on the CUDA cores
// (67 TFLOP/s), against 4 n2 (k + 1) + n2 bytes read (3.35 TB/s), n2 the
// rows of the layout.  At the main path's 10M rows, k = 160, that is about
// 3.9 ms to 1.9 ms: bound by operations.
//
// Design.  The TPU kernel keeps (G, k, k) accumulators across a sequential
// grid and adds each block into its group's slot.  On the H100 the fold
// is two launches:
//   pass 1, one CTA per (block, row split, unit): the upper triangle of
//     the Gram of A = [x m | y m | m] (width w = k + 2) over the split's
//     rows, through gram_upper.cuh, xtx's routine: 176-column tiles, one
//     8 x 8 register micro-tile per thread, a cp.async two-stage ring;
//     each thread multiplies the elements it staged by their row's m
//     (x * m, as the reference) and writes the m column.  At k = 160 a
//     unit is one 176-column tile, 231 micro-tiles.  A block holds at most
//     4096 rows on the main path; a larger explicit block size is cut by
//     the wrapper into splits of at most 8192 rows, xtx's chain cap.  The
//     output is the packed upper triangle, w (w + 1) / 2 floats per split:
//     13,203 at k = 160.  The sentinel blocks that pad_blocks_to appends
//     (g >= G) return at once;
//   pass 2, grid (group g, entry tile): each CTA compacts, in block order,
//     the indices of the blocks whose gid is g (warp ballots into shared
//     memory), and each thread adds its packed entry over them in that
//     order, the splits of a block in order, then writes x^T x[a][b] and
//     x^T x[b][a] from the one sum (bitwise symmetric).
// The sum order is fixed for any bgid order: deterministic, no atomics;
// bitwise the plain version on dyadic data.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gram_upper.cuh"

namespace {

using namespace madlib::gram;

constexpr int REDUCE_THREADS = 256;

// start of row a of the packed upper triangle of a width-w matrix
__host__ __device__ inline long long packed_row(int a, int w) {
  const long long la = a;
  return la * w - la * (la - 1) / 2;
}

__global__ void __launch_bounds__(THREADS, 2)
segment_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const uint8_t* __restrict__ valid,
                       const int* __restrict__ bgids,
                       float* __restrict__ partials, int k, int bs,
                       int splits_per_block, int rows_per_split,
                       int num_groups, int vec) {
  // [stage][tile ti, then tile tj unless they are one][ROWS][TW]
  extern __shared__ __align__(16) float buf[];
  const int w = k + 2;
  const int T = tiles_of(w);
  const int units = T * T;
  const long long split = blockIdx.x / units;
  const long long b = split / splits_per_block;
  const int g = bgids[b];
  if (g < 0 || g >= num_groups) return;  // sentinel block: never read
  int ti, tj, half;
  unit_of(static_cast<int>(blockIdx.x % units), T, ti, tj, half);
  const long long end = (b + 1) * bs;
  const long long r0 = b * bs + (split % splits_per_block) * rows_per_split;
  const long long r1 = r0 + rows_per_split < end ? r0 + rows_per_split : end;
  int a, c;
  const bool mine = micro_of(threadIdx.x, half, a, c);
  const int ga = ti * TW + a * MT, gb = tj * TW + c * MT;
  const bool active = mine && ga < w && gb < w;

  float acc[MT][MT];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = 0.f;
  gram_rows(acc, buf, x, y, valid, r0, r1, k, ti, tj, T > 1, active, a, c,
            vec != 0);
  if (!active) return;
  float* out = partials + split * (packed_row(w, w));
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    const int ra = ga + u;
    if (ra >= w) continue;
    const long long row = packed_row(ra, w) - ra;
#pragma unroll
    for (int v = 0; v < MT; ++v)
      if (gb + v < w && gb + v >= ra) out[row + gb + v] = acc[u][v];
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
segment_reduce_kernel(const float* __restrict__ partials,
                      const int* __restrict__ bgids, int nb,
                      int splits_per_block, int k, float* __restrict__ xtx,
                      float* __restrict__ xty, float* __restrict__ y_sum,
                      float* __restrict__ y_sq, float* __restrict__ n_out) {
  __shared__ int blocks[REDUCE_THREADS];
  __shared__ int warp_counts[REDUCE_THREADS / 32];
  const int g = blockIdx.x;
  const int w = k + 2;
  const long long per = packed_row(w, w);  // w (w + 1) / 2
  const long long e =
      static_cast<long long>(blockIdx.y) * REDUCE_THREADS + threadIdx.x;
  const bool active = e < per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f;
  for (int base = 0; base < nb; base += REDUCE_THREADS) {
    const int b = base + threadIdx.x;
    const bool hit = b < nb && bgids[b] == g;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < REDUCE_THREADS / 32; ++i) {
      if (i < warp) offset += warp_counts[i];
      total += warp_counts[i];
    }
    if (hit) blocks[offset + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    if (active)
      for (int i = 0; i < total; ++i)
        for (int sp = 0; sp < splits_per_block; ++sp)
          s += partials[(static_cast<long long>(blocks[i]) * splits_per_block +
                         sp) * per + e];
    __syncthreads();
  }
  if (!active) return;
  // (a, c), a <= c, of packed entry e: the last row a that starts at or
  // before e (the float estimate corrected both ways)
  const double t = 2.0 * w + 1.0;
  int a = static_cast<int>(
      (t - sqrt(t * t - 8.0 * static_cast<double>(e))) / 2.0);
  if (a < 0) a = 0;
  if (a > w - 1) a = w - 1;
  while (a > 0 && packed_row(a, w) > e) --a;
  while (a + 1 < w && packed_row(a + 1, w) <= e) ++a;
  const int c = a + static_cast<int>(e - packed_row(a, w));
  if (a < k && c < k) {
    xtx[(static_cast<long long>(g) * k + a) * k + c] = s;
    xtx[(static_cast<long long>(g) * k + c) * k + a] = s;
  } else if (a < k && c == k) {
    xty[static_cast<long long>(g) * k + a] = s;
  } else if (a == k && c == k) {
    y_sq[g] = s;
  } else if (a == k && c == k + 1) {
    y_sum[g] = s;
  } else if (a == k + 1 && c == k + 1) {
    n_out[g] = s;
  }
}

}  // namespace

// x (nb bs, k), y (nb bs,) f32 and valid (nb bs,) bool contiguous, bgids
// (nb,) int32; partials (nb splits_per_block, (k + 2) (k + 3) / 2)
// scratch.  Returns cudaGetLastError().
extern "C" int madlib_segment_linregr(const void* x, const void* y,
                                      const void* valid, const void* bgids,
                                      void* partials, void* xtx, void* xty,
                                      void* y_sum, void* y_sq, void* n_out,
                                      int nb, int bs, int k, int num_groups,
                                      int splits_per_block,
                                      int rows_per_split, void* stream) {
  const int w = k + 2;
  const int T = tiles_of(w);
  // 16-byte copies of x need 16-byte rows and base; else 4-byte copies
  const int vec =
      k % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      segment_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>(nb) * splits_per_block * T * T;
  if (grid >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (grid > 0)
    segment_partial_kernel<<<grid, THREADS, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(bgids),
        static_cast<float*>(partials), k, bs, splits_per_block,
        rows_per_split, num_groups, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = packed_row(w, w);
  const unsigned entry_tiles =
      static_cast<unsigned>((per + REDUCE_THREADS - 1) / REDUCE_THREADS);
  if (num_groups > 0)
    segment_reduce_kernel<<<dim3(num_groups, entry_tiles), REDUCE_THREADS, 0,
                            st>>>(
        static_cast<const float*>(partials), static_cast<const int*>(bgids),
        nb, splits_per_block, k, static_cast<float*>(xtx),
        static_cast<float*>(xty), static_cast<float*>(y_sum),
        static_cast<float*>(y_sq), static_cast<float*>(n_out));
  return static_cast<int>(cudaGetLastError());
}
