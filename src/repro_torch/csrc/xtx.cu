// xtx: X^T X (k, k) and X^T y (k,) of one row block, f32: the wide path.
//
// Replaces the TPU kernel src/repro/kernels/xtx/kernel.py:29 (`_xtx_kernel`,
// launched through `pl.pallas_call` at :56 by xtx_xty_padded), the inner
// update of the OLS transition.  Two paths, chosen by kernels/xtx/ops.py
// from k alone: k <= K_NARROW (120) runs csrc/xtx_narrow.cu (row groups
// of a CTA each sum the whole upper triangle over their own rows: the
// register triangle up to k = 15, 8 x 8 micro-tiles past it), wider k
// runs this file.
//
// Bound on the H100: X^T X is symmetric, so the function needs a multiply
// and an add per row for each of its k (k + 1) / 2 distinct entries and
// the k of X^T y, n k (k + 3) operations in f32 on the CUDA cores
// (67 TFLOP/s), against 4 n (k + 1) bytes read (3.35 TB/s): bytes bound
// it below k = 78, operations above, so the narrow path must stream x at
// the memory rate and this path, from k = 121 up, must keep the FFMA
// pipes busy.  At the main path's n = 10M, k = 160 that is 2.6e11 FLOP,
// about 3.9 ms, to 6.4 GB, about 1.9 ms: bound by operations.
//
// Design.  The TPU kernel carries one accumulator across a sequential
// grid; CTAs on the H100 run in parallel and in no fixed order.  So each
// CTA sums one row split of at most 8192 rows (ops.py; the cap bounds each
// f32 accumulation chain and so the rounding error on Gaussian data) into
// its own partial, and a second launch adds the partials of every split in
// the fixed order s = 0 .. S - 1: deterministic, no float atomics, no TF32.
// A CTA computes one unit of the upper triangle of A = [x | y] (width
// w = k + 1) over its split, through gram_upper.cuh (176-column tiles,
// one 8 x 8 register micro-tile per thread, cp.async two-stage ring).
// The units of a split are numbered next to each other, so they run side
// by side and share its rows in L2.  At k = 160 there is one tile: each
// CTA reads its split's rows of x once and computes 231 micro-tiles with
// 256 threads, 1.13x the 13,041 distinct entries.  The reduce writes
// xtx[a][b] and xtx[b][a] from one sum, so xtx is bitwise symmetric.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_upper.cuh"

namespace {

using namespace madlib::gram;

constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(THREADS, 2)
xtx_upper_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ partials, long long n, int k,
                 long long rows_per_split, int vec) {
  // [stage][tile ti, then tile tj unless they are one][ROWS][TW]
  extern __shared__ __align__(16) float buf[];
  const int w = k + 1;
  const int T = tiles_of(w);
  const int units = T * T;  // T triangles and T (T - 1) halves
  int ti, tj, half;
  unit_of(static_cast<int>(blockIdx.x % units), T, ti, tj, half);
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
  gram_rows(acc, buf, x, y, nullptr, r0, r1, k, ti, tj, T > 1, active, a, b,
            vec != 0);
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
  const int T = tiles_of(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = smem_bytes(w);
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
