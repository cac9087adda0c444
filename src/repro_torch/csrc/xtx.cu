// xtx: X^T X (k, k) and X^T y (k,) of one row block, f32.
//
// Replaces the TPU kernel src/repro/kernels/xtx/kernel.py:_xtx_kernel
// (called through xtx_xty_padded), the inner update of the OLS transition.
//
// Bound on the H100: X^T X is symmetric, so the function needs a multiply
// and an add per row for each of its k (k + 1) / 2 distinct entries and
// the k of X^T y, n k (k + 3) operations in f32 on the CUDA cores
// (67 TFLOP/s), against 4 n (k + 1) bytes read (3.35 TB/s).  At the main
// path's n = 10M, k = 160 that is 2.6e11 FLOP, about 3.9 ms, to 6.4 GB,
// about 1.9 ms: bound by operations.  This kernel computes every tile of
// the full (k + 1)^2 Gram, about twice the work the bound counts.
//
// Design.  The TPU kernel carries one accumulator across a sequential
// grid; CTAs on the H100 run in parallel and in no fixed order.  So the
// grid is (row split s, output tile i, output tile j): each CTA stages
// 32-row chunks of its two 64-column tiles of A = [x | y] in shared memory
// and accumulates a 4 x 4 register micro-tile per thread, then writes its
// split's partial tile.  A second launch adds the partials of every split
// in the fixed order s = 0 .. S - 1: deterministic, no float atomics.  A
// split holds at most 8192 rows (ops.py), which bounds each f32
// accumulation chain and so the rounding error on Gaussian data.  K is
// not padded to the TPU's 128 lanes; the ragged tile edge is masked.
#include "gram.cuh"

using namespace madlib;

__global__ void __launch_bounds__(THREADS)
xtx_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ partials, long long n, int k,
                   long long rows_per_split) {
  const int w = k + 1;
  const long long s = blockIdx.x;
  const long long r0 = s * rows_per_split;
  const long long r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  gram_tile(x, y, nullptr, r0, r1, k, w, blockIdx.y, blockIdx.z,
            partials + s * w * w);
}

__global__ void __launch_bounds__(THREADS)
xtx_reduce_kernel(const float* __restrict__ partials, float* __restrict__ xtx,
                  float* __restrict__ xty, int k, int splits) {
  const int w = k + 1;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)k * w) return;  // rows a < k of the (w, w) Gram
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partials[(long long)i * w * w + e];
  const int a = (int)(e / w), b = (int)(e % w);
  if (b < k)
    xtx[(long long)a * k + b] = s;
  else
    xty[a] = s;
}

extern "C" int madlib_xtx(const void* x, const void* y, void* partials,
                          void* xtx, void* xty, long long n, int k,
                          int splits, long long rows_per_split,
                          void* stream) {
  const int w = k + 1;
  const int tiles = (w + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  xtx_partial_kernel<<<dim3(splits, tiles, tiles), THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(partials), n, k, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = (long long)k * w;
  const unsigned blocks = (unsigned)((outs + THREADS - 1) / THREADS);
  if (blocks > 0)
    xtx_reduce_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(partials), static_cast<float*>(xtx),
        static_cast<float*>(xty), k, splits);
  return (int)cudaGetLastError();
}
