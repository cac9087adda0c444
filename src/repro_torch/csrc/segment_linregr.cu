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
// 3.9 ms to 1.9 ms: bound by operations.  This kernel computes every tile
// of the full (k + 2)^2 Gram, about twice the work the bound counts.
//
// Design.  The TPU kernel keeps (G, k, k) accumulators across a sequential
// grid and adds each block into its group's slot.  On the H100 the fold
// is two launches:
//   pass 1, grid (block b, tile i, tile j): one CTA per output tile of
//     block b's Gram of A = [x m | y m | m], written to an (nb, k+2, k+2)
//     scratch; the sentinel blocks that pad_blocks_to appends (g >= G)
//     return at once;
//   pass 2, grid (group g, tile): each CTA compacts, in block order, the
//     indices of the blocks whose gid is g (warp ballots into shared
//     memory), and each thread adds its element over them in that order.
// The sum order is fixed for any bgid order: deterministic, no atomics.
#include "gram.cuh"

using namespace madlib;

__global__ void __launch_bounds__(THREADS)
segment_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const uint8_t* __restrict__ valid,
                       const int* __restrict__ bgids,
                       float* __restrict__ partials, int k, int bs,
                       int num_groups) {
  const long long b = blockIdx.x;
  const int g = bgids[b];
  if (g < 0 || g >= num_groups) return;  // sentinel block: never read
  const int w = k + 2;
  gram_tile(x, y, valid, b * bs, (b + 1) * bs, k, w, blockIdx.y, blockIdx.z,
            partials + b * w * w);
}

__global__ void __launch_bounds__(THREADS)
segment_reduce_kernel(const float* __restrict__ partials,
                      const int* __restrict__ bgids, int nb, int k,
                      float* __restrict__ xtx, float* __restrict__ xty,
                      float* __restrict__ y_sum, float* __restrict__ y_sq,
                      float* __restrict__ n_out) {
  __shared__ int blocks[THREADS];
  __shared__ int warp_counts[THREADS / 32];
  const int g = blockIdx.x;
  const int w = k + 2;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  const bool active = e < w * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f;
  for (int base = 0; base < nb; base += THREADS) {
    const int b = base + threadIdx.x;
    const bool hit = b < nb && bgids[b] == g;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      if (i < warp) offset += warp_counts[i];
      total += warp_counts[i];
    }
    if (hit) blocks[offset + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    if (active)
      for (int i = 0; i < total; ++i)
        s += partials[(long long)blocks[i] * w * w + e];
    __syncthreads();
  }
  if (!active) return;
  const int a = e / w, c = e % w;
  if (a < k && c < k)
    xtx[((long long)g * k + a) * k + c] = s;
  else if (a < k && c == k)
    xty[(long long)g * k + a] = s;
  else if (a == k && c == k)
    y_sq[g] = s;
  else if (a == k + 1 && c == k)
    y_sum[g] = s;
  else if (a == k + 1 && c == k + 1)
    n_out[g] = s;
}

extern "C" int madlib_segment_linregr(const void* x, const void* y,
                                      const void* valid, const void* bgids,
                                      void* partials, void* xtx, void* xty,
                                      void* y_sum, void* y_sq, void* n_out,
                                      int nb, int bs, int k, int num_groups,
                                      void* stream) {
  const int w = k + 2;
  const int tiles = (w + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segment_partial_kernel<<<dim3(nb, tiles, tiles), THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(bgids),
      static_cast<float*>(partials), k, bs, num_groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int out_tiles = (w * w + THREADS - 1) / THREADS;
  if (num_groups > 0)
    segment_reduce_kernel<<<dim3(num_groups, out_tiles), THREADS, 0, st>>>(
        static_cast<const float*>(partials), static_cast<const int*>(bgids),
        nb, k, static_cast<float*>(xtx), static_cast<float*>(xty),
        static_cast<float*>(y_sum), static_cast<float*>(y_sq),
        static_cast<float*>(n_out));
  return (int)cudaGetLastError();
}
