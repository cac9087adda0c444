// Shared device routine of the xtx and segment_linregr kernels: one
// 64 x 64 tile of the Gram matrix A^T A over a range of rows, where A is
// the augmented row matrix
//
//     A = [x * m | y * m | m]      (width k + 2; m is the 0/1 validity)
//     A = [x | y]                  (width k + 1; when m is null)
//
// read in place from x (n, k), y (n,) and m (n,) without materialising A.
// Every sufficient statistic of OLS is a block of A^T A: x^T x is the top
// left k x k block, x^T y is column k, sum(y^2) is entry (k, k), sum(y) is
// entry (k + 1, k) and the row count is entry (k + 1, k + 1).
//
// Arithmetic is IEEE f32 fused multiply-add on the CUDA cores, one row at
// a time in ascending row order for each output element.  No TF32: the
// tests hold fold states bit for bit on dyadic data, where every partial
// sum is exact in f32 and any summation order gives the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace madlib {

constexpr int TILE = 64;      // output tile edge, in columns of A
constexpr int CHUNK = 32;     // rows of A staged in shared memory per step
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

// Entry (row, col) of A; zero past its width.
__device__ __forceinline__ float aug_value(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const uint8_t* __restrict__ m,
                                           long long row, int col, int k,
                                           int w) {
  if (col >= w) return 0.f;
  const float mv = (m == nullptr || m[row]) ? 1.f : 0.f;
  if (col < k) return x[row * k + col] * mv;
  if (col == k) return y[row] * mv;
  return mv;
}

// Tile (ti, tj) of A[r0:r1]^T A[r0:r1], written into out (w x w, row
// major).  Every thread of the block must call it: it synchronises.
__device__ __forceinline__ void gram_tile(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          const uint8_t* __restrict__ m,
                                          long long r0, long long r1, int k,
                                          int w, int ti, int tj,
                                          float* __restrict__ out) {
  __shared__ float as[CHUNK][TILE];
  __shared__ float bs[CHUNK][TILE];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ci = ti * TILE, cj = tj * TILE;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (long long r = r0; r < r1; r += CHUNK) {
    for (int e = tid; e < CHUNK * TILE; e += THREADS) {
      const int rr = e / TILE, cc = e % TILE;
      const long long row = r + rr;
      const bool in = row < r1;
      as[rr][cc] = in ? aug_value(x, y, m, row, ci + cc, k, w) : 0.f;
      bs[rr][cc] = in ? aug_value(x, y, m, row, cj + cc, k, w) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < CHUNK; ++q) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = as[q][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = bs[q][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ia = ci + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int jb = cj + tx + 16 * v;
      if (ia < w && jb < w) out[(long long)ia * w + jb] = acc[u][v];
    }
  }
}

}  // namespace madlib
