// kmeans_assign: the data pass of one fused Lloyd round, f32.  For every
// row of x (n, d) against the centroids c (k, d), with a row weight m (n,)
// (the 0/1 validity mask):
//
//   d2[r][j]   = (|x_r|^2 - 2 x_r . c_j) + |c_j|^2      (the reference's order)
//   assign[r]  = argmin_j d2[r][j], the lowest j among equal minima, for
//                every row, masked or not
//   mind[r]    = max(min_j d2[r][j], 0) * m[r]
//   sums[j]    = sum over rows with assign = j of m[r] * x_r
//   counts[j]  = sum over rows with assign = j of m[r]
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign/kernel.py:_kernel
// (called through assign_reduce_padded), the transition of KMeansAggregate
// with use_kernel.
//
// Bound on the H100: the distances need a multiply and an add per row,
// centroid and feature, 2 n k d operations in f32 on the CUDA cores
// (67 TFLOP/s), against 4 n d + 4 n bytes read and 8 n written, plus the
// centroids and the sums, 8 k d (3.35 TB/s).  At the main path's n = 10M,
// k = 64, d = 32 that is 4.1e10 FLOP, about 0.61 ms, to 1.40 GB, about
// 0.42 ms: bound by operations.
//
// Design.  The TPU kernel keeps the (k, d) sums and (k,) counts resident
// across a sequential grid; CTAs on the H100 run in parallel and in no
// fixed order.  So the first launch is persistent: a fixed number S of
// CTAs (the wrapper caps it so that S partials fit a small scratch), each
// walking the 256-row tiles s, s + S, s + 2S, ... in order.  Per tile:
//   1. distances: 32-column chunks of the tile's rows are staged in shared
//      memory (row stride 33, so a warp reading 32 rows hits 32 banks),
//      32 centroids at a time transposed beside them; each thread holds
//      2 rows x 32 centroids of x . c in registers, one FFMA chain per
//      entry in ascending feature order; the epilogue keeps a running
//      minimum with a strict '<' over ascending centroid index, which is
//      argmin's tie rule;
//   2. the one-hot product becomes a scatter: warp w owns the centroids
//      j = w (mod 4), lane q owns their features q (mod 32); a warp ballot
//      over each 32 rows picks the rows it owns, in ascending order, and
//      the owning lanes add m * x into the CTA's partial.  Every partial
//      entry has one owner and a fixed row order: no atomics.
// The partial (k d + k floats) lives in shared memory when it takes at
// most 96 KB (the main path's takes 8.4 KB) and in the CTA's own slice of
// the global scratch otherwise.  A second launch adds the S partials of
// every entry in the order s = 0 .. S - 1.  The result is deterministic,
// and bitwise equal to the plain version on dyadic data, where every
// partial sum is exact in f32.  No TF32: IEEE FFMA only.  Neither K nor D
// is padded to the TPU's layout.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RPT = 2;                    // rows per thread
constexpr int TILE_ROWS = THREADS * RPT;  // 256
constexpr int DC = 32;                    // feature columns staged per step
constexpr int XS_LD = DC + 1;             // padded row stride of the x tile
constexpr int TK = 32;                    // centroids per register tile
constexpr int ACC_SMEM_MAX = 96 * 1024;   // shared-memory partial, at most

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ m, int* __restrict__ assign,
                     float* __restrict__ mind, float* __restrict__ partials,
                     long long n, int d, int k, int acc_in_smem) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // TILE_ROWS x XS_LD
  float* cs = xs + TILE_ROWS * XS_LD;    // DC x TK, centroid-minor
  float* ccs = cs + DC * TK;             // k centroid norms
  float* wts = ccs + ((k + 3) & ~3);     // TILE_ROWS row weights
  int* asg = reinterpret_cast<int*>(wts + TILE_ROWS);  // TILE_ROWS
  const long long kd = (long long)k * d;
  float* part = partials + (long long)blockIdx.x * (kd + k);
  float* acc = acc_in_smem ? reinterpret_cast<float*>(asg + TILE_ROWS) : part;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long long e = tid; e < kd + k; e += THREADS) acc[e] = 0.f;
  for (int j = tid; j < k; j += THREADS) {
    const float* cj = c + (long long)j * d;
    float s = 0.f;
    for (int q = 0; q < d; ++q) s = fmaf(cj[q], cj[q], s);
    ccs[j] = s;
  }
  // (the first barrier of the tile loop orders these before any use)

  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const int nchunks = (d + DC - 1) / DC;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TILE_ROWS;
    float xx[RPT], best[RPT];
    int arg[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      xx[r] = 0.f;
      best[r] = INFINITY;
      arg[r] = 0;
    }
    for (int k0 = 0; k0 < k; k0 += TK) {
      float a[RPT][TK];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) a[r][kk] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DC) {
        const int dn = min(DC, d - d0);
        __syncthreads();  // the previous step is done with xs and cs
        if (nchunks > 1 || k0 == 0) {
          for (int e = tid; e < TILE_ROWS * DC; e += THREADS) {
            const int rr = e / DC, q = e % DC;
            const long long row = row0 + rr;
            xs[rr * XS_LD + q] =
                (row < n && q < dn) ? x[row * d + d0 + q] : 0.f;
          }
        }
        for (int e = tid; e < TK * DC; e += THREADS) {
          const int q = e / TK, kk = e % TK;  // lanes on consecutive banks
          cs[q * TK + kk] = (k0 + kk < k && q < dn)
                                ? c[(long long)(k0 + kk) * d + d0 + q]
                                : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int q = 0; q < dn; ++q) {
          float xv[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            xv[r] = xs[(tid + r * THREADS) * XS_LD + q];
          if (k0 == 0) {
#pragma unroll
            for (int r = 0; r < RPT; ++r) xx[r] = fmaf(xv[r], xv[r], xx[r]);
          }
#pragma unroll
          for (int kk = 0; kk < TK; kk += 4) {
            const float4 cv = *reinterpret_cast<const float4*>(&cs[q * TK + kk]);
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              a[r][kk] = fmaf(xv[r], cv.x, a[r][kk]);
              a[r][kk + 1] = fmaf(xv[r], cv.y, a[r][kk + 1]);
              a[r][kk + 2] = fmaf(xv[r], cv.z, a[r][kk + 2]);
              a[r][kk + 3] = fmaf(xv[r], cv.w, a[r][kk + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const int j = k0 + kk;
        if (j < k) {
          const float cc = ccs[j];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            // 2 a is exact: xx - 2 a rounds once, as the reference's does
            const float d2 = __fadd_rn(__fsub_rn(xx[r], 2.f * a[r][kk]), cc);
            if (d2 < best[r]) {
              best[r] = d2;
              arg[r] = j;
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int rr = tid + r * THREADS;
      const long long row = row0 + rr;
      float wt = 0.f;
      if (row < n) {
        wt = m[row];
        assign[row] = arg[r];
        mind[row] = __fmul_rn(fmaxf(best[r], 0.f), wt);
      }
      asg[rr] = arg[r];
      wts[rr] = wt;
    }
    __syncthreads();

    for (int r0 = 0; r0 < TILE_ROWS; r0 += 32) {
      const int aj = asg[r0 + lane];
      const float wt = wts[r0 + lane];
      unsigned mine = __ballot_sync(0xffffffffu, wt != 0.f && aj % WARPS == warp);
      while (mine) {
        const int b = __ffs(mine) - 1;
        mine &= mine - 1;
        const int j = __shfl_sync(0xffffffffu, aj, b);
        const float wj = __shfl_sync(0xffffffffu, wt, b);
        const int rr = r0 + b;
        float* sj = acc + (long long)j * d;
        if (nchunks == 1) {  // the whole row is still staged
          for (int q = lane; q < d; q += 32)
            sj[q] = __fadd_rn(sj[q], __fmul_rn(wj, xs[rr * XS_LD + q]));
        } else {
          const float* xr = x + (row0 + rr) * d;
          for (int q = lane; q < d; q += 32)
            sj[q] = __fadd_rn(sj[q], __fmul_rn(wj, xr[q]));
        }
        if (lane == 0) acc[kd + j] = __fadd_rn(acc[kd + j], wj);
      }
    }
  }

  if (acc_in_smem) {
    __syncthreads();
    for (long long e = tid; e < kd + k; e += THREADS) part[e] = acc[e];
  }
}

__global__ void __launch_bounds__(256)
kmeans_reduce_kernel(const float* __restrict__ partials,
                     float* __restrict__ sums, float* __restrict__ counts,
                     long long kd, int k, int splits) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long w = kd + k;
  if (e >= w) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partials[(long long)i * w + e];
  if (e < kd)
    sums[e] = s;
  else
    counts[e - kd] = s;
}

}  // namespace

extern "C" int madlib_kmeans_assign(const void* x, const void* c,
                                    const void* m, void* assign, void* mind,
                                    void* partials, void* sums, void* counts,
                                    long long n, int d, int k, int splits,
                                    void* stream) {
  const long long kd = (long long)k * d;
  const size_t acc_bytes = (size_t)(kd + k) * sizeof(float);
  const int acc_in_smem = acc_bytes <= (size_t)ACC_SMEM_MAX;
  const size_t bytes =
      (size_t)(TILE_ROWS * XS_LD + DC * TK + ((k + 3) & ~3) + TILE_ROWS) *
          sizeof(float) +
      TILE_ROWS * sizeof(int) + (acc_in_smem ? acc_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kmeans_assign_kernel<<<splits, THREADS, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(m), static_cast<int*>(assign),
      static_cast<float*>(mind), static_cast<float*>(partials), n, d, k,
      acc_in_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((kd + k + 255) / 256);
  kmeans_reduce_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(sums),
      static_cast<float*>(counts), kd, k, splits);
  return (int)cudaGetLastError();
}
