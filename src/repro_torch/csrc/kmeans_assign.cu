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
// CTAs (ops.splits_for), each walking the 256-row tiles s, s + S, ... in
// order into a partial of its own.  Per tile:
//   1. staging: when d <= 32 the tile's rows arrive by cp.async into a
//      two-stage ring (16-byte copies when d % 4 == 0 and x is 16-byte
//      aligned, 4-byte copies otherwise), the next tile's copy in flight
//      during this tile's FFMA; the row stride is 4 x an odd number, so
//      reads of 8 consecutive rows hit distinct banks.  Wider rows are
//      staged 32 columns at a time, synchronously.
//   2. distances: the centroids sit in shared memory for the whole launch,
//      transposed and zero-padded (or, past 48 KB, are staged 32 features
//      by a pass's centroids per step).  Shared memory delivers 128 bytes
//      a clock to an SM's registers, broadcast or not, so the register
//      tile is sized for reuse: each thread holds 8 rows x 8 centroids of
//      x . c, and CG = 1, 2 or 4 neighbouring lanes split a pass's 8 CG
//      centroids by k's size class (k <= 8, <= 16, more; passes of 32
//      past 32): per feature 8 scalar reads of x and 2 float4 reads of c
//      feed 64 FFMA, and k = 8 spends no FFMA on padding.  One FFMA chain
//      per entry in ascending feature order (zero padding adds exact
//      zeros).  Each thread keeps a running minimum with a strict '<' over
//      its centroids in ascending order; the CG lanes of a row then take
//      the least distance, the lower index on equal ones: argmin's tie
//      rule.  The row weights are loaded at the start of the tile, so
//      their latency hides behind the FFMA.
//   3. the one-hot product without a serial chain: an integer atomicOr
//      per row (the same bits in any order) builds, per centroid, a
//      bitmap of the tile's rows that chose it (weight 0 left out), one
//      word per 32-row group; then one owner thread per centroid j and 8
//      features adds its bitmap's rows in ascending order into 8 register
//      sums (float4 reads of the staged rows, two rows' reads issued
//      together), and the count with the first features.  Every entry is
//      one fixed-order sum: no float atomics.
// Each thread holds its owners' sums in registers for the whole launch
// when k * ceil(d / 8) <= 2 x the CTA's threads (the main path's k = 64,
// d = 32: 256 owners, 128 threads), and adds into its CTA's slice of the
// global scratch otherwise; the bitmaps live in shared memory when they
// take at most 16 KB.  The x tile has no padding (an XOR swizzle spreads
// the banks), so a CTA takes 76 KB of shared memory at the main shape and
// three fill an SM.
// A second launch adds the S partials of every entry in the order
// s = 0 .. S - 1: per entry rows ascending within a tile, tiles ascending
// within a CTA, then the CTAs in order.  The result is deterministic, and
// bitwise equal to the plain version on dyadic data, where every partial
// sum is exact in f32.  No TF32: IEEE FFMA only.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using madlib::cp16;
using madlib::cp4;
using madlib::cp_commit;
using madlib::cp_wait;

constexpr int R = 8;                     // rows per thread
constexpr int TILE_ROWS = 32 * R;        // 256
constexpr int GROUPS = TILE_ROWS / 32;   // bitmap words per centroid
constexpr int DC = 32;                   // feature columns staged per step
constexpr int QC = 8;                    // features per owner of the partial
constexpr int OWN = 2;                   // owners a thread holds in registers
constexpr int CS_SMEM_MAX = 48 * 1024;   // resident centroids, at most
constexpr int MASK_SMEM_MAX = 16 * 1024; // shared-memory bitmaps, at most
constexpr int REDUCE_THREADS = 256;

// where column q (< DC) of staged row rr lies: rows of DC floats, the
// 16-byte groups of row rr XOR-ed with rr % 8, so 8 consecutive rows read
// at one column hit 8 banks, and a group stays 16 contiguous bytes
__device__ __forceinline__ int xcol(int rr, int q) {
  return rr * DC + (q ^ ((rr & 7) << 2));
}

// floats of a CTA's scratch: the bitmaps (GROUPS words per centroid), the
// partial sums and the counts, padded to 16 bytes (ops.scratch_floats)
__host__ __device__ inline long long scratch_floats(int k, int d) {
  return (static_cast<long long>(GROUPS) * k + static_cast<long long>(k) * d +
          k + 3) & ~3ll;
}

struct Plan {
  int ring;       // d <= DC: whole rows staged, two-stage ring
  int c_res;      // centroids resident in shared memory
  int mask_smem;  // bitmaps in shared memory
  int acc_reg;    // the partial in the owners' registers (else global)
};

__host__ inline size_t smem_bytes(int d, int k, int kc, const Plan& p) {
  const int d4 = (d + 3) & ~3, kpad = (k + kc - 1) / kc * kc;
  return 4 * (static_cast<size_t>(p.ring ? 2 : 1) * TILE_ROWS * DC +
              (p.c_res ? static_cast<size_t>(d4) * kpad : DC * kc) + kpad +
              (p.mask_smem ? GROUPS * k : 0));
}

// Three CTAs of 128 threads fill an SM at the main shape: 76 KB of shared
// memory and at most 170 registers each
template <int TK, int CG>
__global__ void __launch_bounds__(32 * CG, 3)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ m, int* __restrict__ assign,
                     float* __restrict__ mind, float* __restrict__ partials,
                     long long n, int d, int k, int vec, Plan p) {
  constexpr int THREADS = 32 * CG;
  constexpr int KC = TK * CG;  // centroids a pass covers
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3, kpad = (k + KC - 1) / KC * KC;
  const int kd = k * d;
  const int qchunks = (d + QC - 1) / QC;
  const int owners = k * qchunks;
  float* xs = smem;                                     // [stage][row][DC]
  // [d4][kpad] resident, or [DC][KC] a step
  float* cs = xs + (p.ring ? 2 : 1) * TILE_ROWS * DC;
  float* ccs = cs + (p.c_res ? d4 * kpad : DC * KC);    // kpad norms
  unsigned* msk_s = reinterpret_cast<unsigned*>(ccs + kpad);
  // the CTA's slice of the scratch: bitmaps, then the partial
  float* part = partials + blockIdx.x * scratch_floats(k, d);
  float* acc = part + GROUPS * k;
  // masks[j * GROUPS + g]: bit b set when row 32 g + b of the tile chose j
  unsigned* masks =
      p.mask_smem ? msk_s : reinterpret_cast<unsigned*>(part);
  const int tid = threadIdx.x, lane = tid & 31;
  // this thread: rows rg + 32 r (r < R) against centroid group cg, whose
  // float4 blocks are cg, cg + CG, ... of each pass; the CG threads of a
  // row are neighbouring lanes
  const int rg = (tid >> 5) * (32 / CG) + lane / CG, cg = lane % CG;

  if (!p.acc_reg)
    for (int e = tid; e < kd + k; e += THREADS) acc[e] = 0.f;
  for (int e = tid; e < GROUPS * k; e += THREADS) masks[e] = 0u;
  for (int j = tid; j < kpad; j += THREADS) {
    float s = 0.f;
    if (j < k) {
      const float* cj = c + static_cast<long long>(j) * d;
      for (int q = 0; q < d; ++q) s = fmaf(cj[q], cj[q], s);
    }
    ccs[j] = s;
  }
  if (p.c_res)
    for (int e = tid; e < d4 * kpad; e += THREADS) {
      const int q = e / kpad, j = e % kpad;
      cs[e] = q < d && j < k ? c[static_cast<long long>(j) * d + q] : 0.f;
    }
  // (the first barrier of the tile loop orders these before any use)

  // rows row0 .. row0 + TILE_ROWS - 1, columns d0 .. d0 + dn - 1 of x into
  // dst by xcol(); zero past n and in the columns up to the next multiple
  // of 4
  auto stage_x = [&](float* dst, long long row0, int d0) {
    const int dn = min(DC, d - d0);
    const int w = vec ? (dn + 3) / 4 : 4 * ((dn + 3) / 4);  // copies a row
    // copy e = tid + THREADS i is (row rr, copy cq) of e = rr w + cq,
    // stepped without a division
    const int sr = THREADS / w, sc = THREADS % w;
    int rr = tid / w, cq = tid % w;
    while (rr < TILE_ROWS) {
      const long long row = row0 + rr;
      if (vec) {
        const bool in = row < n;
        cp16(dst + xcol(rr, 4 * cq), in ? x + row * d + d0 + 4 * cq : x, in);
      } else {
        const bool in = row < n && cq < dn;
        cp4(dst + xcol(rr, cq), in ? x + row * d + d0 + cq : x, in);
      }
      rr += sr;
      cq += sc;
      if (cq >= w) {
        cq -= w;
        ++rr;
      }
    }
  };

  // owner o: centroid j, features q0 .. q0 + QC - 1 (and the count when
  // q0 = 0): adds the rows of j's bitmap, in ascending order, to s and cnt
  auto own = [&](int o, const float* xt, long long row0, float (&s)[QC],
                 float& cnt) {
    const int j = o / qchunks, q0 = (o % qchunks) * QC;
    const uint4 lo = *reinterpret_cast<const uint4*>(masks + j * GROUPS);
    const uint4 hi = *reinterpret_cast<const uint4*>(masks + j * GROUPS + 4);
    // rows 64 h .. 64 h + 63 of the tile in word h
    const unsigned long long w1 =
        lo.z | (static_cast<unsigned long long>(lo.w) << 32);
    const unsigned long long w2 =
        hi.x | (static_cast<unsigned long long>(hi.y) << 32);
    const unsigned long long w3 =
        hi.z | (static_cast<unsigned long long>(hi.w) << 32);
    unsigned long long cur =
        lo.x | (static_cast<unsigned long long>(lo.y) << 32);
    int h = 0;
    auto next_row = [&]() {  // the next row of j, ascending; -1 at the end
      while (cur == 0) {  // -1 again on every later call
        if (h == 3) return -1;
        ++h;
        cur = h == 1 ? w1 : h == 2 ? w2 : w3;
      }
      const int b = __ffsll(static_cast<long long>(cur)) - 1;
      cur &= cur - 1;
      return 64 * h + b;
    };
    auto load_row = [&](int rr, float (&v)[QC]) {
      if (p.ring) {  // the whole row is staged, zero past d
#pragma unroll
        for (int i = 0; i < QC; i += 4)
          if (q0 + i < d) {
            const float4 f =
                *reinterpret_cast<const float4*>(xt + xcol(rr, q0 + i));
            v[i] = f.x;
            v[i + 1] = f.y;
            v[i + 2] = f.z;
            v[i + 3] = f.w;
          }
      } else {
        const float* xr = x + (row0 + rr) * d + q0;
#pragma unroll
        for (int i = 0; i < QC; ++i)
          if (q0 + i < d) v[i] = xr[i];
      }
    };
    // two rows at a time: their loads go out together
    for (int ra = next_row(); ra >= 0; ra = next_row()) {
      const int rb = next_row();
      float va[QC], vb[QC];
      const float wa = __ldg(m + row0 + ra);
      const float wb = rb >= 0 ? __ldg(m + row0 + rb) : 0.f;
      load_row(ra, va);
      if (rb >= 0) load_row(rb, vb);
#pragma unroll
      for (int i = 0; i < QC; ++i)
        if (q0 + i < d) s[i] = __fadd_rn(s[i], __fmul_rn(wa, va[i]));
      cnt = __fadd_rn(cnt, wa);
      if (rb < 0) break;
#pragma unroll
      for (int i = 0; i < QC; ++i)
        if (q0 + i < d) s[i] = __fadd_rn(s[i], __fmul_rn(wb, vb[i]));
      cnt = __fadd_rn(cnt, wb);
    }
  };
  // the owners' sums of the whole launch, when each thread has at most OWN
  float sreg[OWN][QC], creg[OWN];
#pragma unroll
  for (int u = 0; u < OWN; ++u) {
    creg[u] = 0.f;
#pragma unroll
    for (int i = 0; i < QC; ++i) sreg[u][i] = 0.f;
  }

  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  long long tile = blockIdx.x;
  if (p.ring && tile < tiles) stage_x(xs, tile * TILE_ROWS, 0);
  cp_commit();
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const long long row0 = tile * TILE_ROWS;
    const float* xt = xs + (p.ring ? (it & 1) * TILE_ROWS * DC : 0);
    if (p.ring) {
      const long long next = tile + gridDim.x;
      if (next < tiles)
        stage_x(xs + ((it + 1) & 1) * TILE_ROWS * DC, next * TILE_ROWS, 0);
      cp_commit();
      cp_wait<1>();
      __syncthreads();  // this tile's rows have landed, every thread's part
    }
    float xx[R], best[R], wt[R];
    int arg[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // the weights load during the FFMA
      const long long row = row0 + rg + 32 * r;
      wt[r] = cg == 0 && row < n ? m[row] : 0.f;
      xx[r] = 0.f;
      best[r] = INFINITY;
      arg[r] = 0;
    }
    for (int k0 = 0; k0 < k; k0 += KC) {
      float a[R][TK];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) a[r][kk] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DC) {
        const int dq4 = 4 * ((min(DC, d - d0) + 3) / 4);
        if (!p.ring || !p.c_res) {
          __syncthreads();  // the previous step is done with the chunks
          if (!p.ring) stage_x(xs, row0, d0);
          if (!p.c_res)
            for (int e = tid; e < dq4 * KC; e += THREADS) {
              const int q = e / KC, kk = e % KC;
              cs[e] = k0 + kk < k && d0 + q < d
                          ? c[static_cast<long long>(k0 + kk) * d + d0 + q]
                          : 0.f;
            }
          if (!p.ring) {
            cp_commit();
            cp_wait<0>();
          }
          __syncthreads();
        }
        const float* cb = (p.c_res ? cs + d0 * kpad + k0 : cs) + 4 * cg;
        const int cld = p.c_res ? kpad : KC;
        // rows rg + 32 r share rg % 8, so one XOR serves all of them
        const float* xrow = xt + rg * DC;
        const int swz = (rg & 7) << 2;
#pragma unroll 4
        for (int q = 0; q < dq4; ++q) {
          float xv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) xv[r] = xrow[32 * DC * r + (q ^ swz)];
          if (k0 == 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) xx[r] = fmaf(xv[r], xv[r], xx[r]);
          }
          const float* crow = cb + q * cld;
#pragma unroll
          for (int i = 0; i < TK / 4; ++i) {
            const float4 cv =
                *reinterpret_cast<const float4*>(crow + 4 * CG * i);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              a[r][4 * i] = fmaf(xv[r], cv.x, a[r][4 * i]);
              a[r][4 * i + 1] = fmaf(xv[r], cv.y, a[r][4 * i + 1]);
              a[r][4 * i + 2] = fmaf(xv[r], cv.z, a[r][4 * i + 2]);
              a[r][4 * i + 3] = fmaf(xv[r], cv.w, a[r][4 * i + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {  // ascending j within the thread
        const int j = k0 + 4 * (cg + CG * (kk / 4)) + kk % 4;
        if (j < k) {
          const float cc = ccs[j];
#pragma unroll
          for (int r = 0; r < R; ++r) {
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
    // the CG threads of a row: the least distance, the lowest j on ties
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 1; s < CG; s <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[r], s);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[r], s);
        if (ob < best[r] || (ob == best[r] && oa < arg[r])) {
          best[r] = ob;
          arg[r] = oa;
        }
      }

    int key[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rr = rg + 32 * r;  // row group r, bit rg
      const long long row = row0 + rr;
      key[r] = -1;
      if (cg == 0) {
        if (row < n) {
          assign[row] = arg[r];
          mind[row] = __fmul_rn(fmaxf(best[r], 0.f), wt[r]);
        }
        if (wt[r] != 0.f) key[r] = arg[r];
        // integer OR: the bitmap is the same in any order
        if (key[r] >= 0) atomicOr(&masks[key[r] * GROUPS + r], 1u << rg);
      }
    }
    __syncthreads();  // bitmaps written

    if (p.acc_reg) {
#pragma unroll
      for (int u = 0; u < OWN; ++u)
        if (tid + u * THREADS < owners)
          own(tid + u * THREADS, xt, row0, sreg[u], creg[u]);
    } else {
      for (int o = tid; o < owners; o += THREADS) {
        const int j = o / qchunks, q0 = (o % qchunks) * QC;
        float* aj = acc + j * d + q0;
        float s[QC], cnt = acc[kd + j];
#pragma unroll
        for (int i = 0; i < QC; ++i) s[i] = q0 + i < d ? aj[i] : 0.f;
        own(o, xt, row0, s, cnt);
#pragma unroll
        for (int i = 0; i < QC; ++i)
          if (q0 + i < d) aj[i] = s[i];
        if (q0 == 0) acc[kd + j] = cnt;
      }
    }
    __syncthreads();  // bitmaps and this tile's buffer are free
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (key[r] >= 0) masks[key[r] * GROUPS + r] = 0u;
  }

  if (p.acc_reg) {
#pragma unroll
    for (int u = 0; u < OWN; ++u) {
      const int o = tid + u * THREADS;
      if (o >= owners) continue;
      const int j = o / qchunks, q0 = (o % qchunks) * QC;
#pragma unroll
      for (int i = 0; i < QC; ++i)
        if (q0 + i < d) acc[j * d + q0 + i] = sreg[u][i];
      if (q0 == 0) acc[kd + j] = creg[u];
    }
  }
}

// entry e of the sums and counts: the S partials added in order
__global__ void __launch_bounds__(REDUCE_THREADS)
kmeans_reduce_kernel(const float* __restrict__ partials,
                     float* __restrict__ sums, float* __restrict__ counts,
                     int kd, int k, int splits) {
  const int e = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e >= kd + k) return;
  const long long w = scratch_floats(k, kd / k);
  const float* p = partials + GROUPS * k + e;  // past the bitmaps
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += p[i * w];
  if (e < kd)
    sums[e] = s;
  else
    counts[e - kd] = s;
}

template <int TK, int CG>
cudaError_t launch_assign(const float* x, const float* c, const float* m,
                          int* assign, float* mind, float* partials,
                          long long n, int d, int k, int splits,
                          cudaStream_t st) {
  constexpr int KC = TK * CG;
  const int d4 = (d + 3) & ~3, kpad = (k + KC - 1) / KC * KC;
  Plan p;
  p.ring = d <= DC;
  p.c_res = static_cast<long long>(d4) * kpad * 4 <= CS_SMEM_MAX;
  p.mask_smem = GROUPS * k * 4 <= MASK_SMEM_MAX;
  p.acc_reg = static_cast<long long>(k) * ((d + QC - 1) / QC) <= OWN * 32 * CG;
  const size_t bytes = smem_bytes(d, k, KC, p);
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_assign_kernel<TK, CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // 16-byte copies of x need 16-byte rows and base; else 4-byte copies
  const int vec =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
  kmeans_assign_kernel<TK, CG><<<splits, 32 * CG, bytes, st>>>(
      x, c, m, assign, mind, partials, n, d, k, vec, p);
  return cudaGetLastError();
}

}  // namespace

// x (n, d), c (k, d), m (n,) contiguous f32; partials (splits, k d + k +
// 8 k) scratch (the partial and the bitmaps of each CTA).  Returns
// cudaGetLastError().
extern "C" int madlib_kmeans_assign(const void* x, const void* c,
                                    const void* m, void* assign, void* mind,
                                    void* partials, void* sums, void* counts,
                                    long long n, int d, int k, int splits,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(c);
  const float* mf = static_cast<const float*>(m);
  int* af = static_cast<int*>(assign);
  float* mi = static_cast<float*>(mind);
  float* pf = static_cast<float*>(partials);
  // the threads of a row by k's size class: 1, 2 or 4
  auto launch = k <= 8    ? &launch_assign<8, 1>
                : k <= 16 ? &launch_assign<8, 2>
                          : &launch_assign<8, 4>;
  cudaError_t err = launch(xf, cf, mf, af, mi, pf, n, d, k, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kd = k * d;
  const unsigned blocks = (kd + k + REDUCE_THREADS - 1) / REDUCE_THREADS;
  kmeans_reduce_kernel<<<blocks, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(sums),
      static_cast<float*>(counts), kd, k, splits);
  return static_cast<int>(cudaGetLastError());
}
