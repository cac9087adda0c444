// xtx at narrow widths: X^T X (k, k) and X^T y (k,) of one row block, f32,
// for k <= K_NARROW (kernels/xtx/ops.py), where csrc/xtx.cu's 176-column
// tiles keep most threads idle (at k = 8 three of 256 do all the FFMA).
//
// Replaces, with csrc/xtx.cu, the TPU kernel src/repro/kernels/xtx/
// kernel.py:29 (`_xtx_kernel`, launched through `pl.pallas_call` at :56).
//
// Bound on the H100: n k (k + 3) operations in f32 on the CUDA cores
// (67 TFLOP/s) against 4 n (k + 1) bytes read (3.35 TB/s): bytes bound
// the function below k = 78, operations above.  At n = 10M, k = 8 that is
// 0.36 GB, about 0.107 ms, for 8.8e8 FLOP: the kernel has to stream x at
// the memory rate and spend little on anything else.
//
// Design.  S persistent CTAs (whole waves, ops.narrow_splits) each take a
// row split and walk it in chunks, staged by cp.async into a ring: x's
// chunk is contiguous, copied flat (neighbouring threads, neighbouring
// addresses) in 4-byte copies, so x and y may start anywhere and k may be
// anything, or in 16-byte copies where k % 4 == 0 and x is 16-byte
// aligned.  One barrier per chunk: the next chunks are copied while this
// one is summed.  The CTA's threads form row groups, each computing the
// whole upper triangle over its own rows of every chunk:
//   - k + 1 <= 16, the register triangle: 256 threads, each a group of its
//     own holding all (k + 1)(k + 2) / 2 entries of [x | y]'s Gram in
//     registers (45 at k = 8), taking 1, 2 or 4 (8 at k = 1) rows of a
//     chunk; a staged row, y at column k, has an odd pitch, so 32 lanes
//     reading 32 consecutive rows hit 32 banks.  Four stages.
//   - k >= 16, micro-tiles: c = ceil(k / 8) blocks of 8 of x's columns
//     make m = c (c + 1) / 2 micro-tiles of 8 x 8 (55 at k = 80); a group
//     is m neighbouring threads, one micro-tile each, all reading the same
//     row (columns 0-3 of every block first, then 4-7, as gram_upper.cuh
//     lays them out, so a row's float4 reads hit distinct banks or
//     broadcast), and floor(256 / m) groups fill the CTA, two CTAs an SM.
//     y is staged beside the rows, and every thread also sums its 8
//     columns times y (the same work on every lane, so no lane waits on
//     another); the diagonal micro-tiles' sums are the ones kept, so a
//     k = 8 c needs no extra block for y.  A group takes 4, 8 or 16 rows
//     of a chunk, unrolled.  Three stages.
// At the end of the split the groups' triangles are added in a fixed
// order (the register triangle: a butterfly over the warp's lanes, then
// the 8 warps as a tree; micro-tiles: a tree that folds the upper half of
// the groups onto the lower), and the CTA writes one partial.  The S
// partials of each entry a <= b are then added by a second launch, one
// warp an entry, in a fixed order (lane i of the warp the partials i,
// i + 32, ..., then a butterfly), and xtx[a][b] and xtx[b][a] written
// from one sum: bitwise symmetric.  An f32 chain runs over at most 8192
// rows (ops.narrow_splits), every sum is in a fixed order, with no
// float atomics and no TF32, so the result is
// deterministic, and bitwise the plain version's on dyadic data; the
// short chains and trees keep it closer to a float64 sum than the plain
// version on Gaussian data.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using madlib::cp16;
using madlib::cp4;
using madlib::cp_commit;
using madlib::cp_wait;

constexpr int TRI_STAGES = 4;
constexpr int TRI_THREADS = 256;
constexpr int TRI_MAX_W = 16;
constexpr int MT = 8;              // micro-tile edge
constexpr int MT_THREADS = 256;    // most threads of a micro-tile CTA
constexpr int MT_STAGES = 3;
constexpr int MT_SMEM = 28672;     // floats of a micro-tile CTA: two an SM
constexpr int REDUCE_THREADS = 256;

__host__ __device__ constexpr int tri_pitch(int w) { return w | 1; }
__host__ __device__ constexpr int mt_pitch(int c) { return MT * c + 4; }

// column j of a row of c 8-column blocks: columns 0-3 of every block,
// then their columns 4-7
__device__ __forceinline__ int slot(int j, int c) {
  return (j & 4) * c + (j >> 3) * 4 + (j & 3);
}

// Rows row .. row + rows - 1 of [x | y] into shared memory: x's row q at
// dst + q * pitch, its column j at col(j); y's at ydst + q * ystride.
// x's rows are rows * k contiguous floats, copied V at a time (V = 4:
// 16-byte copies, which need k % 4 == 0, x 16-byte aligned and col(j) ..
// col(j) + 3 contiguous for j % 4 == 0; V = 1: 4-byte copies, any k and
// any alignment), thread tid taking copies tid, tid + nthreads, ...:
// neighbouring threads read neighbouring addresses.
template <int V, class Col>
__device__ __forceinline__ void stage_rows(float* dst, float* ydst,
                                           int ystride,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           long long row, int rows, int k,
                                           int pitch, Col col, int tid,
                                           int nthreads) {
  const float* src = x + row * k;
  const int total = rows * k, step = nthreads * V;
  int e = tid * V, r = e / k, j = e - r * k;
  const int dr = step / k, dj = step - dr * k;
  for (; e < total; e += step) {
    if (V == 4)
      cp16(dst + r * pitch + col(j), src + e, true);
    else
      cp4(dst + r * pitch + col(j), src + e, true);
    r += dr;
    j += dj;
    if (j >= k) {
      j -= k;
      ++r;
    }
  }
  for (int q = tid; q < rows; q += nthreads)
    cp4(ydst + q * ystride, y + row + q, true);
}

// entry (i, j), i <= j, of a width-W upper triangle, row major
__host__ __device__ constexpr int tri_index(int i, int j, int W) {
  return i * W - i * (i - 1) / 2 + (j - i);
}

// rows of a chunk that each thread of the register triangle takes: more
// where a row is short, so that a chunk is 4-18 KB
__host__ __device__ constexpr int tri_rows_per_thread(int W) {
  return W <= 2 ? 8 : W <= 4 ? 4 : W <= 12 ? 2 : 1;
}

// The register triangle, W = k + 1 <= TRI_MAX_W: thread t takes rows
// t, t + 256, ... of every chunk.
template <int W>
__global__ void __launch_bounds__(TRI_THREADS)
xtx_narrow_tri_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      float* __restrict__ partials, long long n,
                      long long rows_per_split) {
  constexpr int K = W - 1, P = tri_pitch(W), E = W * (W + 1) / 2;
  constexpr int RPT = tri_rows_per_thread(W), R = TRI_THREADS * RPT;
  static_assert(TRI_THREADS == 256, "the warps' tree below adds 8 triangles");
  extern __shared__ __align__(16) float ring[];  // [TRI_STAGES][R][P]
  const int tid = threadIdx.x;
  const long long r0 = blockIdx.x * rows_per_split;
  const long long r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  const int chunks = r1 > r0 ? static_cast<int>((r1 - r0 + R - 1) / R) : 0;
  auto plain = [](int j) { return j; };
  auto stage = [&](int c) {
    if (c < chunks) {
      const long long row = r0 + static_cast<long long>(c) * R;
      const int rows = static_cast<int>(r1 - row < R ? r1 - row : R);
      float* d = ring + (c % TRI_STAGES) * R * P;
      stage_rows<1>(d, d + K, P, x, y, row, rows, K, P, plain, tid,
                    TRI_THREADS);
    }
    cp_commit();  // an empty group past the last chunk keeps the count
  };

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int c = 0; c < TRI_STAGES - 1; ++c) stage(c);
  for (int c = 0; c < chunks; ++c) {
    cp_wait<TRI_STAGES - 2>();  // this thread's copies of chunk c landed
    __syncthreads();        // everyone's; and chunk c - 1's stage is free
    stage(c + TRI_STAGES - 1);
    const long long row = r0 + static_cast<long long>(c) * R;
    const int rows = static_cast<int>(r1 - row < R ? r1 - row : R);
#pragma unroll
    for (int h = 0; h < RPT; ++h) {
      const int q = tid + h * TRI_THREADS;
      if (q < rows) {
        const float* v = ring + (c % TRI_STAGES) * R * P + q * P;
        float a[W];
#pragma unroll
        for (int j = 0; j < W; ++j) a[j] = v[j];
#pragma unroll
        for (int i = 0; i < W; ++i)
#pragma unroll
          for (int j = i; j < W; ++j)
            acc[tri_index(i, j, W)] =
                fmaf(a[i], a[j], acc[tri_index(i, j, W)]);
      }
    }
  }

  // the warp's 32 triangles by a butterfly (every lane ends with the same
  // bits: each step adds the same two values), then the 8 warps' as a tree
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[e] = v;
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' triangles
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) ring[warp * E + e] = acc[e];
  }
  __syncthreads();
  float* out = partials + static_cast<long long>(blockIdx.x) * W * W;
  for (int e = tid; e < E; e += TRI_THREADS) {
    const float* p = ring + e;
    const float s = ((p[0] + p[E]) + (p[2 * E] + p[3 * E])) +
                    ((p[4 * E] + p[5 * E]) + (p[6 * E] + p[7 * E]));
    int i = 0, rem = e;
    while (rem >= W - i) {
      rem -= W - i;
      ++i;
    }
    out[i * W + i + rem] = s;
  }
}

// Micro-tiles, w = k + 1 > TRI_MAX_W: c = ceil(k / 8) blocks of x's
// columns, m = c (c + 1) / 2 micro-tiles; groups x m threads, thread
// g m + i the micro-tile i of group g, which takes rows g, g + groups, ...
// of a chunk of groups x RPG rows.  Every thread also sums its a-block
// times y (the same work on every lane, so no lane waits for another);
// the diagonal micro-tiles' sums are the ones written.  vec: 16-byte
// copies of x.
template <int RPG>
__global__ void __launch_bounds__(MT_THREADS, 2)
xtx_narrow_mt_kernel(const float* __restrict__ x,
                     const float* __restrict__ y,
                     float* __restrict__ partials, long long n, int k,
                     long long rows_per_split, int groups, int vec) {
  // [MT_STAGES][R][P] x's rows, then [MT_STAGES][R] y
  extern __shared__ __align__(16) float ring[];
  const int w = k + 1, c = (k + MT - 1) / MT, m = c * (c + 1) / 2;
  const int P = mt_pitch(c), G = groups, R = groups * RPG;
  float* ring_y = ring + MT_STAGES * R * P;
  const int nthreads = m * G;
  const int tid = threadIdx.x, g = tid / m, i = tid - g * m;
  int a = 0, rem = i;  // micro-tile i of the c x c block triangle, row major
  while (rem >= c - a) {
    rem -= c - a;
    ++a;
  }
  const int b = a + rem;
  const long long r0 = blockIdx.x * rows_per_split;
  const long long r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  const int chunks = r1 > r0 ? static_cast<int>((r1 - r0 + R - 1) / R) : 0;
  // columns k .. 8 c - 1 of every staged row: zero, never copied over
  const int pad = MT * c - k;
  for (int e = tid; e < MT_STAGES * R * pad; e += nthreads) {
    const int q = e / pad;
    ring[q * P + slot(k + (e - q * pad), c)] = 0.f;
  }
  auto slotted = [c](int j) { return slot(j, c); };
  auto stage = [&](int ch) {
    if (ch < chunks) {
      const long long row = r0 + static_cast<long long>(ch) * R;
      const int rows = static_cast<int>(r1 - row < R ? r1 - row : R);
      float* d = ring + (ch % MT_STAGES) * R * P;
      float* yd = ring_y + (ch % MT_STAGES) * R;
      if (vec)
        stage_rows<4>(d, yd, 1, x, y, row, rows, k, P, slotted, tid,
                      nthreads);
      else
        stage_rows<1>(d, yd, 1, x, y, row, rows, k, P, slotted, tid,
                      nthreads);
    }
    cp_commit();
  };

  float acc[MT][MT], accy[MT];
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    accy[u] = 0.f;
#pragma unroll
    for (int v = 0; v < MT; ++v) acc[u][v] = 0.f;
  }
  for (int ch = 0; ch < MT_STAGES - 1; ++ch) stage(ch);
  for (int ch = 0; ch < chunks; ++ch) {
    cp_wait<MT_STAGES - 2>();
    __syncthreads();
    stage(ch + MT_STAGES - 1);
    const long long row = r0 + static_cast<long long>(ch) * R;
    const int rows = static_cast<int>(r1 - row < R ? r1 - row : R);
    const float* base = ring + (ch % MT_STAGES) * R * P;
    const float* ys = ring_y + (ch % MT_STAGES) * R;
    auto fma_row = [&](const float* xr, float yv) {
      const float4 a0 = *reinterpret_cast<const float4*>(xr + 4 * a);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + 4 * (a + c));
      const float4 b0 = *reinterpret_cast<const float4*>(xr + 4 * b);
      const float4 b1 = *reinterpret_cast<const float4*>(xr + 4 * (b + c));
      const float av[MT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[MT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        accy[u] = fmaf(av[u], yv, accy[u]);
#pragma unroll
        for (int v = 0; v < MT; ++v)
          acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
    };
    if (rows == R) {  // a whole chunk: RPG rows for every group, unrolled
#pragma unroll
      for (int t = 0; t < RPG; ++t)
        fma_row(base + (g + t * G) * P, ys[g + t * G]);
    } else {
#pragma unroll 2
      for (int q = g; q < rows; q += G) fma_row(base + q * P, ys[q]);
    }
  }

  // fold the groups onto group 0: groups [half, live) hand their tiles to
  // groups [0, live - half) through the free ring, in a fixed tree
  constexpr int TILE = MT * MT + MT;
  cp_wait<0>();
  __syncthreads();
  for (int live = G; live > 1;) {
    const int half = (live + 1) / 2;
    if (g >= half && g < live) {
      float* d = ring + ((g - half) * m + i) * TILE;
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        d[MT * MT + u] = accy[u];
#pragma unroll
        for (int v = 0; v < MT; ++v) d[u * MT + v] = acc[u][v];
      }
    }
    __syncthreads();
    if (g < live - half) {
      const float* s = ring + (g * m + i) * TILE;
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        accy[u] += s[MT * MT + u];
#pragma unroll
        for (int v = 0; v < MT; ++v) acc[u][v] += s[u * MT + v];
      }
    }
    __syncthreads();
    live = half;
  }
  if (g == 0) {
    float* out = partials + static_cast<long long>(blockIdx.x) * w * w;
    const int ga = MT * a, gb = MT * b;
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      if (ga + u >= k) continue;
      if (a == b) out[(ga + u) * w + k] = accy[u];
#pragma unroll
      for (int v = 0; v < MT; ++v)
        if (gb + v < k && ga + u <= gb + v)
          out[(ga + u) * w + gb + v] = acc[u][v];
    }
  }
}

// Entry (a, b), a <= b, of the upper triangle, one warp each: the splits'
// partials of entry e = a (k + 1) + b added in a fixed order (lane i of
// the warp the partials i, i + 32, ... in order, then a butterfly over
// the lanes), written to xtx[a][b] and xtx[b][a] from one sum (or to
// xty[a] for b = k).
__global__ void __launch_bounds__(REDUCE_THREADS)
xtx_narrow_reduce_kernel(const float* __restrict__ partials,
                         float* __restrict__ xtx, float* __restrict__ xty,
                         int k, int splits) {
  const int w = k + 1, lane = threadIdx.x & 31;
  const long long e = static_cast<long long>(blockIdx.x) *
                          (REDUCE_THREADS / 32) + threadIdx.x / 32;
  if (e >= static_cast<long long>(k) * w) return;  // rows a < k
  const int a = static_cast<int>(e / w), b = static_cast<int>(e % w);
  if (b < a) return;  // the whole warp
  float s = 0.f;
#pragma unroll 4
  for (int i = lane; i < splits; i += 32)
    s += partials[static_cast<long long>(i) * w * w + e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  if (b < k) {
    xtx[static_cast<long long>(a) * k + b] = s;
    xtx[static_cast<long long>(b) * k + a] = s;
  } else {
    xty[a] = s;
  }
}

// Every query and every launch first allows the kernel its shared memory
// above 48 KB, as csrc/xtx.cu does: the widths of one micro-tile template
// need different bytes, so an allowance set for one k may be short for
// the next.
struct Launch {
  const float* x;
  const float* y;
  float* partials;
  long long n;
  int k;
  int splits;
  long long rows_per_split;
  int groups;
  cudaStream_t stream;
};

template <class Kern>
cudaError_t fit_or_launch(Kern kern, int threads, int bytes,
                          int* ctas_per_sm, const Launch& l,
                          void (*go)(const Launch&, int, int)) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (ctas_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern,
                                                         threads, bytes);
  go(l, threads, bytes);
  return cudaGetLastError();
}

template <int W>
void go_tri(const Launch& l, int threads, int bytes) {
  xtx_narrow_tri_kernel<W><<<l.splits, threads, bytes, l.stream>>>(
      l.x, l.y, l.partials, l.n, l.rows_per_split);
}

template <int RPG>
void go_mt(const Launch& l, int threads, int bytes) {
  // 16-byte copies of x need 16-byte rows and base; else 4-byte copies
  const int vec =
      l.k % 4 == 0 && (reinterpret_cast<uintptr_t>(l.x) & 15) == 0 ? 1 : 0;
  xtx_narrow_mt_kernel<RPG><<<l.splits, threads, bytes, l.stream>>>(
      l.x, l.y, l.partials, l.n, l.k, l.rows_per_split, l.groups, vec);
}

template <int W>
cudaError_t tri(const Launch& l, int rows_per_chunk, int* ctas_per_sm) {
  constexpr int R = TRI_THREADS * tri_rows_per_thread(W);
  if (l.groups != TRI_THREADS || rows_per_chunk != R)
    return cudaErrorInvalidValue;
  return fit_or_launch(xtx_narrow_tri_kernel<W>, TRI_THREADS,
                       TRI_STAGES * R * tri_pitch(W) * 4, ctas_per_sm, l,
                       go_tri<W>);
}

template <int RPG>
cudaError_t mt(const Launch& l, int* ctas_per_sm) {
  const int c = (l.k + MT - 1) / MT, m = c * (c + 1) / 2;
  const int threads = m * l.groups;
  const int ring = MT_STAGES * l.groups * RPG * (mt_pitch(c) + 1);
  const int fold = l.groups / 2 * m * (MT * MT + MT);
  if (l.groups < 1 || threads > MT_THREADS || ring > MT_SMEM ||
      fold > MT_SMEM)
    return cudaErrorInvalidValue;
  return fit_or_launch(xtx_narrow_mt_kernel<RPG>, threads,
                       4 * (ring > fold ? ring : fold), ctas_per_sm, l,
                       go_mt<RPG>);
}

// The partial kernel for k (launched, or with ctas_per_sm its CTAs that
// fit an SM written there and nothing launched).
cudaError_t narrow_partials(const Launch& l, int rows_per_chunk,
                            int* ctas_per_sm) {
  switch (l.k + 1) {
#define MADLIB_TRI(W) \
  case W:             \
    return tri<W>(l, rows_per_chunk, ctas_per_sm);
    MADLIB_TRI(2) MADLIB_TRI(3) MADLIB_TRI(4) MADLIB_TRI(5) MADLIB_TRI(6)
    MADLIB_TRI(7) MADLIB_TRI(8) MADLIB_TRI(9) MADLIB_TRI(10) MADLIB_TRI(11)
    MADLIB_TRI(12) MADLIB_TRI(13) MADLIB_TRI(14) MADLIB_TRI(15)
    MADLIB_TRI(16)
#undef MADLIB_TRI
    default:
      break;
  }
  static_assert(TRI_MAX_W == 16, "the cases above run to TRI_MAX_W");
  if (l.k + 1 <= TRI_MAX_W || l.groups < 1 ||
      rows_per_chunk % l.groups != 0)
    return cudaErrorInvalidValue;
  switch (rows_per_chunk / l.groups) {
    case 4:
      return mt<4>(l, ctas_per_sm);
    case 8:
      return mt<8>(l, ctas_per_sm);
    case 16:
      return mt<16>(l, ctas_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, k) and y (n,) contiguous f32, any alignment; partials (splits,
// k + 1, k + 1) scratch (only the upper triangle is written and read);
// groups and rows_per_chunk from ops.narrow_layout.  Two launches: the
// partials, then their fixed-order sums.  Returns cudaGetLastError().
extern "C" int madlib_xtx_narrow(const void* x, const void* y,
                                 void* partials, void* xtx, void* xty,
                                 long long n, int k, int splits,
                                 long long rows_per_split, int groups,
                                 int rows_per_chunk, void* stream) {
  const Launch l{static_cast<const float*>(x), static_cast<const float*>(y),
                 static_cast<float*>(partials), n, k, splits,
                 rows_per_split, groups, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = narrow_partials(l, rows_per_chunk, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = static_cast<long long>(k) * (k + 1);
  const long long warps = REDUCE_THREADS / 32;
  const unsigned blocks = static_cast<unsigned>((entries + warps - 1) / warps);
  xtx_narrow_reduce_kernel<<<blocks, REDUCE_THREADS, 0, l.stream>>>(
      l.partials, static_cast<float*>(xtx), static_cast<float*>(xty), k,
      splits);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of madlib_xtx_narrow's partial kernel for k that fit one SM of
// the current card (its registers and shared memory), or -1 on an error.
extern "C" int madlib_xtx_narrow_ctas_per_sm(int k, int groups,
                                             int rows_per_chunk) {
  int ctas = 0;
  const Launch l{nullptr, nullptr, nullptr, 0, k, 1, 1, groups, nullptr};
  const cudaError_t err = narrow_partials(l, rows_per_chunk, &ctas);
  return err == cudaSuccess ? ctas : -1;
}
