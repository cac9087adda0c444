// column_stats: the count of valid rows and, per column, the sum, the sum of
// squares, the minimum and the maximum of one row block of f32 under a bool
// row mask, reading every value once.
//
// Replaces no TPU kernel.  The reference's profile transition
// (src/repro/core/templates.py, ProfileAggregate.transition) is plain jnp,
// which XLA fuses into one pass over the column.  Run eagerly in PyTorch the
// same arithmetic was eight passes over the column, four of them writing a
// whole-column temporary and four reading one back; this kernel is that one
// pass, added so the port's profile reads its table once.
//
// Bound on the H100: bytes.  A launch reads 4 n k bytes of the column and
// n of the mask, and does about 7 f32 operations a value (a product and a
// sum for sum, two products and a sum for sumsq, a min, a max), far under
// the FFMA rate.  At n = 10M, k = 320: 12.81 GB, 3.82 ms at 3.35 TB/s.
//
// Design.  A CTA owns a contiguous range of rows and walks it with
// `groups x lanes` threads: thread t takes column group t % groups (V
// neighbouring columns) of row lane t / groups, and the lanes step through
// the rows together, so a warp reads consecutive addresses of consecutive
// rows.  V = 4 (16-byte loads) when k, the row stride and the base pointer
// allow it and the columns of a row are adjacent, else 1, which takes any
// column stride (a transposed view is read where it lies).  Wide columns
// (k = 320: 80 groups, 3 lanes) read with 16-byte loads across the row;
// narrow ones (k = 1: 1 group, 256 lanes) put the threads along the rows.  Column tiles (grid.y) cover k past
// 256 groups.  Each thread keeps U rows of loads in flight (U = 4 of
// 16 bytes, or 8 of 4), about 60 KB an SM at four CTAs, and holds its
// running sums, sums of squares, minima and maxima in registers; the sums
// restart every SEGMENT rows into a second register, so no f32 chain is
// longer than SEGMENT adds on Gaussian data.  The lanes combine through
// shared memory in a fixed tree, and the second kernel adds the CTAs'
// partials in a fixed order: deterministic, no float atomics, no TF32.
// The count is an integer per CTA, summed exactly.  Given a running state
// (the fold's), the reduce adds the block into it as the eager fold did,
// state + block for the count and the sums, a NaN-keeping min and max, so
// a transition is the one pair of launches.
//
// The same function as the plain version (kernels/column_stats/ref.py):
// sum adds x * m and sumsq (x * x) * m with m = 0 or 1, so a NaN or an
// inf in a masked row still reaches them, as `col * m` does; min and max
// take only valid rows and propagate NaN as torch.amin and torch.minimum
// do (min.NaN / max.NaN, where fminf would drop it).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;   // a partial CTA holds groups x lanes <= 256
constexpr int SEGMENT = 512;   // rows of a lane's inner f32 chain
constexpr int RCOLS = 32;      // reduce: columns of a CTA, one a warp lane
constexpr int RLANES = 32;     // reduce: warps, each over every 32nd partial

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int V>
__device__ __forceinline__ void load_row(float (&v)[V], const float* p);

template <>
__device__ __forceinline__ void load_row<4>(float (&v)[4], const float* p) {
  // read once: stream past the caches
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <>
__device__ __forceinline__ void load_row<1>(float (&v)[1], const float* p) {
  v[0] = __ldcs(p);
}

template <int V>
__device__ __forceinline__ void add_row(const float (&v)[V], bool valid,
                                        float (&s)[V], float (&q)[V],
                                        float (&lo)[V], float (&hi)[V]) {
  const float m = valid ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    // x * m is exact (m is 0 or 1), so one fma rounds as x * m, then + s
    s[j] = fmaf(v[j], m, s[j]);
    q[j] = fmaf(__fmul_rn(v[j], v[j]), m, q[j]);
    lo[j] = min_nan(lo[j], valid ? v[j] : CUDART_INF_F);
    hi[j] = max_nan(hi[j], valid ? v[j] : -CUDART_INF_F);
  }
}

// partials: [gridDim.x][4][k] (sum, sumsq, min, max); counts: [gridDim.x]
template <int V, int U>
__global__ void __launch_bounds__(THREADS, 4)
column_stats_partial_kernel(const float* __restrict__ x,
                            const unsigned char* __restrict__ mask,
                            long long n, int k, long long stride,
                            long long cstride, long long mstride,
                            int groups, int lanes,
                            long long rows_per_cta,
                            float* __restrict__ partials,
                            int* __restrict__ counts) {
  __shared__ float red[4][THREADS * V];
  __shared__ int cnt[THREADS];
  const int t = threadIdx.x;
  const int g = t % groups;
  const int r = t / groups;
  const int col0 = (blockIdx.y * groups + g) * V;
  const bool live = col0 < k;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long row1 = row0 + rows_per_cta < n ? row0 + rows_per_cta : n;

  float s[V], q[V], lo[V], hi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = 0.0f;
    q[j] = 0.0f;
    lo[j] = CUDART_INF_F;
    hi[j] = -CUDART_INF_F;
  }
  int c = 0;
  if (live) {
    const float* base = x + col0 * cstride;
    const long long step = static_cast<long long>(lanes);
    for (long long seg = row0 + r; seg < row1; seg += SEGMENT * step) {
      const long long end =
          seg + SEGMENT * step < row1 ? seg + SEGMENT * step : row1;
      float s1[V], q1[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] = 0.0f;
        q1[j] = 0.0f;
      }
      long long row = seg;
      for (; row + (U - 1) * step < end; row += U * step) {
        float v[U][V];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long rr = row + u * step;
          ok[u] = mask[rr * mstride] != 0;
          load_row<V>(v[u], base + rr * stride);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          c += ok[u];
          add_row<V>(v[u], ok[u], s1, q1, lo, hi);
        }
      }
      for (; row < end; row += step) {
        float v[V];
        const bool ok = mask[row * mstride] != 0;
        load_row<V>(v, base + row * stride);
        c += ok;
        add_row<V>(v, ok, s1, q1, lo, hi);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += s1[j];
        q[j] += q1[j];
      }
    }
  }

  // the lanes of a column group, combined in a fixed tree
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][t * V + j] = s[j];
    red[1][t * V + j] = q[j];
    red[2][t * V + j] = lo[j];
    red[3][t * V + j] = hi[j];
  }
  cnt[t] = c;
  __syncthreads();
  int half = 1;
  while (half < lanes) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (r < half && r + half < lanes) {
      const int o = t + half * groups;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][t * V + j] += red[0][o * V + j];
        red[1][t * V + j] += red[1][o * V + j];
        red[2][t * V + j] = min_nan(red[2][t * V + j], red[2][o * V + j]);
        red[3][t * V + j] = max_nan(red[3][t * V + j], red[3][o * V + j]);
      }
      cnt[t] += cnt[o];
    }
    __syncthreads();
  }
  if (r == 0 && live) {
    float* out = partials + static_cast<long long>(blockIdx.x) * 4 * k + col0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = red[0][t * V + j];
      out[k + j] = red[1][t * V + j];
      out[2 * k + j] = red[2][t * V + j];
      out[3 * k + j] = red[3][t * V + j];
    }
  }
  if (t == 0 && blockIdx.y == 0) counts[blockIdx.x] = cnt[0];
}

// The running state a reduce folds the block into: each pointer to k
// floats (count to 1), or all null for the block alone.
struct Prior {
  const float* sum;
  const float* sumsq;
  const float* min;
  const float* max;
  const float* count;
};

// out: sum [k], sumsq [k], min [k], max [k], count [1]
__global__ void __launch_bounds__(RCOLS * RLANES)
column_stats_reduce_kernel(const float* __restrict__ partials,
                           const int* __restrict__ counts, int ctas, int k,
                           Prior prior, float* __restrict__ out) {
  __shared__ float red[4][RLANES][RCOLS + 1];
  __shared__ unsigned long long total;
  const int c = threadIdx.x % RCOLS;
  const int l = threadIdx.x / RCOLS;
  const int col = blockIdx.x * RCOLS + c;
  float s = 0.0f, q = 0.0f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
  if (col < k) {
    // unrolled so several partials' loads are in flight at once
#pragma unroll 4
    for (int p = l; p < ctas; p += RLANES) {
      const float* in = partials + static_cast<long long>(p) * 4 * k + col;
      s += in[0];
      q += in[k];
      lo = min_nan(lo, in[2 * k]);
      hi = max_nan(hi, in[3 * k]);
    }
  }
  red[0][l][c] = s;
  red[1][l][c] = q;
  red[2][l][c] = lo;
  red[3][l][c] = hi;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  for (int half = RLANES / 2; half > 0; half >>= 1) {
    if (l < half) {
      red[0][l][c] += red[0][l + half][c];
      red[1][l][c] += red[1][l + half][c];
      red[2][l][c] = min_nan(red[2][l][c], red[2][l + half][c]);
      red[3][l][c] = max_nan(red[3][l][c], red[3][l + half][c]);
    }
    __syncthreads();
  }
  if (l == 0 && col < k) {
    s = red[0][0][c];
    q = red[1][0][c];
    lo = red[2][0][c];
    hi = red[3][0][c];
    if (prior.sum != nullptr) {
      // the eager fold's ops: state + block, minimum, maximum
      s = prior.sum[col] + s;
      q = prior.sumsq[col] + q;
      lo = min_nan(prior.min[col], lo);
      hi = max_nan(prior.max[col], hi);
    }
    out[col] = s;
    out[k + col] = q;
    out[2 * k + col] = lo;
    out[3 * k + col] = hi;
  }
  if (blockIdx.x == 0) {
    // integers: exact in any order
    unsigned long long mine = 0;
    for (int p = threadIdx.x; p < ctas; p += blockDim.x)
      mine += static_cast<unsigned long long>(counts[p]);
    atomicAdd(&total, mine);
    __syncthreads();
    if (threadIdx.x == 0) {
      const float block = __ull2float_rn(total);
      out[4 * k] = prior.count != nullptr ? *prior.count + block : block;
    }
  }
}

}  // namespace

// work: ctas * 4 * k floats of partials, then ctas ints of counts; p_*:
// the running state's sum, sumsq, min, max and count, or five nulls
extern "C" int madlib_column_stats(const void* x, const void* mask,
                                   void* work, void* out, const void* p_sum,
                                   const void* p_sumsq, const void* p_min,
                                   const void* p_max, const void* p_count,
                                   long long n, int k, long long stride,
                                   long long cstride, long long mstride,
                                   int vec, int groups, int lanes, int tiles,
                                   int ctas, long long rows_per_cta,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const unsigned char* mb = static_cast<const unsigned char*>(mask);
  float* partials = static_cast<float*>(work);
  int* counts = reinterpret_cast<int*>(partials +
                                       static_cast<long long>(ctas) * 4 * k);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(tiles));
  const int threads = groups * lanes;
  if (vec)
    column_stats_partial_kernel<4, 4><<<grid, threads, 0, st>>>(
        xf, mb, n, k, stride, 1, mstride, groups, lanes, rows_per_cta,
        partials, counts);
  else
    column_stats_partial_kernel<1, 8><<<grid, threads, 0, st>>>(
        xf, mb, n, k, stride, cstride, mstride, groups, lanes, rows_per_cta,
        partials, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((k + RCOLS - 1) / RCOLS);
  const Prior pr{static_cast<const float*>(p_sum),
                 static_cast<const float*>(p_sumsq),
                 static_cast<const float*>(p_min),
                 static_cast<const float*>(p_max),
                 static_cast<const float*>(p_count)};
  column_stats_reduce_kernel<<<blocks, RCOLS * RLANES, 0, st>>>(
      partials, counts, ctas, k, pr, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
