// Causal GQA flash attention, forward, for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:29
// (`_kernel`, launched by `flash_attention_padded` at :80 through
// `pl.pallas_call` at :91).  It computes what that body computes:
//
//   s   = (q . k^T in f32) * scale                      (scale after the dot)
//   s   = -1e30 where the key lies after the query (causal) or past S
//   m   = max(m, rowmax s);  alpha = exp(m_old - m);  p = exp(s - m)   (f32)
//   l   = alpha * l + rowsum p;  acc = alpha * acc + p . v   (p stays f32)
//   out = acc / max(l, 1e-30), in q's type
//
// with query head h of batch b reading KV head h / (Hq / Hk) of batch b, so
// no K/V replication is materialised.
//
// Design: one CTA of 128 threads per (q tile of 64 rows, query head,
// batch).  A loop over KV tiles of 64 keys stands in for the TPU's
// sequential third grid axis; the causal loop stops at the diagonal tile.
// Q^T, K^T and V tiles are staged in shared memory as f32 (converted from
// bf16 on load); P^T reuses K^T's space once the scores are taken.
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4 ty .. 4 ty + 3:
// their m and l, the scores of keys 8 tx .. 8 tx + 7, and the accumulator
// columns 4 tx + 32 g .. + 3.  The eight threads of a row group are
// neighbouring lanes of one warp, so row maxima and sums are shuffles.
// Every output row is written by one CTA, with no atomics: the result
// repeats from run to run.  Rows and keys past S are masked in the kernel,
// so any S >= 1 is taken.  q, k, v and o are read and written through
// their strides (batch, head, position; the feature stride is 1), so the
// (B, S, H, D) projections of the model need no copy.
//
// Bound at the main path's shape (B, Hq, Hk, S, D) = (2, 32, 8, 4096, 128),
// bf16, causal, on one H100 SXM:
//   operations 4 B Hq D S (S + 1) / 2 = 2.75e11 FLOP over 989 TFLOP/s
//              (bf16 dense tensor cores) = 0.278 ms;
//   bytes      (q + o) B Hq S D 2 + (k + v) B Hk S D 2 = 168 MB over
//              3.35 TB/s = 0.050 ms.
// It is bound by operations.  This kernel does them as f32 FFMA on the SMs'
// CUDA cores, whose peak is 67 TFLOP/s: even at that peak it would stand
// 14.8x from the tensor-core bound, and with the shared-memory loads and
// the exp of every score beside the FFMA it stands further off.  The
// tensor-core version (mma.sync / wgmma on bf16 tiles, TMA loads) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;            // query rows per CTA
constexpr int TK = 64;            // keys per KV tile
constexpr int THREADS = 128;
constexpr int LDT = TQ + 4;       // row stride of the transposed tiles
constexpr float NEG = -1e30f;     // the mask value (never -inf: no NaN)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

// rows of the K^T space, which later holds P^T (TK rows)
template <int DP>
__host__ __device__ constexpr int kt_rows() {
  return DP > TK ? DP : TK;
}

template <int DP>
constexpr int smem_bytes() {
  // Q^T (DP x LDT), K^T then P^T (kt_rows x LDT), V (TK x DP)
  return ((DP + kt_rows<DP>()) * LDT + TK * DP) * 4;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int S, int D, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int causal) {
  static_assert(DP % 32 == 0 && DP <= 128, "DP");
  constexpr int NG = DP / 32;     // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* sQT = reinterpret_cast<float*>(smem4);   // [DP][LDT]
  float* sKT = sQT + DP * LDT;                    // [DP][LDT]
  float* sPT = sKT;                               // [TK][LDT]
  float* sV = sKT + kt_rows<DP>() * LDT;          // [TK][DP]

  const int n_qt = (S + TQ - 1) / TQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = qt * TQ;

  for (int e = tid; e < TQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    const int row = q0 + r;
    sQT[d * LDT + r] =
        (row < S && d < D) ? to_f32(qb[row * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (S + TK - 1) / TK;
  const int n_kt = causal ? min(qt + 1, n_kt_all) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();  // the last tile's P^T and V are read; Q^T is staged
    for (int e = tid; e < TK * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      const int key = k0 + r;
      const bool in = key < S && d < D;
      sKT[d * LDT + r] = in ? to_f32(kb[key * ks.s + d]) : 0.f;
      sV[r * DP + d] = in ? to_f32(vb[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          &sQT[d * LDT + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(
          &sKT[d * LDT + tx * 8]);
      const float4 kc = *reinterpret_cast<const float4*>(
          &sKT[d * LDT + tx * 8 + 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    const bool edge = (causal && kt == qt) || (k0 + TK > S);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mc = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j] * scale;
        if (edge) {
          const int col = k0 + tx * 8 + j;
          if (col >= S || (causal && col > row)) x = NEG;
        }
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
      const float m_new = fmaxf(m[i], mc);
      alpha[i] = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l[i] = alpha[i] * l[i] + ps;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done with K^T: it becomes P^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&sPT[(tx * 8 + j) * LDT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int r = 0; r < TK; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(
          &sPT[r * LDT + ty * 4]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &sV[r * DP + g * 32 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pr[i], v4.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pr[i], v4.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pr[i], v4.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pr[i], v4.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 32 + tx * 4 + c;
        if (d < D) ob[row * os.s + d] = from_f32<T>(acc[i][g * 4 + c] / denom);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hk, int S, int D, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DP>;
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TQ - 1) / TQ, Hq, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hk, S, D, qs, ks,
      vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dp(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hk, int S, int D, Strides qs,
                        Strides ks, Strides vs, Strides os, float scale,
                        int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, Hq, Hk, S, D, qs, ks, vs, os, scale,
                         causal, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hk, S, D, qs, ks, vs, os, scale,
                         causal, stream);
  return launch<T, 128>(q, k, v, o, B, Hq, Hk, S, D, qs, ks, vs, os, scale,
                        causal, stream);
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hk, S, D), o (B, Hq, S, D), each given by its
// batch, head and position strides in elements (feature stride 1).
// dtype 0 is float32, 1 is bfloat16.  The wrapper checks Hq % Hk == 0,
// 1 <= D <= 128 and S >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int madlib_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hk, int S, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || D < 1 || D > 128 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? dispatch_dp<__nv_bfloat16>(q, k, v, o, B, Hq, Hk, S, D, qs, ks,
                                       vs, os, scale, causal, st)
          : dispatch_dp<float>(q, k, v, o, B, Hq, Hk, S, D, qs, ks, vs, os,
                               scale, causal, st);
  return static_cast<int>(err);
}
