// Causal GQA flash attention, backward, for the H100 (sm_90a): the FFMA
// kernels, the gradient with respect to q, k and v for f32 inputs and for
// bf16 that TMA cannot read (head dimension D not a multiple of 8, or a
// pointer or stride off 16 bytes).  Other bf16 (every config of the repo)
// takes the tensor-core backward in flash_attention_bwd_tc.cu; the wrapper
// (kernels/flash_attention/ops.py, kernel_for) chooses by dtype, D and
// layout, as for the forward.
//
// Replaces no TPU kernel: the reference package has no backward Pallas
// kernel.  It differentiates its chunked attention
// (src/repro/models/layers.py:170-234, attention_chunked under
// jax.checkpoint) where the port's training path runs the forward kernel
// of src/repro/kernels/flash_attention/kernel.py:29.  It computes, with
// s = (q . k^T in f32) * scale, the forward's mask (-1e30 where the key
// lies after the query, causal, or past S) and the forward's log-sum-exp
// lse of each row (natural log, from the forward kernel's epilogue):
//
//   P     = exp(s - lse)                     (0 where masked)
//   delta = rowsum(dO o O)                   (O the forward's output)
//   dV    = P^T dO;   dP = dO V^T;   dS = P o (dP - delta)
//   dQ    = dS K * scale;   dK = dS^T Q * scale
//
// with dK and dV summed over the query heads of each KV head's group, and
// dq, dk, dv rounded to the input type once.
//
// Design: three kernels on the caller's stream, 128 threads each.
//   1. rows:  delta per query row into an f32 scratch (B, Hq, S)
//      (flash_bwd_rows.cuh, shared with the tensor-core backward).
//   2. dk/dv: one CTA per (64 keys, KV head, batch) keeps its keys' dK and
//      dV in registers (thread (ty, tx) owns keys 4 ty .. 4 ty + 3 and the
//      feature columns 4 tx + 32 g .. + 3) and walks the group's query
//      heads and, for each, the query tiles of 32 rows in order (causal:
//      from the diagonal on).  Per tile it forms P^T and dP^T (4 keys x 4
//      queries a thread), dS^T, stages P and dS in shared memory and adds
//      P^T dO and dS^T Q.
//   3. dq:    one CTA per (64 query rows, query head, batch) keeps dQ in
//      registers and walks the key tiles of 64 (causal: up to the
//      diagonal), forming P and dP (4 rows x 8 keys a thread), dS, staging
//      dS^T in shared memory and adding dS K.
// Every output element is written by one thread of one CTA after sums in a
// fixed order: no atomics, so two calls give the same bits.  Inputs are
// read through their batch, head and position strides (feature stride 1)
// and converted to f32 as they are staged; rows and keys past S are masked
// in the kernels, so any S >= 1 is taken.
//
// Bound at the training path's shape (B, Hq, Hk, S, D) =
// (2, 32, 32, 4096, 64), f32, causal, on one H100 SXM: the backward's five
// products are 2.5 x the forward's 4 B Hq D S^2 / 2 = 3.44e11 FLOP, over
// 67 TFLOP/s (f32 outside the tensor cores; the port does not use TF32)
// 5.13 ms; bytes (q, k, v, o, dO read, dq, dk, dv written) 4 x 8 x B H S D
// = 2.1e8 over 3.35 TB/s 0.064 ms.  It is bound by operations, and does
// 7 products where 5 are needed (q k^T and dO v^T again for dQ).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_rows.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TQ = 64;            // query rows per CTA (rows, dq)
constexpr int TK = 64;            // keys per tile (dq) and per CTA (dk/dv)
constexpr int TQ2 = 32;           // query rows per tile in the dk/dv kernel
constexpr int LD = 68;            // row stride of 64-wide transposed tiles
constexpr int LD2 = TQ2 + 4;      // row stride of 32-wide transposed tiles

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

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;               // the forward's, (B, Hq, S) f32
  float* delta;                   // (B, Hq, S) f32 scratch
  int group, S, D;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [r0, r0 + R) of a (S, D) head slice as f32: transposed into
// t[d * ldt + r] when t != nullptr, row-major into m[r * DP + d] when
// m != nullptr; zeros past S and past D.
template <typename T, int DP, int R>
__device__ __forceinline__ void stage(const T* base, long long stride, int r0,
                                      int S, int D, float* t, int ldt,
                                      float* m) {
  for (int e = threadIdx.x; e < R * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    const int row = r0 + r;
    const float x =
        (row < S && d < D) ? to_f32(base[row * stride + d]) : 0.f;
    if (t != nullptr) t[d * ldt + r] = x;
    if (m != nullptr) m[r * DP + d] = x;
  }
}

// ---------------------------------------------------------------------------
// 2. dk/dv: one CTA per (64 keys, KV head, batch)
// ---------------------------------------------------------------------------

template <int DP>
constexpr int dkdv_smem_floats() {
  // K^T, V^T (DP x LD); Q^T, dO^T (DP x LD2); Q, dO (TQ2 x DP);
  // P, dS (TQ2 x LD); lse, delta (TQ2)
  return 2 * DP * LD + 2 * DP * LD2 + 2 * TQ2 * DP + 2 * TQ2 * LD + 2 * TQ2;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, DP > 64 ? 1 : 2)
flash_bwd_dkdv_kernel(Args a) {
  static_assert(DP % 32 == 0 && DP <= 128, "DP");
  constexpr int NG = DP / 32;
  extern __shared__ float4 smem4[];
  float* sKT = reinterpret_cast<float*>(smem4);   // [DP][LD]
  float* sVT = sKT + DP * LD;                     // [DP][LD]
  float* sQT = sVT + DP * LD;                     // [DP][LD2]
  float* sGT = sQT + DP * LD2;                    // dO^T [DP][LD2]
  float* sQ = sGT + DP * LD2;                     // [TQ2][DP]
  float* sG = sQ + TQ2 * DP;                      // dO [TQ2][DP]
  float* sP = sG + TQ2 * DP;                      // P [TQ2][LD] (query-major)
  float* sDS = sP + TQ2 * LD;                     // dS [TQ2][LD]
  float* sLse = sDS + TQ2 * LD;                   // [TQ2]
  float* sDelta = sLse + TQ2;                     // [TQ2]

  const int S = a.S, D = a.D;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * a.group;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int k0 = kt * TK;

  stage<T, DP, TK>(kb, a.ks.s, k0, S, D, sKT, LD, nullptr);
  stage<T, DP, TK>(vb, a.vs.s, k0, S, D, sVT, LD, nullptr);

  float dk[4][4 * NG], dv[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int n_qt = (S + TQ2 - 1) / TQ2;
  const int qt_first = a.causal ? k0 / TQ2 : 0;
  for (int g = 0; g < a.group; ++g) {
    const int h = hk * a.group + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* gb = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const long long head = (static_cast<long long>(b) * Hq + h) * S;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * TQ2;
      __syncthreads();  // the last tile's Q, dO, P and dS are read
      stage<T, DP, TQ2>(qb, a.qs.s, q0, S, D, sQT, LD2, sQ);
      stage<T, DP, TQ2>(gb, a.dos.s, q0, S, D, sGT, LD2, sG);
      if (tid < TQ2) {
        const int row = q0 + tid;
        sLse[tid] = row < S ? a.lse[head + row] : 0.f;
        sDelta[tid] = row < S ? a.delta[head + row] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dP^T = V dO^T: keys 4 ty + i, queries 4 tx + j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        const float4 k4 = ld4(&sKT[d * LD + ty * 4]);
        const float4 v4 = ld4(&sVT[d * LD + ty * 4]);
        const float4 q4 = ld4(&sQT[d * LD2 + tx * 4]);
        const float4 g4 = ld4(&sGT[d * LD2 + tx * 4]);
        const float kr[4] = {k4.x, k4.y, k4.z, k4.w};
        const float vr[4] = {v4.x, v4.y, v4.z, v4.w};
        const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
        const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], gr[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx * 4 + j;
        const float lse = sLse[tx * 4 + j], delta = sDelta[tx * 4 + j];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + ty * 4 + i;
          const bool masked =
              row >= S || key >= S || (a.causal && key > row);
          p[i] = masked ? 0.f : expf(s[i][j] * a.scale - lse);
          ds[i] = p[i] * (dp[i][j] - delta);
        }
        *reinterpret_cast<float4*>(&sP[(tx * 4 + j) * LD + ty * 4]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&sDS[(tx * 4 + j) * LD + ty * 4]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's 32 queries, in order
#pragma unroll 2
      for (int r = 0; r < TQ2; ++r) {
        const float4 p4 = ld4(&sP[r * LD + ty * 4]);
        const float4 s4 = ld4(&sDS[r * LD + ty * 4]);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float4 g4 = ld4(&sG[r * DP + gg * 32 + tx * 4]);
          const float4 q4 = ld4(&sQ[r * DP + gg * 32 + tx * 4]);
          const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
          const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dv[i][gg * 4 + c] = fmaf(pr[i], gr[c], dv[i][gg * 4 + c]);
              dk[i][gg * 4 + c] = fmaf(sr[i], qr[c], dk[i][gg * 4 + c]);
            }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dks.b + hk * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = gg * 32 + tx * 4 + c;
        if (d < D) {
          dkb[key * a.dks.s + d] = from_f32<T>(dk[i][gg * 4 + c] * a.scale);
          dvb[key * a.dvs.s + d] = from_f32<T>(dv[i][gg * 4 + c]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one CTA per (64 query rows, query head, batch)
// ---------------------------------------------------------------------------

template <int DP>
constexpr int dq_smem_floats() {
  // Q^T, dO^T, K^T (then dS^T), V^T (DP x LD, K^T at least TK rows);
  // K (TK x DP)
  return (3 * DP + (DP > TK ? DP : TK)) * LD + TK * DP;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(Args a) {
  static_assert(DP % 32 == 0 && DP <= 128, "DP");
  constexpr int NG = DP / 32;
  constexpr int KT_ROWS = DP > TK ? DP : TK;
  extern __shared__ float4 smem4[];
  float* sQT = reinterpret_cast<float*>(smem4);   // [DP][LD]
  float* sGT = sQT + DP * LD;                     // dO^T [DP][LD]
  float* sVT = sGT + DP * LD;                     // [DP][LD]
  float* sKT = sVT + DP * LD;                     // [KT_ROWS][LD]
  float* sST = sKT;                               // dS^T [TK][LD]
  float* sK = sKT + KT_ROWS * LD;                 // [TK][DP]

  const int S = a.S, D = a.D;
  const int n_qt = (S + TQ - 1) / TQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* gb = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = qt * TQ;
  const long long head = (static_cast<long long>(b) * gridDim.y + h) * S;

  stage<T, DP, TQ>(qb, a.qs.s, q0, S, D, sQT, LD, nullptr);
  stage<T, DP, TQ>(gb, a.dos.s, q0, S, D, sGT, LD, nullptr);
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse[i] = row < S ? a.lse[head + row] : 0.f;
    delta[i] = row < S ? a.delta[head + row] : 0.f;
  }

  float acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (S + TK - 1) / TK;
  const int n_kt = a.causal ? min(qt + 1, n_kt_all) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();  // the last tile's dS^T and K are read
    stage<T, DP, TK>(kb, a.ks.s, k0, S, D, sKT, LD, sK);
    stage<T, DP, TK>(vb, a.vs.s, k0, S, D, sVT, LD, nullptr);
    __syncthreads();

    // s = Q K^T and dP = dO V^T: rows 4 ty + i, keys 8 tx + j
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < DP; ++d) {
      const float4 q4 = ld4(&sQT[d * LD + ty * 4]);
      const float4 g4 = ld4(&sGT[d * LD + ty * 4]);
      const float4 ka = ld4(&sKT[d * LD + tx * 8]);
      const float4 kc = ld4(&sKT[d * LD + tx * 8 + 4]);
      const float4 va = ld4(&sVT[d * LD + tx * 8]);
      const float4 vc = ld4(&sVT[d * LD + tx * 8 + 4]);
      const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
      const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
      const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
      const float vr[8] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
          dp[i][j] = fmaf(gr[i], vr[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx * 8 + j;
        const bool masked = row >= S || key >= S || (a.causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] * a.scale - lse[i]);
        s[i][j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();  // every thread is done with K^T: it becomes dS^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&sST[(tx * 8 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < TK; ++r) {
      const float4 s4 = ld4(&sST[r * LD + ty * 4]);
      const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        const float4 k4 = ld4(&sK[r * DP + gg * 32 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][gg * 4 + 0] = fmaf(sr[i], k4.x, acc[i][gg * 4 + 0]);
          acc[i][gg * 4 + 1] = fmaf(sr[i], k4.y, acc[i][gg * 4 + 1]);
          acc[i][gg * 4 + 2] = fmaf(sr[i], k4.z, acc[i][gg * 4 + 2]);
          acc[i][gg * 4 + 3] = fmaf(sr[i], k4.w, acc[i][gg * 4 + 3]);
        }
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = gg * 32 + tx * 4 + c;
        if (d < D) dqb[row * a.dqs.s + d] = from_f32<T>(acc[i][gg * 4 + c] * a.scale);
      }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int B, int Hq, int Hk,
                   cudaStream_t stream) {
  const int S = a.S;
  constexpr int dkdv_bytes = dkdv_smem_floats<DP>() * 4;
  constexpr int dq_bytes = dq_smem_floats<DP>() * 4;
  auto dkdv = flash_bwd_dkdv_kernel<T, DP>;
  auto dq = flash_bwd_dq_kernel<T, DP>;
  cudaError_t err = set_smem(dkdv, dkdv_bytes);
  if (err == cudaSuccess) err = set_smem(dq, dq_bytes);
  if (err != cudaSuccess) return err;
  const int n_q = (S + TQ - 1) / TQ, n_k = (S + TK - 1) / TK;
  madlib::flash_bwd::flash_bwd_rows_kernel<T>
      <<<dim3(n_q, Hq, B), madlib::flash_bwd::ROWS_THREADS, 0, stream>>>(
          static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.os.b,
          a.os.h, a.os.s, a.dos.b, a.dos.h, a.dos.s, a.lse, 1.f, nullptr,
          a.delta, S, S, a.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(n_k, Hk, B), THREADS, dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<dim3(n_q, Hq, B), THREADS, dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dp(const Args& a, int B, int Hq, int Hk,
                        cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, B, Hq, Hk, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, Hq, Hk, stream);
  return launch<T, 128>(a, B, Hq, Hk, stream);
}

}  // namespace

// q, o, dout and dq (B, Hq, S, D); k, v, dk and dv (B, Hk, S, D); each given
// by its batch, head and position strides in elements (feature stride 1).
// lse: the forward's log-sum-exp (B, Hq, S), f32 contiguous, natural log;
// delta: f32 scratch of B * Hq * S elements.  dtype 0 is float32, 1 is
// bfloat16.  Launches the rows, dk/dv and dq kernels in that order on the
// stream.  Returns cudaGetLastError() after the launches.
extern "C" int madlib_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, int dtype, int B, int Hq, int Hk, int S, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int causal, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || D < 1 || D > 128 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.group = Hq / Hk;
  a.S = S;
  a.D = D;
  a.qs = {q_sb, q_sh, q_ss};
  a.ks = {k_sb, k_sh, k_ss};
  a.vs = {v_sb, v_sh, v_ss};
  a.os = {o_sb, o_sh, o_ss};
  a.dos = {do_sb, do_sh, do_ss};
  a.dqs = {dq_sb, dq_sh, dq_ss};
  a.dks = {dk_sb, dk_sh, dk_ss};
  a.dvs = {dv_sb, dv_sh, dv_ss};
  a.scale = scale;
  a.causal = causal;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch_dp<__nv_bfloat16>(a, B, Hq, Hk, st)
                 : dispatch_dp<float>(a, B, Hq, Hk, st);
  return static_cast<int>(err);
}
