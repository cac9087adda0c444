// Causal GQA flash attention, backward, bf16, on the H100's tensor cores
// (sm_90a: wgmma, TMA, mbarrier): the gradient of flash_attention_tc.cu's
// forward with respect to q, k and v.
//
// Replaces no TPU kernel: the reference package has no backward Pallas
// kernel.  It differentiates its chunked attention
// (src/repro/models/layers.py:170-234, attention_chunked under
// jax.checkpoint).  It computes, with s = (q . k^T in f32) * scale, the
// forward's mask (the key after the query, causal, or past S: the forward
// scores those -1e30, so their p is 0 here) and the forward's log-sum-exp
// lse of each row (from the forward kernel's epilogue):
//
//   P     = exp(s - lse)                     (f32, 0 where masked)
//   delta = rowsum(dO o O)                   (f32, O the forward's output)
//   dP    = dO V^T;   dS = P o (dP - delta)  (f32)
//   dV    = bf16(P)^T dO
//   dK    = bf16(dS)^T Q * scale;   dQ = bf16(dS) K * scale
//
// with dK and dV summed over the query heads of each KV head's group, in
// f32, and dq, dk, dv rounded to bf16 once.  P and dS are rounded to bf16
// only as product operands, as the reference's bf16 gradient does (the
// cotangents of `p.astype(vc.dtype)`'s einsum at layers.py:213-215 are
// bf16).  f32 inputs, and bf16 that TMA cannot read (D % 8 != 0, or a
// pointer or stride off 16 bytes), take the FFMA kernels of
// flash_attention_bwd.cu: the wrapper (kernels/flash_attention/ops.py,
// kernel_for) chooses by dtype, D and layout, as for the forward.
//
// Bound at the training path's shape (B, Hq, Hk, S, D) =
// (2, 32, 32, 4096, 64), causal, on one H100 SXM: the five products are
// 2.5 x the forward's 4 B Hq D S (S + 1) / 2 = 3.44e11 FLOP, over 989
// TFLOP/s (bf16 dense tensor cores) 0.347 ms; bytes (q, k, v, o, dO read,
// dq, dk, dv written) 16 B H S D = 1.07e8 over 3.35 TB/s 0.032 ms.  It is
// bound by operations, on the tensor cores.
//
// Design: three kernels on the caller's stream.
//   1. rows (flash_bwd_rows.cuh, shared with the FFMA backward): delta per
//      query row in a fixed order, and the forward's lse times log2(e),
//      into an f32 scratch padded to a multiple of 64 rows a head, so that
//      a tile's 64 values are one 256-byte bulk copy.  Bound by bytes: it
//      reads O and dO once.
//   2. dK/dV: one CTA per (128 keys, KV head, batch): two consumer
//      warpgroups of 64 keys each and a producer warpgroup.  The
//      producer's first thread loads the CTA's K and V once, then streams
//      the Q and dO tiles of BQ queries (64; 32 at D = 128, see bq()) of
//      each query head of the group, and each query tile of that head in
//      order (causal: from the diagonal on), with the tile's lse and delta,
//      through a 2-stage TMA ring (128-byte swizzle, completion on
//      mbarriers; a stage is reloaded once every consumer warp has arrived
//      on its "empty" barrier).  Per tile each warpgroup forms S^T = K Q^T
//      and dP^T = V dO^T with wgmma m64nBQk16, both operands in shared
//      memory and f32 accumulators in registers: computing the transposes
//      directly keeps keys as the fragment's rows, so nothing is
//      transposed through shared memory.  P^T and dS^T are formed in
//      registers (exp2 with log2(e) folded into the scale), cast to bf16
//      in registers, and are wgmma's register A operand of dV += P^T dO
//      and dK += dS^T Q (m64nDk16, dO and Q read MN-major through the
//      transpose flag, as the forward reads V).  A thread has at most 168
//      registers (65,536 / 384), and at D = 128 dK and dV take 128 of
//      them, hence the narrower query tile there (ptxas still spills a
//      little at D = 128; setmaxnreg, which hands the producer's registers
//      to the consumers at run time, does not raise that allocation).
//   3. dQ: one CTA per (128 query rows, query head, batch): two consumer
//      warpgroups of 64 rows and a producer warpgroup streaming K and V tiles
//      of 64 keys (causal: up to the diagonal), longest causal rows
//      first.  S = Q K^T and dP = dO V^T on wgmma from shared memory; dS in
//      registers, cast to bf16 as the A operand of dQ += dS K (K read
//      MN-major).
// No float atomics and no waits between CTAs: every output element is
// written by one CTA after sums in a fixed order, so two calls give the
// same bits.  The price: dQ is a pass of its own that forms S and dP
// again, 7 products where 5 are the minimum.  D is padded to 64 or 128 by
// TMA's zero fill (at D = 80, 37.5% of the work multiplies zeros).  Rows
// and keys past S are zero-filled by TMA (or, in a tile that is an A
// operand, not loaded where a whole box lies past S) and masked; nothing
// past S is stored, so any S >= 1 works.
// The tensor maps carry each tensor's batch, head and position strides, so
// (B, S, H, D) storage seen through transpose(1, 2) needs no copy; query
// head h reads KV head h / (Hq / Hk).  The C entry returns
// cudaGetLastError() after the launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_rows.cuh"
#include "hopper.cuh"

namespace {

using namespace madlib::hopper;

constexpr int BKV = 128;          // keys per dK/dV CTA (two warpgroups)
constexpr int BM = 128;           // query rows per dQ CTA (two warpgroups)
constexpr int TK = 64;            // keys per tile streamed to dQ
constexpr int STAGES = 2;         // ring depth
constexpr int CONSUMERS = 256;    // two warpgroups
// and a producer warpgroup, of which one thread issues every copy: ptxas
// gives a thread at most 168 registers (65,536 / 384) either way, as it
// does for a lone producer warp (288 threads), and on an H100 the whole
// warpgroup ran a little faster than the warp
constexpr int THREADS = CONSUMERS + 128;
constexpr int ROW_PAD = 64;       // the rows scratch pads S to this multiple

// Queries per tile streamed to dK/dV: 64, but 32 at D = 128, where dK and dV
// of a warpgroup's 64 keys already take 128 of a thread's 168 registers
// (384 threads a CTA) and S^T and dP^T must fit beside them.
template <int DP>
__host__ __device__ constexpr int bq() {
  return DP == 128 ? 32 : 64;
}
static_assert(ROW_PAD % 64 == 0, "a query tile's rows lie in the scratch");

// A tile of R positions x DP features in shared memory: DP / 64 chunks of
// R rows x 128 bytes, swizzled, every chunk 1024-byte aligned; TMA fills it
// with boxes of BR positions (the tensor map's box: bq<DP>() for q and dO,
// TK for k and v).
template <int DP, int R>
__host__ __device__ constexpr int tile_bytes() {
  return (DP / 64) * R * ROW_BYTES;
}

// The bytes that load_tile brings for positions [r0, r0 + R).
template <int DP, int R, int BR>
__device__ __forceinline__ uint32_t tile_load_bytes(int r0, int S) {
  const int boxes = min(R / BR, (S - r0 + BR - 1) / BR);
  return static_cast<uint32_t>(boxes) * (DP / 64) * BR * ROW_BYTES;
}

// Positions [r0, r0 + R) of head (h, b) into the tile at dst, box by box.
// TMA zero-fills the part of a box past S; a box wholly past S is not
// loaded, and its rows keep whatever the shared memory held.  That is safe
// only in a tile that is wgmma's A operand (K and V in dK/dV, Q and dO in
// dQ): its rows are the products' rows, and results at positions past S
// are never stored.  A tile streamed through a ring is a B operand, whose
// rows past S must be zeros: it is one box (R == BR), which starts before
// S.
template <int DP, int R, int BR>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int S, int h,
                                          int b) {
  static_assert(R % BR == 0, "whole boxes");
#pragma unroll
  for (int i = 0; i < R / BR; ++i) {
    if (r0 + i * BR >= S) break;
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(dst + (c * R + i * BR) * ROW_BYTES, map, bar, 64 * c,
               r0 + i * BR, h, b);
  }
}

// ---------------------------------------------------------------------------
// 2. dK/dV: one CTA per (128 keys, KV head, batch)
// ---------------------------------------------------------------------------

// shared memory: [K | V | Q0 dO0 | Q1 dO1 | lse0 delta0 lse1 delta1 | bars]
template <int DP>
struct DkdvSmem {
  static constexpr int BQ = bq<DP>();
  static constexpr int KV = tile_bytes<DP, BKV>();
  static constexpr int QT = tile_bytes<DP, BQ>();
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV;
  static constexpr int RING_OFF = 2 * KV;
  static constexpr int ROWS_OFF = RING_OFF + STAGES * 2 * QT;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BARS = 1 + 2 * STAGES;  // K/V; full, empty a stage
  static constexpr int BYTES = BAR_OFF + 8 * BARS + 1024;  // + alignment
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Hq, int Hk,
                         int S, int S_pad, int D, long long dk_sb,
                         long long dk_sh, long long dk_ss, long long dv_sb,
                         long long dv_sh, long long dv_ss, float scale,
                         float scale_log2, int causal) {
  using L = DkdvSmem<DP>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* rows = reinterpret_cast<const float*>(
      smem_raw + (base - raw) + L::ROWS_OFF);
  const uint32_t kvbar = base + L::BAR_OFF;
  auto full = [&](int s) { return kvbar + 8 * (1 + s); };
  auto empty = [&](int s) { return kvbar + 8 * (1 + STAGES + s); };
  auto q_tile = [&](int s) { return base + L::RING_OFF + 2 * s * L::QT; };
  auto do_tile = [&](int s) { return q_tile(s) + L::QT; };

  const int group = Hq / Hk;
  const int hk = blockIdx.x % Hk;
  const int b = blockIdx.x / Hk;
  const int k0 = blockIdx.y * BKV;  // the slow axis: longest causal first
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(kvbar, 2 * tile_load_bytes<DP, BKV, TK>(k0, S));
      load_tile<DP, BKV, TK>(base + L::K_OFF, &tk, kvbar, k0, S, hk, b);
      load_tile<DP, BKV, TK>(base + L::V_OFF, &tv, kvbar, k0, S, hk, b);
      int t = 0;
      for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        const long long head = (static_cast<long long>(b) * Hq + h) * S_pad;
        for (int qt = qt0; qt < n_qt; ++qt, ++t) {
          const int s = t % STAGES;
          if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) + 1) & 1);
          const uint32_t r = base + L::ROWS_OFF + 2 * s * BQ * 4;
          mbar_expect_tx(full(s), 2 * L::QT + 2 * BQ * 4);
          load_tile<DP, BQ, BQ>(q_tile(s), &tq, full(s), qt * BQ, S, h, b);
          load_tile<DP, BQ, BQ>(do_tile(s), &tdo, full(s), qt * BQ, S, h,
                                b);
          bulk_load(r, lse2 + head + qt * BQ, BQ * 4, full(s));
          bulk_load(r + BQ * 4, delta + head + qt * BQ, BQ * 4, full(s));
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63; this thread keys
  // key0 and key0 + 8, and query columns 8 j + cq, + 1 of every 8
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + (lane >> 2);
  const int key1 = key0 + 8;
  const int cq = 2 * (lane & 3);
  const uint32_t ka = base + L::K_OFF + wg * 64 * ROW_BYTES;
  const uint32_t va = base + L::V_OFF + wg * 64 * ROW_BYTES;

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  mbar_wait(kvbar, 0);

  int t = 0;
  for (int g = 0; g < group; ++g) {
    for (int qt = qt0; qt < n_qt; ++qt, ++t) {
      const int s = t % STAGES;
      const uint32_t par = (t / STAGES) & 1;
      const int q0 = qt * BQ;
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        st[i] = 0.f;
        dpt[i] = 0.f;
      }
      mbar_wait(full(s), par);
      pin(st);
      pin(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 bf16 inside the swizzle row
        const uint32_t kc = (kk / 4) * BKV * ROW_BYTES + col;
        const uint32_t qc = (kk / 4) * BQ * ROW_BYTES + col;
        wgmma_ss<BQ>(st, desc_sw128(ka + kc, 16, 1024),
                     desc_sw128(q_tile(s) + qc, 16, 1024));
        wgmma_ss<BQ>(dpt, desc_sw128(va + kc, 16, 1024),
                     desc_sw128(do_tile(s) + qc, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      const float* lse_s = rows + 2 * s * BQ;
      const float* delta_s = lse_s + BQ;
      const bool edge = q0 + BQ > S || (causal && q0 < kw0 + 64);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * j + cq + e;
          const float l2 = lse_s[qi], dl = delta_s[qi];
          float p0 = exp2_ftz(st[4 * j + e] * scale_log2 - l2);
          float p1 = exp2_ftz(st[4 * j + 2 + e] * scale_log2 - l2);
          if (edge) {
            const int row = q0 + qi;
            if (row >= S || (causal && key0 > row)) p0 = 0.f;
            if (row >= S || (causal && key1 > row)) p1 = 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dl);
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dl);
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_a<BQ>(st, pa);
      pack_a<BQ>(dpt, da);

      pin(dk_acc);
      pin(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t r = kk * 16 * ROW_BYTES;  // 16 queries down
        wgmma_rs<DP>(dv_acc, pa[kk],
                     desc_sw128(do_tile(s) + r, BQ * ROW_BYTES, 1024));
        wgmma_rs<DP>(dk_acc, da[kk],
                     desc_sw128(q_tile(s) + r, BQ * ROW_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dk_acc);
      pin(dv_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }
  }

  __nv_bfloat16* dkb = dk + b * dk_sb + hk * dk_sh;
  __nv_bfloat16* dvb = dv + b * dv_sb + hk * dv_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= D) continue;
    if (key0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * dk_ss + col) =
          __floats2bfloat162_rn(dk_acc[4 * j] * scale,
                                dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * dv_ss + col) =
          __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (key1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * dk_ss + col) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2] * scale,
                                dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * dv_ss + col) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one CTA per (128 query rows, query head, batch)
// ---------------------------------------------------------------------------

// shared memory: [Q | dO | K0 V0 | K1 V1 | bars]
template <int DP>
struct DqSmem {
  static constexpr int QB = tile_bytes<DP, BM>();
  static constexpr int KT = tile_bytes<DP, TK>();
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = QB;
  static constexpr int RING_OFF = 2 * QB;
  static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * KT;
  static constexpr int BARS = 1 + 2 * STAGES;  // Q/dO; full, empty a stage
  static constexpr int BYTES = BAR_OFF + 8 * BARS + 1024;  // + alignment
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Hq, int Hk, int S,
                       int S_pad, int D, long long dq_sb, long long dq_sh,
                       long long dq_ss, float scale, float scale_log2,
                       int causal) {
  using L = DqSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qbar = base + L::BAR_OFF;
  auto full = [&](int s) { return qbar + 8 * (1 + s); };
  auto empty = [&](int s) { return qbar + 8 * (1 + STAGES + s); };
  auto k_tile = [&](int s) { return base + L::RING_OFF + 2 * s * L::KT; };
  auto v_tile = [&](int s) { return k_tile(s) + L::KT; };

  const int n_qt = (S + BM - 1) / BM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int n_kt_all = (S + TK - 1) / TK;
  const int n_kt =
      causal ? min((q0 + BM + TK - 1) / TK, n_kt_all) : n_kt_all;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer: one thread issues every copy
    if (tid == CONSUMERS) {
      constexpr int QBOX = bq<DP>();
      mbar_expect_tx(qbar, 2 * tile_load_bytes<DP, BM, QBOX>(q0, S));
      load_tile<DP, BM, QBOX>(base + L::Q_OFF, &tq, qbar, q0, S, h, b);
      load_tile<DP, BM, QBOX>(base + L::DO_OFF, &tdo, qbar, q0, S, h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) + 1) & 1);
        mbar_expect_tx(full(s), 2 * L::KT);
        load_tile<DP, TK, TK>(k_tile(s), &tk, full(s), t * TK, S, hk, b);
        load_tile<DP, TK, TK>(v_tile(s), &tv, full(s), t * TK, S, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8, and key columns 8 j + cq, + 1 of every 8
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const uint32_t qa = base + L::Q_OFF + wg * 64 * ROW_BYTES;
  const uint32_t ga = base + L::DO_OFF + wg * 64 * ROW_BYTES;
  const long long head = (static_cast<long long>(b) * Hq + h) * S_pad;
  const float l0 = r0 < S ? lse2[head + r0] : 0.f;
  const float l1 = r1 < S ? lse2[head + r1] : 0.f;
  const float d0 = r0 < S ? delta[head + r0] : 0.f;
  const float d1 = r1 < S ? delta[head + r1] : 0.f;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % STAGES;
    const uint32_t par = (t / STAGES) & 1;
    float sc[TK / 2], dp[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      sc[i] = 0.f;
      dp[i] = 0.f;
    }
    mbar_wait(full(s), par);
    pin(sc);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint32_t qc = (kk / 4) * BM * ROW_BYTES + col;
      const uint32_t kc = (kk / 4) * TK * ROW_BYTES + col;
      wgmma_ss<TK>(sc, desc_sw128(qa + qc, 16, 1024),
                   desc_sw128(k_tile(s) + kc, 16, 1024));
      wgmma_ss<TK>(dp, desc_sw128(ga + qc, 16, 1024),
                   desc_sw128(v_tile(s) + kc, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

    const int k0 = t * TK;
    const bool edge = k0 + TK > S || (causal && k0 + TK - 1 > q0 + 64 * wg);
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2_ftz(sc[4 * j + e] * scale_log2 - l0);
        float p1 = exp2_ftz(sc[4 * j + 2 + e] * scale_log2 - l1);
        if (edge) {
          const int key = k0 + 8 * j + cq + e;
          if (key >= S || (causal && key > r0)) p0 = 0.f;
          if (key >= S || (causal && key > r1)) p1 = 0.f;
        }
        dp[4 * j + e] = p0 * (dp[4 * j + e] - d0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - d1);
      }
    uint32_t da[TK / 16][4];
    pack_a<TK>(dp, da);

    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<DP>(acc, da[kk],
                   desc_sw128(k_tile(s) + kk * 16 * ROW_BYTES,
                              TK * ROW_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

  __nv_bfloat16* dqb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= D) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + r0 * dq_ss + col) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + r1 * dq_ss + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int DP>
cudaError_t launch(const Maps& m, const void* o, const void* dout,
                   const long long* st, const float* lse, float* rows,
                   void* dq, void* dk, void* dv, int B, int Hq, int Hk,
                   int S, int D, float scale, int causal,
                   cudaStream_t stream) {
  // st: the batch, head and position strides of q, k, v, o, dout, dq, dk,
  // dv in that order
  const int S_pad = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  float* lse2 = rows;
  float* delta = rows + static_cast<long long>(B) * Hq * S_pad;
  madlib::flash_bwd::flash_bwd_rows_kernel<__nv_bfloat16>
      <<<dim3(S_pad / madlib::flash_bwd::ROWS_PER_CTA, Hq, B),
         madlib::flash_bwd::ROWS_THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), st[9], st[10], st[11],
          st[12], st[13], st[14], lse, LOG2E, lse2, delta, S, S_pad, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_tc_kernel<DP>;
  constexpr int dkdv_bytes = DkdvSmem<DP>::BYTES;
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(B * Hk, (S + BKV - 1) / BKV), THREADS, dkdv_bytes, stream>>>(
      m.q, m.k, m.v, m.dout, lse2, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Hq,
      Hk, S, S_pad, D, st[18], st[19], st[20], st[21], st[22], st[23], scale,
      scale * LOG2E, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_tc_kernel<DP>;
  constexpr int dq_bytes = DqSmem<DP>::BYTES;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(B * Hq, (S + BM - 1) / BM), THREADS, dq_bytes, stream>>>(
      m.q, m.k, m.v, m.dout, lse2, delta, static_cast<__nv_bfloat16*>(dq),
      Hq, Hk, S, S_pad, D, st[15], st[16], st[17], scale, scale * LOG2E,
      causal);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, o, dout and dq (B, Hq, S, D); k, v, dk and dv (B, Hk, S, D); each
// given by its batch, head and position strides in elements (feature
// stride 1).  lse: the forward's log-sum-exp (B, Hq, S), f32 contiguous,
// natural log.  rows: f32 scratch of 2 B Hq S_pad elements, S_pad = S
// rounded up to a multiple of 64, 16-byte aligned.  Takes D % 8 == 0,
// 8 <= D <= 128, every bf16 pointer 16-byte aligned and every stride a
// multiple of 8 elements (TMA's 16-byte rule); the wrapper sends only such
// inputs here and passes a contiguous tensor's stride for an axis of size
// 1.  Launches the rows, dK/dV and dQ kernels in that order on the stream
// and returns cudaGetLastError() after them.
extern "C" int madlib_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* rows, int B, int Hq, int Hk, int S, int D, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss, float scale,
    int causal, void* stream) {
  const long long st[24] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,
                            v_sb,  v_sh,  v_ss,  o_sb,  o_sh,  o_ss,
                            do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss,
                            dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  const void* ptrs[10] = {q, k, v, o, dout, dq, dk, dv, lse, rows};
  if (Hk <= 0 || Hq % Hk != 0 || D % 8 != 0 || D < 8 || D > 128 || S < 1 ||
      B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : ptrs)
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  for (long long s : st)
    if (s % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_context(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // boxes: q and dO in the dK/dV kernel's query tiles, k and v in the dQ
  // kernel's key tiles (see load_tile)
  const int qbox = D <= 64 ? bq<64>() : bq<128>();
  Maps m;
  if (!make_map(&m.q, encode, q, D, S, Hq, B, q_sb, q_sh, q_ss, qbox) ||
      !make_map(&m.k, encode, k, D, S, Hk, B, k_sb, k_sh, k_ss, TK) ||
      !make_map(&m.v, encode, v, D, S, Hk, B, v_sb, v_sh, v_ss, TK) ||
      !make_map(&m.dout, encode, dout, D, S, Hq, B, do_sb, do_sh, do_ss,
                qbox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto stream_ = static_cast<cudaStream_t>(stream);
  auto lse_f = static_cast<const float*>(lse);
  auto rows_f = static_cast<float*>(rows);
  const cudaError_t err =
      D <= 64 ? launch<64>(m, o, dout, st, lse_f, rows_f, dq, dk, dv, B, Hq,
                           Hk, S, D, scale, causal, stream_)
              : launch<128>(m, o, dout, st, lse_f, rows_f, dq, dk, dv, B, Hq,
                            Hk, S, D, scale, causal, stream_);
  return static_cast<int>(err);
}
