// Causal GQA flash attention, forward, bf16, on the H100's tensor cores
// (sm_90a: wgmma, TMA, mbarrier).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:29
// (`_kernel`, launched by `flash_attention_padded` at :80 through
// `pl.pallas_call` at :91) for bf16 inputs whose head dimension D is a
// multiple of 8.  It computes what that body computes:
//
//   s   = (q . k^T in f32) * scale
//   s   = -1e30 where the key lies after the query (causal) or past S
//   m   = max(m, rowmax s);  alpha = exp(m_old - m);  p = exp(s - m)   (f32)
//   l   = alpha * l + rowsum p;  acc = alpha * acc + bf16(p) . v
//   out = acc / max(l, 1e-30), in bf16
//   lse = (m + log2 l) ln 2  (natural log; only when the caller asks)
//
// p is rounded to bf16 before the PV product, as the reference's chunked
// path does (`p.astype(vc.dtype)`); l sums the f32 p.  f32 inputs, and
// bf16 that TMA cannot read (D % 8 != 0, or a pointer or stride off 16
// bytes), take the FFMA kernel of flash_attention.cu: the wrapper
// (kernels/flash_attention/ops.py, kernel_for) chooses by dtype, D and
// layout.
//
// Bound at the main path's shape (B, Hq, Hk, S, D) = (2, 32, 8, 4096, 128),
// causal, on one H100 SXM:
//   operations 4 B Hq D S (S + 1) / 2 = 2.75e11 FLOP over 989 TFLOP/s
//              (bf16 dense tensor cores) = 0.278 ms;
//   bytes      (q + o) B Hq S D 2 + (k + v) B Hk S D 2 = 168 MB over
//              3.35 TB/s = 0.050 ms.
// It is bound by operations, on the tensor cores, where the FFMA kernel
// could reach at best 1/14.8 of that rate.
//
// Design.  One CTA per (128 query rows, query head, batch): two consumer
// warpgroups of 64 query rows each and one producer warp.
//   * The producer's lane 0 loads the Q tile once and streams K and V
//     tiles of 128 keys through a 2-stage ring in shared memory with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, completion on mbarriers;
//     the tensor maps come from cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so nothing links against libcuda).  A stage
//     is reloaded once every consumer warp has arrived on its "empty"
//     barrier.  The tensor maps carry q/k/v's own batch, head and position
//     strides, so (B, S, H, D) storage seen through transpose(1, 2) gives
//     the same tiles and the same bits; query head h reads KV head
//     h / (Hq / Hk) of its batch, with no copy.
//   * S = Q K^T: wgmma m64n128k16, Q and K both read from shared memory
//     through descriptors, f32 accumulators in registers.
//   * The online softmax runs on the accumulator fragment in registers,
//     in base 2 (log2(e) folded into the scale); masked scores are -1e30,
//     never -inf.  Each thread holds two rows; a row's max is two shuffles
//     across its quad, and its sum stays per thread until the end.
//   * P is cast to bf16 in registers and is wgmma's register A operand for
//     O += P V (m64nDk16, V's tile read MN-major through the transpose
//     flag): P never goes back to shared memory.
//   * Rows past S are not stored and keys past S are masked (TMA fills
//     them with zeros), so any S >= 1 works; D is padded to 64 or 128 by
//     the same zero fill.  Causal tiles above the diagonal are skipped,
//     and the grid's slow axis launches the longest causal rows first.
//     Every output row is written by one CTA, with no atomics: results
//     repeat bit for bit.  The C entry returns cudaGetLastError().
//   * When asked, the epilogue also writes each row's log-sum-exp, which
//     the backward (flash_attention_bwd_tc.cu, flash_attention_bwd.cu)
//     takes in place of recomputing q k^T: stored in natural log, as the
//     FFMA forward stores it, from the base-2 m and l here.  The mbarrier,
//     TMA and wgmma helpers are shared with the backward in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace madlib::hopper;

constexpr int BM = 128;           // query rows per CTA (two warpgroups)
constexpr int TK = 128;           // keys per K/V tile
constexpr int STAGES = 2;         // K/V ring depth
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
static_assert(BM == TK, "one tensor-map box shape serves Q, K and V");

// shared memory: [Q | K0 V0 | K1 V1 | barriers], each tile 64-column chunks
// of (rows x 128 bytes), every chunk 1024-byte aligned for the swizzle
template <int DP>
struct Smem {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int Q_BYTES = CHUNKS * BM * ROW_BYTES;
  static constexpr int KV_BYTES = CHUNKS * TK * ROW_BYTES;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = K_OFF + STAGES * STAGE_BYTES;
  // q, full K and V per stage, empty per stage
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * BARS + 1024;  // + alignment
};

template <int DP, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Hq, int group,
                          int S, int D, long long o_sb, long long o_sh,
                          long long o_ss, float scale_log2, int causal) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t qbar = base + L::BAR_OFF;
  auto full_k = [&](int s) { return qbar + 8 * (1 + s); };
  auto full_v = [&](int s) { return qbar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return qbar + 8 * (1 + 2 * STAGES + s); };
  auto k_tile = [&](int s) { return base + L::K_OFF + s * L::STAGE_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + L::KV_BYTES; };

  const int n_qt = (S + BM - 1) / BM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / group;
  const int q0 = qt * BM;
  const int n_kt_all = (S + TK - 1) / TK;
  const int n_kt =
      causal ? min((q0 + BM + TK - 1) / TK, n_kt_all) : n_kt_all;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: its lane 0 issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < L::CHUNKS; ++c)
        tma_load(sq + c * BM * ROW_BYTES, &tq, qbar, 64 * c, q0, h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) + 1) & 1);
        mbar_expect_tx(full_k(s), L::KV_BYTES);
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(k_tile(s) + c * TK * ROW_BYTES, &tk, full_k(s), 64 * c,
                   t * TK, hk, b);
        mbar_expect_tx(full_v(s), L::KV_BYTES);
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(v_tile(s) + c * TK * ROW_BYTES, &tv, full_v(s), 64 * c,
                   t * TK, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8, and columns 8 j + cq, + 1 of every 8-column block
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const uint32_t qa = sq + wg * 64 * ROW_BYTES;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % STAGES;
    const uint32_t par = (t / STAGES) & 1;
    float sc[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
    mbar_wait(full_k(s), par);
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 16 bf16 inside the swizzle row
      wgmma_ss_n128(
          sc, desc_sw128(qa + (kk / 4) * BM * ROW_BYTES + col, 16, 1024),
          desc_sw128(k_tile(s) + (kk / 4) * TK * ROW_BYTES + col, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    const int k0 = t * TK;
    const bool edge = k0 + TK > S || (causal && k0 + TK - 1 > q0 + 64 * wg);
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale_log2;
        float x1 = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + cq + e;
          if (col >= S || (causal && col > r0)) x0 = NEG;
          if (col >= S || (causal && col > r1)) x1 = NEG;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[TK / 16][4];  // wgmma's A fragment for keys 16 kk .. + 15
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool hi = (i & 2) != 0;
        const float p = exp2_ftz(sc[8 * kk + i] - (hi ? mn1 : mn0));
        sc[8 * kk + i] = p;
        if (hi)
          ps1 += p;
        else
          ps0 += p;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    }
    l0 = a0 * l0 + ps0;
    l1 = a1 * l1 + ps1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }

    mbar_wait(full_v(s), par);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<DP>(acc, pa[kk],
                   desc_sw128(v_tile(s) + kk * 16 * ROW_BYTES,
                              TK * ROW_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (LSE && (lane & 3) == 0) {
    // the natural log: m and l are in base 2 here
    float* lb = lse + (static_cast<long long>(b) * Hq + h) * S;
    if (r0 < S) lb[r0] = (m0 + log2f(d0)) * LN2;
    if (r1 < S) lb[r1] = (m1 + log2f(d1)) * LN2;
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= D) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_ss + col) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_ss + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, float* lse, int B, int Hq,
                   int Hk, int S, int D, long long o_sb, long long o_sh,
                   long long o_ss, float scale, int causal,
                   cudaStream_t stream) {
  // without lse an instantiation of its own, whose code has no epilogue
  // branch: serving does not pay for the backward's output
  auto kernel = lse == nullptr ? flash_attention_tc_kernel<DP, false>
                               : flash_attention_tc_kernel<DP, true>;
  constexpr int bytes = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (S + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hq / Hk, S, D,
      o_sb, o_sh, o_ss, scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B, Hq, S, D), k and v (B, Hk, S, D), o (B, Hq, S, D), each given
// by its batch, head and position strides in elements (feature stride 1).
// lse, when not null, receives each row's log-sum-exp of the scaled, masked
// scores in natural log, f32 (B, Hq, S) contiguous; null writes nothing and
// leaves o's bits as they are without it.  Takes D % 8 == 0, 8 <= D <= 128,
// every pointer 16-byte aligned and every stride a multiple of 8 elements
// (TMA's 16-byte rule); the wrapper sends only such inputs here and passes
// a contiguous tensor's stride for an axis of size 1.
// Returns cudaGetLastError() after the launch.
extern "C" int madlib_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hk, int S, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, void* stream) {
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  if (Hk <= 0 || Hq % Hk != 0 || D % 8 != 0 || D < 8 || D > 128 || S < 1 ||
      B < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  for (long long s : strides)
    if (s % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_context(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, D, S, Hq, B, q_sb, q_sh, q_ss, BM) ||
      !make_map(&tk, encode, k, D, S, Hk, B, k_sb, k_sh, k_ss, TK) ||
      !make_map(&tv, encode, v, D, S, Hk, B, v_sb, v_sh, v_ss, TK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      D <= 64 ? launch<64>(tq, tk, tv, o, static_cast<float*>(lse), B, Hq,
                           Hk, S, D, o_sb, o_sh, o_ss, scale, causal, st)
              : launch<128>(tq, tk, tv, o, static_cast<float*>(lse), B, Hq,
                            Hk, S, D, o_sb, o_sh, o_ss, scale, causal, st);
  return static_cast<int>(err);
}
