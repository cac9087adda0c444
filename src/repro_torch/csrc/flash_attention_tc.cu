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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // query rows per CTA (two warpgroups)
constexpr int TK = 128;           // keys per K/V tile
constexpr int STAGES = 2;         // K/V ring depth
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int ROW_BYTES = 128;    // one swizzled row: 64 bf16
constexpr float NEG = -1e30f;     // the mask value (never -inf: no NaN)
constexpr float LOG2E = 1.4426950408889634f;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of the given parity to complete.  A wait that
// outlasts about 10 s of SM clock (a copy that never lands) traps, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of the 4-d tensor map (D, S, H, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the SFU, subnormal results flushed to zero (a p below 2^-126 of
// the row's largest weighs nothing against it in bf16)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128, f32) += A(64 x 16, shared) B(16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64, f32) += A(64 x 16, registers) B(16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, registers) B(16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int Hq, int group,
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, S, H, B) bf16 with the given strides in elements; boxes of 64
// features x 128 positions, 128-byte swizzle, zeros outside the tensor
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int D,
              int S, int H, int B, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, BM, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int B, int Hq, int Hk,
                   int S, int D, long long o_sb, long long o_sh,
                   long long o_ss, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<DP>;
  constexpr int bytes = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (S + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hq / Hk, S, D, o_sb,
      o_sh, o_ss, scale * LOG2E, causal);
  return cudaGetLastError();
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// bf16 q (B, Hq, S, D), k and v (B, Hk, S, D), o (B, Hq, S, D), each given
// by its batch, head and position strides in elements (feature stride 1).
// Takes D % 8 == 0, 8 <= D <= 128, every pointer 16-byte aligned and every
// stride a multiple of 8 elements (TMA's 16-byte rule); the wrapper sends
// only such inputs here and passes a contiguous tensor's stride for an
// axis of size 1.
// Returns cudaGetLastError() after the launch.
extern "C" int madlib_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hk, int S, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int causal, void* stream) {
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  if (Hk <= 0 || Hq % Hk != 0 || D % 8 != 0 || D < 8 || D > 128 || S < 1 ||
      B < 1 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  for (long long s : strides)
    if (s % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, D, S, Hq, B, q_sb, q_sh, q_ss) ||
      !make_map(&tk, encode, k, D, S, Hk, B, k_sb, k_sh, k_ss) ||
      !make_map(&tv, encode, v, D, S, Hk, B, v_sb, v_sh, v_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      D <= 64 ? launch<64>(tq, tk, tv, o, B, Hq, Hk, S, D, o_sb, o_sh, o_ss,
                           scale, causal, st)
              : launch<128>(tq, tk, tv, o, B, Hq, Hk, S, D, o_sb, o_sh, o_ss,
                            scale, causal, st);
  return static_cast<int>(err);
}
