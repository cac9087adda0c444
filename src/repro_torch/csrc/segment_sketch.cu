// segment_countmin and segment_fm: the whole grouped Count-Min and
// Flajolet-Martin folds over the group-aligned layout of
// GroupedView.aligned_blocks (nb blocks of bs rows, each block one group's,
// block b's group id in bgids[b]).
//
// Replace the TPU kernels src/repro/kernels/segment_fold/kernel.py:
// _countmin_kernel (called through segment_countmin_padded) and _fm_kernel
// (called through segment_fm_padded).  Each computes what its jnp oracle in
// src/repro/kernels/segment_fold/ref.py computes:
//   segment_countmin -> (G, depth, width) int32, the sum over each group's
//     blocks of the masked Count-Min counts;
//   segment_fm -> (G, H, bits) int32 in {0, 1}, the OR over each group's
//     valid rows of the one-hot at the lowest set bit of each of H hashes,
//     or at bits - 1 where no bit below `bits` is set.
//
// Bound on the H100: each row is read once (int32 item + bool mask, 5 bytes;
// 50 MB at the main path's 10M rows, about 15 us at 3.35 TB/s).  Per valid
// row and hash the hash needs 3 IMAD (FMA pipe) and 6 ALU instructions
// (shifts and xors); Count-Min's `% width` at a power-of-two width folds
// into the last xor, and FM adds h & -h, the fallback select and the OR
// (3 ALU) and the negation (an IMAD.MOV).  At 64 ALU instructions per SM per
// clock on 132 SMs at 1980 MHz: Count-Min, 4 hashes, 2.4e8 ALU instructions,
// about 14.3 us, bound by bytes; FM, 8 hashes, 7.2e8, about 43 us, bound by
// operations.  Atomics are not lane ops and are not counted.
//
// Design.  The TPU kernels carry the (G, ...) accumulator in VMEM across a
// sequential grid.  Here:
//   * segment_countmin runs persistent CTAs (kCountMinCtasPerSm of
//     kCountMinThreads threads to an SM), CTA c over a contiguous range of
//     blocks (ops.py:cta_blocks).  It walks its range run by run, a run
//     being consecutive blocks of one gid (aligned_blocks puts each group's
//     blocks together), streams each run's rows through countmin_rows
//     (sketch_hash.cuh: vector loads, the next 8 rows' loads in flight
//     while a thread hashes 8) into one (depth, width) histogram in shared
//     memory, and flushes it into slot bgids[b] with global integer
//     atomics only where the gid changes and at the end of its range: about
//     CTAs + G flushes instead of one per block, and any order of bgids
//     stays right (a gid met twice is flushed twice).  Integer sums are
//     exact in any order.  A histogram too large for shared memory adds
//     straight into the slot.
//   * segment_fm: every group-aligned block is one CTA.  For bits <= 32 a
//     row's one-hot fits in one uint32, so each thread ORs it, h & -h (the
//     lowest set bit alone, no bit scan), into a register word per hash.  A
//     warp ORs its words
//     with __reduce_or_sync, one atomicOr per warp and hash goes to shared
//     memory, and the CTA's set bits go to the slot with atomicOr.  For
//     bits > 32 the lowest set bit of a nonzero 32-bit hash is below 32, so
//     positions 32 .. bits - 2 are never set; the fallback bit bits - 1 is a
//     flag of its own, and no shift reaches 32.
// Sentinel blocks (gid >= G, from pad_blocks_to) and negative gids add
// nothing; empty groups stay zero.  The output is zeroed on the stream
// before the launch.
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

using namespace madlib;

template <bool kShared>
__global__ void __launch_bounds__(kCountMinThreads, kCountMinCtasPerSm)
segment_countmin_kernel(const int* __restrict__ items,
                        const unsigned char* __restrict__ valid,
                        const int* __restrict__ bgids, int* __restrict__ out,
                        int nb, int bs, int depth, int width, int num_groups,
                        int blocks_per_cta) {
  extern __shared__ int hist[];
  const int cells = depth * width;
  const long long b0 = (long long)blockIdx.x * blocks_per_cta;
  const long long b1 = b0 + blocks_per_cta < nb ? b0 + blocks_per_cta : nb;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  for (long long b = b0; b < b1;) {
    // the run [b, e) of blocks with b's gid; the same for the whole CTA
    const int g = bgids[b];
    long long e = b + 1;
    while (e < b1 && bgids[e] == g) ++e;
    if (g >= 0 && g < num_groups) {
      int* slot = out + (long long)g * cells;
      countmin_rows(kShared ? hist : slot, items, valid, b * bs, e * bs,
                    depth, (uint32_t)width);
      if (kShared) {
        __syncthreads();
        countmin_flush(hist, cells, slot);
        __syncthreads();
      }
    }
    b = e;
  }
}

__global__ void __launch_bounds__(kSketchThreads)
segment_fm_kernel(const int* __restrict__ items,
                  const unsigned char* __restrict__ valid,
                  const int* __restrict__ bgids, int* __restrict__ out,
                  int bs, int num_hashes, int bits, int num_groups) {
  const int g = bgids[blockIdx.x];
  if (g < 0 || g >= num_groups) return;  // the same for the whole CTA
  __shared__ uint32_t words[kSketchMaxRows];
  __shared__ uint32_t fallback;  // bit j: hash j fell back to bits - 1
  if (threadIdx.x < kSketchMaxRows) words[threadIdx.x] = 0u;
  if (threadIdx.x == 0) fallback = 0u;
  __syncthreads();

  uint32_t w[kSketchMaxRows];
#pragma unroll
  for (int j = 0; j < kSketchMaxRows; ++j) w[j] = 0u;
  uint32_t fb = 0u;
  // positions below `bits` (all 32 from bits = 32 up), and the fallback bit
  const uint32_t window = bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
  const uint32_t top = bits <= 32 ? 1u << (bits - 1) : 0u;
  const long long base = (long long)blockIdx.x * bs;
  for (int r = threadIdx.x; r < bs; r += blockDim.x) {
    if (!valid[base + r]) continue;
    const uint32_t x = (uint32_t)items[base + r];
#pragma unroll
    for (int j = 0; j < kSketchMaxRows; ++j) {
      if (j >= num_hashes) break;
      const uint32_t h = sketch_hash(x, j);
      // the one-hot of the lowest set bit is h & -h; 0 when h == 0 or the
      // bit lies at `bits` or above
      const uint32_t low = h & (0u - h) & window;
      if (bits <= 32) {
        w[j] |= low ? low : top;
      } else if (low) {
        w[j] |= low;
      } else {
        fb |= 1u << j;
      }
    }
  }
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int j = 0; j < kSketchMaxRows; ++j) {
    if (j >= num_hashes) break;
    const uint32_t v = __reduce_or_sync(0xffffffffu, w[j]);
    if (lane0 && v) atomicOr(&words[j], v);
  }
  const uint32_t f = __reduce_or_sync(0xffffffffu, fb);
  if (lane0 && f) atomicOr(&fallback, f);
  __syncthreads();

  int* slot = out + (long long)g * num_hashes * bits;
  for (int i = threadIdx.x; i < num_hashes * bits; i += blockDim.x) {
    const int j = i / bits, p = i % bits;
    const bool set = p < 32 ? ((words[j] >> p) & 1u) != 0u
                            : (p == bits - 1 && ((fallback >> j) & 1u) != 0u);
    if (set) atomicOr(&slot[i], 1);
  }
}

// Zeroes `out` (G * depth * width int32) on the stream, then launches
// ceil(nb / blocks_per_cta) CTAs (ops.py:cta_blocks), with the histogram
// in shared memory when it fits in the opt-in size.
extern "C" int madlib_segment_countmin(const void* items, const void* valid,
                                       const void* bgids, void* out, int nb,
                                       int bs, int depth, int width,
                                       int num_groups, int blocks_per_cta,
                                       void* stream) {
  static SketchLaunchCache cache;
  if (blocks_per_cta < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)depth * width * sizeof(int);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)num_groups * bytes, st);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cache.optin((const void*)segment_countmin_kernel<true>, &optin);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nb + blocks_per_cta - 1) / blocks_per_cta;
  if (grid == 0) return (int)cudaSuccess;
  const int* it = static_cast<const int*>(items);
  const unsigned char* vd = static_cast<const unsigned char*>(valid);
  const int* bg = static_cast<const int*>(bgids);
  int* o = static_cast<int*>(out);
  if (bytes <= (size_t)optin)
    segment_countmin_kernel<true><<<grid, kCountMinThreads, bytes, st>>>(
        it, vd, bg, o, nb, bs, depth, width, num_groups, blocks_per_cta);
  else
    segment_countmin_kernel<false><<<grid, kCountMinThreads, 0, st>>>(
        it, vd, bg, o, nb, bs, depth, width, num_groups, blocks_per_cta);
  return (int)cudaGetLastError();
}

extern "C" int madlib_segment_fm(const void* items, const void* valid,
                                 const void* bgids, void* out, int nb, int bs,
                                 int num_hashes, int bits, int num_groups,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)num_groups * num_hashes * bits * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  segment_fm_kernel<<<nb, kSketchThreads, 0, st>>>(
      static_cast<const int*>(items), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(bgids), static_cast<int*>(out), bs, num_hashes,
      bits, num_groups);
  return (int)cudaGetLastError();
}
