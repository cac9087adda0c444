// The sketches' hash family on the device, shared by countmin.cu and
// segment_sketch.cu: hash d of item x (read as uint32) is
// fmix32(x * p_d + p_d), with the odd multipliers of the reference package's
// methods/sketches.py (_PRIMES, _fmix32).  uint32 arithmetic wraps for free
// here; the plain PyTorch versions reproduce the wrap with int64 masking
// (kernels/sketch_hash.py).
//
// Also the Count-Min row loop that countmin and segment_countmin share
// (countmin_rows), the flush of a CTA's histogram (countmin_flush), and
// the per-device launch fact both read once (SketchLaunchCache).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace madlib {

constexpr int kSketchMaxRows = 8;
constexpr int kSketchThreads = 256;  // segment_fm
// The Count-Min kernels: persistent CTAs of kCountMinThreads threads,
// kCountMinCtasPerSm to an SM (the wrappers' CTAS_PER_SM in
// kernels/countmin/ops.py), each with one (depth, width) histogram in
// shared memory.  A thread's stage is kCountMinUnroll chunks of 4 rows.
constexpr int kCountMinThreads = 512;
constexpr int kCountMinCtasPerSm = 2;
constexpr int kCountMinUnroll = 2;
constexpr int kSketchMaxDevices = 64;

__device__ __forceinline__ uint32_t sketch_prime(int d) {
  switch (d) {
    case 0: return 0x9E3779B1u;
    case 1: return 0x85EBCA77u;
    case 2: return 0xC2B2AE3Du;
    case 3: return 0x27D4EB2Fu;
    case 4: return 0x165667B1u;
    case 5: return 0xD3A2646Cu;
    case 6: return 0xFD7046C5u;
    default: return 0xB55A4F09u;
  }
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t sketch_hash(uint32_t x, int d) {
  const uint32_t p = sketch_prime(d);
  return fmix32(x * p + p);
}

// Count-Min: add one for each of `depth` hashes of x into a (depth, width)
// int32 histogram (shared or global memory).  A power-of-two width (the
// defaults) takes the bucket with one AND, which folds into fmix32's last
// xor; any other width pays a full unsigned division per hash.
__device__ __forceinline__ void countmin_add(int* hist, uint32_t x, int depth,
                                             uint32_t width) {
  const bool pow2 = (width & (width - 1u)) == 0u;
#pragma unroll
  for (int d = 0; d < kSketchMaxRows; ++d) {
    if (d >= depth) break;
    const uint32_t h = sketch_hash(x, d);
    atomicAdd(&hist[d * width + (pow2 ? h & (width - 1u) : h % width)], 1);
  }
}

// One stage of a thread's rows: kCountMinUnroll chunks of 4 rows, chunk u
// at index c0 + u * T + t of the range's chunks, each a 16-byte load of
// items and a 4-byte load of mask bytes (byte loads where the mask's
// address is not a multiple of 4 there).  Chunks past the range load
// nothing and count as masked.
struct CountMinStage {
  static constexpr int kRows = 4 * kCountMinUnroll;
  int4 x[kCountMinUnroll];
  uint32_t m[kCountMinUnroll];

  __device__ __forceinline__ void load(const int4* __restrict__ it4,
                                       const unsigned char* __restrict__ mk,
                                       bool mask_words, long long c0,
                                       long long T, long long chunks) {
#pragma unroll
    for (int u = 0; u < kCountMinUnroll; ++u) {
      const long long c = c0 + u * T + threadIdx.x;
      m[u] = 0u;
      if (c < chunks) {
        x[u] = __ldg(it4 + c);
        if (mask_words) {
          m[u] = __ldg(reinterpret_cast<const unsigned int*>(mk + 4 * c));
        } else {
          const unsigned char* b = mk + 4 * c;
          m[u] = (uint32_t)b[0] | (uint32_t)b[1] << 8 |
                 (uint32_t)b[2] << 16 | (uint32_t)b[3] << 24;
        }
      }
    }
  }

  // Adds the stage's valid rows hash row by hash row, so that the depth
  // test, the row's prime and its offset are paid once per stage and hash
  // row, not once per item and hash.  x * p + p is computed as (x + 1) * p,
  // one multiply by an immediate.  A stage whose rows are all valid (the
  // common case) adds without a branch per atomic.
  template <bool kPow2>
  __device__ __forceinline__ void add(int* hist, int depth,
                                      uint32_t width) const {
    bool all = true;
#pragma unroll
    for (int u = 0; u < kCountMinUnroll; ++u)
      all = all && __vcmpeq4(m[u], 0u) == 0u;  // no mask byte is 0
    if (all)
      add_rows<kPow2, true>(hist, depth, width);
    else
      add_rows<kPow2, false>(hist, depth, width);
  }

  template <bool kPow2, bool kAllValid>
  __device__ __forceinline__ void add_rows(int* hist, int depth,
                                           uint32_t width) const {
    uint32_t x1[kRows];
    bool v[kRows];
#pragma unroll
    for (int u = 0; u < kCountMinUnroll; ++u) {
      x1[4 * u] = (uint32_t)x[u].x + 1u;
      x1[4 * u + 1] = (uint32_t)x[u].y + 1u;
      x1[4 * u + 2] = (uint32_t)x[u].z + 1u;
      x1[4 * u + 3] = (uint32_t)x[u].w + 1u;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * u + j] = (m[u] >> (8 * j)) & 0xffu;
    }
#pragma unroll
    for (int d = 0; d < kSketchMaxRows; ++d) {
      if (d >= depth) break;
      const uint32_t p = sketch_prime(d);
      int* row = hist + d * width;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t h = fmix32(x1[r] * p);
        const uint32_t b = kPow2 ? h & (width - 1u) : h % width;
        if (kAllValid || v[r]) atomicAdd(row + b, 1);
      }
    }
  }
};

// Count-Min over rows [r0, r1) by every thread of the CTA, adding the
// valid rows into `hist`.  The rows go in stages of CountMinStage, the
// next stage's loads issued before the adds of the current one, so that
// a thread keeps 8 rows' loads in flight while it hashes 8 more.  The rows
// before the first 16-byte aligned item (a view such as items[1:] starts
// 4 bytes in) and the ragged tail, at most 3 each, go one by one.  Every
// thread must call it with the same range.
__device__ __forceinline__ void countmin_rows(
    int* hist, const int* __restrict__ items,
    const unsigned char* __restrict__ mask, long long r0, long long r1,
    int depth, uint32_t width) {
  const int t = threadIdx.x;
  const long long T = blockDim.x;
  const int misalign = (int)(reinterpret_cast<uintptr_t>(items + r0) & 15u);
  const long long head = r1 - r0 < (16 - misalign) / 4 % 4
                             ? r1 - r0 : (16 - misalign) / 4 % 4;
  const long long v0 = r0 + head;
  const long long chunks = (r1 - v0) / 4;
  const long long v1 = v0 + 4 * chunks;
  if (t < head && mask[r0 + t])
    countmin_add(hist, (uint32_t)items[r0 + t], depth, width);
  if (t < r1 - v1 && mask[v1 + t])
    countmin_add(hist, (uint32_t)items[v1 + t], depth, width);
  const int4* it4 = reinterpret_cast<const int4*>(items + v0);
  const unsigned char* mk = mask + v0;
  const bool mask_words = (reinterpret_cast<uintptr_t>(mk) & 3u) == 0u;
  const bool pow2 = (width & (width - 1u)) == 0u;
  const long long step = kCountMinUnroll * T;
  CountMinStage cur;
  cur.load(it4, mk, mask_words, 0, T, chunks);
  for (long long c0 = 0; c0 < chunks; c0 += step) {
    CountMinStage next;
    next.load(it4, mk, mask_words, c0 + step, T, chunks);
    if (pow2)
      cur.add<true>(hist, depth, width);
    else
      cur.add<false>(hist, depth, width);
    cur = next;
  }
}

// Adds a (depth, width) histogram of `cells` counters in shared memory
// into dst (global) with one integer atomic per nonzero counter, and
// zeroes it.  CTA c starts at counter c * 1031 (mod cells), so that CTAs
// that finish together add into different counters.  Callers put a
// barrier before and after.
__device__ __forceinline__ void countmin_flush(int* hist, int cells,
                                               int* dst) {
  const int rot = (int)((blockIdx.x * 1031ull) % (unsigned)cells);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int j = i + rot < cells ? i + rot : i + rot - cells;
    const int c = hist[j];
    hist[j] = 0;
    if (c) atomicAdd(&dst[j], c);
  }
}

// What a Count-Min launch needs to know of the current device, read once
// per device: the shared memory a CTA may opt into (227 KB on the H100).
// On its first use on a device it also allows `kernel` that size.  One
// instance per kernel (a static in the entry that launches it).
class SketchLaunchCache {
 public:
  cudaError_t optin(const void* kernel, int* bytes) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kSketchMaxDevices)
      return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if (!ready_[device]) {
      err = cudaDeviceGetAttribute(
          &optin_[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin_[device]);
      if (err != cudaSuccess) return err;
      ready_[device] = true;
    }
    *bytes = optin_[device];
    return cudaSuccess;
  }

 private:
  std::mutex mu_;
  bool ready_[kSketchMaxDevices] = {};
  int optin_[kSketchMaxDevices] = {};
};

}  // namespace madlib
