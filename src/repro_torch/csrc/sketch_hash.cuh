// The sketches' hash family on the device, shared by countmin.cu and
// segment_sketch.cu: hash d of item x (read as uint32) is
// fmix32(x * p_d + p_d), with the odd multipliers of the reference package's
// methods/sketches.py (_PRIMES, _fmix32).  uint32 arithmetic wraps for free
// here; the plain PyTorch versions reproduce the wrap with int64 masking
// (kernels/sketch_hash.py).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace madlib {

constexpr int kSketchMaxRows = 8;
constexpr int kSketchThreads = 256;

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

// Whether a (depth, width) int32 histogram fits in the shared memory a CTA
// may opt into on the current device (227 KB on the H100).
inline bool sketch_fits_shared(size_t bytes) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes <= (size_t)optin;
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

}  // namespace madlib
