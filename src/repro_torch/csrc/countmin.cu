// countmin: the (depth, width) int32 Count-Min counts of a column of items,
// each valid row adding one into bucket hash_d(item) % width of every row d.
//
// Replaces the TPU kernel src/repro/kernels/countmin/kernel.py:_kernel
// (called through countmin_padded, wrapped by ops.py:countmin_block), the
// block update of the Count-Min transition.
//
// Bound on the H100: each row is read once (int32 item + bool mask, 5 bytes)
// and each valid row and hash needs 3 IMAD on the FMA pipe (the multiply-add
// and fmix32's two multiplies) and 6 ALU instructions (fmix32's three shifts
// and three xors; at a power-of-two width the `% width` AND folds into the
// last xor's LOP3).  The increment is an atomic, not a lane op.  At the main
// path's n = 10M, depth 4, width 1024 that is 50 MB, about 14.9 us at
// 3.35 TB/s, against 2.4e8 ALU instructions, about 14.3 us at 64 per SM per
// clock on 132 SMs at 1980 MHz: bound by bytes, barely.
//
// Design.  The TPU kernel keeps one (depth, width) block in VMEM across a
// sequential grid and builds a one-hot per tile because the TPU has no fast
// scatter.  On the H100 the grid is parallel and shared memory has fast
// integer atomics: each CTA keeps its own (depth, width) histogram in shared
// memory, its threads stride over the rows (one row per thread per step,
// hashes in registers) and add with shared atomics, and at the end the CTA
// adds its nonzero counters into the output with global atomics.  Integer
// sums do not depend on their order, so the result is exact and the same on
// every run.  A histogram too large for shared memory takes the second
// kernel, which adds straight into the output with global atomics.  Masked
// rows add nothing, as the reference's multiply by the mask adds 0.  Rows of
// a hot key all hit the same depth counters; those atomics serialize.
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

using namespace madlib;

__global__ void __launch_bounds__(kSketchThreads)
countmin_shared_kernel(const int* __restrict__ items,
                       const unsigned char* __restrict__ mask,
                       int* __restrict__ out, long long n, int depth,
                       int width) {
  extern __shared__ int hist[];
  const int cells = depth * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride)
    if (mask[r]) countmin_add(hist, (uint32_t)items[r], depth, (uint32_t)width);
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&out[i], c);
  }
}

__global__ void __launch_bounds__(kSketchThreads)
countmin_global_kernel(const int* __restrict__ items,
                       const unsigned char* __restrict__ mask,
                       int* __restrict__ out, long long n, int depth,
                       int width) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride)
    if (mask[r]) countmin_add(out, (uint32_t)items[r], depth, (uint32_t)width);
}

// Zeroes `out` (depth * width int32) on the stream, then launches one of the
// two kernels: shared-memory histograms when depth * width * 4 bytes fit in
// the device's opt-in shared memory, global atomics otherwise.
extern "C" int madlib_countmin(const void* items, const void* mask, void* out,
                               long long n, int depth, int width,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t cells = (size_t)depth * width;
  cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (n + kSketchThreads - 1) / kSketchThreads;
  const int* it = static_cast<const int*>(items);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  int* o = static_cast<int*>(out);
  const size_t smem = cells * sizeof(int);
  if (sketch_fits_shared(smem)) {
    err = cudaFuncSetAttribute(countmin_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, countmin_shared_kernel, kSketchThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
    long long grid = (long long)sms * per_sm;
    if (grid > want) grid = want;
    if (grid < 1) grid = 1;
    countmin_shared_kernel<<<(unsigned)grid, kSketchThreads, smem, st>>>(
        it, mk, o, n, depth, width);
  } else {
    long long grid = (long long)sms * 8;
    if (grid > want) grid = want;
    if (grid < 1) grid = 1;
    countmin_global_kernel<<<(unsigned)grid, kSketchThreads, 0, st>>>(
        it, mk, o, n, depth, width);
  }
  return (int)cudaGetLastError();
}
