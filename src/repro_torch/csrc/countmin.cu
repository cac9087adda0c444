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
// scatter.  On the H100 shared memory has fast integer atomics, so a CTA
// counts into a histogram in shared memory and adds it into the output
// once.  The grid is persistent: kCountMinCtasPerSm CTAs of
// kCountMinThreads threads to an SM (the wrapper sizes it), each over one
// contiguous range of rows (ops.py:cta_rows), so the clear and the flush
// happen once per CTA and not once per few thousand rows.  The rows go
// through countmin_rows (sketch_hash.cuh): 16-byte loads of 4 items and
// 4-byte loads of their mask bytes, the next 8 rows' loads in flight while
// a thread hashes 8, so that the loads overlap the hashing.  The CTA's
// threads add into one histogram with shared atomics (copies of it per
// warp measured slower: atomics of different warps do not contend), and
// the CTA adds it into the output with one global atomic per nonzero
// counter, CTAs starting at different counters.  Integer sums do not depend on their order, so the result is exact and the
// same on every run.  A histogram larger than the opt-in shared memory is
// added straight into the output with global atomics.  Masked rows add
// nothing, as the reference's multiply by the mask adds 0.  Rows of a hot
// key all hit the same depth counters; those atomics serialize.
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

using namespace madlib;

template <bool kShared>
__global__ void __launch_bounds__(kCountMinThreads, kCountMinCtasPerSm)
countmin_kernel(const int* __restrict__ items,
                const unsigned char* __restrict__ mask, int* __restrict__ out,
                long long n, int depth, int width, long long rows_per_cta) {
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < n ? r0 + rows_per_cta : n;
  if (!kShared) {
    countmin_rows(out, items, mask, r0, r1, depth, (uint32_t)width);
    return;
  }
  extern __shared__ int hist[];
  const int cells = depth * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  countmin_rows(hist, items, mask, r0, r1, depth, (uint32_t)width);
  __syncthreads();
  countmin_flush(hist, cells, out);
}

// Zeroes `out` (depth * width int32) on the stream, then launches the
// kernel over ceil(n / rows_per_cta) CTAs: with the histogram in shared
// memory when it fits in the opt-in size, with global atomics otherwise.
// rows_per_cta must be a positive multiple of 4 (ops.py:cta_rows).
extern "C" int madlib_countmin(const void* items, const void* mask, void* out,
                               long long n, int depth, int width,
                               long long rows_per_cta, void* stream) {
  static SketchLaunchCache cache;
  if (rows_per_cta < 4 || rows_per_cta % 4) return (int)cudaErrorInvalidValue;
  const long long grid = (n + rows_per_cta - 1) / rows_per_cta;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)depth * width * sizeof(int);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, st);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cache.optin((const void*)countmin_kernel<true>, &optin);
  if (err != cudaSuccess) return (int)err;
  const int* it = static_cast<const int*>(items);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  int* o = static_cast<int*>(out);
  if (bytes <= (size_t)optin)
    countmin_kernel<true><<<(unsigned)grid, kCountMinThreads, bytes, st>>>(
        it, mk, o, n, depth, width, rows_per_cta);
  else
    countmin_kernel<false><<<(unsigned)grid, kCountMinThreads, 0, st>>>(
        it, mk, o, n, depth, width, rows_per_cta);
  return (int)cudaGetLastError();
}
