// The flash attention backward's row pass, shared by the FFMA backward
// (flash_attention_bwd.cu) and the tensor-core backward
// (flash_attention_bwd_tc.cu):
//
//   delta = rowsum(dO o O)   per query row, f32, in a fixed order
//
// and, where the caller gives lse_out, the forward's log-sum-exp of each
// row times lse_scale beside it (the tensor-core kernels take it in base
// 2).  Rows live in a space of S_pad rows a head (S itself, or S padded so
// that a tile of rows starts 16-byte aligned); rows at or past S get 0.
// It reads O and dO once and is bound by those bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace madlib {
namespace flash_bwd {
// internal linkage: each source that includes this builds its own copy
namespace {

constexpr int ROWS_PER_CTA = 64;
constexpr int ROWS_THREADS = 128;

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One CTA of 128 threads per (64 rows, query head, batch): lanes tx take
// the features tx, tx + 8, ... of their rows (4 rows a group of 8 lanes),
// then a fixed-order shuffle reduction over the 8 lanes.  lse is the
// forward's (B, Hq, S), f32 contiguous; lse_out and delta are (B, Hq,
// S_pad).  Grid (ceil(S_pad / 64), Hq, B).
template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
flash_bwd_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      long long o_sb, long long o_sh, long long o_ss,
                      long long do_sb, long long do_sh, long long do_ss,
                      const float* __restrict__ lse, float lse_scale,
                      float* __restrict__ lse_out, float* __restrict__ delta,
                      int S, int S_pad, int D) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const T* ob = o + b * o_sb + h * o_sh;
  const T* gb = dout + b * do_sb + h * do_sh;
  const long long head = static_cast<long long>(b) * gridDim.y + h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = blockIdx.x * ROWS_PER_CTA + ty * 4 + i;
    float dl = 0.f;
    if (row < S)
      for (int d = tx; d < D; d += 8)
        dl = fmaf(as_f32(gb[row * do_ss + d]), as_f32(ob[row * o_ss + d]),
                  dl);
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    dl += __shfl_xor_sync(0xffffffffu, dl, 4);
    if (tx == 0 && row < S_pad) {
      delta[head * S_pad + row] = row < S ? dl : 0.f;
      if (lse_out != nullptr)
        lse_out[head * S_pad + row] =
            row < S ? lse[head * S + row] * lse_scale : 0.f;
    }
  }
}

}  // namespace
}  // namespace flash_bwd
}  // namespace madlib
