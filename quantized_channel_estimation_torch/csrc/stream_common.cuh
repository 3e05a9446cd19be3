// Shared pieces of the fp32 bank-streaming kernels (K4 / K5 in
// grouped_topk.cu, K14a in karatsuba_estimate.cu): the block shape, the
// cp.async primitives, the warp butterfly sum and the copy of one pipeline
// stage of the bank into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qce {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKc = 32;  // rows of pw_k per pipeline stage

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Sum over the warp. Every lane ends with the same bits: the xor butterfly
// adds the same pair, in either order, in both lanes of each exchange.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Issue the asynchronous copy of pipeline stage t (component t / n_ch, row
// slice t % n_ch of pw_k, pw_k being two_m rows of s_cols floats) into buf:
// the first `cols` columns of each row of the slice, at row stride `cols`.
// vec: 16-byte copies (cols and s_cols multiples of 4, pw 16-byte aligned).
__device__ __forceinline__ void issue_stage(float* buf, const float* pw, int t,
                                            int n_ch, int two_m, int s_cols,
                                            int cols, bool vec) {
  const int k = t / n_ch;
  const int kk0 = (t % n_ch) * kKc;
  const int rows = min(kKc, two_m - kk0);
  const float* src = pw + ((size_t)k * two_m + kk0) * s_cols;
  if (cols == s_cols) {  // whole rows: one contiguous run, no index math
    const int count = rows * s_cols;
    if (vec) {
      for (int i = threadIdx.x * 4; i < count; i += kThreads * 4)
        cp_async16(buf + i, src + i);
    } else {
      for (int i = threadIdx.x; i < count; i += kThreads)
        cp_async4(buf + i, src + i);
    }
  } else if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
      const int rr = i / c4, cc = (i - rr * c4) * 4;
      cp_async16(buf + rr * cols + cc, src + (size_t)rr * s_cols + cc);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int rr = i / cols, cc = i - rr * cols;
      cp_async4(buf + rr * cols + cc, src + (size_t)rr * s_cols + cc);
    }
  }
}

// columns per lane: 2 up to 64 wide, 4 up to 128, 8 up to 256
inline int cols_per_lane(int width) {
  return width <= 64 ? 2 : width <= 128 ? 4 : 8;
}

}  // namespace qce
