// Shared pieces of the circulant (FFT-domain) estimation kernels (K6-K9 in
// circ_estimate.cu, K10 in mp_circ_estimate.cu): the tile product that
// streams its right operand through a two-buffer cp.async ring, the pool of
// the logits over the rows of a coherence block, and the softmax over the
// components.
//
// A tile is kWarps * RPW rows, each warp owning RPW of them; a row keeps its
// values in shared memory at row stride `stride`, with K slots at `w_off`
// for the softmax weights.
#pragma once

#include "stream_common.cuh"

namespace qce {

constexpr int kStage = 4096;  // floats in one ring buffer (16 KB)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load_vec(const float* p, float (&b)[1]) {
  b[0] = p[0];
}
__device__ __forceinline__ void load_vec(const float* p, float (&b)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  b[0] = t.x;
  b[1] = t.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&b)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  b[0] = t.x;
  b[1] = t.y;
  b[2] = t.z;
  b[3] = t.w;
}

// Asynchronous copy of `count` contiguous floats into a ring buffer.
__device__ __forceinline__ void start_copy(float* buf, const float* src,
                                           int count, bool vec) {
  if (vec) {
    for (int i = threadIdx.x * 4; i < count; i += kThreads * 4)
      cp_async16(buf + i, src + i);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads)
      cp_async4(buf + i, src + i);
  }
}

// acc[i][j V + v] = sum_kk a[i][kk] * bmat[kk][V (lane + 32 j) + v] for the
// warp's RPW rows a (shared memory, row stride a_stride, kdim columns) and
// the row-major (kdim, ncols) matrix bmat in global memory, streamed by the
// whole block through the ring in slices of kStage / ncols rows. Columns
// past ncols read column 0; their sums are never used. Every thread of the
// block must call it; it begins and ends with a block barrier after its
// first copy has landed and after its last read of the ring.
template <int RPW, int CJ, int V>
__device__ __forceinline__ void tile_gemm(const float* a_rows, int a_stride,
                                          int kdim,
                                          const float* __restrict__ bmat,
                                          int ncols, float* ring, int lane,
                                          float (&acc)[RPW][CJ * V]) {
  int off[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int c = V * (lane + 32 * j);
    off[j] = c < ncols ? c : 0;
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CJ * V; ++j) acc[i][j] = 0.f;

  const int rows_stage = kStage / ncols;
  const int n_st = (kdim + rows_stage - 1) / rows_stage;
  const bool vec =
      (ncols % 4 == 0) && (reinterpret_cast<uintptr_t>(bmat) % 16 == 0);
  start_copy(ring, bmat, min(rows_stage, kdim) * ncols, vec);
  cp_async_commit();

  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st) {
      const int r0 = (s + 1) * rows_stage;
      start_copy(ring + ((s + 1) & 1) * kStage, bmat + (size_t)r0 * ncols,
                 min(rows_stage, kdim - r0) * ncols, vec);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const float* bs = ring + (s & 1) * kStage;
    const int kk0 = s * rows_stage;
    const int rows = min(rows_stage, kdim - kk0);
    const float* as = a_rows + kk0;
#pragma unroll 2
    for (int kk = 0; kk < rows; ++kk) {
      float a[RPW], b[CJ][V];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = as[i * a_stride + kk];
      const float* brow = bs + kk * ncols;
#pragma unroll
      for (int j = 0; j < CJ; ++j) load_vec(brow + off[j], b[j]);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[i][j * V + v] = fmaf(a[i], b[j][v], acc[i][j * V + v]);
    }
    __syncthreads();  // buffer s & 1 is refilled by the copy started at s + 1
  }
}

// sum += part as a compensated (Kahan) sum, `lost` carrying the low bits.
template <int R, int C>
__device__ __forceinline__ void kahan_add(float (&sum)[R][C],
                                          float (&lost)[R][C],
                                          const float (&part)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float y = part[i][j] - lost[i][j];
      const float next = sum[i][j] + y;
      lost[i][j] = (next - sum[i][j]) - y;
      sum[i][j] = next;
    }
}

// The coherent kernels' pool over each block's rows. lg[i][j] is the logit
// of the warp's row i and the component k = lane + 32 j; the first
// `tile_rows` rows of the tile are whole blocks of t_coh consecutive rows.
// Replaces lg by lg + alpha (s - lg), s the sum of lg over the row's block
// (alpha >= 1: s). The warps exchange their logits through the rows' w
// slots; two block barriers, so every thread of the block must call it.
template <int RPW, int CK>
__device__ __forceinline__ void pool_over_blocks(float (&lg)[RPW][CK],
                                                 float* rows_s, int stride,
                                                 int w_off, int warp,
                                                 int lane, int tile_rows,
                                                 int t_coh, int k_comp,
                                                 float alpha) {
  float* my = rows_s + warp * RPW * stride;
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int k = lane + 32 * j;
      if (k < k_comp) my[i * stride + w_off + k] = lg[i][j];
    }
  __syncthreads();
  float s[RPW][CK];
  int prev_b0 = -1;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = warp * RPW + i;
    const int b0 = rr < tile_rows ? rr / t_coh * t_coh : -1;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int k = lane + 32 * j;
      if (b0 < 0 || k >= k_comp) {
        s[i][j] = lg[i][j];  // masked: never stored
      } else if (i > 0 && b0 == prev_b0) {
        s[i][j] = s[i - 1][j];
      } else {
        // compensated (Kahan) sum: a pooled logit is T times a row's,
        // and a running float32 sum would lose its low bits T times
        float sum = 0.f, lost = 0.f;
        for (int t = 0; t < t_coh; ++t) {
          const float y = rows_s[(b0 + t) * stride + w_off + k] - lost;
          const float next = sum + y;
          lost = (next - sum) - y;
          sum = next;
        }
        s[i][j] = sum;
      }
    }
    prev_b0 = b0;
  }
  __syncthreads();  // the w slots are rewritten by the softmax
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j)
      if (lane + 32 * j < k_comp)
        lg[i][j] = alpha >= 1.f ? s[i][j]
                                : fmaf(alpha, s[i][j] - lg[i][j], lg[i][j]);
}

// Softmax over the components of each of the warp's rows, into the rows' w
// slots: exp(lg - m) / den when NORM, else the un-normalised exp(lg - m).
// lg of the components k >= k_comp must be -INFINITY. mx and den return
// each row's m = max_k lg and den = sum_k exp(lg - m).
template <int RPW, int CK, bool NORM>
__device__ __forceinline__ void softmax_rows(const float (&lg)[RPW][CK],
                                             float* my, int stride, int w_off,
                                             int k_comp, int lane,
                                             float (&mx)[RPW],
                                             float (&den)[RPW]) {
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    float m = lg[i][0];
#pragma unroll
    for (int j = 1; j < CK; ++j) m = fmaxf(m, lg[i][j]);
    m = warp_max(m);
    // exp(-inf - (-inf)) would be NaN: an all -inf row weighs nothing
    if (m == -INFINITY) m = 0.f;
    float p[CK], sum = 0.f;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      p[j] = lg[i][j] == -INFINITY ? 0.f : expf(lg[i][j] - m);
      sum += p[j];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int k = lane + 32 * j;
      if (k < k_comp) my[i * stride + w_off + k] = NORM ? p[j] / sum : p[j];
    }
    mx[i] = m;
    den[i] = sum;
  }
}

}  // namespace qce
