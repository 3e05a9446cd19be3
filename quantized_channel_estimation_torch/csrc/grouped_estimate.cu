// Grouped online-softmax GMM-Bussgang estimator (kernel K1) for Hopper.
//
// Replaces the TPU kernel `_grouped_stream` + `_estimate_kernel_block_grouped`
// launched by `estimate_packed_block_grouped`
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:327, :419,
// :476). Per row n of r2 = [Re r | Im r] (N x 2M) and component k, with
// yz_k = r2 @ pw_k (pw_k = [P_k | W_k] in the real 2x2 block embedding):
//
//   h2_n = sum_k softmax_k(logw_k - |yz_k[:, :2M] - mu_k|^2)
//                 * (yz_k[:, 2M:] + b_k)
//
// with a running max / denominator / accumulator over k, so the (N, K, 2D)
// per-component estimates never exist in memory.
//
// Bound on an H100: 2 N 2M (2M+2D) K fp32 operations (5.5e11 for a
// 131072-row batch at M = D = K = 64, 8.2 ms at the 67 TFLOP/s fp32 peak)
// against ~0.15 GB of compulsory traffic (0.04 ms at 3.35 TB/s): the kernel
// is bound by fp32 FMA throughput. TF32 tensor cores are excluded for
// accuracy (logits at 20 dB are large and a 10-bit mantissa moves the
// posterior); 3xTF32 tensor-core GEMMs are later work (kernel K14).
//
// Design, simple and correct first:
//   - one block of 8 warps per tile of 8*RPW rows; the r tile sits in shared
//     memory, each warp owns RPW rows, each lane a strided set of columns
//     (lane + 32 j) of the P part (CP columns) and the W part (CW columns);
//   - the bank is streamed through shared memory in slices of KC rows of
//     pw_k, double-buffered with cp.async (the 8 MiB default bank lives in
//     the 50 MB L2), one stage per (component, slice);
//   - plain fp32 FMAs into register accumulators yz;
//   - the quadratic term of each row is reduced across its warp by shuffles;
//   - online-softmax update of the per-row accumulator in registers;
//   - the ragged last tile is masked in the kernel (no padding copy).
// Any N and K, 2M and 2D up to 256.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Issue the asynchronous copy of pipeline stage t (component t / n_ch, row
// slice t % n_ch of pw_k) into buf.
__device__ __forceinline__ void issue_stage(float* buf, const float* pw, int t,
                                            int n_ch, int two_m, int s_cols,
                                            bool vec) {
  const int k = t / n_ch;
  const int kk0 = (t % n_ch) * kKc;
  const int rows = min(kKc, two_m - kk0);
  const float* src = pw + ((size_t)k * two_m + kk0) * s_cols;
  const int count = rows * s_cols;
  if (vec) {
    for (int i = threadIdx.x * 4; i < count; i += kThreads * 4)
      cp_async16(buf + i, src + i);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads)
      cp_async4(buf + i, src + i);
  }
}

template <int CP, int CW, int RPW>
__global__ void __launch_bounds__(kThreads)
    grouped_estimate_kernel(const float* __restrict__ r2,
                            const float* __restrict__ pw,
                            const float* __restrict__ mu,
                            const float* __restrict__ b,
                            const float* __restrict__ logw,
                            float* __restrict__ out, int n, int k_comp,
                            int two_m, int two_d, int vec) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const int buf_floats = kKc * s_cols;
  float* r_s = smem;
  float* pw_s = smem + kTileN * r_stride;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTileN;

  // r tile -> shared memory, rows past N read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_m; i += kThreads) {
    const int rr = i / two_m, cc = i - rr * two_m;
    const int row = row0 + rr;
    r_s[rr * r_stride + cc] = row < n ? r2[(size_t)row * two_m + cc] : 0.f;
  }

  // per-lane column offsets into a pw_k row; masked columns read column 0
  // (in bounds) and their accumulators are never used
  int off_p[CP], off_w[CW];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = lane + 32 * j;
    off_p[j] = c < two_m ? c : 0;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    off_w[j] = c < two_d ? two_m + c : 0;
  }

  float yp[RPW][CP], yw[RPW][CW], acc[RPW][CW], m_run[RPW], den[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CP; ++j) yp[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      yw[i][j] = 0.f;
      acc[i][j] = 0.f;
    }
  }

  const int n_ch = (two_m + kKc - 1) / kKc;
  const int total = k_comp * n_ch;
  issue_stage(pw_s, pw, 0, n_ch, two_m, s_cols, vec);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_stage(pw_s + ((t + 1) & 1) * buf_floats, pw, t + 1, n_ch, two_m,
                  s_cols, vec);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const float* ps = pw_s + (t & 1) * buf_floats;
    const int k = t / n_ch;
    const int kk0 = (t % n_ch) * kKc;
    const int rows = min(kKc, two_m - kk0);
    const float* rs = r_s + warp * RPW * r_stride + kk0;
#pragma unroll 2
    for (int kk = 0; kk < rows; ++kk) {
      float a[RPW], bp[CP], bw[CW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = rs[i * r_stride + kk];
      const float* prow = ps + kk * s_cols;
#pragma unroll
      for (int j = 0; j < CP; ++j) bp[j] = prow[off_p[j]];
#pragma unroll
      for (int j = 0; j < CW; ++j) bw[j] = prow[off_w[j]];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
#pragma unroll
        for (int j = 0; j < CP; ++j) yp[i][j] = fmaf(a[i], bp[j], yp[i][j]);
#pragma unroll
        for (int j = 0; j < CW; ++j) yw[i][j] = fmaf(a[i], bw[j], yw[i][j]);
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by the issue at t + 1

    if (kk0 + rows == two_m) {  // component k complete: online softmax
      const float* muk = mu + (size_t)k * two_m;
      const float* bk = b + (size_t)k * two_d;
      const float lw = logw[k];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const int c = lane + 32 * j;
          if (c < two_m) {
            const float d = yp[i][j] - __ldg(muk + c);
            q = fmaf(d, d, q);
          }
          yp[i][j] = 0.f;
        }
        q = warp_sum(q);
        const float logit = lw - q;
        const float m_new = fmaxf(m_run[i], logit);
        // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales by 0
        const float scale =
            m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
        const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
        den[i] = fmaf(den[i], scale, p);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int c = lane + 32 * j;
          const float z = yw[i][j] + (c < two_d ? __ldg(bk + c) : 0.f);
          acc[i][j] = fmaf(p, z, acc[i][j] * scale);
          yw[i][j] = 0.f;
        }
        m_run[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = row0 + warp * RPW + i;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int c = lane + 32 * j;
        if (c < two_d) out[(size_t)row * two_d + c] = acc[i][j] / den[i];
      }
    }
  }
}

template <int CP, int CW, int RPW>
int launch(const float* r2, const float* pw, const float* mu, const float* b,
           const float* logw, float* out, int n, int k_comp, int two_m,
           int two_d, cudaStream_t stream) {
  constexpr int kTileN = kWarps * RPW;
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * r_stride + 2 * (size_t)kKc * s_cols);
  const int vec = (s_cols % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(pw) % 16 == 0);
  auto kern = grouped_estimate_kernel<CP, CW, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kTileN - 1) / kTileN;
  kern<<<grid, kThreads, smem, stream>>>(r2, pw, mu, b, logw, out, n, k_comp,
                                         two_m, two_d, vec);
  return (int)cudaGetLastError();
}

// columns per lane: 2 up to 64 wide, 4 up to 128, 8 up to 256
int cols_per_lane(int width) { return width <= 64 ? 2 : width <= 128 ? 4 : 8; }

}  // namespace

// C entry point, loaded with ctypes. Returns a cudaError_t (0 on success).
extern "C" int grouped_estimate_launch(const float* r2, const float* pw,
                                       const float* mu, const float* b,
                                       const float* logw, float* out, int n,
                                       int k_comp, int two_m, int two_d,
                                       void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 256 || two_d < 1 ||
      two_d > 256)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = cols_per_lane(two_m), cw = cols_per_lane(two_d);
#define QCE_LAUNCH(CP_, CW_, RPW_)                                           \
  if (cp == CP_ && cw == CW_)                                                \
    return launch<CP_, CW_, RPW_>(r2, pw, mu, b, logw, out, n, k_comp, two_m, \
                                  two_d, s);
  QCE_LAUNCH(2, 2, 8)
  QCE_LAUNCH(2, 4, 8)
  QCE_LAUNCH(4, 2, 8)
  QCE_LAUNCH(4, 4, 8)
  QCE_LAUNCH(2, 8, 4)
  QCE_LAUNCH(8, 2, 4)
  QCE_LAUNCH(4, 8, 4)
  QCE_LAUNCH(8, 4, 4)
  QCE_LAUNCH(8, 8, 4)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
