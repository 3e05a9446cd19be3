// Top-k selection GMM-Bussgang estimator (kernel K4) for Hopper.
//
// Replaces the TPU kernel `_grouped_stream_topk` +
// `_estimate_kernel_block_grouped_topk` launched by
// `estimate_packed_block_grouped_topk`
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:568, :611,
// :633; entry `estimate_fused_topk` :809). Per row n of r2 = [Re r | Im r]
// (N x 2M), with the logits lg_nk = logw_k - |r2_n P_k - mu_k|^2 and S_n
// the k_sel components of largest logit (ties keep the lower index):
//
//   h2_n = sum_{j in S_n} w_j (r2_n W_j + b_j) / sum_{j in S_n} w_j,
//   w_j = exp(lg_nj - max_{S_n} lg)
//
// (k_sel = 1: the estimate of the argmax component alone).
//
// Design. The TPU kernel streams the whole [P | W] bank and keeps k_sel
// live (tile, 2D) estimate buffers beside the running top-k logits. On
// Hopper those buffers would cost RPW * k_sel * 2D / 32 registers a thread
// (256 at k_sel = 8, 8 rows a warp, 2D = 128), more than a thread has.
// Instead:
//   - the stream (the block shape and cp.async ring of K1,
//     grouped_estimate.cu) reads only the precision part P_k (2M x 2M) of
//     each pw_k and accumulates r2 P_k in registers;
//   - the quadratic term is reduced across the warp by shuffles, so every
//     lane holds the warp's RPW logits; lane l keeps the running top-k of
//     row l % RPW, (logit, index) pairs in 2 k_sel registers, inserted by a
//     bubble with strict >, so ties keep the lower component index;
//   - an epilogue computes r2_n W_j + b_j only for the selected components,
//     reading W_j from L2 (the 8 MiB default bank stays in the 50 MB L2),
//     with the row's r from the shared-memory tile, and combines them.
// Bound on an H100: 2 N 2M 2M K fp32 operations for the logits plus
// k_sel 2 N 2M 2D for the combine (2.75e11 + k_sel 4.3e9 at N = 131072,
// M = D = K = 64: 4.1 ms + 0.064 ms k_sel at the 67 TFLOP/s fp32 peak);
// bytes ~0.1 GB (0.03 ms): bound by fp32 FMA throughput. Streaming the whole
// [P | W] bank as the TPU kernel does could not go below 8.2 ms. The
// epilogue's W reads are k_sel 2M 2D floats a row from L2, not HBM.
// Any N, K, 1 <= k_sel <= min(8, K), 2M and 2D up to 256.
#include "stream_common.cuh"

namespace {

using namespace qce;

constexpr int kRpw = 8;         // rows a warp
constexpr int kTileN = kWarps * kRpw;
constexpr int kSlots = 8;       // TOPK_KERNEL_MAX

template <int CP, int CW>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_topk_kernel(const float* __restrict__ r2,
                        const float* __restrict__ pw,
                        const float* __restrict__ mu,
                        const float* __restrict__ b,
                        const float* __restrict__ logw,
                        float* __restrict__ out, int n, int k_comp,
                        int two_m, int two_d, int k_sel, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const int buf_floats = kKc * two_m;  // P columns only
  float* r_s = smem;
  float* p_s = smem + kTileN * r_stride;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTileN;

  // r tile -> shared memory, rows past N read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_m; i += kThreads) {
    const int rr = i / two_m, cc = i - rr * two_m;
    const int row = row0 + rr;
    r_s[rr * r_stride + cc] = row < n ? r2[(size_t)row * two_m + cc] : 0.f;
  }

  // masked columns read column 0 (in bounds) and are never used
  int off_p[CP], off_w[CW];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = lane + 32 * j;
    off_p[j] = c < two_m ? c : 0;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    off_w[j] = c < two_d ? c : 0;
  }

  float yp[kRpw][CP];
#pragma unroll
  for (int i = 0; i < kRpw; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) yp[i][j] = 0.f;

  // running top-k of row `mine`, sorted by descending logit
  const int mine = lane % kRpw;
  float top_l[kSlots];
  int top_k[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    top_l[s] = -INFINITY;
    top_k[s] = -1;
  }

  const int n_ch = (two_m + kKc - 1) / kKc;
  const int total = k_comp * n_ch;
  issue_stage(p_s, pw, 0, n_ch, two_m, s_cols, two_m, vec);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_stage(p_s + ((t + 1) & 1) * buf_floats, pw, t + 1, n_ch, two_m,
                  s_cols, two_m, vec);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const float* ps = p_s + (t & 1) * buf_floats;
    const int k = t / n_ch;
    const int kk0 = (t % n_ch) * kKc;
    const int rows = min(kKc, two_m - kk0);
    const float* rs = r_s + warp * kRpw * r_stride + kk0;
#pragma unroll 2
    for (int kk = 0; kk < rows; ++kk) {
      float a[kRpw], bp[CP];
#pragma unroll
      for (int i = 0; i < kRpw; ++i) a[i] = rs[i * r_stride + kk];
      const float* prow = ps + kk * two_m;
#pragma unroll
      for (int j = 0; j < CP; ++j) bp[j] = prow[off_p[j]];
#pragma unroll
      for (int i = 0; i < kRpw; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) yp[i][j] = fmaf(a[i], bp[j], yp[i][j]);
    }
    __syncthreads();  // buffer t & 1 is refilled by the issue at t + 1

    if (kk0 + rows == two_m) {  // component k complete: top-k insert
      const float* muk = mu + (size_t)k * two_m;
      const float lw = logw[k];
      float cand = -INFINITY;
#pragma unroll
      for (int i = 0; i < kRpw; ++i) {
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
        const float lg = lw - warp_sum(q);
        if (i == mine) cand = lg;
      }
      int cand_k = k;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < k_sel) {
          const bool take = cand > top_l[s];  // strict: ties keep lower k
          const float ev_l = take ? top_l[s] : cand;
          const int ev_k = take ? top_k[s] : cand_k;
          if (take) {
            top_l[s] = cand;
            top_k[s] = cand_k;
          }
          cand = ev_l;
          cand_k = ev_k;
        }
      }
    }
  }

  // epilogue: each warp combines the selected components of its rows
#pragma unroll 1
  for (int i = 0; i < kRpw; ++i) {
    const int row = row0 + warp * kRpw + i;
    if (row >= n) break;  // warp-uniform
    const float* rrow = r_s + (warp * kRpw + i) * r_stride;
    const float l0 = __shfl_sync(0xffffffffu, top_l[0], i);
    float acc[CW], den = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s >= k_sel) break;  // uniform
      const float ls = __shfl_sync(0xffffffffu, top_l[s], i);
      const int ks = __shfl_sync(0xffffffffu, top_k[s], i);
      if (ks < 0) break;      // uniform; only when K < k_sel
      const float w = s == 0 ? 1.f : expf(ls - l0);
      const float* wk = pw + (size_t)ks * two_m * s_cols + two_m;
      const float* bk = b + (size_t)ks * two_d;
      float z[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) z[j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < two_m; ++kk) {
        const float a = rrow[kk];
        const float* wrow = wk + (size_t)kk * s_cols;
#pragma unroll
        for (int j = 0; j < CW; ++j) z[j] = fmaf(a, __ldg(wrow + off_w[j]), z[j]);
      }
#pragma unroll
      for (int j = 0; j < CW; ++j)
        acc[j] = fmaf(w, z[j] + __ldg(bk + off_w[j]), acc[j]);
      den += w;
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int c = lane + 32 * j;
      if (c < two_d)
        out[(size_t)row * two_d + c] = k_sel == 1 ? acc[j] : acc[j] / den;
    }
  }
}

template <int CP, int CW>
int launch(const float* r2, const float* pw, const float* mu, const float* b,
           const float* logw, float* out, int n, int k_comp, int two_m,
           int two_d, int k_sel, cudaStream_t stream) {
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * r_stride + 2 * (size_t)kKc * two_m);
  const int vec = (two_m % 4 == 0) && (s_cols % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(pw) % 16 == 0);
  auto kern = grouped_topk_kernel<CP, CW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kTileN - 1) / kTileN;
  kern<<<grid, kThreads, smem, stream>>>(r2, pw, mu, b, logw, out, n, k_comp,
                                         two_m, two_d, k_sel, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Returns a cudaError_t (0 on success).
extern "C" int grouped_topk_launch(const float* r2, const float* pw,
                                   const float* mu, const float* b,
                                   const float* logw, float* out, int n,
                                   int k_comp, int two_m, int two_d,
                                   int k_sel, void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 256 || two_d < 1 ||
      two_d > 256 || k_sel < 1 || k_sel > kSlots || k_sel > k_comp)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = cols_per_lane(two_m), cw = cols_per_lane(two_d);
#define QCE_LAUNCH(CP_, CW_)                                                  \
  if (cp == CP_ && cw == CW_)                                                 \
    return launch<CP_, CW_>(r2, pw, mu, b, logw, out, n, k_comp, two_m, two_d, \
                            k_sel, s);
  QCE_LAUNCH(2, 2)
  QCE_LAUNCH(2, 4)
  QCE_LAUNCH(2, 8)
  QCE_LAUNCH(4, 2)
  QCE_LAUNCH(4, 4)
  QCE_LAUNCH(4, 8)
  QCE_LAUNCH(8, 2)
  QCE_LAUNCH(8, 4)
  QCE_LAUNCH(8, 8)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
