// Grouped online-softmax GMM-Bussgang estimator for Hopper: kernel K1, its
// coherent (block-pooled) mode K3, and their split-K stats form K2, one
// stream for all three.
//
// Replaces the TPU kernel `_grouped_stream` + `_estimate_kernel_block_grouped`
// launched by `estimate_packed_block_grouped`
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:327, :419,
// :476), flat (K1) and with `t_coh > 1`, `coh_alpha` (K3, entry
// `estimate_fused_coherent` :1151), and `_estimate_kernel_block_grouped_stats`
// launched by `estimate_packed_block_grouped_stats` (:454, :857; K2, flat and
// coherent): the STATS form writes each row's running max m, denominator den
// and un-normalised accumulator acc in place of acc / den, so the states of
// disjoint component shards merge exactly (m* = max m, den* and acc* the
// exp(m - m*)-weighted sums). Per row n of r2 = [Re r | Im r]
// (N x 2M) and component k, with yz_k = r2 @ pw_k (pw_k = [P_k | W_k] in
// the real 2x2 block embedding):
//
//   lg_nk = logw_k - |yz_k[:, :2M] - mu_k|^2
//   h2_n  = sum_k softmax_k(lg'_nk) * (yz_k[:, 2M:] + b_k)
//
// with lg' = lg for K1 and, for K3, rows laid out block-major (the T rows
// of a coherence block consecutive): s_k = sum of lg_k over the row's block
// and lg' = (1 - alpha) lg + alpha s (alpha = 1 gives s). The caller divides
// the mixture log-weight by (1 - alpha + alpha T) so that it enters once
// per block. A running max / denominator / accumulator over k keeps the
// (N, K, 2D) per-component estimates out of memory.
//
// Bound on an H100: 2 N 2M (2M+2D) K fp32 operations (5.5e11 for a
// 131072-row batch at M = D = K = 64, 8.2 ms at the 67 TFLOP/s fp32 peak)
// against ~0.15 GB of compulsory traffic (0.04 ms at 3.35 TB/s): the kernel
// is bound by fp32 FMA throughput; the pooling adds O(N K) work. TF32
// tensor cores are excluded for accuracy (logits at 20 dB are large and a
// 10-bit mantissa moves the posterior); 3xTF32 tensor-core GEMMs are later
// work (kernel K14).
//
// Design, simple and correct first:
//   - one block of 8 warps per tile of 8*RPW rows; the r tile sits in shared
//     memory, each warp owns RPW rows, each lane a strided set of columns
//     (lane + 32 j) of the P part (CP columns) and the W part (CW columns);
//   - the bank is streamed through shared memory in slices of kKc rows of
//     pw_k, double-buffered with cp.async (the 8 MiB default bank lives in
//     the 50 MB L2), one stage per (component, slice);
//   - plain fp32 FMAs into register accumulators yz;
//   - the quadratic term of each row is reduced across its warp by shuffles,
//     so every lane holds the same logits of the warp's RPW rows;
//   - K3 pooling: a tile holds floor(8 RPW / T) whole blocks (rows past them
//     are masked). When T divides RPW each block lies inside one warp and is
//     pooled in registers; otherwise the warps exchange their logits through
//     shared memory at each component's completion, one extra barrier per
//     component against the two per pipeline stage. T is at most the tile's
//     8 RPW rows (64 for 2M, 2D <= 128, else 32);
//   - online-softmax update of the per-row accumulator in registers;
//   - the ragged last tile is masked in the kernel (no padding copy);
//   - STATS writes two floats a row more than K1 and skips the division.
// Any N and K, 2M and 2D up to 256.
#include "stream_common.cuh"

namespace {

using namespace qce;

template <int CP, int CW, int RPW, bool COH, bool STATS>
__global__ void __launch_bounds__(kThreads)
    grouped_estimate_kernel(const float* __restrict__ r2,
                            const float* __restrict__ pw,
                            const float* __restrict__ mu,
                            const float* __restrict__ b,
                            const float* __restrict__ logw,
                            float* __restrict__ out,
                            float* __restrict__ m_out,
                            float* __restrict__ den_out, int n, int k_comp,
                            int two_m, int two_d, int vec, int t_coh,
                            float coh_alpha) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const int buf_floats = kKc * s_cols;
  float* r_s = smem;
  float* pw_s = smem + kTileN * r_stride;
  float* lg_s = pw_s + 2 * buf_floats;  // K3: one component's tile logits

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows of this tile: whole T-row blocks for K3
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int row0 = blockIdx.x * tile_rows;
  // K3 blocks inside one warp (T divides RPW, so T is a power of two):
  // rows i and j share a block iff (i ^ j) & ~(T - 1) == 0
  const bool in_warp = COH && (RPW % t_coh == 0);
  const int t_mask = ~(t_coh - 1);

  // r tile -> shared memory; masked rows read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_m; i += kThreads) {
    const int rr = i / two_m, cc = i - rr * two_m;
    const int row = row0 + rr;
    r_s[rr * r_stride + cc] =
        (rr < tile_rows && row < n) ? r2[(size_t)row * two_m + cc] : 0.f;
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
  issue_stage(pw_s, pw, 0, n_ch, two_m, s_cols, s_cols, vec);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_stage(pw_s + ((t + 1) & 1) * buf_floats, pw, t + 1, n_ch, two_m,
                  s_cols, s_cols, vec);
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
      float lg[RPW];
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
        lg[i] = lw - warp_sum(q);
      }
      if constexpr (COH) {
        float s[RPW];
        if (in_warp) {
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            s[i] = 0.f;
#pragma unroll
            for (int j = 0; j < RPW; ++j)
              if (((i ^ j) & t_mask) == 0) s[i] += lg[j];
          }
        } else {
          // lg_s was last read before this stage's first barrier
          if (lane == 0) {
#pragma unroll
            for (int i = 0; i < RPW; ++i) lg_s[warp * RPW + i] = lg[i];
          }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int rr = warp * RPW + i;
            s[i] = lg[i];  // masked rows: never stored
            if (rr < tile_rows) {
              const int b0 = rr / t_coh * t_coh;
              float sum = 0.f;
              for (int j = 0; j < t_coh; ++j) sum += lg_s[b0 + j];
              s[i] = sum;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          lg[i] = coh_alpha >= 1.f ? s[i]
                                   : (1.f - coh_alpha) * lg[i] + coh_alpha * s[i];
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float logit = lg[i];
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
    const int rr = warp * RPW + i;
    const int row = row0 + rr;
    if (rr < tile_rows && row < n) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int c = lane + 32 * j;
        if (c < two_d)
          out[(size_t)row * two_d + c] =
              STATS ? acc[i][j] : acc[i][j] / den[i];
      }
      if (STATS && lane == 0) {  // every lane holds the row's m and den
        m_out[row] = m_run[i];
        den_out[row] = den[i];
      }
    }
  }
}

template <int CP, int CW, int RPW, bool COH, bool STATS>
int launch(const float* r2, const float* pw, const float* mu, const float* b,
           const float* logw, float* out, float* m_out, float* den_out, int n,
           int k_comp, int two_m, int two_d, int t_coh, float coh_alpha,
           cudaStream_t stream) {
  constexpr int kTileN = kWarps * RPW;
  if (COH && t_coh > kTileN) return (int)cudaErrorInvalidValue;
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * r_stride + 2 * (size_t)kKc * s_cols +
                       (COH ? kTileN : 0));
  const int vec = (s_cols % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(pw) % 16 == 0);
  auto kern = grouped_estimate_kernel<CP, CW, RPW, COH, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int grid = (n + tile_rows - 1) / tile_rows;
  kern<<<grid, kThreads, smem, stream>>>(r2, pw, mu, b, logw, out, m_out,
                                         den_out, n, k_comp, two_m, two_d, vec,
                                         t_coh, coh_alpha);
  return (int)cudaGetLastError();
}

// The instantiation for the widths: RPW = 8 rows a warp while both widths
// are at most 128 (4 columns a lane), else 4 (kernels.tile_rows mirrors it).
template <bool COH, bool STATS>
int dispatch(const float* r2, const float* pw, const float* mu,
             const float* b, const float* logw, float* out, float* m_out,
             float* den_out, int n, int k_comp, int two_m, int two_d,
             int t_coh, float coh_alpha, void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 256 || two_d < 1 ||
      two_d > 256)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = cols_per_lane(two_m), cw = cols_per_lane(two_d);
#define QCE_LAUNCH(CP_, CW_, RPW_)                                        \
  if (cp == CP_ && cw == CW_)                                             \
    return launch<CP_, CW_, RPW_, COH, STATS>(                            \
        r2, pw, mu, b, logw, out, m_out, den_out, n, k_comp, two_m, two_d, \
        t_coh, coh_alpha, s);
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

}  // namespace

// C entry points, loaded with ctypes. Each returns a cudaError_t (0 on
// success).

// K1: r2 (n, two_m) -> out (n, two_d).
extern "C" int grouped_estimate_launch(const float* r2, const float* pw,
                                       const float* mu, const float* b,
                                       const float* logw, float* out, int n,
                                       int k_comp, int two_m, int two_d,
                                       void* stream) {
  return dispatch<false, false>(r2, pw, mu, b, logw, out, nullptr, nullptr, n,
                                k_comp, two_m, two_d, 1, 1.f, stream);
}

// K3: r2 (n, two_m) holds n / t_coh blocks of t_coh consecutive rows;
// 2 <= t_coh <= the tile's rows.
extern "C" int grouped_estimate_coherent_launch(
    const float* r2, const float* pw, const float* mu, const float* b,
    const float* logw, float* out, int n, int k_comp, int two_m, int two_d,
    int t_coh, float coh_alpha, void* stream) {
  if (t_coh < 2 || n % t_coh != 0) return (int)cudaErrorInvalidValue;
  return dispatch<true, false>(r2, pw, mu, b, logw, out, nullptr, nullptr, n,
                               k_comp, two_m, two_d, t_coh, coh_alpha, stream);
}

// K2: r2 (n, two_m) -> the K1 state m (n), den (n), acc (n, two_d).
extern "C" int grouped_estimate_stats_launch(
    const float* r2, const float* pw, const float* mu, const float* b,
    const float* logw, float* acc, float* m, float* den, int n, int k_comp,
    int two_m, int two_d, void* stream) {
  return dispatch<false, true>(r2, pw, mu, b, logw, acc, m, den, n, k_comp,
                               two_m, two_d, 1, 1.f, stream);
}

// K2, coherent: the K3 state per row of n / t_coh blocks of t_coh rows.
extern "C" int grouped_estimate_coherent_stats_launch(
    const float* r2, const float* pw, const float* mu, const float* b,
    const float* logw, float* acc, float* m, float* den, int n, int k_comp,
    int two_m, int two_d, int t_coh, float coh_alpha, void* stream) {
  if (t_coh < 2 || n % t_coh != 0) return (int)cudaErrorInvalidValue;
  return dispatch<true, true>(r2, pw, mu, b, logw, acc, m, den, n, k_comp,
                              two_m, two_d, t_coh, coh_alpha, stream);
}
