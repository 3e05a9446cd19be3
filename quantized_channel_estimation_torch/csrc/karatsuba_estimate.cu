// Karatsuba-layout online-softmax GMM-Bussgang estimator for Hopper: kernel
// K14a.
//
// Replaces the TPU kernel `_estimate_kernel` launched by `estimate_packed`
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:105,
// pallas_call :175; entry `estimate` :192). It computes K1's 'all'-mode
// estimate from the complex bank without the real 2x2 block embedding:
// per row n of r = rr + i ri (M wide) and component k, every complex
// product y = r B runs as three real ones,
//
//   p1 = rr B_re,  p2 = ri B_im,  p3 = (rr + ri)(B_re + B_im),
//   Re y = p1 - p2,  Im y = (p3 - p1) - p2,
//
// for B = conj(P_k) (y, M wide) and B = W_k^T (z, D wide, plus b_k), then
//
//   lg_nk = logw_k - |y_k - mu_k|^2,
//   h_n   = sum_k softmax_k(lg_nk) z_nk,
//
// with a running max / denominator / accumulator over k. The bank arrives
// as one slab (K, M, 3M + 3D) = [pc_re | pc_im | pc_s | wt_re | wt_im |
// wt_s] per contraction row, the sum planes precomputed as the JAX layout
// `kernel_bank` holds them.
//
// Bound on an H100: 6 N M (M + D) K fp32 operations (4.12e11 for 131072
// rows at M = D = K = 64, 6.15 ms at the 67 TFLOP/s fp32 peak; K1's block
// embedding does 4/3 of that) against ~0.17 GB of compulsory traffic
// (0.05 ms at 3.35 TB/s): bound by fp32 FMA throughput.
//
// Design, K1's, simple and correct first:
//   - one block of 8 warps per tile of 8 RPW rows; the rr and ri tiles sit
//     in shared memory, each warp owns RPW rows, each lane the columns
//     lane + 32 j of each plane (CP of the M-wide P planes, CW of the D-wide
//     W planes); rr + ri is formed in registers (the JAX kernel's shared
//     operand rs, the same float32 sum);
//   - the slab is streamed through shared memory in slices of kKc
//     contraction rows, double-buffered with cp.async from L2
//     (stream_common.cuh);
//   - plain fp32 FMAs into three register accumulators per output column;
//   - the quadratic term of each row is reduced across its warp by shuffles;
//   - the ragged last tile is masked in the kernel (any N, no padding).
// The Karatsuba imaginary part p3 - p1 - p2 cancels: its rounding error
// scales with |p1| + |p2| + |p3|, not with |Im y|. It is formed in the JAX
// kernel's order, and the kernel is held against the complex-product plain
// version and against K1 on the same bank.
// Any N and K, M and D up to 128.
#include "stream_common.cuh"

namespace {

using namespace qce;

template <int CP, int CW, int RPW>
__global__ void __launch_bounds__(kThreads)
    karatsuba_kernel(const float* __restrict__ r_re,
                     const float* __restrict__ r_im,
                     const float* __restrict__ slab,
                     const float* __restrict__ mu_re,
                     const float* __restrict__ mu_im,
                     const float* __restrict__ b_re,
                     const float* __restrict__ b_im,
                     const float* __restrict__ logw, float* __restrict__ h_re,
                     float* __restrict__ h_im, int n, int k_comp, int m,
                     int d, int vec) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  const int s_cols = 3 * m + 3 * d;
  const int r_stride = (m + 3) & ~3;
  const int buf_floats = kKc * s_cols;
  float* rr_s = smem;
  float* ri_s = rr_s + kTileN * r_stride;
  float* pw_s = ri_s + kTileN * r_stride;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTileN;

  for (int i = threadIdx.x; i < kTileN * m; i += kThreads) {
    const int rr = i / m, cc = i - rr * m;
    const int row = row0 + rr;
    const bool in = row < n;
    rr_s[rr * r_stride + cc] = in ? r_re[(size_t)row * m + cc] : 0.f;
    ri_s[rr * r_stride + cc] = in ? r_im[(size_t)row * m + cc] : 0.f;
  }

  // per-lane column offsets into a slab row (the re plane; im and sum lie
  // m or d further); masked columns read column 0 of the plane
  int off_p[CP], off_w[CW];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = lane + 32 * j;
    off_p[j] = c < m ? c : 0;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    off_w[j] = 3 * m + (c < d ? c : 0);
  }

  float p1p[RPW][CP], p2p[RPW][CP], p3p[RPW][CP];
  float p1w[RPW][CW], p2w[RPW][CW], p3w[RPW][CW];
  float acc_re[RPW][CW], acc_im[RPW][CW], m_run[RPW], den[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CP; ++j) p1p[i][j] = p2p[i][j] = p3p[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      p1w[i][j] = p2w[i][j] = p3w[i][j] = 0.f;
      acc_re[i][j] = acc_im[i][j] = 0.f;
    }
  }

  const int n_ch = (m + kKc - 1) / kKc;
  const int total = k_comp * n_ch;
  issue_stage(pw_s, slab, 0, n_ch, m, s_cols, s_cols, vec);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_stage(pw_s + ((t + 1) & 1) * buf_floats, slab, t + 1, n_ch, m,
                  s_cols, s_cols, vec);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const float* ps = pw_s + (t & 1) * buf_floats;
    const int k = t / n_ch;
    const int kk0 = (t % n_ch) * kKc;
    const int rows = min(kKc, m - kk0);
    const float* ra = rr_s + warp * RPW * r_stride + kk0;
    const float* rb = ri_s + warp * RPW * r_stride + kk0;
#pragma unroll 2
    for (int kk = 0; kk < rows; ++kk) {
      float a[RPW], ai[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        a[i] = ra[i * r_stride + kk];
        ai[i] = rb[i * r_stride + kk];
      }
      const float* prow = ps + kk * s_cols;
      float pre[CP], pim[CP], psm[CP], wre[CW], wim[CW], wsm[CW];
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        pre[j] = prow[off_p[j]];
        pim[j] = prow[off_p[j] + m];
        psm[j] = prow[off_p[j] + 2 * m];
      }
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        wre[j] = prow[off_w[j]];
        wim[j] = prow[off_w[j] + d];
        wsm[j] = prow[off_w[j] + 2 * d];
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float s = a[i] + ai[i];
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          p1p[i][j] = fmaf(a[i], pre[j], p1p[i][j]);
          p2p[i][j] = fmaf(ai[i], pim[j], p2p[i][j]);
          p3p[i][j] = fmaf(s, psm[j], p3p[i][j]);
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          p1w[i][j] = fmaf(a[i], wre[j], p1w[i][j]);
          p2w[i][j] = fmaf(ai[i], wim[j], p2w[i][j]);
          p3w[i][j] = fmaf(s, wsm[j], p3w[i][j]);
        }
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by the issue at t + 1

    if (kk0 + rows == m) {  // component k complete: online softmax
      const float* mrk = mu_re + (size_t)k * m;
      const float* mik = mu_im + (size_t)k * m;
      const float* brk = b_re + (size_t)k * d;
      const float* bik = b_im + (size_t)k * d;
      const float lw = logw[k];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const int c = lane + 32 * j;
          if (c < m) {
            const float dre = (p1p[i][j] - p2p[i][j]) - __ldg(mrk + c);
            const float dim =
                ((p3p[i][j] - p1p[i][j]) - p2p[i][j]) - __ldg(mik + c);
            q = fmaf(dre, dre, q);
            q = fmaf(dim, dim, q);
          }
          p1p[i][j] = p2p[i][j] = p3p[i][j] = 0.f;
        }
        const float logit = lw - warp_sum(q);
        const float m_new = fmaxf(m_run[i], logit);
        // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales by 0
        const float scale =
            m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
        const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
        den[i] = fmaf(den[i], scale, p);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int c = lane + 32 * j;
          const bool in = c < d;
          const float z_re =
              (p1w[i][j] - p2w[i][j]) + (in ? __ldg(brk + c) : 0.f);
          const float z_im = ((p3w[i][j] - p1w[i][j]) - p2w[i][j]) +
                             (in ? __ldg(bik + c) : 0.f);
          acc_re[i][j] = fmaf(p, z_re, acc_re[i][j] * scale);
          acc_im[i][j] = fmaf(p, z_im, acc_im[i][j] * scale);
          p1w[i][j] = p2w[i][j] = p3w[i][j] = 0.f;
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
        if (c < d) {
          h_re[(size_t)row * d + c] = acc_re[i][j] / den[i];
          h_im[(size_t)row * d + c] = acc_im[i][j] / den[i];
        }
      }
    }
  }
}

template <int CP, int CW, int RPW>
int launch(const float* r_re, const float* r_im, const float* slab,
           const float* mu_re, const float* mu_im, const float* b_re,
           const float* b_im, const float* logw, float* h_re, float* h_im,
           int n, int k_comp, int m, int d, cudaStream_t stream) {
  constexpr int kTileN = kWarps * RPW;
  const int s_cols = 3 * m + 3 * d;
  const int r_stride = (m + 3) & ~3;
  const size_t smem = sizeof(float) * (2 * (size_t)kTileN * r_stride +
                                       2 * (size_t)kKc * s_cols);
  const int vec = (s_cols % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(slab) % 16 == 0);
  auto kern = karatsuba_kernel<CP, CW, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kTileN - 1) / kTileN;
  kern<<<grid, kThreads, smem, stream>>>(r_re, r_im, slab, mu_re, mu_im, b_re,
                                         b_im, logw, h_re, h_im, n, k_comp, m,
                                         d, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K14a: r_re, r_im (n, m) -> h_re, h_im (n, d); slab (k_comp, m, 3m + 3d),
// mu_re, mu_im (k_comp, m), b_re, b_im (k_comp, d), logw (k_comp).
// Rows a warp: 8 while m, d <= 64 (two columns a lane and plane), 4 with
// one of them past 64, 2 with both (the accumulators' registers).
extern "C" int karatsuba_estimate_launch(
    const float* r_re, const float* r_im, const float* slab,
    const float* mu_re, const float* mu_im, const float* b_re,
    const float* b_im, const float* logw, float* h_re, float* h_im, int n,
    int k_comp, int m, int d, void* stream) {
  if (n < 0 || k_comp < 1 || m < 1 || m > 128 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = cols_per_lane(m), cw = cols_per_lane(d);
#define QCE_LAUNCH(CP_, CW_, RPW_)                                           \
  if (cp == CP_ && cw == CW_)                                                \
    return launch<CP_, CW_, RPW_>(r_re, r_im, slab, mu_re, mu_im, b_re, b_im, \
                                  logw, h_re, h_im, n, k_comp, m, d, s);
  QCE_LAUNCH(2, 2, 8)
  QCE_LAUNCH(2, 4, 4)
  QCE_LAUNCH(4, 2, 4)
  QCE_LAUNCH(4, 4, 2)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
