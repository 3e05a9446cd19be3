// Factored (MFA, low-rank plus diagonal) Bussgang estimator for Hopper:
// kernels K11 (flat), K12 (coherent) and K13 (stats), one template with COH
// and STATS flags.
//
// Replaces the TPU kernels `_fact_kernel` (:2048), `_fact_kernel_coh`
// (:2126) and `_fact_kernel_stats` (:2231) launched by
// `estimate_fact_packed` (:2091), `estimate_fact_packed_coh` (:2183) and
// `estimate_fact_packed_stats` (:2275) of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py. Per row n
// of x (N x 2D, complex64 observations as interleaved [re, im] pairs) and
// component k, with the Woodbury factors of the bank (M << D):
//
//   [beta | gamma] = x @ fwd_k             (2D, 4M): beta = T r, gamma = P2 r
//   lg_nk  = const_k + [Re r | Im r | |r|^2] . lcoef_k + |beta - T mu|^2
//   w_nk   = softmax_k(lg'_nk)
//   h_n    = sum_k w_nk ([beta | gamma] @ comb_k + bias_k + a1_k o r)
//            comb_k (4M, 2D): gamma Lambda^T - beta R^T
//
// lg' = lg for K11/K13. For K12 the rows are block-major (the T rows of a
// coherence block consecutive), s_k = sum of lg_k over the row's block and
// lg' = lg + alpha (s - lg) (alpha >= 1: s); the caller divides the mixture
// log-weight inside const by (1 - alpha + alpha T) so that it enters once
// per block, while logdet and the mean term pool T times. K13 emits
// m = max_k lg, den = sum_k exp(lg - m) and the un-normalised h, so that the
// states of disjoint component shards merge exactly.
//
// Bound on an H100: 2 N K (2D 4M + 4M 2D + 3D + 2M + 6D) fp32 operations
// (2.8e11 for a 131072-row batch at D = K = 64, M = 16: 4.2 ms at the
// 67 TFLOP/s fp32 peak), against 2 N 2D 4 bytes of compulsory traffic plus
// the 4.3 MB bank (0.14 GB, 0.04 ms at 3.35 TB/s): bound by fp32 FMA
// throughput, half the dense estimator K1's work (the D / 2M saving of the
// factored form). TF32 is excluded as in K1: the logit is an expanded
// quadratic that cancels at high SNR.
//
// Design, simple and correct first:
//   - the TPU kernel keeps the whole bank resident (4.3 MB at the headline)
//     and forms beta and gamma of every component at once (2 K M complex
//     values a row), reducing |beta - T mu|^2 and broadcasting w through
//     block-indicator GEMMs. Here the bank streams from L2 one component at
//     a time through a two-buffer cp.async ring of 16 KB slices, K1's
//     grouped online softmax: the forward slab of component k, then its
//     combine slab, in one uninterrupted stream of stages. No (rows, K M)
//     intermediate is kept and no indicator product is done;
//   - one block of 8 warps per tile of 8 RPW rows, tiles independent; a row
//     keeps [x (2D) | p [beta | gamma] (4M)] floats in shared memory, each
//     warp owns RPW rows, so the left operand of both products is
//     warp-private and read by broadcast, two columns at a time;
//   - forward: a lane owns the complex outputs q = lane + 32 j of
//     [beta | gamma] in registers; when the slab is done, the logit's two
//     sums (the D diagonal terms of the lane's bins, the M terms of
//     |beta - T mu|^2) are each reduced across the warp on their own and
//     then added: the two cancel at high SNR. The running max is updated,
//     the accumulator rescaled, p [beta | gamma] written to the row's slots;
//   - combine: a lane owns the bins c = lane + 32 j of h (both halves of a
//     complex value), accumulating p [beta | gamma] @ comb_k straight into
//     the online-softmax accumulator, plus p (bias + a1 o r) at its bins;
//   - K12: a tile holds floor(8 RPW / T) whole blocks; the warps exchange a
//     component's logits through shared memory (one extra barrier a
//     component) and pool them over T in a compensated sum;
//   - dead components carry a finite -1e30 const; plain fp32 FMAs; the
//     ragged last tile is masked in the kernel (no padding copy).
// Any N and K in one launch, 1 <= D <= 128, 1 <= M <= 64, T up to the
// tile's rows (64 for D <= 64 and M <= 32, else 32).
#include <algorithm>

#include "circ_common.cuh"

namespace {

using namespace qce;

// Asynchronous copy of stage t of the stream into buf: stage s = t % per of
// component k = t / per is slice s of the forward slab (s < nf, rows_f rows
// of 4M floats) or slice s - nf of the combine slab (rows_c rows of 2D).
__device__ __forceinline__ void issue_fact_stage(
    float* buf, const float* __restrict__ fwd, const float* __restrict__ comb,
    int t, int per, int nf, int rows_f, int rows_c, int two_d, int four_m,
    bool vec) {
  const int k = t / per, s = t - k * per;
  if (s < nf) {
    const int r0 = s * rows_f;
    start_copy(buf, fwd + ((size_t)k * two_d + r0) * four_m,
               min(rows_f, two_d - r0) * four_m, vec);
  } else {
    const int r0 = (s - nf) * rows_c;
    start_copy(buf, comb + ((size_t)k * four_m + r0) * two_d,
               min(rows_c, four_m - r0) * two_d, vec);
  }
}

template <int CF, int CW, int RPW, bool COH, bool STATS>
__global__ void __launch_bounds__(kThreads)
    fact_estimate_kernel(const float* __restrict__ x,
                         const float* __restrict__ fwd,
                         const float* __restrict__ comb,
                         const float* __restrict__ tmu,
                         const float* __restrict__ lcoef,
                         const float* __restrict__ cst,
                         const float* __restrict__ bias,
                         const float* __restrict__ a1,
                         float* __restrict__ out, float* __restrict__ m_out,
                         float* __restrict__ den_out, int n, int d, int m,
                         int k_comp, int stride, int rows_f, int rows_c,
                         int vec, int t_coh, float alpha) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  float* rows_s = smem;                    // kTileN rows of `stride` floats
  float* ring = smem + kTileN * stride;    // 2 buffers of kStage floats
  float* lg_s = ring + 2 * kStage;         // K12: a component's tile logits
  const int two_d = 2 * d, two_m = 2 * m, four_m = 4 * m;
  const int g_off = two_d;                 // a row's p [beta | gamma] slots

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows of this tile: whole T-row blocks for K12
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int row0 = blockIdx.x * tile_rows;

  // x tile -> the rows' x slots; masked rows read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_d; i += kThreads) {
    const int rr = i / two_d, cc = i - rr * two_d;
    const int row = row0 + rr;
    rows_s[rr * stride + cc] =
        (rr < tile_rows && row < n) ? x[(size_t)row * two_d + cc] : 0.f;
  }
  float* my = rows_s + warp * RPW * stride;  // this warp's rows

  // the lane's forward outputs q (complex, of [beta | gamma]) and bins c;
  // masked ones read column 0 and are never used
  int off_f[CF], off_c[CW];
#pragma unroll
  for (int j = 0; j < CF; ++j) {
    const int q = lane + 32 * j;
    off_f[j] = q < two_m ? 2 * q : 0;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    off_c[j] = c < d ? 2 * c : 0;
  }

  float fw[RPW][2 * CF], acc[RPW][2 * CW], m_run[RPW], den[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * CF; ++j) fw[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * CW; ++j) acc[i][j] = 0.f;
  }

  const int nf = (two_d + rows_f - 1) / rows_f;
  const int nc = (four_m + rows_c - 1) / rows_c;
  const int per = nf + nc;
  const int total = k_comp * per;
  issue_fact_stage(ring, fwd, comb, 0, per, nf, rows_f, rows_c, two_d,
                   four_m, vec);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_fact_stage(ring + ((t + 1) & 1) * kStage, fwd, comb, t + 1, per,
                       nf, rows_f, rows_c, two_d, four_m, vec);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const float* bs = ring + (t & 1) * kStage;
    const int k = t / per, s = t - k * per;
    if (s < nf) {
      // forward: fw += x[kk0:kk0+rows] @ slice (rows, 4M)
      const int kk0 = s * rows_f;
      const int rows = min(rows_f, two_d - kk0);
      const float* as = my + kk0;
#pragma unroll 2
      for (int kk = 0; kk < rows; kk += 2) {
        float2 a[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          a[i] = *reinterpret_cast<const float2*>(as + i * stride + kk);
        const float* b0 = bs + kk * four_m;
#pragma unroll
        for (int j = 0; j < CF; ++j) {
          const float2 u0 = *reinterpret_cast<const float2*>(b0 + off_f[j]);
          const float2 u1 =
              *reinterpret_cast<const float2*>(b0 + four_m + off_f[j]);
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            fw[i][2 * j] =
                fmaf(a[i].y, u1.x, fmaf(a[i].x, u0.x, fw[i][2 * j]));
            fw[i][2 * j + 1] =
                fmaf(a[i].y, u1.y, fmaf(a[i].x, u0.y, fw[i][2 * j + 1]));
          }
        }
      }
    } else {
      // combine: acc += p [beta | gamma][kk0:kk0+rows] @ slice (rows, 2D)
      const int kk0 = (s - nf) * rows_c;
      const int rows = min(rows_c, four_m - kk0);
      const float* as = my + g_off + kk0;
#pragma unroll 2
      for (int kk = 0; kk < rows; kk += 2) {
        float2 a[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          a[i] = *reinterpret_cast<const float2*>(as + i * stride + kk);
        const float* b0 = bs + kk * two_d;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const float2 u0 = *reinterpret_cast<const float2*>(b0 + off_c[j]);
          const float2 u1 =
              *reinterpret_cast<const float2*>(b0 + two_d + off_c[j]);
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            acc[i][2 * j] =
                fmaf(a[i].y, u1.x, fmaf(a[i].x, u0.x, acc[i][2 * j]));
            acc[i][2 * j + 1] =
                fmaf(a[i].y, u1.y, fmaf(a[i].x, u0.y, acc[i][2 * j + 1]));
          }
        }
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by the issue at t + 1

    if (s != nf - 1) continue;

    // component k's beta and gamma are complete: its logits
    const float ck = __ldg(cst + k);
    const float* lk = lcoef + (size_t)k * 3 * d;
    const float* tk = tmu + (size_t)k * two_m;
    float l0[CW], l1[CW], l2[CW], tr[CF], ti[CF];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int c = lane + 32 * j;
      const bool live = c < d;
      l0[j] = live ? __ldg(lk + c) : 0.f;
      l1[j] = live ? __ldg(lk + d + c) : 0.f;
      l2[j] = live ? __ldg(lk + 2 * d + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      const int q = lane + 32 * j;
      tr[j] = q < m ? __ldg(tk + 2 * q) : 0.f;
      ti[j] = q < m ? __ldg(tk + 2 * q + 1) : 0.f;
    }
    float lg[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float lin = 0.f, quad = 0.f;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float2 xv =
            *reinterpret_cast<const float2*>(my + i * stride + off_c[j]);
        lin = fmaf(l0[j], xv.x, lin);
        lin = fmaf(l1[j], xv.y, lin);
        lin = fmaf(l2[j], fmaf(xv.x, xv.x, xv.y * xv.y), lin);
      }
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        if (lane + 32 * j < m) {
          const float dr = fw[i][2 * j] - tr[j];
          const float di = fw[i][2 * j + 1] - ti[j];
          quad = fmaf(dr, dr, fmaf(di, di, quad));
        }
      }
      // the two sums cancel at high SNR: each is reduced on its own
      lg[i] = ck + warp_sum(lin) + warp_sum(quad);
    }

    if constexpr (COH) {
      // pool over each block's rows: lg_s was last read before this stage's
      // first barrier
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) lg_s[warp * RPW + i] = lg[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rr = warp * RPW + i;
        float pooled = lg[i];  // masked rows: never stored
        if (rr < tile_rows) {
          // compensated (Kahan) sum: a pooled logit is T times a row's
          const int b0 = rr / t_coh * t_coh;
          float sum = 0.f, lost = 0.f;
          for (int tt = 0; tt < t_coh; ++tt) {
            const float y = lg_s[b0 + tt] - lost;
            const float next = sum + y;
            lost = (next - sum) - y;
            sum = next;
          }
          pooled = sum;
        }
        lg[i] = alpha >= 1.f ? pooled : fmaf(alpha, pooled - lg[i], lg[i]);
      }
    }

    // online softmax: rescale, add p (bias + a1 o r), stash p [beta|gamma]
    const float* bk = bias + (size_t)k * two_d;
    const float* ak = a1 + (size_t)k * two_d;
    float2 bv[CW], av[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      bv[j] = __ldg(reinterpret_cast<const float2*>(bk + off_c[j]));
      av[j] = __ldg(reinterpret_cast<const float2*>(ak + off_c[j]));
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float m_new = fmaxf(m_run[i], lg[i]);
      // exp(-inf - (-inf)) would be NaN: the first component scales by 0
      const float scale =
          m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      const float p = expf(lg[i] - m_new);
      den[i] = fmaf(den[i], scale, p);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float2 xv =
            *reinterpret_cast<const float2*>(my + i * stride + off_c[j]);
        const float hr = fmaf(-av[j].y, xv.y, fmaf(av[j].x, xv.x, bv[j].x));
        const float hi = fmaf(av[j].y, xv.x, fmaf(av[j].x, xv.y, bv[j].y));
        acc[i][2 * j] = fmaf(p, hr, acc[i][2 * j] * scale);
        acc[i][2 * j + 1] = fmaf(p, hi, acc[i][2 * j + 1] * scale);
      }
      // the combine stages read these after the next stage's first barrier
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        if (lane + 32 * j < two_m)
          *reinterpret_cast<float2*>(my + i * stride + g_off + off_f[j]) =
              make_float2(p * fw[i][2 * j], p * fw[i][2 * j + 1]);
        fw[i][2 * j] = 0.f;
        fw[i][2 * j + 1] = 0.f;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = warp * RPW + i;
    const int row = row0 + rr;
    if (rr < tile_rows && row < n) {
      if constexpr (STATS) {
        if (lane == 0) {
          m_out[row] = m_run[i];
          den_out[row] = den[i];
        }
      }
      const float inv = STATS ? 1.f : 1.f / den[i];
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        if (lane + 32 * j < d) {
          float2 h = make_float2(acc[i][2 * j], acc[i][2 * j + 1]);
          if constexpr (!STATS) h = make_float2(h.x * inv, h.y * inv);
          *reinterpret_cast<float2*>(out + (size_t)row * two_d + off_c[j]) =
              h;
        }
      }
    }
  }
}

template <int CF, int CW, int RPW, bool COH, bool STATS>
int launch(const float* x, const float* fwd, const float* comb,
           const float* tmu, const float* lcoef, const float* cst,
           const float* bias, const float* a1, float* out, float* m_out,
           float* den_out, int n, int d, int m, int k_comp, int t_coh,
           float alpha, cudaStream_t stream) {
  constexpr int kTileN = kWarps * RPW;
  if (COH && t_coh > kTileN) return (int)cudaErrorInvalidValue;
  const int two_d = 2 * d, four_m = 4 * m;
  const int stride = (two_d + four_m + 3) & ~3;
  // slices of an even number of rows: the products read two rows a step
  const int rows_f = std::min(two_d, (kStage / four_m) & ~1);
  const int rows_c = std::min(four_m, (kStage / two_d) & ~1);
  const size_t smem = sizeof(float) * ((size_t)kTileN * stride +
                                       2 * (size_t)kStage +
                                       (COH ? kTileN : 0));
  const int vec = (reinterpret_cast<uintptr_t>(fwd) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(comb) % 16 == 0);
  auto kern = fact_estimate_kernel<CF, CW, RPW, COH, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int grid = (n + tile_rows - 1) / tile_rows;
  kern<<<grid, kThreads, smem, stream>>>(
      x, fwd, comb, tmu, lcoef, cst, bias, a1, out, m_out, den_out, n, d, m,
      k_comp, stride, rows_f, rows_c, vec, t_coh, alpha);
  return (int)cudaGetLastError();
}

// The instantiation for the widths: complex outputs a lane CF = 1, 2, 4 for
// 2M <= 32, 64, 128; bins a lane CW = 1, 2, 4 for D <= 32, 64, 128; RPW = 8
// rows a warp while CF, CW <= 2, else 4 (fact_kernels.fact_tile_rows
// mirrors it).
template <bool COH, bool STATS>
int dispatch(const float* x, const float* fwd, const float* comb,
             const float* tmu, const float* lcoef, const float* cst,
             const float* bias, const float* a1, float* out, float* m_out,
             float* den_out, int n, int d, int m, int k_comp, int t_coh,
             float alpha, cudaStream_t s) {
  const int cf = 2 * m <= 32 ? 1 : 2 * m <= 64 ? 2 : 4;
  const int cw = d <= 32 ? 1 : d <= 64 ? 2 : 4;
#define QCE_LAUNCH(CF_, CW_, RPW_)                                            \
  if (cf == CF_ && cw == CW_)                                                 \
    return launch<CF_, CW_, RPW_, COH, STATS>(x, fwd, comb, tmu, lcoef, cst,  \
                                              bias, a1, out, m_out, den_out, \
                                              n, d, m, k_comp, t_coh, alpha, \
                                              s);
  QCE_LAUNCH(1, 1, 8)
  QCE_LAUNCH(1, 2, 8)
  QCE_LAUNCH(2, 1, 8)
  QCE_LAUNCH(2, 2, 8)
  QCE_LAUNCH(1, 4, 4)
  QCE_LAUNCH(2, 4, 4)
  QCE_LAUNCH(4, 1, 4)
  QCE_LAUNCH(4, 2, 4)
  QCE_LAUNCH(4, 4, 4)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// x (n, 2d) and out (n, 2d) hold complex values as interleaved [re, im]
// pairs. t_coh > 1 selects the coherent kernel K12 (n a whole number of
// t_coh row blocks); stats != 0 selects K13, which writes the un-normalised
// accumulator to out and m, den (n) to m_out, den_out. The two are not
// combined.
extern "C" int fact_estimate_launch(const float* x, const float* fwd,
                                    const float* comb, const float* tmu,
                                    const float* lcoef, const float* cst,
                                    const float* bias, const float* a1,
                                    float* out, float* m_out, float* den_out,
                                    int n, int d, int m, int k_comp,
                                    int t_coh, float alpha, int stats,
                                    void* stream) {
  if (n < 0 || d < 1 || d > 128 || m < 1 || m > 64 || k_comp < 1 ||
      t_coh < 1 || n % t_coh != 0 || (stats && t_coh > 1) ||
      (stats && (m_out == nullptr || den_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_coh > 1)
    return dispatch<true, false>(x, fwd, comb, tmu, lcoef, cst, bias, a1, out,
                                 m_out, den_out, n, d, m, k_comp, t_coh,
                                 alpha, s);
  if (stats)
    return dispatch<false, true>(x, fwd, comb, tmu, lcoef, cst, bias, a1, out,
                                 m_out, den_out, n, d, m, k_comp, 1, 1.f, s);
  return dispatch<false, false>(x, fwd, comb, tmu, lcoef, cst, bias, a1, out,
                                m_out, den_out, n, d, m, k_comp, 1, 1.f, s);
}
