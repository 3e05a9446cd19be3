// Single-pass circulant (FFT-domain) GMM-Bussgang estimator for Hopper:
// kernels K6 (flat), K7 (coherent), K8 (stats) and K9 (coherent stats), one
// template with COH and STATS flags.
//
// Replaces the TPU kernels `_circ_kernel`, `_circ_kernel_coh`,
// `_circ_kernel_stats` and `_circ_kernel_coh_stats` launched by
// `estimate_circ_packed` (:1346), `estimate_circ_packed_coh` (:1698),
// `estimate_circ_packed_stats` (:1789) and `estimate_circ_packed_coh_stats`
// (:1868) of quantized_channel_estimation_tpu/estimators/pallas_kernels.py.
// Per row n of x (N x 2D, complex64 observations as interleaved [re, im]
// pairs) and component k:
//
//   u      = x @ bfwd                      forward (block-)DFT, (2D, 2D)
//   lg_nk  = [u, |u|^2] @ lcoef + const    one (3D, K) product
//   w_nk   = softmax_k(lg'_nk)
//   c      = w @ comb                      (K, 4D): [br, bi, fr, fi] per bin
//   h      = (br + i bi) + (fr + i fi) * u
//   out    = h @ binv                      inverse (block-)DFT, (2D, 2D)
//
// lg' = lg for K6/K8. For K7/K9 the rows are block-major (the T rows of a
// coherence block consecutive), s_k = sum of lg_k over the row's block and
// lg' = lg + alpha (s - lg) (alpha >= 1: s); the caller divides the mixture
// log-weight inside const by (1 - alpha + alpha T) so that it enters once
// per block. STATS (K8/K9) stops before the normalisation and the inverse
// transform: it emits m = max_k lg', den = sum_k exp(lg' - m) and the
// un-normalised h (the DFT-domain accumulator) so that states of disjoint
// component shards merge exactly; the inverse transform runs once after
// the merge. The transforms are general matrices, so the kron(F_n1, F_n2)
// basis of block-circulant banks rides the same kernel.
//
// Bound on an H100: 2 N (2D 2D + 3D K + K 4D + 2D 2D) fp32 operations
// (1.6e10 for a 131072-row batch at D = K = 64, 0.24 ms at the 67 TFLOP/s
// fp32 peak) against 2 N 2D 4 bytes of compulsory traffic (0.13 GB,
// 0.04 ms at 3.35 TB/s): bound by fp32 FMA throughput, 34x less work than
// the dense estimator K1. TF32 is excluded as in K1: the expanded quadratic
// logit cancels at high SNR and a 10-bit mantissa moves the posterior.
//
// Design, simple and correct first:
//   - the TPU kernel keeps all operands resident in fast memory; here they
//     total 246 KB at D = K = 64, over a block's 227 KB, so each phase
//     streams its one operand through a two-buffer cp.async ring of 16 KB
//     slices (all of it lives in the 50 MB L2) while the tile's rows stay
//     in shared memory: per row [u (2D) | |u|^2 (D) | w (K)] floats;
//   - one block of 8 warps per tile of 8 RPW rows, tiles independent (the
//     kernel carries nothing between them); each warp owns RPW rows, so the
//     left operand of every product is warp-private and read by broadcast;
//     each lane owns the bins c = lane + 32 j (both halves of a complex
//     value, all four combine coefficients), so the elementwise complex
//     steps need no exchange between lanes;
//   - plain fp32 FMAs into register accumulators;
//   - the softmax max and sum go across the warp by shuffles;
//   - K7/K9: a tile holds floor(8 RPW / T) whole blocks; the warps exchange
//     their logits through the rows' w slots, two extra barriers a tile;
//     the pool over T is a compensated sum;
//   - the ragged last tile is masked in the kernel (no padding copy).
// Any N, 1 <= D <= 128, 1 <= K <= 128, T up to the tile's rows (64 for
// D <= 64, else 32).
#include "circ_common.cuh"

namespace {

using namespace qce;

template <int CD, int CK, int RPW, bool COH, bool STATS>
__global__ void __launch_bounds__(kThreads)
    circ_estimate_kernel(const float* __restrict__ x,
                         const float* __restrict__ bfwd,
                         const float* __restrict__ lcoef,
                         const float* __restrict__ cst,
                         const float* __restrict__ comb,
                         const float* __restrict__ binv,
                         float* __restrict__ out, float* __restrict__ m_out,
                         float* __restrict__ den_out, int n, int d,
                         int k_comp, int stride, int t_coh, float alpha) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  float* rows_s = smem;                    // kTileN rows of `stride` floats
  float* ring = smem + kTileN * stride;    // 2 buffers of kStage floats
  const int two_d = 2 * d;
  const int w_off = 3 * d;                 // a row's w slots

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows of this tile: whole T-row blocks for K7/K9
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int row0 = blockIdx.x * tile_rows;

  // x tile -> the rows' u slots; masked rows read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_d; i += kThreads) {
    const int rr = i / two_d, cc = i - rr * two_d;
    const int row = row0 + rr;
    rows_s[rr * stride + cc] =
        (rr < tile_rows && row < n) ? x[(size_t)row * two_d + cc] : 0.f;
  }

  float* my = rows_s + warp * RPW * stride;  // this warp's rows

  // 1. forward transform: u over x, |u|^2 behind it
  {
    float u[RPW][CD * 2];
    tile_gemm<RPW, CD, 2>(my, stride, two_d, bfwd, two_d, ring, lane, u);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = lane + 32 * j;
        if (c < d) {
          const float ur = u[i][2 * j], ui = u[i][2 * j + 1];
          *reinterpret_cast<float2*>(my + i * stride + 2 * c) =
              make_float2(ur, ui);
          my[i * stride + two_d + c] = fmaf(ur, ur, ui * ui);
        }
      }
  }

  // 2. logits of the components k = lane + 32 j
  float lg[RPW][CK];
  tile_gemm<RPW, CK, 1>(my, stride, 3 * d, lcoef, k_comp, ring, lane, lg);
#pragma unroll
  for (int j = 0; j < CK; ++j) {
    const int k = lane + 32 * j;
    const float ck = k < k_comp ? __ldg(cst + k) : 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      lg[i][j] = k < k_comp ? lg[i][j] + ck : -INFINITY;
  }

  // 3. K7/K9: pool over each block's rows through the w slots
  if constexpr (COH)
    pool_over_blocks<RPW, CK>(lg, rows_s, stride, w_off, warp, lane,
                              tile_rows, t_coh, k_comp, alpha);

  // softmax over k: w (K6/K7) or the un-normalised p with m and den
  {
    float mx[RPW], den[RPW];
    softmax_rows<RPW, CK, !STATS>(lg, my, stride, w_off, k_comp, lane, mx,
                                  den);
    if constexpr (STATS) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rr = warp * RPW + i;
        const int row = row0 + rr;
        if (lane == 0 && rr < tile_rows && row < n) {
          m_out[row] = mx[i];
          den_out[row] = den[i];
        }
      }
    }
  }

  // 4. combine: c = w @ comb, h = bias + filt * u (over u in place)
  {
    float c4[RPW][CD * 4];
    tile_gemm<RPW, CD, 4>(my + w_off, stride, k_comp, comb, 4 * d, ring,
                          lane, c4);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i;
      const int row = row0 + rr;
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = lane + 32 * j;
        if (c < d) {
          float2* up = reinterpret_cast<float2*>(my + i * stride + 2 * c);
          const float2 u = *up;
          const float br = c4[i][4 * j], bi = c4[i][4 * j + 1];
          const float fr = c4[i][4 * j + 2], fi = c4[i][4 * j + 3];
          const float2 h =
              make_float2(fmaf(-fi, u.y, fmaf(fr, u.x, br)),
                          fmaf(fi, u.x, fmaf(fr, u.y, bi)));
          if constexpr (STATS) {
            if (rr < tile_rows && row < n)
              *reinterpret_cast<float2*>(out + (size_t)row * two_d + 2 * c) =
                  h;
          } else {
            *up = h;
          }
        }
      }
    }
  }

  // 5. inverse transform
  if constexpr (!STATS) {
    float o[RPW][CD * 2];
    tile_gemm<RPW, CD, 2>(my, stride, two_d, binv, two_d, ring, lane, o);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i;
      const int row = row0 + rr;
      if (rr < tile_rows && row < n) {
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          const int c = lane + 32 * j;
          if (c < d)
            *reinterpret_cast<float2*>(out + (size_t)row * two_d + 2 * c) =
                make_float2(o[i][2 * j], o[i][2 * j + 1]);
        }
      }
    }
  }
}

template <int CD, int CK, int RPW, bool COH, bool STATS>
int launch(const float* x, const float* bfwd, const float* lcoef,
           const float* cst, const float* comb, const float* binv,
           float* out, float* m_out, float* den_out, int n, int d,
           int k_comp, int t_coh, float alpha, cudaStream_t stream) {
  constexpr int kTileN = kWarps * RPW;
  if (COH && t_coh > kTileN) return (int)cudaErrorInvalidValue;
  const int stride = (3 * d + k_comp + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * stride + 2 * (size_t)kStage);
  auto kern = circ_estimate_kernel<CD, CK, RPW, COH, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int grid = (n + tile_rows - 1) / tile_rows;
  kern<<<grid, kThreads, smem, stream>>>(x, bfwd, lcoef, cst, comb, binv, out,
                                         m_out, den_out, n, d, k_comp, stride,
                                         t_coh, alpha);
  return (int)cudaGetLastError();
}

// The instantiation for the widths: bins a lane CD = 1, 2, 4 for D <= 32,
// 64, 128; components a lane CK likewise for K; RPW = 8 rows a warp up to
// D = 64, else 4 (circ_kernels.circ_tile_rows mirrors it).
template <bool COH, bool STATS>
int dispatch(const float* x, const float* bfwd, const float* lcoef,
             const float* cst, const float* comb, const float* binv,
             float* out, float* m_out, float* den_out, int n, int d,
             int k_comp, int t_coh, float alpha, cudaStream_t s) {
  const int cd = d <= 32 ? 1 : d <= 64 ? 2 : 4;
  const int ck = k_comp <= 32 ? 1 : k_comp <= 64 ? 2 : 4;
#define QCE_LAUNCH(CD_, CK_, RPW_)                                          \
  if (cd == CD_ && ck == CK_)                                               \
    return launch<CD_, CK_, RPW_, COH, STATS>(x, bfwd, lcoef, cst, comb,    \
                                              binv, out, m_out, den_out, n, \
                                              d, k_comp, t_coh, alpha, s);
  QCE_LAUNCH(1, 1, 8)
  QCE_LAUNCH(1, 2, 8)
  QCE_LAUNCH(1, 4, 8)
  QCE_LAUNCH(2, 1, 8)
  QCE_LAUNCH(2, 2, 8)
  QCE_LAUNCH(2, 4, 8)
  QCE_LAUNCH(4, 1, 4)
  QCE_LAUNCH(4, 2, 4)
  QCE_LAUNCH(4, 4, 4)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// x (n, 2d) and out (n, 2d) hold complex values as interleaved [re, im]
// pairs. t_coh > 1 selects the coherent kernels (n a whole number of t_coh
// row blocks); stats != 0 selects the stats kernels, which write the
// DFT-domain accumulator to out and m, den (n) to m_out, den_out.
extern "C" int circ_estimate_launch(const float* x, const float* bfwd,
                                    const float* lcoef, const float* cst,
                                    const float* comb, const float* binv,
                                    float* out, float* m_out, float* den_out,
                                    int n, int d, int k_comp, int t_coh,
                                    float alpha, int stats, void* stream) {
  if (n < 0 || d < 1 || d > 128 || k_comp < 1 || k_comp > 128 || t_coh < 1 ||
      n % t_coh != 0 || (stats && (m_out == nullptr || den_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_coh > 1) {
    if (stats)
      return dispatch<true, true>(x, bfwd, lcoef, cst, comb, binv, out, m_out,
                                  den_out, n, d, k_comp, t_coh, alpha, s);
    return dispatch<true, false>(x, bfwd, lcoef, cst, comb, binv, out, m_out,
                                 den_out, n, d, k_comp, t_coh, alpha, s);
  }
  if (stats)
    return dispatch<false, true>(x, bfwd, lcoef, cst, comb, binv, out, m_out,
                                 den_out, n, d, k_comp, 1, 1.f, s);
  return dispatch<false, false>(x, bfwd, lcoef, cst, comb, binv, out, m_out,
                                den_out, n, d, k_comp, 1, 1.f, s);
}
