// Single-pass multi-pilot circulant (FFT-domain) GMM-Bussgang estimator for
// Hopper: kernel K10, flat and coherent, one template with a COH flag.
//
// Replaces the TPU kernel `_mp_circ_kernel` (:1505) launched by
// `estimate_mp_circ_packed` (:1578) of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py. The
// observation of a row is P pilot segments of D complex values (the
// reference's kron(x, I) layout), a complex64 tensor's interleaved [re, im]
// pairs: x is (N, 2PD). Per row n and component k, with u_p the transform
// of segment p:
//
//   u_p    = x_p @ bfwd                    forward (block-)DFT, (2D, 2D)
//   z      = [u_1 .. u_P | |u_1|^2 .. |u_P|^2 | v_12 v_13 .. v_(P-1)P]
//            v_pq = conj(u_p) u_q, interleaved, p < q
//   lg_nk  = z @ lcoef + const             F = D (3P + P (P-1)) features
//   w_nk   = softmax_k(lg'_nk)
//   h      = w @ comb_0 + sum_p (w @ comb_p) * u_p     per bin, complex
//   out    = h @ binv                      inverse (block-)DFT, (2D, 2D)
//
// lg' = lg for the flat form. For the coherent form the rows are block-major
// (the T rows of a coherence block consecutive), s_k = sum of lg_k over the
// row's block and lg' = lg + alpha (s - lg) (alpha >= 1: s); the caller
// divides the mixture log-weight inside const by (1 - alpha + alpha T) so
// that it enters once per block.
//
// Bound on an H100: 2 N (P 2D 2D + F K + (P+1) K 2D + 2D 2D) fp32
// operations (2.8e10 for a 131072-row batch at P = 2, D = K = 64, 0.42 ms at
// the 67 TFLOP/s fp32 peak) against N (2PD + 2D) 4 bytes of compulsory
// traffic (0.20 GB, 0.06 ms at 3.35 TB/s): bound by fp32 FMA throughput.
// TF32 is excluded: the expanded quadratic sums P^2 terms that cancel at
// high SNR and a 10-bit mantissa moves the posterior.
//
// Design, simple and correct first (the tile product, the pool and the
// softmax are those of K6-K9, circ_common.cuh):
//   - the TPU kernel multiplies a [Re | Im] split copy of the row by P
//     mostly-zero (2PD, D) operands; here segment p of the interleaved row
//     is the left operand of the one (2D, 2D) matrix, P products, no copy;
//   - the TPU kernel materialises the F features of a row (1536 floats at
//     P = 4, D = 64: a 64-row tile would take 384 KB, over a block's
//     227 KB). Here a row keeps [u (2PD) | one group (2D) | w (K)] floats;
//     the logit product runs group by group: u_p for each p, then |u_p|^2
//     for each p and v_pq for each pair, each formed in the group slots
//     just before its slice of lcoef streams by. So the tile keeps K6's
//     rows at any P and P is a runtime loop, not a template value;
//   - the groups' terms cancel (the diagonal terms of u^H Prec u against
//     the pair terms, more so as P grows): one running float32 sum over all
//     F features reads 4x the plain version's error at P = 4, D = 64. Each
//     group's product (at most 2D terms) is summed on its own and the
//     groups are added in a compensated (Kahan) sum;
//   - the combine is P + 1 products against the (K, 2D) slabs of comb
//     (bias, filt_1 .. filt_P), h held in registers across them: a lane
//     owns the bins c = lane + 32 j and reads u_p at those bins;
//   - one block of 8 warps per tile of 8 RPW rows, tiles independent; the
//     ragged last tile is masked in the kernel (no padding copy); plain
//     fp32 FMAs; the pool over T is a compensated sum.
// Any N, P >= 1, 1 <= D <= 128, 1 <= K <= 128, T up to the tile's rows (64
// for D <= 64, else 32), as far as the tile fits a block's shared memory.
#include "circ_common.cuh"

namespace {

using namespace qce;

template <int CD, int CK, int RPW, bool COH>
__global__ void __launch_bounds__(kThreads)
    mp_circ_estimate_kernel(const float* __restrict__ x,
                            const float* __restrict__ bfwd,
                            const float* __restrict__ lcoef,
                            const float* __restrict__ cst,
                            const float* __restrict__ comb,
                            const float* __restrict__ binv,
                            float* __restrict__ out, int n, int d, int p_pil,
                            int k_comp, int stride, int t_coh, float alpha) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  float* rows_s = smem;                    // kTileN rows of `stride` floats
  float* ring = smem + kTileN * stride;    // 2 buffers of kStage floats
  const int two_d = 2 * d;
  const int two_pd = p_pil * two_d;
  const int g_off = two_pd;                // a row's group slots (2D)
  const int w_off = two_pd + two_d;        // a row's w slots (K)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows of this tile: whole T-row blocks for the coherent form
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int row0 = blockIdx.x * tile_rows;

  // x tile -> the rows' u slots; masked rows read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_pd; i += kThreads) {
    const int rr = i / two_pd, cc = i - rr * two_pd;
    const int row = row0 + rr;
    rows_s[rr * stride + cc] =
        (rr < tile_rows && row < n) ? x[(size_t)row * two_pd + cc] : 0.f;
  }

  float* my = rows_s + warp * RPW * stride;  // this warp's rows

  // 1. forward transform of each pilot segment, in place
  for (int p = 0; p < p_pil; ++p) {
    float u[RPW][CD * 2];
    float* seg = my + p * two_d;
    tile_gemm<RPW, CD, 2>(seg, stride, two_d, bfwd, two_d, ring, lane, u);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = lane + 32 * j;
        if (c < d)
          *reinterpret_cast<float2*>(seg + i * stride + 2 * c) =
              make_float2(u[i][2 * j], u[i][2 * j + 1]);
      }
  }

  // 2. logits of the components k = lane + 32 j, one feature group a
  // product, the groups added in a compensated sum
  float lg[RPW][CK], lost[RPW][CK];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) lg[i][j] = lost[i][j] = 0.f;
  const float* lrow = lcoef;
  float part[RPW][CK];
  for (int p = 0; p < p_pil; ++p) {  // u_p
    tile_gemm<RPW, CK, 1>(my + p * two_d, stride, two_d, lrow, k_comp, ring,
                          lane, part);
    kahan_add<RPW, CK>(lg, lost, part);
    lrow += (size_t)two_d * k_comp;
  }
  for (int p = 0; p < p_pil; ++p) {  // |u_p|^2
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = lane + 32 * j;
        if (c < d) {
          const float2 a = *reinterpret_cast<const float2*>(
              my + i * stride + p * two_d + 2 * c);
          my[i * stride + g_off + c] = fmaf(a.x, a.x, a.y * a.y);
        }
      }
    tile_gemm<RPW, CK, 1>(my + g_off, stride, d, lrow, k_comp, ring, lane,
                          part);
    kahan_add<RPW, CK>(lg, lost, part);
    lrow += (size_t)d * k_comp;
  }
  for (int p = 0; p < p_pil; ++p)
    for (int q = p + 1; q < p_pil; ++q) {  // conj(u_p) u_q
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          const int c = lane + 32 * j;
          if (c < d) {
            const float2 a = *reinterpret_cast<const float2*>(
                my + i * stride + p * two_d + 2 * c);
            const float2 b = *reinterpret_cast<const float2*>(
                my + i * stride + q * two_d + 2 * c);
            *reinterpret_cast<float2*>(my + i * stride + g_off + 2 * c) =
                make_float2(fmaf(a.x, b.x, a.y * b.y),
                            fmaf(a.x, b.y, -a.y * b.x));
          }
        }
      tile_gemm<RPW, CK, 1>(my + g_off, stride, two_d, lrow, k_comp, ring,
                            lane, part);
      kahan_add<RPW, CK>(lg, lost, part);
      lrow += (size_t)two_d * k_comp;
    }
#pragma unroll
  for (int j = 0; j < CK; ++j) {
    const int k = lane + 32 * j;
    const float ck = k < k_comp ? __ldg(cst + k) : 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      lg[i][j] = k < k_comp ? lg[i][j] + ck : -INFINITY;
  }

  // 3. coherent form: pool over each block's rows through the w slots
  if constexpr (COH)
    pool_over_blocks<RPW, CK>(lg, rows_s, stride, w_off, warp, lane,
                              tile_rows, t_coh, k_comp, alpha);

  {
    float mx[RPW], den[RPW];
    softmax_rows<RPW, CK, true>(lg, my, stride, w_off, k_comp, lane, mx, den);
  }

  // 4. combine: h = w @ bias + sum_p (w @ filt_p) * u_p, into the group slots
  {
    float h[RPW][CD * 2];
    tile_gemm<RPW, CD, 2>(my + w_off, stride, k_comp, comb, two_d, ring, lane,
                          h);
    for (int p = 0; p < p_pil; ++p) {
      float f[RPW][CD * 2];
      tile_gemm<RPW, CD, 2>(my + w_off, stride, k_comp,
                            comb + (size_t)(p + 1) * k_comp * two_d, two_d,
                            ring, lane, f);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          const int c = lane + 32 * j;
          if (c < d) {
            const float2 u = *reinterpret_cast<const float2*>(
                my + i * stride + p * two_d + 2 * c);
            const float fr = f[i][2 * j], fi = f[i][2 * j + 1];
            h[i][2 * j] = fmaf(-fi, u.y, fmaf(fr, u.x, h[i][2 * j]));
            h[i][2 * j + 1] = fmaf(fi, u.x, fmaf(fr, u.y, h[i][2 * j + 1]));
          }
        }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = lane + 32 * j;
        if (c < d)
          *reinterpret_cast<float2*>(my + i * stride + g_off + 2 * c) =
              make_float2(h[i][2 * j], h[i][2 * j + 1]);
      }
  }

  // 5. inverse transform
  float o[RPW][CD * 2];
  tile_gemm<RPW, CD, 2>(my + g_off, stride, two_d, binv, two_d, ring, lane,
                        o);
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

// Floats of one row in shared memory: [u (2PD) | group (2D) | w (K)],
// rounded up to whole float4s (mp_circ_kernels.mp_circ_smem_bytes mirrors
// it).
inline int row_stride(int d, int p_pil, int k_comp) {
  return (2 * p_pil * d + 2 * d + k_comp + 3) & ~3;
}

template <int CD, int CK, int RPW, bool COH>
int launch(const float* x, const float* bfwd, const float* lcoef,
           const float* cst, const float* comb, const float* binv,
           float* out, int n, int d, int p_pil, int k_comp, int t_coh,
           float alpha, cudaStream_t stream) {
  constexpr int kTileN = kWarps * RPW;
  if (COH && t_coh > kTileN) return (int)cudaErrorInvalidValue;
  const int stride = row_stride(d, p_pil, k_comp);
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * stride + 2 * (size_t)kStage);
  auto kern = mp_circ_estimate_kernel<CD, CK, RPW, COH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int grid = (n + tile_rows - 1) / tile_rows;
  kern<<<grid, kThreads, smem, stream>>>(x, bfwd, lcoef, cst, comb, binv, out,
                                         n, d, p_pil, k_comp, stride, t_coh,
                                         alpha);
  return (int)cudaGetLastError();
}

// The instantiation for the widths, as K6-K9: bins a lane CD = 1, 2, 4 for
// D <= 32, 64, 128; components a lane CK likewise for K; RPW = 8 rows a warp
// up to D = 64, else 4 (circ_kernels.circ_tile_rows mirrors it).
template <bool COH>
int dispatch(const float* x, const float* bfwd, const float* lcoef,
             const float* cst, const float* comb, const float* binv,
             float* out, int n, int d, int p_pil, int k_comp, int t_coh,
             float alpha, cudaStream_t s) {
  const int cd = d <= 32 ? 1 : d <= 64 ? 2 : 4;
  const int ck = k_comp <= 32 ? 1 : k_comp <= 64 ? 2 : 4;
#define QCE_LAUNCH(CD_, CK_, RPW_)                                         \
  if (cd == CD_ && ck == CK_)                                              \
    return launch<CD_, CK_, RPW_, COH>(x, bfwd, lcoef, cst, comb, binv,    \
                                       out, n, d, p_pil, k_comp, t_coh,    \
                                       alpha, s);
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
// x (n, 2 p d) and out (n, 2 d) hold complex values as interleaved [re, im]
// pairs, x pilot-major. lcoef is (d (3p + p (p-1)), k_comp), comb
// (p + 1, k_comp, 2 d). t_coh > 1 selects the coherent form (n a whole
// number of t_coh row blocks).
extern "C" int mp_circ_estimate_launch(const float* x, const float* bfwd,
                                       const float* lcoef, const float* cst,
                                       const float* comb, const float* binv,
                                       float* out, int n, int d, int p_pil,
                                       int k_comp, int t_coh, float alpha,
                                       void* stream) {
  if (n < 0 || d < 1 || d > 128 || p_pil < 1 || k_comp < 1 || k_comp > 128 ||
      t_coh < 1 || n % t_coh != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_coh > 1)
    return dispatch<true>(x, bfwd, lcoef, cst, comb, binv, out, n, d, p_pil,
                          k_comp, t_coh, alpha, s);
  return dispatch<false>(x, bfwd, lcoef, cst, comb, binv, out, n, d, p_pil,
                         k_comp, 1, 1.f, s);
}
