// The wide form of the circulant (FFT-domain) estimation kernels for
// Hopper: K6 (flat), K7 (coherent), K8 (stats) and K9 (coherent stats) at
// every width past the one-pilot template of mp_circ_estimate.cu (D > 128),
// up to D = 672 (the wrappers take it where the transform does not split
// into factors of at most 64; elsewhere the factorised kernel of
// circ_fact_estimate.cu serves all four); and of the multi-pilot kernel K10
// (flat and coherent) at every shape past that template's rule (D or K >
// 128, a P whose u does not fit a block's shared memory, a T past its live
// rows), any K.
//
// Replaces, at those widths, the TPU kernels of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py that the
// JAX package runs there whenever the bank's constants fit its 13 MiB
// budget (D <= 652 at K = 1, 625 at K = 64; models/structured_bank.py:415,
// :604): `_circ_kernel` (:1309, pallas_call in `estimate_circ_packed`
// :1346), `_circ_kernel_coh` (:1647, :1698), `_circ_kernel_stats` (:1749,
// :1789) and `_circ_kernel_coh_stats` (:1822, :1868). The function is that
// of mp_circ_estimate.cu at one pilot. Per row x (2D interleaved [re, im]
// pairs) and component k:
//
//   u      = x @ bfwd                      forward (block-)DFT, (2D, 2D)
//   lg_k   = [u | |u|^2] @ lcoef + const   (3D, K)
//   w_k    = softmax_k(lg'_k)              K7 / K9: lg' = lg + a (s - lg),
//                                          s the sum over the row's block
//   h      = w @ bias + (w @ filt) * u     per bin, complex; (K, 4D)
//   out    = h @ binv                      inverse (block-)DFT, (2D, 2D)
//
// K8 / K9 stop before the normalisation and the inverse: m = max_k lg'
// (with the row's offset back in, below), den = sum_k exp(lg' - m) and the
// un-normalised h, so that component shards merge exactly.
//
// Why a design of its own: the narrow template keeps a warpgroup's u in
// shared memory and its A operands in registers. At D = 512, u for 64 rows
// is 2D x 64 x 4 B = 256 KB, past the 227 KB a block has, and a thread's
// A fragments of one 2D-deep contraction would be 48 registers a chunk.
//
// Design: one launch of nine kernels on the stream, every product on one
// template (wide_gemm.cuh) of 128-row blocks on the wide K1's chunk
// ring (wide_ring.cuh: two consumer warpgroups of 64 rows, one producer
// warpgroup that streams, for each 64-deep chunk of the contraction, both
// warpgroups' A chunk and the same chunk of two 64-column pieces of the
// bank operand, three bf16 planes each, 96 KB a stage, two stages, with
// cp.async.bulk). A chunk is 6 x 4 wgmma m64n64k16 (the six bf16 products
// of three-plane splits, smallest first, hi.hi last) into a fresh fp32
// accumulator; the chunks of an output piece are added in a compensated
// (Kahan) sum. One accumulator over the 512- to 2048-deep contractions of
// the wide K1 (grouped_wide_estimate.cu) read up to 2.6x the plain float32
// version's error against float64; fresh accumulators per chunk
// 0.6-1.1x. The intermediates live in global scratch between the passes:
//   1. the row split (`split_tiles` of `CircRows`) writes x's three planes
//      as 64-row tiles of 64-deep chunks (8 KB runs, K-major, 128-byte
//      swizzle: the wide K1's layout, `kernels.wide_row_planes`);
//   2. the forward product writes u (N, 2D) fp32;
//   3. the split forms the features [u | |u|^2] a chunk at a time;
//   4. the logit product: each k16 step's six products into a fresh
//      accumulator, added with const in a compensated sum whose error is
//      folded in after the row's offset (its largest logit of the first 64
//      components) is taken off, lg' = (lg - off) - lost, as the narrow
//      template does (the expanded quadratic cancels; an accumulator over a
//      whole chunk left a near-tie of two components to fp32's rounding of
//      a logit in the thousands). It writes lg' (N, K) and off (N);
//   5. `softmax_kernel`, a warp a coherence block, pools each component's
//      logits over the block (sums in float64), takes the softmax and
//      writes the weights over lg' (normalised for K6 / K7; for K8 / K9
//      exp(l - max l) with m = fl(o + max l), o the pooled offset, and den);
//   6. the split lays the weights out as A;
//   7. the combine: pieces (bias j, filter j) of one column slice in one
//      block, h = c_bias + c_filt * u per bin in the epilogue, written to
//      out;
//   8, 9. (K6 / K7) the split of h and the inverse product into out.
// Everything outside the products is fp32 (the pool's sums float64). TF32
// stays excluded. Dead components keep the finite -1e30 floor of const.
// The blocks run slice-fastest (blockIdx.x the column slice): the slices
// of one row pair run together and share its A chunks in L2, and a whole
// (2D, 2D) operand (6.5 MB of planes at D = 512) stays in L2.
//
// Bound on an H100 (D = 512, K = 16, N = 32768; `circ_kernels.circ_bound`):
// the function needs its transforms only as FFTs (5 D log2 D fp32
// operations a row each, 1.5e9), and the logit and combine as six bf16
// products of 2 N (3D K + K 4D) (2.25e10, 0.023 ms at 989 TFLOP/s), against
// the rows read and written once (0.27 GB, 0.080 ms at 3.35 TB/s): bound
// by bytes, 0.080 ms (K8 / K9 the same). This kernel's dense transforms
// take 6 x 2 N (2D 2D + 2D 2D) = 8.25e11 more operations (0.857 ms with
// the rest; K8 / K9 0.44 ms), and the scratch passes move ~40 N D bytes
// more (0.67 GB at D = 512, 0.2 ms): a factorised transform is the way
// toward the function's bound.
// Any N (a whole number of T-row blocks), 1 <= D <= 672, 1 <= K <= 128,
// 1 <= T <= 64, with up to 65535 pairs of 64-row tiles a launch (the
// wrapper cuts rows to its scratch budget first).
//
// K10 (`mp_circ_wide_launch`) replaces, at those shapes, the TPU kernel
// `_mp_circ_kernel` (pallas_kernels.py:1505, pallas_call in
// `estimate_mp_circ_packed` :1578), which the JAX package runs on every
// 'all'-mode multi-pilot bank whose constants and a 64-row tile (8 T rows
// coherent) fit 11 MiB (models/structured_bank.py:829, :896). The same
// passes at P pilots:
//   - the forward product takes the observation (N, P 2D) as N P rows of
//     2D through the one (2D, 2D) operand: u (N, P, 2D);
//   - the split forms the features [u_1..u_P | |u_p|^2 | v_pq =
//     conj(u_p) u_q, p < q] (F = D (3P + P (P - 1)) columns, the rows of
//     `MpCircKernelBank.lcoef`) a 64-deep chunk at a time;
//   - the logit product runs over K in column slices of two pieces; the
//     first slice takes the rows' offsets, a second launch gives the other
//     slices those offsets (K > 128);
//   - the softmax: `softmax_kernel` up to K = 128, past it
//     `softmax_any_kernel`, which walks the row in global memory;
//   - the combine: one block a 64-column slice of 2D runs its P + 1
//     pieces (bias, filter_1 .. filter_P) two at a time, h = c_bias +
//     sum_p c_filt_p u_p per bin, pilot by pilot, in the epilogue;
//   - the inverse product.
// Any N, 1 <= D <= 672, any K and P >= 1 whose rows fit the scratch,
// 1 <= T <= 64.
#include "wide_gemm.cuh"

namespace {

using namespace qce_tc;
using namespace qce_wide;

constexpr int kMaxD = 672;
constexpr int kMaxK = 128;  // components of K6-K9
constexpr int kMaxT = 64;

// The bank's units (64 columns x 64 deep, three planes) as
// `circ_kernels.circ_wide_operands` (P = 1) and
// `mp_circ_kernels.mp_circ_wide_operands` lay them out: the forward
// operand's NPD x NPD, the logit's KP x NF, the combine's NPD x (P + 1) x
// KP and, except for the stats forms, the inverse's NPD x NPD.
long long wide_units(int d, int k, int p, bool stats) {
  const long long npd = chunks_of(2 * d), kp = chunks_of(k);
  const long long nf = (feat_width(d, p) + 63) / 64;
  return npd * npd + kp * nf + npd * (p + 1) * kp + (stats ? 0 : npd * npd);
}

// The wide form's passes on n rows of p pilots (K6-K9: p = 1) with the
// bank's units `planes`; the caller has validated the arguments.
int run_wide(const float* x, const bf16* const (&planes)[3], const float* cst,
             float* out, float* m_out, float* den_out, void* a, float* u,
             float* lg, float* offs, int n, int d, int p, int k_comp,
             int t_coh, float alpha, int stats, cudaStream_t st) {
  const int two_d = 2 * d, npd = chunks_of(two_d), kp = chunks_of(k_comp);
  const int fw = (int)feat_width(d, p), nf = chunks_of(fw);
  const int tiles = row_tiles(n), tiles_x = row_tiles(n * p);
  const auto at = [&](int unit, int rows, int tl, int n_ch, int n_pieces,
                      int slice_pieces, float* dst, int width) {
    Gemm g{static_cast<const uint4*>(a),
           (size_t)tl * n_ch * 512,
           {planes[0] + (size_t)unit * 4096, planes[1] + (size_t)unit * 4096,
            planes[2] + (size_t)unit * 4096},
           n_ch,
           n_pieces,
           rows,
           0,
           slice_pieces,
           dst,
           width,
           cst,
           offs,
           u};
    return g;
  };
  const int u_fwd = 0, u_lg = npd * npd, u_comb = u_lg + kp * nf;
  const int u_inv = u_comb + npd * (p + 1) * kp;
  int err;
  // forward: u = x bfwd, every pilot's rows through the one operand
  if ((err = split_tiles(PlainRows{x, n * p, two_d}, a, npd, tiles_x, st)))
    return err;
  if ((err = gemm<kStore>(at(u_fwd, n * p, tiles_x, npd, npd, kGroup, u,
                             two_d),
                          (npd + kGroup - 1) / kGroup, tiles_x, st)))
    return err;
  // logits of the features, the first slice's offsets before the others
  if ((err = split_tiles(FeatRows{u, n, fw, two_d, p}, a, nf, tiles, st)))
    return err;
  Gemm gl = at(u_lg, n, tiles, nf, kp, kGroup, lg, k_comp);
  if ((err = gemm<kLogit>(gl, 1, tiles, st))) return err;
  const int lg_slices = (kp + kGroup - 1) / kGroup;
  if (lg_slices > 1) {
    gl.slice0 = 1;
    if ((err = gemm<kLogit>(gl, lg_slices - 1, tiles, st))) return err;
  }
  // the softmax weights in the logits' place
  if ((err = softmax(lg, offs, m_out, den_out, n, k_comp, t_coh, alpha,
                     stats, st)))
    return err;
  // combine: h = w bias + sum_p (w filt_p) u_p into out
  if ((err = split_tiles(PlainRows{lg, n, k_comp}, a, kp, tiles, st)))
    return err;
  if ((err = gemm<kComb>(at(u_comb, n, tiles, kp, npd * (p + 1), p + 1, out,
                            two_d),
                         npd, tiles, st)))
    return err;
  if (stats) return 0;
  // inverse: out = h binv
  if ((err = split_tiles(PlainRows{out, n, two_d}, a, npd, tiles, st)))
    return err;
  return gemm<kStore>(at(u_inv, n, tiles, npd, npd, kGroup, out, two_d),
                      (npd + kGroup - 1) / kGroup, tiles, st);
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K6 (t_coh = 1), K7 (t_coh > 1) and, with stats != 0, K8 / K9 at any
// 1 <= d <= 672: x (n, 2d) and out (n, 2d) interleaved [re, im] pairs
// (STATS: out the DFT-domain accumulator, m_out, den_out (n)); hi, lo, lo2
// the bank's `units` units (`circ_kernels.circ_wide_operands`, 16-byte
// aligned); cst (k_comp) the layout's constants; scratch: a (3, tiles,
// ceil(max(3d, k_comp) / 64), 64, 64) bf16 with tiles =
// `kernels.wide_row_tiles(n)`, u (n, 2d), lg (n, k_comp) and offs (n)
// fp32. n a whole number of t_coh-row
// blocks, 1 <= t_coh <= 64, 1 <= k_comp <= 128.
extern "C" int circ_wide_launch(const float* x, const void* hi,
                                const void* lo, const void* lo2,
                                const float* cst, float* out, float* m_out,
                                float* den_out, void* a, float* u, float* lg,
                                float* offs, int n, int d, int k_comp,
                                int units, int t_coh, float alpha, int stats,
                                void* stream) {
  if (n < 0 || d < 1 || d > kMaxD || k_comp < 1 || k_comp > kMaxK ||
      t_coh < 1 || t_coh > kMaxT || n % t_coh != 0 ||
      (stats && (m_out == nullptr || den_out == nullptr)) ||
      units != wide_units(d, k_comp, 1, stats != 0))
    return (int)cudaErrorInvalidValue;
  if (int err = check_pointers(hi, lo, lo2, x, out, a, u)) return err;
  if (n == 0) return 0;
  if (row_tiles(n) / kWgs > 65535) return (int)cudaErrorInvalidValue;
  const bf16* planes[3] = {static_cast<const bf16*>(hi),
                           static_cast<const bf16*>(lo),
                           static_cast<const bf16*>(lo2)};
  return run_wide(x, planes, cst, out, m_out, den_out, a, u, lg, offs, n, d,
                  1, k_comp, t_coh, alpha, stats,
                  static_cast<cudaStream_t>(stream));
}

// C entry point of the wide K10 (flat at t_coh = 1, coherent above) at any
// 1 <= d <= 672, p >= 1 pilots and k_comp >= 1 components: x (n, 2 p d)
// interleaved [re, im] pairs, pilot-major; out (n, 2d); hi, lo, lo2 the
// bank's `units` units (`mp_circ_kernels.mp_circ_wide_operands`); cst
// (k_comp) the layout's constants; scratch: a bf16 of 3 x 4096 x
// max(tiles(n p) ceil(2d / 64), tiles(n) ceil(max(F, k_comp) / 64)) values
// with tiles(m) = `kernels.wide_row_tiles(m)`, F = d (3p + p (p - 1)), u
// (n, p, 2d), lg (n, k_comp) and offs (n) fp32. n a whole number of
// t_coh-row blocks, 1 <= t_coh <= 64.
extern "C" int mp_circ_wide_launch(const float* x, const void* hi,
                                   const void* lo, const void* lo2,
                                   const float* cst, float* out, void* a,
                                   float* u, float* lg, float* offs, int n,
                                   int d, int p, int k_comp, int units,
                                   int t_coh, float alpha, void* stream) {
  if (n < 0 || d < 1 || d > kMaxD || p < 1 || k_comp < 1 || t_coh < 1 ||
      t_coh > kMaxT || n % t_coh != 0 || feat_width(d, p) >= (1LL << 30) ||
      (long long)n * p >= (1LL << 31) ||
      units != wide_units(d, k_comp, p, false))
    return (int)cudaErrorInvalidValue;
  if (int err = check_pointers(hi, lo, lo2, x, out, a, u)) return err;
  if (n == 0) return 0;
  if (row_tiles(n * p) / kWgs > 65535) return (int)cudaErrorInvalidValue;
  const bf16* planes[3] = {static_cast<const bf16*>(hi),
                           static_cast<const bf16*>(lo),
                           static_cast<const bf16*>(lo2)};
  return run_wide(x, planes, cst, out, nullptr, nullptr, a, u, lg, offs, n,
                  d, p, k_comp, t_coh, alpha, 0,
                  static_cast<cudaStream_t>(stream));
}

// u (n, p, two_d) fp32 -> its logit features [u | |u_p|^2 | v_pq] (n, F)
// as the logit product reads them: a (3, tiles, ceil(F / 64), 64, 64)
// bf16, tiles = `kernels.wide_row_tiles(n)` (`circ_kernels.circ_wide_rows(u,
// True)` at p = 1 and `mp_circ_kernels.mp_circ_wide_rows(u, p)` are the
// plain versions; the rows' own split is grouped_wide_estimate.cu's).
extern "C" int circ_wide_features_launch(const float* u, void* a, int n,
                                         int two_d, int p, void* stream) {
  if (n < 1 || two_d < 2 || two_d % 2 != 0 || two_d > 2 * kMaxD || p < 1 ||
      feat_width(two_d / 2, p) >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int fw = (int)feat_width(two_d / 2, p);
  return split_tiles(FeatRows{u, n, fw, two_d, p}, a, chunks_of(fw),
                     row_tiles(n), static_cast<cudaStream_t>(stream));
}
