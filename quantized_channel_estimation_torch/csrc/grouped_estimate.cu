// Grouped online-softmax GMM-Bussgang estimator for Hopper: kernel K1, its
// coherent (block-pooled) mode K3, and their split-K stats form K2 (flat
// and coherent), one stream for all.
//
// Replaces the TPU kernel `_grouped_stream` (:327) +
// `_estimate_kernel_block_grouped` (:419) launched by
// `estimate_packed_block_grouped` (quantized_channel_estimation_tpu/
// estimators/pallas_kernels.py :476, pallas_call :536) flat (K1) and with
// `t_coh > 1`, `coh_alpha` (K3, entry `estimate_fused_coherent` :1151), and
// `_estimate_kernel_block_grouped_stats` (:454) launched by
// `estimate_packed_block_grouped_stats` (:857; K2, flat and coherent). The
// JAX 'f32' mode runs float32 operands through multi-pass bf16 products on
// the TPU's matrix unit; its 'split3' / 'split2' / 'bf16' modes (:440,
// :430) are K14b (grouped_tc_estimate.cu).
//
// The stream is csrc/grouped_tc_stream.cuh (the function, the six-product
// bf16 split that keeps fp32 accuracy, the bound, the design), with
// PASSES = 6: each 64-column piece of yz_k = r2 [P_k | W_k] is six exact
// bf16 products of three-plane splits of r2 and the bank, accumulated in
// fp32 on wgmma; everything after the products is fp32. Bound on an H100
// (131072 rows, M = D = K = 64): 3.34 ms of bf16 tensor-core operations
// plus 0.06 ms of fp32 epilogue (K3: + 3 N K fp32), against 8.21 ms for the
// same products as fp32 FMAs. K3 pools T consecutive rows (quad shuffles
// for T = 2, 4, 8, 16; shared memory for any other T up to 64), K2 writes
// the running max m, denominator den and un-normalised accumulator acc of
// each row so that component shards merge exactly.
// Any N and K, 2M and 2D up to 256; K3 any 2 <= T <= 64.
#include "grouped_tc_stream.cuh"

namespace {

using namespace qce_tc;

Args make_args(const float* r2, const void* hi, const void* lo,
               const void* lo2, const float* vec, const float* logw,
               float* out, float* m_out, float* den_out, int n, int k_comp,
               int two_m, int two_d, int t_coh, float alpha, void* stream) {
  return Args{r2,
              {static_cast<const bf16*>(hi), static_cast<const bf16*>(lo),
               static_cast<const bf16*>(lo2)},
              vec,
              logw,
              out,
              m_out,
              den_out,
              n,
              k_comp,
              two_m,
              two_d,
              t_coh,
              alpha,
              nullptr,
              0,
              static_cast<cudaStream_t>(stream)};
}

template <bool COH, bool STATS>
int run(const Args& g) {
  if (int err = check_args(g, 6, 256)) return err;
  if (COH && (g.t_coh < 2 || g.t_coh > 64 || g.n % g.t_coh != 0))
    return (int)cudaErrorInvalidValue;
  if (g.n == 0) return 0;
  return dispatch<6, COH, STATS, kFull, true>(g);
}

}  // namespace

// C entry points, loaded with ctypes. Each returns a cudaError_t (0 on
// success). slab_hi, slab_lo, slab_lo2: the bank's three bf16 planes in the
// B layout (`tc_slab`, 16-byte aligned); vec: mu and b by piece
// (`tc_vectors`); logw (k_comp).

// K1: r2 (n, two_m) -> out (n, two_d).
extern "C" int grouped_estimate_launch(const float* r2, const void* slab_hi,
                                       const void* slab_lo,
                                       const void* slab_lo2, const float* vec,
                                       const float* logw, float* out, int n,
                                       int k_comp, int two_m, int two_d,
                                       void* stream) {
  return run<false, false>(make_args(r2, slab_hi, slab_lo, slab_lo2, vec,
                                     logw, out, nullptr, nullptr, n, k_comp,
                                     two_m, two_d, 1, 1.f, stream));
}

// K3: r2 (n, two_m) holds n / t_coh blocks of t_coh consecutive rows;
// 2 <= t_coh <= 64.
extern "C" int grouped_estimate_coherent_launch(
    const float* r2, const void* slab_hi, const void* slab_lo,
    const void* slab_lo2, const float* vec, const float* logw, float* out,
    int n, int k_comp, int two_m, int two_d, int t_coh, float coh_alpha,
    void* stream) {
  return run<true, false>(make_args(r2, slab_hi, slab_lo, slab_lo2, vec, logw,
                                    out, nullptr, nullptr, n, k_comp, two_m,
                                    two_d, t_coh, coh_alpha, stream));
}

// K2: r2 (n, two_m) -> the K1 state m (n), den (n), acc (n, two_d).
extern "C" int grouped_estimate_stats_launch(
    const float* r2, const void* slab_hi, const void* slab_lo,
    const void* slab_lo2, const float* vec, const float* logw, float* acc,
    float* m, float* den, int n, int k_comp, int two_m, int two_d,
    void* stream) {
  return run<false, true>(make_args(r2, slab_hi, slab_lo, slab_lo2, vec, logw,
                                    acc, m, den, n, k_comp, two_m, two_d, 1,
                                    1.f, stream));
}

// K2, coherent: the K3 state per row of n / t_coh blocks of t_coh rows.
extern "C" int grouped_estimate_coherent_stats_launch(
    const float* r2, const void* slab_hi, const void* slab_lo,
    const void* slab_lo2, const float* vec, const float* logw, float* acc,
    float* m, float* den, int n, int k_comp, int two_m, int two_d, int t_coh,
    float coh_alpha, void* stream) {
  return run<true, true>(make_args(r2, slab_hi, slab_lo, slab_lo2, vec, logw,
                                   acc, m, den, n, k_comp, two_m, two_d, t_coh,
                                   coh_alpha, stream));
}
