// K1 with fewer bf16 tensor-core products, for Hopper: kernel K14b, the
// opt-in precision modes 'bf16', 'split2' and 'split3'.
//
// Replaces the TPU kernels `_estimate_kernel_block_grouped_bf16` and
// `_estimate_kernel_block_grouped_split` launched by
// `estimate_packed_block_grouped` with mode='bf16' / 'split3' / 'split2'
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:430, :440,
// dispatch :511-530, pallas_call :536). K1's estimate with yz_k = r2 pw_k
// formed from bf16 planes hi = bf16(x), lo = bf16(x - hi) of r2 and pw,
// each rounded to nearest even:
//
//   PASSES = 1 ('bf16'):   yz = r_hi pw_hi
//   PASSES = 2 ('split2'): yz = r_hi pw_hi + r_hi pw_lo
//   PASSES = 3 ('split3'): yz = r_hi pw_hi + r_hi pw_lo + r_lo pw_hi
//
// each product of two bf16 values exact in the fp32 accumulator; split3
// drops the r_lo pw_lo term, O(2^-16) of the product. mu, b, logw, the
// quadratic term, the softmax and the combine stay fp32.
//
// It is the stream of K1 (csrc/grouped_tc_stream.cuh: its design, bound and
// measurements) with one, two or three products in place of K1's six:
// PASSES 2 N 2M (2M+2D) K bf16 tensor-core operations (0.56, 1.11 and 1.67
// ms at 131072 rows, M = D = K = 64) plus 4.3e9 fp32 epilogue operations
// (0.06 ms). Measured (chip_smoke, H100 80GB HBM3 at 700 W; the ranges in
// PERF.md): bf16 1.24 ms, split2 1.69, split3 2.17 against the one-call
// bf16 GEMM yardsticks 1.75-1.86 / 3.42-3.65 / 5.13-5.38: each extra pass
// adds ~0.5 ms, less than a pass takes at the bf16 peak, so the later
// passes hide under the fp32 epilogue.
// Any N and K, 2M and 2D up to 256.
#include "grouped_tc_stream.cuh"

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K14b: r2 (n, two_m) fp32 -> out (n, two_d) fp32 through `passes` (1, 2
// or 3) bf16 tensor-core products; slab_hi, slab_lo: pw_hi, pw_lo in the
// kernel's B layout (`tc_slab`: (k_comp, mp + dp, Kp / 64, 64, 64) bf16,
// 16-byte aligned; slab_lo unread at passes = 1), vec: mu and b by piece
// (`tc_vectors`: (k_comp, mp + dp, 64) fp32), logw (k_comp) fp32.
extern "C" int grouped_tc_estimate_launch(const float* r2, const void* slab_hi,
                                          const void* slab_lo, const float* vec,
                                          const float* logw, float* out, int n,
                                          int k_comp, int two_m, int two_d,
                                          int passes, void* stream) {
  using namespace qce_tc;
  const bf16* hi = static_cast<const bf16*>(slab_hi);
  const Args g{r2,
               {hi, static_cast<const bf16*>(slab_lo), hi},
               vec,
               logw,
               out,
               nullptr,
               nullptr,
               n,
               k_comp,
               two_m,
               two_d,
               1,
               1.f,
               nullptr,
               0,
               static_cast<cudaStream_t>(stream)};
  if (passes < 1 || passes > 3) return (int)cudaErrorInvalidValue;
  if (int err = check_args(g, passes, 256)) return err;
  if (n == 0) return 0;
  switch (passes) {
    case 1:
      return dispatch<1, false, false, kFull, true>(g);
    case 2:
      return dispatch<2, false, false, kFull, true>(g);
    default:
      return dispatch<3, false, false, kFull, true>(g);
  }
}
