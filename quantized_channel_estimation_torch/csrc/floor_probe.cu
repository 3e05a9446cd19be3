// The K1 floor probe for Hopper: kernel K15, seven stripped bodies of K1.
//
// Replaces the TPU probe `run_variant` of tools/kernel_floor_probe.py
// (:203, pallas_call :213) with its bodies `BODIES` (:191): full,
// gemm_only, logits_only, combine_only, square_only, quad_only and
// full_fixedmax. They attribute K1's time to the products, the logits, the
// softmax and the combine.
//
// Design: every variant is an instantiation of K1's own stream
// (grouped_tc_stream.cuh, its VARIANT parameter: an epilogue switch), with
// K1's six bf16 products, block shape, row tiles and ring, so the probe
// measures K1's code and cannot drift from it: `full` is K1 bit for bit.
// Each stripped variant still issues every product: ptxas removes a wgmma
// whose results nobody reads, so each accumulator its body does not read
// is folded into a value stored only under a runtime flag that the wrapper
// passes as 0. square_only spills 12 bytes at 2M = 2D = 128 with two
// consumer warpgroups, with this sink or without it; its time in the
// probe's table carries that spill.
//
// Bound on an H100: every variant does at least K1's products, 6 x 2 N 2M
// (2M+2D) K bf16 tensor-core operations (3.34 ms for 131072 rows at M = D
// = K = 64 at 989 TFLOP/s). Widths: 2M, 2D <= 128 (K1's main-path
// instantiations); square_only needs 2D <= 2M. Any N and K.
#include "grouped_tc_stream.cuh"

namespace {

using namespace qce_tc;

template <int VARIANT>
int run(const Args& g) {
  return dispatch<6, false, false, VARIANT, false>(g);
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K15: variant (0..6, the ProbeVariant order) of r2 (n, two_m) -> out (n,
// two_d), the bank as K1 takes it; sink, of grid x block threads floats,
// is written only when store_sink != 0.
extern "C" int floor_probe_launch(const float* r2, const void* slab_hi,
                                  const void* slab_lo, const void* slab_lo2,
                                  const float* vec, const float* logw,
                                  float* out, int n, int k_comp, int two_m,
                                  int two_d, int variant, float* sink,
                                  int store_sink, void* stream) {
  const Args g{r2,
               {static_cast<const bf16*>(slab_hi),
                static_cast<const bf16*>(slab_lo),
                static_cast<const bf16*>(slab_lo2)},
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
               sink,
               store_sink,
               static_cast<cudaStream_t>(stream)};
  if (int err = check_args(g, 6, 128)) return err;
  if (variant == kSquareOnly && two_d > two_m)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  switch (variant) {
    case kFull:
      return run<kFull>(g);
    case kGemmOnly:
      return run<kGemmOnly>(g);
    case kLogitsOnly:
      return run<kLogitsOnly>(g);
    case kCombineOnly:
      return run<kCombineOnly>(g);
    case kSquareOnly:
      return run<kSquareOnly>(g);
    case kQuadOnly:
      return run<kQuadOnly>(g);
    case kFullFixedmax:
      return run<kFullFixedmax>(g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
