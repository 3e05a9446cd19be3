// The K1 floor probe for Hopper: kernel K15, seven stripped bodies of K1.
//
// Replaces the TPU probe `run_variant` of tools/kernel_floor_probe.py
// (:203, pallas_call :213) with its bodies `BODIES` (:191): full,
// gemm_only, logits_only, combine_only, square_only, quad_only and
// full_fixedmax. They attribute K1's time to the GEMM, the logits, the
// softmax and the combine.
//
// Design: every variant is an instantiation of K1's own stream
// (grouped_stream.cuh, the VARIANT parameter), with K1's block shape, row
// tiles and cp.async ring, so the probe measures K1's code and cannot drift
// from it: `full` is K1 bit for bit. Each stripped variant still runs the
// whole (2M+2D)-wide GEMM: the accumulators it does not read are folded
// into a value stored only under a runtime flag that the wrapper passes as
// 0 (see grouped_stream.cuh), so nvcc keeps their FMAs.
//
// Bound on an H100: every variant does at least K1's GEMM, 2 N 2M (2M+2D) K
// fp32 operations (5.5e11 for 131072 rows at M = D = K = 64, 8.2 ms at the
// 67 TFLOP/s fp32 peak); a variant that ran faster than that would have
// lost GEMM work. Widths: 2M, 2D <= 128 (8 warps of 8 rows, K1's headline
// instantiations); square_only needs 2D <= 2M. Any N and K.
#include "grouped_stream.cuh"

namespace {

using namespace qce;

constexpr int kRpw = 8;

template <int CP, int CW, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    floor_probe_kernel(const float* __restrict__ r2,
                       const float* __restrict__ pw,
                       const float* __restrict__ mu,
                       const float* __restrict__ b,
                       const float* __restrict__ logw,
                       float* __restrict__ out, int n, int k_comp, int two_m,
                       int two_d, int vec, float* __restrict__ sink,
                       int store_sink) {
  grouped_stream<CP, CW, kRpw, false, false, VARIANT>(
      r2, pw, mu, b, logw, out, nullptr, nullptr, n, k_comp, two_m, two_d,
      vec, 1, 1.f, sink, store_sink);
}

template <int CP, int CW, int VARIANT>
int launch(const float* r2, const float* pw, const float* mu, const float* b,
           const float* logw, float* out, int n, int k_comp, int two_m,
           int two_d, float* sink, int store_sink, cudaStream_t stream) {
  constexpr int kTileN = kWarps * kRpw;
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * r_stride + 2 * (size_t)kKc * s_cols);
  const int vec = (s_cols % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(pw) % 16 == 0);
  auto kern = floor_probe_kernel<CP, CW, VARIANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kTileN - 1) / kTileN;
  kern<<<grid, kThreads, smem, stream>>>(r2, pw, mu, b, logw, out, n, k_comp,
                                         two_m, two_d, vec, sink, store_sink);
  return (int)cudaGetLastError();
}

template <int VARIANT>
int dispatch(const float* r2, const float* pw, const float* mu,
             const float* b, const float* logw, float* out, int n, int k_comp,
             int two_m, int two_d, float* sink, int store_sink,
             cudaStream_t s) {
  const int cp = cols_per_lane(two_m), cw = cols_per_lane(two_d);
#define QCE_LAUNCH(CP_, CW_)                                                \
  if (cp == CP_ && cw == CW_)                                               \
    return launch<CP_, CW_, VARIANT>(r2, pw, mu, b, logw, out, n, k_comp,   \
                                     two_m, two_d, sink, store_sink, s);
  QCE_LAUNCH(2, 2)
  QCE_LAUNCH(2, 4)
  QCE_LAUNCH(4, 2)
  QCE_LAUNCH(4, 4)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K15: variant (0..6, the ProbeVariant order) of r2 (n, two_m) -> out (n,
// two_d); sink, of grid * 256 floats, is written only when store_sink != 0.
extern "C" int floor_probe_launch(const float* r2, const float* pw,
                                  const float* mu, const float* b,
                                  const float* logw, float* out, int n,
                                  int k_comp, int two_m, int two_d,
                                  int variant, float* sink, int store_sink,
                                  void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 128 || two_d < 1 ||
      two_d > 128 || (variant == kSquareOnly && two_d > two_m))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull:
      return dispatch<kFull>(r2, pw, mu, b, logw, out, n, k_comp, two_m,
                             two_d, sink, store_sink, s);
    case kGemmOnly:
      return dispatch<kGemmOnly>(r2, pw, mu, b, logw, out, n, k_comp, two_m,
                                 two_d, sink, store_sink, s);
    case kLogitsOnly:
      return dispatch<kLogitsOnly>(r2, pw, mu, b, logw, out, n, k_comp,
                                   two_m, two_d, sink, store_sink, s);
    case kCombineOnly:
      return dispatch<kCombineOnly>(r2, pw, mu, b, logw, out, n, k_comp,
                                    two_m, two_d, sink, store_sink, s);
    case kSquareOnly:
      return dispatch<kSquareOnly>(r2, pw, mu, b, logw, out, n, k_comp,
                                   two_m, two_d, sink, store_sink, s);
    case kQuadOnly:
      return dispatch<kQuadOnly>(r2, pw, mu, b, logw, out, n, k_comp, two_m,
                                 two_d, sink, store_sink, s);
    case kFullFixedmax:
      return dispatch<kFullFixedmax>(r2, pw, mu, b, logw, out, n, k_comp,
                                     two_m, two_d, sink, store_sink, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
