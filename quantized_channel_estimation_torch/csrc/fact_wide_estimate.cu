// The wide form of the factored (MFA, low-rank plus diagonal) estimation
// kernels for Hopper: K11 (flat), K12 (coherent) and K13 (stats) at every
// shape past the template of fact_estimate.cu (D > 128 or M > 64), any K.
//
// Replaces, at those shapes, the TPU kernels of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py that the
// JAX package runs wherever the bank and a 64-row tile (8 T rows coherent)
// fit its VMEM budget (`_fact_kernel_eligible` :1969: D to 10334 at K = M
// = 1, M to 2475 at D = 64, K to 39 at D = 256, M = 16): `_fact_kernel`
// (:2048, pallas_call in `estimate_fact_packed` :2091), `_fact_kernel_coh`
// (:2126, :2183) and `_fact_kernel_stats` (:2231, :2275), through
// models/mfa_bank.py's `estimate_factored` (:281), its coherent form (:344)
// and the mesh's K13 a shard (parallel/mesh.py:253-270). Per row x (2D
// interleaved [re, im] pairs) and component k, with the Woodbury factors of
// the bank:
//
//   [beta | gamma] = x @ fwd_k             (2D, 4M)
//   lg_k  = z . lcoef_k + |beta - T mu_k|^2 + const_k   z = [Re r | Im r |
//                                                            |r|^2]
//   w     = softmax_k(lg')                 K12: lg' = lg + a (s - lg), s
//                                          the sum over the row's block
//   h     = sum_k w_k ([beta | gamma] @ comb_k + bias_k + a1_k o x)
//
// K13 stops before the normalisation: m = max_k lg' (with the row's offset
// back in, below), den = sum_k exp(lg' - m) and the un-normalised h, so
// that component shards merge exactly.
//
// Why a design of its own: the template keeps a warpgroup's x planes and,
// past D, M <= 64 / 16, its [beta | gamma] planes in shared memory, with at
// most four 64-deep contraction chunks of 2D and of 4M. At D = 256, M = 64
// or D = 10334 neither fits a block's 227 KB.
//
// Design: one launch of eight kernels on the stream, the three products on
// the wide forms' template (wide_gemm.cuh: 128-row blocks on the chunk ring
// of wide_ring.cuh, two consumer warpgroups of 64 rows and one producer
// warpgroup streaming each 64-deep chunk of both warpgroups' rows and of
// two 64-column pieces of the bank operand, three bf16 planes each, with
// cp.async.bulk; a chunk is the six bf16 products of three-plane splits
// into a fresh fp32 accumulator, the chunks of an output piece added in a
// compensated sum: one accumulator over the wide K1's 512- to 2048-deep
// contractions read up to 2.6x the plain float32 version's error against
// float64, fresh ones a chunk 0.6-1.1x). The intermediates live in global
// scratch between the passes:
//   1. the row split writes x's three planes (64-row tiles of 64-deep
//      chunks, the wide K1's layout, `kernels.wide_row_planes`);
//   2. the forward product writes u = [beta_k | gamma_k]_k (N, K 4M) fp32
//      over all components at once, x (N, 2D) against fwd (2D, K 4M);
//   3. `quad_kernel` writes each row's quadratic terms |beta_k - T mu_k|^2
//      (N, K), summed in float64 and rounded once;
//   4. the split forms the features z = [x | |x|^2] (3D) a chunk at a time;
//   5. the logit product z lcoef: each k16 step's six products into a
//      fresh accumulator, added with const_k and the quadratic term in a
//      compensated sum whose error is folded in after the row's offset (its
//      largest logit of the first 64 components) is taken off, lg' = (lg -
//      off) - lost (the diagonal and quadratic terms cancel at high SNR:
//      each is reduced apart, then added; an accumulator over a whole chunk
//      left a near-tie to fp32's rounding of a logit in the thousands); K
//      past 128 in column slices, the first taking the offsets;
//   6. `softmax_kernel` (K <= 128) or `softmax_any_kernel` pools over the
//      block (sums in float64) and writes the weights over lg' (for K13
//      exp(l - max l) with m = fl(o + max l) and den);
//   7. the split forms A = [w_k u_k]_k (N, K 4M), each value w_k beta or
//      w_k gamma rounded in fp32, and the combine product A comb (K 4M, 2D)
//      writes h_lin;
//   8. `fold_kernel` adds sum_k w_k bias_k + (sum_k w_k a1_k) o x per bin,
//      the sums over k in float64, rounded once into the output.
// Everything outside the products is fp32 or float64. TF32 stays excluded.
// Dead components keep the finite -1e30 floor of const.
//
// Bound on an H100 (D = 256, K = 32, M = 16, N = 32768;
// `fact_kernels.fact_bound`): the two products as six bf16 products of 2 N
// K (2D 4M + 4M 2D) (8.2e11, 0.834 ms at 989 TFLOP/s) plus 2 N K (3D + 2M +
// 6D) fp32 epilogue operations (4.9e9, 0.073 ms at 67 TFLOP/s) against the
// rows read and written once (0.13 GB, 0.040 ms at 3.35 TB/s): bound by
// operations, 0.91 ms. The scratch passes move ~20 K M + 30 D bytes a row
// more (u and the combine's planes: 0.8 GB there, 0.25 ms).
// Any N (a whole number of T-row blocks), D >= 1, M >= 1, K >= 1 with K 4M
// < 2^30, 1 <= T <= 64, up to 65535 pairs of 64-row tiles a launch (the
// wrapper cuts rows to its scratch budget first).
#include "wide_gemm.cuh"

namespace {

using namespace qce_tc;
using namespace qce_wide;

constexpr int kMaxT = 64;

// The bank's units (64 columns x 64 deep, three planes) as
// `fact_kernels.fact_wide_operands` lays them out: the forward operand fwd
// (2D, K 4M)'s NQ pieces of NPD chunks, the logit operand (3D, K)'s KP
// pieces of NF chunks, the combine operand comb (K 4M, 2D)'s NPD pieces of
// NQ chunks (NPD, NF, NQ, KP the 64-wide pieces of 2D, 3D, K 4M and K).
long long fact_wide_units(int d, int m, int k) {
  const long long npd = chunks_of(2 * d), nf = chunks_of(3 * d);
  const long long nq = ((long long)k * 4 * m + 63) / 64, kp = chunks_of(k);
  return 2 * npd * nq + kp * nf;
}

// The combine's rows A (n, K 4M) as the row split reads them: u's value
// times its component's weight, w_k beta or w_k gamma, rounded in fp32.
struct WuRows {
  const float* u;
  const float* w;
  int n, width, m4, k_comp;
  __device__ __forceinline__ bool skip(int) const { return false; }
  __device__ __forceinline__ int row(int tile, int rr) const {
    const int r = tile * 64 + rr;
    return r < n ? r : -1;
  }
  __device__ __forceinline__ float value(int r, int col) const {
    if (col >= width) return 0.f;
    return __fmul_rn(__ldg(u + (size_t)r * width + col),
                     __ldg(w + (size_t)r * k_comp + col / m4));
  }
  __device__ __forceinline__ float2 pair(int r, int col) const {
    return make_float2(value(r, col), value(r, col + 1));
  }
};

inline int grid_of(size_t threads) {
  const size_t blocks = (threads + 255) / 256;
  return (int)(blocks < 65535 ? blocks : 65535);
}

// quad (n, K): |beta_k - T mu_k|^2 of each row and component, beta_k the
// first 2M of u's 4M columns of component k, summed in float64 and rounded
// once. A thread a (row, component).
__global__ void quad_kernel(const float* __restrict__ u,
                            const float* __restrict__ tmu,
                            float* __restrict__ quad, int n, int k_comp,
                            int m) {
  const size_t total = (size_t)n * k_comp;
  const size_t width = (size_t)k_comp * 4 * m;
  for (size_t id = (size_t)blockIdx.x * blockDim.x + threadIdx.x; id < total;
       id += (size_t)gridDim.x * blockDim.x) {
    const size_t r = id / k_comp;
    const int k = (int)(id - r * k_comp);
    const float* ur = u + r * width + (size_t)k * 4 * m;
    const float* t = tmu + (size_t)k * 2 * m;
    double s = 0.0;
    for (int i = 0; i < 2 * m; ++i) {
      const double dd = (double)__ldg(ur + i) - (double)__ldg(t + i);
      s += dd * dd;
    }
    quad[id] = (float)s;
  }
}

// out (n, 2D) = h_lin + sum_k w_k bias_k + (sum_k w_k a1_k) o x per bin (a
// complex product), the sums over k and the bin's sum in float64, rounded
// once; h_lin read from out. A thread a (row, bin).
__global__ void fold_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            const float* __restrict__ a1,
                            float* __restrict__ out, int n, int d,
                            int k_comp) {
  const size_t total = (size_t)n * d;
  for (size_t id = (size_t)blockIdx.x * blockDim.x + threadIdx.x; id < total;
       id += (size_t)gridDim.x * blockDim.x) {
    const size_t r = id / d;
    const int b = (int)(id - r * d);
    const float* wr = w + r * k_comp;
    double br = 0.0, bi = 0.0, ar = 0.0, ai = 0.0;
    for (int k = 0; k < k_comp; ++k) {
      const double wk = (double)__ldg(wr + k);
      const float2 bb = __ldg(reinterpret_cast<const float2*>(
          bias + (size_t)k * 2 * d) + b);
      const float2 aa = __ldg(reinterpret_cast<const float2*>(
          a1 + (size_t)k * 2 * d) + b);
      br += wk * bb.x;
      bi += wk * bb.y;
      ar += wk * aa.x;
      ai += wk * aa.y;
    }
    const float2 xx = __ldg(reinterpret_cast<const float2*>(
        x + r * 2 * d) + b);
    float2* o = reinterpret_cast<float2*>(out + r * 2 * d) + b;
    const float2 lin = *o;
    const double hr = ((double)lin.x + br) + (ar * xx.x - ai * xx.y);
    const double hi = ((double)lin.y + bi) + (ar * xx.y + ai * xx.x);
    *o = make_float2((float)hr, (float)hi);
  }
}

// Built with -DQCE_PASS_EVENTS (tools/fact_pass_split.py, never on the
// main path) a launch records a CUDA event before its first pass and after
// each of the nine below, and `fact_wide_pass_ms` reads the last launch's
// pass times; otherwise the marks compile to nothing.
#ifdef QCE_PASS_EVENTS
constexpr int kPassMarks = 10;
cudaEvent_t g_pass_ev[kPassMarks];
bool g_pass_ready = false;
inline void pass_mark(int i, cudaStream_t st) {
  if (!g_pass_ready) {
    for (auto& e : g_pass_ev) cudaEventCreate(&e);
    g_pass_ready = true;
  }
  cudaEventRecord(g_pass_ev[i], st);
}
#define QCE_PASS(i) pass_mark(i, st)
#else
#define QCE_PASS(i) ((void)0)
#endif

// The wide form's passes on n rows with the bank's units `planes`; the
// caller has validated the arguments.
int run_fact_wide(const float* x, const bf16* const (&planes)[3],
                  const float* tmu, const float* cst, const float* bias,
                  const float* a1, float* out, float* m_out, float* den_out,
                  void* a, float* u, float* lg, float* offs, int n, int d,
                  int m, int k_comp, int t_coh, float alpha, int stats,
                  cudaStream_t st) {
  const int two_d = 2 * d, npd = chunks_of(two_d), nf = chunks_of(3 * d);
  const int wu = k_comp * 4 * m, nq = chunks_of(wu), kp = chunks_of(k_comp);
  const int tiles = row_tiles(n);
  const auto at = [&](long long unit, int n_ch, int n_pieces, float* dst,
                      int width, const float* quad) {
    Gemm g{static_cast<const uint4*>(a),
           (size_t)tiles * n_ch * 512,
           {planes[0] + (size_t)unit * 4096, planes[1] + (size_t)unit * 4096,
            planes[2] + (size_t)unit * 4096},
           n_ch,
           n_pieces,
           n,
           0,
           kGroup,
           dst,
           width,
           cst,
           offs,
           nullptr,
           quad};
    return g;
  };
  const long long u_fwd = 0, u_lg = (long long)nq * npd;
  const long long u_comb = u_lg + (long long)kp * nf;
  int err;
  QCE_PASS(0);
  // forward: u = x fwd, every component's [beta | gamma]
  if ((err = split_tiles(PlainRows{x, n, two_d}, a, npd, tiles, st)))
    return err;
  QCE_PASS(1);
  if ((err = gemm<kStore>(at(u_fwd, npd, nq, u, wu, nullptr),
                          (nq + kGroup - 1) / kGroup, tiles, st)))
    return err;
  QCE_PASS(2);
  // the quadratic terms into the logits' place, then the logits
  quad_kernel<<<grid_of((size_t)n * k_comp), 256, 0, st>>>(u, tmu, lg, n,
                                                           k_comp, m);
  if ((err = (int)cudaGetLastError())) return err;
  QCE_PASS(3);
  if ((err = split_tiles(FeatRows{x, n, 3 * d, two_d, 1}, a, nf, tiles, st)))
    return err;
  QCE_PASS(4);
  Gemm gl = at(u_lg, nf, kp, lg, k_comp, lg);
  if ((err = gemm<kLogit>(gl, 1, tiles, st))) return err;
  const int lg_slices = (kp + kGroup - 1) / kGroup;
  if (lg_slices > 1) {
    gl.slice0 = 1;
    if ((err = gemm<kLogit>(gl, lg_slices - 1, tiles, st))) return err;
  }
  QCE_PASS(5);
  // the softmax weights in the logits' place
  if ((err = softmax(lg, offs, m_out, den_out, n, k_comp, t_coh, alpha,
                     stats, st)))
    return err;
  QCE_PASS(6);
  // combine: h_lin = [w_k u_k] comb into out, then the bias and diagonal
  if ((err = split_tiles(WuRows{u, lg, n, wu, 4 * m, k_comp}, a, nq, tiles,
                         st)))
    return err;
  QCE_PASS(7);
  if ((err = gemm<kStore>(at(u_comb, nq, npd, out, two_d, nullptr),
                          (npd + kGroup - 1) / kGroup, tiles, st)))
    return err;
  QCE_PASS(8);
  fold_kernel<<<grid_of((size_t)n * d), 256, 0, st>>>(x, lg, bias, a1, out,
                                                      n, d, k_comp);
  QCE_PASS(9);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K11 (t_coh = 1), K12 (t_coh > 1) and, with stats != 0, K13 at any d, m,
// k_comp >= 1 with k_comp 4m < 2^30: x (n, 2d) and out (n, 2d) interleaved
// [re, im] pairs (STATS: out the un-normalised accumulator, m_out, den_out
// (n)); hi, lo, lo2 the bank's `units` units
// (`fact_kernels.fact_wide_operands`, 16-byte aligned); tmu (k_comp, 2m),
// bias and a1 (k_comp, 2d) interleaved and cst (k_comp), the layout's
// (`fact_kernels.FactKernelBank`); scratch: a (3, tiles, max(ceil(2d /
// 64), ceil(3d / 64), ceil(4 m k_comp / 64)), 64, 64) bf16 with tiles =
// `kernels.wide_row_tiles(n)`, u (n, 4 m k_comp), lg (n, k_comp) and offs
// (n) fp32. n a whole number of t_coh-row blocks, 1 <= t_coh <= 64.
extern "C" int fact_wide_launch(const float* x, const void* hi,
                                const void* lo, const void* lo2,
                                const float* tmu, const float* cst,
                                const float* bias, const float* a1,
                                float* out, float* m_out, float* den_out,
                                void* a, float* u, float* lg, float* offs,
                                int n, int d, int m, int k_comp, int units,
                                int t_coh, float alpha, int stats,
                                void* stream) {
  if (n < 0 || d < 1 || d >= (1 << 28) || m < 1 || k_comp < 1 ||
      (long long)k_comp * 4 * m >= (1LL << 30) || t_coh < 1 ||
      t_coh > kMaxT || n % t_coh != 0 ||
      (stats && (m_out == nullptr || den_out == nullptr)) ||
      units != fact_wide_units(d, m, k_comp))
    return (int)cudaErrorInvalidValue;
  if (int err = check_pointers(hi, lo, lo2, x, out, a, u)) return err;
  const void* pairs[3] = {tmu, bias, a1};
  for (const void* ptr : pairs)
    if (reinterpret_cast<uintptr_t>(ptr) % 8 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  if (row_tiles(n) / kWgs > 65535) return (int)cudaErrorInvalidValue;
  const bf16* planes[3] = {static_cast<const bf16*>(hi),
                           static_cast<const bf16*>(lo),
                           static_cast<const bf16*>(lo2)};
  return run_fact_wide(x, planes, tmu, cst, bias, a1, out, m_out, den_out, a,
                       u, lg, offs, n, d, m, k_comp, t_coh, alpha, stats,
                       static_cast<cudaStream_t>(stream));
}

#ifdef QCE_PASS_EVENTS
// the last launch's nine pass times (ms) into ms[0..8], after its last
// event completes; a cudaError_t
extern "C" int fact_wide_pass_ms(float* ms) {
  if (!g_pass_ready) return (int)cudaErrorNotReady;
  cudaError_t err = cudaEventSynchronize(g_pass_ev[kPassMarks - 1]);
  for (int i = 0; err == cudaSuccess && i + 1 < kPassMarks; ++i)
    err = cudaEventElapsedTime(ms + i, g_pass_ev[i], g_pass_ev[i + 1]);
  return (int)err;
}
#endif
