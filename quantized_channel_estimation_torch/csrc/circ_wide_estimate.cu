// The wide form of the circulant (FFT-domain) estimation kernels for
// Hopper: K6 (flat), K7 (coherent), K8 (stats) and K9 (coherent stats) at
// every width past the one-pilot template of mp_circ_estimate.cu (D > 128),
// up to D = 672.
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
// template (`circ_wide_gemm`) of 128-row blocks on the wide K1's chunk
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
#include "wide_ring.cuh"

namespace {

using namespace qce_tc;
using namespace qce_wide;

constexpr int kMaxD = 672;
constexpr int kMaxK = 128;
constexpr int kMaxT = 64;

enum Epilogue { kStore = 0, kLogit = 1, kComb = 2 };

__host__ __device__ constexpr int chunks_of(int w) { return (w + 63) / 64; }

// The bank's units (64 columns x 64 deep, three planes) as
// `circ_kernels.circ_wide_operands` lays them out: the forward operand's
// NPD x NPD, the logit's KP x NZ, the combine's NPD x 2 x KP and, except for
// the stats forms, the inverse's NPD x NPD.
int wide_units(int d, int k, bool stats) {
  const int npd = chunks_of(2 * d), nz = chunks_of(3 * d), kp = chunks_of(k);
  return npd * npd + kp * nz + 2 * npd * kp + (stats ? 0 : npd * npd);
}

// Rows src (n, width) fp32 as the row split reads them, tile i's row rr
// the row 64 i + rr (padding past n), any width (K may be odd: scalar
// loads). FEAT: the features [u | |u|^2] (width 3D) of u (n, two_d),
// |u_b|^2 rounded as the plain version rounds it.
template <bool FEAT>
struct CircRows {
  const float* src;
  int n, width, two_d;
  __device__ __forceinline__ bool skip(int) const { return false; }
  __device__ __forceinline__ int row(int tile, int rr) const {
    const int r = tile * 64 + rr;
    return r < n ? r : -1;
  }
  __device__ __forceinline__ float value(int r, int col) const {
    if (col >= width) return 0.f;
    if (!FEAT) return __ldg(src + (size_t)r * width + col);
    if (col < two_d) return __ldg(src + (size_t)r * two_d + col);
    const float2 ub = __ldg(reinterpret_cast<const float2*>(
        src + (size_t)r * two_d + 2 * (col - two_d)));
    return __fadd_rn(__fmul_rn(ub.x, ub.x), __fmul_rn(ub.y, ub.y));
  }
  __device__ __forceinline__ float2 pair(int r, int col) const {
    return make_float2(value(r, col), value(r, col + 1));
  }
};

// One product of the wide form: C (n, 64 n_pieces) = A (n, 64 n_ch) B,
// A the split rows' planes, B units (piece, chunk) from the operand's first
// unit; the epilogue's inputs and outputs.
struct Gemm {
  const uint4* a;
  size_t plane_units;
  const bf16* b[3];
  int n_ch, n_pieces, n;
  float* out;        // kStore, kComb: (n, width); kLogit: lg (n, width = K)
  int width;
  const float* cst;  // kLogit: const (K)
  float* offs;       // kLogit: the rows' offsets (n)
  const float* u;    // kComb: u (n, width)
};

// The producer: one thread copies, for each chunk, both warpgroups' A
// chunk and the chunk of the block's gn pieces into the ring.
__device__ void produce(const Gemm& g, int j0, int gn, WideRing ring) {
  for (int c = 0; c < g.n_ch; ++c)
    load_chunk(ring, g.a, g.plane_units, blockIdx.y, g.n_ch, c, g.b, j0, gn);
}

// sum - lost += part over the live pieces, compensated (`kahan`)
__device__ __forceinline__ void kahan_add(float (&sum)[kGroup][32],
                                          float (&lost)[kGroup][32],
                                          const float (&part)[kGroup][32],
                                          int gn) {
#pragma unroll
  for (int gp = 0; gp < kGroup; ++gp) {
    if (gp >= gn) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) kahan(sum[gp][i], lost[gp][i], part[gp][i]);
  }
}

// The logit's chunk: each k16 step's six products into a fresh
// accumulator, waited for and added to the compensated sum
template <int KS>
__device__ __forceinline__ void logit_steps(float (&acc)[kGroup][32],
                                            float (&sum)[kGroup][32],
                                            float (&lost)[kGroup][32],
                                            unsigned st, int wg, int gn) {
  if constexpr (KS < 4) {
    wgmma_fence();
    fence_all(acc);
    issue_chunk<0, 6, KS, KS + 1>(acc, st, wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(acc);
    kahan_add(sum, lost, acc, gn);
    logit_steps<KS + 1>(acc, sum, lost, st, wg, gn);
  }
}

// The product kernel: grid (column slices of two pieces, pairs of 64-row
// tiles). kStore writes C; kLogit the offset logits lg' and the offsets;
// kComb the combine h from the pieces (bias, filter) of its slice and u.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1) circ_wide_gemm(Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideRing ring = ring_init(smem_raw);

  const int wg = threadIdx.x / kWg;
  const int j0 = kGroup * blockIdx.x;
  const int gn = min(kGroup, g.n_pieces - j0);
  if (wg == kWgs) {  // the producer warpgroup: one thread streams
    setmaxnreg_dec<40>();
    if (threadIdx.x == kWgs * kWg) produce(g, j0, gn, ring);
    return;
  }
  setmaxnreg_inc<232>();

  float acc[kGroup][32], sum[kGroup][32], lost[kGroup][32];
#pragma unroll
  for (int gp = 0; gp < kGroup; ++gp)
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[gp][i] = lost[gp][i] = 0.f;
  for (int c = 0; c < g.n_ch; ++c) {
    const unsigned st = ring.stage();
    mbar_wait(ring.full(), ring.ph);
    if constexpr (EPI == kLogit) {
      logit_steps<0>(acc, sum, lost, st, wg, gn);
    } else {
      wgmma_fence();
      fence_all(acc);
      issue_chunk<0, 6, 0, 4>(acc, st, wg);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
    }
    warp_arrive(ring.empty());  // the products have read the stage
    ring.next();
    if constexpr (EPI != kLogit) kahan_add(sum, lost, acc, gn);
  }

  // this lane's columns 8 t + 2 q + {0, 1} of each piece, its rows
  // row_in_wg() and + 8 of its warpgroup's 64
  const int q = threadIdx.x & 3;
  int row[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = (blockIdx.y * kWgs + wg) * 64 + row_in_wg() + 8 * r;
    live[r] = row[r] < g.n;
  }
  if constexpr (EPI == kStore) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      float* orow = g.out + (size_t)row[r] * g.width;
#pragma unroll
      for (int gp = 0; gp < kGroup; ++gp) {
        if (gp >= gn) continue;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = (j0 + gp) * 64 + 8 * t + 2 * q;  // width is even
          const int i = 4 * t + 2 * r;
          if (col < g.width)
            *reinterpret_cast<float2*>(orow + col) = make_float2(
                sum[gp][i] - lost[gp][i], sum[gp][i + 1] - lost[gp][i + 1]);
        }
      }
    }
  } else if constexpr (EPI == kComb) {  // pieces (bias, filter) of slice x
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const size_t at = (size_t)row[r] * g.width;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = blockIdx.x * 64 + 8 * t + 2 * q;  // a bin's (re, im)
        const int i = 4 * t + 2 * r;
        if (col >= g.width) continue;
        const float br = sum[0][i] - lost[0][i];
        const float bi = sum[0][i + 1] - lost[0][i + 1];
        const float fr = sum[1][i] - lost[1][i];
        const float fi = sum[1][i + 1] - lost[1][i + 1];
        const float2 uu = __ldg(reinterpret_cast<const float2*>(g.u + at +
                                                                 col));
        *reinterpret_cast<float2*>(g.out + at + col) =
            make_float2(br + fr * uu.x - fi * uu.y,
                        bi + fr * uu.y + fi * uu.x);
      }
    }
  } else {  // kLogit: const in the compensated sum, -inf past K
    const int k_comp = g.width;
#pragma unroll
    for (int gp = 0; gp < kGroup; ++gp)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 64 * gp + 8 * t + 2 * q + h;
          const float ck = k < k_comp ? __ldg(g.cst + k) : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * t + 2 * r + h;
            kahan(sum[gp][i], lost[gp][i], ck);
            if (k >= k_comp) sum[gp][i] = -INFINITY, lost[gp][i] = 0.f;
          }
        }
    // the rows' offsets: the largest logit of components [0, 64) (a row's
    // values on the four threads of a quad), or 0 where those are all dead
    float off[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) m = fmaxf(m, sum[0][4 * t + 2 * r + h]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      off[r] = m > -1e29f ? m : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      float* lr = g.out + (size_t)row[r] * k_comp;
#pragma unroll
      for (int gp = 0; gp < kGroup; ++gp)
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 64 * gp + 8 * t + 2 * q + h;
            const int i = 4 * t + 2 * r + h;
            if (k < k_comp) lr[k] = (sum[gp][i] - off[r]) - lost[gp][i];
          }
      if (q == 0) g.offs[row[r]] = off[r];
    }
  }
}

// The softmax over each row's K offset logits lg' (n, K), a warp a block of
// T consecutive rows (each lane components lane + 32 i): the pool lg' + a
// (s - lg'), s the block's sum in float64 (a >= 1: s), then the weights
// over lg' in place, normalised, or (STATS) exp(l - max l) with m = fl(o +
// max l), o the row's offset pooled alike in float64, and den. A row whose
// logits are all -inf weighs nothing.
__global__ void softmax_kernel(float* __restrict__ lg,
                               const float* __restrict__ offs,
                               float* __restrict__ m_out,
                               float* __restrict__ den_out, int n,
                               int k_comp, int t_coh, float alpha,
                               int stats) {
  constexpr int kPer = kMaxK / 32;
  const int lane = threadIdx.x & 31;
  const int r0 = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * t_coh;
  if (r0 >= n) return;
  double s[kPer], so = 0.0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s[i] = 0.0;
  if (t_coh > 1) {
    for (int tt = 0; tt < t_coh; ++tt) {
      const float* lr = lg + (size_t)(r0 + tt) * k_comp;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = lane + 32 * i;
        if (k < k_comp) s[i] += (double)lr[k];
      }
      so += (double)__ldg(offs + r0 + tt);
    }
  }
  for (int tt = 0; tt < t_coh; ++tt) {
    const int row = r0 + tt;
    float* lr = lg + (size_t)row * k_comp;
    float v[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lane + 32 * i;
      v[i] = -INFINITY;
      if (k < k_comp) {
        const float l = lr[k];
        v[i] = t_coh == 1 ? l
               : alpha >= 1.f
                   ? (float)s[i]
                   : (float)((double)l + (double)alpha * (s[i] - (double)l));
        mx = fmaxf(mx, v[i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx == -INFINITY) mx = 0.f;
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = v[i] == -INFINITY ? 0.f : expf(v[i] - mx);
      den += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lane + 32 * i;
      if (k < k_comp) lr[k] = stats ? v[i] : v[i] / den;
    }
    if (stats && lane == 0) {
      double o = (double)__ldg(offs + row);
      if (t_coh > 1) o = alpha >= 1.f ? so : o + (double)alpha * (so - o);
      m_out[row] = (float)(o + (double)mx);
      den_out[row] = den;
    }
  }
}

int split(bool feat, const float* src, void* a, int n, int width, int two_d,
          int tiles, cudaStream_t st) {
  const int n_ch = chunks_of(width);
  return feat ? split_tiles(CircRows<true>{src, n, width, two_d}, a, n_ch,
                            tiles, st)
              : split_tiles(CircRows<false>{src, n, width, two_d}, a, n_ch,
                            tiles, st);
}

template <int EPI>
int gemm(const Gemm& g, int tiles, cudaStream_t st) {
  auto kern = circ_wide_gemm<EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRingSmem);
  if (err != cudaSuccess) return (int)err;
  const int slices = EPI == kComb ? g.n_pieces / 2
                     : EPI == kLogit ? 1
                                     : (g.n_pieces + kGroup - 1) / kGroup;
  kern<<<dim3(slices, tiles / kWgs), kThreads, kRingSmem, st>>>(g);
  return (int)cudaGetLastError();
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
      units != wide_units(d, k_comp, stats != 0))
    return (int)cudaErrorInvalidValue;
  const void* aligned[3] = {hi, lo, lo2};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const int tiles = row_tiles(n);
  if (tiles / kWgs > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int two_d = 2 * d, npd = chunks_of(two_d), nz = chunks_of(3 * d);
  const int kp = chunks_of(k_comp);
  const bf16* planes[3] = {static_cast<const bf16*>(hi),
                           static_cast<const bf16*>(lo),
                           static_cast<const bf16*>(lo2)};
  const auto at = [&](int unit, int n_ch, int n_pieces, float* dst,
                      int width) {
    Gemm g{static_cast<const uint4*>(a),
           (size_t)tiles * n_ch * 512,
           {planes[0] + (size_t)unit * 4096, planes[1] + (size_t)unit * 4096,
            planes[2] + (size_t)unit * 4096},
           n_ch,
           n_pieces,
           n,
           dst,
           width,
           cst,
           offs,
           u};
    return g;
  };
  int err;
  // forward: u = x bfwd
  if ((err = split(false, x, a, n, two_d, two_d, tiles, st))) return err;
  if ((err = gemm<kStore>(at(0, npd, npd, u, two_d), tiles, st))) return err;
  // logits of [u | |u|^2], then the softmax weights in their place
  if ((err = split(true, u, a, n, 3 * d, two_d, tiles, st))) return err;
  if ((err = gemm<kLogit>(at(npd * npd, nz, kp, lg, k_comp), tiles, st)))
    return err;
  const int warps = n / t_coh;
  softmax_kernel<<<(warps + 3) / 4, 128, 0, st>>>(lg, offs, m_out, den_out, n,
                                                  k_comp, t_coh, alpha,
                                                  stats);
  if ((err = (int)cudaGetLastError())) return err;
  // combine: h = w bias + (w filt) u into out
  if ((err = split(false, lg, a, n, k_comp, two_d, tiles, st))) return err;
  if ((err = gemm<kComb>(at(npd * npd + kp * nz, kp, 2 * npd, out, two_d),
                         tiles, st)))
    return err;
  if (stats) return 0;
  // inverse: out = h binv
  if ((err = split(false, out, a, n, two_d, two_d, tiles, st))) return err;
  return gemm<kStore>(
      at(npd * npd + kp * nz + 2 * npd * kp, npd, npd, out, two_d), tiles,
      st);
}

// u (n, two_d) fp32 -> its features [u | |u|^2] (n, 3d) as the logit
// product reads them: a (3, tiles, ceil(3d / 64), 64, 64) bf16, tiles =
// `kernels.wide_row_tiles(n)` (`circ_kernels.circ_wide_rows(u, True)` is
// the plain version; the rows' own split is grouped_wide_estimate.cu's).
extern "C" int circ_wide_features_launch(const float* u, void* a, int n,
                                         int two_d, void* stream) {
  if (n < 1 || two_d < 2 || two_d % 2 != 0 || two_d > 2 * kMaxD)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  return split(true, u, a, n, two_d / 2 * 3, two_d, row_tiles(n),
               static_cast<cudaStream_t>(stream));
}
