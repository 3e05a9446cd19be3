// The product template of the wide forms that keep their intermediates in
// global scratch, shared by circ_wide_estimate.cu (K6-K10 past their
// templates) and fact_wide_estimate.cu (K11-K13 past theirs): one product
// C (n, 64 n_pieces) = A (n, 64 n_ch) B a launch, A the rows' three bf16
// planes as the row split lays them out (wide_ring.cuh), B the bank
// operand's units (piece, chunk), on the chunk ring of wide_ring.cuh. A
// chunk is the six bf16 products of three-plane splits into a fresh fp32
// accumulator; the chunks of an output piece are added in a compensated
// (Kahan) sum. Three epilogues: kStore writes C; kLogit adds the layout's
// constants (and, where given, a per-(row, component) term) to each logit
// in the compensated sum and writes the logits less the row's offset;
// kComb (the circulant kernels) forms h = c_bias + sum_p c_filt_p u_p per
// bin from the pieces of one column slice. Beside it the softmax kernels
// that pool and normalise the logits in global memory.
#pragma once

#include "wide_ring.cuh"

namespace qce_wide {

constexpr int kSoftmaxMaxK = 128;  // components of `softmax_kernel`

enum Epilogue { kStore = 0, kLogit = 1, kComb = 2 };

__host__ __device__ constexpr int chunks_of(int w) { return (w + 63) / 64; }

// Features of a row of P pilots at D bins: [u | |u_p|^2 | v_pq].
__host__ __device__ constexpr long long feat_width(int d, int p) {
  return (long long)d * (3 * p + p * (p - 1));
}

// Rows src (n, width) fp32 as the row split reads them, tile i's row rr
// the row 64 i + rr (padding past n), any width (K may be odd: scalar
// loads).
struct PlainRows {
  const float* src;
  int n, width;
  __device__ __forceinline__ bool skip(int) const { return false; }
  __device__ __forceinline__ int row(int tile, int rr) const {
    const int r = tile * 64 + rr;
    return r < n ? r : -1;
  }
  __device__ __forceinline__ float value(int r, int col) const {
    return col < width ? __ldg(src + (size_t)r * width + col) : 0.f;
  }
  __device__ __forceinline__ float2 pair(int r, int col) const {
    return make_float2(value(r, col), value(r, col + 1));
  }
};

// The logit features of u (n, P, 2D) fp32 as the row split reads them:
// [u_1..u_P | |u_p|^2 (P D) | v_pq (2D each, pairs p < q in row-major
// order, [Re, Im] interleaved per bin)], rounded as the plain versions
// round them (at P = 1 the circulant kernels' [u | |u|^2], and the
// factored kernels' [x | |x|^2] of the rows themselves).
struct FeatRows {
  const float* src;
  int n, width, two_d, p;
  __device__ __forceinline__ bool skip(int) const { return false; }
  __device__ __forceinline__ int row(int tile, int rr) const {
    const int r = tile * 64 + rr;
    return r < n ? r : -1;
  }
  // the first pair index of pilot pi's row of pairs
  __device__ __forceinline__ int first_pair(int pi) const {
    return pi * (2 * p - pi - 1) / 2;
  }
  __device__ __forceinline__ float value(int r, int col) const {
    if (col >= width) return 0.f;
    const int pd2 = p * two_d, d = two_d / 2;
    const float* ur = src + (size_t)r * pd2;
    if (col < pd2) return __ldg(ur + col);
    if (col < pd2 + p * d) {
      const int c2 = col - pd2, pi = c2 / d, b = c2 - pi * d;
      const float2 ub = __ldg(reinterpret_cast<const float2*>(
          ur + pi * two_d + 2 * b));
      return __fadd_rn(__fmul_rn(ub.x, ub.x), __fmul_rn(ub.y, ub.y));
    }
    const int j = col - pd2 - p * d, pair = j / two_d;
    const int w = j - pair * two_d;
    // the pair's pilots pi < qi: the root of first_pair(pi) = pair,
    // corrected for its rounding
    const double b2 = 2.0 * p - 1.0;
    int pi = (int)((b2 - sqrt(b2 * b2 - 8.0 * pair)) * 0.5);
    pi = max(0, min(pi, p - 2));
    while (pi > 0 && first_pair(pi) > pair) --pi;
    while (pi < p - 2 && first_pair(pi + 1) <= pair) ++pi;
    const int qi = pi + 1 + pair - first_pair(pi);
    const float2 a = __ldg(reinterpret_cast<const float2*>(
        ur + pi * two_d + (w & ~1)));
    const float2 c = __ldg(reinterpret_cast<const float2*>(
        ur + qi * two_d + (w & ~1)));
    return (w & 1) ? __fsub_rn(__fmul_rn(a.x, c.y), __fmul_rn(a.y, c.x))
                   : __fadd_rn(__fmul_rn(a.x, c.x), __fmul_rn(a.y, c.y));
  }
  __device__ __forceinline__ float2 pair(int r, int col) const {
    return make_float2(value(r, col), value(r, col + 1));
  }
};

// One product of the wide form: C (n, 64 n_pieces) = A (n, 64 n_ch) B, A the
// split rows' planes, B units (piece, chunk) from the operand's first unit;
// a block takes the pieces of its column slice (blockIdx.x + slice0) two at
// a time, slice_pieces of them (kComb: the P + 1 slabs of a 64-column slice
// of 2D; else 2); the epilogue's inputs and outputs.
struct Gemm {
  const uint4* a;
  size_t plane_units;
  const bf16* b[3];
  int n_ch, n_pieces, n, slice0, slice_pieces;
  float* out;         // kStore, kComb: (n, width); kLogit: lg (n, width = K)
  int width;
  const float* cst;   // kLogit: const (K)
  float* offs;        // kLogit: the rows' offsets (n)
  const float* u;     // kComb: u (n, P, width)
  const float* quad;  // kLogit: a term (n, K) added beside const, or null
};

// The producer: one thread copies, for each of the block's pairs of pieces
// and each chunk, both warpgroups' A chunk and the chunk of the pieces into
// the ring.
template <int EPI>
__device__ void produce(const Gemm& g, WideRing ring) {
  const int slice = blockIdx.x + g.slice0;
  for (int s0 = 0; s0 < (EPI == kComb ? g.slice_pieces : kGroup);
       s0 += kGroup) {
    const int j0 = slice * g.slice_pieces + s0;
    const int gn = min(kGroup, min(g.n_pieces - j0, g.slice_pieces - s0));
    for (int c = 0; c < g.n_ch; ++c)
      load_chunk(ring, g.a, g.plane_units, blockIdx.y, g.n_ch, c, g.b, j0,
                 gn);
  }
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

// The product kernel: grid (column slices, pairs of 64-row tiles). kStore
// writes C; kLogit the offset logits lg' of its two pieces of K (the first
// slice also the offsets, the others read them); kComb the combine h from
// the pieces (bias, filter_1 .. filter_P) of its slice and u.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1) wide_gemm(Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideRing ring = ring_init(smem_raw);

  const int wg = threadIdx.x / kWg;
  if (wg == kWgs) {  // the producer warpgroup: one thread streams
    setmaxnreg_dec<40>();
    if (threadIdx.x == kWgs * kWg) produce<EPI>(g, ring);
    return;
  }
  setmaxnreg_inc<232>();

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
  const int slice = blockIdx.x + g.slice0;
  float acc[kGroup][32], sum[kGroup][32], lost[kGroup][32];
  for (int s0 = 0; s0 < (EPI == kComb ? g.slice_pieces : kGroup);
       s0 += kGroup) {
    const int j0 = slice * g.slice_pieces + s0;
    const int gn = min(kGroup, min(g.n_pieces - j0, g.slice_pieces - s0));
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
              *reinterpret_cast<float2*>(orow + col) =
                  make_float2(sum[gp][i] - lost[gp][i],
                              sum[gp][i + 1] - lost[gp][i + 1]);
          }
        }
      }
    } else if constexpr (EPI == kComb) {
      // pieces s0, s0 + 1 of slice x: slab 0 the bias, slab s the filter
      // of pilot s - 1; the first pair writes h = c_bias + c_filt_1 u_1,
      // the later pairs add their pilots to it
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!live[r]) continue;
        const size_t at = (size_t)row[r] * g.width;
        const float* urow = g.u + (size_t)row[r] * (g.slice_pieces - 1) *
                                      g.width;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = blockIdx.x * 64 + 8 * t + 2 * q;  // a bin's re, im
          const int i = 4 * t + 2 * r;
          if (col >= g.width) continue;
          float hx, hy;
          if (s0 == 0) {
            hx = sum[0][i] - lost[0][i];
            hy = sum[0][i + 1] - lost[0][i + 1];
          } else {
            const float2 h = *reinterpret_cast<const float2*>(g.out + at +
                                                              col);
            hx = h.x;
            hy = h.y;
          }
#pragma unroll
          for (int gp = 0; gp < kGroup; ++gp) {
            if (gp >= gn || s0 + gp == 0) continue;
            const float fr = sum[gp][i] - lost[gp][i];
            const float fi = sum[gp][i + 1] - lost[gp][i + 1];
            const float2 uu = __ldg(reinterpret_cast<const float2*>(
                urow + (s0 + gp - 1) * g.width + col));
            hx = hx + fr * uu.x - fi * uu.y;
            hy = hy + fr * uu.y + fi * uu.x;
          }
          *reinterpret_cast<float2*>(g.out + at + col) = make_float2(hx, hy);
        }
      }
    } else {  // kLogit: const (and quad) in the compensated sum, -inf past K
      const int k_comp = g.width;
#pragma unroll
      for (int gp = 0; gp < kGroup; ++gp)
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 64 * (j0 + gp) + 8 * t + 2 * q + h;
            const float ck = k < k_comp ? __ldg(g.cst + k) : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * t + 2 * r + h;
              kahan(sum[gp][i], lost[gp][i], ck);
              // the same thread reads this element here and writes it
              // below: no other thread touches it
              if (g.quad != nullptr && k < k_comp && live[r])
                kahan(sum[gp][i], lost[gp][i],
                      g.quad[(size_t)row[r] * k_comp + k]);
              if (k >= k_comp) sum[gp][i] = -INFINITY, lost[gp][i] = 0.f;
            }
          }
      // the rows' offsets: the largest logit of components [0, 64) (a
      // row's values on the four threads of a quad), or 0 where those are
      // all dead; the first slice takes them, the others read them
      float off[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (j0 > 0) {
          off[r] = live[r] ? g.offs[row[r]] : 0.f;
          continue;
        }
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
              const int k = 64 * (j0 + gp) + 8 * t + 2 * q + h;
              const int i = 4 * t + 2 * r + h;
              if (k < k_comp) lr[k] = (sum[gp][i] - off[r]) - lost[gp][i];
            }
        if (q == 0 && j0 == 0) g.offs[row[r]] = off[r];
      }
    }
  }
}

// The softmax over each row's K offset logits lg' (n, K <= 128), a warp a
// block of T consecutive rows (each lane components lane + 32 i): the pool
// lg' + a (s - lg'), s the block's sum in float64 (a >= 1: s), then the
// weights over lg' in place, normalised, or (STATS) exp(l - max l) with m =
// fl(o + max l), o the row's offset pooled alike in float64, and den. A row
// whose logits are all -inf weighs nothing.
static __global__ void softmax_kernel(float* __restrict__ lg,
                                      const float* __restrict__ offs,
                                      float* __restrict__ m_out,
                                      float* __restrict__ den_out, int n,
                                      int k_comp, int t_coh, float alpha,
                                      int stats) {
  constexpr int kPer = kSoftmaxMaxK / 32;
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

// `softmax_kernel` at any K (past 128 components): the same arithmetic, the
// row walked in global memory. The pool first (each lane its components'
// block sums in float64, the pooled logits written in place), then for
// each row its largest logit, the sum of the exponentials and the weights;
// STATS as there (offs, m_out and den_out read and written only then).
static __global__ void softmax_any_kernel(float* __restrict__ lg,
                                          const float* __restrict__ offs,
                                          float* __restrict__ m_out,
                                          float* __restrict__ den_out, int n,
                                          int k_comp, int t_coh, float alpha,
                                          int stats) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * t_coh;
  if (r0 >= n) return;
  float* blk = lg + (size_t)r0 * k_comp;
  if (t_coh > 1) {
    for (int k = lane; k < k_comp; k += 32) {
      double s = 0.0;
      for (int tt = 0; tt < t_coh; ++tt) s += (double)blk[tt * k_comp + k];
      for (int tt = 0; tt < t_coh; ++tt) {
        float* l = blk + tt * k_comp + k;
        *l = alpha >= 1.f ? (float)s
                          : (float)((double)*l + (double)alpha * (s -
                                                                 (double)*l));
      }
    }
  }
  double so = 0.0;
  if (stats && t_coh > 1)
    for (int tt = 0; tt < t_coh; ++tt) so += (double)__ldg(offs + r0 + tt);
  for (int tt = 0; tt < t_coh; ++tt) {
    float* lr = blk + (size_t)tt * k_comp;
    float mx = -INFINITY;
    for (int k = lane; k < k_comp; k += 32) mx = fmaxf(mx, lr[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx == -INFINITY) mx = 0.f;
    float den = 0.f;
    for (int k = lane; k < k_comp; k += 32)
      den += lr[k] == -INFINITY ? 0.f : expf(lr[k] - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    for (int k = lane; k < k_comp; k += 32) {
      const float e = lr[k] == -INFINITY ? 0.f : expf(lr[k] - mx);
      lr[k] = stats ? e : e / den;
    }
    if (stats && lane == 0) {
      const int row = r0 + tt;
      double o = (double)__ldg(offs + row);
      if (t_coh > 1) o = alpha >= 1.f ? so : o + (double)alpha * (so - o);
      m_out[row] = (float)(o + (double)mx);
      den_out[row] = den;
    }
  }
}

// The softmax of n rows of K offset logits in place: `softmax_kernel` up to
// 128 components, `softmax_any_kernel` past them.
inline int softmax(float* lg, const float* offs, float* m_out, float* den_out,
                   int n, int k_comp, int t_coh, float alpha, int stats,
                   cudaStream_t st) {
  const int warps = n / t_coh;
  if (k_comp <= kSoftmaxMaxK)
    softmax_kernel<<<(warps + 3) / 4, 128, 0, st>>>(
        lg, offs, m_out, den_out, n, k_comp, t_coh, alpha, stats);
  else
    softmax_any_kernel<<<(warps + 3) / 4, 128, 0, st>>>(
        lg, offs, m_out, den_out, n, k_comp, t_coh, alpha, stats);
  return (int)cudaGetLastError();
}

// Launch one product over `slices` column slices and `tiles` 64-row tiles.
template <int EPI>
int gemm(const Gemm& g, int slices, int tiles, cudaStream_t st) {
  auto kern = wide_gemm<EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRingSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(slices, tiles / kWgs), kThreads, kRingSmem, st>>>(g);
  return (int)cudaGetLastError();
}

// The checks every entry shares: alignment of the units, the rows and the
// scratch (0 if they hold).
inline int check_pointers(const void* hi, const void* lo, const void* lo2,
                          const void* x, const void* out, const void* a,
                          const void* u) {
  const void* aligned[4] = {hi, lo, lo2, a};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const void* pairs[3] = {x, out, u};
  for (const void* ptr : pairs)
    if (reinterpret_cast<uintptr_t>(ptr) % 8 != 0)
      return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace qce_wide
