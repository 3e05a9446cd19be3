// The circulant (FFT-domain) estimation kernels K6 (flat) and K7
// (coherent), and with the STATS flag their stats forms K8 and K9, with a
// factorised transform, for Hopper: one fused kernel a tile of rows, x in
// and the finished estimate (or the state) out, every intermediate on
// chip.
//
// Replaces, at every width 128 < D <= 672 whose transform splits into two
// factors of at most 64 (`circ_kernels.circ_fact_blocks`: 314 of those 544
// widths for the DFT, and the kron(F_n1, F_n2) basis of block-circulant
// banks with n1, n2 <= 64), the TPU kernels of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py that the
// JAX package runs there (models/structured_bank.py:415, :604;
// parallel/mesh.py:183, :193): `_circ_kernel` (:1309, pallas_call in
// `estimate_circ_packed` :1346), `_circ_kernel_coh` (:1647, :1698),
// `_circ_kernel_stats` (:1749, :1789) and `_circ_kernel_coh_stats` (:1822,
// :1868); K8 / K9 only where they were measured faster than the dense
// wide form (`circ_kernels.circ_stats_fact_eligible`: 3 K <= D, few dense
// odd-prime stages, two sweeps only without them). The other wide widths
// and shapes keep the dense wide form of circ_wide_estimate.cu. Per row x
// (D complex values, interleaved [re, im] pairs) and component k:
//
//   u      = F x                           forward (block-)DFT, factorised
//   lg_k   = [u | |u|^2] @ lcoef + const   (3D, K), tensor cores
//   w_k    = softmax_k(lg'_k)              K7: lg' = lg + a (s - lg), s the
//                                          sum over the row's block
//   h      = w @ bias + (w @ filt) * u     per bin, (K, 4D), tensor cores
//   out    = F^H h                         inverse, factorised
//
// STATS (K8 / K9) stops before the normalisation and the inverse: per row
// m = o + max_k lg'_k (o the row's offset, kept in shared memory a float a
// row through both sweeps, pooled over the block as the logits are, in
// float64; the logits' -D log pi row constant dropped, as in the dense wide
// form, so that states of either route merge), den = sum_k exp(lg'_k - max)
// and acc = h with the un-normalised weights, written in natural bin order
// (`store_natural`: bin p + d1 q from slot p (d2 | 1) + q; the kron basis'
// positions are its bins), m and den a float a row. The merge of component
// shards and the one inverse transform stay on the host
// (`kernels.merge_stats`, `circ_kernels._merged`). STATS is a template
// parameter: K6 / K7's instantiation is the same code as without it.
//
// The transform. D = d1 d2 (d1 <= d2 <= 64, the most balanced split; or
// the kron basis' (n1, n2)). A row is the (d1, d2) array x[a d2 + b]; the
// forward transform is d2 DFTs of d1 points over a (stride d2), the
// twiddle W_D^{p b} (unit for the kron basis) and d1 DFTs of d2 points over
// b, which leaves bin p + d1 q at position p d2 + q: the bins stay in that
// permuted order (`circ_kernels.circ_fact_perm`), the bank's per-bin rows
// of lcoef and columns of comb are permuted once on the host to match, and
// the inverse reads h in that order and runs the mirrored steps (d2-point
// DFTs over q, the conjugate twiddle, d1-point DFTs over p) into natural
// order. No transpose happens. Each level runs as Stockham stages in
// shared memory (ping-pong between two row buffers, natural order within a
// level): its size is split into radices 4 and 2, whose butterflies run one
// a thread, and odd primes, each a dense r-point DFT one output a thread;
// consecutive threads take consecutive batches, and a row's d1 lines of d2
// points sit d2 | 1 slots apart (`circ_kernels.circ_fact_slots`: an odd
// stride, so a half-warp's 16 lines at one offset fall on 16 banks); every
// stage's twiddles come from one table of W_n (n the level's size), and the
// cross twiddle, with the unitary 1 / sqrt(D) folded in, from a table over
// the slots. The tables are built in float64 on the host and rounded once
// (`circ_kernels.circ_fact_operands`). The transforms are fp32 on the CUDA
// cores: 512 = 16 x 32 runs five radix-4/2 stages each way. (Radix-8 and
// radix-16 butterflies in registers, three stages each way, and two
// 256-thread blocks a SM on one row buffer and a half-size scratch were
// each slower at D = 512 on the H100.)
//
// The products. The logit's features [u | |u|^2] and the weights are split
// in the kernel into three bf16 planes (hi, lo, lo2, each rounded to
// nearest even); the bank's logit and combine operands are split on the
// host and laid out as mma.sync B fragments (`circ_fact_operands`), read
// from L2. Each k16 step's six products (hi.lo2, lo.lo, lo2.hi, lo.hi,
// hi.lo, hi.hi of A's and B's planes, smallest first) go into a fresh fp32
// accumulator (mma.sync m16n8k16), and the steps into a compensated (Kahan)
// sum, as the dense wide form and the narrow template do. The logit's 3D
// contraction is split over warps, each loading its B fragments two k16
// steps ahead; the partial sums meet in shared memory
// in a compensated sum with const, and each row's logits are offset by its
// largest logit of components [0, 64): lg' = (lg - off) - lost. Dead
// components keep the -1e30 floor of const. The softmax (K7: the pool over
// a coherence block's rows in float64) runs a warp a block in shared memory.
//
// A block of 512 threads takes 16 rows (K6; K7 at T <= 16 the whole blocks
// within 16 rows): the rows arrive by cp.async, the forward stages, the
// logits, the softmax, the combine (h over u in place), the inverse stages
// and the rows out, with nothing in global memory between. At D = 512, 16
// rows of u are 66 KB, 134 KB with the second buffer: one block a SM. K7 at T > 16 takes one coherence block a block in
// sub-tiles of 16 rows and two sweeps: the first keeps only each sub-tile's
// logits (at most 64 x 128 x 4 B = 32 KB), the pooled softmax runs, and
// the second re-reads x and recomputes the forward transform (cheap beside
// the products) before the combine and the inverse. A cluster sharing u in
// distributed shared memory was the alternative; u of a 64-row block at D =
// 672 is 344 KB, more than two blocks' buffers, and the recompute costs one
// more read of the rows.
//
// Bound on an H100 (D = 512, K = 16, N = 32768; `circ_kernels.circ_bound`):
// the rows read and written once, 0.27 GB, 0.080 ms at 3.35 TB/s, against
// the transforms as FFTs (1.5e9 fp32 operations) and the six bf16 products
// of 2 N (3D K + 4 K D) (2.25e10): bound by bytes. The dense wide form
// spent 8.25e11 tensor-core operations on its dense transforms and ~0.67
// GB on scratch between nine passes; this kernel has neither.
//
// K8 / K9 (the same bound, the inverse's operations and the rows out
// replaced by acc, m and den): at D = 512, K = 16 0.080 ms, bytes.
//
// Any N (a whole number of T-row blocks), d = d1 d2 with 2 <= d1, d2 <= 64
// and d <= 672, 1 <= K <= 128, 1 <= T <= 64.
//
// The transform's stages, the rows in and out, the split, the six-product
// step, the softmax and the logits' last sum are in circ_fact_common.cuh,
// which the multi-pilot K10 of mp_circ_fact_estimate.cu shares.
#include "circ_fact_common.cuh"

namespace {

using namespace circ_fact;

constexpr int kRows = 16;     // rows of a sub-tile

struct Params {
  const float2* x;
  float2* out;         // STATS: acc, in natural bin order
  float* m;            // STATS: m and den, a float a row
  float* den;
  const uint2* bl[3];  // logit B fragments (ks, nt, lane) of each plane
  const uint2* bc[3];  // combine B fragments (nt, ks, lane) of each plane
  const float* cst;
  const float2* tw;    // W_d1 (d1), W_d2 (d2), cross (dp, zero at pads)
  int n, d, k, kpad, t_coh, rows_cta, buf;  // buf: float2 a buffer
  float alpha;
  bool kron;           // the basis: the output order of STATS
  Transform tf;        // a row: d1 lines of ld2 = d2 | 1 slots, rs = dp
};

// rows [row0, row0 + rows) of x into buf (cp.async), waited for
__device__ void load_tile(float2* buf, const Params& p, int row0, int rows) {
  load_rows(buf, p.x + (size_t)row0 * p.d, p.d, rows, p.tf);
  cp_async_wait_all();
  __syncthreads();
}

// features f, f + 1 (f even) of row `row` of u: [u | |u|^2], zero past 3D
// and past the sub-tile's rows
__device__ __forceinline__ float2 feature_pair(const float2* u, int row,
                                               int rows, int f, int d) {
  if (row >= rows) return make_float2(0.f, 0.f);
  const float2* ur = u + row * d;
  if (f < 2 * d) return ur[f >> 1];
  const int b = f - 2 * d;
  float2 v = make_float2(0.f, 0.f);
  if (b < d) {
    const float2 a = ur[b];
    v.x = __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
  }
  if (b + 1 < d) {
    const float2 a = ur[b + 1];
    v.y = __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
  }
  return v;
}

// One warp's share of the sub-tile's logit product: TN n8 tiles of K from
// tile t0, every ksplit-th k16 step from kpart, each step's six products
// into a fresh accumulator and the steps in a compensated sum; the B
// fragments two steps ahead (a ring of two slots, each refilled once its
// products are issued). The sums and their lost parts go to `part`.
template <int TN>
__device__ void logit_part(const float2* u, float2* part, int rows,
                           const Params& p, int t0, int kpart, int ksplit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ntk = (p.k + 7) >> 3, ks_n = (3 * p.tf.dp + 15) >> 4;
  float sum[TN][4], lost[TN][4];
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[j][i] = lost[j][i] = 0.f;
  uint2 b[2][TN][3];
  const auto load_b = [&](int ks, uint2 (&dst)[TN][3]) {
    if (ks >= ks_n) return;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t fi = ((size_t)ks * ntk + t0 + j) * 32 + lane;
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) dst[j][pl] = __ldg(p.bl[pl] + fi);
    }
  };
  const auto step = [&](int ks, const uint2 (&bs)[TN][3]) {
    unsigned a[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = feature_pair(u, g + 8 * (e & 1), rows,
                                    16 * ks + 2 * q + 8 * (e >> 1), p.tf.dp);
      unsigned w[3];
      split3(v.x, v.y, w);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) a[pl][e] = w[pl];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float c[4];
      six(c, a, bs[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) kahan(sum[j][i], lost[j][i], c[i]);
    }
  };
  load_b(kpart, b[0]);
  load_b(kpart + ksplit, b[1]);
  for (int ks = kpart; ks < ks_n; ks += 2 * ksplit) {
    step(ks, b[0]);
    load_b(ks + 2 * ksplit, b[0]);
    if (ks + ksplit >= ks_n) break;
    step(ks + ksplit, b[1]);
    load_b(ks + 3 * ksplit, b[1]);
  }
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i >> 1), col = 8 * (t0 + j) + 2 * q + (i & 1);
      part[(kpart * kM + row) * p.kpad + col] =
          make_float2(sum[j][i], lost[j][i]);
    }
}

// The sub-tile's offset logits lg' into lg (rows x kpad): the 3 dp-deep
// product split over warps (a warp: a chunk of up to four n8 tiles of K
// and every ksplit-th k16 step, `logit_part`), the partial sums in `part`,
// then a warp a row: their compensated sum with const, the row's offset,
// lg' (and, where offs is given, each row's offset into it).
__device__ void logits(const float2* u, float2* part, float* lg, int rows,
                       const Params& p, float* offs) {
  const int warp = threadIdx.x >> 5;
  const int ntk = (p.k + 7) >> 3, nch = (ntk + 3) >> 2, ksplit = kWarps / nch;
  const int chunk = warp % nch, kpart = warp / nch;
  const int t0 = chunk * 4, tn = min(4, ntk - t0);
  if (kpart < ksplit) {
    switch (tn) {
      case 1: logit_part<1>(u, part, rows, p, t0, kpart, ksplit); break;
      case 2: logit_part<2>(u, part, rows, p, t0, kpart, ksplit); break;
      case 3: logit_part<3>(u, part, rows, p, t0, kpart, ksplit); break;
      default: logit_part<4>(u, part, rows, p, t0, kpart, ksplit); break;
    }
  }
  __syncthreads();
  reduce_logits(part, lg, rows, kM, ksplit, p.k, p.kpad, p.cst, offs);
}

// the sub-tile's weights (rows x kpad in lg) as A fragments of three
// planes, [plane][k16 step][lane] of four registers
__device__ void weight_planes(const float* lg, uint4* wpl, int rows,
                              const Params& p) {
  const int ksw = (p.k + 15) >> 4;
  for (int it = threadIdx.x; it < ksw * 32; it += kThreads) {
    const int ks = it >> 5, lane = it & 31, g = lane >> 2, q = lane & 3;
    unsigned a[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1), kk = 16 * ks + 2 * q + 8 * (e >> 1);
      const bool live = row < rows;
      const float v0 = live && kk < p.k ? lg[row * p.kpad + kk] : 0.f;
      const float v1 = live && kk + 1 < p.k ? lg[row * p.kpad + kk + 1] : 0.f;
      unsigned w[3];
      split3(v0, v1, w);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) a[pl][e] = w[pl];
    }
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      wpl[(pl * ksw + ks) * 32 + lane] =
          make_uint4(a[pl][0], a[pl][1], a[pl][2], a[pl][3]);
  }
}

// h = w bias + (w filt) u per bin over u in place: a warp takes the n8
// tiles of the 4D combine columns (two bins a tile: [br, bi, fr, fi]
// each) kB at a time, their B fragments loaded together before the
// products, the K-deep product's k16 steps in a compensated sum; the lane
// pair holding a bin's bias and filter meets by a shuffle.
__device__ void combine(float2* u, const uint4* wpl, int rows,
                        const Params& p) {
  constexpr int kB = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ksw = (p.k + 15) >> 4, ntc = (4 * p.tf.dp + 7) >> 3;
  for (int t0 = warp; t0 < ntc; t0 += kWarps * kB) {
    float sum[kB][4], lost[kB][4];
#pragma unroll
    for (int j = 0; j < kB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[j][i] = lost[j][i] = 0.f;
    for (int ks = 0; ks < ksw; ++ks) {
      uint2 b[kB][3];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int t = min(t0 + j * kWarps, ntc - 1);
        const size_t fi = ((size_t)t * ksw + ks) * 32 + lane;
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) b[j][pl] = __ldg(p.bc[pl] + fi);
      }
      unsigned a[3][4];
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        const uint4 v = wpl[(pl * ksw + ks) * 32 + lane];
        a[pl][0] = v.x;
        a[pl][1] = v.y;
        a[pl][2] = v.z;
        a[pl][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        float c[4];
        six(c, a, b[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) kahan(sum[j][i], lost[j][i], c[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int t = t0 + j * kWarps;
      float v[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = sum[j][i] - lost[j][i];
        o[i] = __shfl_xor_sync(0xffffffffu, v[i], 1);
      }
      const int bin = 2 * t + (q >> 1);
      if ((q & 1) != 0 || t >= ntc || bin >= p.tf.dp) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (row >= rows) continue;
        // this lane: bias (v), its pair: filter (o)
        const float br = v[2 * r], bi = v[2 * r + 1];
        const float fr = o[2 * r], fi = o[2 * r + 1];
        float2* at = u + row * p.tf.dp + bin;
        const float2 uu = *at;
        *at = make_float2(br + fr * uu.x - fi * uu.y,
                          bi + fr * uu.y + fi * uu.x);
      }
    }
  }
}

// K6 / K7, or (STATS) K8 / K9: the same kernel, which keeps each row's
// offset, runs the stats softmax and writes (m, den, acc) in place of the
// normalisation, the inverse and the rows out.
template <bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
    circ_fact_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + p.buf;
  float* lg = reinterpret_cast<float*>(buf1 + p.buf);
  float2* tw = reinterpret_cast<float2*>(lg + p.rows_cta * p.kpad);
  const int n_tw = p.tf.d1 + p.tf.d2 + p.tf.dp;
  float* offs = STATS ? reinterpret_cast<float*>(tw + n_tw) : nullptr;
  for (int i = threadIdx.x; i < n_tw; i += kThreads) tw[i] = p.tw[i];

  const int row0 = blockIdx.x * p.rows_cta;
  const int rows_here = min(p.rows_cta, p.n - row0);
  const int n_sub = (rows_here + kRows - 1) / kRows;
  float2* cur = buf0;
  float2* oth = buf1;
  __syncthreads();
  // sweep 1: the logits of every sub-tile
  for (int s = 0; s < n_sub; ++s) {
    const int rows = min(kRows, rows_here - s * kRows);
    load_tile(cur, p, row0 + s * kRows, rows);
    transform<false, kRows>(cur, oth, rows, p.tf, tw);
    zero_pads(cur, rows, p.tf.dp, p.tf);
    __syncthreads();
    logits(cur, oth, lg + s * kRows * p.kpad, rows, p,
           STATS ? offs + s * kRows : nullptr);
    __syncthreads();
  }
  softmax_rows<STATS>(lg, rows_here, p.k, p.kpad, p.t_coh, p.alpha, offs,
                      STATS ? p.m + row0 : nullptr,
                      STATS ? p.den + row0 : nullptr);
  __syncthreads();
  // sweep 2: the combine and the inverse of every sub-tile (u recomputed
  // where the block holds more than one); STATS: the combine's acc out
  for (int s = 0; s < n_sub; ++s) {
    const int rows = min(kRows, rows_here - s * kRows);
    if (n_sub > 1) {
      load_tile(cur, p, row0 + s * kRows, rows);
      transform<false, kRows>(cur, oth, rows, p.tf, tw);
      zero_pads(cur, rows, p.tf.dp, p.tf);
    }
    weight_planes(lg + s * kRows * p.kpad, reinterpret_cast<uint4*>(oth), rows,
                  p);
    __syncthreads();
    combine(cur, reinterpret_cast<const uint4*>(oth), rows, p);
    __syncthreads();
    float2* dst = p.out + (size_t)(row0 + s * kRows) * p.d;
    if (STATS) {
      store_natural(cur, dst, p.d, rows, p.tf, p.kron);
    } else {
      transform<true, kRows>(cur, oth, rows, p.tf, tw);
      store_rows(cur, dst, p.d, rows, p.tf);
    }
    __syncthreads();
  }
}

int rows_cta(int t_coh) {
  return t_coh <= kRows ? kRows / t_coh * t_coh : t_coh;
}

// float2 slots of each of the two row buffers: a sub-tile's rows, the
// logit's partial sums, or the weights' planes
long long buffer_slots(int dp, int k) {
  const int kpad = (k + 7) / 8 * 8;
  const int ntk = (k + 7) / 8, nch = (ntk + 3) / 4, ksplit = kWarps / nch;
  long long buf = (long long)kRows * dp;
  buf = std::max(buf, (long long)ksplit * kM * kpad);
  buf = std::max(buf, 3LL * ((k + 15) / 16) * 32 * 2);
  return (buf + 1) / 2 * 2;  // 16 bytes
}

// Units (uint2: a lane's four bf16 of one B fragment) of each plane of the
// bank's operands (`circ_kernels.circ_fact_operands`) over the dp =
// d1 (d2 | 1) slots of a row: the logit's ceil(3 dp / 16) x ceil(k / 8)
// fragments, then the combine's ceil(4 dp / 8) x ceil(k / 16), 32 lanes
// each.
long long circ_fact_units(int d1, int d2, int k) {
  const long long dp = padded(d1, d2);
  return 32LL * ((3 * dp + 15) / 16 * ((k + 7) / 8) +
                 (4 * dp + 7) / 8 * ((k + 15) / 16));
}

// Shared memory of one block, bytes (STATS: the rows' offsets too); 0 past
// the card's.
int circ_fact_smem(int d1, int d2, int k, int t_coh, bool stats) {
  const int dp = padded(d1, d2), kpad = (k + 7) / 8 * 8;
  const long long bytes = 16 * buffer_slots(dp, k) +
                          4LL * rows_cta(t_coh) * kpad + 8LL * (d1 + d2 + dp) +
                          (stats ? 4LL * rows_cta(t_coh) : 0);
  return bytes > kSmemMax ? 0 : (int)bytes;
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K6 (t_coh = 1) and K7 (t_coh > 1), or with stats != 0 K8 / K9: x (n, 2d)
// and out (n, 2d) interleaved [re, im] pairs (stats: out the DFT-domain
// accumulator in natural bin order, m_out and den_out (n), neither null);
// hi, lo, lo2 the bank's `units` units a plane
// (`circ_kernels.circ_fact_operands`, 8-byte aligned); cst (k_comp) the
// layout's constants; tw the (d1 + d2 + dp) complex twiddles (the cross
// twiddle over the padded slots); kron != 0 for the kron(F_d1, F_d2)
// basis. d = d1 d2, 2 <= d1, d2 <= 64, d <= 672, n a whole number of
// t_coh-row blocks, 1 <= t_coh <= 64, 1 <= k_comp <= 128.
extern "C" int circ_fact_launch(const float* x, const void* hi, const void* lo,
                                const void* lo2, const float* cst,
                                const float* tw, float* out, float* m_out,
                                float* den_out, int n, int d, int d1, int d2,
                                int k_comp, long long units, int t_coh,
                                float alpha, int stats, int kron,
                                void* stream) {
  if (n < 0 || d < 1 || d > kMaxD || d1 < 2 || d2 < 2 || d1 > kMaxN ||
      d2 > kMaxN || d1 * d2 != d || k_comp < 1 || k_comp > kMaxK ||
      t_coh < 1 || t_coh > kMaxT || n % t_coh != 0 ||
      (stats && (m_out == nullptr || den_out == nullptr)) ||
      units != circ_fact_units(d1, d2, k_comp))
    return (int)cudaErrorInvalidValue;
  const void* aligned[7] = {x, hi, lo, lo2, tw, out, cst};
  for (const void* ptr : aligned)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 8 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const int smem = circ_fact_smem(d1, d2, k_comp, t_coh, stats != 0);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = reinterpret_cast<const float2*>(x);
  p.out = reinterpret_cast<float2*>(out);
  p.m = m_out;
  p.den = den_out;
  if (!make_transform(d1, d2, padded(d1, d2), p.tf))
    return (int)cudaErrorInvalidValue;
  const long long lunits =
      32LL * ((3LL * p.tf.dp + 15) / 16) * ((k_comp + 7) / 8);
  const void* planes[3] = {hi, lo, lo2};
  for (int pl = 0; pl < 3; ++pl) {
    p.bl[pl] = static_cast<const uint2*>(planes[pl]);
    p.bc[pl] = p.bl[pl] + lunits;
  }
  p.cst = cst;
  p.tw = reinterpret_cast<const float2*>(tw);
  p.n = n;
  p.d = d;
  p.k = k_comp;
  p.kpad = (k_comp + 7) / 8 * 8;
  p.t_coh = t_coh;
  p.rows_cta = rows_cta(t_coh);
  p.alpha = alpha;
  p.kron = kron != 0;
  p.buf = (int)buffer_slots(p.tf.dp, k_comp);
  const auto kernel = stats ? circ_fact_kernel<true> : circ_fact_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + p.rows_cta - 1) / p.rows_cta;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
