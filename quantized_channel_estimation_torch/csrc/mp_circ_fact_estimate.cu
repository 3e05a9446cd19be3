// The multi-pilot circulant (FFT-domain) estimation kernel K10, flat and
// coherent, with a factorised transform, for Hopper: one fused kernel a
// tile of rows, the P pilots' rows in and the finished estimate out, the P
// transforms and every other intermediate on chip.
//
// Replaces, past the narrow template's rule (csrc/mp_circ_estimate.cu)
// wherever the transform splits into two factors of at most 64
// (`circ_kernels.circ_fact_blocks`), the tile fits a block's shared memory
// and this kernel was measured faster than the dense wide form
// (`mp_circ_kernels.mp_circ_fact_eligible`), the TPU kernel of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py that the
// JAX package runs there (models/structured_bank.py:829-837 flat,
// :897-904 coherent): `_mp_circ_kernel` (:1505, pallas_call in
// `estimate_mp_circ_packed` :1555, :1578). The other wide shapes keep the
// dense wide form (`mp_circ_wide_launch`, circ_wide_estimate.cu). Per row
// of P pilot segments x_1 .. x_P (D complex values each, interleaved [re,
// im] pairs, pilot-major) and component k:
//
//   u_p   = F x_p                          P forward transforms, factorised
//   lg_k  = [u_p | |u_p|^2 | v_pq] lcoef + const   F = D (3P + P (P-1)),
//                                          v_pq = conj(u_p) u_q (p < q)
//   w_k   = softmax_k(lg'_k)               coherent: lg' = lg + a (s - lg),
//                                          s the sum over the row's block
//   h     = c_bias + sum_p c_filt_p u_p    c = w comb, per bin, P + 1 slabs
//   out   = F^H h                          inverse, factorised
//
// The transforms are K6's (circ_fact_common.cuh): D = d1 d2 as Stockham
// stages in shared memory, the bins left at position p d2 + q
// (`circ_kernels.circ_fact_perm`) and the bank's per-bin rows and columns
// permuted on the host to match (`mp_circ_kernels.mp_circ_fact_operands`).
// A tile of R = 16 or 32 rows (MT = R / 16 mma row tiles; 32 where the
// buffers fit) keeps P regions of R rows, rows rs = 8 nsb + 4 float2 apart
// (nsb = ceil(dp / 8) blocks of 8 slots; rs = 4 mod 16, so the four rows a
// half-warp reads at one slot fall on distinct banks), u_1 .. u_P, and
// after them a scratch: the Stockham stages' second buffer, the logit's
// partial sums, the weights' planes. Pilot p's rows arrive by cp.async in
// region p and its stages ping-pong with the scratch; where a transform
// has an odd number of stages, pilot p arrives one region up and ends in
// region p, the region it left being the next pilot's second buffer.
//
// The logit. Its features are never stored: each k16 step's A fragment is
// formed from the u regions in registers and split into three bf16 planes.
// The steps walk the row's 8-slot blocks; block j's S = P + P (P-1) / 2 +
// ceil(P / 2) steps are u_1 .. u_P (16 values: slot 8j + i at columns 2i,
// 2i + 1 for i < 4 and 8 + 2(i - 4), 9 + 2(i - 4) above, [re, im]), the
// pairs v_pq in row-major order (the same columns), and |u_p|^2 two pilots
// a step (columns 0-7 pilot 2i, 8-15 pilot 2i + 1, column 2c + e of each
// half slot 8j + c + 4e), so that a lane of an mma tile reads the slots 8j
// + (lane mod 4) and + 4 of each row it holds for every step of the block.
// The bank's logit operand is laid out in that order. The B fragments come
// from L2 two steps ahead, each reused by the MT row tiles; the steps are
// split over warps (chunks of up to 4 n8 tiles of K at MT = 1, 2 at MT =
// 2, and every ksplit-th step), each step's six products into a fresh
// accumulator and the steps in a compensated sum, the warps' partial sums
// meeting in the scratch in a compensated sum with const. The offset rule,
// the softmax and the coherent pool in float64 are K6's.
//
// The combine. The bank's P + 1 slabs lie as n8 tiles of 4 slots of one
// slab ([re, im] of slots 4j .. 4j + 3, per bin permuted like the logit's
// rows), the tiles of group j consecutive, bias first: a warp takes a
// group, the products of up to three slabs a pass over K's k16 steps
// (fresh accumulators, compensated sum), and each lane holds its slot's
// c_bias, c_filt_p of the rows it owns: h = c_bias + sum_p c_filt_p u_p in
// registers, written over u_1, whose inverse transform goes out.
//
// Coherent blocks of T <= R rows run in one sweep (whole blocks a tile);
// T > R rows a block in sub-tiles of R rows and two sweeps: the first keeps
// the logits, the pooled softmax runs, the second reloads the rows and
// recomputes the P forward transforms before the combine and the inverse.
//
// Bound on an H100 (D = 256, K = 32, P = 2, N = 65536;
// `mp_circ_kernels.mp_circ_bound`): the six bf16 products of 2 N (F K + (P
// + 1) K 2D) (9.0e10) and the transforms as FFTs with the epilogue (2.5e9
// fp32): bound by operations, 0.128 ms. The dense wide form spends its
// 0.72 ms bound on (2D, 2D) transform products and passes u, the features,
// the logits and h through global memory.
//
// Any N (a whole number of T-row blocks), d = d1 d2 with 2 <= d1, d2 <= 64
// and d <= 672, 1 <= P <= 16, 1 <= K <= 128, 1 <= T <= 64, where the
// tile's buffers fit (`mp_circ_fact_plan`).
#include "circ_fact_common.cuh"

namespace {

using namespace circ_fact;

constexpr int kMaxP = 16;
constexpr int kSlabs = 3;     // combine slabs a pass

enum StepKind { kU = 0, kV = 1, kSq = 2 };

struct Params {
  const float2* x;     // (n, P, D) complex
  float2* out;         // (n, D) complex
  const uint2* bl[3];  // logit B fragments (ks, nt, lane) of each plane
  const uint2* bc[3];  // combine B fragments (nt, ks, lane) of each plane
  const float* cst;
  const float2* tw;    // W_d1 (d1), W_d2 (d2), cross (dp, zero at pads)
  int n, d, np, k, kpad, t_coh, rows_cta, region;  // region: float2 a u
  int scratch;         // float2 of the scratch
  int nsb, nstep, ng;  // 8-slot blocks, k16 steps a block, 4-slot groups
  int odd;             // the transform has an odd number of stages
  float alpha;
  Transform tf;        // a row: d1 lines of ld2 = d2 | 1 slots, rs apart
};

// the P pilots' rows [row0, row0 + rows) into regions odd .. P - 1 + odd
// (cp.async), waited for
__device__ void load_pilots(float2* base, const Params& p, int row0,
                            int rows) {
  const long long stride = (long long)p.np * p.d;
  for (int pi = 0; pi < p.np; ++pi)
    load_rows(base + (pi + p.odd) * p.region, p.x + row0 * stride + pi * p.d,
              stride, rows, p.tf);
  cp_async_wait_all();
  __syncthreads();
}

// the P forward transforms into regions 0 .. P - 1 (where the stage count
// is odd, pilot p from region p + 1 with region p as its second buffer;
// else with the scratch) and their pads zeroed
template <int R>
__device__ void forward(float2* base, const Params& p, int rows,
                        const float2* tw) {
  for (int pi = 0; pi < p.np; ++pi) {
    float2* cur = base + (pi + p.odd) * p.region;
    float2* oth = base + (p.odd ? pi : p.np) * p.region;
    transform<false, R>(cur, oth, rows, p.tf, tw);
  }
  for (int pi = 0; pi < p.np; ++pi)
    zero_pads(base + pi * p.region, rows, 8 * p.nsb, p.tf);
  __syncthreads();
}

// The A fragment (three planes) of one k16 step of 8-slot block j for the
// mma row tile at `row0` (see the layout above); zero past `rows`.
__device__ __forceinline__ void a_step(const float2* base, int code, int j,
                                       int row0, int rows, const Params& p,
                                       unsigned (&a)[3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int kind = code & 255, pa = (code >> 8) & 255, pb = code >> 16;
  const int rs = p.tf.rs, s0 = 8 * j + q;
  const float2* ua = base + pa * p.region;
  const float2* ub = pb < p.np ? base + pb * p.region : nullptr;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + g + 8 * (e & 1), h = e >> 1;
    float v0 = 0.f, v1 = 0.f;
    if (row < rows) {
      if (kind == kU) {
        const float2 x = ua[row * rs + s0 + 4 * h];
        v0 = x.x;
        v1 = x.y;
      } else if (kind == kV) {
        const float2 x = ua[row * rs + s0 + 4 * h];
        const float2 y = ub[row * rs + s0 + 4 * h];
        v0 = __fadd_rn(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y));
        v1 = __fsub_rn(__fmul_rn(x.x, y.y), __fmul_rn(x.y, y.x));
      } else {
        const float2* u = h ? ub : ua;
        if (u != nullptr) {
          const float2 x0 = u[row * rs + s0], x1 = u[row * rs + s0 + 4];
          v0 = __fadd_rn(__fmul_rn(x0.x, x0.x), __fmul_rn(x0.y, x0.y));
          v1 = __fadd_rn(__fmul_rn(x1.x, x1.x), __fmul_rn(x1.y, x1.y));
        }
      }
    }
    unsigned w[3];
    split3(v0, v1, w);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) a[pl][e] = w[pl];
  }
}

// One warp's share of the sub-tile's logit product: TN n8 tiles of K from
// tile t0, every ksplit-th k16 step from kpart, each step's six products
// into a fresh accumulator for each of the MT row tiles and the steps in a
// compensated sum; the B fragments two steps ahead (a ring of two slots,
// each refilled once its products are issued). The sums and their lost
// parts go to `part` (ksplit blocks of 16 MT rows x kpad).
template <int MT, int TN>
__device__ void logit_part(const float2* base, const int* steps,
                           float2* part, int rows, const Params& p, int t0,
                           int kpart, int ksplit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ntk = (p.k + 7) >> 3, ks_n = p.nsb * p.nstep;
  float sum[MT][TN][4], lost[MT][TN][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mi][j][i] = lost[mi][j][i] = 0.f;
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
    const int j = ks / p.nstep, code = steps[ks - j * p.nstep];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      unsigned a[3][4];
      a_step(base, code, j, kM * mi, rows, p, a);
#pragma unroll
      for (int jt = 0; jt < TN; ++jt) {
        float c[4];
        six(c, a, bs[jt]);
#pragma unroll
        for (int i = 0; i < 4; ++i) kahan(sum[mi][jt][i], lost[mi][jt][i], c[i]);
      }
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
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = kM * mi + g + 8 * (i >> 1);
        const int col = 8 * (t0 + j) + 2 * q + (i & 1);
        part[(kpart * kM * MT + row) * p.kpad + col] =
            make_float2(sum[mi][j][i], lost[mi][j][i]);
      }
}

// n8 tiles of K a warp takes at once in the logit
template <int MT>
__host__ __device__ constexpr int logit_tiles() {
  return MT == 1 ? 4 : 2;
}

// The sub-tile's offset logits lg' into lg (rows x kpad): the product over
// the F features split over warps (`logit_part`), then their partial sums
// with const (`reduce_logits`).
template <int MT>
__device__ void logits(const float2* base, const int* steps, float2* part,
                       float* lg, int rows, const Params& p) {
  constexpr int kTn = logit_tiles<MT>();
  const int warp = threadIdx.x >> 5;
  const int ntk = (p.k + 7) >> 3, nch = (ntk + kTn - 1) / kTn;
  const int ksplit = kWarps / nch;
  const int chunk = warp % nch, kpart = warp / nch;
  const int t0 = chunk * kTn, tn = min(kTn, ntk - t0);
  if (kpart < ksplit) {
    if constexpr (MT == 1) {
      switch (tn) {
        case 1: logit_part<MT, 1>(base, steps, part, rows, p, t0, kpart, ksplit); break;
        case 2: logit_part<MT, 2>(base, steps, part, rows, p, t0, kpart, ksplit); break;
        case 3: logit_part<MT, 3>(base, steps, part, rows, p, t0, kpart, ksplit); break;
        default: logit_part<MT, logit_tiles<MT>()>(base, steps, part, rows, p, t0, kpart, ksplit); break;
      }
    } else {
      if (tn == 1)
        logit_part<MT, 1>(base, steps, part, rows, p, t0, kpart, ksplit);
      else
        logit_part<MT, logit_tiles<MT>()>(base, steps, part, rows, p, t0, kpart, ksplit);
    }
  }
  __syncthreads();
  reduce_logits(part, lg, rows, kM * MT, ksplit, p.k, p.kpad, p.cst);
}

// the sub-tile's weights (rows x kpad in lg) as A fragments of three
// planes, [row tile][plane][k16 step][lane] of four registers
template <int MT>
__device__ void weight_planes(const float* lg, uint4* wpl, int rows,
                              const Params& p) {
  const int ksw = (p.k + 15) >> 4;
  for (int it = threadIdx.x; it < MT * ksw * 32; it += kThreads) {
    const int mi = it / (ksw * 32), rest = it - mi * ksw * 32;
    const int ks = rest >> 5, lane = rest & 31, g = lane >> 2, q = lane & 3;
    unsigned a[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = kM * mi + g + 8 * (e & 1);
      const int kk = 16 * ks + 2 * q + 8 * (e >> 1);
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
      wpl[((mi * 3 + pl) * ksw + ks) * 32 + lane] =
          make_uint4(a[pl][0], a[pl][1], a[pl][2], a[pl][3]);
  }
}

// h = c_bias + sum_p c_filt_p u_p over u_1 in place: a warp takes the
// 4-slot groups in turn; of a group, the P + 1 slabs' n8 tiles up to
// kSlabs a pass, their B fragments of a k16 step loaded together before
// the products, the K-deep product's steps in a compensated sum for each
// row tile; lane (g, q) holds slot 4j + q of rows g and g + 8 of each tile.
template <int MT>
__device__ void combine(float2* base, const uint4* wpl, int rows,
                        const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, rs = p.tf.rs;
  const int ksw = (p.k + 15) >> 4, nsl = p.np + 1;
  for (int jg = warp; jg < p.ng; jg += kWarps) {
    const int slot = 4 * jg + q;
    float2 h[MT][2];
    for (int s0 = 0; s0 < nsl; s0 += kSlabs) {
      const int ns = min(kSlabs, nsl - s0);
      float sum[kSlabs][MT][4], lost[kSlabs][MT][4];
#pragma unroll
      for (int sj = 0; sj < kSlabs; ++sj)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum[sj][mi][i] = lost[sj][mi][i] = 0.f;
      for (int ks = 0; ks < ksw; ++ks) {
        uint2 b[kSlabs][3];
#pragma unroll
        for (int sj = 0; sj < kSlabs; ++sj) {
          const int t = jg * nsl + s0 + min(sj, ns - 1);
          const size_t fi = ((size_t)t * ksw + ks) * 32 + lane;
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) b[sj][pl] = __ldg(p.bc[pl] + fi);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          unsigned a[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) {
            const uint4 v = wpl[((mi * 3 + pl) * ksw + ks) * 32 + lane];
            a[pl][0] = v.x;
            a[pl][1] = v.y;
            a[pl][2] = v.z;
            a[pl][3] = v.w;
          }
#pragma unroll
          for (int sj = 0; sj < kSlabs; ++sj) {
            if (sj >= ns) break;
            float c[4];
            six(c, a, b[sj]);
#pragma unroll
            for (int i = 0; i < 4; ++i) kahan(sum[sj][mi][i], lost[sj][mi][i], c[i]);
          }
        }
      }
#pragma unroll
      for (int sj = 0; sj < kSlabs; ++sj) {
        if (sj >= ns) break;
        const int s = s0 + sj;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float cr = sum[sj][mi][2 * r] - lost[sj][mi][2 * r];
            const float ci = sum[sj][mi][2 * r + 1] - lost[sj][mi][2 * r + 1];
            if (s == 0) {
              h[mi][r] = make_float2(cr, ci);
            } else {
              const int row = kM * mi + g + 8 * r;
              const float2 u = row < rows
                                   ? base[(s - 1) * p.region + row * rs + slot]
                                   : make_float2(0.f, 0.f);
              h[mi][r].x += cr * u.x - ci * u.y;
              h[mi][r].y += cr * u.y + ci * u.x;
            }
          }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kM * mi + g + 8 * r;
        if (row < rows) base[row * rs + slot] = h[mi][r];
      }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    mp_circ_fact_kernel(const Params p) {
  constexpr int R = kM * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* base = reinterpret_cast<float2*>(smem_raw);
  float2* scratch = base + p.np * p.region;
  float* lg = reinterpret_cast<float*>(scratch + p.scratch);
  float2* tw = reinterpret_cast<float2*>(lg + p.rows_cta * p.kpad);
  const int n_tw = p.tf.d1 + p.tf.d2 + p.tf.dp;
  int* steps = reinterpret_cast<int*>(tw + n_tw);
  for (int i = threadIdx.x; i < n_tw; i += kThreads) tw[i] = p.tw[i];
  const int np = p.np, npairs = np * (np - 1) / 2;
  for (int s = threadIdx.x; s < p.nstep; s += kThreads) {
    int code;
    if (s < np) {
      code = kU | s << 8 | s << 16;
    } else if (s < np + npairs) {
      int i = s - np, a = 0;
      while (i >= np - 1 - a) i -= np - 1 - a, ++a;
      code = kV | a << 8 | (a + 1 + i) << 16;
    } else {
      const int a = 2 * (s - np - npairs);
      code = kSq | a << 8 | (a + 1) << 16;
    }
    steps[s] = code;
  }

  const int row0 = blockIdx.x * p.rows_cta;
  const int rows_here = min(p.rows_cta, p.n - row0);
  const int n_sub = (rows_here + R - 1) / R;
  __syncthreads();
  // sweep 1: the logits of every sub-tile
  for (int s = 0; s < n_sub; ++s) {
    const int rows = min(R, rows_here - s * R);
    load_pilots(base, p, row0 + s * R, rows);
    forward<R>(base, p, rows, tw);
    logits<MT>(base, steps, scratch, lg + s * R * p.kpad, rows, p);
    __syncthreads();
  }
  softmax_rows(lg, rows_here, p.k, p.kpad, p.t_coh, p.alpha);
  __syncthreads();
  // sweep 2: the combine and the inverse of every sub-tile (the P
  // transforms recomputed where the block holds more than one)
  for (int s = 0; s < n_sub; ++s) {
    const int rows = min(R, rows_here - s * R);
    if (n_sub > 1) {
      load_pilots(base, p, row0 + s * R, rows);
      forward<R>(base, p, rows, tw);
    }
    weight_planes<MT>(lg + s * R * p.kpad, reinterpret_cast<uint4*>(scratch),
                      rows, p);
    __syncthreads();
    combine<MT>(base, reinterpret_cast<const uint4*>(scratch), rows, p);
    __syncthreads();
    float2* cur = base;
    float2* oth = scratch;
    transform<true, R>(cur, oth, rows, p.tf, tw);
    store_rows(cur, p.out + (size_t)(row0 + s * R) * p.d, p.d, rows, p.tf);
    __syncthreads();
  }
}

int rows_cta(int t_coh, int mt) {
  const int r = kM * mt;
  return t_coh <= r ? r / t_coh * t_coh : t_coh;
}

int nstep(int np) { return np + np * (np - 1) / 2 + (np + 1) / 2; }

// float2 from one row of a region to the next: every 8-slot block, 4 mod 16
int row_stride(int dp) { return 8 * ((dp + 7) / 8) + 4; }

// float2 of each pilot's region: R rows of u (16 bytes whole)
long long region_slots(int dp, int mt) {
  return ((long long)kM * mt * row_stride(dp) + 1) / 2 * 2;
}

// float2 of the scratch: a region, the logit's partial sums of its warps,
// or the weights' planes (16 bytes whole)
long long scratch_slots(int dp, int k, int mt) {
  const int kpad = (k + 7) / 8 * 8, ntk = (k + 7) / 8;
  const int tn = mt == 1 ? logit_tiles<1>() : logit_tiles<2>();
  const int nch = (ntk + tn - 1) / tn, ksplit = kWarps / nch;
  long long buf = region_slots(dp, mt);
  buf = std::max(buf, (long long)ksplit * kM * mt * kpad);
  buf = std::max(buf, 3LL * mt * ((k + 15) / 16) * 32 * 2);
  return (buf + 1) / 2 * 2;
}

// Shared memory of one block at MT row tiles, bytes; 0 past the card's.
long long smem_bytes(int d1, int d2, int np, int k, int t_coh, int mt) {
  const int dp = padded(d1, d2), kpad = (k + 7) / 8 * 8;
  const long long bytes =
      8LL * (np * region_slots(dp, mt) + scratch_slots(dp, k, mt)) +
      4LL * rows_cta(t_coh, mt) * kpad + 8LL * (d1 + d2 + dp) +
      4LL * nstep(np);
  return bytes > kSmemMax ? 0 : bytes;
}

// Units (uint2: a lane's four bf16 of one B fragment) of each plane of the
// bank's operands (`mp_circ_kernels.mp_circ_fact_operands`): the logit's
// nsb S k16 steps x ceil(k / 8) n8 tiles, then the combine's ng (P + 1)
// n8 tiles x ceil(k / 16) k16 steps, 32 lanes each.
long long mp_circ_fact_units(int d1, int d2, int np, int k) {
  const long long dp = padded(d1, d2);
  return 32LL * ((dp + 7) / 8 * nstep(np) * ((k + 7) / 8) +
                 (dp + 3) / 4 * (np + 1) * ((k + 15) / 16));
}

bool valid(int d, int d1, int d2, int np, int k, int t) {
  return d >= 1 && d <= kMaxD && d1 >= 2 && d2 >= 2 && d1 <= kMaxN &&
         d2 <= kMaxN && d1 * d2 == d && np >= 1 && np <= kMaxP && k >= 1 &&
         k <= kMaxK && t >= 1 && t <= kMaxT;
}

}  // namespace

// The tile the kernel takes at these widths: returns the shared memory of
// one block in bytes and sets *mt to its mma row tiles (2: 32 rows, where
// the buffers fit; else 1: 16 rows), or returns 0 where neither fits or
// the widths are out of range.
extern "C" long long mp_circ_fact_plan(int d1, int d2, int np, int k_comp,
                                       int t_coh, int* mt) {
  if (!valid(d1 * d2, d1, d2, np, k_comp, t_coh)) return 0;
  for (int m = 2; m >= 1; --m) {
    const long long bytes = smem_bytes(d1, d2, np, k_comp, t_coh, m);
    if (bytes > 0) {
      if (mt != nullptr) *mt = m;
      return bytes;
    }
  }
  return 0;
}

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K10 flat (t_coh = 1) and coherent (t_coh > 1): x (n, 2 P d) interleaved
// [re, im] pairs, pilot-major, and out (n, 2d); hi, lo, lo2 the bank's
// `units` units a plane (`mp_circ_kernels.mp_circ_fact_operands`, 8-byte
// aligned); cst (k_comp) the layout's constants; tw the (d1 + d2 + dp)
// complex twiddles (the cross twiddle over the padded slots). d = d1 d2,
// 2 <= d1, d2 <= 64, d <= 672, 1 <= np <= 16, n a whole number of
// t_coh-row blocks, 1 <= t_coh <= 64, 1 <= k_comp <= 128, where
// `mp_circ_fact_plan` finds a tile.
extern "C" int mp_circ_fact_launch(const float* x, const void* hi,
                                   const void* lo, const void* lo2,
                                   const float* cst, const float* tw,
                                   float* out, int n, int d, int d1, int d2,
                                   int np, int k_comp, long long units,
                                   int t_coh, float alpha, void* stream) {
  int mt = 0;
  if (n < 0 || !valid(d, d1, d2, np, k_comp, t_coh) || n % t_coh != 0 ||
      units != mp_circ_fact_units(d1, d2, np, k_comp))
    return (int)cudaErrorInvalidValue;
  const long long smem = mp_circ_fact_plan(d1, d2, np, k_comp, t_coh, &mt);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const void* aligned[7] = {x, hi, lo, lo2, tw, out, cst};
  for (const void* ptr : aligned)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 8 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  Params p{};
  p.x = reinterpret_cast<const float2*>(x);
  p.out = reinterpret_cast<float2*>(out);
  const int dp = padded(d1, d2);
  if (!make_transform(d1, d2, row_stride(dp), p.tf))
    return (int)cudaErrorInvalidValue;
  p.nsb = (dp + 7) / 8;
  p.nstep = nstep(np);
  p.ng = (dp + 3) / 4;
  p.odd = (p.tf.lv[0].nst + p.tf.lv[1].nst) % 2;
  const long long lunits = 32LL * p.nsb * p.nstep * ((k_comp + 7) / 8);
  const void* planes[3] = {hi, lo, lo2};
  for (int pl = 0; pl < 3; ++pl) {
    p.bl[pl] = static_cast<const uint2*>(planes[pl]);
    p.bc[pl] = p.bl[pl] + lunits;
  }
  p.cst = cst;
  p.tw = reinterpret_cast<const float2*>(tw);
  p.n = n;
  p.d = d;
  p.np = np;
  p.k = k_comp;
  p.kpad = (k_comp + 7) / 8 * 8;
  p.t_coh = t_coh;
  p.rows_cta = rows_cta(t_coh, mt);
  p.region = (int)region_slots(dp, mt);
  p.scratch = (int)scratch_slots(dp, k_comp, mt);
  p.alpha = alpha;
  const auto kernel = mt == 2 ? mp_circ_fact_kernel<2> : mp_circ_fact_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + p.rows_cta - 1) / p.rows_cta;
  kernel<<<blocks, kThreads, (int)smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
