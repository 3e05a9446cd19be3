// The wide form of the grouped online-softmax estimator for Hopper: K1,
// its coherent mode K3 and their split-K stats form K2 at every width past
// the wgmma stream of grouped_estimate.cu (2M or 2D > 256), up to 2M = 2048
// and any 2D.
//
// Replaces, at those widths, the TPU kernels that
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py runs there:
// `_estimate_kernel_block_grouped_stats` (:454, pallas_call :892), which
// `estimate_fused` (:1026) splits the bank into K-chunks for
// (`estimate_block_grouped_chunked` :963, `_stats_chunked` :934, merged by
// `merge_stats`), `estimate_fused_stats` (:982) and the coherent
// `_coherent_stats_merged` (:1076) run; and the whole-bank
// `_estimate_kernel_block_grouped` (:419, pallas_call :536) where a wide
// bank fits its VMEM budget. The function is that of grouped_estimate.cu
// (see grouped_tc_stream.cuh): per row of r2 = [Re r | Im r] (N x 2M) and
// component k, yz_k = r2 [P_k | W_k],
//
//   lg_nk = logw_k - |yz_k[:, :2M] - mu_k|^2     (K3: pooled over T rows)
//   h2_n  = sum_k softmax_k(lg_nk) (yz_k[:, 2M:] + b_k)
//
// or, STATS, the state m_n = max_k lg_nk, den_n = sum_k exp(lg_nk - m_n),
// acc_n = sum_k exp(lg_nk - m_n) (yz_k[:, 2M:] + b_k). Every product is
// the stream's six bf16 products of three-plane splits accumulated in
// fp32 on wgmma; everything after the products is fp32.
//
// Why a design of its own: the stream keeps each row's running output in
// registers (2D / 64 pieces of 32 floats a thread) and r2's three planes
// over the whole contraction in registers or shared memory. At 2D = 512
// the output alone is 256 registers a thread; at 2M = 512 r2's planes for
// 64 rows are 196 KB, and a ring stage of one piece's three B planes over
// Kp = 512 contraction rows another 196 KB, against 227 KB a block.
//
// Design: one launch of three kernels on the stream.
//   - the row split (`split_rows`, on wide_ring.cuh's `split_tiles`)
//     splits r2 into its three bf16 planes, laid out as the bank's B slabs
//     are: per 64-row tile and 64-wide contraction chunk one 8 KB run,
//     K-major in the 128-byte swizzle, padding rows and columns zero (a
//     tile holds floor(64 / T) whole blocks for K3);
//   - every product is cut along the contraction into 64-deep chunks on
//     wide_ring.cuh's ring: a stage holds one chunk of r2's three planes
//     for each of the two consumer warpgroups (48 KB) and the same chunk of
//     two pieces' three B planes (48 KB), copied by one producer thread
//     with cp.async.bulk; two stages (192 KB). A chunk of a piece is 6 x 4
//     wgmma m64n64k16 into fresh fp32 accumulators (the stream's order,
//     hi.hi last), added to the piece's sum over the chunks in fp32;
//   - pass 1 (`wide_kernel<1>`) streams each component's logit pieces, two
//     at a time, with hi.hi in an accumulator of its own, sums each
//     piece's squares |yz - mu|^2 as a tree a row and the pieces in a
//     compensated sum, pools (K3, the stream's `pool_logits`) and writes
//     each row's logits lg (N x K floats of scratch): K2's state before
//     the combine. The logit of a 512- to 2048-deep product is a sum of
//     hundreds of squares, each of them hundreds of products: one
//     accumulator for all six products over every chunk, and a running
//     sum of the squares, left the estimate up to 2.6x the plain float32
//     version's error against float64 (the float32 claim allows 2x); as
//     here, 0.6-1.1x (H100, 2M = 512 and 640);
//   - pass 2 (`wide_kernel<2>`) splits the value columns over the grid's
//     y: a block takes two value pieces (128 columns) of its rows, reads
//     their logits, m and den, and for each component folds p = exp(lg -
//     m) times (yz + b) of its two pieces into 64 registers a thread of
//     output. The value half is computed once; no piece is recomputed.
// Bound on an H100 (D = 256, K = 32, N = 32768, 2M = 2D = 512): six bf16
// products 6 x 2 N 2M (2M + 2D) K = 6.6e12 operations, 6.67 ms at 989
// TFLOP/s, plus 2 N K (2M + 2D) fp32 epilogue operations, 0.03 ms. Each
// 128-row block reads the bank's three planes once (100.7 MB) and its rows'
// planes once a piece pair; both come mostly from L2 when neighbouring
// blocks stream the same pieces.
//
// The top-k selection estimator at the same widths: K4 and its split-K
// stats form K5 (`grouped_wide_topk_launch`), where grouped_topk.cu stops
// (2M or 2D > 256). Replaces the TPU kernels `_grouped_stream_topk` +
// `_estimate_kernel_block_grouped_topk` (:568, :611, pallas_call :662)
// and `_estimate_kernel_block_grouped_topk_stats` (:677, pallas_call
// :725), which `estimate_fused_topk` runs on the whole bank or, past its
// VMEM budget, on K-chunks merged by `merge_topk` (`_topk_chunked` :790).
// Per row, with the logits above, the k_sel components of largest logit
// S_n (ties keep the lower index): K5 writes their logits, sorted
// descending, and candidates r2_n W_j + b_j; K4 combines them,
// h2_n = sum_{j in S_n} w_j (r2_n W_j + b_j) / sum w_j, w_j = exp(lg_nj -
// max_S lg) (k_sel = 1: the argmax component's candidate). The TPU kernel
// streams the whole [P | W] bank and bubbles k_sel live (tile, 2D)
// estimates a row through it; here pass 1 computes the logits alone, the
// picks are bucketed by component on the card (a counting sort: no host
// synchronisation), and a third pass multiplies only the picked rows by
// their W_j with the same six bf16 products (the top-k section below):
// k_sel / K of pass 2's value work. Bound on an H100 (D = 256, K = 32, N =
// 32768): the logits' six bf16 products 6 x 2 N 2M 2M K = 3.30e12 (3.34
// ms) plus k_sel x 6 x 2 N 2M 2D = 1.03e11 a slot (0.10 ms). Measured
// there (chip_smoke phase 3k, H100 80GB HBM3 at 700 W): K4 5.2-5.3 ms at
// k_sel = 1 and 6.1-6.4 at k_sel = 4, 60-66% of that bound (the passes'
// shares not measured).
// Any N and K, 2M <= 2048, any 2D; K3 any 2 <= T <= 64; K4 1 <= k_sel <=
// min(8, K), K5 1 <= k_sel <= 8.
#include "wide_ring.cuh"

namespace {

using namespace qce_tc;
using namespace qce_wide;

constexpr int kMaxTwoM = 2048;

// r2's rows as the row split reads them: row rr of tile i is r2's row i
// wg_rows + rr (padding past wg_rows or n); with `ent` (the top-k value
// pass, wg_rows = 64) r2's row ent[64 i + rr] / k_sel (padding where ent
// holds -1), and tiles whose pair `pair_comp` marks unused (-1) are not
// written.
struct GroupedRows {
  const float* r2;
  int n, two_m, wg_rows;
  const int* ent;
  int k_sel;
  const int* pair_comp;
  __device__ __forceinline__ bool skip(int tile) const {
    return ent != nullptr && __ldg(pair_comp + tile / kWgs) < 0;
  }
  __device__ __forceinline__ int row(int tile, int rr) const {
    if (ent != nullptr) {
      const int e = __ldg(ent + (size_t)tile * 64 + rr);
      return e >= 0 ? e / k_sel : -1;
    }
    const int r = tile * wg_rows + rr;
    return rr < wg_rows && r < n ? r : -1;
  }
  __device__ __forceinline__ float2 pair(int r, int col) const {
    return col < two_m  // 2M is even
               ? __ldg(reinterpret_cast<const float2*>(r2 + (size_t)r * two_m +
                                                        col))
               : make_float2(0.f, 0.f);
  }
};

struct WideArgs {
  const uint4* a;  // r2's planes (`split_rows`)
  const bf16* planes[3];
  const float* vec;
  const float* logw;
  float* lg;  // (n, k_comp) logits: pass 1 writes, pass 2 reads
  float* out;
  float* m_out;
  float* den_out;
  int n, k_comp, two_m, two_d, n_ch, tiles, wg_rows, t_coh;
  float alpha;
  size_t plane_units;
  // pass 3 (top-k values): the (row, slot) entry of each gathered row
  // (-1: padding) and the component of each block of two tiles (-1: none)
  const int* perm;
  const int* pair_comp;
};

// The components a block streams: every one, or in pass 3 its pair's.
template <int PASS>
__device__ __forceinline__ void block_components(const WideArgs& g, int& k0,
                                                 int& k1) {
  k0 = PASS == 3 ? __ldg(g.pair_comp + blockIdx.x) : 0;
  k1 = PASS == 3 ? k0 + 1 : g.k_comp;
}

// The pieces a block streams for each component: pass 1 the logit pieces
// [0, mp), passes 2 and 3 the two value pieces mp + 2 y, + 1 of its column
// slice.
template <int PASS>
__device__ __forceinline__ void block_pieces(const WideArgs& g, int& j0,
                                             int& j1) {
  const int mp = g.n_ch, pieces = g.n_ch + (g.two_d + kPiece - 1) / kPiece;
  j0 = PASS == 1 ? 0 : mp + kGroup * blockIdx.y;
  j1 = PASS == 1 ? mp : min(j0 + kGroup, pieces);
}

// The producer: one thread copies, for each component, piece pair and
// chunk, the chunk of both warpgroups' row planes and of the pieces' B
// planes into the ring.
template <int PASS>
__device__ void produce_wide(const WideArgs& g, WideRing ring) {
  int j0, j1, k0, k1;
  block_pieces<PASS>(g, j0, j1);
  block_components<PASS>(g, k0, k1);
  const int pieces = g.n_ch + (g.two_d + kPiece - 1) / kPiece;
  for (int k = k0; k < k1; ++k)
    for (int j = j0; j < j1; j += kGroup)
      for (int c = 0; c < g.n_ch; ++c)
        load_chunk(ring, g.a, g.plane_units, blockIdx.x, g.n_ch, c, g.planes,
                   k * pieces + j, min(kGroup, j1 - j));
}

// A chunk's partial products f of the live pieces into their sums over
// the chunks (`first`: the pieces' first chunk).
__device__ __forceinline__ void fold(float (&sum)[kGroup][32],
                                     const float (&f)[kGroup][32], int gn,
                                     bool first) {
#pragma unroll
  for (int gp = 0; gp < kGroup; ++gp) {
    if (gp >= gn) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sum[gp][i] = first ? f[gp][i] : sum[gp][i] + f[gp][i];
  }
}

// The kernel. Pass 1 writes the (pooled) logits lg; pass 2 the output
// columns of its slice (STATS: acc, and slice 0 m and den); pass 3 (the
// top-k values) r2_n W_j + b_j of its slice for the gathered rows of its
// pair's component j, at out row perm[row] (a (row, slot) entry).
template <int PASS, bool COH, bool STATS>
__global__ void __launch_bounds__(kThreads, 1) wide_kernel(WideArgs g) {
  if constexpr (PASS == 3) {
    if (__ldg(g.pair_comp + blockIdx.x) < 0) return;  // an unused pair
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideRing ring = ring_init(smem_raw);

  const int wg = threadIdx.x / kWg;
  if (wg == kWgs) {  // the producer warpgroup: one thread streams
    setmaxnreg_dec<40>();
    if (threadIdx.x == kWgs * kWg) produce_wide<PASS>(g, ring);
    return;
  }
  setmaxnreg_inc<232>();

  int j0, j1, k0, k1;
  block_pieces<PASS>(g, j0, j1);
  block_components<PASS>(g, k0, k1);
  const int pieces = g.n_ch + (g.two_d + kPiece - 1) / kPiece;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWgs + wg;
  int row[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row_in_wg() + 8 * r;
    if constexpr (PASS == 3) {  // a gathered row: its (row, slot) entry
      row[r] = __ldg(g.perm + (size_t)tile * 64 + rr);
      live[r] = row[r] >= 0;
    } else {
      row[r] = tile * g.wg_rows + rr;
      live[r] = rr < g.wg_rows && row[r] < g.n;
    }
  }

  // pass 2: the rows' softmax state from their logits
  float m[2] = {0.f, 0.f}, den[2] = {1.f, 1.f};
  float o[kGroup][32];
  if constexpr (PASS == 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const float* lr = g.lg + (size_t)row[r] * g.k_comp;
      float mx = -INFINITY;
      for (int k = 0; k < g.k_comp; ++k) mx = fmaxf(mx, __ldg(lr + k));
      float sum = 0.f;
      for (int k = 0; k < g.k_comp; ++k) sum += expf(__ldg(lr + k) - mx);
      m[r] = mx;
      den[r] = sum;
    }
  }
  if constexpr (PASS >= 2) {
#pragma unroll
    for (int gp = 0; gp < kGroup; ++gp)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[gp][i] = 0.f;
  }
  const Epi ep{g.logw, g.n_ch, pieces, g.t_coh, g.alpha, 0.f, ring.extra()};

  // a chunk's products: pass 1 the five small ones in acc and hi.hi in hh,
  // each fresh (the logits' accuracy, see the design note); pass 2 all
  // six in acc
  float acc[kGroup][32], hh[kGroup][32], sum[kGroup][32];
  for (int k = k0; k < k1; ++k) {
    // pass 1: the rows' quadratic terms, a compensated sum of the pieces'
    float q[2] = {0.f, 0.f}, qc[2] = {0.f, 0.f}, p[2] = {0.f, 0.f};
    if constexpr (PASS == 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (live[r])
          p[r] = expf(__ldg(g.lg + (size_t)row[r] * g.k_comp + k) - m[r]);
    }
    for (int j = j0; j < j1; j += kGroup) {
      const int gn = min(kGroup, j1 - j);
      for (int c = 0; c < g.n_ch; ++c) {
        const unsigned st = ring.stage();
        mbar_wait(ring.full(), ring.ph);
        wgmma_fence();
        fence_all(acc);
        if constexpr (PASS == 1) {
          fence_all(hh);
          issue_chunk<0, 5, 0, 4>(acc, st, wg);
          issue_chunk<5, 6, 0, 4>(hh, st, wg);
        } else {
          issue_chunk<0, 6, 0, 4>(acc, st, wg);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_all(acc);
        warp_arrive(ring.empty());  // the products have read the stage
        ring.next();
        fold(sum, acc, gn, c == 0);
        if constexpr (PASS == 1) {
          fence_all(hh);
          fold(sum, hh, gn, false);
        }
      }
      // the pieces' epilogues: this lane's columns 8 t + 2 (lane % 4) +
      // {0, 1} of each piece, its rows lane / 4 and + 8 of its warp's 16
#pragma unroll
      for (int gp = 0; gp < kGroup; ++gp) {
        if (gp >= gn) continue;
        const float* v = g.vec + ((size_t)k * pieces + j + gp) * kPiece +
                         2 * (lane & 3);
        float sq[2][16];  // pass 1: the piece's squares, a row's 16 columns
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 vv = __ldg(reinterpret_cast<const float2*>(v + 8 * t));
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * t + 2 * r + h;
              const float vc = h ? vv.y : vv.x;  // padding: 0
              if constexpr (PASS == 1) {
                const float dv = sum[gp][i] - vc;
                sq[r][2 * t + h] = dv * dv;
              } else if constexpr (PASS == 2) {
                o[gp][i] = fmaf(p[r], sum[gp][i] + vc, o[gp][i]);
              } else {
                o[gp][i] = sum[gp][i] + vc;
              }
            }
        }
        if constexpr (PASS == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // Kahan: q + the piece's tree sum
            const float y = tree_sum<16>(sq[r]) - qc[r];
            const float nq = q[r] + y;
            qc[r] = (nq - q[r]) - y;
            q[r] = nq;
          }
        }
      }
    }
    if constexpr (PASS == 1) {  // the rows' logits of component k
      const float lw = __ldg(g.logw + k);
      float lg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float qq = q[r];
        qq += __shfl_xor_sync(0xffffffffu, qq, 1);
        qq += __shfl_xor_sync(0xffffffffu, qq, 2);
        lg[r] = lw - qq;
      }
      if constexpr (COH) pool_logits(lg, ep);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (live[r]) g.lg[(size_t)row[r] * g.k_comp + k] = lg[r];
      }
    }
  }

  if constexpr (PASS >= 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      float* orow = g.out + (size_t)row[r] * g.two_d;
#pragma unroll
      for (int gp = 0; gp < kGroup; ++gp)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = (j0 - g.n_ch + gp) * kPiece + 8 * t +
                          2 * (lane & 3);  // even
          if (col < g.two_d) {
            const float x0 = o[gp][4 * t + 2 * r];
            const float x1 = o[gp][4 * t + 2 * r + 1];
            *reinterpret_cast<float2*>(orow + col) =
                STATS || PASS == 3 ? make_float2(x0, x1)
                                   : make_float2(x0 / den[r], x1 / den[r]);
          }
        }
      if constexpr (STATS) {
        if (blockIdx.y == 0 && (lane & 3) == 0) {
          g.m_out[row[r]] = m[r];
          g.den_out[row[r]] = den[r];
        }
      }
    }
  }
}

template <int PASS, bool COH, bool STATS>
int launch_pass(const WideArgs& g, int pairs, int slices,
                cudaStream_t stream) {
  const size_t smem = kRingSmem + (COH ? kWgs * 64 * 4 : 0);
  auto kern = wide_kernel<PASS, COH, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(pairs, slices), kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

int split_rows(const float* r2, void* a, int n, int two_m, int n_ch,
               int tiles, int wg_rows, const int* ent, int k_sel,
               const int* pair_comp, cudaStream_t stream) {
  return split_tiles(GroupedRows{r2, n, two_m, wg_rows, ent, k_sel, pair_comp},
                     a, n_ch, tiles, stream);
}

int check_operands(const void* slab_hi, const void* slab_lo,
                   const void* slab_lo2, const float* vec) {
  const void* planes[3] = {slab_hi, slab_lo, slab_lo2};
  for (const void* p : planes)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(vec) % 8)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// The arguments of passes 1 and 2 over n rows in t_coh-row blocks, after
// the row split into a.
WideArgs wide_args(const void* a, const void* slab_hi, const void* slab_lo,
                   const void* slab_lo2, const float* vec, const float* logw,
                   float* lg, float* out, float* m_out, float* den_out, int n,
                   int k_comp, int two_m, int two_d, int t_coh, float alpha) {
  const int wg_rows = t_coh > 1 ? 64 / t_coh * t_coh : 64;
  const int n_ch = (two_m + 63) / 64, tiles = row_tiles(n, wg_rows);
  return WideArgs{static_cast<const uint4*>(a),
                  {static_cast<const bf16*>(slab_hi),
                   static_cast<const bf16*>(slab_lo),
                   static_cast<const bf16*>(slab_lo2)},
                  vec,
                  logw,
                  lg,
                  out,
                  m_out,
                  den_out,
                  n,
                  k_comp,
                  two_m,
                  two_d,
                  n_ch,
                  tiles,
                  wg_rows,
                  t_coh,
                  alpha,
                  (size_t)tiles * n_ch * 512,
                  nullptr,
                  nullptr};
}

// ----------------------------------------------------------------- top-k
// K4 and K5 past the stream's widths, after pass 1's logits lg:
//   - `topk_select_kernel`, a thread a row, takes the row's k_sel largest
//     logits in slot order, inserted with strict > (ties keep the lower
//     index; a -inf or NaN logit takes no slot), as grouped_topk.cu does;
//     it writes l (n, k_sel) and the picked components idx, zeroes the
//     values of an empty slot (a shard of fewer than k_sel components)
//     and counts each component's picks;
//   - `topk_buckets_kernel`, one block, lays the picks out by component:
//     component j's entries from a multiple of 128 on (two 64-row tiles,
//     one block of pass 3), its first position in cursor[j], and marks
//     each block of two tiles with its component (-1: unused);
//   - `topk_scatter_kernel` writes each (row, slot) entry row k_sel +
//     slot to the next position of its component (perm). Which position
//     an entry takes depends on the order of the atomics, but no sum does:
//     each product row is computed from its own row alone;
//   - the row split gathers the entries' rows of r2 into the three bf16
//     planes (`split_rows` with ent = perm), and pass 3 multiplies
//     each block's rows by its component's value pieces with the six bf16
//     products, adding b_j: the candidates z (n, k_sel, 2D);
//   - K4 then combines each row's candidates in slot order
//     (`topk_combine_kernel`: w_0 = 1, w_s = exp(l_s - l_0)); at k_sel = 1
//     pass 3 writes the output itself.

constexpr int kSlots = 8;

__global__ void topk_select_kernel(const float* __restrict__ lg,
                                   float* __restrict__ l_out,
                                   int* __restrict__ idx,
                                   int* __restrict__ count,
                                   float* __restrict__ z_out, int n,
                                   int k_comp, int k_sel, int two_d) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float top_l[kSlots];
  int top_k[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    top_l[s] = -INFINITY;
    top_k[s] = -1;
  }
  const float* lr = lg + (size_t)row * k_comp;
  for (int k = 0; k < k_comp; ++k) {
    float cand = __ldg(lr + k);
    int cand_k = k;
    bool placed = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < k_sel) {
        const bool take = placed || cand > top_l[s];
        const float ev_l = take ? top_l[s] : cand;
        const int ev_k = take ? top_k[s] : cand_k;
        if (take) {
          top_l[s] = cand;
          top_k[s] = cand_k;
        }
        cand = ev_l;
        cand_k = ev_k;
        placed = take;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (s >= k_sel) continue;
    const size_t e = (size_t)row * k_sel + s;
    l_out[e] = top_l[s];
    idx[e] = top_k[s];
    if (top_k[s] >= 0) {
      atomicAdd(count + top_k[s], 1);
    } else {
      float* zr = z_out + e * two_d;
      for (int c = 0; c < two_d; ++c) zr[c] = 0.f;
    }
  }
}

__global__ void topk_buckets_kernel(const int* __restrict__ count,
                                    int* __restrict__ cursor,
                                    int* __restrict__ pair_comp, int k_comp,
                                    int max_pairs) {
  __shared__ int total;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < k_comp; ++k) {
      cursor[k] = acc * 128;
      acc += (count[k] + 127) / 128;
    }
    total = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < k_comp; k += blockDim.x) {
    const int p0 = cursor[k] / 128, np = (count[k] + 127) / 128;
    for (int i = 0; i < np; ++i) pair_comp[p0 + i] = k;
  }
  for (int p = total + threadIdx.x; p < max_pairs; p += blockDim.x)
    pair_comp[p] = -1;
}

__global__ void topk_scatter_kernel(const int* __restrict__ idx,
                                    int* __restrict__ cursor,
                                    int* __restrict__ perm, int entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  const int j = idx[e];
  if (j >= 0) perm[atomicAdd(cursor + j, 1)] = e;
}

__global__ void topk_combine_kernel(const float* __restrict__ l,
                                    const float* __restrict__ z,
                                    float* __restrict__ out, int n,
                                    int k_sel, int two_d) {
  const size_t total = (size_t)n * two_d;
  for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += (size_t)gridDim.x * blockDim.x) {
    const size_t row = u / two_d, c = u % two_d;
    const float* lr = l + row * k_sel;
    const float l0 = lr[0];
    float acc = 0.f, den = 0.f;
    for (int s = 0; s < k_sel; ++s) {
      const float w = s == 0 ? 1.f : expf(lr[s] - l0);
      acc = fmaf(w, z[(row * k_sel + s) * two_d + c], acc);
      den += w;
    }
    out[u] = acc / den;
  }
}

// Blocks of two 64-row tiles that pass 3 may need for n rows' k_sel picks
// over k_comp components: each component's picks start a block of their
// own (`kernels.wide_topk_pairs`).
int topk_pairs(int n, int k_comp, int k_sel) {
  return (int)(((size_t)n * k_sel + 127) / 128) + k_comp;
}

}  // namespace

// C entry points, loaded with ctypes. Each returns a cudaError_t (0 on
// success).

// r2 (n, two_m) -> its three bf16 planes in a: (3, tiles, n_ch, 64, 64)
// bf16, tiles = `kernels.wide_row_tiles(n, t_coh)`: the layout passes 1
// and 2 stream, the first kernel of `grouped_wide_launch`
// (`kernels.wide_row_planes` is its plain version).
extern "C" int grouped_wide_split_launch(const float* r2, void* a, int n,
                                         int two_m, int t_coh, void* stream) {
  if (n < 1 || two_m < 2 || two_m % 2 || two_m > kMaxTwoM || t_coh < 1 ||
      t_coh > 64)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(r2) % 8)
    return (int)cudaErrorMisalignedAddress;
  const int wg_rows = t_coh > 1 ? 64 / t_coh * t_coh : 64;
  return split_rows(r2, a, n, two_m, (two_m + 63) / 64, row_tiles(n, wg_rows),
                    wg_rows, nullptr, 1, nullptr,
                    static_cast<cudaStream_t>(stream));
}

// K1 (t_coh = 1), K3 (t_coh > 1) and, with stats != 0, K2 (flat and
// coherent) at any width: r2 (n, two_m); slab_hi / lo / lo2 and vec the
// bank's `tc_operands`; logw (k_comp); out (n, two_d) (STATS: acc); m_out,
// den_out (n) for STATS; scratch: a (3, tiles, n_ch, 64, 64) bf16 (see
// `grouped_wide_split_launch`), lg (n, k_comp) fp32. n / t_coh whole blocks
// of t_coh consecutive rows, 1 <= t_coh <= 64.
extern "C" int grouped_wide_launch(const float* r2, const void* slab_hi,
                                   const void* slab_lo, const void* slab_lo2,
                                   const float* vec, const float* logw,
                                   float* out, float* m_out, float* den_out,
                                   void* a, float* lg, int n, int k_comp,
                                   int two_m, int two_d, int t_coh,
                                   float alpha, int stats, void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 2 || two_m % 2 || two_m > kMaxTwoM ||
      two_d < 2 || two_d % 2 || t_coh < 1 || t_coh > 64 || n % t_coh)
    return (int)cudaErrorInvalidValue;
  if (int err = check_operands(slab_hi, slab_lo, slab_lo2, vec)) return err;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = grouped_wide_split_launch(r2, a, n, two_m, t_coh, stream))
    return err;
  const WideArgs g = wide_args(a, slab_hi, slab_lo, slab_lo2, vec, logw, lg,
                               out, m_out, den_out, n, k_comp, two_m, two_d,
                               t_coh, alpha);
  const int dp = (two_d + kPiece - 1) / kPiece;
  const int pairs = g.tiles / kWgs, slices = (dp + kGroup - 1) / kGroup;
  int err = t_coh > 1 ? launch_pass<1, true, false>(g, pairs, 1, st)
                      : launch_pass<1, false, false>(g, pairs, 1, st);
  if (err) return err;
  return stats ? launch_pass<2, false, true>(g, pairs, slices, st)
               : launch_pass<2, false, false>(g, pairs, slices, st);
}

// K4 (stats = 0) and K5 (stats != 0) at any width up to 2M = 2048: r2 (n,
// two_m); slab_hi / lo / lo2, vec and logw as for `grouped_wide_launch`;
// l_out (n, k_sel) the selected logits, sorted descending; z_out (n, k_sel,
// two_d) their candidates r2_n W_j + b_j (K5's outputs; for K4 scratch,
// unread at k_sel = 1, where pass 3 writes out); out (n, two_d) K4's
// combine; scratch: a (3, max(`kernels.wide_row_tiles(n)`, 2 pairs), n_ch,
// 64, 64) bf16 with pairs = `topk_pairs(n, k_comp, k_sel)`, lg (n, k_comp)
// fp32, and iscratch int32: idx (n k_sel), count and cursor (k_comp each),
// pair_comp (pairs) and perm (128 pairs). 1 <= k_sel <= 8, and for K4
// k_sel <= k_comp; slots past a K5 shard's k_comp hold -inf and zeros.
extern "C" int grouped_wide_topk_launch(
    const float* r2, const void* slab_hi, const void* slab_lo,
    const void* slab_lo2, const float* vec, const float* logw, float* l_out,
    float* z_out, float* out, void* a, float* lg, int* iscratch, int n,
    int k_comp, int two_m, int two_d, int k_sel, int stats, void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 2 || two_m % 2 || two_m > kMaxTwoM ||
      two_d < 2 || two_d % 2 || k_sel < 1 || k_sel > kSlots ||
      (!stats && (k_sel > k_comp || out == nullptr)) ||
      ((stats || k_sel > 1) && z_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (int err = check_operands(slab_hi, slab_lo, slab_lo2, vec)) return err;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = grouped_wide_split_launch(r2, a, n, two_m, 1, stream))
    return err;
  WideArgs g = wide_args(a, slab_hi, slab_lo, slab_lo2, vec, logw, lg,
                         nullptr, nullptr, nullptr, n, k_comp, two_m, two_d, 1,
                         1.f);
  if (int err = launch_pass<1, false, false>(g, g.tiles / kWgs, 1, st))
    return err;

  const int pairs = topk_pairs(n, k_comp, k_sel), entries = n * k_sel;
  int* idx = iscratch;
  int* count = idx + entries;
  int* cursor = count + k_comp;
  int* pair_comp = cursor + k_comp;
  int* perm = pair_comp + pairs;
  float* z = stats || k_sel > 1 ? z_out : out;  // the candidates' rows
  cudaError_t ce = cudaMemsetAsync(count, 0, sizeof(int) * k_comp, st);
  if (ce == cudaSuccess)
    ce = cudaMemsetAsync(perm, 0xff, sizeof(int) * 128 * (size_t)pairs, st);
  if (ce != cudaSuccess) return (int)ce;
  topk_select_kernel<<<(n + 127) / 128, 128, 0, st>>>(
      lg, l_out, idx, count, z, n, k_comp, k_sel, two_d);
  topk_buckets_kernel<<<1, 256, 0, st>>>(count, cursor, pair_comp, k_comp,
                                         pairs);
  topk_scatter_kernel<<<(entries + 255) / 256, 256, 0, st>>>(idx, cursor, perm,
                                                             entries);
  if (int err = (int)cudaGetLastError()) return err;

  // pass 3 on the gathered rows, in the same scratch a
  g.tiles = 2 * pairs;
  g.wg_rows = 64;
  g.plane_units = (size_t)g.tiles * g.n_ch * 512;
  g.out = z;
  g.perm = perm;
  g.pair_comp = pair_comp;
  if (int err = split_rows(r2, a, n, two_m, g.n_ch, g.tiles, 64, perm, k_sel,
                           pair_comp, st))
    return err;
  const int dp = (two_d + kPiece - 1) / kPiece;
  if (int err = launch_pass<3, false, false>(g, pairs,
                                             (dp + kGroup - 1) / kGroup, st))
    return err;
  if (stats || k_sel == 1) return 0;
  const size_t total = (size_t)n * two_d;
  const int grid = (int)((total + 255) / 256 < 65535 ? (total + 255) / 256
                                                     : 65535);
  topk_combine_kernel<<<grid, 256, 0, st>>>(l_out, z_out, out, n, k_sel,
                                            two_d);
  return (int)cudaGetLastError();
}
