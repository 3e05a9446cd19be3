// Factored (MFA, low-rank plus diagonal) Bussgang estimator on Hopper's
// tensor cores: kernels K11 (flat), K12 (coherent) and K13 (stats), one
// template with COH and STATS flags.
//
// Replaces the TPU kernels `_fact_kernel` (:2048), `_fact_kernel_coh`
// (:2126) and `_fact_kernel_stats` (:2231) launched by
// `estimate_fact_packed` (:2091), `estimate_fact_packed_coh` (:2183) and
// `estimate_fact_packed_stats` (:2275) of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py. Per row n
// of x (N x 2D, complex64 observations as interleaved [re, im] pairs) and
// component k, with the Woodbury factors of the bank (M << D):
//
//   [beta | gamma] = x @ fwd_k             (2D, 4M): beta = T r, gamma = P2 r
//   lg_nk  = const_k + [Re r | Im r | |r|^2] . lcoef_k + |beta - T mu|^2
//   w_nk   = softmax_k(lg'_nk)
//   h_n    = sum_k w_nk ([beta | gamma] @ comb_k + bias_k + a1_k o r)
//            comb_k (4M, 2D): gamma Lambda^T - beta R^T
//
// lg' = lg for K11/K13. For K12 the rows are block-major (the T rows of a
// coherence block consecutive), s_k = sum of lg_k over the row's block and
// lg' = (1 - alpha) lg + alpha s (alpha >= 1: s); the caller divides the
// mixture log-weight inside const by (1 - alpha + alpha T) so that it
// enters once per block. K13 emits m = max_k lg, den = sum_k exp(lg - m)
// and the un-normalised h, so that the states of disjoint component shards
// merge exactly.
//
// The products. Both products of a component run on the tensor cores as
// K1's do (grouped_tc_stream.cuh): each fp32 operand split into three bf16
// planes (hi, lo, lo2, each rounded to nearest even, hi + lo + lo2 = x
// exactly for normal x), six exact bf16 products accumulated in fp32,
// smallest first (hi.lo2, lo.lo, lo2.hi, lo.hi, hi.lo, hi.hi; the rows'
// plane first), product by product over all contraction chunks. The bank's
// planes of fwd and comb are split once on the host
// (`fact_kernels.fact_tc_operands`), x's per tile in the kernel, and the
// combine's A operand [beta | gamma] per component from the forward
// accumulator. Everything after the products is fp32: the logit's diagonal
// term [Re r | Im r | |r|^2] . lcoef_k from the rows (x rebuilt exactly as
// hi + lo + lo2 from its planes), the quadratic term from the accumulator
// registers (a thread's columns as a tree, then the row's four threads by
// quad shuffles; the two sums reduced apart and then added, since they
// cancel at high SNR), K12's pooling, the online softmax, bias + a1 o r.
// The combine accumulates into a fresh accumulator that is folded into the
// running output in fp32 (h = h sc + p (C + bias + a1 o r)), as K1 folds
// its pieces; so its A operand is [beta | gamma] itself and p is applied
// in fp32 after the product (the plain version's (p u) comb, with p moved
// out of the product).
//
// Bound on an H100 (131072 rows, D = K = 64, M = 16): 6 x 2 N K (2D 4M +
// 4M 2D) = 1.65e12 bf16 tensor-core operations (1.67 ms at 989 TFLOP/s)
// plus 2 N K (3D + 2M + 6D) = 1.0e10 fp32 epilogue operations (0.15 ms at
// 67 TFLOP/s), against ~0.14 GB of compulsory traffic (0.04 ms at 3.35
// TB/s): 1.82 ms, against 4.25 ms for the products as fp32 FMAs.
//
// Design:
//   - a block is WGS consumer warpgroups of 64 rows (K12: 64 / T whole
//     blocks) and one producer warpgroup; WGS = 2 at D <= 64, M <= 16
//     (`setmaxnreg`: 232 registers a consumer thread, 40 a producer
//     thread) where 128-row blocks cover the SMs, else 1 (the service's
//     microbatches, run_mfa's 10000 rows, and the wider forms);
//   - x's three planes sit in the warpgroup's shared memory (K-major,
//     128-byte swizzle, 2D padded to NCX chunks of 64), the A operand of
//     the forward product;
//   - the bank streams as units: one PW-column piece of fwd_k (the forward
//     pieces, 4M columns) or of comb_k (the combine pieces, 2D columns),
//     one 64-deep contraction chunk, its three bf16 planes; one producer
//     thread copies unit after unit with cp.async.bulk into a ring of
//     stages under full and empty mbarriers, deep enough for a whole piece;
//     and each component's record (T mu, then lcoef, bias and a1 per bin)
//     into one of two record slots under their own barriers;
//   - a piece is one commit group of 24 NC wgmma m64nPWk16, product by
//     product over its NC chunks, into one accumulator; the piece waits for
//     its products (no wgmma group is in flight across a loop's back edge:
//     ptxas serialises every wgmma of a kernel where one is), and its units
//     go back to the ring;
//   - at D <= 64, M <= 16 (ARS, the main path) 4M fits one 64-column
//     forward piece, whose accumulator becomes the combine's A fragments in
//     registers (three planes, the m64n64 accumulator laid out as the m64k16
//     A fragments of the next product, FlashAttention-3's P.V pattern), and
//     the combine is RS wgmma; wider, each forward piece's planes go to the
//     warpgroup's shared memory (U planes, NCU chunks) and the combine is SS
//     wgmma. PW = 64, or 32 / 16 where a piece's units and the planes would
//     not fit the 227 KB of shared memory beside each other;
//   - while the first forward piece's products run, the diagonal term of
//     the logit from x (read from its planes) and lcoef (from the record);
//     a thread takes the bins of its output columns, and at D <= 64 keeps
//     their x in registers for the fold; after the forward: the quadratic
//     term, the pooling, the online softmax, then h = h sc + p (bias + a1
//     o r); the record slot is released after a proxy fence (fault F2: a
//     generic read of a slot must be performed before the async refill
//     lands); then the combine pieces, each folded as h += p C;
//   - the ragged last tile is masked in the kernel (any N, no padding).
// Any N and K, 1 <= D <= 128, 1 <= M <= 64, K12 any 2 <= T <= 64.
#include "grouped_tc_stream.cuh"

namespace {

using namespace qce_tc;

// 64-deep chunks a contraction of w columns needs: 1, 2 or 4
__host__ __device__ constexpr int chunks_of(int w) {
  return w <= 64 ? 1 : w <= 128 ? 2 : 4;
}

// One instantiation: NCX 64-deep chunks of the forward contraction (2D) and
// NCU of the combine's (4M), PW-column pieces, WGS consumer warpgroups, the
// combine's A in registers (ARS: one 64-column forward piece) or in shared
// memory, and the K12 / K13 flags.
template <int NCX_, int NCU_, int PW_, int WGS_, bool ARS_, bool COH_,
          bool STATS_>
struct FactCfg {
  static constexpr int NCX = NCX_, NCU = NCU_, PW = PW_, WGS = WGS_;
  static constexpr bool ARS = ARS_, COH = COH_, STATS = STATS_;
  static_assert(!ARS || (NCU == 1 && PW == 64), "ARS: one 64-column piece");
  static constexpr int kAcc = PW / 2;                  // accumulator floats
  static constexpr int kT = PW / 8;                    // a thread's column
                                                       // pairs in a piece
  static constexpr int CP = NCX * 64 / PW;             // output pieces (max)
  static constexpr unsigned kPlane = PW * 128;         // a unit's bf16 plane
  static constexpr unsigned kStage = 3 * kPlane;       // hi, lo, lo2
  static constexpr unsigned kX = 3 * NCX * kAtomBytes;  // a warpgroup's x
  static constexpr unsigned kU = ARS ? 0 : 3 * NCU * kAtomBytes;  // its U
  // a thread keeps its bins' x from the logit to the fold (D <= 64)
  static constexpr bool kKeepX = NCX <= 2;
};

// The ring: stage s's planes at b + s kStage and its barriers at full /
// empty + 8 s; record slot i at rec + i rec_bytes, its barriers at rfull /
// rempty + 8 i.
struct FactRing {
  unsigned b, full, empty, rec, rfull, rempty, rec_bytes;
  int stages;
};

__device__ __forceinline__ unsigned ld_shared_b32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// k16 step I of a piece's six products with both operands in shared
// memory, product by product over the piece's NC chunks (each four steps):
// A plane prod_a of chunk c at da (planes NC atoms apart), B plane prod_b of
// the chunk's unit at db[c].
template <class C, int NC, int I = 0>
__device__ __forceinline__ void ss_steps(float (&d)[C::kAcc], uint64_t da,
                                         const uint64_t (&db)[NC]) {
  if constexpr (I < 24 * NC) {
    constexpr int P = I / (4 * NC), c = (I / 4) % NC, ks = I % 4;
    constexpr int oa = ((prod_a(6, P) * NC + c) * kAtomBytes + ks * 32) >> 4;
    constexpr int ob = (prod_b(6, P) * (int)C::kPlane + ks * 32) >> 4;
    wgmma_at<oa, ob>(d, da, db[c], I > 0);
    ss_steps<C, NC, I + 1>(d, da, db);
  }
}

// The same with A in registers (ARS: one chunk): a[plane][step].
template <class C, int I = 0>
__device__ __forceinline__ void rs_steps(float (&d)[32],
                                         const unsigned (&a)[3][4][4],
                                         uint64_t db) {
  if constexpr (I < 24) {
    constexpr int P = I / 4, ks = I % 4;
    constexpr int ob = (prod_b(6, P) * (int)C::kPlane + ks * 32) >> 4;
    wgmma_64x64_rs(d, a[prod_a(6, P)][ks], db + ob, I > 0);
    rs_steps<C, I + 1>(d, a, db);
  }
}

// Wait for the NC units of a piece at the cursor (s, ph) and note their
// stages in st and their B descriptors in db.
template <class C, int NC>
__device__ __forceinline__ void take_units(const FactRing& ring, int& s,
                                           int& ph, int (&st)[NC],
                                           uint64_t (&db)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    mbar_wait(ring.full + 8 * s, ph);
    st[c] = s;
    db[c] = sw128_desc(ring.b + s * C::kStage);
    if (++s == ring.stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// The complex value at (row, columns c, c + 1) of the rows whose planes
// are at xa (NC chunks a plane), rebuilt exactly: hi + lo + lo2.
template <int NC>
__device__ __forceinline__ float2 x_at(unsigned xa, int row, int c) {
  const unsigned off = sw128_off(row, c);
  const unsigned w0 = ld_shared_b32(xa + off);
  const unsigned w1 = ld_shared_b32(xa + NC * kAtomBytes + off);
  const unsigned w2 = ld_shared_b32(xa + 2 * NC * kAtomBytes + off);
  return make_float2((bf_lo(w0) + bf_lo(w1)) + bf_lo(w2),
                     (bf_hi(w0) + bf_hi(w1)) + bf_hi(w2));
}

// The warpgroup's rows of x (n, 2D interleaved) -> its three planes at xa:
// plane q, chunk c at xa + (q NCX + c) kAtomBytes, each 64 rows x 64 bf16
// in the 128-byte swizzle; rows past the tile or N and columns past 2D
// zero. 16 bytes (8 columns of one row) of each plane at a time.
template <class C>
__device__ __forceinline__ void load_x(unsigned xa,
                                       const float* __restrict__ x,
                                       int two_d, int row0, int rows, int n) {
  constexpr int kUnitsRow = C::NCX * 8;
  for (int u = threadIdx.x % kWg; u < 64 * kUnitsRow; u += kWg) {
    const int rr = u / kUnitsRow, kq = u - rr * kUnitsRow;
    const int row = row0 + rr;
    const bool live = rr < rows && row < n;
    unsigned pl[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kq * 8 + 2 * e;  // 2D is even: a pair is in or out
      float2 v = make_float2(0.f, 0.f);
      if (live && c < two_d)
        v = __ldg(reinterpret_cast<const float2*>(x + (size_t)row * two_d +
                                                  c));
      unsigned w[3];
      split3(v.x, v.y, w);
#pragma unroll
      for (int q = 0; q < 3; ++q) pl[q][e] = w[q];
    }
    const unsigned off = sw128_off(rr, kq * 8);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      st_shared_v4(xa + q * C::NCX * kAtomBytes + off, pl[q]);
  }
}

// A thread's rows (accumulator rows lane / 4 and + 8 of its warp's 16):
// the running output at columns jj PW + 8 t + 2 (lane % 4) + {0, 1} of
// each output piece jj, the online-softmax state and the current
// component's p.
template <class C>
struct FactRows {
  float h[C::CP][C::kAcc];
  float m_run[2], den[2], p[2];
};

// A forward piece's columns j0 + 8 t + 2 (lane % 4) + {0, 1} that lie in
// beta (below 2M): their (u - T mu)^2 added to the rows' quadratic terms.
// rec: the component's record (T mu first).
template <class C>
__device__ __forceinline__ void quad_piece(float (&q)[2],
                                           const float (&acc)[C::kAcc],
                                           unsigned rec, int j0, int two_m) {
  float part[2][2 * C::kT];
#pragma unroll
  for (int t = 0; t < C::kT; ++t) {
    const int c = j0 + 8 * t + 2 * (lane_id() & 3);
    const bool live = c < two_m;  // 2M is even: a pair is in or out
    const float2 mu = live ? ld_shared_f2(rec + 4 * c) : make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dv = acc[4 * t + 2 * r + h] - (h ? mu.y : mu.x);
        part[r][2 * t + h] = live ? dv * dv : 0.f;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) q[r] += tree_sum<2 * C::kT>(part[r]);
}

// SS: forward piece j's accumulator -> its columns of the warpgroup's U
// planes at ua (NCU chunks a plane).
template <class C>
__device__ __forceinline__ void store_u(unsigned ua,
                                        const float (&acc)[C::kAcc], int j) {
  const int rr0 = row_in_wg();
#pragma unroll
  for (int t = 0; t < C::kT; ++t) {
    const int c = j * C::PW + 8 * t + 2 * (lane_id() & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      unsigned w[3];
      split3(acc[4 * t + 2 * r], acc[4 * t + 2 * r + 1], w);
      const unsigned off = sw128_off(rr0 + 8 * r, c);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        st_shared_b32(ua + q * C::NCU * kAtomBytes + off, w[q]);
    }
  }
}

// The kernel. x (n, 2D) fp32 interleaved; hi, lo, lo2: the bank's bf16
// planes as units (`fact_tc_operands`: (k_comp, units, PW, 64)); rec: each
// component's record (k_comp, rec_bytes / 4) floats: T mu (2M, padded to
// a multiple of 4), then per bin (l0, l1, l2, 0, Re b, Im b, Re a1, Im a1);
// cst (k_comp); out (n, 2D); STATS: m_out, den_out (n); K12: t_coh, alpha.
template <class C>
__global__ void __launch_bounds__((C::WGS + 1) * kWg, 1)
    fact_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ hi,
                   const bf16* __restrict__ lo, const bf16* __restrict__ lo2,
                   const float* __restrict__ recs,
                   const float* __restrict__ cst, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ den_out,
                   int n, int d, int m, int k_comp, int stages,
                   int rec_bytes, int t_coh, float alpha) {
  constexpr int WGS = C::WGS, PW = C::PW, CP = C::CP, kAcc = C::kAcc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int two_d = 2 * d, two_m = 2 * m, four_m = 4 * m;
  const int fp = C::ARS ? 1 : (four_m + PW - 1) / PW;  // forward pieces
  const int cp = (two_d + PW - 1) / PW;                // combine pieces
  const int units = fp * C::NCX + cp * C::NCU;         // a component's
  FactRing ring;
  ring.b = base + WGS * (C::kX + C::kU);
  ring.stages = stages;
  ring.rec_bytes = rec_bytes;
  ring.rec = ring.b + stages * C::kStage;
  ring.full = ring.rec + 2 * rec_bytes;
  ring.empty = ring.full + 8 * stages;
  ring.rfull = ring.empty + 8 * stages;
  ring.rempty = ring.rfull + 16;
  const unsigned lg0 = ring.rempty + 16;  // K12: 64 logits a warpgroup

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, WGS * 4);  // one arrival a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ring.rfull + 8 * i, 1);
      mbar_init(ring.rempty + 8 * i, WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == WGS) {  // the producer warpgroup: one thread streams the bank
    if constexpr (WGS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == WGS * kWg) {
      int s = 0, ph = 0;
      for (int k = 0; k < k_comp; ++k) {
        // the component's record, then its units
        const unsigned slot = k & 1;
        mbar_wait(ring.rempty + 8 * slot, ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(ring.rfull + 8 * slot, rec_bytes);
        bulk_copy(ring.rec + slot * rec_bytes,
                  reinterpret_cast<const char*>(recs) + (size_t)k * rec_bytes,
                  rec_bytes, ring.rfull + 8 * slot);
        for (int u = 0; u < units; ++u) {
          const unsigned full = ring.full + 8 * s;
          mbar_wait(ring.empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full, C::kStage);
          const size_t off = ((size_t)k * units + u) * C::kPlane;
          const unsigned dst = ring.b + s * C::kStage;
          bulk_copy(dst, reinterpret_cast<const char*>(hi) + off, C::kPlane,
                    full);
          bulk_copy(dst + C::kPlane, reinterpret_cast<const char*>(lo) + off,
                    C::kPlane, full);
          bulk_copy(dst + 2 * C::kPlane,
                    reinterpret_cast<const char*>(lo2) + off, C::kPlane,
                    full);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }
  if constexpr (WGS == 2) setmaxnreg_inc<232>();

  // K12: whole T-row blocks a warpgroup
  const int wg_rows = C::COH ? 64 / t_coh * t_coh : 64;
  const int row0 = blockIdx.x * (WGS * wg_rows) + wg * wg_rows;
  const unsigned xa = base + wg * (C::kX + C::kU);  // x's planes
  const unsigned ua = xa + C::kX;                    // U's planes (SS)
  load_x<C>(xa, x, two_d, row0, wg_rows, n);
  if constexpr (!C::ARS) {
    // U's columns past the forward pieces are never written: zero, so the
    // combine's padding rows of comb meet zeros, not stale bits
    for (int i = threadIdx.x % kWg; i < (int)C::kU / 16; i += kWg) {
      const unsigned z[4] = {0u, 0u, 0u, 0u};
      st_shared_v4(ua + 16 * i, z);
    }
  }
  // the generic-proxy stores become visible to wgmma, then the warpgroup
  // meets
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(1 + wg);
  const uint64_t dx = sw128_desc(xa);
  const uint64_t du = sw128_desc(ua);
  const int qd = lane_id() & 3;
  const int rr0 = row_in_wg();
  const Epi ep{nullptr, 0, 0, t_coh, alpha, 0.f, lg0};

  FactRows<C> st;
#pragma unroll
  for (int j = 0; j < CP; ++j)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) st.h[j][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m_run[r] = -INFINITY;
    st.den[r] = st.p[r] = 0.f;
  }

  float acc[kAcc];
  unsigned areg[C::ARS ? 3 : 1][4][4];
  int s = 0, ph = 0;
  for (int k = 0; k < k_comp; ++k) {
    const unsigned slot = k & 1;
    const unsigned rec = ring.rec + slot * rec_bytes;
    const unsigned bins = rec + 4 * ((two_m + 3) & ~3);  // per-bin values
    float q[2] = {0.f, 0.f}, lin[2] = {0.f, 0.f};
    float2 xk[C::kKeepX ? CP : 1][C::kKeepX ? C::kT : 1][2];
    // the forward pieces: [beta | gamma] = x fwd_k, PW columns a piece
    for (int j = 0; j < fp; ++j) {
      int su[C::NCX];
      uint64_t db[C::NCX];
      take_units<C, C::NCX>(ring, s, ph, su, db);
      // the record was copied before the units; its wait comes before the
      // products (a barrier's spin loop between a wgmma and its wait makes
      // ptxas inject a wait, C7517)
      if (j == 0) mbar_wait(ring.rfull + 8 * slot, (k >> 1) & 1);
      wgmma_fence();
      fence_operand(acc);
      ss_steps<C, C::NCX>(acc, dx, db);
      wgmma_commit();
      fence_operand(acc);
      if (j == 0) {
        // while the first piece's products run: the diagonal term of the
        // thread's bins d = jj PW / 2 + 4 t + lane % 4
#pragma unroll
        for (int jj = 0; jj < CP; ++jj)
#pragma unroll
          for (int t = 0; t < C::kT; ++t) {
            const int b = jj * PW / 2 + 4 * t + qd;
            if (b < d) {
              const float4 lc = ld_shared_f4(bins + 32 * b);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float2 xv = x_at<C::NCX>(xa, rr0 + 8 * r, 2 * b);
                if constexpr (C::kKeepX) xk[jj][t][r] = xv;
                lin[r] = fmaf(lc.x, xv.x, lin[r]);
                lin[r] = fmaf(lc.y, xv.y, lin[r]);
                lin[r] = fmaf(lc.z, fmaf(xv.x, xv.x, xv.y * xv.y), lin[r]);
              }
            }
          }
      }
      wgmma_wait<0>();
      fence_operand(acc);
#pragma unroll
      for (int c = 0; c < C::NCX; ++c) warp_arrive(ring.empty + 8 * su[c]);
      if (j * PW < two_m) quad_piece<C>(q, acc, rec, j * PW, two_m);
      if constexpr (!C::ARS) store_u<C>(ua, acc, j);
    }

    // the two sums cancel at high SNR: each is reduced on its own
    const float ck = __ldg(cst + k);
    float lg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lin[r] += __shfl_xor_sync(0xffffffffu, lin[r], 1);
      lin[r] += __shfl_xor_sync(0xffffffffu, lin[r], 2);
      q[r] += __shfl_xor_sync(0xffffffffu, q[r], 1);
      q[r] += __shfl_xor_sync(0xffffffffu, q[r], 2);
      lg[r] = (ck + lin[r]) + q[r];
    }
    if constexpr (C::COH) pool_logits(lg, ep);

    // the online softmax, then h = h sc + p (bias + a1 o r)
    float sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(st.m_run[r], lg[r]);
      // exp(-inf - (-inf)) would be NaN: the first component scales by 0
      sc[r] = st.m_run[r] == -INFINITY ? 0.f : expf(st.m_run[r] - m_new);
      st.p[r] = expf(lg[r] - m_new);
      st.den[r] = fmaf(st.den[r], sc[r], st.p[r]);
      st.m_run[r] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < CP; ++jj)
#pragma unroll
      for (int t = 0; t < C::kT; ++t) {
        const int b = jj * PW / 2 + 4 * t + qd;
        if (b < d) {
          const float4 ba = ld_shared_f4(bins + 32 * b + 16);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 xv;
            if constexpr (C::kKeepX)
              xv = xk[jj][t][r];
            else
              xv = x_at<C::NCX>(xa, rr0 + 8 * r, 2 * b);
            const float hr = fmaf(-ba.w, xv.y, fmaf(ba.z, xv.x, ba.x));
            const float hm = fmaf(ba.w, xv.x, fmaf(ba.z, xv.y, ba.y));
            const int i = 4 * t + 2 * r;
            st.h[jj][i] = fmaf(st.p[r], hr, st.h[jj][i] * sc[r]);
            st.h[jj][i + 1] = fmaf(st.p[r], hm, st.h[jj][i + 1] * sc[r]);
          }
        }
      }
    // The slot is refilled by cp.async.bulk, a write of the async proxy;
    // the barrier's release orders the reads of the record above only
    // against the generic proxy, so this proxy fence keeps the refill from
    // landing before they are performed (fault F2). For SS it also makes
    // the U planes written above visible to wgmma before the warpgroup
    // meets.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warp_arrive(ring.rempty + 8 * slot);
    if constexpr (C::ARS)
      to_a_regs(areg, acc);
    else
      wg_sync(1 + wg);

    // the combine pieces: C = [beta | gamma] comb_k, PW columns a piece,
    // folded as h += p C
    for (int jj = 0; jj < cp; ++jj) {
      int su[C::NCU];
      uint64_t db[C::NCU];
      take_units<C, C::NCU>(ring, s, ph, su, db);
      wgmma_fence();
      fence_operand(acc);
      if constexpr (C::ARS)
        rs_steps<C>(acc, areg, db[0]);
      else
        ss_steps<C, C::NCU>(acc, du, db);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
#pragma unroll
      for (int c = 0; c < C::NCU; ++c) warp_arrive(ring.empty + 8 * su[c]);
#pragma unroll
      for (int j2 = 0; j2 < CP; ++j2) {
        if (j2 == jj) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            st.h[j2][i] = fmaf(st.p[(i >> 1) & 1], acc[i], st.h[j2][i]);
        }
      }
    }
  }

  // 2D is even: a thread's two columns are 8-byte aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = rr0 + 8 * r;
    const int row = row0 + rr;
    if (rr < wg_rows && row < n) {
      const float inv = C::STATS ? 1.f : 1.f / st.den[r];
      float* orow = out + (size_t)row * two_d;
#pragma unroll
      for (int jj = 0; jj < CP; ++jj)
#pragma unroll
        for (int t = 0; t < C::kT; ++t) {
          const int c = jj * PW + 8 * t + 2 * qd;
          if (c < two_d)
            *reinterpret_cast<float2*>(orow + c) =
                make_float2(st.h[jj][4 * t + 2 * r] * inv,
                            st.h[jj][4 * t + 2 * r + 1] * inv);
        }
      if constexpr (C::STATS) {
        if (qd == 0) {  // a row's four threads hold its m and den
          m_out[row] = st.m_run[r];
          den_out[row] = st.den[r];
        }
      }
    }
  }
}

// shared memory of a launch with `stages` ring stages
template <class C>
size_t fact_smem(int stages, int rec_bytes) {
  return 1024 + (size_t)C::WGS * (C::kX + C::kU) +
         (size_t)stages * (C::kStage + 16) + 2 * ((size_t)rec_bytes + 16) +
         (C::COH ? C::WGS * 64 * 4 : 0);
}

// the deepest ring (up to kMaxStages) that fits, 0 if not even one does
template <class C>
int fact_stages(int rec_bytes) {
  int s = kMaxStages;
  while (s > 0 && fact_smem<C>(s, rec_bytes) > (size_t)kSmemMax) --s;
  return s;
}

struct FactArgs {
  const float* x;
  const bf16* planes[3];
  const float* rec;
  const float* cst;
  float* out;
  float* m_out;
  float* den_out;
  int n, d, m, k_comp, t_coh;
  float alpha;
  cudaStream_t stream;
};

// the record's bytes: T mu (2M floats, padded to a multiple of 4) and 8
// floats a bin
inline int rec_bytes_of(int d, int m) {
  return 4 * (((2 * m + 3) & ~3) + 8 * d);
}

template <class C>
int fact_launch(const FactArgs& g) {
  const int rb = rec_bytes_of(g.d, g.m);
  const int stages = fact_stages<C>(rb);
  // a piece's units are in the ring together
  if (stages < (C::NCX > C::NCU ? C::NCX : C::NCU))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fact_smem<C>(stages, rb);
  auto kern = fact_tc_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = C::WGS * (C::COH ? 64 / g.t_coh * g.t_coh : 64);
  kern<<<(g.n + rows - 1) / rows, (C::WGS + 1) * kWg, smem, g.stream>>>(
      g.x, g.planes[0], g.planes[1], g.planes[2], g.rec, g.cst, g.out,
      g.m_out, g.den_out, g.n, g.d, g.m, g.k_comp, stages, rb, g.t_coh,
      g.alpha);
  return (int)cudaGetLastError();
}

// The instantiation for the widths (fact_kernels.fact_tc_shape mirrors the
// layout half of it): NCX = chunks_of(2D), NCU = chunks_of(4M); at NCX <= 2,
// NCU = 1 (D <= 64, M <= 16, the main path) the combine's A in registers
// and two consumer warpgroups where 128-row blocks cover the SMs; else A in
// shared memory, one warpgroup, 64-column pieces while NCX, NCU <= 2,
// 32-column pieces where one of them is 4, 16-column pieces at 4 and 4 (so
// that a piece's units fit beside x's and U's planes).
template <bool COH, bool STATS>
int fact_dispatch(const FactArgs& g) {
  const int ncx = chunks_of(2 * g.d), ncu = chunks_of(4 * g.m);
#define QCE_FACT(NCX_, NCU_, PW_, WGS_, ARS_)                            \
  if (ncx == NCX_ && ncu == NCU_)                                        \
    return fact_launch<FactCfg<NCX_, NCU_, PW_, WGS_, ARS_, COH, STATS>>(g);
  if (ncu == 1 && ncx <= 2) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return (int)cudaErrorInvalidDevice;
    const int wg_rows = COH ? 64 / g.t_coh * g.t_coh : 64;
    if ((g.n + 2 * wg_rows - 1) / (2 * wg_rows) >= sms) {
      QCE_FACT(1, 1, 64, 2, true)
      QCE_FACT(2, 1, 64, 2, true)
    }
    QCE_FACT(1, 1, 64, 1, true)
    QCE_FACT(2, 1, 64, 1, true)
  }
  QCE_FACT(1, 2, 64, 1, false)
  QCE_FACT(2, 2, 64, 1, false)
  QCE_FACT(4, 1, 32, 1, false)
  QCE_FACT(4, 2, 32, 1, false)
  QCE_FACT(1, 4, 32, 1, false)
  QCE_FACT(2, 4, 32, 1, false)
  QCE_FACT(4, 4, 16, 1, false)
#undef QCE_FACT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// x (n, 2d) and out (n, 2d) hold complex values as interleaved [re, im]
// pairs; hi, lo, lo2 and rec are the bank's units and records
// (`fact_kernels.fact_tc_operands`, 16-byte aligned); cst (k_comp) the
// layout's constants. t_coh > 1 selects the coherent kernel K12 (n a whole
// number of t_coh row blocks, t_coh <= 64); stats != 0 selects K13, which
// writes the un-normalised accumulator to out and m, den (n) to m_out,
// den_out. The two are not combined.
extern "C" int fact_estimate_launch(const float* x, const void* hi,
                                    const void* lo, const void* lo2,
                                    const float* rec, const float* cst,
                                    float* out, float* m_out, float* den_out,
                                    int n, int d, int m, int k_comp,
                                    int t_coh, float alpha, int stats,
                                    void* stream) {
  if (n < 0 || d < 1 || d > 128 || m < 1 || m > 64 || k_comp < 1 ||
      t_coh < 1 || t_coh > 64 || n % t_coh != 0 || (stats && t_coh > 1) ||
      (stats && (m_out == nullptr || den_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* aligned[4] = {hi, lo, lo2, rec};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(x) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const FactArgs g{x,
                   {static_cast<const bf16*>(hi), static_cast<const bf16*>(lo),
                    static_cast<const bf16*>(lo2)},
                   rec,
                   cst,
                   out,
                   m_out,
                   den_out,
                   n,
                   d,
                   m,
                   k_comp,
                   t_coh,
                   alpha,
                   static_cast<cudaStream_t>(stream)};
  if (t_coh > 1) return fact_dispatch<true, false>(g);
  if (stats) return fact_dispatch<false, true>(g);
  return fact_dispatch<false, false>(g);
}
