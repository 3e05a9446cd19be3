// The fused wide form of the factored (MFA, low-rank plus diagonal)
// estimation kernels for Hopper: K11 (flat) and K12 (coherent, the COH
// template flag) in one kernel a row tile, at 128 < D <= 256, M <= 16.
//
// Replaces, at those shapes, the TPU kernels `_fact_kernel` (:2048, its
// pallas_call in `estimate_fact_packed` :2091) and `_fact_kernel_coh`
// (:2126, :2183) of quantized_channel_estimation_tpu/estimators/
// pallas_kernels.py, through models/mfa_bank.py's `estimate_factored` and
// its coherent form. Per row x (2D interleaved [re, im] pairs) and
// component k, with the Woodbury factors of the bank:
//
//   [beta | gamma] = x @ fwd_k             (2D, 4M)
//   lg_k  = const_k + z . lcoef_k + |beta - T mu_k|^2,  z = [Re x | Im x |
//                                                             |x|^2]
//   w     = softmax_k(lg')                 K12: lg' = lg + a (s - lg), s
//                                          the sum over the row's block
//   h     = sum_k w_k ([beta | gamma] @ comb_k + bias_k + a1_k o x)
//
// Bound on an H100 (D = 256, K = 32, M = 16, N = 32768;
// `fact_kernels.fact_bound`): the two products as six bf16 products of 2 N
// K (2D 4M + 4M 2D) on the tensor cores (8.2e11, 0.834 ms at 989 TFLOP/s)
// plus 2 N K (3D + 2M + 6D) fp32 epilogue operations (0.073 ms at 67
// TFLOP/s), against the rows read and written once (0.13 GB, 0.040 ms at
// 3.35 TB/s): bound by operations, 0.907 ms.
//
// What holds the wide form of csrc/fact_wide_estimate.cu back there
// (tools/fact_pass_split.py, PERF.md §6): eight kernels a launch with u =
// [beta_k | gamma_k]_k (N, K 4M) fp32 and the combine's operand (3 x N x K
// 4M bf16) written to and read back from device memory, the two SS n64
// products 1.23 ms of its 2.39, and the CUDA-core passes in float64 (the
// quadratic terms, the weighted-rows split and the fold) 0.89 ms. The
// narrow template (csrc/fact_estimate.cu) keeps everything on chip, but at
// 2D = 512 a 64-row tile's x (128 KB fp32) and its output (128 KB fp32,
// 256 registers a thread of one warpgroup) do not fit one block, and the
// bank (12.6 MB of bf16 planes) is read from L2 once a tile: at 64 rows a
// fetch, 6.4 GB at the shape above.
//
// Design: the narrow template's scheme carried past D = 128 by splitting
// 2D's columns four ways across a cluster.
//   - A cluster of four blocks takes a tile of 128 rows (K12: two runs of
//     64 / T whole blocks); block q takes quarter q of 2D's 64-wide chunks
//     (`fused_plan`), both as its part of the forward product's
//     contraction and as its columns of the output, and its two consumer
//     warpgroups take 64 rows each. Both warpgroups read every unit of the
//     bank their block streams, so 128 rows share each fetch (3.2 GB from
//     L2 at the shape above) without a multicast, and the two never wait
//     on each other: one's softmax and exchange run beside the other's
//     products. A warpgroup holds 64 rows x the quarter's columns of the
//     running output (64 registers a thread at 2D = 512).
//   - 288 threads a block: the two consumer warpgroups and one producer
//     warp. ptxas gives it 168 registers a thread, as it gives a block of
//     three warpgroups with `setmaxnreg` (a third of the warps of one SM
//     sub-partition's registers): 0.4-1 KB of spills a thread. 224
//     registers (`__maxnreg__`) does not launch, and 256 threads with
//     the fills issued by the consumers' leaders (255 registers, no
//     spills) ran slower (PERF.md §6).
//   - x sits in shared memory in fp32, each warpgroup's rows of the
//     quarter (32 KB at 2D = 512, an XOR swizzle of 8-float groups by row
//     against bank conflicts); the forward's A fragments are split into
//     their three bf16 planes from it a chunk at a time (RS wgmma, whose A
//     never crosses shared memory), and the fold's bias + a1 o x and the
//     logit's diagonal term read the same fp32 x.
//   - The bank streams as units of 64 columns x 64 deep, three bf16 planes
//     (24 KB, the 128-byte swizzle; n64 wgmma), one ring of stages a block
//     under full / empty mbarriers (each stage released by the eight
//     consumer warps), filled by one producer thread with cp.async.bulk:
//     per component the quarter's forward units (a 64-deep chunk of its
//     contraction x the 4M columns) and then its combine pieces (64 of its
//     output columns x the 4M contraction); each component's record (T mu,
//     then per bin of the quarter lcoef, bias, a1) in one of two slots,
//     released after a proxy fence (fault F2).
//   - The forward: per chunk one commit group of 24 RS wgmma m64n(32 NU)k16
//     into a fresh accumulator, product by product over the chunk's four
//     k16 steps (hi.lo2, lo.lo, lo2.hi, lo.hi, hi.lo, hi.hi: the small
//     ones first, the narrow template's order), waited before the next
//     chunk (no group in flight across a back edge, a barrier's spin loop
//     or a second accumulator: ptxas serialises every wgmma where one is,
//     C7514 / C7517 / C7520), and added to the quarter's partial in fp32.
//     The diagonal term over the quarter's bins runs while the first
//     chunk's products do.
//   - The four quarters' partials of u (and of the diagonal term) meet
//     through distributed shared memory, each warpgroup with the same
//     rows' warpgroups of the other three blocks, as a reduce-scatter and
//     an all-gather: block q owns a quarter of u's columns, receives the
//     other three blocks' partials of them (stores into its buffers, then
//     a release arrive on its barrier), adds the four in a fixed order
//     ((P0 + P1) + (P2 + P3), the plain version's), and sends the sum to
//     the other three; every block then holds the same bits of u. A buffer
//     is reused for the next component without a handshake of its own: a
//     sender writes component k + 1's partial only after it has the
//     receiver's sum of component k, which the receiver sends after
//     reading.
//   - Then the quadratic term from the accumulator registers, the pooling
//     (K12, T <= 64, whole blocks a warpgroup), the online softmax and h =
//     h sc + p (bias + a1 o x), as in the narrow template.
//   - The combine: u becomes the RS A fragments of the combine in registers
//     (FlashAttention-3's P.V pattern, 4M <= 64), and each 64-column piece
//     of the quarter's output is one commit group of the six products over
//     its k16 steps into a fresh fp32 accumulator, folded as h += p C.
//   - Nothing but the output goes to device memory; every block of a
//     cluster meets the others at a cluster barrier before it exits.
// Measured (PERF.md §6, tools/mfa_bank_bench.py fused / fused_reach): at
// D = 256, K = 32, M = 16, 32768 rows 4.5-4.9 ms, half the speed of the
// wide form, with 2.8 ms left when every product is taken out; faster
// than the wide form only at one component (1.4-1.7x), a width no
// workload of the repo runs. So the entries keep the wide form, and only
// the wrappers `fact_estimate_fused[_coherent]` launch this kernel.
// Any N (a whole number of T-row blocks) and K, 129 <= D <= 256, 1 <= M <=
// 16, 1 <= T <= 64. A wait that outlasts ~2^34 cycles traps (a launch
// error) rather than hanging the card.
#include "grouped_tc_stream.cuh"

namespace {

using namespace qce_tc;

constexpr unsigned kUnitPlane = 64 * 128;            // 64 rows x 64 bf16
constexpr unsigned kUnitBytes = 3 * kUnitPlane;      // hi, lo, lo2
constexpr int kFusedMaxStages = 8;
constexpr int kNcw = 2;         // 64-deep chunks of 2D a quarter at most
constexpr int kQuarters = 4;    // blocks a cluster
constexpr long long kWaitCycles = 1LL << 34;
constexpr int kThreads = 2 * kWg + 32;  // two consumer warpgroups, a
                                        // producer warp

// One instantiation: NU 32-column halves of the 4M forward columns and the
// K12 flag.
template <int NU_, bool COH_>
struct FusedCfg {
  static constexpr int NU = NU_;
  static constexpr bool COH = COH_;
  static constexpr int FA = 16 * NU;      // floats of a forward accumulator
  static constexpr int KS = 2 * NU;       // k16 steps of the combine
  static constexpr int SL = FA / 4;       // a thread's floats of a quarter
                                          // of u's columns
  static constexpr int XS = 64 * kNcw;    // floats a row of a warpgroup's x
  static constexpr unsigned kX = 64u * XS * 4u;
  static constexpr unsigned kSlot = kWg * SL * 4u;  // a partial's slot
};

// The shape's split (mirrored by `fact_kernels.fact_fused_plan`): half c of
// the nc 64-wide chunks of 2D (the first ceil(nc / 2)), in it quarter 2 c +
// w's ncw[c][w] chunks from column cb[c][w] (the first ceil(half / 2)), its
// pcs[c][w] 64-column output pieces below 2D, its u[c][w] units a component
// (forward chunks, then combine pieces) at off[c][w] of the component's
// units; rec_floats a record's floats (T mu padded to a multiple of 4, then
// 8 a bin of 64).
struct FusedPlan {
  int nc, nu, ncw[2][2], cb[2][2], pcs[2][2], u[2][2], off[2][2], units,
      rec_floats;
};

__host__ __device__ inline FusedPlan fused_plan(int d, int m) {
  FusedPlan p;
  p.nc = (2 * d + 63) / 64;
  p.nu = (4 * m + 31) / 32;
  const int half[2] = {(p.nc + 1) / 2, p.nc - (p.nc + 1) / 2};
  int at = 0;
  p.units = 0;
  for (int c = 0; c < 2; ++c)
    for (int w = 0; w < 2; ++w) {
      p.ncw[c][w] = w ? half[c] - (half[c] + 1) / 2 : (half[c] + 1) / 2;
      p.cb[c][w] = 64 * at;
      at += p.ncw[c][w];
      const int cols = 2 * d - p.cb[c][w];
      const int own = 64 * p.ncw[c][w];
      p.pcs[c][w] = ((own < cols ? own : cols) + 63) / 64;
      p.u[c][w] = p.ncw[c][w] + p.pcs[c][w];
      p.off[c][w] = p.units;
      p.units += p.u[c][w];
    }
  p.rec_floats = ((2 * m + 3) & ~3) + 8 * 32 * kNcw;
  return p;
}

// mbarrier wait (acquire at cluster scope) that traps instead of spinning
// past ~2^34 cycles
__device__ __forceinline__ void fwait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the address of a shared location of this block in block `rank`'s
// shared memory
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// a warp's arrival on the barrier at `bar` of block `rank`, releasing the
// warp's stores before it at cluster scope
__device__ __forceinline__ void warp_arrive_remote(unsigned bar,
                                                   unsigned rank) {
  __syncwarp();
  if (lane_id() == 0)
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::
            "r"(peer_addr(bar, rank))
        : "memory");
}

__device__ __forceinline__ void st_remote_f4(unsigned remote, float a,
                                             float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ void st_remote_f32(unsigned remote, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// d (+)= A B for a 64 x 64 x 16 (d of 32 floats) or 64 x 32 x 16 (16
// floats) tile, A in registers (this thread's m64k16 fragment), B K-major
// in shared memory at the descriptor db + OB (OB in 16-byte units, added in
// the asm so that only the base stays live); d is overwritten where
// accumulate == 0
template <int OB>
__device__ __forceinline__ void rs_at(float (&d)[32], const unsigned (&a)[4],
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.s64 b, %36, %38;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, b, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(OB));
}

template <int OB>
__device__ __forceinline__ void rs_at(float (&d)[16], const unsigned (&a)[4],
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "add.s64 b, %20, %22;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, b, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(OB));
}

// The six products over S k16 steps into a fresh d, product by product:
// A the fragments a[plane][step], B the unit at db.
template <int S, int N, int I = 0>
__device__ __forceinline__ void six_issue(float (&d)[N],
                                          const unsigned (&a)[3][S][4],
                                          uint64_t db) {
  if constexpr (I < 6 * S) {
    constexpr int P = I / S, ks = I % S;
    constexpr int ob = (prod_b(6, P) * (int)kUnitPlane + ks * 32) >> 4;
    rs_at<ob>(d, a[prod_a(6, P)][ks], db, I > 0);
    six_issue<S, N, I + 1>(d, a, db);
  }
}

// six_issue as one commit group (the caller waits for it)
template <int S, int N>
__device__ __forceinline__ void six_products(float (&d)[N],
                                             const unsigned (&a)[3][S][4],
                                             uint64_t db) {
  wgmma_fence();
  fence_operand(d);
  six_issue<S>(d, a, db);
  wgmma_commit();
  fence_operand(d);
}

// This thread's A fragments of x's 64-deep chunk at local column lc0, split
// into their three planes: step s, register e holds columns lc0 + 16 s + 8
// (e >> 1) + 2 (lane % 4) + {0, 1} of row rr0 + 8 (e & 1); xt is the
// thread's row base (row rr0, float units).
template <class C>
__device__ __forceinline__ void x_frags(unsigned (&a)[3][4][4], unsigned xs,
                                        int xt, int lc0) {
  const int qd = lane_id() & 3, sw = ((lane_id() >> 2) & 7) << 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lc = (lc0 + 16 * s + 8 * (e >> 1) + 2 * qd) ^ sw;
      const float2 v = ld_shared_f2(xs + 4 * (xt + 8 * (e & 1) * C::XS + lc));
      unsigned w[3];
      split3(v.x, v.y, w);
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q][s][e] = w[q];
    }
}

// x at (row rr0 + 8 r, local column lc) of a warpgroup's fp32 x
template <class C>
__device__ __forceinline__ float2 x_at(unsigned xs, int xt, int r, int lc) {
  const int sw = ((lane_id() >> 2) & 7) << 3;
  return ld_shared_f2(xs + 4 * (xt + 8 * r * C::XS + (lc ^ sw)));
}

// u (FA floats in the m64n(32 NU) accumulator layout, 4M <= 32 NU
// columns) -> the combine's A fragments: step s, register e holds columns
// 16 s + 8 (e >> 1) + 2 (lane % 4) + {0, 1} of row lane / 4 + 8 (e & 1),
// accumulator pair 4 (2 s + (e >> 1)) + 2 (e & 1)
template <class C>
__device__ __forceinline__ void u_frags(unsigned (&a)[3][C::KS][4],
                                        const float (&u)[C::FA]) {
#pragma unroll
  for (int s = 0; s < C::KS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (2 * s + (e >> 1)) + 2 * (e & 1);
      unsigned w[3];
      split3(u[i], u[i + 1], w);
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q][s][e] = w[q];
    }
}

// The kernel. x (n, 2D) fp32 interleaved; hi, lo, lo2: the bank's units
// (`fact_kernels.fact_fused_operands`: (k_comp, units, 64, 64) bf16, per
// component each quarter's units at off[c][w]); recs (k_comp, 4,
// rec_floats): per component and quarter T mu (2M, padded to a multiple of
// 4), then per bin of the quarter's columns (l0, l1, l2, 0, Re b, Im b, Re
// a1, Im a1); cst (k_comp); out (n, 2D); K12: t_coh, alpha.
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
    fact_fused_kernel(const float* __restrict__ x, const bf16* __restrict__ hi,
                      const bf16* __restrict__ lo,
                      const bf16* __restrict__ lo2,
                      const float* __restrict__ recs,
                      const float* __restrict__ cst, float* __restrict__ out,
                      int n, int d, int m, int k_comp, int stages,
                      int t_coh, float alpha) {
  constexpr int FA = C::FA, KS = C::KS, XS = C::XS, SL = C::SL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const FusedPlan pl = fused_plan(d, m);
  const int two_d = 2 * d, two_m = 2 * m;
  const unsigned q = cluster_rank();  // the block's quarter of 2D
  const int qc = q >> 1, qw = q & 1;
  const int ncw = pl.ncw[qc][qw], pcs = pl.pcs[qc][qw];
  const int uq = pl.u[qc][qw];        // the block's units a component
  const unsigned rec_bytes = 4u * pl.rec_floats;
  const unsigned ring = base + 2 * C::kX;
  const unsigned recs0 = ring + stages * kUnitBytes;
  // per consumer warpgroup three slots (one for each other quarter, in rank
  // order) of the partials of its owned columns (rs), of the other
  // quarters' sums (ag) and of the diagonal term's partials (ln, 64 floats)
  const unsigned rs0 = recs0 + 2u * rec_bytes;
  const unsigned ag0 = rs0 + 2u * 3u * C::kSlot;
  const unsigned ln0 = ag0 + 2u * 3u * C::kSlot;
  const unsigned pool0 = ln0 + 2u * 3u * 64u * 4u;  // K12: 2 x 64 logits
  const unsigned full0 = pool0 + 2u * 64u * 4u;     // a stage each
  const unsigned empty0 = full0 + 8u * stages;
  const unsigned rfull0 = empty0 + 8u * stages;     // a record slot each
  const unsigned rempty0 = rfull0 + 16u;
  const unsigned rsfull0 = rempty0 + 16u;           // a warpgroup each
  const unsigned agfull0 = rsfull0 + 16u;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8);  // the block's eight consumer warps
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(rfull0 + 8 * i, 1);
      mbar_init(rempty0 + 8 * i, 8);
      mbar_init(rsfull0 + 8 * i, 3 * 4);  // three blocks' four warps
      mbar_init(agfull0 + 8 * i, 3 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any store or arrive

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer warp: one thread fills the ring
    if (threadIdx.x == 2 * kWg) {
      int s = 0, ph = 0;
      for (int k = 0; k < k_comp; ++k) {
        const unsigned slot = k & 1;
        fwait(rempty0 + 8 * slot, ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(rfull0 + 8 * slot, rec_bytes);
        bulk_copy(recs0 + slot * rec_bytes,
                  recs + ((size_t)k * kQuarters + q) * pl.rec_floats,
                  rec_bytes, rfull0 + 8 * slot);
        for (int i = 0; i < uq; ++i) {
          const unsigned full = full0 + 8 * s;
          fwait(empty0 + 8 * s, ph ^ 1);
          mbar_expect_tx(full, kUnitBytes);
          const size_t off =
              ((size_t)k * pl.units + pl.off[qc][qw] + i) * kUnitPlane;
          const unsigned dst = ring + s * kUnitBytes;
          bulk_copy(dst, reinterpret_cast<const char*>(hi) + off, kUnitPlane,
                    full);
          bulk_copy(dst + kUnitPlane, reinterpret_cast<const char*>(lo) + off,
                    kUnitPlane, full);
          bulk_copy(dst + 2 * kUnitPlane,
                    reinterpret_cast<const char*>(lo2) + off, kUnitPlane,
                    full);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    const int cb = pl.cb[qc][qw];                // first column of 2D
    const int cols = min(64 * ncw, two_d - cb);  // the quarter's columns
    const int rows = C::COH ? 64 / t_coh * t_coh : 64;
    const int row0 = (blockIdx.x / kQuarters) * 2 * rows + wg * rows;
    const unsigned xs = base + wg * C::kX;
    const int tid = threadIdx.x % kWg;
    const int qd = lane_id() & 3;
    const int rr0 = row_in_wg();
    const int xt = rr0 * XS;
    const unsigned rs = rs0 + wg * 3u * C::kSlot;
    const unsigned ag = ag0 + wg * 3u * C::kSlot;
    const unsigned ln = ln0 + wg * 3u * 256u;
    const unsigned rsfull = rsfull0 + 8 * wg, agfull = agfull0 + 8 * wg;
    // the slot of quarter j's data in block `to`'s buffers
    const auto slot_of = [](unsigned j, unsigned to) {
      return j < to ? j : j - 1;
    };

    // the warpgroup's rows of the quarter's columns, fp32, rows past the
    // tile or n and columns past 2D zero; a row's 8-float groups
    // XOR-swizzled by row
    for (int i = tid; i < 64 * 32 * ncw; i += kWg) {
      const int rr = i / (32 * ncw), lc = 2 * (i - rr * 32 * ncw);
      const int row = row0 + rr, c = cb + lc;
      float2 v = make_float2(0.f, 0.f);
      if (rr < rows && row < n && c < two_d)
        v = __ldg(reinterpret_cast<const float2*>(x + (size_t)row * two_d +
                                                  c));
      const unsigned at = xs + 4 * (rr * XS + (lc ^ ((rr & 7) << 3)));
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(v.x),
                   "f"(v.y)
                   : "memory");
    }
    wg_sync(1 + wg);

    float h[kNcw][32];
#pragma unroll
    for (int j = 0; j < kNcw; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) h[j][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
    const Epi ep{nullptr, 0, 0, t_coh, alpha, 0.f, pool0};
    int s = 0;
    unsigned ph = 0;

    for (int k = 0; k < k_comp; ++k) {
      const unsigned slot = k & 1;
      const unsigned rec = recs0 + slot * rec_bytes;
      const unsigned bins = rec + 4 * ((two_m + 3) & ~3);
      // the forward: the quarter's partial of [beta | gamma] = x fwd_k, a
      // chunk at a time
      float u[FA], acc[FA];
      float lin[2] = {0.f, 0.f};
      for (int c = 0; c < ncw; ++c) {
        unsigned a[3][4][4];
        x_frags<C>(a, xs, xt, 64 * c);
        const int st = s;
        fwait(full0 + 8 * st, ph);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
        // the record was copied before the units; its wait comes before
        // the products (a barrier's spin loop between a wgmma and its wait
        // makes ptxas inject a wait)
        if (c == 0) fwait(rfull0 + 8 * slot, (k >> 1) & 1);
        six_products<4>(acc, a, sw128_desc(ring + st * kUnitBytes));
        if (c == 0) {
          // while the products run: the diagonal term over the quarter's
          // bins 32 jj + 4 t + lane % 4 (local)
#pragma unroll
          for (int jj = 0; jj < kNcw; ++jj) {
            if (64 * jj < cols) {
#pragma unroll
              for (int t = 0; t < 8; ++t) {
                const int b = 32 * jj + 4 * t + qd;
                const float4 lc = ld_shared_f4(bins + 32 * b);
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const float2 xv = x_at<C>(xs, xt, r, 2 * b);
                  lin[r] = fmaf(lc.x, xv.x, lin[r]);
                  lin[r] = fmaf(lc.y, xv.y, lin[r]);
                  lin[r] = fmaf(lc.z, fmaf(xv.x, xv.x, xv.y * xv.y), lin[r]);
                }
              }
            }
          }
        }
        wgmma_wait<0>();
        fence_operand(acc);
        warp_arrive(empty0 + 8 * st);
#pragma unroll
        for (int i = 0; i < FA; ++i) u[i] = c ? u[i] + acc[i] : acc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lin[r] += __shfl_xor_sync(0xffffffffu, lin[r], 1);
        lin[r] += __shfl_xor_sync(0xffffffffu, lin[r], 2);
      }

      // reduce-scatter: quarter j of u's columns (the thread's floats SL j
      // + [0, SL)) to block j, the diagonal term to every other block
#pragma unroll
      for (int j = 0; j < kQuarters; ++j) {
        if (j == (int)q) continue;
        const unsigned to =
            peer_addr(rs + slot_of(q, j) * C::kSlot + 4u * SL * tid, j);
#pragma unroll
        for (int i = 0; i < SL; i += 4)
          st_remote_f4(to + 4 * i, u[SL * j + i], u[SL * j + i + 1],
                       u[SL * j + i + 2], u[SL * j + i + 3]);
        if (qd == 0) {
          const unsigned lt = peer_addr(ln + slot_of(q, j) * 256u, j);
          st_remote_f32(lt + 4 * rr0, lin[0]);
          st_remote_f32(lt + 4 * (rr0 + 8), lin[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kQuarters; ++j)
        if (j != (int)q) warp_arrive_remote(rsfull, j);
      fwait(rsfull, k & 1);
      // the owned quarter's sum, (P0 + P1) + (P2 + P3) in rank order, and
      // the diagonal term's likewise
      float own[SL];
      {
        float pj[kQuarters][SL];
#pragma unroll
        for (int j = 0; j < kQuarters; ++j)
#pragma unroll
          for (int i = 0; i < SL; i += 4) {
            if (j == (int)q) {
#pragma unroll
              for (int e = 0; e < 4; ++e) pj[j][i + e] = u[SL * j + i + e];
            } else {
              const float4 v = ld_shared_f4(rs + slot_of(j, q) * C::kSlot +
                                            4u * (SL * tid + i));
              pj[j][i] = v.x;
              pj[j][i + 1] = v.y;
              pj[j][i + 2] = v.z;
              pj[j][i + 3] = v.w;
            }
          }
#pragma unroll
        for (int i = 0; i < SL; ++i)
          own[i] = (pj[0][i] + pj[1][i]) + (pj[2][i] + pj[3][i]);
        float lj[kQuarters][2];
#pragma unroll
        for (int j = 0; j < kQuarters; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            lj[j][r] = j == (int)q
                           ? lin[r]
                           : ld_shared_f32(ln + slot_of(j, q) * 256u +
                                           4 * (rr0 + 8 * r));
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lin[r] = (lj[0][r] + lj[1][r]) + (lj[2][r] + lj[3][r]);
      }
      // all-gather: the owned quarter's sum to every other block
#pragma unroll
      for (int j = 0; j < kQuarters; ++j) {
        if (j == (int)q) continue;
        const unsigned to =
            peer_addr(ag + slot_of(q, j) * C::kSlot + 4u * SL * tid, j);
#pragma unroll
        for (int i = 0; i < SL; i += 4)
          st_remote_f4(to + 4 * i, own[i], own[i + 1], own[i + 2],
                       own[i + 3]);
      }
#pragma unroll
      for (int j = 0; j < kQuarters; ++j)
        if (j != (int)q) warp_arrive_remote(agfull, j);
      fwait(agfull, k & 1);
#pragma unroll
      for (int j = 0; j < kQuarters; ++j)
#pragma unroll
        for (int i = 0; i < SL; i += 4) {
          if (j == (int)q) {
#pragma unroll
            for (int e = 0; e < 4; ++e) u[SL * j + i + e] = own[i + e];
          } else {
            const float4 v = ld_shared_f4(ag + slot_of(j, q) * C::kSlot +
                                          4u * (SL * tid + i));
            u[SL * j + i] = v.x;
            u[SL * j + i + 1] = v.y;
            u[SL * j + i + 2] = v.z;
            u[SL * j + i + 3] = v.w;
          }
        }

      // the quadratic term: beta's columns 8 t + 2 (lane % 4) + {0, 1}
      // below 2M, a thread's as a tree, then the row's four threads
      float qt[2];
      {
        float part[2][FA / 2];
#pragma unroll
        for (int t = 0; t < FA / 4; ++t) {
          const int c = 8 * t + 2 * qd;
          const bool live = c < two_m;  // 2M is even: a pair is in or out
          const float2 mu =
              live ? ld_shared_f2(rec + 4 * c) : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dv = u[4 * t + 2 * r + e] - (e ? mu.y : mu.x);
              part[r][2 * t + e] = live ? dv * dv : 0.f;
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qt[r] = tree_sum<FA / 2>(part[r]);
          qt[r] += __shfl_xor_sync(0xffffffffu, qt[r], 1);
          qt[r] += __shfl_xor_sync(0xffffffffu, qt[r], 2);
        }
      }
      // the two sums cancel at high SNR: each was reduced on its own
      const float ck = __ldg(cst + k);
      float lg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) lg[r] = (ck + lin[r]) + qt[r];
      if constexpr (C::COH) pool_logits(lg, ep);

      // the online softmax, then h = h sc + p (bias + a1 o x)
      float sc[2], p[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], lg[r]);
        // exp(-inf - (-inf)) would be NaN: the first component scales by 0
        sc[r] = m_run[r] == -INFINITY ? 0.f : expf(m_run[r] - m_new);
        p[r] = expf(lg[r] - m_new);
        den[r] = fmaf(den[r], sc[r], p[r]);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int jj = 0; jj < kNcw; ++jj) {
        if (64 * jj < cols) {
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int b = 32 * jj + 4 * t + qd;
            const float4 ba = ld_shared_f4(bins + 32 * b + 16);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 xv = x_at<C>(xs, xt, r, 2 * b);
              const float hr = fmaf(-ba.w, xv.y, fmaf(ba.z, xv.x, ba.x));
              const float hm = fmaf(ba.w, xv.x, fmaf(ba.z, xv.y, ba.y));
              const int i = 4 * t + 2 * r;
              h[jj][i] = fmaf(p[r], hr, h[jj][i] * sc[r]);
              h[jj][i + 1] = fmaf(p[r], hm, h[jj][i + 1] * sc[r]);
            }
          }
        }
      }
      // The slot is refilled by cp.async.bulk, a write of the async proxy:
      // this proxy fence keeps the refill from landing before the generic
      // reads of the record above are performed (fault F2).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warp_arrive(rempty0 + 8 * slot);

      // the combine: C = [beta | gamma] comb_k a 64-column piece of the
      // quarter's output at a time, with u as the A fragments in
      // registers, folded as h += p C
      unsigned areg[3][KS][4];
      u_frags<C>(areg, u);
#pragma unroll
      for (int jj = 0; jj < kNcw; ++jj) {
        if (jj < pcs) {
          float cacc[32];
          const int st = s;
          fwait(full0 + 8 * st, ph);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
          six_products<KS>(cacc, areg, sw128_desc(ring + st * kUnitBytes));
          wgmma_wait<0>();
          fence_operand(cacc);
          warp_arrive(empty0 + 8 * st);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            h[jj][i] = fmaf(p[(i >> 1) & 1], cacc[i], h[jj][i]);
        }
      }
    }

    // 2D is even: a thread's two columns are 8-byte aligned
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = rr0 + 8 * r;
      const int row = row0 + rr;
      if (rr < rows && row < n) {
        const float inv = 1.f / den[r];
        float* orow = out + (size_t)row * two_d + cb;
#pragma unroll
        for (int jj = 0; jj < kNcw; ++jj)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int c = 64 * jj + 8 * t + 2 * qd;
            if (c < cols)
              *reinterpret_cast<float2*>(orow + c) =
                  make_float2(h[jj][4 * t + 2 * r] * inv,
                              h[jj][4 * t + 2 * r + 1] * inv);
          }
      }
    }
  }
  // no block leaves while another of the cluster may still store into it
  // or arrive on it
  __syncwarp();
  cluster_sync();
}

// shared memory of a launch with `stages` ring stages
template <class C>
size_t fused_smem(int stages, int rec_bytes) {
  return 1024 + 2 * (size_t)C::kX + (size_t)stages * (kUnitBytes + 16) +
         2 * (size_t)rec_bytes + 2 * 2 * 3 * (size_t)C::kSlot +
         2 * 3 * 64 * 4 + 2 * 64 * 4 + 64;
}

struct FusedArgs {
  const float* x;
  const bf16* planes[3];
  const float* rec;
  const float* cst;
  float* out;
  int n, d, m, k_comp, t_coh;
  float alpha;
  cudaStream_t stream;
};

template <class C>
int fused_launch(const FusedArgs& g) {
  const FusedPlan pl = fused_plan(g.d, g.m);
  const int rb = 4 * pl.rec_floats;
  int stages = kFusedMaxStages;
  while (stages > 0 && fused_smem<C>(stages, rb) > (size_t)kSmemMax) --stages;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fused_smem<C>(stages, rb);
  auto kern = fact_fused_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 2 * (C::COH ? 64 / g.t_coh * g.t_coh : 64);
  const int tiles = (g.n + rows - 1) / rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kQuarters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kQuarters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, g.x, g.planes[0], g.planes[1],
                           g.planes[2], g.rec, g.cst, g.out, g.n, g.d, g.m,
                           g.k_comp, stages, g.t_coh, g.alpha);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation for the widths: NU = ceil(4M / 32) (1 or 2).
template <bool COH>
int fused_dispatch(const FusedArgs& g) {
  return fused_plan(g.d, g.m).nu == 1 ? fused_launch<FusedCfg<1, COH>>(g)
                                      : fused_launch<FusedCfg<2, COH>>(g);
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// x (n, 2d) and out (n, 2d) hold complex values as interleaved [re, im]
// pairs; hi, lo, lo2 and rec are the bank's units and records
// (`fact_kernels.fact_fused_operands`, 16-byte aligned); cst (k_comp) the
// layout's constants. t_coh > 1 selects K12 (n a whole number of t_coh row
// blocks, t_coh <= 64). 129 <= d <= 256, 1 <= m <= 16.
extern "C" int fact_fused_launch(const float* x, const void* hi,
                                 const void* lo, const void* lo2,
                                 const float* rec, const float* cst,
                                 float* out, int n, int d, int m, int k_comp,
                                 int t_coh, float alpha, void* stream) {
  if (n < 0 || d < 129 || d > 256 || m < 1 || m > 16 || k_comp < 1 ||
      t_coh < 1 || t_coh > 64 || n % t_coh != 0)
    return (int)cudaErrorInvalidValue;
  const void* aligned[4] = {hi, lo, lo2, rec};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const FusedArgs g{x,
                    {static_cast<const bf16*>(hi), static_cast<const bf16*>(lo),
                     static_cast<const bf16*>(lo2)},
                    rec,
                    cst,
                    out,
                    n,
                    d,
                    m,
                    k_comp,
                    t_coh,
                    alpha,
                    static_cast<cudaStream_t>(stream)};
  return t_coh > 1 ? fused_dispatch<true>(g) : fused_dispatch<false>(g);
}
