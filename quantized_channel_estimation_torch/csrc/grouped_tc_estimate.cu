// K1 with its GEMMs on bf16 tensor cores for Hopper: kernel K14b, the
// opt-in precision modes 'bf16', 'split2' and 'split3'.
//
// Replaces the TPU kernels `_estimate_kernel_block_grouped_bf16` and
// `_estimate_kernel_block_grouped_split` launched by
// `estimate_packed_block_grouped` with mode='bf16' / 'split3' / 'split2'
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:430, :440,
// dispatch :511-530, pallas_call :536). Per row n of r2 = [Re r | Im r]
// (N x 2M) and component k, K1's estimate
//
//   lg_nk = logw_k - |yz_k[:, :2M] - mu_k|^2
//   h2_n  = sum_k softmax_k(lg_nk) (yz_k[:, 2M:] + b_k)
//
// with yz_k = r2 pw_k formed from bf16 planes: pw_hi = bf16(pw), pw_lo =
// bf16(pw - pw_hi) (split in the wrapper), r_hi = bf16(r2), r_lo =
// bf16(r2 - r_hi) (split here, per tile), all rounded to nearest even, and
//
//   PASSES = 1 ('bf16'):   yz = r_hi pw_hi
//   PASSES = 2 ('split2'): yz = r_hi pw_hi + r_hi pw_lo
//   PASSES = 3 ('split3'): yz = r_hi pw_hi + r_hi pw_lo + r_lo pw_hi
//
// each product of two bf16 values exact in the fp32 accumulator; the
// dropped r_lo pw_lo term is O(2^-16) of the product. mu, b, logw, the
// quadratic term, the softmax and the combine stay fp32.
//
// Bound on an H100: PASSES 2 N 2M (2M+2D) K operations on the bf16 tensor
// cores (5.5e11 a pass for 131072 rows at M = D = K = 64: 0.56, 1.11 and
// 1.67 ms at 989 TFLOP/s) plus 2 N K (2M + 2D) fp32 epilogue operations
// (4.3e9, 0.06 ms at 67 TFLOP/s), against ~0.15 GB of compulsory traffic
// (0.04 ms at 3.35 TB/s).
//
// Design (wgmma). The first version ran mma.sync on 64-row tiles of
// one 8-warp block an SM, streamed the bank through a 2-stage ring with two
// block barriers a 32-row slice and ran the epilogue from an fp32 yz tile
// in shared memory while the tensor cores idled: 10.9 / 15.7 / 16.8 ms for
// bf16 / split2 / split3 (PERF.md). Now:
//   - a block is WGS = 2 consumer warpgroups of 64 rows each (1 at the
//     widest, where their shared memory or registers do not fit) and one
//     producer warpgroup, so the bank is read from L2 once per 128 rows;
//     `setmaxnreg` gives the consumers 232 registers, the producer 40;
//   - the bank's columns are cut into pieces of 64 (the logit half [0, 2M)
//     in mp pieces, then the value half [2M, 2M + 2D) in DP pieces, each
//     zero-padded); the wrapper lays every (component, piece) out once in
//     the wgmma B layout (`variant_kernels.tc_slab`: K-major, 128-byte
//     swizzle, Kp = 2M rounded up to 64 contraction rows), so one piece of
//     one plane is one contiguous run of Kp * 128 bytes, and mu / b by
//     piece (`tc_vectors`: 64 fp32 values a piece);
//   - one producer thread copies piece after piece (its planes and its 64
//     vector values) with cp.async.bulk into a ring of 2-8 stages, each
//     guarded by a full and an empty mbarrier; the consumers never meet at
//     a block barrier;
//   - up to 2M = 128 and 2D = 128 (the main path) each thread holds its
//     rows' r_hi (and r_lo) as wgmma A fragments in registers, so a
//     product reads only B from shared memory; wider, the warpgroup keeps
//     them in shared memory (K-major, 128-byte swizzle);
//   - each piece is PASSES x Kp / 16 wgmma m64n64k16 (bf16 -> fp32) into
//     one of two register accumulators, and the next piece is issued
//     before this one is read, so a piece's epilogue overlaps the next
//     piece's products (and the other warpgroup's); no wgmma group is in
//     flight across a loop's back edge (ptxas serialises every wgmma of a
//     kernel where one is): with A in registers a component's pieces run
//     as one unrolled chain, in shared memory in pairs;
//   - the epilogue reads the accumulators in registers: a logit piece adds
//     its columns to the rows' quadratic terms (each thread holds two rows,
//     a row's four threads reduced by quad shuffles after the last logit
//     piece, then the online softmax), a value piece folds p (yz + b) into
//     the running output with the softmax rescale; mu and b come from the
//     stage in shared memory; no yz tile, no barrier a component;
//   - the ragged last tile is masked in the kernel (any N, no padding);
//   - a consumer releases a stage only after a proxy fence orders its
//     generic reads of the stage's mu / b before the async refill (see
//     consume_piece; without it a warp can read the next piece's).
// Measured (chip_smoke, H100 80GB HBM3 at 700 W, 131072 rows, K = D = 64;
// the ranges and the fence's cost in PERF.md): bf16 1.24 ms, split2 1.69,
// split3 2.17 (1.21-1.33 / 1.64-1.80 / 2.14-2.32 in earlier runs),
// against the one-call bf16 GEMM yardsticks 1.75-1.86 / 3.42-3.65 /
// 5.13-5.38 and bounds 0.62 / 1.18 / 1.73. Each
// extra pass adds ~0.5 ms, less than a pass takes at the bf16 peak, so
// the later passes hide under the epilogue: what bounds bf16 now is the
// fp32 epilogue and the pipeline (PERF.md).
// Any N and K, 2M and 2D up to 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPiece = 64;             // columns a piece: wgmma N
constexpr int kAtomBytes = 64 * 128;   // 64 rows x 64 bf16 of contraction
constexpr int kMaxStages = 8;
constexpr int kWg = 128;               // threads a warpgroup
constexpr int kSmemMax = 232448;       // a block's shared memory on an H100

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_v4(unsigned addr, const unsigned* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// A wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of d across an asynchronous wgmma
__device__ __forceinline__ void fence_operand(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 64 x 16 tile: A, B K-major bf16 in shared memory
// (descriptors), d fp32 in the wgmma accumulator layout; d is overwritten
// where accumulate == 0
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B for a 64 x 64 x 16 tile with A in registers: a, this thread's
// 4 registers of bf16 pairs in the m16n8k16 A layout of its warp's 16 rows
// (rows lane / 4 and + 8, columns 2 (lane % 4) + {0, 1} and + 8); B
// K-major in shared memory
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// Shared memory: the barriers (full, then empty, kMaxStages each), each
// stage's 64 fp32 vector values (mu_k or b_k of its columns), then,
// 1024-aligned, with A in shared memory each warpgroup's A planes
// [plane][chunk][64 rows][128 B], and the ring of stages, a stage one piece
// of each B plane [plane][chunk][64 columns][128 B].
struct Ring {
  unsigned full, empty;  // barrier arrays
  unsigned vec;          // stage 0's vector values
  unsigned a;            // this warpgroup's first A plane (A in smem)
  unsigned a_bytes;      // one A plane (= one B plane of a piece)
  unsigned b;            // stage 0
  unsigned stage_bytes;
  int n_ch;              // 64-row contraction chunks: Kp / 64
  int stages;
};

// A position in the sequence of pieces: piece j of component k, in ring
// stage s of ring round parity ph; advanced without divisions.
struct Cursor {
  int k, j, s, ph;
  __device__ __forceinline__ void next(int pieces, int stages) {
    if (++j == pieces) {
      j = 0;
      ++k;
    }
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The producer: one thread copies piece after piece (its B planes and its
// vector values) into the ring.
template <int BPLANES>
__device__ __forceinline__ void produce(const Ring& ring, const bf16* hi,
                                        const bf16* lo, const float* vec,
                                        int total) {
  const unsigned piece = ring.a_bytes;
  int s = 0, ph = 0;
  for (int g = 0; g < total; ++g) {
    const unsigned full = ring.full + 8 * s;
    mbar_wait(ring.empty + 8 * s, ph ^ 1);
    mbar_expect_tx(full, ring.stage_bytes + kPiece * 4);
    bulk_copy(ring.vec + s * (kPiece * 4), vec + (size_t)g * kPiece,
              kPiece * 4, full);
    const size_t off = (size_t)g * piece;  // slab order (k, piece)
    const unsigned dst = ring.b + s * ring.stage_bytes;
    bulk_copy(dst, reinterpret_cast<const char*>(hi) + off, piece, full);
    if constexpr (BPLANES == 2)
      bulk_copy(dst + piece, reinterpret_cast<const char*>(lo) + off, piece,
                full);
    if (++s == ring.stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

// A operand: KCH > 0 holds this thread's fragments of r_hi (and r_lo) for
// KCH 64-wide contraction chunks in registers; KCH = 0 reads the
// warpgroup's A planes in shared memory.
template <int PASSES, int KCH>
struct AOperand {
  static constexpr int kSteps = KCH * 4;
  unsigned hi[kSteps > 0 ? kSteps : 1][4];
  unsigned lo[kSteps > 0 ? kSteps : 1][4];  // read at PASSES = 3 only
};

// Wait for the piece at `at` and issue its products into d: PASSES x Kp /
// 16 wgmma, the first overwriting d.
template <int PASSES, int KCH>
__device__ __forceinline__ void issue_piece(float (&d)[32], const Cursor& at,
                                            const Ring& ring,
                                            const AOperand<PASSES, KCH>& a) {
  mbar_wait(ring.full + 8 * at.s, at.ph);
  const unsigned bs = ring.b + at.s * ring.stage_bytes;
  wgmma_fence();
  fence_operand(d);
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const unsigned bb = bs + (pass == 1 ? ring.a_bytes : 0u);
    if constexpr (KCH > 0) {
#pragma unroll
      for (int ks = 0; ks < KCH * 4; ++ks)
        wgmma_64x64_rs(d, pass == 2 ? a.lo[ks] : a.hi[ks],
                       sw128_desc(bb + (ks >> 2) * kAtomBytes + (ks & 3) * 32),
                       pass > 0 || ks > 0);
    } else {
      const unsigned aa = ring.a + (pass == 2 ? ring.a_bytes : 0u);
      for (int ks = 0; ks < ring.n_ch * 4; ++ks) {
        const unsigned koff = (ks >> 2) * kAtomBytes + (ks & 3) * 32;
        wgmma_64x64(d, sw128_desc(aa + koff), sw128_desc(bb + koff),
                    pass > 0 || ks > 0);
      }
    }
  }
  wgmma_commit();
  fence_operand(d);
}

// A thread's rows (accumulator rows lane / 4 and + 8 of its warp's 16):
// the running output at columns 8 t + 2 (lane % 4) + {0, 1} of each value
// piece, t < 8, and the online-softmax state.
template <int DP>
struct Rows {
  float o[DP][32];
  float m_run[2], den[2];
  float q[2], sc[2], p[2];  // the current component's
};

// The epilogue of the piece at `at`, whose products are complete in d; its
// stage is released after the epilogue has used the stage's vector values.
template <int DP>
__device__ __forceinline__ void consume_piece(Rows<DP>& st,
                                              const float (&d)[32],
                                              const Cursor& at,
                                              const Ring& ring,
                                              const float* logw, int mp,
                                              int lane) {
  const int col_l = 2 * (lane & 3);
  // this lane's vector values: columns 8 t + col_l + {0, 1} of the piece
  float2 v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    unsigned lo, hi;
    asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                 : "=r"(lo), "=r"(hi)
                 : "r"(ring.vec + at.s * (kPiece * 4) + (8 * t + col_l) * 4)
                 : "memory");
    v[t] = make_float2(__uint_as_float(lo), __uint_as_float(hi));
  }
  if (at.j < mp) {  // a logit piece: the quadratic term of its columns
    if (at.j == 0) st.q[0] = st.q[1] = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mc = h ? v[t].y : v[t].x;  // padding: 0 and 0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float dv = d[4 * t + 2 * r + h] - mc;
          st.q[r] = fmaf(dv, dv, st.q[r]);
        }
      }
    if (at.j == mp - 1) {  // the rows' logits complete: online softmax
      const float lw = __ldg(logw + at.k);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float q = st.q[r];
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        const float logit = lw - q;
        const float m_new = fmaxf(st.m_run[r], logit);
        // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales by 0
        st.sc[r] =
            st.m_run[r] == -INFINITY ? 0.f : expf(st.m_run[r] - m_new);
        st.p[r] = logit == -INFINITY ? 0.f : expf(logit - m_new);
        st.den[r] = fmaf(st.den[r], st.sc[r], st.p[r]);
        st.m_run[r] = m_new;
      }
    }
  } else {  // a value piece: fold p (yz + b) into the output
    const int jd = at.j - mp;
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      if (jj == jd) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float bc = h ? v[t].y : v[t].x;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * t + 2 * r + h;
              st.o[jj][i] = fmaf(st.p[r], d[i] + bc, st.o[jj][i] * st.sc[r]);
            }
          }
      }
    }
  }
  // The stage is refilled by cp.async.bulk, a write of the async proxy;
  // the barrier's release orders the reads of v above only against the
  // generic proxy, so only this proxy fence keeps the refill from landing
  // before they are performed, when a warp would read the next piece's mu
  // / b. Released right after the reads, a copy without the fence failed
  // 1290 of 2000 launches (2M = 256, 2D = 24, N = 50693, bf16;
  // `tools/tc_repeat_check.py`); here, after the math that used v, the
  // fence finds the reads done and costs less. Then release the stage.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty + 8 * at.s);
}

// A consumer warpgroup's two halves of a piece: issuing its products and,
// once they are complete, its epilogue; each advances its cursor.
template <int PASSES, int KCH, int DP>
struct Step {
  const Ring& ring;
  const AOperand<PASSES, KCH>& a;
  const float* logw;
  int mp, pieces, lane;

  __device__ __forceinline__ void issue(float (&d)[32], Cursor& at) const {
    issue_piece<PASSES, KCH>(d, at, ring, a);
    at.next(pieces, ring.stages);
  }
  __device__ __forceinline__ void consume(float (&d)[32], Rows<DP>& st,
                                          Cursor& at) const {
    fence_operand(d);
    consume_piece<DP>(st, d, at, ring, logw, mp, lane);
    at.next(pieces, ring.stages);
  }
};

// Pieces J .. P - 1 of a component whose piece J is in flight in cur:
// issue piece J + 1 into nxt, consume piece J, go on with the two swapped;
// the last waits for all, so nothing is left in flight.
template <int J, int P, int PASSES, int KCH, int DP>
__device__ __forceinline__ void component_chain(
    const Step<PASSES, KCH, DP>& step, float (&cur)[32], float (&nxt)[32],
    Rows<DP>& st, Cursor& issued, Cursor& done) {
  if constexpr (J < P) {
    if constexpr (J + 1 < P) {
      step.issue(nxt, issued);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    step.consume(cur, st, done);
    component_chain<J + 1, P>(step, nxt, cur, st, issued, done);
  }
}

template <int PASSES, int DP, int WGS, int KCH>
__global__ void __launch_bounds__((WGS + 1) * kWg, 1)
    grouped_tc_kernel(const float* __restrict__ r2,
                      const bf16* __restrict__ slab_hi,
                      const bf16* __restrict__ slab_lo,
                      const float* __restrict__ vec,
                      const float* __restrict__ logw, float* __restrict__ out,
                      int n, int k_comp, int two_m, int two_d, int stages) {
  constexpr int kAPlanes = KCH > 0 ? 0 : PASSES == 3 ? 2 : 1;  // in smem
  constexpr int kBPlanes = PASSES >= 2 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring ring;
  ring.full = smem_u32(smem_raw);
  ring.empty = ring.full + 8 * kMaxStages;
  ring.vec = ring.full + 16 * kMaxStages;
  const unsigned base =
      (ring.vec + kMaxStages * kPiece * 4 + 1023) & ~1023u;
  ring.n_ch = (two_m + 63) / 64;
  ring.a_bytes = ring.n_ch * kAtomBytes;
  ring.stage_bytes = kBPlanes * ring.a_bytes;
  ring.b = base + WGS * kAPlanes * ring.a_bytes;
  ring.stages = stages;
  const int mp = ring.n_ch;  // logit pieces
  const int pieces = mp + DP;
  const int total = k_comp * pieces;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, WGS * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == WGS) {  // the producer warpgroup: one thread streams the pieces
    if constexpr (WGS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == WGS * kWg)
      produce<kBPlanes>(ring, slab_hi, slab_lo, vec, total);
    return;
  }
  if constexpr (WGS == 2) setmaxnreg_inc<232>();

  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * (WGS * 64) + wg * 64;
  ring.a = base + wg * kAPlanes * ring.a_bytes;

  // this warpgroup's rows -> r_hi (and r_lo): with KCH > 0 into this
  // thread's fragments (rows 16 warp + lane / 4 and + 8, columns 16 ks +
  // 2 (lane % 4) + {0, 1} and + 8), else a 16-byte unit (8 contraction
  // columns of one row) at a time into the swizzled A planes; rows past N
  // and columns past 2M zero
  AOperand<PASSES, KCH> a;
  if constexpr (KCH > 0) {
#pragma unroll
    for (int ks = 0; ks < KCH * 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 16 * warp + (lane >> 2) + 8 * (e & 1);
        const int c = 16 * ks + 2 * (lane & 3) + 8 * (e >> 1);
        float2 x = make_float2(0.f, 0.f);
        if (row < n && c < two_m)  // 2M is even: c + 1 < 2M too
          x = __ldg(reinterpret_cast<const float2*>(r2 + (size_t)row * two_m +
                                                     c));
        const bf16 h0 = __float2bfloat16_rn(x.x);
        const bf16 h1 = __float2bfloat16_rn(x.y);
        a.hi[ks][e] = pack_bf16(h0, h1);
        if constexpr (PASSES == 3)
          a.lo[ks][e] =
              pack_bf16(__float2bfloat16_rn(x.x - __bfloat162float(h0)),
                        __float2bfloat16_rn(x.y - __bfloat162float(h1)));
      }
  } else {
    const int units_row = ring.n_ch * 8;
    for (int u = tid; u < 64 * units_row; u += kWg) {
      const int rr = u / units_row, kq = u - rr * units_row;
      const int row = row0 + rr;
      unsigned hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = kq * 8 + 2 * e + h;
          x[h] = (row < n && c < two_m)
                     ? __ldg(r2 + (size_t)row * two_m + c)
                     : 0.f;
        }
        const bf16 h0 = __float2bfloat16_rn(x[0]);
        const bf16 h1 = __float2bfloat16_rn(x[1]);
        hi[e] = pack_bf16(h0, h1);
        lo[e] = pack_bf16(__float2bfloat16_rn(x[0] - __bfloat162float(h0)),
                          __float2bfloat16_rn(x[1] - __bfloat162float(h1)));
      }
      const unsigned off = (kq >> 3) * kAtomBytes + rr * 128 +
                           (((kq & 7) ^ (rr & 7)) << 4);
      st_shared_v4(ring.a + off, hi);
      if constexpr (PASSES == 3) st_shared_v4(ring.a + ring.a_bytes + off, lo);
    }
    // the generic-proxy stores become visible to wgmma, then the
    // warpgroup meets (named barrier 1 + wg: the other roles never wait
    // on it)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWg) : "memory");
  }

  Rows<DP> st;
#pragma unroll
  for (int j = 0; j < DP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) st.o[j][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m_run[r] = -INFINITY;
    st.den[r] = st.q[r] = st.sc[r] = st.p[r] = 0.f;
  }

  // Two accumulators: a piece's successor is issued before the piece is
  // consumed. No wgmma group is in flight across a loop's back edge (ptxas
  // serialises every wgmma of a kernel where one is): with A in registers
  // a component's pieces are one unrolled chain, else pieces go in pairs.
  float acc0[32], acc1[32];
  Cursor issued{0, 0, 0, 0}, done{0, 0, 0, 0};
  const Step<PASSES, KCH, DP> step{ring, a, logw, mp, pieces, lane};
  if constexpr (KCH > 0) {
    for (int k = 0; k < k_comp; ++k) {
      step.issue(acc0, issued);
      component_chain<0, KCH + DP>(step, acc0, acc1, st, issued, done);
    }
  } else {
    for (int g = 0; g < total; g += 2) {
      step.issue(acc0, issued);
      if (g + 1 < total) {
        step.issue(acc1, issued);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      step.consume(acc0, st, done);
      if (g + 1 < total) {
        wgmma_wait<0>();
        step.consume(acc1, st, done);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * r;
    if (row < n) {
      float* orow = out + (size_t)row * two_d;
#pragma unroll
      for (int jj = 0; jj < DP; ++jj)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int c = jj * kPiece + 8 * t + 2 * (lane & 3);  // even
          if (c < two_d)
            *reinterpret_cast<float2*>(orow + c) =
                make_float2(st.o[jj][4 * t + 2 * r] / st.den[r],
                            st.o[jj][4 * t + 2 * r + 1] / st.den[r]);
        }
    }
  }
}

// shared memory of a launch with `stages` ring stages
template <int PASSES, int WGS, int KCH>
size_t smem_bytes(int n_ch, int stages) {
  constexpr int kAPlanes = KCH > 0 ? 0 : PASSES == 3 ? 2 : 1;
  constexpr int kBPlanes = PASSES >= 2 ? 2 : 1;
  const size_t atom = (size_t)n_ch * kAtomBytes;
  return 16 * kMaxStages + kMaxStages * kPiece * 4 + 1024 +
         WGS * kAPlanes * atom + (size_t)stages * kBPlanes * atom;
}

// the deepest ring (up to kMaxStages) that fits, 0 if not even one does
template <int PASSES, int WGS, int KCH>
int ring_stages(int n_ch) {
  int s = kMaxStages;
  while (s > 0 && smem_bytes<PASSES, WGS, KCH>(n_ch, s) > (size_t)kSmemMax)
    --s;
  return s;
}

template <int PASSES, int DP, int WGS, int KCH>
int launch(const float* r2, const bf16* hi, const bf16* lo, const float* vec,
           const float* logw, float* out, int n, int k_comp, int two_m,
           int two_d, cudaStream_t stream) {
  const int n_ch = (two_m + 63) / 64;
  const int stages = ring_stages<PASSES, WGS, KCH>(n_ch);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<PASSES, WGS, KCH>(n_ch, stages);
  auto kern = grouped_tc_kernel<PASSES, DP, WGS, KCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + WGS * 64 - 1) / (WGS * 64);
  kern<<<grid, (WGS + 1) * kWg, smem, stream>>>(
      r2, hi, lo, vec, logw, out, n, k_comp, two_m, two_d, stages);
  return (int)cudaGetLastError();
}

// Up to 2M = 128 and 2D = 128 (the main path) A sits in registers, two
// consumer warpgroups; wider, A sits in shared memory, two warpgroups where
// a 3-stage ring fits beside their A planes and the output fits their
// registers (2D <= 192), else one.
template <int PASSES, int DP>
int dispatch_a(const float* r2, const bf16* hi, const bf16* lo,
               const float* vec, const float* logw, float* out, int n,
               int k_comp, int two_m, int two_d, cudaStream_t s) {
  const int n_ch = (two_m + 63) / 64;
  if constexpr (DP <= 2) {
    if (n_ch == 1)
      return launch<PASSES, DP, 2, 1>(r2, hi, lo, vec, logw, out, n, k_comp,
                                      two_m, two_d, s);
    if (n_ch == 2)
      return launch<PASSES, DP, 2, 2>(r2, hi, lo, vec, logw, out, n, k_comp,
                                      two_m, two_d, s);
  }
  if constexpr (DP < 4) {
    if (ring_stages<PASSES, 2, 0>(n_ch) >= 3)
      return launch<PASSES, DP, 2, 0>(r2, hi, lo, vec, logw, out, n, k_comp,
                                      two_m, two_d, s);
  }
  return launch<PASSES, DP, 1, 0>(r2, hi, lo, vec, logw, out, n, k_comp,
                                  two_m, two_d, s);
}

template <int PASSES>
int dispatch(const float* r2, const bf16* hi, const bf16* lo,
             const float* vec, const float* logw, float* out, int n,
             int k_comp, int two_m, int two_d, cudaStream_t s) {
  switch ((two_d + kPiece - 1) / kPiece) {
    case 1:
      return dispatch_a<PASSES, 1>(r2, hi, lo, vec, logw, out, n, k_comp,
                                   two_m, two_d, s);
    case 2:
      return dispatch_a<PASSES, 2>(r2, hi, lo, vec, logw, out, n, k_comp,
                                   two_m, two_d, s);
    case 3:
      return dispatch_a<PASSES, 3>(r2, hi, lo, vec, logw, out, n, k_comp,
                                   two_m, two_d, s);
    default:
      return dispatch_a<PASSES, 4>(r2, hi, lo, vec, logw, out, n, k_comp,
                                   two_m, two_d, s);
  }
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K14b: r2 (n, two_m) fp32 -> out (n, two_d) fp32 through `passes` (1, 2
// or 3) bf16 tensor-core products; slab_hi, slab_lo: pw_hi, pw_lo in the
// kernel's B layout (`variant_kernels.tc_slab`: (k_comp, mp + dp, Kp / 64,
// 64, 64) bf16, 16-byte aligned; slab_lo unread at passes = 1), vec: mu
// and b by piece (`variant_kernels.tc_vectors`: (k_comp, mp + dp, 64)
// fp32), logw (k_comp) fp32.
extern "C" int grouped_tc_estimate_launch(const float* r2, const void* slab_hi,
                                          const void* slab_lo, const float* vec,
                                          const float* logw,
                                          float* out, int n, int k_comp,
                                          int two_m, int two_d, int passes,
                                          void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 256 || two_d < 1 ||
      two_d > 256 || two_d % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(slab_hi) % 16 != 0 ||
      (passes > 1 && reinterpret_cast<uintptr_t>(slab_lo) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hi = static_cast<const bf16*>(slab_hi);
  const bf16* lo = static_cast<const bf16*>(slab_lo);
  switch (passes) {
    case 1:
      return dispatch<1>(r2, hi, lo, vec, logw, out, n, k_comp, two_m,
                         two_d, s);
    case 2:
      return dispatch<2>(r2, hi, lo, vec, logw, out, n, k_comp, two_m,
                         two_d, s);
    case 3:
      return dispatch<3>(r2, hi, lo, vec, logw, out, n, k_comp, two_m,
                         two_d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
