// The bank stream of the grouped online-softmax estimator on Hopper's
// tensor cores (wgmma), shared by K1 / K3 / K2 (grouped_estimate.cu, six
// bf16 products), the opt-in precision modes K14b (grouped_tc_estimate.cu,
// one to three products) and the floor probe K15 (floor_probe.cu, K1's
// stream with its epilogue stripped). All compile this one template, so the
// probe times K1's own code: its `full` variant is K1, bit for bit.
//
// Replaces the TPU kernels of quantized_channel_estimation_tpu/estimators/
// pallas_kernels.py: `_grouped_stream` (:327) with
// `_estimate_kernel_block_grouped` (:419, entry `estimate_fused`) and its
// coherent mode (`t_coh > 1`, entry `estimate_fused_coherent` :1151), the
// split-K stats form `_estimate_kernel_block_grouped_stats` (:454), the
// precision modes 'bf16' (:430) and 'split2' / 'split3' (:440), and the
// stripped bodies of tools/kernel_floor_probe.py (`BODIES` :191). Per row n
// of r2 = [Re r | Im r] (N x 2M) and component k, with yz_k = r2 pw_k
// (pw_k = [P_k | W_k] in the real 2x2 block embedding):
//
//   lg_nk = logw_k - |yz_k[:, :2M] - mu_k|^2
//   h2_n  = sum_k softmax_k(lg'_nk) (yz_k[:, 2M:] + b_k)
//
// with lg' = lg, or for K3 (rows block-major, T rows a block) lg' = (1 - a)
// lg + a s_k, s_k the sum of lg_k over the row's block. STATS writes the
// running max m, denominator den and un-normalised accumulator acc of each
// row in place of acc / den, so the states of component shards merge
// exactly (m* = max m; den*, acc* the exp(m - m*)-weighted sums).
//
// The products. Each fp32 operand x is split into three bf16 planes, each
// rounded to nearest even: hi = bf16(x), lo = bf16(x - hi), lo2 =
// bf16(x - hi - lo); hi + lo + lo2 = x exactly for normal x (8 + 8 + 8
// significand bits). pw's planes are split once on the host (variant
// kernels' `split_planes3`, its hi and lo those of the two-plane split),
// r2's per tile in the kernel. A product of two bf16 values is exact in the
// fp32 accumulator, and
//
//   PASSES = 1 ('bf16'):   yz = hi.hi
//   PASSES = 2 ('split2'): yz = hi.hi + hi.lo
//   PASSES = 3 ('split3'): yz = hi.hi + hi.lo + lo.hi
//   PASSES = 6 (K1):       yz = hi.lo2 + lo.lo + lo2.hi + lo.hi + hi.lo
//                               + hi.hi
//
// (r2's plane first). Six products drop lo.lo2, lo2.lo and lo2.lo2, terms
// of order 2^-24 of yz: fp32's own rounding. They are issued smallest
// first, hi.hi last, into one accumulator, so the tensor core's alignment
// of each k16 step to the largest term costs the small terms nothing.
// Everything after the product is fp32: the quadratic term, K3's pooling,
// the online softmax, the combine. TF32 stays excluded: a 10-bit mantissa
// moves the posterior at 20 dB, and 3xTF32 leaves ~2^-22 of yz.
//
// Bound on an H100 (131072 rows, M = D = K = 64): PASSES x 2 N 2M (2M+2D) K
// bf16 tensor-core operations (5.5e11 a pass, 0.56 ms at 989 TFLOP/s; six
// passes 3.34 ms) plus 2 N K (2M + 2D) fp32 epilogue operations (4.3e9,
// 0.06 ms at 67 TFLOP/s; K3 adds 3 N K), against ~0.15 GB of compulsory
// traffic (0.04 ms at 3.35 TB/s): 3.40 ms for K1, against 8.21 ms for the
// same products in fp32 FMAs.
//
// Design:
//   - a block is WGS = 2 consumer warpgroups of 64 rows each and one
//     producer warpgroup, so the bank is read from L2 once per 128 rows
//     (`setmaxnreg`: 232 registers for a consumer, 40 for the producer);
//     one consumer warpgroup (64 rows a block) where 128-row blocks would
//     not cover the SMs (the service's microbatches), or at the widest;
//   - the bank's columns are cut into pieces of 64 (the logit half [0, 2M)
//     in mp pieces, then the value half [2M, 2M + 2D) in DP pieces, each
//     zero-padded); the wrapper lays every (component, piece) of each plane
//     out once in the wgmma B layout (`tc_slab`: K-major, 128-byte swizzle,
//     Kp = 2M rounded up to 64 contraction rows), and mu / b by piece
//     (`tc_vectors`: 64 fp32 values a piece);
//   - one producer thread copies piece after piece (its planes and its 64
//     vector values) with cp.async.bulk into a ring of 1-8 stages, each
//     guarded by a full and an empty mbarrier; consumers never meet at a
//     block barrier;
//   - up to 2M = 128 and 2D = 128 (the main path) each thread holds its
//     rows' hi and lo planes of r2 as wgmma A fragments in registers and
//     the warpgroup keeps lo2 in shared memory (three planes in registers
//     and two accumulators would not fit beside the running output); wider,
//     every plane sits in shared memory (K-major, 128-byte swizzle);
//   - a piece is PASSES x Kp / 16 wgmma m64n64k16 (bf16 -> fp32) into one of
//     two register accumulators, and the next piece is issued before this
//     one is read, so its epilogue overlaps the next piece's products (and
//     the other warpgroup's); no wgmma group is in flight across a loop's
//     back edge (ptxas serialises every wgmma of a kernel where one is).
//     With one ring stage (the widest) the pieces run one at a time;
//   - the epilogue reads the accumulators in registers: a logit piece adds
//     its columns to the rows' quadratic terms (a thread holds rows 16 w +
//     lane / 4 and + 8 of its warp w; a row's four threads reduced by quad
//     shuffles after the last logit piece, then the pooling and the online
//     softmax), a value piece folds p (yz + b) into the running output; mu
//     and b come from the stage; no yz tile;
//   - K3 pools T consecutive rows, each warpgroup holding floor(64 / T)
//     whole blocks (masked rows are never stored): T = 2, 4, 8 by quad-group
//     shuffles (xor 4, 8, 16 over lane / 4), T = 16 by an in-thread add of
//     a thread's two rows and those shuffles, any other T <= 64 through 64
//     floats of shared memory a warpgroup under its named barrier;
//   - the ragged last tile is masked in the kernel (any N, no padding);
//   - a consumer releases a stage only after a proxy fence orders its
//     generic reads of the stage's mu / b before the async refill (see
//     consume_piece; without it a warp can read the next piece's);
//   - the probe's stripped epilogues (VARIANT) keep every product: each
//     accumulator their body does not read is folded into a value stored
//     under a runtime flag the wrapper passes as 0, since ptxas removes a
//     wgmma whose results nobody reads.
// Any N and K, 2M and 2D up to 256.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qce_tc {

using bf16 = __nv_bfloat16;

constexpr int kPiece = 64;            // columns a piece: wgmma N
constexpr int kAtomBytes = 64 * 128;  // 64 rows x 64 bf16 of contraction
constexpr int kMaxStages = 8;
constexpr int kWg = 128;              // threads a warpgroup
constexpr int kSmemMax = 232448;      // a block's shared memory on an H100

// The probe's bodies (tools/kernel_floor_probe.py `BODIES`), after the
// products of component k, per row:
//   kFull          the K1 epilogue (logits, online softmax, combine);
//   kGemmOnly      acc += yz[:, 2M:]                       -> acc
//   kLogitsOnly    the logit and the online-softmax denominator -> den
//   kCombineOnly   acc += logw_k (yz[:, 2M:] + b_k)        -> acc
//   kSquareOnly    acc += ((yz[:, :2M] - mu_k)^2)[:, :2D]  -> acc (2D <= 2M)
//   kQuadOnly      s += |yz[:, :2M] - mu_k|^2              -> s
//   kFullFixedmax  p = exp(lg - logw_0), no running max    -> acc / den
// with den and s written to every column of the row.
enum ProbeVariant {
  kFull = 0,
  kGemmOnly = 1,
  kLogitsOnly = 2,
  kCombineOnly = 3,
  kSquareOnly = 4,
  kQuadOnly = 5,
  kFullFixedmax = 6,
};

// Product i of PASSES, in issue order: (plane of r2, plane of pw), planes
// 0 = hi, 1 = lo, 2 = lo2.
__host__ __device__ constexpr int prod_a(int passes, int i) {
  return passes == 6 ? (i == 1 || i == 3 ? 1 : i == 2 ? 2 : 0)
                     : (i == 2 ? 1 : 0);
}
__host__ __device__ constexpr int prod_b(int passes, int i) {
  return passes == 6 ? (i == 0 ? 2 : i == 1 || i == 4 ? 1 : 0)
                     : (i == 1 ? 1 : 0);
}
__host__ __device__ constexpr int a_planes(int passes) {
  return passes == 6 ? 3 : passes == 3 ? 2 : 1;
}
__host__ __device__ constexpr int b_planes(int passes) {
  return passes == 6 ? 3 : passes >= 2 ? 2 : 1;
}

// One instantiation: PASSES products, DP value pieces, WGS consumer
// warpgroups, KCH 64-wide contraction chunks of A in registers (0: A in
// shared memory), and the epilogue's form.
template <int PASSES_, int DP_, int WGS_, int KCH_, bool COH_, bool STATS_,
          int VARIANT_>
struct Cfg {
  static constexpr int PASSES = PASSES_, DP = DP_, WGS = WGS_, KCH = KCH_;
  static constexpr bool COH = COH_, STATS = STATS_;
  static constexpr int VARIANT = VARIANT_;
  // r2's planes in registers (hi, lo) and in shared memory: with KCH > 0
  // lo2 only, with KCH = 0 all
  static constexpr int kARegs = KCH > 0 ? (a_planes(PASSES) < 2
                                               ? a_planes(PASSES) : 2) : 0;
  static constexpr int kASmem = a_planes(PASSES) - kARegs;
  static constexpr int kBPlanes = b_planes(PASSES);
  static constexpr bool kStripped = VARIANT != kFull &&
                                    VARIANT != kFullFixedmax;
  static constexpr bool kLogits = VARIANT == kFull || VARIANT == kLogitsOnly ||
                                  VARIANT == kQuadOnly ||
                                  VARIANT == kFullFixedmax;
};

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

__device__ __forceinline__ void st_shared_v4(unsigned addr,
                                             const unsigned* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void st_shared_b32(unsigned addr, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// the warpgroup's 128 threads meet (named barrier id: the other roles never
// wait on it)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWg) : "memory");
}

// A wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The descriptor of k16 step ks of an operand whose descriptor is d0: the
// step's byte offset (chunk ks / 4, 32 bytes a step within it) added to
// the address field (shared addresses stay below 2^18, so no carry leaves
// it)
__device__ __forceinline__ uint64_t step_desc(uint64_t d0, int ks) {
  return d0 + (((ks >> 2) * kAtomBytes + (ks & 3) * 32) >> 4);
}

__device__ __forceinline__ float2 ld_shared_f2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// byte offset of element (row, column c of the contraction) in a K-major
// 128-byte-swizzled operand of 64 rows a chunk
__device__ __forceinline__ unsigned sw128_off(int row, int c) {
  return (c >> 6) * kAtomBytes + row * 128 +
         ((((c >> 3) & 7) ^ (row & 7)) << 4) + (c & 7) * 2;
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
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d (+)= A B for a 64 x N x 16 tile (N = 64, 32, 16 by d's size), A and B
// K-major bf16 in shared memory at the descriptors da + OA and db + OB
// (offsets in 16-byte units, added in the asm so that only the bases stay
// live); d is overwritten where accumulate == 0.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_at(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.s64 a, %32, %35;\n"
      "add.s64 b, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_at(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "add.s64 a, %16, %19;\n"
      "add.s64 b, %17, %20;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_at(float (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "add.s64 a, %8, %11;\n"
      "add.s64 b, %9, %12;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
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

__device__ __forceinline__ float4 ld_shared_f4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// v0, v1 -> their three bf16 planes as packed pairs pl[plane] (v0 in the
// low half), each rounded to nearest even
__device__ __forceinline__ void split3(float v0, float v1, unsigned (&pl)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float y0 = v0 - hf.x, y1 = v1 - hf.y;
  const __nv_bfloat162 l = __floats2bfloat162_rn(y0, y1);
  const float2 lf = __bfloat1622float2(l);
  pl[0] = bf2_bits(h);
  pl[1] = bf2_bits(l);
  pl[2] = bf2_bits(__floats2bfloat162_rn(y0 - lf.x, y1 - lf.y));
}

// An m64n64 accumulator (or values in its layout) -> the A fragments of one
// 64-deep chunk, three planes of four k16 steps: step s, register e holds
// columns 16 s + 8 (e >> 1) + 2 (lane % 4) + {0, 1} of row lane / 4 + 8 (e
// & 1), which are accumulator pair 4 (2 s + (e >> 1)) + 2 (e & 1).
__device__ __forceinline__ void to_a_regs(unsigned (&a)[3][4][4],
                                          const float (&v)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (2 * s + (e >> 1)) + 2 * (e & 1);
      unsigned w[3];
      split3(v[i], v[i + 1], w);
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q][s][e] = w[q];
    }
}

// Shared memory, from a 1024-aligned base: with A in shared memory each
// warpgroup's A planes [plane][chunk][64 rows][128 B]; the ring of stages,
// a stage one piece of each B plane [plane][chunk][64 columns][128 B];
// then the barriers (full, then empty, a stage each), each stage's 64 fp32
// vector values (mu_k or b_k of its columns) and, for K3, 64 logits a
// warpgroup.
struct Ring {
  unsigned full, empty;  // barrier arrays
  unsigned vec;          // stage 0's vector values
  unsigned a;            // this warpgroup's first A plane in shared memory
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
__device__ __forceinline__ void produce(const Ring& ring,
                                        const bf16* const (&planes)[3],
                                        const float* vec, int total) {
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
#pragma unroll
    for (int p = 0; p < BPLANES; ++p)
      bulk_copy(dst + p * piece,
                reinterpret_cast<const char*>(planes[p]) + off, piece, full);
    if (++s == ring.stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

// A operand in registers: this thread's fragments of r2's hi (and lo)
// planes for KCH 64-wide contraction chunks.
template <class C>
struct AOperand {
  static constexpr int kSteps = C::KCH > 0 ? C::KCH * 4 : 1;
  unsigned hi[kSteps][4];
  unsigned lo[C::kARegs >= 2 ? kSteps : 1][4];
};

// Product P of the piece in stage bs into d: Kp / 16 wgmma, the first of
// product 0 overwriting d.
template <class C, int P>
__device__ __forceinline__ void issue_product(float (&d)[32],
                                              const AOperand<C>& a,
                                              const Ring& ring, unsigned bs) {
  constexpr int ap = prod_a(C::PASSES, P), bp = prod_b(C::PASSES, P);
  const uint64_t db = sw128_desc(bs + bp * ring.a_bytes);
  if constexpr (ap < C::kARegs) {
#pragma unroll
    for (int ks = 0; ks < C::KCH * 4; ++ks) {
      if constexpr (ap == 0)
        wgmma_64x64_rs(d, a.hi[ks], step_desc(db, ks), P > 0 || ks > 0);
      else
        wgmma_64x64_rs(d, a.lo[ks], step_desc(db, ks), P > 0 || ks > 0);
    }
  } else {
    const uint64_t da = sw128_desc(ring.a + (ap - C::kARegs) * ring.a_bytes);
    if constexpr (C::KCH > 0) {
#pragma unroll
      for (int ks = 0; ks < C::KCH * 4; ++ks)
        wgmma_64x64(d, step_desc(da, ks), step_desc(db, ks),
                    P > 0 || ks > 0);
    } else {
      for (int ks = 0; ks < ring.n_ch * 4; ++ks)
        wgmma_64x64(d, step_desc(da, ks), step_desc(db, ks),
                    P > 0 || ks > 0);
    }
  }
}

template <class C, int P = 0>
__device__ __forceinline__ void issue_products(float (&d)[32],
                                               const AOperand<C>& a,
                                               const Ring& ring, unsigned bs) {
  if constexpr (P < C::PASSES) {
    issue_product<C, P>(d, a, ring, bs);
    issue_products<C, P + 1>(d, a, ring, bs);
  }
}

// Wait for the piece at `at` and issue its products into d.
template <class C>
__device__ __forceinline__ void issue_piece(float (&d)[32], const Cursor& at,
                                            const Ring& ring,
                                            const AOperand<C>& a) {
  mbar_wait(ring.full + 8 * at.s, at.ph);
  wgmma_fence();
  fence_operand(d);
  issue_products<C>(d, a, ring, ring.b + at.s * ring.stage_bytes);
  wgmma_commit();
  fence_operand(d);
}

// A thread's rows (accumulator rows lane / 4 and + 8 of its warp's 16):
// the running output at columns 8 t + 2 (lane % 4) + {0, 1} of each value
// piece, t < 8, the online-softmax state, and the probe's sink.
template <int DP>
struct Rows {
  float o[DP][32];
  float m_run[2], den[2];
  float q[2], sc[2], p[2];  // the current component's
  float sink;
};

// What the epilogue reads beside the accumulators. The thread's place is
// recomputed from threadIdx where it is used (fewer live registers).
struct Epi {
  const float* logw;
  int mp, pieces;
  int t_coh;     // K3
  float alpha, m_fix;
  unsigned lg0;  // K3: warpgroup 0's 64 logits in shared memory
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the thread's first row within its warpgroup's 64 (its second: + 8)
__device__ __forceinline__ int row_in_wg() {
  return 16 * ((threadIdx.x % kWg) >> 5) + ((threadIdx.x & 31) >> 2);
}

// a warp's arrival on a ring barrier that counts one arrival a consumer
// warp
__device__ __forceinline__ void warp_arrive(unsigned bar) {
  __syncwarp();
  if (lane_id() == 0) mbar_arrive(bar);
}

// x[0] + ... + x[N - 1] as a tree (N a power of two)
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1)
    return x[0];
  else
    return tree_sum<N / 2>(x) + tree_sum<N / 2>(x + N / 2);
}

// sum += part in a compensated (Kahan) sum: sum - lost is the running
// value, lost the rounding error sum has taken on
__device__ __forceinline__ void kahan(float& sum, float& lost, float part) {
  const float y = part - lost;
  const float next = sum + y;
  lost = (next - sum) - y;
  sum = next;
}

// K3: replace each row's logit by (1 - a) lg + a s, s the sum of lg over
// the row's block of T consecutive rows (a >= 1: s).
__device__ __forceinline__ void pool_logits(float (&lg)[2], const Epi& ep) {
  const int t = ep.t_coh;
  float s[2];
  if (t == 16) {  // a warp's 16 rows: the thread's two, then its column
    s[0] = lg[0] + lg[1];
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], 4);
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], 8);
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], 16);
    s[1] = s[0];
  } else if (t <= 8 && (t & (t - 1)) == 0) {  // rows lane / 4 of a group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[r] = lg[r];
      for (int o = 4; o < 4 * t; o <<= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
    }
  } else {  // across warps: the warpgroup's 64 logits in shared memory
    const int wg = threadIdx.x / kWg, rr0 = row_in_wg();
    const unsigned lgs = ep.lg0 + wg * 64 * 4;
    if ((threadIdx.x & 3) == 0) {
      st_shared_b32(lgs + 4 * rr0, __float_as_uint(lg[0]));
      st_shared_b32(lgs + 4 * (rr0 + 8), __float_as_uint(lg[1]));
    }
    wg_sync(1 + wg);
    // each pair of a quad's threads sums one row's block each, in a
    // compensated sum: a pooled logit is up to 64 times a row's, and a plain
    // running sum would round it past the plain version's error at T = 64
    const int r = threadIdx.x & 1;
    const int rr = rr0 + 8 * r;
    float mine = r ? lg[1] : lg[0];  // masked rows: never stored
    if (rr < 64 / t * t) {
      const int b0 = rr / t * t;
      float sum = 0.f, comp = 0.f;
      for (int j = 0; j < t; ++j) {
        const float y = ld_shared_f32(lgs + 4 * (b0 + j)) - comp;
        const float next = sum + y;
        comp = (next - sum) - y;
        sum = next;
      }
      mine = sum;
    }
    const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
    s[0] = r ? other : mine;
    s[1] = r ? mine : other;
    wg_sync(1 + wg);  // the next component's logits overwrite these
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lg[r] = ep.alpha >= 1.f ? s[r]
                            : (1.f - ep.alpha) * lg[r] + ep.alpha * s[r];
}

// The epilogue of the piece at `at`, whose products are complete in d; its
// stage is released after the epilogue has used the stage's vector values.
// J: the piece's place in its component where the caller knows it at
// compile time (a component's unrolled chain), else -1 (at.j).
template <class C, int J>
__device__ __forceinline__ void consume_piece(Rows<C::DP>& st,
                                              const float (&d)[32],
                                              const Cursor& at,
                                              const Ring& ring,
                                              const Epi& ep) {
  constexpr int DP = C::DP, V = C::VARIANT;
  const int j = J >= 0 ? J : at.j;
  // this lane's vector values: columns 8 t + 2 (lane % 4) + {0, 1} of the
  // piece, read where they are used
  const unsigned vec = ring.vec + at.s * (kPiece * 4) + 8 * (threadIdx.x & 3);
  if (j < ep.mp) {  // a logit piece: the quadratic term of its columns
    if (j == 0) st.q[0] = st.q[1] = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 v = ld_shared_f2(vec + 32 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mc = h ? v.y : v.x;  // padding: 0 and 0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * t + 2 * r + h;
          const float dv = d[i] - mc;
          if constexpr (C::kLogits) st.q[r] = fmaf(dv, dv, st.q[r]);
          if constexpr (V == kSquareOnly) {
            // output column c of piece jj is logit column c (2D <= 2M)
#pragma unroll
            for (int jj = 0; jj < DP; ++jj)
              if (jj == j) st.o[jj][i] = fmaf(dv, dv, st.o[jj][i]);
          }
        }
      }
    }
    if constexpr (C::kLogits) {
      if (j == ep.mp - 1) {  // the rows' logits complete
        const float lw = __ldg(ep.logw + at.k);
        float lg[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float q = st.q[r];
          q += __shfl_xor_sync(0xffffffffu, q, 1);
          q += __shfl_xor_sync(0xffffffffu, q, 2);
          st.q[r] = q;
          lg[r] = lw - q;
        }
        if constexpr (C::COH) pool_logits(lg, ep);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (V == kQuadOnly) {
            st.den[r] += st.q[r];
          } else if constexpr (V == kFullFixedmax) {
            st.p[r] = expf(lg[r] - ep.m_fix);
            st.den[r] += st.p[r];
          } else {  // kFull, kLogitsOnly: online softmax
            const float logit = lg[r];
            const float m_new = fmaxf(st.m_run[r], logit);
            // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales
            // by 0
            st.sc[r] =
                st.m_run[r] == -INFINITY ? 0.f : expf(st.m_run[r] - m_new);
            st.p[r] = logit == -INFINITY ? 0.f : expf(logit - m_new);
            st.den[r] = fmaf(st.den[r], st.sc[r], st.p[r]);
            st.m_run[r] = m_new;
          }
        }
      }
    }
  } else if constexpr (V == kFull || V == kFullFixedmax || V == kGemmOnly ||
                       V == kCombineOnly) {
    // a value piece: fold its columns into the output
    const int jd = j - ep.mp;
    const float lw = V == kCombineOnly ? __ldg(ep.logw + at.k) : 0.f;
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      if (jj == jd) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 v = ld_shared_f2(vec + 32 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float bc = h ? v.y : v.x;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * t + 2 * r + h;
              float& o = st.o[jj][i];
              if constexpr (V == kFull)
                o = fmaf(st.p[r], d[i] + bc, o * st.sc[r]);
              else if constexpr (V == kFullFixedmax)
                o = fmaf(st.p[r], d[i] + bc, o);
              else if constexpr (V == kGemmOnly)
                o += d[i];
              else
                o = fmaf(lw, d[i] + bc, o);
            }
          }
        }
      }
    }
  }
  // The sink: ptxas removes a wgmma whose accumulator nobody reads, so a
  // piece that no output of a stripped body reads is folded into a value
  // stored under a runtime flag the wrapper passes as 0.
  if constexpr (C::kStripped) {
    if (j < ep.mp ? !(C::kLogits || V == kSquareOnly)
                  : !(V == kGemmOnly || V == kCombineOnly)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) st.sink += d[i];
    }
  }
  // The stage is refilled by cp.async.bulk, a write of the async proxy;
  // the barrier's release orders the reads of vec above only against the
  // generic proxy, so only this proxy fence keeps the refill from landing
  // before they are performed, when a warp would read the next piece's mu
  // / b. Released right after the reads, a copy without the fence failed
  // 1290 of 2000 launches (2M = 256, 2D = 24, N = 50693, bf16;
  // `tools/tc_repeat_check.py`); here, after the math that used v, the
  // fence finds the reads done and costs less. Then release the stage.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane_id() == 0) mbar_arrive(ring.empty + 8 * at.s);
}

// A consumer warpgroup's two halves of a piece: issuing its products and,
// once they are complete, its epilogue; each advances its cursor.
template <class C>
struct Step {
  const Ring& ring;
  const AOperand<C>& a;
  const Epi& ep;

  __device__ __forceinline__ void issue(float (&d)[32], Cursor& at) const {
    issue_piece<C>(d, at, ring, a);
    at.next(ep.pieces, ring.stages);
  }
  template <int J>
  __device__ __forceinline__ void consume(float (&d)[32], Rows<C::DP>& st,
                                          Cursor& at) const {
    fence_operand(d);
    consume_piece<C, J>(st, d, at, ring, ep);
    at.next(ep.pieces, ring.stages);
  }
};

// Pieces J .. P - 1 of a component whose piece J is in flight in cur:
// issue piece J + 1 into nxt, consume piece J, go on with the two swapped;
// the last waits for all, so nothing is left in flight.
template <int J, int P, class C>
__device__ __forceinline__ void component_chain(const Step<C>& step,
                                                float (&cur)[32],
                                                float (&nxt)[32],
                                                Rows<C::DP>& st,
                                                Cursor& issued,
                                                Cursor& done) {
  if constexpr (J < P) {
    if constexpr (J + 1 < P) {
      step.issue(nxt, issued);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    step.template consume<J>(cur, st, done);
    component_chain<J + 1, P, C>(step, nxt, cur, st, issued, done);
  }
}

// The kernel. r2 (n, two_m) fp32; planes[p]: pw's plane p in the B layout
// (`tc_slab`); vec: mu and b by piece (`tc_vectors`); logw (k_comp); out
// (n, two_d); STATS: m_out, den_out (n); K3: t_coh, alpha; the probe: sink
// (grid x block threads floats), written when store_sink != 0.
template <class C>
__global__ void __launch_bounds__((C::WGS + 1) * kWg, 1)
    grouped_tc_kernel(const float* __restrict__ r2,
                      const bf16* __restrict__ slab_hi,
                      const bf16* __restrict__ slab_lo,
                      const bf16* __restrict__ slab_lo2,
                      const float* __restrict__ vec,
                      const float* __restrict__ logw, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ den_out,
                      int n, int k_comp, int two_m, int two_d, int stages,
                      int t_coh, float alpha, float* __restrict__ sink,
                      int store_sink) {
  constexpr int WGS = C::WGS, KCH = C::KCH, DP = C::DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  Ring ring;
  ring.n_ch = (two_m + 63) / 64;
  ring.a_bytes = ring.n_ch * kAtomBytes;
  ring.stage_bytes = C::kBPlanes * ring.a_bytes;
  ring.b = base + WGS * C::kASmem * ring.a_bytes;
  ring.stages = stages;
  ring.full = ring.b + stages * ring.stage_bytes;
  ring.empty = ring.full + 8 * stages;
  ring.vec = ring.empty + 8 * stages;
  const int mp = KCH > 0 ? KCH : ring.n_ch;  // logit pieces
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
    if (threadIdx.x == WGS * kWg) {
      const bf16* const planes[3] = {slab_hi, slab_lo, slab_lo2};
      produce<C::kBPlanes>(ring, planes, vec, total);
    }
    return;
  }
  if constexpr (WGS == 2) setmaxnreg_inc<232>();

  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5, lane = tid & 31;
  // K3: whole T-row blocks a warpgroup
  const int wg_rows = C::COH ? 64 / t_coh * t_coh : 64;
  const int row0 = blockIdx.x * (WGS * wg_rows) + wg * wg_rows;
  ring.a = base + wg * C::kASmem * ring.a_bytes;

  // this warpgroup's rows -> r2's planes: with KCH > 0 hi (and lo) into
  // this thread's fragments (rows 16 warp + lane / 4 and + 8, columns 16 ks
  // + 2 (lane % 4) + {0, 1} and + 8) and lo2 into the warpgroup's A plane,
  // else a 16-byte unit (8 contraction columns of one row) at a time into
  // the swizzled A planes; rows past the tile or N and columns past 2M zero
  AOperand<C> a;
  if constexpr (KCH > 0) {
#pragma unroll
    for (int ks = 0; ks < KCH * 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 16 * warp + (lane >> 2) + 8 * (e & 1);
        const int row = row0 + rr;
        const int c = 16 * ks + 2 * (lane & 3) + 8 * (e >> 1);
        float2 x = make_float2(0.f, 0.f);
        if (rr < wg_rows && row < n && c < two_m)  // 2M is even
          x = __ldg(reinterpret_cast<const float2*>(r2 + (size_t)row * two_m +
                                                     c));
        const bf16 h0 = __float2bfloat16_rn(x.x);
        const bf16 h1 = __float2bfloat16_rn(x.y);
        a.hi[ks][e] = pack_bf16(h0, h1);
        if constexpr (C::kARegs >= 2) {
          const float y0 = x.x - __bfloat162float(h0);
          const float y1 = x.y - __bfloat162float(h1);
          const bf16 l0 = __float2bfloat16_rn(y0);
          const bf16 l1 = __float2bfloat16_rn(y1);
          a.lo[ks][e] = pack_bf16(l0, l1);
          if constexpr (C::kASmem > 0)
            st_shared_b32(
                ring.a + sw128_off(rr, c),
                pack_bf16(__float2bfloat16_rn(y0 - __bfloat162float(l0)),
                          __float2bfloat16_rn(y1 - __bfloat162float(l1))));
        }
      }
  } else {
    const int units_row = ring.n_ch * 8;
    for (int u = tid; u < 64 * units_row; u += kWg) {
      const int rr = u / units_row, kq = u - rr * units_row;
      const int row = row0 + rr;
      unsigned pl[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x[2];
        bf16 p[3][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = kq * 8 + 2 * e + h;
          x[h] = (rr < wg_rows && row < n && c < two_m)
                     ? __ldg(r2 + (size_t)row * two_m + c)
                     : 0.f;
          p[0][h] = __float2bfloat16_rn(x[h]);
          const float y = x[h] - __bfloat162float(p[0][h]);
          p[1][h] = __float2bfloat16_rn(y);
          p[2][h] = __float2bfloat16_rn(y - __bfloat162float(p[1][h]));
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) pl[q][e] = pack_bf16(p[q][0], p[q][1]);
      }
      const unsigned off = sw128_off(rr, kq * 8);
#pragma unroll
      for (int q = 0; q < C::kASmem; ++q)
        st_shared_v4(ring.a + q * ring.a_bytes + off, pl[q]);
    }
  }
  if constexpr (C::kASmem > 0) {
    // the generic-proxy stores become visible to wgmma, then the
    // warpgroup meets
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + wg);
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
  st.sink = 0.f;

  const Epi ep{logw,
               mp,
               pieces,
               t_coh,
               alpha,
               C::VARIANT == kFullFixedmax ? __ldg(logw) : 0.f,
               ring.vec + stages * kPiece * 4};

  // Two accumulators: a piece's successor is issued before the piece is
  // consumed. No wgmma group is in flight across a loop's back edge (ptxas
  // serialises every wgmma of a kernel where one is): with A in registers
  // a component's pieces are one unrolled chain, else pieces go in pairs,
  // or one at a time with a one-stage ring.
  float acc0[32], acc1[32];
  Cursor issued{0, 0, 0, 0}, done{0, 0, 0, 0};
  const Step<C> step{ring, a, ep};
  if constexpr (KCH > 0) {
    for (int k = 0; k < k_comp; ++k) {
      step.issue(acc0, issued);
      component_chain<0, KCH + DP, C>(step, acc0, acc1, st, issued, done);
    }
  } else if (stages >= 2) {
    for (int g = 0; g < total; g += 2) {
      step.issue(acc0, issued);
      if (g + 1 < total) {
        step.issue(acc1, issued);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      step.template consume<-1>(acc0, st, done);
      if (g + 1 < total) {
        wgmma_wait<0>();
        step.template consume<-1>(acc1, st, done);
      }
    }
  } else {
    for (int g = 0; g < total; ++g) {
      step.issue(acc0, issued);
      wgmma_wait<0>();
      step.template consume<-1>(acc0, st, done);
    }
  }

  constexpr int V = C::VARIANT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row_in_wg() + 8 * r;
    const int row = row0 + rr;
    if (rr < wg_rows && row < n) {
      float* orow = out + (size_t)row * two_d;
#pragma unroll
      for (int jj = 0; jj < DP; ++jj)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int c = jj * kPiece + 8 * t + 2 * (lane & 3);  // even
          if (c < two_d) {
            float2 w;
            if constexpr (V == kLogitsOnly || V == kQuadOnly) {
              w = make_float2(st.den[r], st.den[r]);
            } else if constexpr ((V == kFull && !C::STATS) ||
                                 V == kFullFixedmax) {
              w = make_float2(st.o[jj][4 * t + 2 * r] / st.den[r],
                              st.o[jj][4 * t + 2 * r + 1] / st.den[r]);
            } else {
              w = make_float2(st.o[jj][4 * t + 2 * r],
                              st.o[jj][4 * t + 2 * r + 1]);
            }
            *reinterpret_cast<float2*>(orow + c) = w;
          }
        }
      if constexpr (C::STATS) {
        if ((lane & 3) == 0) {  // a row's four threads hold its m and den
          m_out[row] = st.m_run[r];
          den_out[row] = st.den[r];
        }
      }
    }
  }
  if constexpr (C::kStripped) {
    if (store_sink) sink[(size_t)blockIdx.x * blockDim.x + threadIdx.x] =
        st.sink;
  }
}

// shared memory of a launch with `stages` ring stages
template <class C>
size_t smem_bytes(int n_ch, int stages) {
  const size_t atom = (size_t)n_ch * kAtomBytes;
  return 1024 + C::WGS * C::kASmem * atom +
         (size_t)stages * (C::kBPlanes * atom + 16 + kPiece * 4) +
         (C::COH ? C::WGS * 64 * 4 : 0);
}

// the deepest ring (up to kMaxStages) that fits, 0 if not even one does
template <class C>
int ring_stages(int n_ch) {
  int s = kMaxStages;
  while (s > 0 && smem_bytes<C>(n_ch, s) > (size_t)kSmemMax) --s;
  return s;
}

// What a launch passes on to the kernel.
struct Args {
  const float* r2;
  const bf16* planes[3];
  const float* vec;
  const float* logw;
  float* out;
  float* m_out;
  float* den_out;
  int n, k_comp, two_m, two_d, t_coh;
  float alpha;
  float* sink;
  int store_sink;
  cudaStream_t stream;
};

template <class C>
int launch(const Args& g) {
  const int n_ch = (g.two_m + 63) / 64;
  const int stages = ring_stages<C>(n_ch);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<C>(n_ch, stages);
  auto kern = grouped_tc_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int wg_rows = C::COH ? 64 / g.t_coh * g.t_coh : 64;
  const int grid = (g.n + C::WGS * wg_rows - 1) / (C::WGS * wg_rows);
  kern<<<grid, (C::WGS + 1) * kWg, smem, g.stream>>>(
      g.r2, g.planes[0], g.planes[1], g.planes[2], g.vec, g.logw, g.out,
      g.m_out, g.den_out, g.n, g.k_comp, g.two_m, g.two_d, stages, g.t_coh,
      g.alpha, g.sink, g.store_sink);
  return (int)cudaGetLastError();
}

// Fewer 128-row blocks than SMs (the service's microbatches): 64-row
// blocks, twice as many.
inline bool small_batch(const Args& g, bool coh) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  const int wg_rows = coh ? 64 / g.t_coh * g.t_coh : 64;
  return (g.n + 2 * wg_rows - 1) / (2 * wg_rows) < sms;
}

// Up to 2M = 128 and 2D = 128 (the main path) A sits in registers; wider,
// in shared memory (WIDE: instantiate those). Two consumer warpgroups,
// or one for a small batch, where a 3-stage ring does not fit beside two
// warpgroups' A planes, or where the output does not fit two warpgroups'
// registers (2D > 192).
template <int PASSES, bool COH, bool STATS, int VARIANT, bool WIDE, int DP>
int dispatch_a(const Args& g) {
  const int n_ch = (g.two_m + 63) / 64;
  const bool small = small_batch(g, COH);
  if constexpr (DP <= 2) {
    if (n_ch <= 2) {
      if (n_ch == 1)
        return small ? launch<Cfg<PASSES, DP, 1, 1, COH, STATS, VARIANT>>(g)
                     : launch<Cfg<PASSES, DP, 2, 1, COH, STATS, VARIANT>>(g);
      return small ? launch<Cfg<PASSES, DP, 1, 2, COH, STATS, VARIANT>>(g)
                   : launch<Cfg<PASSES, DP, 2, 2, COH, STATS, VARIANT>>(g);
    }
  }
  if constexpr (WIDE) {
    using Two = Cfg<PASSES, DP, 2, 0, COH, STATS, VARIANT>;
    if constexpr (DP < 4) {
      if (!small && ring_stages<Two>(n_ch) >= 3) return launch<Two>(g);
    }
    return launch<Cfg<PASSES, DP, 1, 0, COH, STATS, VARIANT>>(g);
  }
  return (int)cudaErrorInvalidValue;
}

template <int PASSES, bool COH, bool STATS, int VARIANT, bool WIDE>
int dispatch(const Args& g) {
  switch ((g.two_d + kPiece - 1) / kPiece) {
    case 1:
      return dispatch_a<PASSES, COH, STATS, VARIANT, WIDE, 1>(g);
    case 2:
      return dispatch_a<PASSES, COH, STATS, VARIANT, WIDE, 2>(g);
    case 3:
      if constexpr (WIDE)
        return dispatch_a<PASSES, COH, STATS, VARIANT, WIDE, 3>(g);
      return (int)cudaErrorInvalidValue;
    default:
      if constexpr (WIDE)
        return dispatch_a<PASSES, COH, STATS, VARIANT, WIDE, 4>(g);
      return (int)cudaErrorInvalidValue;
  }
}

// The checks every entry makes: widths, and 16-byte slabs, 8-byte rows.
inline int check_args(const Args& g, int passes, int max_width) {
  if (g.n < 0 || g.k_comp < 1 || g.two_m < 2 || g.two_m > max_width ||
      g.two_m % 2 != 0 || g.two_d < 2 || g.two_d > max_width ||
      g.two_d % 2 != 0)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < b_planes(passes); ++p)
    if (reinterpret_cast<uintptr_t>(g.planes[p]) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(g.r2) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace qce_tc
