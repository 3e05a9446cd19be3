// Karatsuba-layout online-softmax GMM-Bussgang estimator on Hopper's tensor
// cores: kernel K14a.
//
// Replaces the TPU kernel `_estimate_kernel` launched by `estimate_packed`
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:105,
// pallas_call :175; entry `estimate` :192). It computes K1's 'all'-mode
// estimate from the complex bank without the real 2x2 block embedding:
// per row n of r = rr + i ri (M wide) and component k, every complex
// product y = r B runs as three real ones,
//
//   p1 = rr B_re,  p2 = ri B_im,  p3 = rs B_s,  rs = rr + ri,
//   B_s = B_re + B_im,  Re y = p1 - p2,  Im y = (p3 - p1) - p2,
//
// for B = conj(P_k) (y, M wide) and B = W_k^T (z, D wide, plus b_k), then
//
//   lg_nk = logw_k - |y_k - mu_k|^2,
//   h_n   = sum_k softmax_k(lg_nk) z_nk,
//
// with a running max / denominator / accumulator over k.
//
// The products. Each of p1, p2, p3 is the product of K1's stream
// (grouped_tc_stream.cuh): both operands split into three bf16 planes (hi,
// lo, lo2, each rounded to nearest even, hi + lo + lo2 = x exactly for
// normal x), six exact bf16 products accumulated in fp32 (hi.lo2, lo.lo,
// lo2.hi, lo.hi, hi.lo, hi.hi: smallest first, so the tensor core's
// alignment of each k16 step to the largest term costs the small ones
// nothing). The bank's planes B_re, B_im, B_s are split once on the host
// (`variant_kernels.karatsuba_operands`); rr, ri and rs (formed in fp32, the
// JAX kernel's shared operand) per tile in the kernel. p1, p2 and p3 are
// three accumulators, each fp32-accurate before Re and Im are formed from
// them in fp32 in the JAX kernel's order: the imaginary part p3 - p1 - p2
// cancels, its rounding error scales with |p1| + |p2| + |p3|, as in the
// fp32 plain version, so no product may fold two of them. Everything after
// the products is fp32; a row's quadratic term sums its columns as a tree.
//
// Bound on an H100 (131072 rows, M = D = K = 64): 3 x 6 x 2 N M (M + D) K
// = 2.47e12 bf16 tensor-core operations (2.50 ms at 989 TFLOP/s) plus N K
// (9 M + 11 D) = 1.1e10 fp32 epilogue operations (0.16 ms at 67 TFLOP/s),
// against ~0.17 GB of compulsory traffic (0.05 ms at 3.35 TB/s): 2.66 ms,
// against 6.15 ms for the three products as fp32 FMAs.
//
// Design:
//   - a block is WGS consumer warpgroups of 64 rows and one producer
//     warpgroup; WGS = 2 at M, D <= 64 (`setmaxnreg`: 232 registers a
//     consumer thread, 40 a producer thread), WGS = 1 where 128-row blocks
//     would not cover the SMs (the service's microbatches) or past 64;
//   - the rows' nine A planes (rr, ri, rs x hi, lo, lo2) sit in the
//     warpgroup's shared memory (K-major, 128-byte swizzle, M padded to 64
//     MC): three accumulators and the running output leave no registers
//     for them;
//   - the bank streams as units: one PW-column piece of one of B_re, B_im,
//     B_s (in that order), one 64-deep contraction chunk, its three bf16
//     planes, and the piece's vector values (mu or b, [Re | Im]); a
//     component's logit pieces come first, then its value pieces. PW = 64
//     at M, D <= 64, else 32, so that three 16-column accumulators beside
//     up to four value pieces of output fit 255 registers. One producer
//     thread copies unit after unit with cp.async.bulk into a ring of
//     stages under full and empty mbarriers, deep enough for a whole piece
//     (3 MC units);
//   - a piece is three commit groups of 24 MC wgmma m64nPWk16 (both
//     operands in shared memory, the descriptors offset inside the asm so
//     only their bases stay live), product by product over the piece's
//     chunks; p1's and p2's units go back to the ring as their groups
//     complete, p3's after the epilogue, which reads the vector values from
//     its stage and fences the proxy before the release (fault F2: a generic
//     read of the stage must be performed before the async refill lands);
//   - the epilogue reads the accumulators in registers (a thread holds rows
//     16 w + lane / 4 and + 8 of its warp w): a logit piece adds its
//     columns to the rows' quadratic terms (the thread's columns as a tree,
//     then the row's four threads by quad shuffles after the last logit
//     piece, then the online softmax), a value piece folds p z into the
//     running output;
//   - no wgmma group is in flight across a loop's back edge (ptxas
//     serialises every wgmma of a kernel where one is): the piece loop waits
//     for all three groups; the other warpgroup's products fill the tensor
//     cores during one warpgroup's epilogue;
//   - the ragged last tile is masked in the kernel (any N, no padding).
// Any N and K, M and D up to 128.
#include "grouped_tc_stream.cuh"

namespace {

using namespace qce_tc;

// One instantiation: MC 64-deep contraction chunks, PW-column pieces, XP
// value pieces of running output (at most), WGS consumer warpgroups.
template <int MC_, int PW_, int XP_, int WGS_>
struct KarCfg {
  static constexpr int MC = MC_, PW = PW_, XP = XP_, WGS = WGS_;
  static constexpr int kAcc = PW / 2;                // accumulator floats
  static constexpr unsigned kPlane = PW * 128;       // a unit's bf16 plane
  static constexpr unsigned kStage = 3 * kPlane;     // hi, lo, lo2
  static constexpr unsigned kVec = 2 * PW * 4;       // [Re | Im] of mu or b
  static constexpr unsigned kAWg = 9 * MC * kAtomBytes;  // a warpgroup's A
};

// The ring: stage s's planes at b + s kStage, its barriers at full / empty
// + 8 s and its vector values at vec + s kVec.
struct KarRing {
  unsigned b, full, empty, vec;
  int stages;
};

// k16 step I of operand O's six products (product-major over the piece's
// MC chunks, each chunk four steps): A plane (3 O + its plane) of chunk c
// in the warpgroup's A planes at da, B plane of the chunk's unit at db[c].
template <class C, int O, int I = 0>
__device__ __forceinline__ void operand_steps(float (&d)[C::kAcc],
                                              uint64_t da,
                                              const uint64_t (&db)[C::MC]) {
  if constexpr (I < 24 * C::MC) {
    constexpr int P = I / (4 * C::MC), c = (I / 4) % C::MC, ks = I % 4;
    constexpr int oa =
        (((3 * O + prod_a(6, P)) * C::MC + c) * kAtomBytes + ks * 32) >> 4;
    constexpr int ob = (prod_b(6, P) * (int)C::kPlane + ks * 32) >> 4;
    wgmma_at<oa, ob>(d, da, db[c], I > 0);
    operand_steps<C, O, I + 1>(d, da, db);
  }
}

// Wait for operand O's MC units at the cursor (s, ph), note their stages in
// st and issue its six products into d as one commit group.
template <class C, int O>
__device__ __forceinline__ void issue_operand(float (&d)[C::kAcc],
                                              uint64_t da,
                                              const KarRing& ring, int& s,
                                              int& ph, int (&st)[C::MC]) {
  uint64_t db[C::MC];
#pragma unroll
  for (int c = 0; c < C::MC; ++c) {
    mbar_wait(ring.full + 8 * s, ph);
    st[c] = s;
    db[c] = sw128_desc(ring.b + s * C::kStage);
    if (++s == ring.stages) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_fence();
  fence_operand(d);
  operand_steps<C, O>(d, da, db);
  wgmma_commit();
  fence_operand(d);
}

// A thread's rows: the running output of each value piece at columns 8 t +
// 2 (lane % 4) + {0, 1}, the online-softmax state and the quadratic terms.
template <class C>
struct KarRows {
  float o_re[C::XP][C::kAcc], o_im[C::XP][C::kAcc];
  float m_run[2], den[2], q[2], sc[2], p[2];
};

// A logit piece: the squared distances of its columns from mu added to the
// rows' quadratic terms. vec: this lane's first vector value in the stage.
template <class C>
__device__ __forceinline__ void logit_piece(KarRows<C>& st,
                                            const float (&p1)[C::kAcc],
                                            const float (&p2)[C::kAcc],
                                            const float (&p3)[C::kAcc],
                                            unsigned vec) {
  constexpr int T = C::PW / 8;
  float part[2][2 * T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float2 mr = ld_shared_f2(vec + 32 * t);
    const float2 mi = ld_shared_f2(vec + C::PW * 4 + 32 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * t + 2 * r + h;
        const float dre = (p1[i] - p2[i]) - (h ? mr.y : mr.x);
        const float dim = ((p3[i] - p1[i]) - p2[i]) - (h ? mi.y : mi.x);
        part[r][2 * t + h] = fmaf(dim, dim, dre * dre);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.q[r] += tree_sum<2 * T>(part[r]);
}

// The rows' logits complete (component k): the online softmax.
template <class C>
__device__ __forceinline__ void softmax_step(KarRows<C>& st, float lw) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float q = st.q[r];
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    st.q[r] = 0.f;
    const float logit = lw - q;
    const float m_new = fmaxf(st.m_run[r], logit);
    // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales by 0
    st.sc[r] = st.m_run[r] == -INFINITY ? 0.f : expf(st.m_run[r] - m_new);
    st.p[r] = logit == -INFINITY ? 0.f : expf(logit - m_new);
    st.den[r] = fmaf(st.den[r], st.sc[r], st.p[r]);
    st.m_run[r] = m_new;
  }
}

// Value piece jd: p (z + b) folded into the running output.
template <class C>
__device__ __forceinline__ void value_piece(KarRows<C>& st,
                                            const float (&p1)[C::kAcc],
                                            const float (&p2)[C::kAcc],
                                            const float (&p3)[C::kAcc],
                                            unsigned vec, int jd) {
  constexpr int T = C::PW / 8;
#pragma unroll
  for (int jj = 0; jj < C::XP; ++jj) {
    if (jj == jd) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float2 br = ld_shared_f2(vec + 32 * t);
        const float2 bi = ld_shared_f2(vec + C::PW * 4 + 32 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * t + 2 * r + h;
            const float zr = (p1[i] - p2[i]) + (h ? br.y : br.x);
            const float zi = ((p3[i] - p1[i]) - p2[i]) + (h ? bi.y : bi.x);
            st.o_re[jj][i] = fmaf(st.p[r], zr, st.o_re[jj][i] * st.sc[r]);
            st.o_im[jj][i] = fmaf(st.p[r], zi, st.o_im[jj][i] * st.sc[r]);
          }
      }
    }
  }
}

// The warpgroup's 64 rows of r_re, r_im -> the nine A planes at a: operand
// o (rr, ri, rs = rr + ri), plane q (hi, lo, lo2), chunk c at a + ((3 o + q)
// MC + c) kAtomBytes, each 64 rows x 64 bf16 in the 128-byte swizzle; rows
// past N and columns past M zero. 16 bytes (8 columns of one row) of each
// plane at a time.
template <class C>
__device__ __forceinline__ void load_rows(unsigned a,
                                          const float* __restrict__ r_re,
                                          const float* __restrict__ r_im,
                                          int m, int row0, int n) {
  constexpr int kUnitsRow = C::MC * 8;
  for (int u = threadIdx.x % kWg; u < 64 * kUnitsRow; u += kWg) {
    const int rr = u / kUnitsRow, kq = u - rr * kUnitsRow;
    const int row = row0 + rr;
    float x[3][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = kq * 8 + e;
      const bool in = row < n && c < m;
      x[0][e] = in ? __ldg(r_re + (size_t)row * m + c) : 0.f;
      x[1][e] = in ? __ldg(r_im + (size_t)row * m + c) : 0.f;
      x[2][e] = x[0][e] + x[1][e];  // the JAX kernel's shared operand rs
    }
    const unsigned off = sw128_off(rr, kq * 8);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      unsigned pl[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bf16 p[3][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = x[o][2 * e + h];
          p[0][h] = __float2bfloat16_rn(v);
          const float y = v - __bfloat162float(p[0][h]);
          p[1][h] = __float2bfloat16_rn(y);
          p[2][h] = __float2bfloat16_rn(y - __bfloat162float(p[1][h]));
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) pl[q][e] = pack_bf16(p[q][0], p[q][1]);
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
        st_shared_v4(a + (3 * o + q) * C::MC * kAtomBytes + off, pl[q]);
    }
  }
}

// The kernel. r_re, r_im (n, m) fp32; hi, lo, lo2: the bank's bf16 planes
// as units (`karatsuba_operands`: (k_comp, pieces, 3, MC, PW, 64)); vec:
// each piece's [Re | Im] vector values (k_comp, pieces, 2, PW); logw
// (k_comp); h_re, h_im (n, d).
template <class C>
__global__ void __launch_bounds__((C::WGS + 1) * kWg, 1)
    karatsuba_tc_kernel(const float* __restrict__ r_re,
                        const float* __restrict__ r_im,
                        const bf16* __restrict__ hi,
                        const bf16* __restrict__ lo,
                        const bf16* __restrict__ lo2,
                        const float* __restrict__ vec,
                        const float* __restrict__ logw,
                        float* __restrict__ h_re, float* __restrict__ h_im,
                        int n, int k_comp, int m, int d, int stages) {
  constexpr int WGS = C::WGS, MC = C::MC, PW = C::PW, XP = C::XP;
  constexpr int kAcc = C::kAcc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  KarRing ring;
  ring.b = base + WGS * C::kAWg;
  ring.stages = stages;
  ring.full = ring.b + stages * C::kStage;
  ring.empty = ring.full + 8 * stages;
  ring.vec = ring.empty + 8 * stages;
  const int mp = (m + PW - 1) / PW, pieces = mp + (d + PW - 1) / PW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, WGS * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == WGS) {  // the producer warpgroup: one thread streams the units
    if constexpr (WGS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == WGS * kWg) {
      const int total = k_comp * pieces * 3 * MC;
      int s = 0, ph = 0;
      for (int g = 0; g < total; ++g) {
        const unsigned full = ring.full + 8 * s;
        mbar_wait(ring.empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full, C::kStage + C::kVec);
        bulk_copy(ring.vec + s * C::kVec,
                  vec + (size_t)(g / (3 * MC)) * 2 * PW, C::kVec, full);
        const size_t off = (size_t)g * C::kPlane;  // unit order
        const unsigned dst = ring.b + s * C::kStage;
        bulk_copy(dst, reinterpret_cast<const char*>(hi) + off, C::kPlane,
                  full);
        bulk_copy(dst + C::kPlane, reinterpret_cast<const char*>(lo) + off,
                  C::kPlane, full);
        bulk_copy(dst + 2 * C::kPlane,
                  reinterpret_cast<const char*>(lo2) + off, C::kPlane, full);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (WGS == 2) setmaxnreg_inc<232>();

  const int row0 = blockIdx.x * (WGS * 64) + wg * 64;
  const unsigned a = base + wg * C::kAWg;
  load_rows<C>(a, r_re, r_im, m, row0, n);
  // the generic-proxy stores become visible to wgmma, then the warpgroup
  // meets
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(1 + wg);
  const uint64_t da = sw128_desc(a);

  KarRows<C> st;
#pragma unroll
  for (int j = 0; j < XP; ++j)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) st.o_re[j][i] = st.o_im[j][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m_run[r] = -INFINITY;
    st.den[r] = st.q[r] = st.sc[r] = st.p[r] = 0.f;
  }
  // this lane's vector values: columns 8 t + 2 (lane % 4) + {0, 1}
  const unsigned vec_lane = ring.vec + 8 * (lane_id() & 3);

  float p1[kAcc], p2[kAcc], p3[kAcc];
  int s = 0, ph = 0;
  for (int k = 0; k < k_comp; ++k) {
    for (int j = 0; j < pieces; ++j) {
      int s1[MC], s2[MC], s3[MC];
      issue_operand<C, 0>(p1, da, ring, s, ph, s1);
      issue_operand<C, 1>(p2, da, ring, s, ph, s2);
      issue_operand<C, 2>(p3, da, ring, s, ph, s3);
      wgmma_wait<2>();  // p1 complete: its units go back to the ring
#pragma unroll
      for (int c = 0; c < MC; ++c) warp_arrive(ring.empty + 8 * s1[c]);
      wgmma_wait<1>();
#pragma unroll
      for (int c = 0; c < MC; ++c) warp_arrive(ring.empty + 8 * s2[c]);
      wgmma_wait<0>();
      fence_operand(p1);
      fence_operand(p2);
      fence_operand(p3);
      const unsigned v = vec_lane + s3[0] * C::kVec;
      if (j < mp) {
        logit_piece<C>(st, p1, p2, p3, v);
        if (j == mp - 1) softmax_step<C>(st, __ldg(logw + k));
      } else {
        value_piece<C>(st, p1, p2, p3, v, j - mp);
      }
      // The stage is refilled by cp.async.bulk, a write of the async proxy;
      // the barrier's release orders the reads of its vector values above
      // only against the generic proxy, so this proxy fence keeps the
      // refill from landing before they are performed (fault F2).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < MC; ++c) warp_arrive(ring.empty + 8 * s3[c]);
    }
  }

  const int lane = lane_id();
  const bool pairs = (d & 1) == 0;  // then a thread's two columns are 8-byte
                                    // aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + row_in_wg() + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / st.den[r];
    float* ore = h_re + (size_t)row * d;
    float* oim = h_im + (size_t)row * d;
#pragma unroll
    for (int jj = 0; jj < XP; ++jj)
#pragma unroll
      for (int t = 0; t < PW / 8; ++t) {
        const int c = jj * PW + 8 * t + 2 * (lane & 3);
        const int i = 4 * t + 2 * r;
        if (pairs && c < d) {
          *reinterpret_cast<float2*>(ore + c) =
              make_float2(st.o_re[jj][i] * inv, st.o_re[jj][i + 1] * inv);
          *reinterpret_cast<float2*>(oim + c) =
              make_float2(st.o_im[jj][i] * inv, st.o_im[jj][i + 1] * inv);
        } else {
          if (c < d) {
            ore[c] = st.o_re[jj][i] * inv;
            oim[c] = st.o_im[jj][i] * inv;
          }
          if (c + 1 < d) {
            ore[c + 1] = st.o_re[jj][i + 1] * inv;
            oim[c + 1] = st.o_im[jj][i + 1] * inv;
          }
        }
      }
  }
}

// shared memory of a launch with `stages` ring stages
template <class C>
size_t kar_smem(int stages) {
  return 1024 + (size_t)C::WGS * C::kAWg +
         (size_t)stages * (C::kStage + 16 + C::kVec);
}

// the deepest ring (up to kMaxStages) that fits, 0 if not even one does
template <class C>
int kar_stages() {
  int s = kMaxStages;
  while (s > 0 && kar_smem<C>(s) > (size_t)kSmemMax) --s;
  return s;
}

struct KarArgs {
  const float* r_re;
  const float* r_im;
  const bf16* planes[3];
  const float* vec;
  const float* logw;
  float* h_re;
  float* h_im;
  int n, k_comp, m, d;
  cudaStream_t stream;
};

template <class C>
int kar_launch(const KarArgs& g) {
  const int stages = kar_stages<C>();
  if (stages < 3 * C::MC) return (int)cudaErrorInvalidValue;  // a piece
  const size_t smem = kar_smem<C>(stages);
  auto kern = karatsuba_tc_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = C::WGS * 64;
  kern<<<(g.n + rows - 1) / rows, (C::WGS + 1) * kWg, smem, g.stream>>>(
      g.r_re, g.r_im, g.planes[0], g.planes[1], g.planes[2], g.vec, g.logw,
      g.h_re, g.h_im, g.n, g.k_comp, g.m, g.d, stages);
  return (int)cudaGetLastError();
}

// M, D <= 64: 64-column pieces, two consumer warpgroups where 128-row
// blocks cover the SMs, else one. Wider: 32-column pieces, one warpgroup.
int kar_dispatch(const KarArgs& g) {
  if (g.m <= 64 && g.d <= 64) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return (int)cudaErrorInvalidDevice;
    if ((g.n + 127) / 128 >= sms) return kar_launch<KarCfg<1, 64, 1, 2>>(g);
    return kar_launch<KarCfg<1, 64, 1, 1>>(g);
  }
  if (g.m <= 64) return kar_launch<KarCfg<1, 32, 4, 1>>(g);
  if (g.d <= 64) return kar_launch<KarCfg<2, 32, 2, 1>>(g);
  return kar_launch<KarCfg<2, 32, 4, 1>>(g);
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K14a: r_re, r_im (n, m) -> h_re, h_im (n, d), all fp32; hi, lo, lo2: the
// bank's three bf16 planes as units and vec their vector values
// (`variant_kernels.karatsuba_operands`, 16-byte aligned); logw (k_comp).
extern "C" int karatsuba_estimate_launch(
    const float* r_re, const float* r_im, const void* hi, const void* lo,
    const void* lo2, const float* vec, const float* logw, float* h_re,
    float* h_im, int n, int k_comp, int m, int d, void* stream) {
  if (n < 0 || k_comp < 1 || m < 1 || m > 128 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  const void* aligned[4] = {hi, lo, lo2, vec};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const KarArgs g{r_re,
                  r_im,
                  {static_cast<const bf16*>(hi), static_cast<const bf16*>(lo),
                   static_cast<const bf16*>(lo2)},
                  vec,
                  logw,
                  h_re,
                  h_im,
                  n,
                  k_comp,
                  m,
                  d,
                  static_cast<cudaStream_t>(stream)};
  return kar_dispatch(g);
}
