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
// bf16(pw - pw_hi) (split in the wrapper, cached beside the bank),
// r_hi = bf16(r2), r_lo = bf16(r2 - r_hi) (split here, per tile), all
// rounded to nearest even, and
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
// Design, simple and correct first (wgmma and TMA are later work):
//   - one block of 8 warps per tile of TN rows (64; 32 past 2M + 2D = 256);
//     the tile's r_hi (and r_lo) sits in shared memory as bf16, zero-padded
//     to Kp = 2M rounded up to 16;
//   - the bank planes are streamed through shared memory in slices of kc
//     contraction rows (32; 16 past 2M + 2D = 256), double-buffered with
//     cp.async from L2, the columns zero-padded to Sp = 2M + 2D rounded up
//     to 16 and the rows past 2M zeroed;
//   - mma.sync m16n8k16 bf16 products with fp32 accumulators, operands
//     from shared memory by ldmatrix (B, stored k-major, by ldmatrix.trans):
//     a warp owns one 16-row tile and every (8 / (TN / 16))-th 16-column
//     tile, at most 8 of them, all passes into one accumulator;
//   - at each component's end the accumulators go to an fp32 yz tile in
//     shared memory and K1's epilogue runs on it in fp32: each warp owns
//     TN / 8 rows, side by side (their sums and shuffles independent), each
//     lane columns lane + 32 j, the quadratic term reduced by shuffles, the
//     online softmax and combine in registers;
//   - the ragged last tile is masked in the kernel (any N, no padding).
// What bounds it at the headline shapes is the bank, streamed from L2 once
// per 64-row tile (4 MB a bf16 plane), and the epilogue, which does not
// overlap the products (PERF.md).
// Any N and K, 2M and 2D up to 256.
#include <cuda_bf16.h>

#include "stream_common.cuh"

namespace {

using namespace qce;
using bf16 = __nv_bfloat16;

constexpr int kFragDim = 16;
constexpr int kMaxFrags = 8;  // 16-column tiles a warp
constexpr int kMaxCw = 8;     // output columns a lane (2D <= 256)

__device__ __forceinline__ void cp_async16b(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4b(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b for one m16n8k16 tile: a, 4 registers of bf16 pairs (row-major
// A), b0 / b1 its k 0-7 / 8-15 (column-major B), d 4 fp32
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copy of pipeline stage t (component t / n_ch, contraction rows
// kk0 .. kk0 + kc of its padded Kp) of `planes` bank planes into bufs
// (plane p at bufs + p * kc * ldb): real elements by cp.async (8 bf16 a copy
// with vec8, else 2), padding (columns past s_cols, rows past two_m) zeroed
// by plain stores.
template <int PLANES>
__device__ __forceinline__ void issue_tc_stage(bf16* bufs, const bf16* hi,
                                               const bf16* lo, int t,
                                               int n_ch, int two_m,
                                               int s_cols, int kp, int sp,
                                               int kc, int ldb, bool vec8) {
  const int k = t / n_ch;
  const int kk0 = (t % n_ch) * kc;
  const int rows = min(kc, kp - kk0);
  const size_t src0 = ((size_t)k * two_m + kk0) * s_cols;
  const int per = vec8 ? 8 : 2;
  const int units = sp / per;
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int rr = i / units, cc = (i - rr * units) * per;
    const bool real = kk0 + rr < two_m && cc < s_cols;
    const size_t src = src0 + (size_t)rr * s_cols + cc;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      bf16* dst = bufs + p * kc * ldb + rr * ldb + cc;
      const bf16* plane = p == 0 ? hi : lo;
      if (real) {
        if (vec8)
          cp_async16b(dst, plane + src);
        else
          cp_async4b(dst, plane + src);
      } else if (vec8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        *reinterpret_cast<unsigned*>(dst) = 0u;
      }
    }
  }
}

template <int PASSES, int TN>
__global__ void __launch_bounds__(kThreads)
    grouped_tc_kernel(const float* __restrict__ r2,
                      const bf16* __restrict__ pw_hi,
                      const bf16* __restrict__ pw_lo,
                      const float* __restrict__ mu,
                      const float* __restrict__ b,
                      const float* __restrict__ logw, float* __restrict__ out,
                      int n, int k_comp, int two_m, int two_d, int kp, int sp,
                      int kc, int vec8) {
  constexpr int kPlanes = PASSES >= 2 ? 2 : 1;
  constexpr int kRpw = TN / kWarps;        // epilogue rows a warp
  constexpr int kRowTiles = TN / kFragDim;
  constexpr int kWarpsPerRow = kWarps / kRowTiles;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int s_cols = two_m + two_d;
  const int ldr = kp + 8;  // bf16 row strides: 16 bytes past a multiple of
  const int ldb = sp + 8;  // 128, so ldmatrix rows hit distinct banks
  const int ldy = sp + 4;
  bf16* r_hi = reinterpret_cast<bf16*>(smem_raw);
  bf16* r_lo = r_hi + TN * ldr;
  bf16* stage = r_lo + (PASSES == 3 ? TN * ldr : 0);
  const int buf_elems = kPlanes * kc * ldb;
  float* yz = reinterpret_cast<float*>(stage + 2 * buf_elems);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TN;

  const int n_ch = (kp + kc - 1) / kc;
  const int total = k_comp * n_ch;
  issue_tc_stage<kPlanes>(stage, pw_hi, pw_lo, 0, n_ch, two_m, s_cols, kp, sp,
                          kc, ldb, vec8);
  cp_async_commit();

  // r tile -> bf16 hi (and lo) planes; masked rows and padded columns zero
  for (int i = threadIdx.x; i < TN * kp; i += kThreads) {
    const int rr = i / kp, cc = i - rr * kp;
    const int row = row0 + rr;
    const float x =
        (row < n && cc < two_m) ? r2[(size_t)row * two_m + cc] : 0.f;
    const bf16 h = __float2bfloat16_rn(x);
    r_hi[rr * ldr + cc] = h;
    if constexpr (PASSES == 3)
      r_lo[rr * ldr + cc] = __float2bfloat16_rn(x - __bfloat162float(h));
  }

  const int rt = warp % kRowTiles;      // this warp's 16-row tile
  const int ct0 = warp / kRowTiles;     // its first 16-column tile
  const int n_ct = sp / kFragDim;
  // a 16-column tile is two m16n8 accumulators of 4 floats
  float accf[kMaxFrags][2][4];
#pragma unroll
  for (int f = 0; f < kMaxFrags; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) accf[f][h][e] = 0.f;
  // ldmatrix row addresses of this lane: A rows rt 16 + lane % 16 at
  // column 8 (lane / 16); B (.trans, its rows are k) rows 8 (j % 2) +
  // lane % 8 at column 8 (j / 2), j = lane / 8
  const int a_row = rt * kFragDim + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_col = (lane >> 4) * 8;

  float acc[kRpw][kMaxCw], m_run[kRpw], den[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    m_run[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCw; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_tc_stage<kPlanes>(stage + ((t + 1) & 1) * buf_elems, pw_hi, pw_lo,
                              t + 1, n_ch, two_m, s_cols, kp, sp, kc, ldb,
                              vec8);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const bf16* bh = stage + (t & 1) * buf_elems;
    const bf16* bl = bh + kc * ldb;
    const int k = t / n_ch;
    const int kk0 = (t % n_ch) * kc;
    const int steps = min(kc, kp - kk0) / kFragDim;
    for (int s = 0; s < steps; ++s) {
      unsigned ah[4], al[4];
      ldsm_x4(ah, r_hi + a_row * ldr + kk0 + s * kFragDim + a_col);
      if constexpr (PASSES == 3)
        ldsm_x4(al, r_lo + a_row * ldr + kk0 + s * kFragDim + a_col);
#pragma unroll
      for (int f = 0; f < kMaxFrags; ++f) {
        const int ct = ct0 + f * kWarpsPerRow;
        if (ct < n_ct) {
          const int off =
              (s * kFragDim + b_row) * ldb + ct * kFragDim + b_col;
          unsigned bh4[4];
          ldsm_x4_trans(bh4, bh + off);
          mma_bf16(accf[f][0], ah, bh4[0], bh4[1]);
          mma_bf16(accf[f][1], ah, bh4[2], bh4[3]);
          if constexpr (PASSES >= 2) {
            unsigned bl4[4];
            ldsm_x4_trans(bl4, bl + off);
            mma_bf16(accf[f][0], ah, bl4[0], bl4[1]);
            mma_bf16(accf[f][1], ah, bl4[2], bl4[3]);
          }
          if constexpr (PASSES == 3) {
            mma_bf16(accf[f][0], al, bh4[0], bh4[1]);
            mma_bf16(accf[f][1], al, bh4[2], bh4[3]);
          }
        }
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by the issue at t + 1

    if (kk0 + kc >= kp) {  // component k complete: fp32 epilogue on yz
#pragma unroll
      for (int f = 0; f < kMaxFrags; ++f) {
        const int ct = ct0 + f * kWarpsPerRow;
        if (ct < n_ct) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // accumulator e: row lane / 4 (+ 8 for e >= 2), column
            // 2 (lane % 4) + e % 2 of the m16n8 tile
            float* y0 = yz + (rt * kFragDim + (lane >> 2)) * ldy +
                        ct * kFragDim + h * 8 + (lane & 3) * 2;
            *reinterpret_cast<float2*>(y0) =
                make_float2(accf[f][h][0], accf[f][h][1]);
            *reinterpret_cast<float2*>(y0 + 8 * ldy) =
                make_float2(accf[f][h][2], accf[f][h][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) accf[f][h][e] = 0.f;
          }
        }
      }
      __syncthreads();
      // yz is rewritten only after the next stage's barrier
      const float* muk = mu + (size_t)k * two_m;
      const float* bk = b + (size_t)k * two_d;
      const float lw = logw[k];
      const float* ys = yz + warp * kRpw * ldy;
      float q[kRpw];
#pragma unroll
      for (int i = 0; i < kRpw; ++i) q[i] = 0.f;
      for (int c = lane; c < two_m; c += 32) {
        const float mc = __ldg(muk + c);
#pragma unroll
        for (int i = 0; i < kRpw; ++i) {
          const float dv = ys[i * ldy + c] - mc;
          q[i] = fmaf(dv, dv, q[i]);
        }
      }
      // warp_sum's butterfly, the rows side by side
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRpw; ++i)
          q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
      float bc[kMaxCw];
#pragma unroll
      for (int j = 0; j < kMaxCw; ++j) {
        const int c = lane + 32 * j;
        bc[j] = c < two_d ? __ldg(bk + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRpw; ++i) {
        const float logit = lw - q[i];
        const float m_new = fmaxf(m_run[i], logit);
        // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales by 0
        const float scale =
            m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
        const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
        den[i] = fmaf(den[i], scale, p);
#pragma unroll
        for (int j = 0; j < kMaxCw; ++j) {
          const int c = lane + 32 * j;
          if (c < two_d)
            acc[i][j] = fmaf(p, ys[i * ldy + two_m + c] + bc[j],
                             acc[i][j] * scale);
        }
        m_run[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int row = row0 + warp * kRpw + i;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < kMaxCw; ++j) {
        const int c = lane + 32 * j;
        if (c < two_d) out[(size_t)row * two_d + c] = acc[i][j] / den[i];
      }
    }
  }
}

template <int PASSES, int TN>
int launch(const float* r2, const bf16* pw_hi, const bf16* pw_lo,
           const float* mu, const float* b, const float* logw, float* out,
           int n, int k_comp, int two_m, int two_d, int kp, int sp, int kc,
           cudaStream_t stream) {
  constexpr int kPlanes = PASSES >= 2 ? 2 : 1;
  const int s_cols = two_m + two_d;
  const size_t smem =
      sizeof(bf16) * ((PASSES == 3 ? 2 : 1) * (size_t)TN * (kp + 8) +
                      2 * (size_t)kPlanes * kc * (sp + 8)) +
      sizeof(float) * (size_t)TN * (sp + 4);
  const bool aligned =
      reinterpret_cast<uintptr_t>(pw_hi) % 16 == 0 &&
      (PASSES == 1 || reinterpret_cast<uintptr_t>(pw_lo) % 16 == 0);
  const int vec8 = s_cols % 8 == 0 && aligned;
  auto kern = grouped_tc_kernel<PASSES, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TN - 1) / TN;
  kern<<<grid, kThreads, smem, stream>>>(r2, pw_hi, pw_lo, mu, b, logw, out,
                                         n, k_comp, two_m, two_d, kp, sp, kc,
                                         vec8);
  return (int)cudaGetLastError();
}

template <int PASSES>
int dispatch(const float* r2, const bf16* pw_hi, const bf16* pw_lo,
             const float* mu, const float* b, const float* logw, float* out,
             int n, int k_comp, int two_m, int two_d, cudaStream_t s) {
  const int kp = (two_m + 15) & ~15;
  const int sp = (two_m + two_d + 15) & ~15;
  if (sp <= 256)
    return launch<PASSES, 64>(r2, pw_hi, pw_lo, mu, b, logw, out, n, k_comp,
                              two_m, two_d, kp, sp, 32, s);
  return launch<PASSES, 32>(r2, pw_hi, pw_lo, mu, b, logw, out, n, k_comp,
                            two_m, two_d, kp, sp, 16, s);
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// K14b: r2 (n, two_m) fp32 -> out (n, two_d) fp32 through `passes` (1, 2
// or 3) bf16 tensor-core products; pw_hi, pw_lo (k_comp, two_m,
// two_m + two_d) bf16 (pw_lo unread at passes = 1), mu (k_comp, two_m),
// b (k_comp, two_d), logw (k_comp) fp32.
extern "C" int grouped_tc_estimate_launch(const float* r2, const void* pw_hi,
                                          const void* pw_lo, const float* mu,
                                          const float* b, const float* logw,
                                          float* out, int n, int k_comp,
                                          int two_m, int two_d, int passes,
                                          void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 256 || two_d < 1 ||
      two_d > 256)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hi = static_cast<const bf16*>(pw_hi);
  const bf16* lo = static_cast<const bf16*>(pw_lo);
  switch (passes) {
    case 1:
      return dispatch<1>(r2, hi, lo, mu, b, logw, out, n, k_comp, two_m,
                         two_d, s);
    case 2:
      return dispatch<2>(r2, hi, lo, mu, b, logw, out, n, k_comp, two_m,
                         two_d, s);
    case 3:
      return dispatch<3>(r2, hi, lo, mu, b, logw, out, n, k_comp, two_m,
                         two_d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
