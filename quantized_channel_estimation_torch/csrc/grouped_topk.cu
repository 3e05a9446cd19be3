// Top-k selection GMM-Bussgang estimator (kernel K4) and its split-K stats
// form (kernel K5) for Hopper.
//
// Replaces the TPU kernel `_grouped_stream_topk` +
// `_estimate_kernel_block_grouped_topk` launched by
// `estimate_packed_block_grouped_topk`
// (quantized_channel_estimation_tpu/estimators/pallas_kernels.py:568, :611,
// :633, pallas_call :662; entry `estimate_fused_topk` :809), and
// `_estimate_kernel_block_grouped_topk_stats` launched by
// `estimate_packed_block_grouped_topk_stats` (:677, :695, pallas_call :725;
// K5). The STATS form writes the shard's candidates instead of combining
// them: per row the selected logits lg_nj (n, k_sel), sorted descending,
// and estimates r2_n W_j + b_j (n, k_sel, 2D); slots past the shard's K
// hold -inf and zeros. The top-k of a union is the top-k of the shards'
// top-k's, so `merge_topk` merges shards exactly. Per row n of
// r2 = [Re r | Im r] (N x 2M), with the logits
// lg_nk = logw_k - |r2_n P_k - mu_k|^2 and S_n the k_sel components of
// largest logit (ties keep the lower index):
//
//   h2_n = sum_{j in S_n} w_j (r2_n W_j + b_j) / sum_{j in S_n} w_j,
//   w_j = exp(lg_nj - max_{S_n} lg)
//
// (k_sel = 1: the estimate of the argmax component alone).
//
// Bound on an H100: 2 N 2M 2M K fp32 operations for the logits plus
// k_sel 2 N 2M 2D for the selected estimates (2.75e11 + k_sel 4.3e9 at
// N = 131072, M = D = K = 64: 4.1 ms + 0.064 ms k_sel at the 67 TFLOP/s
// fp32 peak); bytes ~0.1 GB (0.03 ms; K5 writes k_sel (1 + 2D) floats a
// row, 0.27 GB at k_sel = 4): bound by fp32 FMA throughput. The math is
// fp32 FMAs throughout: TF32 would move the posterior.
//
// Design. The TPU kernel streams the whole [P | W] bank and keeps k_sel
// live (tile, 2D) estimate buffers beside the running top-k logits; here
// the stream reads only the precision part P_k (2M x 2M) and the selected
// W_j are applied afterwards. The first version ran the logits
// as a scalar-load loop (8 rows x 2M columns a warp: 0.375 shared loads an
// FMA, 2 barriers a 32-row slice) and an epilogue that read each selected
// W_j once per row: 12.7 / 14.3 ms for K4 at k = 1 / 4, 12.9 / 14.9 for
// K5 (PERF.md). Now:
//   - the logits are a register-tiled fp32 GEMM: a block of 256 threads
//     holds TR = 2048 / TX rows x Cp = 8 TX padded columns (TX = 8, 16, 32
//     for 2M up to 64, 128, 256), each thread an 8 x 8 tile of rows
//     {4 ty, TR / 2 + 4 ty} + {0..3} x columns {4 tx, Cp / 2 + 4 tx} +
//     {0..3}, a warp 4 row groups x 8 column groups; the r tile is stored
//     k-major, so every contraction row costs 4 16-byte shared loads for
//     64 FMAs;
//   - P streams through a 3-stage cp.async ring of Kc = 256 / TX rows x Cp
//     columns (8 KB a stage) with one barrier a stage;
//   - a component's quadratic term is reduced over the 8 column groups of
//     a warp by xor shuffles and over the TX / 8 warps of a row group in
//     warp order through shared memory; lane l keeps the running top-k of
//     row l % 8 of its 8, (logit, index) pairs inserted with strict >
//     (ties keep the lower index) and an unconditional shift after
//     placement;
//   - the epilogue buckets the tile's (row, slot) picks by component: each
//     warp takes picked components in turn and reads W_j once for up to
//     8 / CV of its picks (16-byte loads, 8 / CV rows in flight), applying
//     it from a register tile of 8, 4, 2 or 1 picks x 4 CV columns a lane,
//     the rows' r from the k-major tile. K5 writes each candidate; K4
//     writes them to a scratch (n, k_sel, 2D) and then combines each row's
//     in slot order (k_sel = 1: straight to the output), so the result does
//     not depend on the order of the warps. The scratch is N k_sel 2D
//     floats (K5's own output has that size) and costs its write and one
//     read-back (PERF.md); combining in the block instead needs a 64 KB
//     accumulator a tile at 2M = 2D = 128, which halves the logit loop's
//     blocks an SM, or a pass a slot, which reads each W_j up to k_sel
//     times, or atomics, whose sum depends on the order of the warps.
// Measured (chip_smoke, H100 80GB HBM3 at 700 W, 131072 rows, K = D = 64):
// K4 7.69-7.97 / 8.85-9.20 ms at k = 1 / 4, K5 7.73-8.06 / 8.80-9.03, the
// one-call logit GEMM 7.26-7.58 (~56% of the fp32 peak). What bounds it
// now (PERF.md): k = 1 runs 4-9% over that GEMM in each call; k = 4
// costs 1.0-1.2 ms more than k = 1, mostly in the epilogue's W_j reads
// from L2, about the whole W bank per 128-row tile (most components are
// picked in a tile); the scratch's read-back and combine take 0.03-0.17.
// Any N, K, 1 <= k_sel <= min(8, K) (K5: 1 <= k_sel <= 8, any K), 2M and
// 2D up to 256.
#include "stream_common.cuh"

namespace {

using namespace qce;

constexpr int kSlots = 8;      // TOPK_KERNEL_MAX
constexpr int kStages = 3;     // the ring
constexpr int kStageF = 2048;  // floats a stage: Kc x Cp (or x Cw)
constexpr int kWin = 1024;     // components bucketed at a time

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's shape at TX threads a row group (8, 16, 32 for 2M up to 64,
// 128, 256): a warp is 4 row groups x 8 column groups, WC warps side by
// side cover a row group's TX column groups.
template <int TX>
struct Shape {
  static constexpr int kTy = kThreads / TX;  // row groups
  static constexpr int kCp = 8 * TX;         // P columns, padded
  static constexpr int kKc = kStageF / kCp;  // contraction rows a stage
  static constexpr int kTr = 8 * kTy;        // rows a tile
  static constexpr int kRs = kTr + 4;        // row stride of the r tile
  static constexpr int kWc = TX / 8;         // warps across a row group
};

// Issue the copy of `rows` rows of `cols` floats, row stride s_cols from
// src, into buf at row stride ld; vec: 16-byte copies.
__device__ __forceinline__ void issue_rows(float* buf, const float* src,
                                           int rows, int cols, int ld,
                                           int s_cols, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
      const int rr = i / c4, cc = (i - rr * c4) * 4;
      cp_async16(buf + rr * ld + cc, src + (size_t)rr * s_cols + cc);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int rr = i / cols, cc = i - rr * cols;
      cp_async4(buf + rr * ld + cc, src + (size_t)rr * s_cols + cc);
    }
  }
}

// The selected estimates z = r2_row W_j + b_j of a tile, applied by one
// warp: lane l holds columns 4 l + {0..3} (and 128 + 4 l + {0..3} at
// 2D > 128) of W_j's rows, read 8 / CV rows at a time, the rows' r from the
// k-major tile.
struct Apply {
  const float* pw;
  const float* b;
  const float* r_t;
  int rs, s_cols, two_m, two_d;
  float* dst;      // K5: z; K4: the output (k_sel = 1) or its scratch
  float* l_out;    // K5
  const float* pick_l;
  int k_sel, row0;
  bool stats;
  int lane;
};

// the 4 columns c .. c + 3 of a row (c even; 2D even, so columns c, c + 1
// are read where ok and c + 2, c + 3 where ok2; others read as 0), as
// predicated loads without branches, so a row's loads issue together
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int c, bool ok,
                                        bool ok2) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (VEC)
    return ok ? __ldg(reinterpret_cast<const float4*>(row + c)) : zero;
  return make_float4(ok ? __ldg(row + c) : 0.f, ok ? __ldg(row + c + 1) : 0.f,
                     ok2 ? __ldg(row + c + 2) : 0.f,
                     ok2 ? __ldg(row + c + 3) : 0.f);
}

// z for `count` <= RG picks (row * 8 + slot, in `picks`) of component j,
// written out; W_j is read once for them
template <int RG, int CV, bool VEC>
__device__ __forceinline__ void apply_w(const Apply& ap, int j,
                                        const int* picks, int count) {
  constexpr int kV = 8 / CV;  // rows of W_j in flight
  bool ok[CV], ok2[CV];
#pragma unroll
  for (int h = 0; h < CV; ++h) {
    ok[h] = 128 * h + 4 * ap.lane < ap.two_d;
    ok2[h] = 128 * h + 4 * ap.lane + 2 < ap.two_d;
  }
  const float* wk = ap.pw + (size_t)j * ap.two_m * ap.s_cols + ap.two_m;
  int rr[RG];
#pragma unroll
  for (int u = 0; u < RG; ++u)  // past count: the first pick again
    rr[u] = picks[u < count ? u : 0] / kSlots;
  float z[RG][4 * CV];
#pragma unroll
  for (int u = 0; u < RG; ++u)
#pragma unroll
    for (int e = 0; e < 4 * CV; ++e) z[u][e] = 0.f;
  for (int kq = 0; kq < ap.two_m; kq += kV) {
    float4 w[kV][CV];
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int h = 0; h < CV; ++h)
        w[v][h] = load4<VEC>(wk + (size_t)(kq + v) * ap.s_cols,
                             128 * h + 4 * ap.lane, ok[h] && kq + v < ap.two_m,
                             ok2[h] && kq + v < ap.two_m);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      if (kq + v < ap.two_m) {
        const float* rk = ap.r_t + (kq + v) * ap.rs;
#pragma unroll
        for (int u = 0; u < RG; ++u) {
          const float a = rk[rr[u]];
#pragma unroll
          for (int h = 0; h < CV; ++h) {
            z[u][4 * h] = fmaf(a, w[v][h].x, z[u][4 * h]);
            z[u][4 * h + 1] = fmaf(a, w[v][h].y, z[u][4 * h + 1]);
            z[u][4 * h + 2] = fmaf(a, w[v][h].z, z[u][4 * h + 2]);
            z[u][4 * h + 3] = fmaf(a, w[v][h].w, z[u][4 * h + 3]);
          }
        }
      }
    }
  }
  const float* bk = ap.b + (size_t)j * ap.two_d;
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    if (u >= count) break;
    const int s = picks[u] % kSlots;
    const int row = ap.row0 + rr[u];
    const size_t at = (ap.k_sel == 1 && !ap.stats)
                          ? (size_t)row
                          : (size_t)row * ap.k_sel + s;
    float* zrow = ap.dst + at * ap.two_d;
#pragma unroll
    for (int h = 0; h < CV; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 128 * h + 4 * ap.lane + e;
        if (c < ap.two_d) zrow[c] = z[u][4 * h + e] + __ldg(bk + c);
      }
    if (ap.stats && ap.lane == 0)
      ap.l_out[(size_t)row * ap.k_sel + s] = ap.pick_l[picks[u]];
  }
}

// all m picks of component j, up to 8 / CV at a time in a register tile
// of 8, 4, 2 or 1 picks (W_j is read once per 8 / CV picks)
template <int CV, bool VEC>
__device__ __forceinline__ void apply_picks(const Apply& ap, int j,
                                            const int* picks, int m) {
  constexpr int kRg = 8 / CV;
  for (int g0 = 0; g0 < m; g0 += kRg) {
    const int left = min(m - g0, kRg);
    if (kRg == 8 && left > 4)
      apply_w<kRg, CV, VEC>(ap, j, picks + g0, left);
    else if (left > 2)
      apply_w<4, CV, VEC>(ap, j, picks + g0, left);
    else if (left == 2)
      apply_w<2, CV, VEC>(ap, j, picks + g0, left);
    else
      apply_w<1, CV, VEC>(ap, j, picks + g0, left);
  }
}

template <int TX, int CW, bool STATS>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_topk_kernel(const float* __restrict__ r2,
                        const float* __restrict__ pw,
                        const float* __restrict__ mu,
                        const float* __restrict__ b,
                        const float* __restrict__ logw,
                        float* out,      // K5: z (n, k_sel, 2D)
                        float* l_out,    // K5: l (n, k_sel)
                        float* scratch,  // K4, k_sel > 1: written, re-read
                        int n, int k_comp, int two_m, int two_d, int k_sel,
                        int vec) {
  using S = Shape<TX>;
  constexpr int CV = CW == 8 ? 2 : 1;      // 4-column groups of 2D a lane
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_list;
  const int s_cols = two_m + two_d;
  float* r_t = smem;                       // [2M][kRs], k-major
  float* ring = smem + two_m * S::kRs;     // kStages x kStageF
  float* epi = ring + kStages * kStageF;   // qbuf, then the picks

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wc = warp % S::kWc;
  const int tx = wc * 8 + (lane & 7);
  const int ty = (warp / S::kWc) * 4 + (lane >> 3);
  const int row0 = blockIdx.x * S::kTr;

  // the ring's padding columns stay zero: the copies never write them
  for (int i = tid; i < kStages * kStageF; i += kThreads)
    if (i % S::kCp >= two_m) ring[i] = 0.f;

  const int n_ch = (two_m + S::kKc - 1) / S::kKc;
  const int total = k_comp * n_ch;
  auto issue_p = [&](int t) {
    const int k = t / n_ch, kk0 = (t % n_ch) * S::kKc;
    issue_rows(ring + (t % kStages) * kStageF,
               pw + ((size_t)k * two_m + kk0) * s_cols,
               min(S::kKc, two_m - kk0), two_m, S::kCp, s_cols, vec);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) issue_p(t);
    cp_async_commit();
  }

  // r tile -> k-major shared memory, rows past N read as zeros (never
  // stored)
  for (int i = tid; i < S::kTr * two_m; i += kThreads) {
    const int rr = i / two_m, cc = i - rr * two_m;
    const int row = row0 + rr;
    r_t[cc * S::kRs + rr] = row < n ? r2[(size_t)row * two_m + cc] : 0.f;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // running top-k of row `mine` of this thread's 8 (tile row rr_mine),
  // sorted by descending logit
  const int mine = lane & 7;
  const int rr_mine =
      mine < 4 ? 4 * ty + mine : S::kTr / 2 + 4 * ty + mine - 4;
  float top_l[kSlots];
  int top_k[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    top_l[s] = -INFINITY;
    top_k[s] = -1;
  }

  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free for t + 2
    if (t + kStages - 1 < total) issue_p(t + kStages - 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    const float* ps = ring + (t % kStages) * kStageF;
    const int k = t / n_ch;
    const int kk0 = (t % n_ch) * S::kKc;
    const int rows = min(S::kKc, two_m - kk0);
    const float* rs = r_t + kk0 * S::kRs;
    auto step = [&](int kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(rs + kk * S::kRs + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(
          rs + kk * S::kRs + S::kTr / 2 + 4 * ty);
      const float4 b0 =
          *reinterpret_cast<const float4*>(ps + kk * S::kCp + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(
          ps + kk * S::kCp + S::kCp / 2 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bp[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bp[j], acc[i][j]);
    };
    if (rows == S::kKc) {
#pragma unroll
      for (int kk = 0; kk < S::kKc; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < rows; ++kk) step(kk);
    }

    if (kk0 + rows == two_m) {  // component k complete: top-k insert
      const float* muk = mu + (size_t)k * two_m;
      float q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // padding columns hold 0 in acc (their P is zero) and in mc
        const int c = (j < 4 ? 4 * tx : S::kCp / 2 + 4 * tx) + (j & 3);
        const float mc = c < two_m ? __ldg(muk + c) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = acc[i][j] - mc;
          q[i] = fmaf(d, d, q[i]);
          acc[i][j] = 0.f;
        }
      }
      // sum over the warp's 8 column groups (the xor butterfly leaves the
      // same bits in every lane), then over the kWc warps of the row group
      // in warp order through shared memory
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
      float qm = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i == mine) qm = q[i];
      if constexpr (S::kWc > 1) {
        float* qbuf = epi + (k & 1) * S::kWc * S::kTr;
        qbuf[wc * S::kTr + rr_mine] = qm;
        __syncthreads();
        qm = 0.f;
#pragma unroll
        for (int w = 0; w < S::kWc; ++w) qm += qbuf[w * S::kTr + rr_mine];
      }
      float cand = __ldg(logw + k) - qm;
      // insert into the sorted list: the first slot whose logit is below
      // cand's takes it (strict: ties keep the lower k, which came first),
      // and every later slot the one pushed out of the slot above, so the
      // list stays ordered by (logit desc, k asc) also through exact ties
      // (dead components all sit at the -1e30 floor)
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
  }

  // Epilogue. The ring and the row groups' sums are free: they hold the
  // tile's picks (component and logit of (row, slot), at row * 8 + slot),
  // the picked components of one window and each warp's list of one
  // component's picks.
  cp_async_wait<0>();
  __syncthreads();
  int* pick_c = reinterpret_cast<int*>(ring);
  float* pick_l = ring + S::kTr * kSlots;
  unsigned* bits = reinterpret_cast<unsigned*>(pick_l + S::kTr * kSlots);
  int* list = reinterpret_cast<int*>(bits + kWin / 32);
  int* wlist = list + kWin + warp * S::kTr;

  if (wc == 0) {  // one copy of each row's picks
    const int row = row0 + rr_mine;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < k_sel) {
        // -1: an empty slot (K < k_sel, K5 only); -2: a row past N
        pick_c[rr_mine * kSlots + s] = row < n ? top_k[s] : -2;
        pick_l[rr_mine * kSlots + s] = top_l[s];
        if constexpr (STATS) {
          if (row < n && top_k[s] < 0) {
            l_out[(size_t)row * k_sel + s] = -INFINITY;
            float* zrow = out + ((size_t)row * k_sel + s) * two_d;
            for (int c = 0; c < two_d; ++c) zrow[c] = 0.f;
          }
        }
      }
    }
  }
  const Apply ap{pw, b, r_t, S::kRs, s_cols, two_m, two_d,
                 STATS ? out : (k_sel == 1 ? out : scratch), l_out, pick_l,
                 k_sel, row0, STATS, lane};
  const int picks = S::kTr * k_sel;

  for (int k0 = 0; k0 < k_comp; k0 += kWin) {
    __syncthreads();  // the picks are published; the last window is done
    for (int i = tid; i < kWin / 32; i += kThreads) bits[i] = 0u;
    __syncthreads();
    for (int i = tid; i < picks; i += kThreads) {
      const int rr = i / k_sel, s = i - rr * k_sel;
      const int c = pick_c[rr * kSlots + s] - k0;
      if (c >= 0 && c < kWin) atomicOr(bits + (c >> 5), 1u << (c & 31));
    }
    __syncthreads();
    if (warp == 0) {  // the window's picked components, ascending
      unsigned w = bits[lane];
      const int cnt = __popc(w);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int pos = incl - cnt;
      while (w) {
        list[pos++] = k0 + lane * 32 + __ffs(w) - 1;
        w &= w - 1;
      }
      if (lane == 31) n_list = incl;
    }
    __syncthreads();

    // each warp takes components in turn: gathers the picks of component
    // j, then applies W_j to them up to kRg at a time, in a register tile
    // of 8, 4, 2 or 1 picks
    for (int e = warp; e < n_list; e += kWarps) {
      const int j = list[e];
      int m = 0;
      for (int base = 0; base < picks; base += 32) {
        const int i = base + lane;
        int idx = -1;
        if (i < picks) {
          const int rr = i / k_sel, s = i - rr * k_sel;
          if (pick_c[rr * kSlots + s] == j) idx = rr * kSlots + s;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, idx >= 0);
        if (idx >= 0) wlist[m + __popc(bal & ((1u << lane) - 1u))] = idx;
        m += __popc(bal);
      }
      __syncwarp();
      if (vec)
        apply_picks<CV, true>(ap, j, wlist, m);
      else
        apply_picks<CV, false>(ap, j, wlist, m);
      __syncwarp();  // wlist is rewritten for the next component
    }
  }

  if constexpr (!STATS) {
    if (k_sel > 1) {  // K4: each row's candidates combined in slot order
      __syncthreads();
      int off_w[CW];
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) {
        const int c = lane + 32 * jj;
        off_w[jj] = c < two_d ? c : 0;
      }
      for (int rr = warp; rr < S::kTr; rr += kWarps) {
        const int row = row0 + rr;
        if (row >= n) break;  // warp-uniform
        const float l0 = pick_l[rr * kSlots];
        const float* zr = scratch + (size_t)row * k_sel * two_d;
        float acc_o[CW], den = 0.f;
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) acc_o[jj] = 0.f;
        for (int s = 0; s < k_sel; ++s) {
          const float w = s == 0 ? 1.f : expf(pick_l[rr * kSlots + s] - l0);
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            acc_o[jj] = fmaf(w, zr[(size_t)s * two_d + off_w[jj]], acc_o[jj]);
          den += w;
        }
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) {
          const int c = lane + 32 * jj;
          if (c < two_d) out[(size_t)row * two_d + c] = acc_o[jj] / den;
        }
      }
    }
  }
}

// shared memory of a block: the r tile, then the larger of the ring with
// the row groups' partial sums and the epilogue's picks and lists
template <int TX>
size_t smem_bytes(int two_m) {
  using S = Shape<TX>;
  const size_t qbuf = S::kWc > 1 ? 2 * S::kWc * S::kTr : 0;
  const size_t stream = kStages * kStageF + qbuf;
  const size_t epi = 3 * S::kTr * kSlots + kWin / 32 + kWin;
  return sizeof(float) *
         ((size_t)two_m * S::kRs + (stream > epi ? stream : epi));
}

template <int TX, int CW, bool STATS>
int launch(const float* r2, const float* pw, const float* mu, const float* b,
           const float* logw, float* out, float* l_out, float* scratch,
           int n, int k_comp, int two_m, int two_d, int k_sel,
           cudaStream_t stream) {
  using S = Shape<TX>;
  const int s_cols = two_m + two_d;
  const size_t smem = smem_bytes<TX>(two_m);
  const int vec = (two_m % 4 == 0) && (two_d % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(pw) % 16 == 0);
  auto kern = grouped_topk_kernel<TX, CW, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + S::kTr - 1) / S::kTr;
  kern<<<grid, kThreads, smem, stream>>>(r2, pw, mu, b, logw, out, l_out,
                                         scratch, n, k_comp, two_m, two_d,
                                         k_sel, vec);
  return (int)cudaGetLastError();
}

template <bool STATS>
int dispatch(const float* r2, const float* pw, const float* mu,
             const float* b, const float* logw, float* out, float* l_out,
             float* scratch, int n, int k_comp, int two_m, int two_d,
             int k_sel, void* stream) {
  if (n < 0 || k_comp < 1 || two_m < 1 || two_m > 256 || two_d < 1 ||
      two_d > 256 || k_sel < 1 || k_sel > kSlots ||
      (!STATS && (k_sel > k_comp || (k_sel > 1 && scratch == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tx = two_m <= 64 ? 8 : two_m <= 128 ? 16 : 32;
  const int cw = cols_per_lane(two_d);
#define QCE_LAUNCH(TX_, CW_)                                                \
  if (tx == TX_ && cw == CW_)                                               \
    return launch<TX_, CW_, STATS>(r2, pw, mu, b, logw, out, l_out, scratch, \
                                   n, k_comp, two_m, two_d, k_sel, s);
  QCE_LAUNCH(8, 2)
  QCE_LAUNCH(8, 4)
  QCE_LAUNCH(8, 8)
  QCE_LAUNCH(16, 2)
  QCE_LAUNCH(16, 4)
  QCE_LAUNCH(16, 8)
  QCE_LAUNCH(32, 2)
  QCE_LAUNCH(32, 4)
  QCE_LAUNCH(32, 8)
#undef QCE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points, loaded with ctypes. Each returns a cudaError_t (0 on
// success).

// K4: r2 (n, two_m) -> out (n, two_d); 1 <= k_sel <= min(8, k_comp);
// scratch (n, k_sel, two_d) fp32 for k_sel > 1 (unread at k_sel = 1).
extern "C" int grouped_topk_launch(const float* r2, const float* pw,
                                   const float* mu, const float* b,
                                   const float* logw, float* out,
                                   float* scratch, int n, int k_comp,
                                   int two_m, int two_d, int k_sel,
                                   void* stream) {
  return dispatch<false>(r2, pw, mu, b, logw, out, nullptr, scratch, n,
                         k_comp, two_m, two_d, k_sel, stream);
}

// K5: r2 (n, two_m) -> the candidates l (n, k_sel), z (n, k_sel, two_d);
// 1 <= k_sel <= 8, any k_comp.
extern "C" int grouped_topk_stats_launch(const float* r2, const float* pw,
                                         const float* mu, const float* b,
                                         const float* logw, float* l,
                                         float* z, int n, int k_comp,
                                         int two_m, int two_d, int k_sel,
                                         void* stream) {
  return dispatch<true>(r2, pw, mu, b, logw, z, l, nullptr, n, k_comp, two_m,
                        two_d, k_sel, stream);
}
