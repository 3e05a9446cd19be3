// The device code the factorised circulant kernels share: the circulant K6
// / K7 (circ_fact_estimate.cu) and the multi-pilot K10
// (mp_circ_fact_estimate.cu). The transform of a row D = d1 d2 as Stockham
// stages in shared memory (`stage`, `transform`), the rows in and out
// (`load_rows`, `store_rows`; the stats forms' accumulator in natural bin
// order, `store_natural`), the three-plane bf16 split and the mma.sync
// six-product step (`split3`, `six`), the compensated sum (`kahan`) and
// the softmax of offset logits with the coherent pool (`softmax_rows`, and
// its STATS form).
//
// A row in shared memory is d1 lines of ld2 = d2 | 1 slots (an odd stride,
// so that the 16 lines a half-warp reads at one offset fall on 16 banks),
// dp = d1 ld2 slots, rows `rs` float2 apart (K6 / K7: rs = dp). The forward
// transform is d2 DFTs of d1 points over a (stride ld2), the cross twiddle
// W_D^{p b} with the unitary 1 / sqrt(D) folded in, and d1 DFTs of d2
// points over b: bin p + d1 q lands at position p d2 + q
// (`circ_kernels.circ_fact_perm`), in slot p ld2 + q. The inverse runs the
// mirrored steps from that order into natural order. Each level's size is
// split into radices 4 and 2, one butterfly a thread, and odd primes, each
// a dense r-point DFT one output a thread; consecutive threads take
// consecutive batches. The twiddles of a level come from one table of W_n,
// the cross twiddle from a table over the slots; both are built in float64
// on the host and rounded once (`circ_kernels.circ_fact_operands`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace circ_fact {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kM = 16;        // rows of an mma tile
constexpr int kMaxD = 672;
constexpr int kMaxN = 64;     // largest factor
constexpr int kMaxK = 128;
constexpr int kMaxT = 64;
constexpr int kMaxStages = 6;  // radices of one level of at most 64 points
constexpr int kSmemMax = 232448;

struct Level {
  int n, istride, bstride, nbatch;  // points, stride of a point, of a batch
  int nst, rad[kMaxStages];
};

// The factorised transform of a row: its levels (the forward's: over a,
// d1 points; over b, d2 points) and its slots in shared memory.
struct Transform {
  int d1, d2, ld2, dp, rs;  // rs: float2 from one row to the next
  Level lv[2];
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj_if(float2 a, bool c) {
  return c ? make_float2(a.x, -a.y) : a;
}

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// v0, v1 -> their three bf16 planes as packed pairs (v0 in the low half)
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

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// one k16 step's six products of three-plane splits into a fresh
// accumulator, smallest first (A's plane first)
__device__ __forceinline__ void six(float (&c)[4], const unsigned (&a)[3][4],
                                    const uint2 (&b)[3]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma(c, a[0], b[2]);
  mma(c, a[1], b[1]);
  mma(c, a[2], b[0]);
  mma(c, a[1], b[0]);
  mma(c, a[0], b[1]);
  mma(c, a[0], b[0]);
}

__device__ __forceinline__ void kahan(float& sum, float& lost, float part) {
  const float y = part - lost;
  const float next = sum + y;
  lost = (next - sum) - y;
  sum = next;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One Stockham stage of radix r over a level of every row: in -> out, rows
// rs float2 apart. Point i of batch bt sits at bt * bstride + i * istride.
// A butterfly j of the stage (ns the product of the level's earlier
// radices, k = j mod ns) reads points j + m n / r, multiplies point m by
// W_{ns r}^{m k} (and by the cross twiddle where given: the level's first
// stage), takes the r-point DFT and writes output m' to point (j - k) r + k
// + m' ns. Radix 2 and 4: one butterfly a thread; other radices: one output
// a thread, the DFT as a dense sum over at most ROWS rows a thread. A
// thread's twiddles serve every row it takes.
template <bool INV, int ROWS>
__device__ void stage(const float2* __restrict__ in, float2* __restrict__ out,
                      int rows, int rs, const Level& lv, int r, int ns,
                      const float2* __restrict__ w,
                      const float2* __restrict__ cross) {
  const int n = lv.n, ms = n / r, tw_step = n / (ns * r);
  const int items = lv.nbatch * (r == 2 || r == 4 ? ms : n);
  const int groups = items >= kThreads ? 1 : kThreads / items;
  for (int it = threadIdx.x; it < items * groups; it += kThreads) {
    const int item = it % items, grp = it / items;
    if (r == 2 || r == 4) {
      const int j = item / lv.nbatch, bt = item - j * lv.nbatch;
      const int k = j % ns, base = bt * lv.bstride;
      const int in0 = base + j * lv.istride, ist = ms * lv.istride;
      const int out0 = base + ((j - k) * r + k) * lv.istride;
      const int ost = ns * lv.istride;
      const bool twid = ns > 1 || cross != nullptr;
      float2 c[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= r) break;
        c[m] = conj_if(w[m * k * tw_step], INV);  // m k tw_step < n
        if (cross != nullptr) c[m] = cmul(c[m], conj_if(cross[in0 + m * ist], INV));
      }
#pragma unroll 4
      for (int row = grp; row < rows; row += groups) {
        const float2* src = in + row * rs;
        float2* dst = out + row * rs;
        if (r == 2) {
          float2 v0 = src[in0], v1 = src[in0 + ist];
          if (twid) {
            v0 = cmul(v0, c[0]);
            v1 = cmul(v1, c[1]);
          }
          dst[out0] = make_float2(v0.x + v1.x, v0.y + v1.y);
          dst[out0 + ost] = make_float2(v0.x - v1.x, v0.y - v1.y);
        } else {
          float2 v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            v[m] = src[in0 + m * ist];
            if (twid) v[m] = cmul(v[m], c[m]);
          }
          const float2 t0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
          const float2 t1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
          const float2 t2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
          const float2 t3 = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
          // -i t3 forward, +i t3 inverse
          const float2 rt = INV ? make_float2(-t3.y, t3.x)
                                : make_float2(t3.y, -t3.x);
          dst[out0] = make_float2(t0.x + t2.x, t0.y + t2.y);
          dst[out0 + ost] = make_float2(t1.x + rt.x, t1.y + rt.y);
          dst[out0 + 2 * ost] = make_float2(t0.x - t2.x, t0.y - t2.y);
          dst[out0 + 3 * ost] = make_float2(t1.x - rt.x, t1.y - rt.y);
        }
      }
    } else {
      const int o = item / lv.nbatch, bt = item - o * lv.nbatch;
      // o = (j / ns) ns r + k + m' ns; the exponent of input m is
      // m (k + m' ns) n / (ns r)
      const int len = ns * r, rem = o % len, k = rem % ns;
      const int j = (o / len) * ns + k, base = bt * lv.bstride;
      const int in0 = base + j * lv.istride, ist = ms * lv.istride;
      const int inc = rem * tw_step;  // < ns r n / (ns r) = n
      float2 acc[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = make_float2(0.f, 0.f);
      int e = 0;
      for (int m = 0; m < r; ++m) {
        float2 wm = conj_if(w[e], INV);
        if (cross != nullptr)
          wm = cmul(wm, conj_if(cross[in0 + m * ist], INV));
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int row = grp + i * groups;
          if (row < rows) {
            const float2 v = in[row * rs + in0 + m * ist];
            acc[i].x += v.x * wm.x - v.y * wm.y;
            acc[i].y += v.x * wm.y + v.y * wm.x;
          }
        }
        e += inc;
        if (e >= n) e -= n;
      }
      const int po = base + o * lv.istride;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = grp + i * groups;
        if (row < rows) out[row * rs + po] = acc[i];
      }
    }
  }
}

// The forward (INV = false: levels over a, then over b, the cross twiddle
// before the second) or inverse (over q, then over p) transform of `rows`
// (at most ROWS) rows in *cur; the result ends in *cur (the buffers swap
// each stage). tw: W_d1 (d1), W_d2 (d2), the cross twiddle (dp slots).
template <bool INV, int ROWS>
__device__ void transform(float2*& cur, float2*& oth, int rows,
                          const Transform& tf, const float2* tw) {
  const float2* tables[2] = {tw, tw + tf.d1};
  const float2* cross = tw + tf.d1 + tf.d2;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int li = INV ? 1 - l : l;
    const Level& lv = tf.lv[li];
    int ns = 1;
    for (int s = 0; s < lv.nst; ++s) {
      const int r = lv.rad[s];
      stage<INV, ROWS>(cur, oth, rows, tf.rs, lv, r, ns, tables[li],
                       l == 1 && s == 0 ? cross : nullptr);
      ns *= r;
      float2* t = cur;
      cur = oth;
      oth = t;
      __syncthreads();
    }
  }
}

// `rows` rows of D = d1 d2 complex values into buf by cp.async (not waited
// for): row r from src + r * stride, the d2 values of its line a to the
// line's ld2 slots
__device__ __forceinline__ void load_rows(float2* buf, const float2* src,
                                          long long stride, int rows,
                                          const Transform& tf) {
  const int lines = kThreads / tf.d2, b = threadIdx.x % tf.d2;
  if (threadIdx.x < lines * tf.d2)
    for (int l = threadIdx.x / tf.d2; l < rows * tf.d1; l += lines) {
      const int r = l / tf.d1, a = l - r * tf.d1;
      cp_async8(buf + r * tf.rs + a * tf.ld2 + b,
                src + r * stride + a * tf.d2 + b);
    }
}

// the rows of buf out to dst (row r at dst + r * stride), line by line
__device__ __forceinline__ void store_rows(const float2* buf, float2* dst,
                                           long long stride, int rows,
                                           const Transform& tf) {
  const int lines = kThreads / tf.d2, b = threadIdx.x % tf.d2;
  if (threadIdx.x < lines * tf.d2)
    for (int l = threadIdx.x / tf.d2; l < rows * tf.d1; l += lines) {
      const int r = l / tf.d1, a = l - r * tf.d1;
      dst[r * stride + a * tf.d2 + b] = buf[r * tf.rs + a * tf.ld2 + b];
    }
}

// The rows of buf (positions in the forward transform's order) out to dst
// in natural bin order (row r at dst + r * stride): bin j sits at position
// p d2 + q with j = p + d1 q (the DFT, `circ_kernels.circ_fact_perm`) or j
// = p d2 + q (the kron basis), slot p ld2 + q. Consecutive threads write
// consecutive bins; their slots lie ld2 (odd) apart, on distinct banks.
__device__ __forceinline__ void store_natural(const float2* buf, float2* dst,
                                              long long stride, int rows,
                                              const Transform& tf, bool kron) {
  const int d = tf.d1 * tf.d2;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const int p = kron ? j / tf.d2 : j % tf.d1;
    const int q = kron ? j - p * tf.d2 : j / tf.d1;
    const int slot = p * tf.ld2 + q;
    for (int r = 0; r < rows; ++r) dst[r * stride + j] = buf[r * tf.rs + slot];
  }
}

// zero what the products read past a transform's output: the pad slot of
// each line (ld2 > d2) and the slots [dp, tail) of each row; the bank's
// rows and columns there are zero
__device__ __forceinline__ void zero_pads(float2* buf, int rows, int tail,
                                          const Transform& tf) {
  if (tf.ld2 != tf.d2)
    for (int l = threadIdx.x; l < rows * tf.d1; l += kThreads) {
      const int r = l / tf.d1, a = l - r * tf.d1;
      buf[r * tf.rs + a * tf.ld2 + tf.d2] = make_float2(0.f, 0.f);
    }
  const int extra = tail - tf.dp;
  if (extra > 0)
    for (int l = threadIdx.x; l < rows * extra; l += kThreads) {
      const int r = l / extra;
      buf[r * tf.rs + tf.dp + (l - r * extra)] = make_float2(0.f, 0.f);
    }
}

// The softmax of `rows` rows of offset logits (kpad apart, k live) in
// place, a warp a block of t rows: the pool lg' + a (s - lg'), s the
// block's sum in float64 (a >= 1: s), then the normalised weights, or
// (STATS) the weights exp(l - max l) with m = fl(o + max l) and den out to
// m_out, den_out (a float a row), o the row's offset (offs) pooled alike in
// float64: the arithmetic of the dense wide form's `softmax_kernel`
// (wide_gemm.cuh). A row whose logits are all -inf weighs nothing. k <=
// 128.
template <bool STATS = false>
__device__ void softmax_rows(float* lg, int rows, int k, int kpad, int t,
                             float alpha, const float* offs = nullptr,
                             float* m_out = nullptr,
                             float* den_out = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = warp * t; r0 < rows; r0 += kWarps * t) {
    double s[4] = {0.0, 0.0, 0.0, 0.0}, so = 0.0;
    if (t > 1)
      for (int tt = 0; tt < t; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = lane + 32 * i;
          if (kk < k) s[i] += (double)lg[(r0 + tt) * kpad + kk];
        }
        if (STATS) so += (double)offs[r0 + tt];
      }
    for (int tt = 0; tt < t; ++tt) {
      float* lr = lg + (r0 + tt) * kpad;
      float v[4], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = lane + 32 * i;
        v[i] = -INFINITY;
        if (kk < k) {
          const float l = lr[kk];
          v[i] = t == 1 ? l
                 : alpha >= 1.f
                     ? (float)s[i]
                     : (float)((double)l + (double)alpha * (s[i] - (double)l));
          mx = fmaxf(mx, v[i]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx == -INFINITY) mx = 0.f;
      float den = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = v[i] == -INFINITY ? 0.f : expf(v[i] - mx);
        den += v[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        den += __shfl_xor_sync(0xffffffffu, den, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = lane + 32 * i;
        if (kk < k) lr[kk] = STATS ? v[i] : v[i] / den;
      }
      if (STATS && lane == 0) {
        double o = (double)offs[r0 + tt];
        if (t > 1) o = alpha >= 1.f ? so : o + (double)alpha * (so - o);
        m_out[r0 + tt] = (float)(o + (double)mx);
        den_out[r0 + tt] = den;
      }
    }
  }
}

// The logits of `rows` rows into lg (kpad apart): a warp a row, the
// compensated sum of the `ksplit` partial (sum, lost) pairs of each
// component (part: ksplit blocks of `prows` rows x kpad) with const, the
// row's offset (its largest logit among components [0, 64); kept in
// offs[row] where offs is given), lg' = (lg - off) - lost. Dead components
// keep the -1e30 floor of const.
__device__ void reduce_logits(const float2* part, float* lg, int rows,
                              int prows, int ksplit, int k, int kpad,
                              const float* __restrict__ cst,
                              float* offs = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < rows; row += kWarps) {
    float s[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = lane + 32 * i;
      s[i] = -INFINITY;
      l[i] = 0.f;
      if (kk < k) {
        s[i] = 0.f;
        for (int kp = 0; kp < ksplit; ++kp) {
          const float2 pr = part[(kp * prows + row) * kpad + kk];
          kahan(s[i], l[i], pr.x);
          kahan(s[i], l[i], -pr.y);
        }
        kahan(s[i], l[i], __ldg(cst + kk));
      }
    }
    float off = fmaxf(s[0], s[1]);  // components [0, 64)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      off = fmaxf(off, __shfl_xor_sync(0xffffffffu, off, o));
    off = off > -1e29f ? off : 0.f;
    if (offs != nullptr && lane == 0) offs[row] = off;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = lane + 32 * i;
      if (kk < k) lg[row * kpad + kk] = (s[i] - off) - l[i];
    }
  }
}

// the radices of an n-point level: 4s, a 2, then odd primes
inline int radices(int n, int (&r)[kMaxStages]) {
  int c = 0;
  while (n % 4 == 0 && c < kMaxStages) r[c++] = 4, n /= 4;
  if (n % 2 == 0 && c < kMaxStages) r[c++] = 2, n /= 2;
  for (int f = 3; f * f <= n; f += 2)
    while (n % f == 0 && c < kMaxStages) r[c++] = f, n /= f;
  if (n > 1) {
    if (c == kMaxStages) return -1;
    r[c++] = n;
  }
  return c;
}

// Slots of a row in shared memory: d1 lines of d2 | 1.
inline int padded(int d1, int d2) { return d1 * (d2 | 1); }

// The levels of D = d1 d2 (level 0: d1 points over a, stride ld2, batches
// b; level 1: d2 points over b, batches the lines a) with rows rs float2
// apart; false where a level has more radices than kMaxStages.
inline bool make_transform(int d1, int d2, int rs, Transform& tf) {
  tf.d1 = d1;
  tf.d2 = d2;
  tf.ld2 = d2 | 1;
  tf.dp = padded(d1, d2);
  tf.rs = rs;
  tf.lv[0] = Level{d1, tf.ld2, 1, d2, 0, {}};
  tf.lv[1] = Level{d2, 1, tf.ld2, d1, 0, {}};
  for (int l = 0; l < 2; ++l) {
    tf.lv[l].nst = radices(tf.lv[l].n, tf.lv[l].rad);
    if (tf.lv[l].nst < 1) return false;
  }
  return true;
}

}  // namespace circ_fact
