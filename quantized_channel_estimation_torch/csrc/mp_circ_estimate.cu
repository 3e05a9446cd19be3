// Single-pass multi-pilot circulant (FFT-domain) GMM-Bussgang estimator on
// Hopper's tensor cores: kernel K10, flat and coherent, and at one pilot the
// circulant kernels K6 (flat), K7 (coherent), K8 (stats) and K9 (coherent
// stats); one template with COH and STATS flags.
//
// Replaces the TPU kernel `_mp_circ_kernel` (:1505) launched by
// `estimate_mp_circ_packed` (:1578), and the kernels `_circ_kernel` (:1309),
// `_circ_kernel_coh` (:1647), `_circ_kernel_stats` (:1749) and
// `_circ_kernel_coh_stats` (:1822) launched by `estimate_circ_packed`
// (:1346), `estimate_circ_packed_coh` (:1698), `estimate_circ_packed_stats`
// (:1789) and `estimate_circ_packed_coh_stats` (:1868), of
// quantized_channel_estimation_tpu/estimators/pallas_kernels.py. The
// observation of a row is P pilot segments of D complex values (the
// reference's kron(x, I) layout), a complex64 tensor's interleaved [re, im]
// pairs: x is (N, 2PD). Per row n and component k, with u_p the transform
// of segment p:
//
//   u_p    = x_p @ bfwd                    forward (block-)DFT, (2D, 2D)
//   z      = [u_1 .. u_P | |u_1|^2 .. |u_P|^2 | v_12 v_13 .. v_(P-1)P]
//            v_pq = conj(u_p) u_q, interleaved, p < q
//   lg_nk  = z @ lcoef + const             F = D (3P + P (P-1)) features
//   w_nk   = softmax_k(lg'_nk)
//   h      = w @ comb_0 + sum_p (w @ comb_p) * u_p     per bin, complex
//   out    = h @ binv                      inverse (block-)DFT, (2D, 2D)
//
// lg' = lg for the flat form. For the coherent form the rows are block-major
// (the T rows of a coherence block consecutive), s_k = sum of lg_k over the
// row's block and lg' = lg + alpha (s - lg) (alpha >= 1: s); the caller
// divides the mixture log-weight inside const by (1 - alpha + alpha T) so
// that it enters once per block. At P = 1 the features are [u | |u|^2] and
// the combine's two slabs are the bias and the filter: K6 and K7 (their
// const keeps the circulant layout's convention, without the row constant
// -D log pi). The STATS form (K8, K9) stops before the normalisation and the
// inverse: it writes m = max_k lg', den = sum_k exp(lg' - m) and the
// un-normalised h (the DFT-domain accumulator), so that the states of
// disjoint component shards merge exactly; the inverse runs once after the
// merge.
//
// The products. All four run on the tensor cores as K1's and K11's do:
// each fp32 operand split into three bf16 planes (hi, lo, lo2, each rounded
// to nearest even, hi + lo + lo2 = x exactly for normal x), six exact bf16
// products accumulated in fp32, smallest first (hi.lo2, lo.lo, lo2.hi,
// lo.hi, hi.lo, hi.hi; the rows' plane first). The bank's planes are split
// once on the host (`mp_circ_kernels.mp_circ_tc_operands`,
// `circ_kernels.circ_tc_operands`), the rows' in the kernel. Every product
// is cut into units, one 64-column piece of the bank operand over one
// 64-deep contraction chunk: each unit's six products go into a fresh fp32
// accumulator, and the units of one output piece are added in fp32; the
// logit's units, a fresh accumulator for each k16 step, in a compensated
// sum. Everything else is fp32: the features, the pooling, the softmax, the
// complex combine. TF32 stays excluded: the expanded quadratic sums P^2
// terms that cancel at high SNR and a 10-bit mantissa moves the posterior.
//
// Bound on an H100 (131072 rows, D = K = 64): six times 2 N (P 2D 2D + F K
// + (P+1) K 2D + 2D 2D) bf16 tensor-core operations, 6 x 2.79e10 at P = 2
// (0.17 ms at 989 TFLOP/s) and 6 x 1.61e10 at P = 1 (0.098 ms; the STATS
// form without the inverse 6 x 1.18e10, 0.072 ms), plus the fp32 epilogue
// (~1e9 operations at P = 2, 0.02 ms at 67 TFLOP/s; ~1.3e8 at P = 1),
// against N (2PD + 2D) 4 bytes of compulsory traffic (0.20 GB, 0.06 ms at
// 3.35 TB/s at P = 2; 0.13 GB at P = 1): bound by operations, ~0.19 ms at
// P = 2 and ~0.10 ms at P = 1, against 0.42 / 0.24 ms for the products as
// fp32 FMAs. The bank streams from L2 once a block: P NPD^2 + (P NPD + P
// NCD + P (P-1)/2 NPD) KP + NPD (P+1) KP + NPD^2 units of 24 KB (26 units,
// 624 KB at P = 2; 15 at P = 1 and 11 for STATS, which streams no inverse).
//
// Design:
//   - a block is WGS consumer warpgroups of 64 rows (the coherent form:
//     64 / T whole blocks) and one producer warpgroup; WGS = 2 at D <= 64,
//     K <= 64 (`setmaxnreg`: 232 registers a consumer thread, 40 a producer
//     thread) where 128-row blocks cover the SMs and two warpgroups' u fit
//     beside a ring of two units, else 1; where one warpgroup's u does not
//     fit at 64 rows (D = 128 at P >= 3, or a large P) a warpgroup keeps 32
//     live rows (HALF: its warps 2 and 3 multiply zeros);
//   - every A operand is in registers (RS wgmma), never in shared memory:
//     an m64n64 fp32 accumulator is the m64k16 A layout of the next product
//     (a thread holds the same (row, column pair)s in both), so a thread
//     only ever reads its own values: x straight from global memory, u_p
//     from the forward's accumulator, the features from its own u_p (the
//     (re, im) of a bin are thread-local, so |u_p|^2, conj(u_p) u_q and the
//     complex combine are too), w from the logit's accumulator, h from the
//     combine's. The |u_p|^2 group is D wide, half its u_p: the host orders
//     lcoef's rows of that group so that A slot i of a thread is its i-th
//     own bin (`mp_circ_tc_operands`), with no shuffle in the kernel;
//   - u_p must survive, exact, to the combine: a thread keeps its own u in
//     shared memory, in fp32, as float4 slots [(p, piece, t)][thread]
//     (conflict-free, no barrier: no other thread reads them), only the
//     columns below 2D (TL of the 8 column groups of a piece); h of piece j
//     replaces the first pilot's piece j once that piece's combine is done;
//   - the bank streams as units in consumption order (the host lays out the
//     whole sequence of a tile, the forward operand once a pilot): one
//     producer thread copies unit after unit with cp.async.bulk into a ring
//     of 2-8 stages under full and empty mbarriers; a unit is one commit
//     group of 24 wgmma m64n64k16 (six products x four k16 steps; a logit
//     unit four groups of six, one a step), each waited for before the
//     next (no wgmma group is in flight across a loop's back
//     edge, and no barrier spin sits between a wgmma and its wait: ptxas
//     serialises the kernel where one does, C7514 / C7517);
//   - the logit: one fresh accumulator for each k16 step (16 features) of
//     a feature group (u_p; |u_p|^2; each pair), added with const in a
//     compensated (Kahan) sum, whose error is folded in after the row's
//     offset (its largest logit) is taken off: lg' = (lg - off) - lost,
//     small where it decides the softmax, the offset cancelling in the
//     softmax and, as a block sum, in the pool. The groups
//     cancel (the diagonal terms of u^H Prec u against the pair terms): a
//     running fp32 sum over all F features read 4x the plain version's
//     error at P = 4 (the fp32 loop that preceded this kernel). The tensor
//     core truncates each step's sum into its accumulator, so an
//     accumulator over a whole 64-deep chunk left the logit no better than
//     fp32, and a logit of ~1600 rounded to fp32 loses the low bits that
//     decide a near-tie of two components' pooled logits (the card test
//     `test_mp_circ_estimate_keeps_fp32_accuracy` has one at D = K = 128,
//     P = 4, T = 4); 16-deep accumulators and the folded error keep them;
//   - the softmax over K in the accumulator layout: a row's K logits lie on
//     the four threads of a quad (max and sum by quad shuffles); K is padded
//     to 64 or 128 columns with -inf logits (dead components keep the finite
//     -1e30 floor of const); the coherent pool writes the warpgroup's logits
//     to shared memory, sums each (block, component) in a compensated sum
//     over T, and reads the block sums back (any T up to the live rows);
//   - STATS: the state is the plain version's, m = max_k lg' with the
//     offset back in and den = sum_k exp(lg' - m): the row's offset o (the
//     coherent form: its pooled value off + alpha (sum_T off - off), the
//     block sum of the offsets in float64 beside the pool's logits) is
//     added back once, m = fl(o + max l), and the weights are exp(l - max
//     l), the largest exactly 1, as in the plain version. Taking them
//     against the rounded m instead (exp(l - (m - o))) made the state
//     exact under a merge but moved den and acc by the rounding of m, up to
//     2.4e-4 of them at the pooled logits of T = 64 (37x the plain
//     version's error against float64); as it is, the rounding of m enters
//     the merge weights exp(m_i - m*) once, as the plain version's own
//     rounded logits do. h goes to out as the combine leaves it, and the
//     producer streams no inverse;
//   - the ragged last tile is masked in the kernel (any N, no padding copy).
// Any N, P >= 1, 1 <= D <= 128, 1 <= K <= 128, T up to the live rows of a
// warpgroup, as far as u and a two-unit ring fit a block's shared memory
// (`mp_circ_kernels.mp_circ_tile_rows` mirrors `mp_plan` below); STATS
// where a warpgroup keeps 64 live rows (every shape at P = 1).
#include "grouped_tc_stream.cuh"

namespace {

using namespace qce_tc;

constexpr unsigned kPlane = 64 * 128;   // one bf16 plane of a unit
constexpr unsigned kUnit = 3 * kPlane;  // a unit: hi, lo, lo2

// One instantiation: NPD 64-column pieces of 2D (also the chunks of the
// forward and inverse contractions), KP 64-column pieces of K (the chunks
// of the combine's contraction), WGS consumer warpgroups, 32 live rows a
// warpgroup (HALF) or 64, the coherent form and the stats form.
template <int NPD_, int KP_, int WGS_, bool HALF_, bool COH_, bool STATS_>
struct MpCfg {
  static constexpr int NPD = NPD_, KP = KP_, WGS = WGS_;
  static constexpr bool HALF = HALF_, COH = COH_, STATS = STATS_;
  static constexpr int NCD = (NPD + 1) / 2;  // chunks of a |u_p|^2 group
  static constexpr int kRows = HALF ? 32 : 64;
  static constexpr int kLive = HALF ? 64 : 128;  // threads with live rows
  static constexpr unsigned kSlot = kLive * 16;  // bytes of one u slot
  // floats a pool row: the logits, then (STATS) the row's offset, whose
  // block sum replaces the block's first two as a double
  static constexpr int kPoolStride = 64 * KP + 8;
  // a warpgroup's pool rows (COH) or its stash of the first piece's
  // logits while the second's are summed (two pieces of K), in bytes
  static constexpr unsigned kPool =
      COH ? kRows * kPoolStride * 4 : KP > 1 ? kLive * 128 : 0;
};

__device__ __forceinline__ void st_shared_f4(unsigned addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_shared_f2(unsigned addr, float a,
                                             float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

__device__ __forceinline__ void st_shared_f64(unsigned addr, double v) {
  asm volatile("st.shared.f64 [%0], %1;\n" ::"r"(addr), "d"(v) : "memory");
}

__device__ __forceinline__ double ld_shared_f64(unsigned addr) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr) : "memory");
  return v;
}

// d = the six products of A (registers) and the unit at db over its k16
// steps KS0 .. KS1 - 1: wgmma I is step KS0 + I % N of product I / N
template <int KS0 = 0, int KS1 = 4, int I = 0>
__device__ __forceinline__ void rs_six(float (&d)[32],
                                       const unsigned (&a)[3][4][4],
                                       uint64_t db) {
  constexpr int N = KS1 - KS0;
  if constexpr (I < 6 * N) {
    constexpr int P = I / N, ks = KS0 + I % N;
    constexpr int ob = (prod_b(6, P) * (int)kPlane + ks * 32) >> 4;
    wgmma_64x64_rs(d, a[prod_a(6, P)][ks], db + ob, I > 0);
    rs_six<KS0, KS1, I + 1>(d, a, db);
  }
}

// The ring: unit stage s at b + s kUnit, its barriers at full / empty + 8 s;
// the consumers' cursor (s, ph).
struct Ring {
  unsigned b, full, empty;
  int stages, s, ph;
};

// wait for the next unit; its stage in slot, its B descriptor returned
__device__ __forceinline__ uint64_t take_unit(Ring& ring, int& slot) {
  slot = ring.s;
  mbar_wait(ring.full + 8 * slot, ring.ph);
  if (++ring.s == ring.stages) {
    ring.s = 0;
    ring.ph ^= 1;
  }
  return sw128_desc(ring.b + slot * kUnit);
}

// acc = the six products over steps KS0 .. KS1 - 1 of A and the unit at db,
// waited for
template <int KS0 = 0, int KS1 = 4>
__device__ __forceinline__ void six_products(float (&acc)[32],
                                             const unsigned (&a)[3][4][4],
                                             uint64_t db) {
  wgmma_fence();
  fence_operand(acc);
  rs_six<KS0, KS1>(acc, a, db);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
}

// acc = the next unit's six products with A; the unit goes back to the
// ring once they are done (it is read by wgmma only: no proxy fence).
__device__ __forceinline__ void unit_product(float (&acc)[32],
                                             const unsigned (&a)[3][4][4],
                                             Ring& ring) {
  int slot;
  six_products(acc, a, take_unit(ring, slot));
  warp_arrive(ring.empty + 8 * slot);
}

// This thread's place: its u slots (slot (p, j, t) at u0 + ((p NPD + j) tl
// + t) kSlot), whether it holds any (HALF: warps 0 and 1), and tl, the
// column groups of a piece below 2D.
struct Own {
  unsigned u0;
  int tl;
  bool live;
};

// The thread's u values of pilot p, piece j, in the accumulator layout:
// v[4 t + 2 r + {0, 1}] = (re, im) of row lane / 4 + 8 r, bin 32 j + 4 t +
// lane % 4. Columns past 2D are zero.
template <class C>
__device__ __forceinline__ void load_u(float (&v)[32], const Own& own, int p,
                                       int j) {
  const unsigned at = own.u0 + (p * C::NPD + j) * own.tl * C::kSlot;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (own.live && t < own.tl) f = ld_shared_f4(at + t * C::kSlot);
    v[4 * t] = f.x;
    v[4 * t + 1] = f.y;
    v[4 * t + 2] = f.z;
    v[4 * t + 3] = f.w;
  }
}

// u's slots of pilot p, piece j = v (add: += v)
template <class C>
__device__ __forceinline__ void store_u(const Own& own, int p, int j,
                                        const float (&v)[32], bool add) {
  if (!own.live) return;
  const unsigned at = own.u0 + (p * C::NPD + j) * own.tl * C::kSlot;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t < own.tl) {
      float4 f = make_float4(v[4 * t], v[4 * t + 1], v[4 * t + 2],
                             v[4 * t + 3]);
      if (add) {
        const float4 o = ld_shared_f4(at + t * C::kSlot);
        f = make_float4(o.x + f.x, o.y + f.y, o.z + f.z, o.w + f.w);
      }
      st_shared_f4(at + t * C::kSlot, f);
    }
  }
}

// The forward's A: columns [64 c, 64 c + 64) of pilot p's segment of the
// thread's rows xr[r] (null where masked), as the fragments of to_a_regs
// (register (s, e) at v[4 s + e]); columns past 2D zero.
__device__ __forceinline__ void load_x(float2 (&v)[16],
                                       const float* const (&xr)[2], int off,
                                       int c, int two_d) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 64 * c + 16 * s + 8 * (e >> 1) + 2 * q;
      const float* row = xr[e & 1];
      v[4 * s + e] = row != nullptr && col < two_d
                         ? __ldg(reinterpret_cast<const float2*>(row + off +
                                                                 col))
                         : make_float2(0.f, 0.f);
    }
}

__device__ __forceinline__ void split_x(unsigned (&a)[3][4][4],
                                        const float2 (&v)[16]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned w[3];
      split3(v[4 * s + e].x, v[4 * s + e].y, w);
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q][s][e] = w[q];
    }
}

__device__ __forceinline__ void kahan_add(float (&sum)[32], float (&lost)[32],
                                          const float (&part)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) kahan(sum[i], lost[i], part[i]);
}

// The next unit of the logit (a 64-deep chunk of a feature group) with A:
// each of its four k16 steps' six products into a fresh accumulator, added
// to (lg, lost) in the compensated sum. An accumulator's truncated sums stay
// at the size of 16 features' terms, so the logit keeps its low bits where
// the terms of a group cancel.
template <int KS = 0>
__device__ __forceinline__ void logit_steps(float (&lg)[32],
                                            float (&lost)[32],
                                            const unsigned (&a)[3][4][4],
                                            uint64_t db) {
  if constexpr (KS < 4) {
    float acc[32];
    six_products<KS, KS + 1>(acc, a, db);
    kahan_add(lg, lost, acc);
    logit_steps<KS + 1>(lg, lost, a, db);
  }
}

__device__ __forceinline__ void logit_unit(float (&lg)[32], float (&lost)[32],
                                           const unsigned (&a)[3][4][4],
                                           Ring& ring) {
  int slot;
  logit_steps(lg, lost, a, take_unit(ring, slot));
  warp_arrive(ring.empty + 8 * slot);
}

// The logits of components [64 kp, 64 kp + 64) as lg - lost: the feature
// groups' chunks in the units' order (u_p pieces; |u_p|^2 chunks;
// conj(u_p) u_q pieces), each k16 step into a fresh accumulator, added in a
// compensated sum; then const in the same sum, and -inf past k_comp.
template <class C>
__device__ __forceinline__ void logit_piece(float (&lg)[32],
                                            float (&lost)[32], Ring& ring,
                                            const Own& own, int p_pil,
                                            int kp, const float* cst,
                                            int k_comp) {
#pragma unroll
  for (int i = 0; i < 32; ++i) lg[i] = lost[i] = 0.f;
  for (int p = 0; p < p_pil; ++p)
#pragma unroll 1
    for (int j = 0; j < C::NPD; ++j) {  // u_p
      unsigned a[3][4][4];
      {
        float v[32];
        load_u<C>(v, own, p, j);
        to_a_regs(a, v);
      }
      logit_unit(lg, lost, a, ring);
    }
  for (int p = 0; p < p_pil; ++p)
#pragma unroll 1
    for (int c = 0; c < C::NCD; ++c) {  // |u_p|^2
      // A slot i = 4 s + 2 (e >> 1) + h of a row: its bin of piece 2 c +
      // i / 8, column group i % 8 (lcoef's rows are laid out to match)
      unsigned a[3][4][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * c + half;
        float sq[8][2];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j < C::NPD && own.live && t < own.tl)
            f = ld_shared_f4(own.u0 + ((p * C::NPD + j) * own.tl + t) *
                                          C::kSlot);
          sq[t][0] = fmaf(f.x, f.x, f.y * f.y);
          sq[t][1] = fmaf(f.z, f.z, f.w * f.w);
        }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 4 * s2 + 2 * (e >> 1);
            unsigned w[3];
            split3(sq[t][e & 1], sq[t + 1][e & 1], w);
#pragma unroll
            for (int q = 0; q < 3; ++q) a[q][2 * half + s2][e] = w[q];
          }
      }
      logit_unit(lg, lost, a, ring);
    }
  for (int p = 0; p < p_pil; ++p)
    for (int q2 = p + 1; q2 < p_pil; ++q2)
#pragma unroll 1
      for (int j = 0; j < C::NPD; ++j) {  // conj(u_p) u_q
        unsigned a[3][4][4];
        {
          float v[32];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            float4 fa = make_float4(0.f, 0.f, 0.f, 0.f), fb = fa;
            if (own.live && t < own.tl) {
              fa = ld_shared_f4(own.u0 + ((p * C::NPD + j) * own.tl + t) *
                                             C::kSlot);
              fb = ld_shared_f4(own.u0 + ((q2 * C::NPD + j) * own.tl + t) *
                                             C::kSlot);
            }
            v[4 * t] = fmaf(fa.x, fb.x, fa.y * fb.y);
            v[4 * t + 1] = fmaf(fa.x, fb.y, -fa.y * fb.x);
            v[4 * t + 2] = fmaf(fa.z, fb.z, fa.w * fb.w);
            v[4 * t + 3] = fmaf(fa.z, fb.w, -fa.w * fb.z);
          }
          to_a_regs(a, v);
        }
        logit_unit(lg, lost, a, ring);
      }
  const int q = lane_id() & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 64 * kp + 8 * t + 2 * q + h;
      const float ck = k < k_comp ? __ldg(cst + k) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * t + 2 * r + h;
        kahan(lg[i], lost[i], ck);
        if (k >= k_comp) lg[i] = -INFINITY, lost[i] = 0.f;
      }
    }
}

// The row offset of the logits: per row (r = 0, 1), the largest logit of
// components [0, 64) (a row's values on the four threads of a quad), or 0
// where those are all dead
__device__ __forceinline__ void row_offset(float (&off)[2],
                                           const float (&lg)[32]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) m = fmaxf(m, lg[4 * t + 2 * r + h]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    off[r] = m > -1e29f ? m : 0.f;
  }
}

// lg = (lg - off) - lost: the compensated logit less its row's offset, so
// that the logits that decide the softmax (near the row's largest) keep
// their low bits in float32. An offset common to a row's components
// cancels in its softmax, and its block sum in a pooled one.
__device__ __forceinline__ void fold(float (&lg)[32], const float (&lost)[32],
                                     const float (&off)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) lg[i] = (lg[i] - off[(i >> 1) & 1]) - lost[i];
}

// The coherent form's pool: each row's logit of each live component
// replaced by lg + alpha (s - lg), s the compensated sum over the row's
// block of T consecutive rows (alpha >= 1: s). The warpgroup's logits go
// through its pool rows at pa; named barriers of the warpgroup only. STATS:
// the rows' offsets off pooled alike, in float64, into o.
template <class C>
__device__ __forceinline__ void pool_blocks(float (&lgk)[C::KP][32],
                                            unsigned pa, int wg_rows,
                                            int t_coh, int k_comp,
                                            float alpha, int wg,
                                            const float (&off)[2],
                                            double (&o)[2]) {
  const int g0 = row_in_wg(), q = lane_id() & 3;
  constexpr int S = C::kPoolStride, kOff = 64 * C::KP;
#pragma unroll
  for (int kp = 0; kp < C::KP; ++kp)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (g0 + 8 * r < C::kRows)
          st_shared_f2(pa + 4 * ((g0 + 8 * r) * S + 64 * kp + 8 * t + 2 * q),
                       lgk[kp][4 * t + 2 * r], lgk[kp][4 * t + 2 * r + 1]);
  if constexpr (C::STATS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q == 0 && g0 + 8 * r < C::kRows)
        st_shared_b32(pa + 4 * ((g0 + 8 * r) * S + kOff),
                      __float_as_uint(off[r]));
  }
  wg_sync(1 + wg);
  // each (block, component) by one thread, into the block's first row
  const int nb = wg_rows / t_coh;
  for (int i = threadIdx.x % kWg; i < nb * k_comp; i += kWg) {
    const int b = i / k_comp, k = i - b * k_comp;
    const unsigned col = pa + 4 * (b * t_coh * S + k);
    float sum = 0.f, lost = 0.f;
    for (int j = 0; j < t_coh; ++j)
      kahan(sum, lost, ld_shared_f32(col + 4 * j * S));
    st_shared_b32(col, __float_as_uint(sum));
  }
  // each block's offsets by one thread, in float64
  if constexpr (C::STATS) {
    for (int b = threadIdx.x % kWg; b < nb; b += kWg) {
      const unsigned col = pa + 4 * (b * t_coh * S + kOff);
      double sum = 0.0;
      for (int j = 0; j < t_coh; ++j)
        sum += (double)ld_shared_f32(col + 4 * j * S);
      st_shared_f64(col, sum);
    }
  }
  wg_sync(1 + wg);
  if constexpr (C::STATS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = g0 + 8 * r;
      o[r] = off[r];
      if (rr < wg_rows) {
        const double s =
            ld_shared_f64(pa + 4 * (rr / t_coh * t_coh * S + kOff));
        o[r] = alpha >= 1.f ? s : o[r] + (double)alpha * (s - o[r]);
      }
    }
  }
#pragma unroll
  for (int kp = 0; kp < C::KP; ++kp)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = g0 + 8 * r, k = 64 * kp + 8 * t + 2 * q + h;
          if (rr < wg_rows && k < k_comp) {
            const float sv =
                ld_shared_f32(pa + 4 * (rr / t_coh * t_coh * S + k));
            float& l = lgk[kp][4 * t + 2 * r + h];
            l = alpha >= 1.f ? sv : fmaf(alpha, sv - l, l);
          }
        }
}

// lgk -> the softmax weights over the components of each row (a row's
// values on the four threads of a quad); an all -inf row weighs nothing.
// STATS: the weights stay un-normalised, and (m, den) go to m_row, den_row
// with m = fl(o + max l) the row's maximum with its offset o back in.
template <class C>
__device__ __forceinline__ void softmax_rows(float (&lgk)[C::KP][32],
                                             const double (&o)[2],
                                             float (&m_row)[2],
                                             float (&den_row)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) m = fmaxf(m, lgk[kp][4 * t + 2 * r + h]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (m == -INFINITY) m = 0.f;
    if constexpr (C::STATS) m_row[r] = (float)(o[r] + (double)m);
    float den = 0.f;
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& l = lgk[kp][4 * t + 2 * r + h];
          l = l == -INFINITY ? 0.f : expf(l - m);
          den += l;
        }
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    if constexpr (C::STATS) {
      den_row[r] = den;
    } else {
#pragma unroll
      for (int kp = 0; kp < C::KP; ++kp)
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) lgk[kp][4 * t + 2 * r + h] /= den;
    }
  }
}

// The thread's values v of output piece j (columns [64 j, 64 j + 64) of
// its rows, the accumulator layout) to out (n, 2D), masked rows skipped;
// 2D is even: a thread's two columns are 8-byte aligned
__device__ __forceinline__ void store_rows(float* out, const int (&rows)[2],
                                           int two_d, int j,
                                           const float (&v)[32]) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (rows[r] >= 0) {
      float* orow = out + (size_t)rows[r] * two_d;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = 64 * j + 8 * t + 2 * q;
        if (col < two_d)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(v[4 * t + 2 * r], v[4 * t + 2 * r + 1]);
      }
    }
}

// The kernel. x (n, 2PD) fp32 interleaved, pilot-major; hi, lo, lo2: the
// bank's bf16 planes as the tile's sequence of `units` units
// (`mp_circ_tc_operands`: (units, 64, 64) each); cst (k_comp) the layout's
// constants; out (n, 2D): the estimate, or (STATS) the DFT-domain
// accumulator, with m_out, den_out (n).
template <class C>
__global__ void __launch_bounds__((C::WGS + 1) * kWg, 1)
    mp_circ_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ hi,
                      const bf16* __restrict__ lo,
                      const bf16* __restrict__ lo2,
                      const float* __restrict__ cst, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ den_out,
                      int n, int d, int p_pil, int k_comp, int units,
                      int stages, int tl, int t_coh, float alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int two_d = 2 * d;
  const unsigned u_bytes = (unsigned)(p_pil * C::NPD * tl) * C::kSlot;
  Ring ring;
  ring.b = base;
  ring.stages = stages;
  ring.s = ring.ph = 0;
  const unsigned u_all = base + stages * kUnit;
  const unsigned pool = u_all + C::WGS * u_bytes;
  ring.full = pool + C::WGS * C::kPool;
  ring.empty = ring.full + 8 * stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, C::WGS * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == C::WGS) {  // the producer warpgroup: one thread streams units
    if constexpr (C::WGS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == C::WGS * kWg) {
      int s = 0, ph = 0;
      for (int u = 0; u < units; ++u) {
        const unsigned full = ring.full + 8 * s;
        mbar_wait(ring.empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full, kUnit);
        const size_t off = (size_t)u * kPlane;
        const unsigned dst = ring.b + s * kUnit;
        bulk_copy(dst, reinterpret_cast<const char*>(hi) + off, kPlane, full);
        bulk_copy(dst + kPlane, reinterpret_cast<const char*>(lo) + off,
                  kPlane, full);
        bulk_copy(dst + 2 * kPlane, reinterpret_cast<const char*>(lo2) + off,
                  kPlane, full);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (C::WGS == 2) setmaxnreg_inc<232>();

  // the coherent form: whole T-row blocks a warpgroup
  const int wg_rows = C::COH ? C::kRows / t_coh * t_coh : C::kRows;
  const int row0 = blockIdx.x * (C::WGS * wg_rows) + wg * wg_rows;
  const int tid = threadIdx.x % kWg;
  const int g0 = row_in_wg();
  const Own own{u_all + wg * u_bytes + tid * 16u, tl, tid < C::kLive};
  const int two_pd = p_pil * two_d;
  int rows[2];
  const float* xr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = g0 + 8 * r;
    rows[r] = rr < wg_rows && row0 + rr < n ? row0 + rr : -1;
    xr[r] = rows[r] >= 0 ? x + (size_t)rows[r] * two_pd : nullptr;
  }

  // 1. u_p = x_p bfwd: unit (c, j) of pilot p adds chunk c's products to
  // piece j of u_p; the next chunk's x is loaded while these run
  {
    const int chunks = p_pil * C::NPD;
    float2 xv[16];
    load_x(xv, xr, 0, 0, two_d);
    for (int pc = 0; pc < chunks; ++pc) {
      const int p = pc / C::NPD, c = pc - p * C::NPD;
      unsigned a[3][4][4];
      split_x(a, xv);
      if (pc + 1 < chunks) {
        const int pn = (pc + 1) / C::NPD;
        load_x(xv, xr, pn * two_d, pc + 1 - pn * C::NPD, two_d);
      }
#pragma unroll 1
      for (int j = 0; j < C::NPD; ++j) {
        float acc[32];
        unit_product(acc, a, ring);
        store_u<C>(own, p, j, acc, c > 0);
      }
    }
  }

  // 2. the logits, one 64-column piece of K after the other
  float lgk[C::KP][32];
  float off[2];
  {
    // two pieces of K: the first's logits wait in the warpgroup's pool
    // rows, a thread's own float4 slots, while the second's are summed
    const unsigned stash = pool + wg * C::kPool + tid * 16u;
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp) {
      float lost[32];
      logit_piece<C>(lgk[kp], lost, ring, own, p_pil, kp, cst, k_comp);
      if (kp == 0) row_offset(off, lgk[0]);
      fold(lgk[kp], lost, off);
      if (kp == 0 && C::KP > 1 && own.live)
#pragma unroll
        for (int t = 0; t < 8; ++t)
          st_shared_f4(stash + t * C::kSlot,
                       make_float4(lgk[0][4 * t], lgk[0][4 * t + 1],
                                   lgk[0][4 * t + 2], lgk[0][4 * t + 3]));
    }
    if constexpr (C::KP > 1) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (own.live) f = ld_shared_f4(stash + t * C::kSlot);
        lgk[0][4 * t] = f.x;
        lgk[0][4 * t + 1] = f.y;
        lgk[0][4 * t + 2] = f.z;
        lgk[0][4 * t + 3] = f.w;
      }
      // the pool rows are written next, over other threads' slots
      if constexpr (C::COH) wg_sync(1 + wg);
    }
  }

  // 3. the coherent pool, the softmax (STATS: its row states)
  double o[2] = {off[0], off[1]};
  if constexpr (C::COH)
    pool_blocks<C>(lgk, pool + wg * C::kPool, wg_rows, t_coh, k_comp, alpha,
                   wg, off, o);
  {
    float m_row[2], den_row[2];
    softmax_rows<C>(lgk, o, m_row, den_row);
    if constexpr (C::STATS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if ((lane_id() & 3) == 0 && rows[r] >= 0) {
          m_out[rows[r]] = m_row[r];
          den_out[rows[r]] = den_row[r];
        }
    }
  }

  // 4. the combine, piece j of h = c_0 + sum_p c_p * u_p with c_p = w
  // comb_p, into the first pilot's slots of piece j (STATS: to out)
  {
    unsigned aw[C::KP][3][4][4];
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp) to_a_regs(aw[kp], lgk[kp]);
#pragma unroll 1
    for (int j = 0; j < C::NPD; ++j) {
      float h[32];
#pragma unroll
      for (int kc = 0; kc < C::KP; ++kc) {
        float acc[32];
        unit_product(acc, aw[kc], ring);
#pragma unroll
        for (int i = 0; i < 32; ++i) h[i] = kc ? h[i] + acc[i] : acc[i];
      }
      for (int p = 0; p < p_pil; ++p) {
#pragma unroll
        for (int kc = 0; kc < C::KP; ++kc) {
          float f[32];
          unit_product(f, aw[kc], ring);
          float u[32];
          load_u<C>(u, own, p, j);
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            h[i] = fmaf(-f[i + 1], u[i + 1], fmaf(f[i], u[i], h[i]));
            h[i + 1] = fmaf(f[i + 1], u[i], fmaf(f[i], u[i + 1], h[i + 1]));
          }
        }
      }
      if constexpr (C::STATS) {
        store_rows(out, rows, two_d, j, h);
      } else {
        store_u<C>(own, 0, j, h, false);
      }
    }
  }
  // 5. out = h binv, piece jo from h's chunks j
  if constexpr (!C::STATS) {
#pragma unroll 1
    for (int jo = 0; jo < C::NPD; ++jo) {
      float ov[32];
#pragma unroll 1
      for (int j = 0; j < C::NPD; ++j) {
        unsigned a[3][4][4];
        {
          float v[32];
          load_u<C>(v, own, 0, j);
          to_a_regs(a, v);
        }
        float acc[32];
        unit_product(acc, a, ring);
#pragma unroll
        for (int i = 0; i < 32; ++i) ov[i] = j ? ov[i] + acc[i] : acc[i];
      }
      store_rows(out, rows, two_d, jo, ov);
    }
  }
}

// The launch plan of a shape: the instantiation's widths, its warpgroups,
// live rows, ring stages and shared memory
// (`mp_circ_kernels.mp_circ_smem_bytes` mirrors `mp_smem`).
struct Plan {
  int npd, kp, wgs, stages, tl;
  bool half;
  size_t smem;
};

inline int pieces_of(int w) { return w <= 64 ? 1 : w <= 128 ? 2 : 4; }

// column groups of 8 a piece holds below 2D: 8, or fewer where 2D < 64
inline int groups_of(int d) { return 2 * d >= 64 ? 8 : (2 * d + 7) / 8; }

inline size_t mp_smem(int npd, int kp, int wgs, bool half, bool coh, int p,
                      int tl, int stages) {
  const size_t live = half ? 64 : 128, rows = half ? 32 : 64;
  const size_t pool =
      coh ? rows * (64 * kp + 8) * 4 : kp > 1 ? live * 128 : 0;  // kPool
  return 1024 + (size_t)stages * (kUnit + 16) +
         (size_t)wgs * (p * npd * tl * live * 16 + pool);
}

inline int mp_stages(int npd, int kp, int wgs, bool half, bool coh, int p,
                     int tl) {
  int s = kMaxStages;
  while (s > 0 && mp_smem(npd, kp, wgs, half, coh, p, tl, s) >
                      (size_t)kSmemMax)
    --s;
  return s;
}

// one warpgroup of 64 live rows where its u and a ring of two units fit,
// else of 32; two warpgroups at D <= 64, K <= 64 where 128-row blocks
// cover the SMs and two warpgroups' u fit beside a ring of two units
inline bool mp_plan(int n, int d, int p, int k, int t_coh, int sms,
                    Plan& pl) {
  const bool coh = t_coh > 1;
  pl.npd = pieces_of(2 * d);
  pl.kp = pieces_of(k);
  pl.tl = groups_of(d);
  pl.wgs = 1;
  pl.half = false;
  pl.stages = mp_stages(pl.npd, pl.kp, 1, false, coh, p, pl.tl);
  if (pl.stages < 2) {
    pl.half = true;
    pl.stages = mp_stages(pl.npd, pl.kp, 1, true, coh, p, pl.tl);
  }
  if (pl.stages < 2 || t_coh > (pl.half ? 32 : 64)) return false;
  if (!pl.half && pl.npd <= 2 && pl.kp == 1) {
    const int wg_rows = 64 / t_coh * t_coh;
    const int s2 = mp_stages(pl.npd, 1, 2, false, coh, p, pl.tl);
    if (s2 >= 2 && (n + 2 * wg_rows - 1) / (2 * wg_rows) >= sms) {
      pl.wgs = 2;
      pl.stages = s2;
    }
  }
  pl.smem = mp_smem(pl.npd, pl.kp, pl.wgs, pl.half, coh, p, pl.tl,
                    pl.stages);
  return true;
}

struct MpArgs {
  const float* x;
  const bf16* planes[3];
  const float* cst;
  float* out;
  float *m_out, *den_out;
  int n, d, p, k, units, t_coh;
  float alpha;
  cudaStream_t stream;
};

template <class C>
int mp_launch(const MpArgs& g, const Plan& pl) {
  auto kern = mp_circ_tc_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = C::WGS * (C::kRows / g.t_coh * g.t_coh);
  kern<<<(g.n + rows - 1) / rows, (C::WGS + 1) * kWg, pl.smem, g.stream>>>(
      g.x, g.planes[0], g.planes[1], g.planes[2], g.cst, g.out, g.m_out,
      g.den_out, g.n, g.d, g.p, g.k, g.units, pl.stages, pl.tl, g.t_coh,
      g.alpha);
  return (int)cudaGetLastError();
}

// the STATS forms only where a warpgroup keeps 64 live rows: the circulant
// kernels K8 / K9 (one pilot) never need 32
template <bool COH, bool STATS>
int mp_dispatch(const MpArgs& g, const Plan& pl) {
#define QCE_MP(NPD_, KP_, WGS_, HALF_)                                     \
  if (pl.npd == NPD_ && pl.kp == KP_ && pl.wgs == WGS_ && pl.half == HALF_) \
    return mp_launch<MpCfg<NPD_, KP_, WGS_, HALF_, COH, STATS>>(g, pl);
  QCE_MP(1, 1, 2, false)
  QCE_MP(2, 1, 2, false)
  QCE_MP(1, 1, 1, false)
  QCE_MP(2, 1, 1, false)
  QCE_MP(4, 1, 1, false)
  QCE_MP(1, 2, 1, false)
  QCE_MP(2, 2, 1, false)
  QCE_MP(4, 2, 1, false)
  if constexpr (!STATS) {
    QCE_MP(1, 1, 1, true)
    QCE_MP(2, 1, 1, true)
    QCE_MP(4, 1, 1, true)
    QCE_MP(1, 2, 1, true)
    QCE_MP(2, 2, 1, true)
    QCE_MP(4, 2, 1, true)
  }
#undef QCE_MP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes; returns a cudaError_t (0 on success).
// x (n, 2 p d) and out (n, 2 d) hold complex values as interleaved [re, im]
// pairs, x pilot-major; hi, lo, lo2 are the bank's `units` units
// (`mp_circ_kernels.mp_circ_tc_operands`, `circ_kernels.circ_tc_operands`,
// 16-byte aligned), cst (k_comp) the layout's constants. t_coh > 1 selects
// the coherent form (n a whole number of t_coh row blocks); stats != 0 the
// stats form, which writes the DFT-domain accumulator to out and m, den (n)
// to m_out, den_out, from units without the inverse operand's.
extern "C" int mp_circ_estimate_launch(const float* x, const void* hi,
                                       const void* lo, const void* lo2,
                                       const float* cst, float* out,
                                       float* m_out, float* den_out, int n,
                                       int d, int p_pil, int k_comp,
                                       int units, int t_coh, float alpha,
                                       int stats, void* stream) {
  if (n < 0 || d < 1 || d > 128 || p_pil < 1 || k_comp < 1 || k_comp > 128 ||
      t_coh < 1 || n % t_coh != 0 ||
      (stats && (m_out == nullptr || den_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int npd = pieces_of(2 * d), ncd = (npd + 1) / 2;
  const int kp = pieces_of(k_comp);
  const int pairs = p_pil * (p_pil - 1) / 2;
  if (units != p_pil * npd * npd +
                   kp * (p_pil * npd + p_pil * ncd + pairs * npd) +
                   npd * (p_pil + 1) * kp + (stats ? 0 : npd * npd))
    return (int)cudaErrorInvalidValue;
  const void* aligned[3] = {hi, lo, lo2};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  Plan pl;
  if (!mp_plan(n, d, p_pil, k_comp, t_coh, sms, pl))
    return (int)cudaErrorInvalidValue;
  const MpArgs g{x,
                 {static_cast<const bf16*>(hi), static_cast<const bf16*>(lo),
                  static_cast<const bf16*>(lo2)},
                 cst,
                 out,
                 m_out,
                 den_out,
                 n,
                 d,
                 p_pil,
                 k_comp,
                 units,
                 t_coh,
                 alpha,
                 static_cast<cudaStream_t>(stream)};
  if (stats)
    return t_coh > 1 ? mp_dispatch<true, true>(g, pl)
                     : mp_dispatch<false, true>(g, pl);
  return t_coh > 1 ? mp_dispatch<true, false>(g, pl)
                   : mp_dispatch<false, false>(g, pl);
}
