// The bank stream of the grouped online-softmax estimator, shared by K1 / K3
// / K2 (grouped_estimate.cu, VARIANT kFull) and the floor probe K15
// (floor_probe.cu, every VARIANT). Both compile this one body, so the probe
// times K1's own code: its `full` variant is K1, bit for bit.
//
// The probe's variants mirror the stripped bodies of
// tools/kernel_floor_probe.py (`BODIES` :191): after the GEMM of component
// k, per row,
//   kFull          the K1 epilogue (logits, online softmax, combine);
//   kGemmOnly      acc += yz[:, 2M:]                       -> acc
//   kLogitsOnly    the logit and the online-softmax denominator -> den
//   kCombineOnly   acc += logw_k (yz[:, 2M:] + b_k)        -> acc
//   kSquareOnly    acc += ((yz[:, :2M] - mu_k)^2)[:, :2D]  -> acc (2D <= 2M)
//   kQuadOnly      s += |yz[:, :2M] - mu_k|^2              -> s
//   kFullFixedmax  p = exp(lg - logw_0), no running max    -> acc / den
// with den and s written to every column of the row. On the TPU every
// stripped body still ran the whole (2M+2D)-wide MXU product; nvcc removes
// FMAs whose results nobody reads. So the stripped variants fold every
// accumulator (all 2M + 2D columns) into `sink_v`, one add per column and
// component, which is stored only when the caller passes store_sink != 0
// (the wrapper passes 0): the full GEMM runs and the output is the JAX
// body's.
#pragma once

#include "stream_common.cuh"

namespace qce {

enum ProbeVariant {
  kFull = 0,
  kGemmOnly = 1,
  kLogitsOnly = 2,
  kCombineOnly = 3,
  kSquareOnly = 4,
  kQuadOnly = 5,
  kFullFixedmax = 6,
};

template <int CP, int CW, int RPW, bool COH, bool STATS, int VARIANT>
__device__ __forceinline__ void grouped_stream(
    const float* __restrict__ r2, const float* __restrict__ pw,
    const float* __restrict__ mu, const float* __restrict__ b,
    const float* __restrict__ logw, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ den_out, int n,
    int k_comp, int two_m, int two_d, int vec, int t_coh, float coh_alpha,
    float* __restrict__ sink, int store_sink) {
  constexpr int kTileN = kWarps * RPW;
  extern __shared__ __align__(16) float smem[];
  const int s_cols = two_m + two_d;
  const int r_stride = (two_m + 3) & ~3;
  const int buf_floats = kKc * s_cols;
  float* r_s = smem;
  float* pw_s = smem + kTileN * r_stride;
  float* lg_s = pw_s + 2 * buf_floats;  // K3: one component's tile logits

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows of this tile: whole T-row blocks for K3
  const int tile_rows = COH ? (kTileN / t_coh) * t_coh : kTileN;
  const int row0 = blockIdx.x * tile_rows;
  // K3 blocks inside one warp (T divides RPW, so T is a power of two):
  // rows i and j share a block iff (i ^ j) & ~(T - 1) == 0
  const bool in_warp = COH && (RPW % t_coh == 0);
  const int t_mask = ~(t_coh - 1);

  // r tile -> shared memory; masked rows read as zeros (never stored)
  for (int i = threadIdx.x; i < kTileN * two_m; i += kThreads) {
    const int rr = i / two_m, cc = i - rr * two_m;
    const int row = row0 + rr;
    r_s[rr * r_stride + cc] =
        (rr < tile_rows && row < n) ? r2[(size_t)row * two_m + cc] : 0.f;
  }

  // per-lane column offsets into a pw_k row; masked columns read column 0
  // (in bounds) and their accumulators are never used
  int off_p[CP], off_w[CW];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = lane + 32 * j;
    off_p[j] = c < two_m ? c : 0;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    off_w[j] = c < two_d ? two_m + c : 0;
  }

  float yp[RPW][CP], yw[RPW][CW], acc[RPW][CW], m_run[RPW], den[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CP; ++j) yp[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      yw[i][j] = 0.f;
      acc[i][j] = 0.f;
    }
  }
  float sink_v = 0.f;  // stripped variants: every accumulator, folded
  const float m_fix = VARIANT == kFullFixedmax ? logw[0] : 0.f;

  const int n_ch = (two_m + kKc - 1) / kKc;
  const int total = k_comp * n_ch;
  issue_stage(pw_s, pw, 0, n_ch, two_m, s_cols, s_cols, vec);
  cp_async_commit();

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total)
      issue_stage(pw_s + ((t + 1) & 1) * buf_floats, pw, t + 1, n_ch, two_m,
                  s_cols, s_cols, vec);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const float* ps = pw_s + (t & 1) * buf_floats;
    const int k = t / n_ch;
    const int kk0 = (t % n_ch) * kKc;
    const int rows = min(kKc, two_m - kk0);
    const float* rs = r_s + warp * RPW * r_stride + kk0;
#pragma unroll 2
    for (int kk = 0; kk < rows; ++kk) {
      float a[RPW], bp[CP], bw[CW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = rs[i * r_stride + kk];
      const float* prow = ps + kk * s_cols;
#pragma unroll
      for (int j = 0; j < CP; ++j) bp[j] = prow[off_p[j]];
#pragma unroll
      for (int j = 0; j < CW; ++j) bw[j] = prow[off_w[j]];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
#pragma unroll
        for (int j = 0; j < CP; ++j) yp[i][j] = fmaf(a[i], bp[j], yp[i][j]);
#pragma unroll
        for (int j = 0; j < CW; ++j) yw[i][j] = fmaf(a[i], bw[j], yw[i][j]);
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by the issue at t + 1

    if (kk0 + rows == two_m) {  // component k complete
      const float* muk = mu + (size_t)k * two_m;
      const float* bk = b + (size_t)k * two_d;
      const float lw = logw[k];
      if constexpr (VARIANT == kFull) {  // online softmax
        float lg[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float q = 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) {
            const int c = lane + 32 * j;
            if (c < two_m) {
              const float d = yp[i][j] - __ldg(muk + c);
              q = fmaf(d, d, q);
            }
            yp[i][j] = 0.f;
          }
          lg[i] = lw - warp_sum(q);
        }
        if constexpr (COH) {
          float s[RPW];
          if (in_warp) {
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
              s[i] = 0.f;
#pragma unroll
              for (int j = 0; j < RPW; ++j)
                if (((i ^ j) & t_mask) == 0) s[i] += lg[j];
            }
          } else {
            // lg_s was last read before this stage's first barrier
            if (lane == 0) {
#pragma unroll
              for (int i = 0; i < RPW; ++i) lg_s[warp * RPW + i] = lg[i];
            }
            __syncthreads();
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
              const int rr = warp * RPW + i;
              s[i] = lg[i];  // masked rows: never stored
              if (rr < tile_rows) {
                const int b0 = rr / t_coh * t_coh;
                float sum = 0.f;
                for (int j = 0; j < t_coh; ++j) sum += lg_s[b0 + j];
                s[i] = sum;
              }
            }
          }
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            lg[i] = coh_alpha >= 1.f
                        ? s[i]
                        : (1.f - coh_alpha) * lg[i] + coh_alpha * s[i];
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float logit = lg[i];
          const float m_new = fmaxf(m_run[i], logit);
          // exp(-inf - (-inf)) would be NaN: an all -inf prefix scales by 0
          const float scale =
              m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
          const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
          den[i] = fmaf(den[i], scale, p);
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            const int c = lane + 32 * j;
            const float z = yw[i][j] + (c < two_d ? __ldg(bk + c) : 0.f);
            acc[i][j] = fmaf(p, z, acc[i][j] * scale);
            yw[i][j] = 0.f;
          }
          m_run[i] = m_new;
        }
      } else {  // the probe's stripped bodies
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float q = 0.f;
          if constexpr (VARIANT == kLogitsOnly || VARIANT == kQuadOnly ||
                        VARIANT == kFullFixedmax) {
#pragma unroll
            for (int j = 0; j < CP; ++j) {
              const int c = lane + 32 * j;
              if (c < two_m) {
                const float d = yp[i][j] - __ldg(muk + c);
                q = fmaf(d, d, q);
              }
            }
            q = warp_sum(q);
          }
          if constexpr (VARIANT == kGemmOnly) {
#pragma unroll
            for (int j = 0; j < CW; ++j) acc[i][j] += yw[i][j];
          } else if constexpr (VARIANT == kLogitsOnly) {
            const float logit = lw - q;
            const float m_new = fmaxf(m_run[i], logit);
            const float scale =
                m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
            const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
            den[i] = fmaf(den[i], scale, p);
            m_run[i] = m_new;
          } else if constexpr (VARIANT == kCombineOnly) {
#pragma unroll
            for (int j = 0; j < CW; ++j) {
              const int c = lane + 32 * j;
              const float z = yw[i][j] + (c < two_d ? __ldg(bk + c) : 0.f);
              acc[i][j] = fmaf(lw, z, acc[i][j]);
            }
          } else if constexpr (VARIANT == kSquareOnly) {
            // output column c = lane + 32 j is P column c (2D <= 2M)
#pragma unroll
            for (int j = 0; j < (CW < CP ? CW : CP); ++j) {
              const int c = lane + 32 * j;
              if (c < two_d) {
                const float d = yp[i][j] - __ldg(muk + c);
                acc[i][j] = fmaf(d, d, acc[i][j]);
              }
            }
          } else if constexpr (VARIANT == kQuadOnly) {
            den[i] += q;
          } else {  // kFullFixedmax
            const float p = expf((lw - q) - m_fix);
            den[i] += p;
#pragma unroll
            for (int j = 0; j < CW; ++j) {
              const int c = lane + 32 * j;
              const float z = yw[i][j] + (c < two_d ? __ldg(bk + c) : 0.f);
              acc[i][j] = fmaf(p, z, acc[i][j]);
            }
          }
          if constexpr (VARIANT != kFullFixedmax) {
#pragma unroll
            for (int j = 0; j < CP; ++j) sink_v += yp[i][j];
#pragma unroll
            for (int j = 0; j < CW; ++j) sink_v += yw[i][j];
          }
#pragma unroll
          for (int j = 0; j < CP; ++j) yp[i][j] = 0.f;
#pragma unroll
          for (int j = 0; j < CW; ++j) yw[i][j] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = warp * RPW + i;
    const int row = row0 + rr;
    if (rr < tile_rows && row < n) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int c = lane + 32 * j;
        if (c < two_d) {
          float v;
          if constexpr (VARIANT == kFull)
            v = STATS ? acc[i][j] : acc[i][j] / den[i];
          else if constexpr (VARIANT == kLogitsOnly || VARIANT == kQuadOnly)
            v = den[i];
          else if constexpr (VARIANT == kFullFixedmax)
            v = acc[i][j] / den[i];
          else
            v = acc[i][j];
          out[(size_t)row * two_d + c] = v;
        }
      }
      if (STATS && lane == 0) {  // every lane holds the row's m and den
        m_out[row] = m_run[i];
        den_out[row] = den[i];
      }
    }
  }
  if constexpr (VARIANT != kFull && VARIANT != kFullFixedmax) {
    if (store_sink) sink[(size_t)blockIdx.x * kThreads + threadIdx.x] = sink_v;
  }
}

}  // namespace qce
