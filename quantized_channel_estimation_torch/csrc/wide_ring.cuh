// The chunk ring of the wide forms for Hopper, shared by
// grouped_wide_estimate.cu (K1-K5 past 2M or 2D = 256) and
// circ_wide_estimate.cu (K6-K9 past D = 128): every product there is cut
// along its contraction into 64-deep chunks, and a block of two consumer
// warpgroups (64 rows each) and one producer warpgroup streams them.
//
//   - the rows' layout: a row split writes the rows' three bf16 planes
//     (hi, lo, lo2) as 64-row tiles of 64-deep chunks, one 8 KB run a
//     (tile, chunk), K-major in the 128-byte swizzle, padding zero
//     (`split_tiles_kernel`; its plain version is
//     `kernels.wide_row_planes`);
//   - a ring stage holds one chunk of both warpgroups' row planes (48 KB)
//     and the same chunk of up to two 64-column pieces of the bank operand
//     (48 KB), copied by one producer thread with cp.async.bulk
//     (`load_chunk`); two stages, each guarded by a full and an empty
//     mbarrier (`WideRing`);
//   - a chunk of a piece is up to six bf16 products of three-plane splits
//     (grouped_tc_stream.cuh's order, hi.hi last), four wgmma m64n64k16
//     each (`issue_chunk`), into a fresh fp32 accumulator that the caller
//     folds into the piece's sum over the chunks.
#pragma once

#include "grouped_tc_stream.cuh"

namespace qce_wide {

using namespace qce_tc;

constexpr int kWgs = 2;     // consumer warpgroups a block, 64 rows each
constexpr int kGroup = 2;   // 64-column pieces a ring stage
constexpr int kStages = 2;
constexpr int kPlanes = 3;  // hi, lo, lo2
constexpr int kStageA = kWgs * kPlanes * kAtomBytes;  // 48 KB
constexpr int kStageBytes = kStageA + kGroup * kPlanes * kAtomBytes;
constexpr int kThreads = (kWgs + 1) * kWg;
// dynamic shared memory of the ring: the stages from a 1024-aligned base,
// then the barriers (full, then empty, a stage each)
constexpr size_t kRingSmem = 1024 + (size_t)kStages * (kStageBytes + 16);

// The row split: one thread a 16-byte unit (8 columns of one row) of the
// planes a (plane stride `plane_units` 16-byte units): tile i, chunk c is
// the 8 KB run at unit (i n_ch + c) 512, its row rr at the unit's row rr,
// column c 64 + j at the 128-byte swizzle's place. ROWS supplies the
// values: `skip(tile)` (a tile left unwritten), `row(tile, rr)` (the
// source row of a tile's row, -1 for padding) and `pair(row, col)` (its
// columns col and col + 1, zero past the row's width).
template <class Rows>
__global__ void split_tiles_kernel(Rows rows, uint4* __restrict__ a,
                                   int n_ch, int tiles, size_t plane_units) {
  const size_t units = (size_t)tiles * n_ch * 512;
  for (size_t id = (size_t)blockIdx.x * blockDim.x + threadIdx.x; id < units;
       id += (size_t)gridDim.x * blockDim.x) {
    const int kq = (int)(id & 7), rr = (int)((id >> 3) & 63);
    const size_t tc = id >> 9;  // tile * n_ch + chunk
    const int c = (int)(tc % n_ch), tile = (int)(tc / n_ch);
    if (rows.skip(tile)) continue;
    const int row = rows.row(tile, rr);
    unsigned pl[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = row >= 0 ? rows.pair(row, c * 64 + kq * 8 + 2 * e)
                                : make_float2(0.f, 0.f);
      unsigned w[3];
      split3(x.x, x.y, w);
#pragma unroll
      for (int q = 0; q < 3; ++q) pl[q][e] = w[q];
    }
    const size_t dst = tc * 512 + rr * 8 + (kq ^ (rr & 7));
#pragma unroll
    for (int q = 0; q < 3; ++q)
      a[q * plane_units + dst] = make_uint4(pl[q][0], pl[q][1], pl[q][2],
                                            pl[q][3]);
  }
}

// Launch the row split of `tiles` tiles of n_ch chunks into a on `st`.
template <class Rows>
int split_tiles(const Rows& rows, void* a, int n_ch, int tiles,
                cudaStream_t st) {
  const size_t units = (size_t)tiles * n_ch * 512;
  const int grid = (int)((units + 255) / 256 < 65535 ? (units + 255) / 256
                                                     : 65535);
  split_tiles_kernel<<<grid, 256, 0, st>>>(rows, static_cast<uint4*>(a),
                                           n_ch, tiles, units);
  return (int)cudaGetLastError();
}

// 64-row tiles of n rows at wg_rows live rows a tile, rounded up to whole
// blocks of kWgs tiles: what the scratch a holds.
inline int row_tiles(int n, int wg_rows = 64) {
  const int tiles = (n + wg_rows - 1) / wg_rows;
  return (tiles + kWgs - 1) / kWgs * kWgs;
}

// A block's ring in shared memory and one party's place in it (the
// producer and each consumer keep their own stage s and parity ph).
struct WideRing {
  unsigned base, full0, empty0;
  int s, ph;
  __device__ __forceinline__ unsigned stage() const {
    return base + s * kStageBytes;
  }
  __device__ __forceinline__ unsigned full() const { return full0 + 8 * s; }
  __device__ __forceinline__ unsigned empty() const {
    return empty0 + 8 * s;
  }
  // past the barriers: shared memory a kernel may add to kRingSmem
  __device__ __forceinline__ unsigned extra() const {
    return empty0 + 8 * kStages;
  }
  __device__ __forceinline__ void next() {
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// Lay the ring out from the block's dynamic shared memory and initialise
// its barriers; a block barrier, so every thread must call it.
__device__ __forceinline__ WideRing ring_init(unsigned char* smem_raw) {
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const WideRing ring{base, base + kStages * kStageBytes,
                      base + kStages * kStageBytes + 8 * kStages, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full0 + 8 * s, 1);
      // one arrival a consumer warp
      mbar_init(ring.empty0 + 8 * s, kWgs * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// The producer's copy of chunk c into the next stage: both warpgroups' row
// chunk (tiles kWgs pair, + 1 of the split a) and chunk c of gn pieces of
// the bank operand, pieces piece0 + gp (a piece's n_ch chunk units
// consecutive in each plane).
__device__ __forceinline__ void load_chunk(WideRing& ring, const uint4* a,
                                           size_t plane_units, int pair,
                                           int n_ch, int c,
                                           const bf16* const (&b)[3],
                                           int piece0, int gn) {
  const unsigned full = ring.full();
  mbar_wait(ring.empty(), ring.ph ^ 1);
  mbar_expect_tx(full, kStageA + gn * kPlanes * kAtomBytes);
  const unsigned dst = ring.stage();
#pragma unroll
  for (int w = 0; w < kWgs; ++w) {
    const size_t run = ((size_t)(pair * kWgs + w) * n_ch + c) * 512;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      bulk_copy(dst + (w * kPlanes + p) * kAtomBytes,
                a + p * plane_units + run, kAtomBytes, full);
  }
  for (int gp = 0; gp < gn; ++gp) {
    const size_t off = ((size_t)(piece0 + gp) * n_ch + c) * kAtomBytes;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      bulk_copy(dst + kStageA + (gp * kPlanes + p) * kAtomBytes,
                reinterpret_cast<const char*>(b[p]) + off, kAtomBytes, full);
  }
  ring.next();
}

// Products [P0, P1) of the chunk in stage st, k16 steps [K0, K1), into
// both pieces' accumulators, the first step of product P0 overwriting: the
// stream's order (prod_a / prod_b, hi.hi last). A stage holding one piece
// leaves acc[1] to a stale product nobody reads.
template <int P0, int P1, int K0, int K1>
__device__ __forceinline__ void issue_chunk(float (&acc)[kGroup][32],
                                            unsigned st, int wg) {
  const uint64_t da = sw128_desc(st + wg * kPlanes * kAtomBytes);
  const uint64_t db = sw128_desc(st + kStageA);
#pragma unroll
  for (int p = P0; p < P1; ++p)
#pragma unroll
    for (int ks = K0; ks < K1; ++ks)
#pragma unroll
      for (int gp = 0; gp < kGroup; ++gp)
        wgmma_64x64(acc[gp],
                    step_desc(da + prod_a(6, p) * (kAtomBytes >> 4), ks),
                    step_desc(db + (gp * kPlanes + prod_b(6, p)) *
                                       (kAtomBytes >> 4),
                              ks),
                    p > P0 || ks > K0);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N][32]) {
#pragma unroll
  for (int gp = 0; gp < N; ++gp) fence_operand(x[gp]);
}

}  // namespace qce_wide
