"""Launch the kernels of the wgmma stream many times at each shape and hold
every output against the plain version: a check for races, which one
launch in a test may not show.

For each shape (2M, 2D, K, N, dead components) and mode of K14b ('bf16',
'split2', 'split3') the plain version is computed once; then K14b runs
`--repeats` times, each launch on a fresh output and, unless `--no-poison`
is given, after a kernel that fills the shared memory of every SM with
NaN, so that a read of shared memory before its write shows as NaN and not
as the last kernel's data. Every launch's error (max |kernel - plain| /
max |plain|) is kept; a launch over 1e-4 (or NaN) counts as a failure. The
default shapes are the shared-memory-A path (2M > 128: one and two
consumer warpgroups, one block, several waves) and a main-path shape.

Mode 'f32' does the same for K1 and K3 (`F32_SHAPES`: K1 with 64- and
128-row blocks and the one-stage ring of the widest bank; K3 at T = 4 and
16, pooled by shuffles, and T = 64 and 3, pooled through shared memory).
A launch fails if its bits differ from the first launch's, or if it is
further than 1e-4 of the scale from the plain version and further from the
plain version evaluated in float64 than twice the plain version's own
error plus 1e-5 (a logit pooled over many rows rounds differently in any
two float32 orders).

Mode 'wide' does the same, with the rule of mode 'f32', for the wide form
of K1 and K3 (`WIDE_SHAPES`: 2M and 2D past the stream's 256, an odd
number of value pieces, contraction widths no multiple of 64, one and
three waves of blocks, K3 at T = 4 and 3).

Mode 'wide_topk' does the same for the wide form of K4 and K5
(`WIDE_TOPK_SHAPES`: D = 256 at one pilot and five pilots at D = 64, k =
1, 4 and 8, a component none of the rows picks and one most rows pick, a
shard of fewer components than k, two waves of blocks), each launch's
outputs written where the last launch's outputs lay, filled with NaN
after it was read; a launch fails if any output's bits differ from the
first launch's, and the first launch if K4 is further than 1e-4 of the
scale from its plain version on the rows whose k-th and (k+1)-th logits
are not near a tie (`topk_near_ties`).

Mode 'karatsuba' does the same for K14a (`KARATSUBA_SHAPES`: one and two
consumer warpgroups a block, 32-column pieces, two contraction chunks); a
launch fails if its bits differ from the first launch's or if it is
further than 1e-4 of the scale from its plain version.

Mode 'fact' does the same for the factored kernels K11, K12 and K13
(`FACT_SHAPES`: the combine's A in registers with one and two consumer
warpgroups a block, A in shared memory with 64-, 32- and 16-column pieces,
K12 pooled by shuffles and through shared memory, K13), with the rule of
mode 'f32' (for K13 on each of m, den and the accumulator).

Mode 'mpcirc' does the same for the multi-pilot circulant kernel K10, flat
and coherent (`MPCIRC_SHAPES`: one and two consumer warpgroups a block, 32
live rows a warpgroup, one, two and four 64-column pieces of 2D, two of K,
the coherent pool at T = 3, 4, 32 and 64), with the rule of mode 'f32'.

Mode 'circ' does the same for the circulant kernels K6-K9, the same
template at one pilot (`CIRC_SHAPES`: one and two consumer warpgroups a
block, one, two and four 64-column pieces of 2D, a 128-component shard,
D = K = 128, the pool at T = 3, 4 and 64), with the rule of mode 'f32' (for
K8 and K9 on each of m, den and the accumulator).

Mode 'wide_circ' does the same for the wide form of K6-K9
(`csrc/circ_wide_estimate.cu`, past D = 128; `WIDE_CIRC_SHAPES`: one past
the template's D, the JAX tool's D = 512 over two waves of blocks, the
rule's edge D = 672, a 128-component shard, the pool at T = 3, 4 and 64),
each launch's outputs written where the last launch's outputs lay, filled
with NaN after they were read: a launch fails if any output's bits differ
from the first launch's, and the first launch under the rule of mode
'f32'.

Mode 'fact_circ' does the same for the factorised K6-K9
(`csrc/circ_fact_estimate.cu` and its STATS form, past D = 128 where the
transform splits; `FACT_CIRC_SHAPES`: one past the template's D, D = 512
over two waves of blocks, the rule's edge D = 672 at K = 128, the pool at
T = 3, 4 and 64 (two sweeps), the kron basis, K8 / K9 at most of these) on
random DFT-domain banks, under the rule of mode 'wide_circ' against its
plain version `circ_fact_reference` (K8 / K9: each of m, den and acc).
Mode 'wide_circ' drives the wide K6-K9 through their own wrappers
(`circ_estimate_wide` and its coherent and stats siblings): its random
transforms are no DFT.

Mode 'wide_mpcirc' does the same for the wide form of K10 (the
multi-pilot kernels of `csrc/circ_wide_estimate.cu`, past the template's
rule; `WIDE_MPCIRC_SHAPES`: D one past the template's, K past one logit
slice, a P past the template's shared memory, D = 1 at many pilots, the
pool at T = 3, 4 and 16), flat and coherent, under the rule of mode
'wide_circ' (each launch after the NaN fill of the last one's output, bit
for bit the first launch; the first held against the wide form's plain
version `mp_circ_wide_reference`, or against float64 under mode 'f32''s
rule).

Mode 'fact_mpcirc' does the same for the factorised K10
(`csrc/mp_circ_fact_estimate.cu`, past the template's rule where the
transform splits and the tile fits; `FACT_MPCIRC_SHAPES`: P = 2 at D = 256
over two waves of blocks, P = 3 at D = 144 with T = 3 and alpha 0.5, the
most pilots the route takes at D = 357, T = 64 past a tile's rows (two
sweeps), the kron basis), flat and coherent, on random DFT-domain
multi-pilot banks, under the rule of mode 'fact_circ' against its plain
version `mp_circ_fact_reference`.

Mode 'wide_fact' does the same for the wide form of K11-K13
(`csrc/fact_wide_estimate.cu`, past the template's D <= 128, M <= 64;
`WIDE_FACT_SHAPES`: D one past the template's, M past it, D = 256 over
two waves of blocks, K past one logit slice, the pool at T = 3, 4 and 16),
under the rule of mode 'wide_circ' (each launch after the NaN fill of the
last one's outputs, bit for bit the first launch; the first held against
the wide form's plain version `fact_wide_reference`, or against float64
under mode 'f32''s rule, for K13 on each of m, den and the accumulator).

Mode 'fused_fact' does the same for the fused K11 / K12
(`csrc/fact_fused_estimate.cu`, 129 <= D <= 256, M <= 16;
`FUSED_FACT_SHAPES`: D one past the template's, odd 2D / 2, the served D =
256, K = 32, M = 16 over two waves of blocks, M = 3 and 8, the pool at T =
3, 4, 16 and 64), against its plain version `fact_fused_reference`.

`--without-proxy-fence` also builds a copy of K14b without the
`fence.proxy.async` before each stage's release (in
csrc/grouped_tc_stream.cuh) and runs it launch for launch beside the
kernel, to measure what the fence does; with `--time` it also times both
(CUDA events, median of 10, in the order kernel, copy, copy, kernel) at the
headline widths (131072 rows, 2M = 2D = 128, K = 64).

    python -m quantized_channel_estimation_torch.tools.tc_repeat_check \
        [--repeats R] \
        [--modes bf16 split2 split3 f32 wide wide_topk karatsuba fact mpcirc
                 circ wide_circ wide_mpcirc wide_fact fused_fact
                 fact_circ fact_mpcirc] \
        [--no-poison] \
        [--without-proxy-fence [--time]]

Exits 1 if any launch of a kernel (not of the copy) failed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time

import torch

from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.estimators import fact_kernels as fk
from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import mp_circ_kernels as mk
from quantized_channel_estimation_torch.estimators import variant_kernels as vk
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.utils import profiling

TOL = 1e-4
# (2M, 2D, K, N, dead components)
SHAPES = (
    (256, 24, 3, 70, 0),        # A in shared memory, two warpgroups
    (256, 256, 4, 200, 1),      # A in shared memory, one warpgroup
    (192, 64, 5, 1000, 0),      # 3 contraction chunks, 8 blocks
    (256, 24, 3, 3 * 132 * 128 + 5, 0),  # three waves of blocks
    (128, 128, 16, 4097, 3),    # the main path: A in registers
)
# K1 (T = 1) and K3: (2M, 2D, K, N, dead components, T, alpha)
F32_SHAPES = (
    (128, 128, 16, 4097, 3, 1, 1.0),       # main widths, 64-row blocks
    (128, 128, 16, 2 * 132 * 128 + 5, 0, 1, 1.0),  # 128-row blocks, 2 waves
    (256, 256, 4, 200, 1, 1, 1.0),         # the widest: a one-stage ring
    (128, 128, 16, 4 * 8193, 2, 4, 1.0),   # T = 4: quad shuffles
    (128, 128, 16, 16 * 2049, 0, 16, 0.25),  # T = 16: a thread's two rows
    (128, 128, 8, 64 * 301, 1, 64, 1.0),   # T = 64: shared memory
    (128, 128, 8, 3 * 4001, 0, 3, 0.5),    # T = 3: 63-row warpgroup tiles
)
# the wide form of K1 (T = 1) and K3, as F32_SHAPES
WIDE_SHAPES = (
    (512, 512, 4, 300, 1, 1, 1.0),          # D = 256: four column slices
    (640, 128, 5, 1001, 0, 1, 1.0),         # five pilots at D = 64
    (400, 400, 3, 2 * 132 * 128 + 5, 0, 1, 1.0),  # ragged pieces, 2 waves
    (512, 128, 4, 4 * 1001, 1, 4, 1.0),     # K3, T = 4: quad shuffles
    (512, 256, 4, 3 * 701, 0, 3, 0.5),      # K3, T = 3: shared memory
)
# the wide K4 / K5: (2M, 2D, K, N, dead components, k, logit shift of
# component 0: a positive shift makes most rows pick it, a negative one
# none)
WIDE_TOPK_SHAPES = (
    (512, 512, 32, 4096, 2, 1, 0.0),        # D = 256 at one pilot
    (512, 512, 32, 4096, 2, 4, 0.0),
    (640, 128, 6, 1201, 1, 8, 0.0),         # five pilots at D = 64, k = 8
    (400, 400, 5, 2 * 132 * 128 + 5, 0, 3, 30.0),   # one component dominates
    (272, 16, 9, 777, 1, 2, -1e4),          # a component no row picks
    (512, 128, 3, 500, 0, 5, 0.0),          # K5: a shard of fewer than k
)
# K14a: (M, D, K, N, dead components)
KARATSUBA_SHAPES = (
    (64, 64, 16, 4097, 3),                 # one consumer warpgroup a block
    (64, 64, 16, 2 * 132 * 128 + 5, 0),    # two, two waves of blocks
    (40, 100, 6, 515, 1),                  # 32-column pieces
    (128, 128, 4, 200, 1),                 # two contraction chunks
)
# K11 / K12 / K13: (D, M, K, N, dead components, T, alpha, kernel)
FACT_SHAPES = (
    (64, 16, 16, 4097, 3, 1, 1.0, "K11"),     # A in registers, 1 warpgroup
    (64, 16, 16, 2 * 132 * 128 + 5, 0, 1, 1.0, "K11"),  # 2, two waves
    (32, 6, 5, 1000, 1, 1, 1.0, "K11"),       # one forward chunk
    (48, 32, 6, 777, 1, 1, 1.0, "K13"),       # A in shared memory
    (100, 24, 3, 515, 0, 1, 1.0, "K11"),      # 32-column pieces
    (128, 64, 4, 300, 1, 1, 1.0, "K11"),      # the widest: 16-column pieces
    (64, 16, 16, 4 * 8193, 2, 4, 1.0, "K12"),  # quad shuffles, 2 warpgroups
    (64, 16, 8, 16 * 2049, 0, 16, 0.25, "K12"),  # a thread's two rows
    (64, 16, 8, 64 * 301, 1, 64, 1.0, "K12"),  # shared memory
    (64, 64, 4, 3 * 1001, 0, 3, 0.5, "K12"),   # 63-row tiles, A in smem
    (64, 16, 16, 4097, 3, 1, 1.0, "K13"),     # A in registers
)
# the wide K11 / K12 / K13: (D, M, K, N, dead components, T, alpha, kernel)
WIDE_FACT_SHAPES = (
    (129, 4, 8, 1001, 1, 1, 1.0, "K11"),       # one past the template's D
    (64, 65, 4, 777, 0, 1, 1.0, "K13"),        # one past its M
    (256, 16, 32, 2 * 132 * 128 + 5, 2, 1, 1.0, "K11"),  # two waves
    (136, 2, 200, 4097, 3, 1, 1.0, "K13"),     # K past one logit slice
    (144, 16, 8, 3 * 701, 0, 3, 0.5, "K12"),   # T = 3, alpha < 1
    (96, 72, 4, 4 * 1001, 1, 4, 0.25, "K12"),  # M = 72 at T = 4
    (256, 16, 10, 16 * 129, 2, 16, 1.0, "K12"),  # T = 16
)
# the fused K11 / K12: (D, M, K, N, dead components, T, alpha, kernel)
FUSED_FACT_SHAPES = (
    (129, 4, 8, 1001, 1, 1, 1.0, "K11"),       # one past the template's D
    (255, 16, 5, 777, 0, 1, 1.0, "K11"),       # 2D = 510: a ragged half
    (256, 16, 32, 2 * 132 * 64 + 5, 2, 1, 1.0, "K11"),  # two waves
    (144, 16, 8, 3 * 701, 0, 3, 0.5, "K12"),   # T = 3, alpha < 1
    (200, 3, 7, 4 * 1001, 1, 4, 0.25, "K12"),  # M = 3, halves of 4 / 3
    (256, 16, 10, 16 * 129, 2, 16, 1.0, "K12"),  # T = 16
    (192, 8, 4, 64 * 33, 1, 64, 1.0, "K12"),   # T = 64, M = 8
)
# K10: (P, D, K, N, dead components, T, alpha)
MPCIRC_SHAPES = (
    (2, 64, 64, 2 * 132 * 128 + 5, 0, 1, 1.0),  # two warpgroups, two waves
    (2, 64, 16, 4097, 3, 1, 1.0),              # one warpgroup
    (3, 24, 40, 1000, 1, 1, 1.0),              # one piece of 2D, 6 groups
    (4, 100, 70, 515, 1, 1, 1.0),              # four pieces, two of K, HALF
    (2, 64, 64, 4 * 8193, 2, 4, 1.0),          # pool, two warpgroups
    (3, 32, 8, 3 * 1001, 0, 3, 0.5),           # T = 3: 63-row tiles
    (4, 64, 64, 64 * 101, 1, 64, 1.0),         # T = 64
    (4, 128, 128, 32 * 61, 0, 32, 0.25),       # the widest, HALF
)
# K6-K9: (D, K, N, dead components, T, alpha, stats)
CIRC_SHAPES = (
    (64, 64, 2 * 132 * 128 + 5, 0, 1, 1.0, False),  # K6, two warpgroups
    (64, 64, 4097, 3, 1, 1.0, True),           # K8, one warpgroup
    (16, 8, 1000, 1, 1, 1.0, False),           # one piece of 2D
    (64, 128, 4097, 1, 1, 1.0, True),          # a 128-component shard
    (128, 128, 2049, 0, 1, 1.0, False),        # four pieces of 2D, two of K
    (64, 64, 4 * 8193, 2, 4, 1.0, False),      # K7, pool, two warpgroups
    (64, 64, 4 * 8193, 2, 4, 1.0, True),       # K9, two warpgroups
    (128, 128, 64 * 33, 1, 64, 1.0, True),     # K9 at D = 128, T = 64
    (32, 40, 3 * 1001, 0, 3, 0.5, True),       # K9, alpha < 1, 63-row tiles
    (100, 50, 4 * 101, 1, 4, 0.25, False),     # widths no multiple of 32
)
# the wide K6-K9: (D, K, N, dead components, T, alpha, stats)
WIDE_CIRC_SHAPES = (
    (129, 16, 1001, 1, 1, 1.0, False),         # K6 one past the template
    (512, 16, 2 * 132 * 128 + 5, 2, 1, 1.0, False),  # D = 512, two waves
    (256, 128, 4097, 3, 1, 1.0, True),         # K8, a 128-component shard
    (672, 64, 4 * 1001, 1, 4, 0.25, False),    # K7 at the rule's edge
    (320, 40, 64 * 33, 0, 64, 1.0, True),      # K9, T = 64
    (200, 7, 3 * 701, 1, 3, 0.5, True),        # K9, T = 3, alpha < 1
)
# the factorised K6-K9: (D, K, N, dead components, T, alpha, blocks, stats)
FACT_CIRC_SHAPES = (
    (129, 16, 1001, 1, 1, 1.0, None, False),   # one past the template, 3 x 43
    (512, 16, 2 * 132 * 16 + 5, 2, 1, 1.0, None, False),  # two waves
    (672, 128, 4 * 1001, 3, 4, 0.25, None, False),  # the edge, K = 128
    (357, 64, 64 * 33, 1, 64, 1.0, None, False),  # 17 x 21, T = 64: 2 sweeps
    (160, 7, 3 * 701, 1, 3, 0.5, None, False),  # T = 3: 15-row tiles
    (256, 16, 1000, 2, 4, 1.0, (16, 16), False),  # the kron basis
    (512, 16, 2 * 132 * 16 + 5, 2, 1, 1.0, None, True),  # K8, two waves
    (672, 128, 4 * 1001, 3, 4, 0.25, None, True),  # K9 at the edge
    (512, 64, 64 * 33, 1, 64, 0.25, None, True),  # K9 two sweeps, alpha < 1
    (160, 7, 3 * 701, 1, 3, 0.5, None, True),  # K9, T = 3
    (256, 16, 1000, 2, 1, 1.0, (16, 16), True),  # K8, the kron basis
)
# the factorised K10: (P, D, K, N, dead components, T, alpha, blocks)
FACT_MPCIRC_SHAPES = (
    (2, 256, 32, 2 * 132 * 32 + 5, 2, 1, 1.0, None),  # D = 256, two waves
    (3, 144, 16, 3 * 701, 0, 3, 0.5, None),    # 12 x 12, T = 3, alpha < 1
    (3, 357, 8, 1001, 1, 1, 1.0, None),        # the most pilots at D = 357
    (2, 256, 16, 64 * 33, 1, 64, 1.0, None),   # T = 64: two sweeps
    (2, 256, 16, 4 * 250, 2, 4, 1.0, (16, 16)),  # the kron basis
)
# the wide K10: (P, D, K, N, dead components, T, alpha)
WIDE_MPCIRC_SHAPES = (
    (2, 129, 8, 1001, 1, 1, 1.0),              # one past the template's D
    (2, 64, 200, 4097, 3, 1, 1.0),             # K past one logit slice
    (12, 64, 16, 515, 0, 1, 1.0),              # P past shared memory
    (40, 1, 4, 4 * 301, 1, 4, 0.25),           # D = 1, 40 pilots, pool
    (3, 144, 16, 3 * 701, 0, 3, 0.5),          # T = 3, alpha < 1
    (2, 256, 32, 16 * 129, 2, 16, 1.0),        # T = 16 at D = 256
)
REPEATS = 300
STREAM = "grouped_tc_stream.cuh"
# the fence before a stage's release (in STREAM): the one at an indent of
# two
FENCE = '\n  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'

_POISON_SRC = r"""
#include <cuda_runtime.h>
// Fill every word of a block's dynamic shared memory with `bits`.
__global__ void smem_poison_kernel(unsigned bits, int words) {
  extern __shared__ unsigned s[];
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s + i));
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(bits) : "memory");
  }
}
extern "C" int smem_poison_launch(unsigned bits, int blocks, void* stream) {
  const int bytes = 232448;  // a block's shared memory on an H100
  cudaError_t err = cudaFuncSetAttribute(
      smem_poison_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  smem_poison_kernel<<<blocks, 1024, bytes, (cudaStream_t)stream>>>(
      bits, bytes / 4);
  return (int)cudaGetLastError();
}
"""

_libs = {}


def _compile(name: str, source: str) -> ctypes.CDLL:
    """Compile `source` (a .cu text) into build/tc_repeat_check/ (kept
    while the text is unchanged) and load it; cached for the process."""
    if name not in _libs:
        out = kernels.BUILD_DIR.parent / "tc_repeat_check"
        out.mkdir(parents=True, exist_ok=True)
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        if not (lib.exists() and src.exists() and src.read_text() == source):
            src.write_text(source)
            run = subprocess.run(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                 str(kernels.CSRC), "-o", str(lib), str(src)],
                capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{run.stdout}"
                                   f"{run.stderr}")
        _libs[name] = ctypes.CDLL(str(lib))
    return _libs[name]


def poison_shared_memory(dev: torch.device) -> None:
    """Fill the shared memory of every SM with NaN (four blocks an SM, one
    resident at a time) on the current stream."""
    lib = _compile("smem_poison", _POISON_SRC)
    lib.smem_poison_launch.argtypes = [ctypes.c_uint, ctypes.c_int,
                                       ctypes.c_void_p]
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    err = lib.smem_poison_launch(0x7FC00000, blocks,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smem poison launch failed: cudaError {err}")


def _without_fence() -> ctypes.CDLL:
    """csrc/grouped_tc_estimate.cu (K14b) with its stream, inlined, without
    the proxy fence before each stage's release."""
    stream = (kernels.CSRC / STREAM).read_text()
    if stream.count(FENCE) != 1:
        raise RuntimeError(f"the fence before a stage's release is not in "
                           f"csrc/{STREAM} as expected")
    entry = (kernels.CSRC / "grouped_tc_estimate.cu").read_text()
    include = f'#include "{STREAM}"\n'
    text = entry.replace(include, stream.replace("#pragma once\n", "")
                         .replace(FENCE, "\n"))
    lib = _compile("grouped_tc_estimate_nofence", text)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_tc_estimate_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.grouped_tc_estimate_launch.restype = i32
    return lib


def random_bank(two_m, two_d, k, dev, n_dead=0, seed=0):
    """A random kernel bank of any widths: logits a few units apart, dead
    components at the -1e30 floor."""
    g = torch.Generator().manual_seed(seed)
    pw = 0.3 * torch.randn(k, two_m, two_m + two_d,
                           generator=g) / math.sqrt(two_m)
    logw = 0.5 * torch.randn(k, generator=g)
    logw[:n_dead] = -1e30
    kb = kernels.KernelBankBlock(pw, 0.3 * torch.randn(k, two_m, generator=g),
                                 torch.randn(k, two_d, generator=g), logw)
    return kernels.KernelBankBlock(*(x.to(dev).contiguous() for x in kb))


def random_rows(n, two_m, dev, seed=1):
    """n rows of +-0.7 (quantized observations' values)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, 2, (n, two_m), generator=g,
                          device=dev).float() - 0.5) * 1.4


def random_karatsuba_bank(m, d, k, dev, n_dead=0, seed=0):
    """A random K14a bank of any widths (M need not reach D): logits a few
    units apart, dead components at the -1e30 floor."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    pc_re, pc_im = (rnd(k, m, m, scale=0.3 / math.sqrt(m)),
                    rnd(k, m, m, scale=0.3 / math.sqrt(m)))
    wt_re, wt_im = (rnd(k, m, d, scale=1 / math.sqrt(m)),
                    rnd(k, m, d, scale=1 / math.sqrt(m)))
    logw = 0.5 * rnd(k)
    logw[:n_dead] = -1e30
    kb = vk.KernelBank(pc_re, pc_im, pc_re + pc_im, wt_re, wt_im,
                       wt_re + wt_im, rnd(k, m, scale=0.3),
                       rnd(k, m, scale=0.3), rnd(k, d), rnd(k, d), logw)
    return vk.KernelBank(*(x.to(dev).contiguous() for x in kb))


def topk_near_ties(lg: torch.Tensor, k_sel: int, gap: float = 1e-3,
                   rel: float = 0.0) -> torch.Tensor:
    """Rows of logits lg (N, K) whose k-th and (k+1)-th largest lie within
    max(gap, rel |k-th|): two float32 sums in another order may order them
    differently. None at k >= K."""
    if k_sel >= lg.shape[1]:
        return torch.zeros(lg.shape[0], dtype=torch.bool, device=lg.device)
    top = lg.topk(k_sel + 1, dim=-1).values
    return (top[:, -2] - top[:, -1]) < torch.clamp(rel * top[:, -2].abs(),
                                                   min=gap)


def _wide_topk_check(dev, shapes, repeats, poison) -> dict:
    """Mode 'wide_topk' of `repeat_check`: {label: {"launches", "failures",
    "max_err"}} over the wide K4 and K5 at `shapes`."""
    out = {}
    for two_m, two_d, k, n, n_dead, k_sel, shift in shapes:
        kb = random_bank(two_m, two_d, k, dev, n_dead)
        if shift:
            kb = kb._replace(logw=torch.cat([kb.logw[:1] + shift,
                                             kb.logw[1:]]))
        ops = kernels.tc_operands(kb)
        r2 = random_rows(n, two_m, dev)
        keep = ~topk_near_ties(kernels.component_logits(r2, kb), k_sel)
        runs = {"K5": lambda: kernels.grouped_estimate_topk_stats_wide(
            r2, kb, k_sel, ops)}
        if k_sel <= k:
            runs["K4"] = lambda: kernels.grouped_estimate_topk_wide(
                r2, kb, k_sel, ops)
            want = kernels.grouped_estimate_topk_reference(r2, kb, k_sel)
        for name, run in runs.items():
            first, errs, fails = None, [], 0
            for _ in range(repeats):
                if poison:
                    poison_shared_memory(dev)
                got = run()
                got = got if isinstance(got, tuple) else (got,)
                if first is None:
                    first = tuple(x.clone() for x in got)
                    err = 0.0
                    if name == "K4":
                        err = float((got[0] - want)[keep].abs().max()
                                    / want.abs().max())
                        fails += not err <= TOL
                    errs.append(err)
                else:
                    fails += not all(torch.equal(x.view(torch.int32),
                                                 y.view(torch.int32))
                                     for x, y in zip(got, first))
                for x in got:       # the next launch's outputs land here
                    x.fill_(math.nan)
                del got
            label = (f"{two_m}/{two_d} K={k} N={n} dead={n_dead} "
                     f"k={k_sel} shift={shift} {name} wide")
            out[label] = {"launches": repeats, "failures": fails,
                          "max_err": max(errs)}
    return out


def _karatsuba_check(dev, shapes, repeats, poison) -> dict:
    """Mode 'karatsuba' of `repeat_check`: {label: {"launches",
    "failures", "max_err"}} over K14a at `shapes`."""
    out = {}
    for m, d, k, n, n_dead in shapes:
        kb = random_karatsuba_bank(m, d, k, dev, n_dead)
        ops = vk.karatsuba_operands(kb) if dev.type == "cuda" else None
        r_re, r_im = random_rows(n, m, dev), random_rows(n, m, dev, seed=2)
        want = torch.cat(vk.reference_estimate_packed(kb, r_re, r_im), -1)
        scale = want.abs().max()
        first, errs, fails = None, [], 0
        for _ in range(repeats):
            if poison:
                poison_shared_memory(dev)
            got = torch.cat(vk.karatsuba_estimate(r_re, r_im, kb, ops), -1)
            err = float((got - want).abs().max() / scale)
            if first is None:
                first = got
            fails += not (torch.equal(got, first) and err <= TOL)  # NaN too
            errs.append(err)
        out[f"M={m} D={d} K={k} N={n} dead={n_dead} karatsuba"] = {
            "launches": repeats, "failures": fails,
            "max_err": max(e if e == e else math.inf for e in errs)}
    return out


def random_fact_bank(d, m, k, dev, n_dead=0, t_coh=1, seed=0):
    """A random factored-kernel bank of any widths: logits a few units
    apart, dead components at the -1e30 floor."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    const = 0.5 * rnd(k)
    const[:n_dead] = -1e30
    fkb = fk.FactKernelBank(
        rnd(k, 2 * d, 4 * m, scale=0.5 / math.sqrt(2 * d)),
        rnd(k, 4 * m, 2 * d, scale=1 / math.sqrt(4 * m)),
        rnd(k, 2 * m, scale=0.3), rnd(k, 3 * d, scale=0.3 / math.sqrt(d)),
        const / t_coh, rnd(k, 2 * d, scale=0.3), rnd(k, 2 * d, scale=0.3))
    return fk.FactKernelBank(*(x.to(dev).contiguous() for x in fkb))


def _fact_check(dev, shapes, repeats, poison, wide=False,
                fused=False) -> dict:
    """Mode 'fact' (with `wide`: 'wide_fact', with `fused`: 'fused_fact')
    of `repeat_check`: {label: {"launches", "failures", "max_err"}} over
    K11, K12 and K13 at `shapes`; with `wide` or `fused`, their wide form or
    the fused K11 / K12, each launch after the NaN fill of the last one's
    outputs, and bit for bit the first launch."""
    out = {}
    bitwise = wide or fused
    for d, m, k, n, n_dead, t, alpha, name in shapes:
        fkb = random_fact_bank(d, m, k, dev, n_dead, t)
        f64 = fk.FactKernelBank(*(x.double() for x in fkb))
        lay = (fk.fact_fused_operands if fused else fk.fact_wide_operands
               if wide else fk.fact_tc_operands)
        ops = lay(fkb) if dev.type == "cuda" else None
        x2 = random_rows(n, 2 * d, dev)
        stats = name == "K13"
        if fused:
            def run():
                if name == "K11":
                    return (fk.fact_estimate_fused(x2, fkb, ops),)
                return (fk.fact_estimate_coherent_fused(x2, fkb, t, alpha,
                                                        ops),)
            want = (fk.fact_fused_reference(x2, fkb, t, alpha),)
        elif wide:
            def run():
                if name == "K11":
                    return (fk.fact_estimate_wide(x2, fkb, ops),)
                if name == "K12":
                    return (fk.fact_estimate_coherent_wide(x2, fkb, t, alpha,
                                                           ops),)
                return fk.fact_estimate_stats_wide(x2, fkb, ops)
            want = fk.fact_wide_reference(x2, fkb, t, alpha, stats)
            want = want if stats else (want,)
        elif name == "K11":
            def run():
                return (fk.fact_estimate(x2, fkb, ops),)
            want = (fk.fact_estimate_reference(x2, fkb),)
        elif name == "K12":
            def run():
                return (fk.fact_estimate_coherent(x2, fkb, t, alpha, ops),)
            want = (fk.fact_estimate_coherent_reference(x2, fkb, t, alpha),)
        else:
            def run():
                return fk.fact_estimate_stats(x2, fkb, ops)
            want = fk.fact_estimate_stats_reference(x2, fkb)
        exact = fk._fact_reference(x2.double(), f64, t, alpha, stats, 8192)
        exact = exact if stats else (exact,)
        scales = [w.abs().max() for w in want]
        plain_errs = [float((w.double() - e).abs().max() / sc)
                      for w, e, sc in zip(want, exact, scales)]
        first, errs, fails = None, [], 0
        for _ in range(repeats):
            if poison:
                poison_shared_memory(dev)
            got = run()
            ok = first is None or all(
                torch.equal(g.view(torch.int32), f.view(torch.int32))
                for g, f in zip(got, first))
            err = 0.0
            for g, w, e, sc, pe in zip(got, want, exact, scales, plain_errs):
                rel = float((g - w).abs().max() / sc)
                rel64 = float((g.double() - e).abs().max() / sc)
                ok = ok and (rel <= TOL or rel64 <= 2 * pe + 1e-5)
                err = max(err, rel if rel == rel else math.inf)
            if first is None:
                first = tuple(g.clone() for g in got) if bitwise else got
            fails += not ok     # NaN fails both comparisons
            errs.append(err)
            if bitwise:         # the next launch's outputs land here
                for g in got:
                    g.fill_(math.nan)
            del got
        out[f"D={d} M={m} K={k} N={n} dead={n_dead} T={t} a={alpha} "
            f"{name}" + (" wide" if wide else " fused" if fused else "")] = {
            "launches": repeats, "failures": fails, "max_err": max(errs)}
    return out


def random_mp_bank(p, d, k, dev, n_dead=0, t_coh=1, seed=0):
    """A random multi-pilot kernel bank of any widths: unitary-scale
    transforms, logits a few units apart, dead components at the -1e30
    floor."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    feat = d * (3 * p + p * (p - 1))
    const = 0.5 * rnd(k)
    const[:n_dead] = -1e30
    ckb = mk.MpCircKernelBank(
        rnd(2 * d, 2 * d, scale=1 / math.sqrt(2 * d)),
        rnd(feat, k, scale=0.3 / math.sqrt(feat)), const / t_coh,
        rnd(p + 1, k, 2 * d, scale=0.5),
        rnd(2 * d, 2 * d, scale=1 / math.sqrt(2 * d)))
    return mk.MpCircKernelBank(*(x.to(dev).contiguous() for x in ckb))


def _mp_check(dev, shapes, repeats, poison, wide=False) -> dict:
    """Mode 'mpcirc' (with `wide`: 'wide_mpcirc') of `repeat_check`:
    {label: {"launches", "failures", "max_err"}} over K10 flat and coherent
    at `shapes`; with `wide`, its wide form, each launch after the NaN fill
    of the last one's output, and bit for bit the first launch."""
    out = {}
    for p, d, k, n, n_dead, t, alpha in shapes:
        ckb = random_mp_bank(p, d, k, dev, n_dead, t)
        f64 = mk.MpCircKernelBank(*(x.double() for x in ckb))
        lay = mk.mp_circ_wide_operands if wide else mk.mp_circ_tc_operands
        ops = lay(ckb) if dev.type == "cuda" else None
        x2 = random_rows(n, 2 * p * d, dev)
        if wide:
            def run():
                if t == 1:
                    return mk.mp_circ_estimate_wide(x2, ckb, ops)
                return mk.mp_circ_estimate_coherent_wide(x2, ckb, t, alpha,
                                                         ops)
            want = mk.mp_circ_wide_reference(x2, ckb, t, alpha)
            exact = mk._mp_reference(x2.double(), f64, t, alpha, 8192)
        elif t == 1:
            def run():
                return mk.mp_circ_estimate(x2, ckb, ops)
            want = mk.mp_circ_estimate_reference(x2, ckb)
            exact = mk.mp_circ_estimate_reference(x2.double(), f64)
        else:
            def run():
                return mk.mp_circ_estimate_coherent(x2, ckb, t, alpha, ops)
            want = mk.mp_circ_estimate_coherent_reference(x2, ckb, t, alpha)
            exact = mk.mp_circ_estimate_coherent_reference(x2.double(), f64,
                                                           t, alpha)
        scale = want.abs().max()
        plain_err = float((want.double() - exact).abs().max() / scale)
        first, errs, fails = None, [], 0
        for _ in range(repeats):
            if poison:
                poison_shared_memory(dev)
            got = run()
            rel = float((got - want).abs().max() / scale)
            rel64 = float((got.double() - exact).abs().max() / scale)
            ok = (first is None or torch.equal(got.view(torch.int32),
                                               first.view(torch.int32))) and (
                rel <= TOL or rel64 <= 2 * plain_err + 1e-5)
            if first is None:
                first = got.clone() if wide else got
            fails += not ok     # NaN fails both comparisons
            errs.append(rel if rel == rel else math.inf)
            if wide:            # the next launch's output lands here
                got.fill_(math.nan)
            del got
        out[f"P={p} D={d} K={k} N={n} dead={n_dead} T={t} a={alpha} K10"
            + (" wide" if wide else "")] = {
            "launches": repeats, "failures": fails, "max_err": max(errs)}
    return out


def random_circ_bank(d, k, dev, n_dead=0, t_coh=1, seed=0):
    """A random circulant kernel bank (`circ_kernels.CircKernelBank`) of
    any widths: unitary-scale transforms, logits a few units apart, dead
    components at the -1e30 floor."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    const = 0.5 * rnd(k)
    const[:n_dead] = -1e30
    ckb = ck.CircKernelBank(
        rnd(2 * d, 2 * d, scale=1 / math.sqrt(2 * d)),
        rnd(3 * d, k, scale=0.3 / math.sqrt(3 * d)), const / t_coh,
        rnd(k, 4 * d, scale=0.5),
        rnd(2 * d, 2 * d, scale=1 / math.sqrt(2 * d)))
    return ck.CircKernelBank(*(x.to(dev).contiguous() for x in ckb))


def _circ_check(dev, shapes, repeats, poison, wide=False) -> dict:
    """Mode 'circ' (with `wide`: 'wide_circ') of `repeat_check`: {label:
    {"launches", "failures", "max_err"}} over K6-K9 at `shapes`; with
    `wide`, each launch after the NaN fill of the last one's outputs, and
    bit for bit the first launch."""
    out = {}
    for d, k, n, n_dead, t, alpha, stats in shapes:
        ckb = random_circ_bank(d, k, dev, n_dead, t)
        f64 = ck.CircKernelBank(*(x.double() for x in ckb))
        ops = None
        if dev.type == "cuda":   # the wide form's own operands past D = 128
            ops = (ck.circ_wide_operands(ckb, stats) if wide
                   else ck.circ_operands(ckb, stats))
        x2 = random_rows(n, 2 * d, dev)
        if t == 1 and not stats:
            name = "K6"
            want = (ck.circ_estimate_reference(x2, ckb),)
            exact = (ck.circ_estimate_reference(x2.double(), f64),)
        elif not stats:
            name = "K7"
            want = (ck.circ_estimate_coherent_reference(x2, ckb, t, alpha),)
            exact = (ck.circ_estimate_coherent_reference(x2.double(), f64, t,
                                                         alpha),)
        elif t == 1:
            name = "K8"
            want = ck.circ_estimate_stats_reference(x2, ckb)
            exact = ck.circ_estimate_stats_reference(x2.double(), f64)
        else:
            name = "K9"
            want = ck.circ_estimate_coherent_stats_reference(x2, ckb, t,
                                                             alpha)
            exact = ck.circ_estimate_coherent_stats_reference(
                x2.double(), f64, t, alpha)

        def run():
            # the wide K6-K9 through their own wrappers: the banks' random
            # transforms are no DFT, which the factorised kernel computes
            # in its stead
            if name == "K6":
                return ((ck.circ_estimate_wide if wide
                         else ck.circ_estimate)(x2, ckb, ops),)
            if name == "K7":
                return ((ck.circ_estimate_coherent_wide if wide
                         else ck.circ_estimate_coherent)(x2, ckb, t, alpha,
                                                         ops),)
            if name == "K8":
                return (ck.circ_estimate_stats_wide if wide
                        else ck.circ_estimate_stats)(x2, ckb, ops)
            return (ck.circ_estimate_coherent_stats_wide if wide
                    else ck.circ_estimate_coherent_stats)(x2, ckb, t, alpha,
                                                          ops)

        scales = [w.abs().max() for w in want]
        plain_errs = [float((w.double() - e).abs().max() / sc)
                      for w, e, sc in zip(want, exact, scales)]
        first, errs, fails = None, [], 0
        for _ in range(repeats):
            if poison:
                poison_shared_memory(dev)
            got = run()
            ok = first is None or all(
                torch.equal(g.view(torch.int32), f.view(torch.int32))
                for g, f in zip(got, first))
            err = 0.0
            for g, w, e, sc, pe in zip(got, want, exact, scales, plain_errs):
                rel = float((g - w).abs().max() / sc)
                rel64 = float((g.double() - e).abs().max() / sc)
                ok = ok and (rel <= TOL or rel64 <= 2 * pe + 1e-5)
                err = max(err, rel if rel == rel else math.inf)
            if first is None:
                first = tuple(g.clone() for g in got) if wide else got
            fails += not ok     # NaN fails both comparisons
            errs.append(err)
            if wide:            # the next launch's outputs land here
                for g in got:
                    g.fill_(math.nan)
            del got
        out[f"D={d} K={k} N={n} dead={n_dead} T={t} a={alpha} {name}"
            + (" wide" if wide else "")] = {
            "launches": repeats, "failures": fails, "max_err": max(errs)}
    return out


def random_dft_bank(d, k, dev, n_dead=0, seed=0):
    """A random `structured_bank.CirculantBank` over D bins (the DFT
    domain's own quantities: log-weights, means, spectra in [0.5, 2],
    filters and biases), dead components at -inf."""
    g = torch.Generator().manual_seed(seed)

    def crnd(scale):
        return scale * torch.complex(torch.randn(k, d, generator=g),
                                     torch.randn(k, d, generator=g))

    lw = torch.log_softmax(torch.randn(k, generator=g), 0)
    lw[:n_dead] = -math.inf
    spec = 0.5 + 1.5 * torch.rand(k, d, generator=g)
    bank = sb.CirculantBank(lw, crnd(0.3), spec, crnd(0.1), crnd(0.05))
    return sb.CirculantBank(*(x.to(dev) for x in bank))


def random_dft_mp_bank(p, d, k, dev, n_dead=0, seed=0):
    """A random `structured_bank.CirculantBankMP` of P pilots over D bins
    (the DFT domain's own quantities: log-weights, per-bin means, per-bin
    P x P precisions I + A A^H / P, log-determinants, filters and biases),
    dead components at -inf."""
    g = torch.Generator().manual_seed(seed)

    def crnd(*shape, scale=1.0):
        return scale * torch.complex(torch.randn(*shape, generator=g),
                                     torch.randn(*shape, generator=g))

    lw = torch.log_softmax(torch.randn(k, generator=g), 0)
    lw[:n_dead] = -math.inf
    a = crnd(k, d, p, p, scale=0.5)
    prec = torch.eye(p, dtype=torch.complex64) + a @ a.mH / p
    logdet = -torch.logdet(prec).real.sum(-1)
    bank = sb.CirculantBankMP(lw, crnd(k, d, p, scale=0.3), prec, logdet,
                              crnd(k, d, p, scale=0.1), crnd(k, d, scale=0.05))
    return sb.CirculantBankMP(*(x.to(dev) for x in bank))


def _fact_circ_check(dev, shapes, repeats, poison) -> dict:
    """Mode 'fact_circ' of `repeat_check`: {label: {"launches",
    "failures", "max_err"}} over the factorised K6-K9 at `shapes` (D, K,
    N, dead components, T, alpha, blocks, stats), each launch after a NaN
    fill of every SM's shared memory and on the memory of the last
    launch's outputs filled with NaN: a launch fails if its bits differ
    from the first launch's, and the first launch under the rule of mode
    'f32' against the plain version `circ_fact_reference` (K8 / K9: each
    of m, den and acc)."""
    out = {}
    for d, k, n, n_dead, t, alpha, blocks, stats in shapes:
        ckb = ck.circ_kernel_bank(random_dft_bank(d, k, dev, n_dead), blocks,
                                  t, alpha)
        f64 = ck.CircKernelBank(*(x.double() for x in ckb))
        ops = ck.circ_fact_operands(ckb, blocks)
        x2 = random_rows(n, 2 * d, dev)
        want = ck.circ_fact_reference(x2, ckb, t, alpha, blocks, stats=stats)
        exact = ck.circ_fact_reference(x2.double(), f64, t, alpha, blocks,
                                       stats=stats)

        def run():
            if stats and t == 1:
                return ck.circ_estimate_stats_fact(x2, ckb, ops)
            if stats:
                return ck.circ_estimate_coherent_stats_fact(x2, ckb, t,
                                                            alpha, ops)
            if t == 1:
                return ck.circ_estimate_fact(x2, ckb, ops)
            return ck.circ_estimate_coherent_fact(x2, ckb, t, alpha, ops)

        name = ("K9" if t > 1 else "K8") if stats else (
            "K7" if t > 1 else "K6")
        out[f"D={d} K={k} N={n} dead={n_dead} T={t} a={alpha}"
            + (f" blocks={blocks}" if blocks else "")
            + f" {name} fact"] = _repeat_bitwise(dev, run, want, exact,
                                                 repeats, poison)
    return out


def _repeat_bitwise(dev, run, want, exact, repeats, poison) -> dict:
    """`repeats` launches of `run`, each after a NaN fill of every SM's
    shared memory (`poison`) and on the memory of the last launch's
    outputs filled with NaN: a launch fails if any output's bits differ
    from the first launch's, or under the rule of mode 'f32' against the
    plain version `want` (`exact`: in float64; a tensor, or a tuple of
    them as `run` returns). -> {"launches", "failures", "max_err"}."""
    def parts(x):
        return x if isinstance(x, tuple) else (x,)

    want, exact = parts(want), parts(exact)
    scales = [w.abs().max() for w in want]
    plain_errs = [float((w.double() - e).abs().max() / sc)
                  for w, e, sc in zip(want, exact, scales)]
    first, errs, fails = None, [], 0
    for _ in range(repeats):
        if poison:
            poison_shared_memory(dev)
        got = parts(run())
        ok = first is None or all(
            torch.equal(g.view(torch.int32), f.view(torch.int32))
            for g, f in zip(got, first))
        err = 0.0
        for g, w, e, sc, pe in zip(got, want, exact, scales, plain_errs):
            rel = float((g - w).abs().max() / sc)
            rel64 = float((g.double() - e).abs().max() / sc)
            ok = ok and (rel <= TOL or rel64 <= 2 * pe + 1e-5)
            err = max(err, rel if rel == rel else math.inf)
        if first is None:
            first = tuple(g.clone() for g in got)
        fails += not ok     # NaN fails both comparisons
        errs.append(err)
        for g in got:       # the next launch's outputs land here
            g.fill_(math.nan)
        del got
    return {"launches": repeats, "failures": fails, "max_err": max(errs)}


def _fact_mpcirc_check(dev, shapes, repeats, poison) -> dict:
    """Mode 'fact_mpcirc' of `repeat_check`: {label: {"launches",
    "failures", "max_err"}} over the factorised K10, flat and coherent, at
    `shapes` (P, D, K, N, dead components, T, alpha, blocks) on random
    DFT-domain multi-pilot banks (`random_dft_mp_bank`), under the rule of
    mode 'fact_circ' against its plain version `mp_circ_fact_reference`."""
    out = {}
    for p, d, k, n, n_dead, t, alpha, blocks in shapes:
        ckb = mk.mp_circ_kernel_bank(random_dft_mp_bank(p, d, k, dev, n_dead),
                                     blocks, t, alpha)
        f64 = mk.MpCircKernelBank(*(x.double() for x in ckb))
        ops = mk.mp_circ_fact_operands(ckb, blocks)
        x2 = random_rows(n, 2 * p * d, dev)
        want = mk.mp_circ_fact_reference(x2, ckb, t, alpha, blocks)
        exact = mk.mp_circ_fact_reference(x2.double(), f64, t, alpha, blocks)

        def run():
            if t == 1:
                return mk.mp_circ_estimate_fact(x2, ckb, ops)
            return mk.mp_circ_estimate_coherent_fact(x2, ckb, t, alpha, ops)

        out[f"P={p} D={d} K={k} N={n} dead={n_dead} T={t} a={alpha}"
            + (f" blocks={blocks}" if blocks else "") + " K10 fact"] = (
                _repeat_bitwise(dev, run, want, exact, repeats, poison))
    return out


def _launch_copy(lib, r2, kb, ops, passes):
    n, two_m = r2.shape
    two_d = kb.b.shape[1]
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    err = lib.grouped_tc_estimate_launch(
        r2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
        ops.vec.data_ptr(), kb.logw.data_ptr(), out.data_ptr(), n,
        kb.mu.shape[0], two_m, two_d, passes,
        torch.cuda.current_stream(r2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy without the fence: cudaError {err}")
    return out


def _f32_runs(shape, dev):
    """K1 (T = 1) or K3 at an F32_SHAPES entry: (label, launch, plain
    output, float64 plain output)."""
    two_m, two_d, k, n, n_dead, t, alpha = shape
    kb = random_bank(two_m, two_d, k, dev, n_dead)
    kb64 = kernels.KernelBankBlock(*(x.double() for x in kb))
    ops = kernels.tc_operands(kb)
    r2 = random_rows(n, two_m, dev)
    label = (f"{two_m}/{two_d} K={k} N={n} dead={n_dead} T={t} a={alpha} "
             + ("wide" if kernels.wide_form(two_m, two_d) else "f32"))
    if t == 1:
        return (label, lambda: kernels.grouped_estimate(r2, kb, ops),
                kernels.grouped_estimate_reference(r2, kb),
                kernels.grouped_estimate_reference(r2.double(), kb64))
    return (label,
            lambda: kernels.grouped_estimate_coherent(r2, kb, t, alpha, ops),
            kernels.grouped_estimate_coherent_reference(r2, kb, t, alpha),
            kernels.grouped_estimate_coherent_reference(r2.double(), kb64, t,
                                                        alpha))


def _f32_check(dev, shapes, repeats, poison) -> dict:
    """Mode 'f32' of `repeat_check`: {label: {"launches", "failures",
    "max_err"}} over K1 and K3 at `shapes`."""
    out = {}
    for shape in shapes:
        label, run, want, exact = _f32_runs(shape, dev)
        scale = want.abs().max()
        plain_err = float((want.double() - exact).abs().max() / scale)
        first, errs, fails = None, [], 0
        for _ in range(repeats):
            if poison:
                poison_shared_memory(dev)
            got = run()
            err = float((got - want).abs().max() / scale)
            err64 = float((got.double() - exact).abs().max() / scale)
            if first is None:
                first = got
            ok = (torch.equal(got, first)
                  and (err <= TOL or err64 <= 2 * plain_err + 1e-5))
            fails += not ok     # NaN fails both comparisons
            errs.append(err)
        out[label] = {"launches": repeats, "failures": fails,
                      "max_err": max(e if e == e else math.inf
                                     for e in errs)}
    return out


def repeat_check(dev, shapes=SHAPES, repeats=REPEATS, poison=True,
                 without_fence=False, modes=tuple(vk.TC_WRAPPERS),
                 f32_shapes=F32_SHAPES,
                 wide_shapes=WIDE_SHAPES,
                 wide_topk_shapes=WIDE_TOPK_SHAPES,
                 karatsuba_shapes=KARATSUBA_SHAPES,
                 fact_shapes=FACT_SHAPES,
                 mpcirc_shapes=MPCIRC_SHAPES,
                 circ_shapes=CIRC_SHAPES,
                 wide_circ_shapes=WIDE_CIRC_SHAPES,
                 wide_mpcirc_shapes=WIDE_MPCIRC_SHAPES,
                 wide_fact_shapes=WIDE_FACT_SHAPES,
                 fused_fact_shapes=FUSED_FACT_SHAPES,
                 fact_circ_shapes=FACT_CIRC_SHAPES,
                 fact_mpcirc_shapes=FACT_MPCIRC_SHAPES) -> dict:
    """Every (shape, mode): `repeats` launches of K14b (and of the copy
    without the fence), each held against the plain version; mode 'f32':
    K1 and K3 at `f32_shapes`; mode 'wide': their wide form at
    `wide_shapes`; mode 'wide_topk': the wide K4 and K5 at
    `wide_topk_shapes`; mode 'karatsuba': K14a at
    `karatsuba_shapes`; mode 'fact': K11-K13 at `fact_shapes`; mode
    'mpcirc': K10 at `mpcirc_shapes`; mode 'circ': K6-K9 at
    `circ_shapes`; mode 'wide_circ': their wide form at
    `wide_circ_shapes`; mode 'wide_mpcirc': K10's wide form at
    `wide_mpcirc_shapes`; mode 'wide_fact': K11-K13's wide form at
    `wide_fact_shapes`; mode 'fused_fact': the fused K11 / K12 at
    `fused_fact_shapes`; mode 'fact_circ': the factorised K6-K9 at
    `fact_circ_shapes`; mode 'fact_mpcirc': the factorised K10 at
    `fact_mpcirc_shapes`. Returns
    {"kernel" (and "no fence"): {label: {"launches", "failures",
    "max_err"}}}."""
    copy = _without_fence() if without_fence else None
    result = {"kernel": {}, "no fence": {}} if copy else {"kernel": {}}
    if "f32" in modes:
        result["kernel"].update(_f32_check(dev, f32_shapes, repeats, poison))
    if "wide" in modes:
        result["kernel"].update(_f32_check(dev, wide_shapes, repeats, poison))
    if "wide_topk" in modes:
        result["kernel"].update(_wide_topk_check(dev, wide_topk_shapes,
                                                 repeats, poison))
    if "karatsuba" in modes:
        result["kernel"].update(_karatsuba_check(dev, karatsuba_shapes,
                                                 repeats, poison))
    if "fact" in modes:
        result["kernel"].update(_fact_check(dev, fact_shapes, repeats,
                                            poison))
    if "mpcirc" in modes:
        result["kernel"].update(_mp_check(dev, mpcirc_shapes, repeats,
                                          poison))
    if "circ" in modes:
        result["kernel"].update(_circ_check(dev, circ_shapes, repeats,
                                            poison))
    if "wide_circ" in modes:
        result["kernel"].update(_circ_check(dev, wide_circ_shapes, repeats,
                                            poison, wide=True))
    if "wide_mpcirc" in modes:
        result["kernel"].update(_mp_check(dev, wide_mpcirc_shapes, repeats,
                                          poison, wide=True))
    if "wide_fact" in modes:
        result["kernel"].update(_fact_check(dev, wide_fact_shapes, repeats,
                                            poison, wide=True))
    if "fused_fact" in modes:
        result["kernel"].update(_fact_check(dev, fused_fact_shapes, repeats,
                                            poison, fused=True))
    if "fact_circ" in modes:
        result["kernel"].update(_fact_circ_check(dev, fact_circ_shapes,
                                                 repeats, poison))
    if "fact_mpcirc" in modes:
        result["kernel"].update(_fact_mpcirc_check(dev, fact_mpcirc_shapes,
                                                   repeats, poison))
    modes = [m for m in modes
             if m not in ("f32", "wide", "wide_topk", "karatsuba", "fact",
                          "mpcirc", "circ", "wide_circ", "wide_mpcirc",
                          "wide_fact", "fused_fact", "fact_circ",
                          "fact_mpcirc")]
    for two_m, two_d, k, n, n_dead in shapes if modes else ():
        kb = random_bank(two_m, two_d, k, dev, n_dead)
        planes = kernels.split_planes(kb.pw)
        ops = kernels.tc_operands(kb)
        r2 = random_rows(n, two_m, dev)
        for mode in modes:
            wrapper, passes = vk.TC_WRAPPERS[mode], vk.MODES[mode]
            want = vk.grouped_tc_estimate_reference(r2, kb, planes, passes)
            scale = want.abs().max()
            runs = {"kernel": lambda: wrapper(r2, kb, planes, ops)}
            if copy:
                runs["no fence"] = lambda: _launch_copy(copy, r2, kb, ops,
                                                        passes)
            errs = {name: [] for name in runs}
            for _ in range(repeats):
                for name, run in runs.items():
                    if poison:
                        poison_shared_memory(dev)
                    errs[name].append((run() - want).abs().max() / scale)
            label = f"{two_m}/{two_d} K={k} N={n} dead={n_dead} {mode}"
            for name, e in errs.items():
                e = torch.stack(e).cpu()
                bad = ~(e <= TOL)   # NaN fails
                result[name][label] = {
                    "launches": len(e), "failures": int(bad.sum()),
                    "max_err": float(e.nan_to_num(float("inf")).max())}
    return result


def time_fence(dev, n=131072, two_m=128, two_d=128, k=64) -> dict:
    """ms of K14b and of the copy without the fence, per mode, at these
    widths: {mode: [kernel, copy, copy, kernel]}."""
    copy = _without_fence()
    kb = random_bank(two_m, two_d, k, dev)
    planes = kernels.split_planes(kb.pw)
    ops = kernels.tc_operands(kb)
    r2 = random_rows(n, two_m, dev)
    out = {}
    for mode, wrapper in vk.TC_WRAPPERS.items():
        passes = vk.MODES[mode]
        runs = [lambda: wrapper(r2, kb, planes, ops),
                lambda: _launch_copy(copy, r2, kb, ops, passes)]
        out[mode] = [profiling.device_ms(runs[i], reps=10)
                     for i in (0, 1, 1, 0)]
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None)
    p.add_argument("--repeats", type=int, default=REPEATS)
    p.add_argument("--modes", nargs="+",
                   default=[*vk.TC_WRAPPERS, "f32", "wide", "wide_topk",
                            "karatsuba", "fact", "mpcirc", "circ",
                            "wide_circ", "wide_mpcirc", "wide_fact",
                            "fused_fact", "fact_circ", "fact_mpcirc"],
                   choices=[*vk.TC_WRAPPERS, "f32", "wide", "wide_topk",
                            "karatsuba", "fact", "mpcirc", "circ",
                            "wide_circ", "wide_mpcirc", "wide_fact",
                            "fused_fact", "fact_circ", "fact_mpcirc"])
    p.add_argument("--no-poison", action="store_true")
    p.add_argument("--without-proxy-fence", action="store_true")
    p.add_argument("--time", action="store_true")
    args = p.parse_args(argv)
    dev = stages.resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("tc_repeat_check needs an NVIDIA card")
    t0 = time.time()
    result = repeat_check(dev, repeats=args.repeats,
                          poison=not args.no_poison,
                          without_fence=args.without_proxy_fence,
                          modes=tuple(args.modes))
    times = (time_fence(dev) if args.time and args.without_proxy_fence
             else None)
    torch.cuda.synchronize()
    for mode, ms in (times or {}).items():
        print(f"{mode}: kernel {ms[0]:.3f} / {ms[3]:.3f} ms, without the "
              f"fence {ms[1]:.3f} / {ms[2]:.3f} ms")
    for name, rows in result.items():
        for label, rec in rows.items():
            print(f"{name:9s} {label:52s} launches {rec['launches']:5d} "
                  f"failures {rec['failures']:4d} max err "
                  f"{rec['max_err']:.3e}")
    print(json.dumps({"seconds": time.time() - t0,
                      "poison": not args.no_poison,
                      "device": torch.cuda.get_device_name(dev),
                      "ms": times, "result": result}))
    return result


if __name__ == "__main__":
    res = main()
    sys.exit(1 if any(r["failures"] for r in res["kernel"].values()) else 0)
