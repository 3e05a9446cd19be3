"""Hand-written CUDA kernels of the estimation path and their plain versions.

Port of `quantized_channel_estimation_tpu/estimators/pallas_kernels.py`,
dense-bank part: the block-GEMM bank layout (`KernelBankBlock`,
`_cplx_block`, `kernel_bank_block`, with the coherent log-weight divisor),
`merge_stats`, `merge_topk`, and five kernels written in CUDA C++ for
`sm_90a`:

- K1, the 'all'-mode grouped online-softmax estimator (`_grouped_stream` +
  `_estimate_kernel_block_grouped`, entry `estimate_fused`), and
- K3, its coherent mode pooling each component's logits over the T rows of
  a coherence block with the alpha blend (entry `estimate_fused_coherent`),
  both in `csrc/grouped_estimate.cu` on the wgmma stream of
  `csrc/grouped_tc_stream.cuh`: each product r2 pw_k as six bf16
  tensor-core products of three-plane splits of r2 and the bank
  (`split_planes3`), accumulated in fp32, which keeps fp32's accuracy; the
  bank's planes are laid out once in the kernel's shared-memory layout
  (`tc_operands`, cached beside the bank by `lowered_tc`);
- K2, the split-K stats form of K1 and K3
  (`_estimate_kernel_block_grouped_stats`, entries `estimate_fused_stats`
  and `estimate_fused_coherent_stats`): the
  un-normalised online-softmax state (m, den, acc) of a component shard,
  which `merge_stats` merges exactly, in the same file (`STATS`);
- the wide form of K1, K2 and K3 (`csrc/grouped_wide_estimate.cu`, the
  wrappers `grouped_estimate_wide` and its coherent and stats siblings),
  which the same wrappers launch past the stream's widths (2M or 2D >
  256, up to 2M = 2048, any 2D; `fused_kernel_eligible`): the same six
  bf16 products, cut into 64-deep contraction chunks, in two passes (the
  logits, then the value half split over column slices), where JAX runs
  its split-K chunked kernel K2 (`estimate_block_grouped_chunked`);
- K4, the top-k selection estimator (`_grouped_stream_topk` +
  `_estimate_kernel_block_grouped_topk`, entry `estimate_fused_topk`) in
  `csrc/grouped_topk.cu`, and K5, its split-K stats form
  (`_estimate_kernel_block_grouped_topk_stats`, entry
  `estimate_fused_topk_stats`): a shard's top-k candidates, which
  `merge_topk` merges exactly; past 2M, 2D <= 256 the same wrappers launch
  their wide form (`csrc/grouped_wide_estimate.cu`, the wrappers
  `grouped_estimate_topk_wide` and `grouped_estimate_topk_stats_wide`):
  the wide K1's row split and logit pass, the picks bucketed by component
  on the card, and the six bf16 products of the picked rows with their
  W_j alone.

K2 and K5 serve banks split over the component axis across ranks
(`parallel.mesh`); on one card K1, K3 and K4 stream any K in one launch.

The circulant kernels K6-K9 and the multi-pilot circulant kernel K10 (one
template, `csrc/mp_circ_estimate.cu`; past D = 128 K6-K9's wide form,
`csrc/circ_wide_estimate.cu`), the factored (MFA)
kernels K11-K13 (`csrc/fact_estimate.cu`; past D = 128 or M = 64 their
wide form, `csrc/fact_wide_estimate.cu`), the Karatsuba and tensor-core
variants of K1, K14a and K14b (`csrc/karatsuba_estimate.cu`,
`csrc/grouped_tc_estimate.cu`), and the floor probe K15
(`csrc/floor_probe.cu`, which compiles K1's stream) have their layouts,
plain versions and wrappers in the siblings `circ_kernels`,
`mp_circ_kernels`, `fact_kernels`, `variant_kernels` and
`tools.kernel_floor_probe`; they are built, bound and counted by this
module (`build`, `_library`, `register_wrappers`). K14b and K15 share K1's
stream and its `tc_operands`.

Rows of coherence blocks are laid out block-major (the T rows of a block
consecutive); the TPU's T-major re-layout served its sublane tiling and has
no counterpart here.

The CUDA sources are compiled with `nvcc` into shared libraries with a plain
C interface at first use, under `build/torch_kernels/` beside the package,
and bound with ctypes. A wrapper launches its kernel on a CUDA tensor (or
raises) and takes the plain PyTorch version only for a tensor on the CPU;
there is no fallback. Each wrapper counts its launches in a `launches`
attribute.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from quantized_channel_estimation_torch.models import gmm_estimator
from quantized_channel_estimation_torch.models.gmm_estimator import (
    PreparedBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
TC_MAX_WIDTH = 256      # 2M and 2D of the wgmma stream (grouped_estimate.cu)
#                         and of K4 / K5's narrow form (grouped_topk.cu)
WIDE_MAX_TWO_M = 2048   # 2M of the wide form (grouped_wide_estimate.cu)
TOPK_KERNEL_MAX = 8  # K4's top-k slots a row
# scratch bytes of one launch of a wide form that keeps its intermediates
# in global memory (the wide top-k of csrc/grouped_wide_estimate.cu, the
# wide circulant kernels of csrc/circ_wide_estimate.cu, the wide factored
# kernels of csrc/fact_wide_estimate.cu); a wrapper cuts
# larger row counts into launches of at most this much
WIDE_SCRATCH = 1 << 30

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build(names=None) -> Dict[str, str]:
    """Compile csrc/<name>.cu -> build/torch_kernels/lib<name>.so for every
    named source (all of csrc/ by default), one `nvcc` per source, all
    started together. Sources whose library is newer than the source and
    every csrc/*.cuh header are skipped. Returns each compiled source's
    compiler output (register and shared-memory use from `-Xptxas -v`);
    raises if any compile fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = max((p.stat().st_mtime for p in CSRC.glob("*.cuh")), default=0)
    procs = {}
    for name in names:
        src, lib = CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
        if lib.exists() and lib.stat().st_mtime >= max(src.stat().st_mtime,
                                                       headers):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    if name not in _libs:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _declare(name, lib)
        _libs[name] = lib
    return _libs[name]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "grouped_estimate":
        lib.grouped_estimate_launch.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.grouped_estimate_launch.restype = i32
        lib.grouped_estimate_coherent_launch.argtypes = (
            [ptr] * 7 + [i32] * 5 + [f32, ptr])
        lib.grouped_estimate_coherent_launch.restype = i32
        lib.grouped_estimate_stats_launch.argtypes = (
            [ptr] * 9 + [i32] * 4 + [ptr])
        lib.grouped_estimate_stats_launch.restype = i32
        lib.grouped_estimate_coherent_stats_launch.argtypes = (
            [ptr] * 9 + [i32] * 5 + [f32, ptr])
        lib.grouped_estimate_coherent_stats_launch.restype = i32
    elif name == "grouped_wide_estimate":
        lib.grouped_wide_launch.argtypes = [ptr] * 11 + [i32] * 5 + [
            f32, i32, ptr]
        lib.grouped_wide_launch.restype = i32
        lib.grouped_wide_split_launch.argtypes = [ptr] * 2 + [i32] * 3 + [ptr]
        lib.grouped_wide_split_launch.restype = i32
        lib.grouped_wide_topk_launch.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
        lib.grouped_wide_topk_launch.restype = i32
    elif name == "grouped_topk":
        lib.grouped_topk_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.grouped_topk_launch.restype = i32
        lib.grouped_topk_stats_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.grouped_topk_stats_launch.restype = i32
    elif name == "circ_wide_estimate":
        lib.circ_wide_launch.argtypes = [ptr] * 12 + [i32] * 5 + [
            f32, i32, ptr]
        lib.circ_wide_launch.restype = i32
        lib.mp_circ_wide_launch.argtypes = [ptr] * 10 + [i32] * 6 + [
            f32, ptr]
        lib.mp_circ_wide_launch.restype = i32
        lib.circ_wide_features_launch.argtypes = [ptr] * 2 + [i32] * 3 + [
            ptr]
        lib.circ_wide_features_launch.restype = i32
    elif name == "circ_fact_estimate":
        lib.circ_fact_launch.argtypes = [ptr] * 9 + [i32] * 5 + [
            ctypes.c_longlong, i32, f32, i32, i32, ptr]
        lib.circ_fact_launch.restype = i32
    elif name == "mp_circ_fact_estimate":
        lib.mp_circ_fact_launch.argtypes = [ptr] * 7 + [i32] * 6 + [
            ctypes.c_longlong, i32, f32, ptr]
        lib.mp_circ_fact_launch.restype = i32
        lib.mp_circ_fact_plan.argtypes = [i32] * 5 + [ptr]
        lib.mp_circ_fact_plan.restype = ctypes.c_longlong
    elif name == "mp_circ_estimate":
        lib.mp_circ_estimate_launch.argtypes = (
            [ptr] * 8 + [i32] * 6 + [f32, i32, ptr])
        lib.mp_circ_estimate_launch.restype = i32
    elif name == "fact_estimate":
        lib.fact_estimate_launch.argtypes = (
            [ptr] * 9 + [i32] * 5 + [f32, i32, ptr])
        lib.fact_estimate_launch.restype = i32
    elif name == "fact_fused_estimate":
        lib.fact_fused_launch.argtypes = [ptr] * 7 + [i32] * 5 + [f32, ptr]
        lib.fact_fused_launch.restype = i32
    elif name == "fact_wide_estimate":
        lib.fact_wide_launch.argtypes = [ptr] * 15 + [i32] * 6 + [
            f32, i32, ptr]
        lib.fact_wide_launch.restype = i32
    elif name == "karatsuba_estimate":
        lib.karatsuba_estimate_launch.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        lib.karatsuba_estimate_launch.restype = i32
    elif name == "grouped_tc_estimate":
        lib.grouped_tc_estimate_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.grouped_tc_estimate_launch.restype = i32
    elif name == "floor_probe":
        lib.floor_probe_launch.argtypes = (
            [ptr] * 7 + [i32] * 5 + [ptr, i32, ptr])
        lib.floor_probe_launch.restype = i32


def fused_kernel_eligible(d: int, m: int) -> bool:
    """Can the dense estimation kernels K1-K3 (and K2) take a bank of
    channel dim D and observation dim M? 2M <= `WIDE_MAX_TWO_M` (2048), any
    D and K: the wgmma stream up to 2M, 2D <= 256, its wide form past it
    (`wide_form`). A rule of the shapes, decided before any launch; past it
    the stages take the einsum estimator. It admits every (M, D, K, T) for
    which JAX's `estimate_fused`, `estimate_fused_stats` and
    `estimate_fused_coherent` run a Pallas kernel: 4 2M (2M + 2D) bytes a
    component, K of them within 13 MiB for the whole bank or four within
    the 8-10 MiB chunk budget (`pallas_kernels.py:1043-1060`), so 2M <=
    1842 at K = 1 and <= 922 from K = 4.
    K4 / K5 take the same widths (`topk_width_eligible`)."""
    return 1 <= 2 * m <= WIDE_MAX_TWO_M and d >= 1


def wide_form(two_m: int, two_d: int) -> bool:
    """Does a launch at these widths take the wide form
    (`csrc/grouped_wide_estimate.cu`)? Past the stream's 2M, 2D <= 256, for
    K1-K3 and K4 / K5 alike."""
    return two_m > TC_MAX_WIDTH or two_d > TC_MAX_WIDTH


def topk_width_eligible(d: int, m: int) -> bool:
    """Can the top-k kernels K4 / K5 take a bank of channel dim D and
    observation dim M? The dense kernels' widths (`fused_kernel_eligible`:
    2M <= 2048, any D and K): `csrc/grouped_topk.cu` up to 2M, 2D <= 256,
    the wide form past it (`wide_form`). It admits every (D, K, M, k) for
    which JAX's `topk_mode_eligible` runs a Pallas kernel: K 4 2M (2M +
    2D) bytes within 13 MiB for the whole bank, or chunks of four within
    the 8-10 MiB budget (`pallas_kernels.py:764-780`)."""
    return fused_kernel_eligible(d, m)


def tile_rows(two_m: int, two_d: int) -> int:
    """Rows of one consumer warpgroup's tile of the K1 / K3 stream at these
    widths (csrc/grouped_tc_stream.cuh: 64 at every width), the largest
    coherence block K3 pools: every T the fp32 stream took (64 rows while
    2M, 2D <= 128, else 32) and more."""
    return 64


# ---------------------------------------------------------------------------
# bank layout
# ---------------------------------------------------------------------------

class KernelBankBlock(NamedTuple):
    """PreparedBank in the real block layout of the estimation kernels.

    Each complex matrix B is embedded as the real 2x2 block
    [[B_re, B_im], [-B_im, B_re]], so with r2 = [r_re | r_im] (N, 2M),
    r2 @ Bblk = [Re(r B) | Im(r B)]. Per component the precision block
    (2M, 2M) and the filter block (2M, 2D) are concatenated column-wise.

    pw:   (K, 2M, 2M+2D)  [Pblk | Wblk], Pblk from conj(P_k), Wblk from W_k^T
    mu:   (K, 2M)         [Re mu~ | Im mu~], mu~_k = means_r_k @ conj(P_k)
    b:    (K, 2D)         [Re bias | Im bias]
    logw: (K,)            log weights (divided by 1 - a + a T for the
                          coherent kernel) + 2 sum log diag(P_k), floored
                          at -1e30
    """
    pw: torch.Tensor
    mu: torch.Tensor
    b: torch.Tensor
    logw: torch.Tensor


def _cplx_block(b: torch.Tensor) -> torch.Tensor:
    """(..., M, P) complex -> (..., 2M, 2P) real [[re, im], [-im, re]]."""
    top = torch.cat([b.real, b.imag], dim=-1)
    bot = torch.cat([-b.imag, b.real], dim=-1)
    return torch.cat([top, bot], dim=-2)


def kernel_bank_block(bank: PreparedBank, t_coh: int = 1,
                      coh_alpha: float = 1.0) -> KernelBankBlock:
    """Lower a PreparedBank to the kernel layout. Dead components carry
    log-weight -inf; the -1e30 floor keeps the online softmax exact (their
    exp underflows to 0 as soon as a live logit appears).

    t_coh > 1 lays the bank out for the coherent kernel K3, whose logit of
    a row is (1-a) lg_row + a sum_T lg over the row's block: the mixture
    log-weight is divided by that blend's coefficient 1 - a + a T so that it
    enters once per block, while the log-det term counts once per
    snapshot."""
    pin_fp32()
    pc = bank.prec_chol_r.conj()                           # (K, M, M)
    mu = torch.matmul(bank.means_r[:, None, :], pc)[:, 0]  # (K, M)
    wt = bank.filters.transpose(-1, -2)                    # (K, M, D)
    diag = torch.diagonal(bank.prec_chol_r, dim1=-2, dim2=-1).real
    lw_div = (1.0 - coh_alpha + coh_alpha * t_coh) if t_coh > 1 else 1.0
    logw = torch.clamp(bank.log_weights / lw_div
                       + 2.0 * torch.log(diag).sum(-1), min=-1e30)
    pw = torch.cat([_cplx_block(pc), _cplx_block(wt)], dim=-1)
    f32 = torch.float32
    return KernelBankBlock(
        pw.to(f32).contiguous(),
        torch.cat([mu.real, mu.imag], dim=-1).to(f32).contiguous(),
        torch.cat([bank.bias.real, bank.bias.imag], dim=-1).to(f32)
        .contiguous(),
        logw.to(f32).contiguous())


def lowered(bank: PreparedBank, cache: Optional[dict] = None,
            t_coh: int = 1, coh_alpha: float = 1.0) -> KernelBankBlock:
    """`kernel_bank_block(bank, t_coh, coh_alpha)`, kept in `cache` (a dict
    the caller holds beside the bank) under (T, alpha), so a bank served
    many times is lowered once per layout. K1 and K4 share the T = 1
    layout."""
    key = (1, 1.0) if t_coh <= 1 else (int(t_coh), float(coh_alpha))
    if cache is None:
        return kernel_bank_block(bank, *key)
    if key not in cache:
        cache[key] = kernel_bank_block(bank, *key)
    return cache[key]


# ---------------------------------------------------------------------------
# the tensor-core layout of the bank (K1-K3, K14b, K15)
# ---------------------------------------------------------------------------

def split_planes(pw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pw float32 -> (pw_hi, pw_lo) bfloat16: pw_hi = bf16(pw), pw_lo =
    bf16(pw - pw_hi), both rounded to nearest even, as JAX splits its bank
    (`estimate_packed_block_grouped`)."""
    hi = pw.to(torch.bfloat16)
    return hi.contiguous(), (pw - hi.to(torch.float32)).to(
        torch.bfloat16).contiguous()


def split_planes3(x: torch.Tensor):
    """x float32 -> (hi, lo, lo2) bfloat16, each rounded to nearest even:
    hi, lo = `split_planes(x)` and lo2 = bf16(x - hi - lo), so that hi + lo
    + lo2 = x exactly for normal x (8 + 8 + 8 significand bits). The planes
    of K1's six products."""
    hi, lo = split_planes(x)
    rest = (x - hi.to(torch.float32)) - lo.to(torch.float32)
    return hi, lo, rest.to(torch.bfloat16).contiguous()


TC_PIECE = 64   # columns a piece, contraction rows a swizzle chunk


def _tc_columns(two_m: int, two_d: int) -> torch.Tensor:
    """The column of pw behind each column of the stream's pieces: the
    logit half [0, 2M) in ceil(2M / 64) pieces, then the value half
    [2M, 2M + 2D) in ceil(2D / 64), each padded with -1 (a zero column) to
    64."""
    mp, dp = -(-two_m // TC_PIECE), -(-two_d // TC_PIECE)
    cols = torch.full(((mp + dp) * TC_PIECE,), -1, dtype=torch.long)
    cols[:two_m] = torch.arange(two_m)
    cols[mp * TC_PIECE:mp * TC_PIECE + two_d] = two_m + torch.arange(two_d)
    return cols


def _sw128(x: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of rows of 64 bf16 values (..., rows, 64): row
    r's 16-byte chunk c moves to chunk c ^ (r % 8). Its own inverse."""
    rows = x.shape[-2]
    chunk = (torch.arange(rows, device=x.device)[:, None] % 8
             ^ torch.arange(8, device=x.device)[None, :])
    y = x.reshape(*x.shape[:-1], 8, 8)
    idx = chunk[:, :, None].expand(*y.shape)
    return torch.gather(y, -2, idx).reshape(x.shape)


def tc_slab(plane: torch.Tensor, two_m: int) -> torch.Tensor:
    """One bf16 plane of the bank (K, 2M, 2M + 2D) in the stream's B layout
    (csrc/grouped_tc_stream.cuh): (K, mp + dp, Kp / 64, 64, 64), per
    component and piece of 64 columns (`_tc_columns`) its transpose,
    Kp = 2M rounded up to 64 contraction rows in chunks of 64, each chunk
    64 columns x 64 rows in the 128-byte swizzle (`_sw128`); padding
    columns and rows are zero. One (component, piece) is one contiguous run
    the kernel copies into shared memory as it is."""
    k_comp, _, s_cols = plane.shape
    cols = _tc_columns(two_m, s_cols - two_m).to(plane.device)
    n_ch = -(-two_m // TC_PIECE)
    pieces = cols.numel() // TC_PIECE
    padded = torch.cat([plane, plane.new_zeros(k_comp, two_m, 1)], -1)
    x = padded[:, :, torch.where(cols < 0, s_cols, cols)]
    x = torch.cat([x, x.new_zeros(k_comp, n_ch * TC_PIECE - two_m,
                                  x.shape[-1])], 1)       # (K, Kp, P 64)
    x = x.reshape(k_comp, n_ch, TC_PIECE, pieces, TC_PIECE).permute(
        0, 3, 1, 4, 2)                                    # (K, P, ch, n, k)
    return _sw128(x).contiguous()


def tc_vectors(kb: KernelBankBlock) -> torch.Tensor:
    """mu and b in the stream's pieces: (K, mp + dp, 64) float32, per
    component the values of each piece's columns (`_tc_columns`: mu_k over
    the logit pieces, b_k over the value pieces), padding zero."""
    k_comp, two_m = kb.mu.shape
    two_d = kb.b.shape[1]
    cols = _tc_columns(two_m, two_d).to(kb.mu.device)
    both = torch.cat([kb.mu, kb.b, kb.mu.new_zeros(k_comp, 1)], 1)
    return both[:, torch.where(cols < 0, two_m + two_d, cols)].reshape(
        k_comp, -1, TC_PIECE).contiguous()


class TcOperands(NamedTuple):
    """The bank as the wgmma stream reads it: its bf16 planes hi, lo, lo2
    (`split_planes3`) in the B layout (`tc_slab`; K14b reads hi and lo,
    K1-K3 and K15 all three) and mu and b by piece (`tc_vectors`). The
    same for every (T, alpha) layout of a bank: they differ in logw only,
    which the kernels read from the layout."""
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor
    vec: torch.Tensor


def tc_operands(kb: KernelBankBlock, planes=None) -> TcOperands:
    """The stream's operands of kb: its three bf16 planes (`planes`,
    default `split_planes3(kb.pw)`) in the B layout, and mu and b by
    piece."""
    if planes is None:
        planes = split_planes3(kb.pw)
    two_m = kb.mu.shape[1]
    return TcOperands(*(tc_slab(p, two_m) for p in planes), tc_vectors(kb))


def _cached_tc(kb: KernelBankBlock, cache: Optional[dict]):
    """(planes, operands) of kb's bank: `split_planes3(kb.pw)` and their
    `tc_operands`, kept in `cache` ("bf16_planes", "tc_operands"), so a
    bank served many times is split and laid out once, for every (T,
    alpha) layout and for K1-K3, K14b and K15 alike."""
    if cache is None:
        planes = split_planes3(kb.pw)
        return planes, tc_operands(kb, planes)
    if "bf16_planes" not in cache:
        cache["bf16_planes"] = split_planes3(kb.pw)
    if "tc_operands" not in cache:
        cache["tc_operands"] = tc_operands(kb, cache["bf16_planes"])
    return cache["bf16_planes"], cache["tc_operands"]


def lowered_tc(bank: PreparedBank, cache: Optional[dict] = None):
    """(kb, planes, operands): the T = 1 layout of the bank (`lowered`),
    its three bf16 planes and their `tc_operands`, all kept in `cache`."""
    kb = lowered(bank, cache)
    return (kb, *_cached_tc(kb, cache))


def _launch_ops(kb: KernelBankBlock, r: torch.Tensor,
                cache: Optional[dict]) -> Optional[TcOperands]:
    """The operands an entry hands its wrapper: the cached `tc_operands`
    for observations on a card, None on the CPU (the plain versions read
    kb alone)."""
    return _cached_tc(kb, cache)[1] if r.is_cuda else None


def _r2(r: torch.Tensor) -> torch.Tensor:
    """Complex observations (..., M) -> float32 rows [re | im] (n, 2M)."""
    r2 = torch.cat([r.real, r.imag], dim=-1).to(torch.float32)
    return r2.reshape(-1, r2.shape[-1]).contiguous()


def _h(h2: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """float32 rows [re | im] (n, 2D) -> complex (n, D) of `dtype`."""
    return torch.complex(h2[:, :d], h2[:, d:]).to(dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _flat_bank(kb: KernelBankBlock) -> torch.Tensor:
    """pw (K, 2M, S) -> (2M, K S): one GEMM gives every component's yz."""
    k_comp, two_m, s_cols = kb.pw.shape
    return kb.pw.permute(1, 0, 2).reshape(two_m, k_comp * s_cols)


def logits_and_estimates(yz: torch.Tensor, kb: KernelBankBlock):
    """The kernels' epilogue on the products yz (n, K, 2M+2D) = r2 pw_k:
    the logits lg (n, K) = logw - |yz[..., :2M] - mu_k|^2 and the
    per-component estimates z (n, K, 2D) = yz[..., 2M:] + b_k."""
    two_m = kb.mu.shape[1]
    dy = yz[..., :two_m] - kb.mu[None]
    return kb.logw[None] - (dy * dy).sum(-1), yz[..., two_m:] + kb.b[None]


def _stream_reference(r2: torch.Tensor, kb: KernelBankBlock,
                      flat: torch.Tensor):
    """What the kernels' stream computes for rows r2 (n, 2M): the logits
    lg (n, K) = logw - |r2 P_k - mu_k|^2 and the per-component estimates
    z (n, K, 2D) = r2 W_k + b_k."""
    k_comp, _, s_cols = kb.pw.shape
    return logits_and_estimates((r2 @ flat).reshape(-1, k_comp, s_cols), kb)


def component_logits(r2: torch.Tensor, kb: KernelBankBlock,
                     chunk: int = 8192) -> torch.Tensor:
    """Per-row component logits (N, K) as the kernels compute them."""
    pin_fp32()
    flat = _flat_bank(kb)
    out = [_stream_reference(r2[i0:i0 + chunk], kb, flat)[0]
           for i0 in range(0, r2.shape[0], chunk)]
    return torch.cat(out) if out else r2.new_zeros((0, kb.pw.shape[0]))


def _grouped_reference(r2, kb, t_coh, coh_alpha, chunk, stats=False,
                       products=None):
    """The K1 / K3 stream in plain PyTorch: the estimate (N, 2D), or with
    `stats` the un-normalised state m (N,), den (N,), acc (N, 2D) of K2.
    `products(rows)` -> (n, K (2M+2D)): the products r2 pw_k of a chunk of
    rows (default: one float32 GEMM)."""
    pin_fp32()
    k_comp, _, s_cols = kb.pw.shape
    if products is None:
        flat = _flat_bank(kb)

        def products(rows):
            return rows @ flat
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    out = []
    for i0 in range(0, r2.shape[0], chunk):
        lg, z = logits_and_estimates(
            products(r2[i0:i0 + chunk]).reshape(-1, k_comp, s_cols), kb)
        if t_coh > 1:
            lg3 = lg.reshape(-1, t_coh, k_comp)
            s = lg3.sum(1, keepdim=True)
            lg = (s.expand_as(lg3) if coh_alpha >= 1.0
                  else (1.0 - coh_alpha) * lg3 + coh_alpha * s)
            lg = lg.reshape(-1, k_comp)
        if not stats:
            out.append(torch.einsum("nk,nkd->nd", torch.softmax(lg, dim=-1),
                                    z))
            continue
        m = lg.max(-1).values
        p = torch.exp(lg - m[:, None])
        out.append((m, p.sum(-1), torch.einsum("nk,nkd->nd", p, z)))
    if stats:
        if not out:
            return (r2.new_zeros(0), r2.new_zeros(0),
                    r2.new_zeros((0, kb.b.shape[1])))
        return tuple(torch.cat(x) for x in zip(*out))
    return torch.cat(out) if out else r2.new_zeros((0, kb.b.shape[1]))


def grouped_estimate_reference(r2: torch.Tensor, kb: KernelBankBlock,
                               chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K1: for yz_k = r2 @ pw_k,
    h2_n = sum_k softmax_k(logw_k - |yz_k[:, :2M] - mu_k|^2)
                 (yz_k[:, 2M:] + b_k), r2 (N, 2M) -> (N, 2D)."""
    return _grouped_reference(r2, kb, 1, 1.0, chunk)


def grouped_estimate_coherent_reference(r2: torch.Tensor, kb: KernelBankBlock,
                                        t_coh: int, coh_alpha: float = 1.0,
                                        chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K3: K1 with the rows of r2 (N, 2M) taken as
    N / T blocks of T consecutive rows and each component's logit of a row
    replaced by (1-a) lg_row + a sum_T lg over its block (alpha >= 1: the
    block sum). kb from `kernel_bank_block(bank, t_coh, coh_alpha)`."""
    if r2.shape[0] % t_coh:
        raise ValueError(f"{r2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    return _grouped_reference(r2, kb, t_coh, coh_alpha, chunk)


def grouped_estimate_stats_reference(r2: torch.Tensor, kb: KernelBankBlock,
                                     chunk: int = 8192):
    """Plain PyTorch version of K2: the state of K1's stream before the
    softmax combine, m_n = max_k lg_nk, den_n = sum_k exp(lg_nk - m_n),
    acc_n = sum_k exp(lg_nk - m_n) (yz_k[:, 2M:] + b_k), so acc / den is
    K1. r2 (N, 2M) -> (m (N,), den (N,), acc (N, 2D))."""
    return _grouped_reference(r2, kb, 1, 1.0, chunk, stats=True)


def grouped_estimate_coherent_stats_reference(r2: torch.Tensor,
                                              kb: KernelBankBlock, t_coh: int,
                                              coh_alpha: float = 1.0,
                                              chunk: int = 8192):
    """Plain PyTorch version of K2's coherent form: K3's state per row
    (m, den equal within a block at alpha >= 1), acc / den is K3."""
    if r2.shape[0] % t_coh:
        raise ValueError(f"{r2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    return _grouped_reference(r2, kb, t_coh, coh_alpha, chunk, stats=True)


def _topk_candidates(lg: torch.Tensor, z: torch.Tensor, k_sel: int):
    """Per row the k_sel components of largest logit, sorted descending
    (ties keep the lower index: a stable sort): logits (n, k) and their
    estimates (n, k, 2D)."""
    ls, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    ls, idx = ls[:, :k_sel], idx[:, :k_sel]
    return ls, torch.gather(z, 1, idx[..., None].expand(-1, -1, z.shape[-1]))


def _topk_combine(ls: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """The softmax renormalised over sorted candidates ls (n, k), zs
    (n, k, 2D) -> (n, 2D); k = 1 is the first candidate's estimate."""
    if ls.shape[1] == 1:
        return zs[:, 0]
    w = torch.exp(ls - ls[:, :1])
    return (w[..., None] * zs).sum(1) / w.sum(1, keepdim=True)


def grouped_estimate_topk_reference(r2: torch.Tensor, kb: KernelBankBlock,
                                    k_sel: int,
                                    chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K4: per row the k_sel components of largest
    logit (ties keep the lower index: a stable descending sort), combined
    with the softmax renormalized over them; k_sel = 1 is the argmax
    component's estimate. r2 (N, 2M) -> (N, 2D)."""
    pin_fp32()
    flat = _flat_bank(kb)
    out = [_topk_combine(*_topk_candidates(
        *_stream_reference(r2[i0:i0 + chunk], kb, flat), k_sel))
        for i0 in range(0, r2.shape[0], chunk)]
    return torch.cat(out) if out else r2.new_zeros((0, kb.b.shape[1]))


def grouped_estimate_topk_stats_reference(r2: torch.Tensor,
                                          kb: KernelBankBlock, k_sel: int,
                                          chunk: int = 8192):
    """Plain PyTorch version of K5: per row the shard's k_sel candidates of
    largest logit, sorted descending (ties keep the lower index), as
    logits l (N, k_sel) and estimates z (N, k_sel, 2D); slots past the
    shard's K hold -inf and zeros. `merge_topk` of the shards' candidates
    is K4 over the union."""
    pin_fp32()
    flat = _flat_bank(kb)
    k_comp, two_d = kb.pw.shape[0], kb.b.shape[1]
    ls, zs = [], []
    for i0 in range(0, r2.shape[0], chunk):
        l_c, z_c = _topk_candidates(
            *_stream_reference(r2[i0:i0 + chunk], kb, flat), k_sel)
        ls.append(l_c)
        zs.append(z_c)
    n = r2.shape[0]
    l_out = torch.cat(ls) if ls else r2.new_zeros((0, min(k_sel, k_comp)))
    z_out = (torch.cat(zs) if zs
             else r2.new_zeros((0, min(k_sel, k_comp), two_d)))
    if k_sel > k_comp:   # empty slots of a shard smaller than k_sel
        l_out = torch.cat([l_out, l_out.new_full((n, k_sel - k_comp),
                                                 -torch.inf)], 1)
        z_out = torch.cat([z_out, z_out.new_zeros((n, k_sel - k_comp,
                                                   two_d))], 1)
    return l_out, z_out


def merge_stats(ms, dens, accs):
    """Exact merge of online-softmax estimation states of disjoint
    component sets (split-K, as in flash attention): with per-set
    (m_c, den_c, acc_c) and m* = max_c m_c,

        den* = sum_c exp(m_c - m*) den_c,  acc* = sum_c exp(m_c - m*) acc_c,

    so acc* / den* equals the single-pass combine over the union. ms, dens:
    lists of (...,) tensors; accs: a list of (..., X) tensors, real or
    complex, whose leading dims are those of m or (coherent states at
    alpha = 1) one more block dim (..., T, X). The same recurrence runs
    across ranks as one all-reduce MAX and two SUMs
    (`parallel.mesh.estimate_sharded_kernel`)."""
    m_all = torch.stack(list(ms))
    m_star = m_all.max(0).values
    w = torch.exp(m_all - m_star[None])
    den = (torch.stack(list(dens)) * w).sum(0)
    acc_all = torch.stack(list(accs))
    wa = w.reshape(w.shape + (1,) * (acc_all.dim() - w.dim()))
    return m_star, den, (acc_all * wa.to(acc_all.dtype)).sum(0)


def merge_topk(ls, zs, k_sel: int) -> torch.Tensor:
    """Exact merge of the top-k candidates of disjoint component shards:
    the top-k of a union is the top-k of the shards' top-k's. ls: a list
    of (N, k) logits (each sorted descending), zs: a list of (N, k, 2D)
    estimates, in component order. Returns the renormalised-softmax top-k
    combine (N, 2D) (k_sel = 1: the argmax component's estimate). The
    candidates are concatenated in component order and sorted stably, so
    exact ties keep the lower component index, as one K4 launch does."""
    return _topk_combine(*_topk_candidates(torch.cat(list(ls), 1),
                                           torch.cat(list(zs), 1), k_sel))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(kernel: str, r2: torch.Tensor, kb: KernelBankBlock,
                  max_width: Optional[int] = None):
    """Validate a CUDA launch's inputs, for a kernel that takes only 2M,
    2D <= `max_width` (K14b) or the widths of K1-K5 (None); returns
    (n, K, 2M, 2D)."""
    n, two_m = r2.shape
    k_comp, _, s_cols = kb.pw.shape
    two_d = s_cols - two_m
    if max_width is not None and not (1 <= two_m <= max_width
                                      and 1 <= two_d <= max_width):
        raise ValueError(f"{kernel} takes 2M, 2D <= {max_width}; got "
                         f"2M={two_m}, 2D={two_d}")
    if not fused_kernel_eligible(two_d // 2, two_m // 2):
        raise ValueError(f"{kernel} takes 2M <= {WIDE_MAX_TWO_M}; got "
                         f"2M={two_m}, 2D={two_d}")
    dev = r2.device
    _check_cuda("r2", r2, (n, two_m), dev)
    _check_cuda("pw", kb.pw, (k_comp, two_m, s_cols), dev)
    _check_cuda("mu", kb.mu, (k_comp, two_m), dev)
    _check_cuda("b", kb.b, (k_comp, two_d), dev)
    _check_cuda("logw", kb.logw, (k_comp,), dev)
    return n, k_comp, two_m, two_d


def _launch(kernel: str, lib_fn, r2: torch.Tensor, kb: KernelBankBlock,
            outs, *args) -> None:
    """Launch on r2's device and current stream with the output tensors
    `outs`; raise on a cudaError."""
    dev = r2.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib_fn(r2.data_ptr(), kb.pw.data_ptr(), kb.mu.data_ptr(),
                     kb.b.data_ptr(), kb.logw.data_ptr(),
                     *(o.data_ptr() for o in outs), *args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def check_tc_operands(kernel: str, ops: TcOperands, kb: KernelBankBlock,
                      device) -> None:
    """Raise unless ops holds the three B-layout slabs and the vectors of a
    bank of kb's shape on `device` (`tc_operands`)."""
    k_comp, two_m, s_cols = kb.pw.shape
    n_ch = -(-two_m // TC_PIECE)
    pieces = n_ch + -(-(s_cols - two_m) // TC_PIECE)
    slab = (k_comp, pieces, n_ch, TC_PIECE, TC_PIECE)
    fields = [("hi", ops.hi, torch.bfloat16, slab),
              ("lo", ops.lo, torch.bfloat16, slab),
              ("lo2", ops.lo2, torch.bfloat16, slab),
              ("vec", ops.vec, torch.float32, (k_comp, pieces, TC_PIECE))]
    for name, t, dtype, shape in fields:
        if (t is None or t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            got = ("None" if t is None
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"{kernel}: operand {name} must be contiguous "
                             f"{dtype} {shape} on {device} (`tc_operands`), "
                             f"got {got}")


def launch_tc(kernel: str, lib_fn, r2: torch.Tensor, kb: KernelBankBlock,
              ops: Optional[TcOperands], outs, *args) -> None:
    """Launch a kernel of the wgmma stream (K1-K3, K15) on r2's device and
    current stream: r2, the three planes and vectors of `ops` (laid out
    from kb here when None), logw, the output tensors `outs`, then `args`;
    raise on a cudaError."""
    dev = r2.device
    if ops is None:
        ops = tc_operands(kb)
    check_tc_operands(kernel, ops, kb, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib_fn(r2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                     ops.lo2.data_ptr(), ops.vec.data_ptr(),
                     kb.logw.data_ptr(), *(o.data_ptr() for o in outs),
                     *args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def grouped_estimate(r2: torch.Tensor, kb: KernelBankBlock,
                     ops: Optional[TcOperands] = None) -> torch.Tensor:
    """K1 on r2 (N, 2M) float32 -> (N, 2D) float32; ops: `tc_operands(kb)`
    (`lowered_tc` keeps them beside a bank; laid out in the call when
    None). On a CUDA tensor it launches the CUDA kernel on the current
    stream (past 2M, 2D <= 256 its wide form, `grouped_estimate_wide`) and
    raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_reference(r2, kb)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate", r2, kb)
    if wide_form(two_m, two_d):
        return _launch_wide(grouped_estimate_wide, r2, kb, ops,
                            dims=(n, k_comp, two_m, two_d))
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    launch_tc("grouped_estimate",
              _library("grouped_estimate").grouped_estimate_launch, r2, kb,
              ops, (out,), n, k_comp, two_m, two_d)
    grouped_estimate.launches += 1
    return out


def grouped_estimate_coherent(r2: torch.Tensor, kb: KernelBankBlock,
                              t_coh: int, coh_alpha: float = 1.0,
                              ops: Optional[TcOperands] = None
                              ) -> torch.Tensor:
    """K3 on r2 (N, 2M) float32, N / T blocks of T consecutive rows ->
    (N, 2D) float32, kb from `kernel_bank_block(bank, t_coh, coh_alpha)`,
    ops as for `grouped_estimate`. On a CUDA tensor it launches the CUDA
    kernel (2 <= T <= `tile_rows`; past 2M, 2D <= 256 its wide form,
    `grouped_estimate_coherent_wide`) on the current stream and raises on
    any refusal; on a CPU tensor it computes the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_coherent_reference(r2, kb, t_coh, coh_alpha)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_coherent",
                                            r2, kb)
    _check_coherent("grouped_estimate_coherent", n, two_m, two_d, t_coh)
    if wide_form(two_m, two_d):
        return _launch_wide(grouped_estimate_coherent_wide, r2, kb, ops,
                            t_coh, coh_alpha, dims=(n, k_comp, two_m, two_d))
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    launch_tc("grouped_estimate_coherent",
              _library("grouped_estimate").grouped_estimate_coherent_launch,
              r2, kb, ops, (out,), n, k_comp, two_m, two_d, int(t_coh),
              float(coh_alpha))
    grouped_estimate_coherent.launches += 1
    return out


def _check_coherent(kernel: str, n: int, two_m: int, two_d: int,
                    t_coh: int) -> None:
    if not 2 <= t_coh <= tile_rows(two_m, two_d) or n % t_coh:
        raise ValueError(f"{kernel} takes N rows of whole T-row blocks, "
                         f"2 <= T <= {tile_rows(two_m, two_d)}; got N={n}, "
                         f"T={t_coh}")


def _stats_outputs(n: int, two_d: int, device):
    f32 = torch.float32
    return (torch.empty((n, two_d), dtype=f32, device=device),
            torch.empty((n,), dtype=f32, device=device),
            torch.empty((n,), dtype=f32, device=device))


def grouped_estimate_stats(r2: torch.Tensor, kb: KernelBankBlock,
                           ops: Optional[TcOperands] = None):
    """K2 on r2 (N, 2M) float32 -> (m (N,), den (N,), acc (N, 2D)), the
    un-normalised state of K1 over this (shard of a) bank; ops as for
    `grouped_estimate`. On a CUDA tensor it launches the CUDA kernel (past
    2M, 2D <= 256 its wide form, `grouped_estimate_stats_wide`) on the
    current stream and raises on any refusal; on a CPU tensor it computes
    the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_stats_reference(r2, kb)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_stats", r2, kb)
    if wide_form(two_m, two_d):
        return _launch_wide(grouped_estimate_stats_wide, r2, kb, ops,
                            stats=True, dims=(n, k_comp, two_m, two_d))
    acc, m, den = _stats_outputs(n, two_d, r2.device)
    if n == 0:
        return m, den, acc
    launch_tc("grouped_estimate_stats",
              _library("grouped_estimate").grouped_estimate_stats_launch, r2,
              kb, ops, (acc, m, den), n, k_comp, two_m, two_d)
    grouped_estimate_stats.launches += 1
    return m, den, acc


def grouped_estimate_coherent_stats(r2: torch.Tensor, kb: KernelBankBlock,
                                    t_coh: int, coh_alpha: float = 1.0,
                                    ops: Optional[TcOperands] = None):
    """K2's coherent form on r2 (N, 2M), N / T blocks of T consecutive
    rows, kb from `kernel_bank_block(bank, t_coh, coh_alpha)`, ops as for
    `grouped_estimate` -> K3's state per row (m (N,), den (N,), acc (N,
    2D)). On a CUDA tensor it launches the CUDA kernel (2 <= T <=
    `tile_rows`; past 2M, 2D <= 256 its wide form,
    `grouped_estimate_coherent_stats_wide`) on the current stream and
    raises on any refusal; on a CPU tensor it computes the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_coherent_stats_reference(r2, kb, t_coh,
                                                         coh_alpha)
    n, k_comp, two_m, two_d = _check_inputs(
        "grouped_estimate_coherent_stats", r2, kb)
    _check_coherent("grouped_estimate_coherent_stats", n, two_m, two_d, t_coh)
    if wide_form(two_m, two_d):
        return _launch_wide(grouped_estimate_coherent_stats_wide, r2, kb, ops,
                            t_coh, coh_alpha, stats=True,
                            dims=(n, k_comp, two_m, two_d))
    acc, m, den = _stats_outputs(n, two_d, r2.device)
    if n == 0:
        return m, den, acc
    lib = _library("grouped_estimate")
    launch_tc("grouped_estimate_coherent_stats",
              lib.grouped_estimate_coherent_stats_launch, r2, kb, ops,
              (acc, m, den), n, k_comp, two_m, two_d, int(t_coh),
              float(coh_alpha))
    grouped_estimate_coherent_stats.launches += 1
    return m, den, acc


def _check_topk(kernel: str, k_sel: int, k_comp: int, stats: bool) -> None:
    """K4 takes 1 <= k <= min(8, K), K5 1 <= k <= 8 (slots past a shard's
    K hold -inf and zeros)."""
    top = (f"{TOPK_KERNEL_MAX}" if stats
           else f"min({TOPK_KERNEL_MAX}, K={k_comp})")
    if not 1 <= k_sel <= (TOPK_KERNEL_MAX if stats
                          else min(TOPK_KERNEL_MAX, k_comp)):
        raise ValueError(f"{kernel} takes 1 <= k <= {top}; got {k_sel}")


def grouped_estimate_topk(r2: torch.Tensor, kb: KernelBankBlock,
                          k_sel: int,
                          ops: Optional[TcOperands] = None) -> torch.Tensor:
    """K4 on r2 (N, 2M) float32 -> (N, 2D) float32. On a CUDA tensor it
    launches the CUDA kernel (1 <= k_sel <= min(8, K); past 2M, 2D <= 256
    its wide form, `grouped_estimate_topk_wide`, which reads `ops`, the
    bank's `tc_operands`, laid out in the call when None) on the current
    stream and raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_topk_reference(r2, kb, k_sel)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_topk", r2, kb)
    _check_topk("grouped_estimate_topk", k_sel, k_comp, False)
    if wide_form(two_m, two_d):
        return _launch_wide_topk(grouped_estimate_topk_wide, r2, kb, k_sel,
                                 ops, dims=(n, k_comp, two_m, two_d))
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    # the kernel's candidates (n, k, 2D), combined per row; at k = 1 it
    # writes the one candidate to `out` and reads no scratch
    scratch = out if k_sel == 1 else torch.empty(
        (n, k_sel, two_d), dtype=torch.float32, device=r2.device)
    _launch("grouped_estimate_topk",
            _library("grouped_topk").grouped_topk_launch, r2, kb,
            (out, scratch), n, k_comp, two_m, two_d, int(k_sel))
    grouped_estimate_topk.launches += 1
    return out


def grouped_estimate_topk_stats(r2: torch.Tensor, kb: KernelBankBlock,
                                k_sel: int,
                                ops: Optional[TcOperands] = None):
    """K5 on r2 (N, 2M) float32 -> the top-k candidates of this (shard of
    a) bank, l (N, k_sel) sorted descending and z (N, k_sel, 2D); slots
    past the shard's K hold -inf and zeros. On a CUDA tensor it launches
    the CUDA kernel (1 <= k_sel <= 8, any K; past 2M, 2D <= 256 its wide
    form, `grouped_estimate_topk_stats_wide`, ops as for
    `grouped_estimate_topk`) on the current stream and raises on any
    refusal; on a CPU tensor it computes the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_topk_stats_reference(r2, kb, k_sel)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_topk_stats",
                                            r2, kb)
    _check_topk("grouped_estimate_topk_stats", k_sel, k_comp, True)
    if wide_form(two_m, two_d):
        return _launch_wide_topk(grouped_estimate_topk_stats_wide, r2, kb,
                                 k_sel, ops, stats=True,
                                 dims=(n, k_comp, two_m, two_d))
    f32 = torch.float32
    l_out = torch.empty((n, k_sel), dtype=f32, device=r2.device)
    z_out = torch.empty((n, k_sel, two_d), dtype=f32, device=r2.device)
    if n == 0:
        return l_out, z_out
    _launch("grouped_estimate_topk_stats",
            _library("grouped_topk").grouped_topk_stats_launch, r2, kb,
            (l_out, z_out), n, k_comp, two_m, two_d, int(k_sel))
    grouped_estimate_topk_stats.launches += 1
    return l_out, z_out


# ---------------------------------------------------------------------------
# the wide form of K1-K3 (csrc/grouped_wide_estimate.cu)
# ---------------------------------------------------------------------------

def _wide_rows(t_coh: int) -> int:
    """Rows of r2 in one 64-row tile of the wide form: floor(64 / T) whole
    blocks for K3."""
    return 64 // t_coh * t_coh if t_coh > 1 else 64


def wide_row_tiles(n: int, t_coh: int = 1) -> int:
    """64-row tiles of the wide form's row planes for n rows, rounded up to
    the two tiles of a block (the kernel's `row_tiles`)."""
    tiles = -(-n // _wide_rows(t_coh))
    return -(-tiles // 2) * 2


def wide_row_planes(r2: torch.Tensor, t_coh: int = 1) -> torch.Tensor:
    """r2 (N, 2M) float32 -> its three bf16 planes (`split_planes3`) as the
    wide form streams them: (3, tiles, Kp / 64, 64, 64), per 64-row tile
    (`wide_row_tiles`; tile i holds rows i w .. i w + w - 1, w = 64 or
    floor(64 / T) T) and 64-wide contraction chunk the tile's 64 rows x 64
    columns in the 128-byte swizzle (`_sw128`), as `tc_slab` lays out the
    bank; padding rows and columns zero. On a CUDA tensor it launches the
    wide form's first kernel (`grouped_wide_split_launch`; uncounted: the
    wide wrappers count their launch), on a CPU tensor it computes this
    plain version."""
    n, two_m = r2.shape
    n_ch = -(-two_m // TC_PIECE)
    tiles = wide_row_tiles(n, t_coh)
    if r2.is_cuda:
        _check_cuda("r2", r2, (n, two_m), r2.device)
        a = torch.empty((3, tiles, n_ch, TC_PIECE, TC_PIECE),
                        dtype=torch.bfloat16, device=r2.device)
        if n == 0:
            return a.zero_()
        with torch.cuda.device(r2.device):
            stream = torch.cuda.current_stream(r2.device).cuda_stream
            err = _library("grouped_wide_estimate").grouped_wide_split_launch(
                r2.data_ptr(), a.data_ptr(), n, two_m, int(t_coh), stream)
        if err != 0:
            raise RuntimeError(f"grouped_wide_split launch failed: "
                               f"cudaError {err}")
        return a
    w = _wide_rows(t_coh)
    x = r2.new_zeros((tiles, TC_PIECE, n_ch * TC_PIECE))
    idx = torch.arange(n, device=r2.device)
    x[idx // w, idx % w, :two_m] = r2
    x = x.reshape(tiles, TC_PIECE, n_ch, TC_PIECE).permute(0, 2, 1, 3)
    return torch.stack([_sw128(p) for p in split_planes3(x)]).contiguous()


def _launch_wide(wrapper, r2: torch.Tensor, kb: KernelBankBlock,
                 ops: Optional[TcOperands], t_coh: int = 1,
                 coh_alpha: float = 1.0, stats: bool = False, dims=None):
    """Launch the wide form (split, pass 1, pass 2) on r2's device and
    current stream and add one to `wrapper`'s count: -> the output (N, 2D),
    or with `stats` (m (N,), den (N,), acc (N, 2D)); raise on a cudaError.
    dims: (N, K, 2M, 2D) from a caller that has checked the inputs, else
    None (checked here)."""
    kernel = wrapper.__name__
    if dims is None:
        dims = _check_inputs(kernel, r2, kb)
        if t_coh > 1:
            _check_coherent(kernel, dims[0], dims[2], dims[3], t_coh)
    n, k_comp, two_m, two_d = dims
    dev = r2.device
    if stats:
        out, m, den = _stats_outputs(n, two_d, dev)
    else:
        out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
        m = den = None
    result = (m, den, out) if stats else out
    if n == 0:
        return result
    if ops is None:
        ops = tc_operands(kb)
    check_tc_operands(kernel, ops, kb, dev)
    a = torch.empty((3, wide_row_tiles(n, t_coh), -(-two_m // TC_PIECE),
                     TC_PIECE, TC_PIECE), dtype=torch.bfloat16, device=dev)
    lg = torch.empty((n, k_comp), dtype=torch.float32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("grouped_wide_estimate").grouped_wide_launch(
            r2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
            ops.lo2.data_ptr(), ops.vec.data_ptr(), kb.logw.data_ptr(),
            out.data_ptr(), ptr(m), ptr(den), a.data_ptr(), lg.data_ptr(),
            n, k_comp, two_m, two_d, int(t_coh), float(coh_alpha),
            int(stats), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    wrapper.launches += 1
    return result


def grouped_estimate_wide(r2: torch.Tensor, kb: KernelBankBlock,
                          ops: Optional[TcOperands] = None) -> torch.Tensor:
    """K1's wide form on r2 (N, 2M) float32 -> (N, 2D) float32, ops as for
    `grouped_estimate` (which launches it past 2M, 2D <= 256). On a CUDA
    tensor it launches the CUDA kernels (2M <= 2048, any 2D) on the
    current stream and raises on any refusal; on a CPU tensor it computes
    the plain version (`grouped_estimate_reference`)."""
    if not r2.is_cuda:
        return grouped_estimate_reference(r2, kb)
    return _launch_wide(grouped_estimate_wide, r2, kb, ops)


def grouped_estimate_coherent_wide(r2: torch.Tensor, kb: KernelBankBlock,
                                   t_coh: int, coh_alpha: float = 1.0,
                                   ops: Optional[TcOperands] = None
                                   ) -> torch.Tensor:
    """K3's wide form: `grouped_estimate_coherent` (which launches it past
    2M, 2D <= 256) at any width up to 2M = 2048, 2 <= T <= 64. On a CPU
    tensor the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_coherent_reference(r2, kb, t_coh, coh_alpha)
    return _launch_wide(grouped_estimate_coherent_wide, r2, kb, ops, t_coh,
                        coh_alpha)


def grouped_estimate_stats_wide(r2: torch.Tensor, kb: KernelBankBlock,
                                ops: Optional[TcOperands] = None):
    """K2's wide form: `grouped_estimate_stats` (which launches it past
    2M, 2D <= 256) at any width up to 2M = 2048 -> (m (N,), den (N,), acc
    (N, 2D)). On a CPU tensor the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_stats_reference(r2, kb)
    return _launch_wide(grouped_estimate_stats_wide, r2, kb, ops, stats=True)


def grouped_estimate_coherent_stats_wide(r2: torch.Tensor,
                                         kb: KernelBankBlock, t_coh: int,
                                         coh_alpha: float = 1.0,
                                         ops: Optional[TcOperands] = None):
    """K2's coherent wide form: `grouped_estimate_coherent_stats` (which
    launches it past 2M, 2D <= 256) at any width up to 2M = 2048, 2 <= T
    <= 64. On a CPU tensor the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_coherent_stats_reference(r2, kb, t_coh,
                                                         coh_alpha)
    return _launch_wide(grouped_estimate_coherent_stats_wide, r2, kb, ops,
                        t_coh, coh_alpha, stats=True)


# ---------------------------------------------------------------------------
# the wide form of K4 and K5 (csrc/grouped_wide_estimate.cu)
# ---------------------------------------------------------------------------

def wide_topk_pairs(n: int, k_comp: int, k_sel: int) -> int:
    """Blocks of two 64-row tiles that the wide top-k's value pass may need
    for n rows' k_sel picks over K components: each component's picks
    start a block of their own, so ceil(n k / 128) + K (the kernel's
    `topk_pairs`)."""
    return -(-n * k_sel // 128) + k_comp


def wide_topk_buckets(idx: torch.Tensor, k_comp: int):
    """The layout of the picks that the wide top-k's value pass reads, in
    plain PyTorch: idx (N, k) the picked component of each (row, slot)
    entry (-1: an empty slot) -> (pair_comp (`wide_topk_pairs`,) int32, the
    component of each block of 128 positions, -1 past the used ones; perm
    (128 pairs,) int32, the entry row k + slot at each position, -1 for
    padding). Component j's entries fill positions from 128 times the
    blocks before it; here in ascending entry order, on the card in the
    order of the scatter's atomics (no sum depends on it)."""
    n, k_sel = idx.shape
    pairs = wide_topk_pairs(n, k_comp, k_sel)
    flat = idx.reshape(-1).long()
    count = torch.bincount(flat[flat >= 0], minlength=k_comp)
    blocks = (count + 127) // 128
    start = torch.cumsum(blocks, 0) - blocks                # in blocks
    pair_comp = torch.full((pairs,), -1, dtype=torch.int32)
    pair_comp[:int(blocks.sum())] = torch.repeat_interleave(
        torch.arange(k_comp, dtype=torch.int32), blocks)
    perm = torch.full((128 * pairs,), -1, dtype=torch.int32)
    ent = torch.nonzero(flat >= 0)[:, 0]
    comp = flat[ent]
    order = torch.argsort(comp, stable=True)
    ent, comp = ent[order], comp[order]
    rank = torch.arange(ent.numel()) - (torch.cumsum(count, 0) - count)[comp]
    perm[128 * start[comp] + rank] = ent.to(torch.int32)
    return pair_comp, perm


def _wide_topk_rows(n: int, k_comp: int, two_m: int, two_d: int, k_sel: int,
                    stats: bool) -> int:
    """Rows of one wide top-k launch: all n, or as many as keep its scratch
    within `WIDE_SCRATCH`, a multiple of 128. A row costs its three
    bf16 planes once for the logits and once a pick, its K logits, and its
    picks' logits, components and positions (and, for K4 at k > 1, their
    candidates); each component's last block of 128 positions may be
    padding."""
    planes = 6 * 64 * -(-two_m // 64)
    per_row = (planes * (k_sel + 1) + 4 * (k_comp + 3 * k_sel)
               + (0 if stats or k_sel == 1 else 4 * k_sel * two_d))
    padding = (planes + 4) * 128 * k_comp
    rows = max(128, (WIDE_SCRATCH - padding) // per_row // 128 * 128)
    return min(n, rows)


def _launch_wide_topk(wrapper, r2: torch.Tensor, kb: KernelBankBlock,
                      k_sel: int, ops: Optional[TcOperands],
                      stats: bool = False, dims=None):
    """Launch the wide K4 (or with `stats` K5) on r2's device and current
    stream, one launch of `grouped_wide_topk_launch` for each row chunk
    (`_wide_topk_rows`), and add one to `wrapper`'s count for each: -> the
    output (N, 2D), or with `stats` (l (N, k), z (N, k, 2D)); raise on a
    cudaError. dims: (N, K, 2M, 2D) from a caller that has checked the
    inputs and k, else None (checked here)."""
    kernel = wrapper.__name__
    if dims is None:
        dims = _check_inputs(kernel, r2, kb)
        _check_topk(kernel, k_sel, dims[1], stats)
    n, k_comp, two_m, two_d = dims
    dev, f32 = r2.device, torch.float32
    if stats:
        l_out = torch.empty((n, k_sel), dtype=f32, device=dev)
        z_out = torch.empty((n, k_sel, two_d), dtype=f32, device=dev)
        out, result = None, (l_out, z_out)
    else:
        out = torch.empty((n, two_d), dtype=f32, device=dev)
        result = out
    if n == 0:
        return result
    if ops is None:
        ops = tc_operands(kb)
    check_tc_operands(kernel, ops, kb, dev)
    rows = _wide_topk_rows(n, k_comp, two_m, two_d, k_sel, stats)
    n_ch = -(-two_m // TC_PIECE)
    pairs = wide_topk_pairs(rows, k_comp, k_sel)
    tiles = max(wide_row_tiles(rows), 2 * pairs)
    a = torch.empty((3, tiles, n_ch, TC_PIECE, TC_PIECE),
                    dtype=torch.bfloat16, device=dev)
    lg = torch.empty((rows, k_comp), dtype=f32, device=dev)
    ints = torch.empty((rows * k_sel + 2 * k_comp + 129 * pairs,),
                       dtype=torch.int32, device=dev)
    if not stats:
        l_out = torch.empty((rows, k_sel), dtype=f32, device=dev)
        z_out = (torch.empty((rows, k_sel, two_d), dtype=f32, device=dev)
                 if k_sel > 1 else None)
    lib = _library("grouped_wide_estimate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i0 in range(0, n, rows):
            i1 = min(n, i0 + rows)
            chunk = slice(i0, i1) if stats else slice(0, i1 - i0)
            err = lib.grouped_wide_topk_launch(
                r2[i0:i1].data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                ops.lo2.data_ptr(), ops.vec.data_ptr(), kb.logw.data_ptr(),
                l_out[chunk].data_ptr(),
                None if z_out is None else z_out[chunk].data_ptr(),
                None if out is None else out[i0:i1].data_ptr(), a.data_ptr(),
                lg.data_ptr(), ints.data_ptr(), i1 - i0, k_comp, two_m, two_d,
                int(k_sel), int(stats), stream)
            if err != 0:
                raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
            wrapper.launches += 1
    return result


def grouped_estimate_topk_wide(r2: torch.Tensor, kb: KernelBankBlock,
                               k_sel: int,
                               ops: Optional[TcOperands] = None
                               ) -> torch.Tensor:
    """K4's wide form on r2 (N, 2M) float32 -> (N, 2D) float32, ops as for
    `grouped_estimate_topk` (which launches it past 2M, 2D <= 256). On a
    CUDA tensor it launches the CUDA kernels (2M <= 2048, any 2D, 1 <= k_sel
    <= min(8, K)) on the current stream and raises on any refusal; on a
    CPU tensor it computes the plain version
    (`grouped_estimate_topk_reference`)."""
    if not r2.is_cuda:
        return grouped_estimate_topk_reference(r2, kb, k_sel)
    return _launch_wide_topk(grouped_estimate_topk_wide, r2, kb, k_sel, ops)


def grouped_estimate_topk_stats_wide(r2: torch.Tensor, kb: KernelBankBlock,
                                     k_sel: int,
                                     ops: Optional[TcOperands] = None):
    """K5's wide form: `grouped_estimate_topk_stats` (which launches it
    past 2M, 2D <= 256) at any width up to 2M = 2048 -> (l (N, k_sel), z
    (N, k_sel, 2D)). On a CPU tensor the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_topk_stats_reference(r2, kb, k_sel)
    return _launch_wide_topk(grouped_estimate_topk_stats_wide, r2, kb, k_sel,
                             ops, stats=True)


_WRAPPERS: list = []


def register_wrappers(*fns) -> None:
    """Give each kernel wrapper a launch count of 0 and list it for
    `reset_launch_counts` / `launch_counts`."""
    for fn in fns:
        fn.launches = 0
        _WRAPPERS.append(fn)


register_wrappers(grouped_estimate, grouped_estimate_coherent,
                  grouped_estimate_topk, grouped_estimate_stats,
                  grouped_estimate_coherent_stats, grouped_estimate_topk_stats,
                  grouped_estimate_wide, grouped_estimate_coherent_wide,
                  grouped_estimate_stats_wide,
                  grouped_estimate_coherent_stats_wide,
                  grouped_estimate_topk_wide, grouped_estimate_topk_stats_wide)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launch count of every kernel wrapper, by kernel name."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


# ---------------------------------------------------------------------------
# entries on complex observations and prepared banks
# ---------------------------------------------------------------------------

def estimate_fused(bank: PreparedBank, r: torch.Tensor,
                   cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode estimate of complex observations r (N, M) -> (N, D)
    through K1: the drop-in for `gmm_estimator.estimate(bank, r, 'all')`.
    `cache`: see `lowered`."""
    kb = lowered(bank, cache)
    h2 = grouped_estimate(_r2(r), kb, _launch_ops(kb, r, cache))
    return _h(h2, bank.filters.shape[1], r.dtype)


def estimate_fused_stats(bank: PreparedBank, r: torch.Tensor,
                         cache: Optional[dict] = None):
    """'all'-mode estimation state of r (N, M) over this (shard of a) bank
    through K2: (m (N,), den (N,), acc (N, D) complex64), the kernel analog
    of `gmm_estimator.estimate_stats`, in its logit convention (2 sum log
    diag P_k folded into logw, the row constant -M log pi dropped), so
    states of kernel and einsum shards merge with `merge_stats`. Past
    `fused_kernel_eligible` it is `gmm_estimator.estimate_stats`. `cache`:
    see `lowered`."""
    _, d, m = bank.filters.shape
    if not fused_kernel_eligible(d, m):
        return gmm_estimator.estimate_stats(bank, r)
    kb = lowered(bank, cache)
    ms, den, acc2 = grouped_estimate_stats(_r2(r), kb,
                                           _launch_ops(kb, r, cache))
    return ms, den, _h(acc2, d, torch.complex64)


def coherent_kernel_eligible(bank: PreparedBank, t: int) -> bool:
    """Can K3 pool T-snapshot blocks of this bank? 1 < T <= the kernel's
    tile rows (`tile_rows`: 64), within `fused_kernel_eligible`. A rule of
    the shapes, decided before any launch."""
    _, d, m = bank.filters.shape
    return (fused_kernel_eligible(d, m)
            and 1 < t <= tile_rows(2 * m, 2 * d))


def estimate_fused_coherent(bank: PreparedBank, r: torch.Tensor,
                            alpha: float = 1.0,
                            cache: Optional[dict] = None) -> torch.Tensor:
    """Coherent 'all'-mode estimate of blocks r (B, T, M) -> (B, T, D): the
    drop-in for `gmm_estimator.estimate_coherent(bank, r, 'all', alpha=)`.
    T = 1 runs K1 within `fused_kernel_eligible`; T within
    `coherent_kernel_eligible` runs K3 with the alpha blend in the kernel;
    anything else takes the einsum estimator. `cache`: see `lowered`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, _ = r.shape
    _, d, m = bank.filters.shape
    if t == 1 and fused_kernel_eligible(d, m):
        return estimate_fused(bank, r[:, 0, :], cache)[:, None, :]
    if not coherent_kernel_eligible(bank, t):
        return gmm_estimator.estimate_coherent(bank, r, "all", 512, alpha)
    kb = lowered(bank, cache, t, alpha)
    h2 = grouped_estimate_coherent(_r2(r), kb, t, alpha,
                                   _launch_ops(kb, r, cache))
    return _h(h2, d, r.dtype).reshape(b, t, d)


def estimate_fused_coherent_stats(bank: PreparedBank, r: torch.Tensor,
                                  alpha: float = 1.0,
                                  cache: Optional[dict] = None):
    """Coherent 'all'-mode block estimation state of r (B, T, M) over this
    (shard of a) bank: the kernel analog of
    `gmm_estimator.estimate_coherent_stats`, in its convention: m, den per
    block (B,) at alpha >= 1 and per snapshot (B, T) below, acc (B, T, D)
    complex64. T within `coherent_kernel_eligible` runs K2's coherent form,
    T = 1 its flat form; anything else is the einsum stats path. `cache`:
    see `lowered`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, _ = r.shape
    _, d, m = bank.filters.shape
    if t == 1 and fused_kernel_eligible(d, m):
        kb = lowered(bank, cache)
        ms, den, acc2 = grouped_estimate_stats(_r2(r), kb,
                                               _launch_ops(kb, r, cache))
    elif coherent_kernel_eligible(bank, t):
        kb = lowered(bank, cache, t, alpha)
        ms, den, acc2 = grouped_estimate_coherent_stats(
            _r2(r), kb, t, alpha, _launch_ops(kb, r, cache))
    else:
        return gmm_estimator.estimate_coherent_stats(bank, r, 512, alpha)
    acc = _h(acc2, d, torch.complex64).reshape(b, t, d)
    ms, den = ms.reshape(b, t), den.reshape(b, t)
    if alpha >= 1.0:    # block-constant: one value a block
        return ms[:, 0], den[:, 0], acc
    return ms, den, acc


def topk_mode_eligible(d: int, k_comp: int, m: int, k_sel) -> bool:
    """Can K4 serve selection mode `k_sel` for a bank of K components,
    channel dim D and observation dim M? An int (not a bool)
    1 <= k <= min(8, K - 1) (k = K is the 'all' combine), and 2M <= 2048
    (`topk_width_eligible`; past 2M, 2D <= 256 the wide form). The one
    rule of `stages.estimate_auto`, the service and
    `parallel.mesh.estimate_sharded`. Dims-based, so a service can decide
    before any bank exists."""
    if not isinstance(k_sel, int) or isinstance(k_sel, bool):
        return False
    return (1 <= k_sel <= min(TOPK_KERNEL_MAX, k_comp - 1)
            and topk_width_eligible(d, m))


def topk_kernel_eligible(bank: PreparedBank, k_sel) -> bool:
    """Bank-shaped form of `topk_mode_eligible`."""
    k_comp, d, m = bank.filters.shape
    return topk_mode_eligible(d, k_comp, m, k_sel)


def estimate_fused_topk(bank: PreparedBank, r: torch.Tensor, k_sel: int,
                        cache: Optional[dict] = None) -> torch.Tensor:
    """Top-k selection estimate of r (N, M) -> (N, D) through K4 (past 2M,
    2D <= 256 its wide form): the drop-in for `gmm_estimator.estimate(bank,
    r, k_sel)` for int modes within `topk_kernel_eligible` (others raise).
    `cache`: see `lowered`."""
    if not topk_kernel_eligible(bank, k_sel):
        k_comp, _, m = bank.filters.shape
        raise ValueError(
            f"top-k kernel needs an int 1 <= k <= min({TOPK_KERNEL_MAX}, "
            f"K-1) and 2M <= {WIDE_MAX_TWO_M} (got k={k_sel!r}, K={k_comp}, "
            f"2M={2 * m})")
    kb = lowered(bank, cache)
    h2 = grouped_estimate_topk(_r2(r), kb, int(k_sel),
                               _topk_ops(bank, kb, r, cache))
    return _h(h2, bank.filters.shape[1], r.dtype)


def _topk_ops(bank: PreparedBank, kb: KernelBankBlock, r: torch.Tensor,
              cache: Optional[dict]) -> Optional[TcOperands]:
    """The cached `tc_operands` for a top-k launch in the wide form (on a
    card past 2M, 2D <= 256), else None: the narrow K4 / K5 read kb."""
    _, d, m = bank.filters.shape
    return (_launch_ops(kb, r, cache) if wide_form(2 * m, 2 * d) else None)


def estimate_fused_topk_stats(bank: PreparedBank, r: torch.Tensor, k_sel: int,
                              cache: Optional[dict] = None):
    """Top-k candidates of r (N, M) over this (shard of a) bank through K5:
    logits l (N, k_sel) sorted descending and estimates z (N, k_sel, 2D)
    real-packed [Re | Im]; `merge_topk` of the shards' candidates in
    component order is `estimate_fused_topk` over the whole bank. Raises
    past `topk_width_eligible` or outside 1 <= k_sel <= 8. `cache`: see
    `lowered`."""
    _, d, m = bank.filters.shape
    if not topk_width_eligible(d, m):
        raise ValueError(f"the top-k stats kernel takes 2M <= "
                         f"{WIDE_MAX_TWO_M} (its wide form past 2M, 2D <= "
                         f"{TC_MAX_WIDTH}); got M={m}, D={d}")
    kb = lowered(bank, cache)
    return grouped_estimate_topk_stats(_r2(r), kb, int(k_sel),
                                       _topk_ops(bank, kb, r, cache))
