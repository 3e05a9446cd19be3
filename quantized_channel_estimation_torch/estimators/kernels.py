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
  both in `csrc/grouped_estimate.cu`;
- K2, the split-K stats form of K1 and K3
  (`_estimate_kernel_block_grouped_stats`, entries `estimate_fused_stats`
  and `estimate_fused_coherent_stats`): the
  un-normalised online-softmax state (m, den, acc) of a component shard,
  which `merge_stats` merges exactly, in the same file (`STATS`);
- K4, the top-k selection estimator (`_grouped_stream_topk` +
  `_estimate_kernel_block_grouped_topk`, entry `estimate_fused_topk`) in
  `csrc/grouped_topk.cu`, and K5, its split-K stats form
  (`_estimate_kernel_block_grouped_topk_stats`, entry
  `estimate_fused_topk_stats`): a shard's top-k candidates, which
  `merge_topk` merges exactly.

K2 and K5 serve banks split over the component axis across ranks
(`parallel.mesh`); on one card K1, K3 and K4 stream any K in one launch.

The circulant kernels K6-K9 (`csrc/circ_estimate.cu`), the multi-pilot
circulant kernel K10 (`csrc/mp_circ_estimate.cu`) and the factored (MFA)
kernels K11-K13 (`csrc/fact_estimate.cu`) have their layouts, plain
versions and wrappers in the siblings `circ_kernels`, `mp_circ_kernels` and
`fact_kernels`; they are built, bound and counted by this module (`build`,
`_library`, `register_wrappers`).

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
from typing import Dict, NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.models import gmm_estimator
from quantized_channel_estimation_torch.models.gmm_estimator import (
    PreparedBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_WIDTH = 256      # 2M and 2D of every kernel
TOPK_KERNEL_MAX = 8  # K4's top-k slots a row

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
        lib.grouped_estimate_launch.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.grouped_estimate_launch.restype = i32
        lib.grouped_estimate_coherent_launch.argtypes = (
            [ptr] * 6 + [i32] * 5 + [f32, ptr])
        lib.grouped_estimate_coherent_launch.restype = i32
        lib.grouped_estimate_stats_launch.argtypes = (
            [ptr] * 8 + [i32] * 4 + [ptr])
        lib.grouped_estimate_stats_launch.restype = i32
        lib.grouped_estimate_coherent_stats_launch.argtypes = (
            [ptr] * 8 + [i32] * 5 + [f32, ptr])
        lib.grouped_estimate_coherent_stats_launch.restype = i32
    elif name == "grouped_topk":
        lib.grouped_topk_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.grouped_topk_launch.restype = i32
        lib.grouped_topk_stats_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.grouped_topk_stats_launch.restype = i32
    elif name == "circ_estimate":
        lib.circ_estimate_launch.argtypes = (
            [ptr] * 9 + [i32] * 4 + [f32, i32, ptr])
        lib.circ_estimate_launch.restype = i32
    elif name == "mp_circ_estimate":
        lib.mp_circ_estimate_launch.argtypes = (
            [ptr] * 7 + [i32] * 5 + [f32, ptr])
        lib.mp_circ_estimate_launch.restype = i32
    elif name == "fact_estimate":
        lib.fact_estimate_launch.argtypes = (
            [ptr] * 11 + [i32] * 5 + [f32, i32, ptr])
        lib.fact_estimate_launch.restype = i32


def fused_kernel_eligible(d: int, m: int) -> bool:
    """Can the dense kernels (K1-K5) take a bank of channel dim D and
    observation dim M? 2M, 2D <= `MAX_WIDTH`, any K. A rule of the shapes,
    decided before any launch; past it the stages take the einsum
    estimator."""
    return 1 <= 2 * m <= MAX_WIDTH and 1 <= 2 * d <= MAX_WIDTH


def tile_rows(two_m: int, two_d: int) -> int:
    """Rows of one tile of the K1/K3 kernel at these widths (8 warps of 8
    rows while 2M, 2D <= 128, else of 4; `dispatch` in
    csrc/grouped_estimate.cu): the largest coherence block K3 pools."""
    return 64 if max(two_m, two_d) <= 128 else 32


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


def _stream_reference(r2: torch.Tensor, kb: KernelBankBlock,
                      flat: torch.Tensor):
    """What the kernels' stream computes for rows r2 (n, 2M): the logits
    lg (n, K) = logw - |r2 P_k - mu_k|^2 and the per-component estimates
    z (n, K, 2D) = r2 W_k + b_k."""
    two_m = r2.shape[1]
    k_comp, _, s_cols = kb.pw.shape
    yz = (r2 @ flat).reshape(-1, k_comp, s_cols)
    dy = yz[..., :two_m] - kb.mu[None]
    return kb.logw[None] - (dy * dy).sum(-1), yz[..., two_m:] + kb.b[None]


def component_logits(r2: torch.Tensor, kb: KernelBankBlock,
                     chunk: int = 8192) -> torch.Tensor:
    """Per-row component logits (N, K) as the kernels compute them."""
    pin_fp32()
    flat = _flat_bank(kb)
    out = [_stream_reference(r2[i0:i0 + chunk], kb, flat)[0]
           for i0 in range(0, r2.shape[0], chunk)]
    return torch.cat(out) if out else r2.new_zeros((0, kb.pw.shape[0]))


def _grouped_reference(r2, kb, t_coh, coh_alpha, chunk, stats=False):
    """The K1 / K3 stream in plain PyTorch: the estimate (N, 2D), or with
    `stats` the un-normalised state m (N,), den (N,), acc (N, 2D) of K2."""
    pin_fp32()
    k_comp = kb.pw.shape[0]
    flat = _flat_bank(kb)
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    out = []
    for i0 in range(0, r2.shape[0], chunk):
        lg, z = _stream_reference(r2[i0:i0 + chunk], kb, flat)
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


def _check_inputs(kernel: str, r2: torch.Tensor, kb: KernelBankBlock):
    """Validate a CUDA launch's inputs; returns (n, K, 2M, 2D)."""
    n, two_m = r2.shape
    k_comp, _, s_cols = kb.pw.shape
    two_d = s_cols - two_m
    if not (1 <= two_m <= MAX_WIDTH and 1 <= two_d <= MAX_WIDTH):
        raise ValueError(f"{kernel} takes 2M, 2D <= {MAX_WIDTH}; got "
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


def grouped_estimate(r2: torch.Tensor, kb: KernelBankBlock) -> torch.Tensor:
    """K1 on r2 (N, 2M) float32 -> (N, 2D) float32. On a CUDA tensor it
    launches the CUDA kernel (2M and 2D at most 256) on the current stream
    and raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_reference(r2, kb)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate", r2, kb)
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    _launch("grouped_estimate",
            _library("grouped_estimate").grouped_estimate_launch, r2, kb,
            (out,), n, k_comp, two_m, two_d)
    grouped_estimate.launches += 1
    return out


def grouped_estimate_coherent(r2: torch.Tensor, kb: KernelBankBlock,
                              t_coh: int,
                              coh_alpha: float = 1.0) -> torch.Tensor:
    """K3 on r2 (N, 2M) float32, N / T blocks of T consecutive rows ->
    (N, 2D) float32, kb from `kernel_bank_block(bank, t_coh, coh_alpha)`.
    On a CUDA tensor it launches the CUDA kernel (2 <= T <= `tile_rows`)
    on the current stream and raises on any refusal; on a CPU tensor it
    computes the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_coherent_reference(r2, kb, t_coh, coh_alpha)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_coherent",
                                            r2, kb)
    _check_coherent("grouped_estimate_coherent", n, two_m, two_d, t_coh)
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    _launch("grouped_estimate_coherent",
            _library("grouped_estimate").grouped_estimate_coherent_launch,
            r2, kb, (out,), n, k_comp, two_m, two_d, int(t_coh),
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


def grouped_estimate_stats(r2: torch.Tensor, kb: KernelBankBlock):
    """K2 on r2 (N, 2M) float32 -> (m (N,), den (N,), acc (N, 2D)), the
    un-normalised state of K1 over this (shard of a) bank. On a CUDA
    tensor it launches the CUDA kernel (2M and 2D at most 256) on the
    current stream and raises on any refusal; on a CPU tensor it computes
    the plain version."""
    if not r2.is_cuda:
        return grouped_estimate_stats_reference(r2, kb)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_stats", r2, kb)
    acc, m, den = _stats_outputs(n, two_d, r2.device)
    if n == 0:
        return m, den, acc
    _launch("grouped_estimate_stats",
            _library("grouped_estimate").grouped_estimate_stats_launch, r2,
            kb, (acc, m, den), n, k_comp, two_m, two_d)
    grouped_estimate_stats.launches += 1
    return m, den, acc


def grouped_estimate_coherent_stats(r2: torch.Tensor, kb: KernelBankBlock,
                                    t_coh: int, coh_alpha: float = 1.0):
    """K2's coherent form on r2 (N, 2M), N / T blocks of T consecutive
    rows, kb from `kernel_bank_block(bank, t_coh, coh_alpha)` -> K3's
    state per row (m (N,), den (N,), acc (N, 2D)). On a CUDA tensor it
    launches the CUDA kernel (2 <= T <= `tile_rows`) on the current stream
    and raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_coherent_stats_reference(r2, kb, t_coh,
                                                         coh_alpha)
    n, k_comp, two_m, two_d = _check_inputs(
        "grouped_estimate_coherent_stats", r2, kb)
    _check_coherent("grouped_estimate_coherent_stats", n, two_m, two_d, t_coh)
    acc, m, den = _stats_outputs(n, two_d, r2.device)
    if n == 0:
        return m, den, acc
    lib = _library("grouped_estimate")
    _launch("grouped_estimate_coherent_stats",
            lib.grouped_estimate_coherent_stats_launch, r2, kb,
            (acc, m, den), n, k_comp, two_m, two_d, int(t_coh),
            float(coh_alpha))
    grouped_estimate_coherent_stats.launches += 1
    return m, den, acc


def grouped_estimate_topk(r2: torch.Tensor, kb: KernelBankBlock,
                          k_sel: int) -> torch.Tensor:
    """K4 on r2 (N, 2M) float32 -> (N, 2D) float32. On a CUDA tensor it
    launches the CUDA kernel (1 <= k_sel <= min(8, K)) on the current
    stream and raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_topk_reference(r2, kb, k_sel)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_topk", r2, kb)
    if not 1 <= k_sel <= min(TOPK_KERNEL_MAX, k_comp):
        raise ValueError(f"grouped_estimate_topk takes 1 <= k <= "
                         f"min({TOPK_KERNEL_MAX}, K={k_comp}); got {k_sel}")
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    _launch("grouped_estimate_topk",
            _library("grouped_topk").grouped_topk_launch, r2, kb, (out,), n,
            k_comp, two_m, two_d, int(k_sel))
    grouped_estimate_topk.launches += 1
    return out


def grouped_estimate_topk_stats(r2: torch.Tensor, kb: KernelBankBlock,
                                k_sel: int):
    """K5 on r2 (N, 2M) float32 -> the top-k candidates of this (shard of
    a) bank, l (N, k_sel) sorted descending and z (N, k_sel, 2D); slots
    past the shard's K hold -inf and zeros. On a CUDA tensor it launches
    the CUDA kernel (1 <= k_sel <= 8, any K) on the current stream and
    raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_topk_stats_reference(r2, kb, k_sel)
    n, k_comp, two_m, two_d = _check_inputs("grouped_estimate_topk_stats",
                                            r2, kb)
    if not 1 <= k_sel <= TOPK_KERNEL_MAX:
        raise ValueError(f"grouped_estimate_topk_stats takes 1 <= k <= "
                         f"{TOPK_KERNEL_MAX}; got {k_sel}")
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


_WRAPPERS: list = []


def register_wrappers(*fns) -> None:
    """Give each kernel wrapper a launch count of 0 and list it for
    `reset_launch_counts` / `launch_counts`."""
    for fn in fns:
        fn.launches = 0
        _WRAPPERS.append(fn)


register_wrappers(grouped_estimate, grouped_estimate_coherent,
                  grouped_estimate_topk, grouped_estimate_stats,
                  grouped_estimate_coherent_stats, grouped_estimate_topk_stats)


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
    h2 = grouped_estimate(_r2(r), lowered(bank, cache))
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
    ms, den, acc2 = grouped_estimate_stats(_r2(r), lowered(bank, cache))
    return ms, den, _h(acc2, d, torch.complex64)


def coherent_kernel_eligible(bank: PreparedBank, t: int) -> bool:
    """Can K3 pool T-snapshot blocks of this bank? 1 < T <= the kernel's
    tile rows (64 at 2M, 2D <= 128, else 32), within
    `fused_kernel_eligible`. A rule of the shapes, decided before any
    launch."""
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
    h2 = grouped_estimate_coherent(_r2(r), lowered(bank, cache, t, alpha),
                                   t, alpha)
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
        ms, den, acc2 = grouped_estimate_stats(_r2(r), lowered(bank, cache))
    elif coherent_kernel_eligible(bank, t):
        ms, den, acc2 = grouped_estimate_coherent_stats(
            _r2(r), lowered(bank, cache, t, alpha), t, alpha)
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
    1 <= k <= min(8, K - 1) (k = K is the 'all' combine), and
    2M, 2D <= 256. Dims-based, so a service can decide before any bank
    exists."""
    if not isinstance(k_sel, int) or isinstance(k_sel, bool):
        return False
    return (1 <= k_sel <= min(TOPK_KERNEL_MAX, k_comp - 1)
            and fused_kernel_eligible(d, m))


def topk_kernel_eligible(bank: PreparedBank, k_sel) -> bool:
    """Bank-shaped form of `topk_mode_eligible`."""
    k_comp, d, m = bank.filters.shape
    return topk_mode_eligible(d, k_comp, m, k_sel)


def estimate_fused_topk(bank: PreparedBank, r: torch.Tensor, k_sel: int,
                        cache: Optional[dict] = None) -> torch.Tensor:
    """Top-k selection estimate of r (N, M) -> (N, D) through K4: the
    drop-in for `gmm_estimator.estimate(bank, r, k_sel)` for int modes
    within `topk_kernel_eligible` (others raise). `cache`: see
    `lowered`."""
    if not topk_kernel_eligible(bank, k_sel):
        k_comp = bank.filters.shape[0]
        raise ValueError(
            f"top-k kernel needs an int 1 <= k <= min({TOPK_KERNEL_MAX}, "
            f"K-1) and 2M, 2D <= {MAX_WIDTH} (got k={k_sel!r}, K={k_comp})")
    h2 = grouped_estimate_topk(_r2(r), lowered(bank, cache), int(k_sel))
    return _h(h2, bank.filters.shape[1], r.dtype)


def estimate_fused_topk_stats(bank: PreparedBank, r: torch.Tensor, k_sel: int,
                              cache: Optional[dict] = None):
    """Top-k candidates of r (N, M) over this (shard of a) bank through K5:
    logits l (N, k_sel) sorted descending and estimates z (N, k_sel, 2D)
    real-packed [Re | Im]; `merge_topk` of the shards' candidates in
    component order is `estimate_fused_topk` over the whole bank. Raises
    past `fused_kernel_eligible` or outside 1 <= k_sel <= 8. `cache`: see
    `lowered`."""
    _, d, m = bank.filters.shape
    if not fused_kernel_eligible(d, m):
        raise ValueError(f"the top-k stats kernel takes 2M, 2D <= "
                         f"{MAX_WIDTH}; got M={m}, D={d}")
    return grouped_estimate_topk_stats(_r2(r), lowered(bank, cache),
                                       int(k_sel))
