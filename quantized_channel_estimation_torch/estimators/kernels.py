"""Hand-written CUDA kernels of the estimation path and their plain versions.

Port of `quantized_channel_estimation_tpu/estimators/pallas_kernels.py`,
single-device subset: the block-GEMM bank layout (`KernelBankBlock`,
`_cplx_block`, `kernel_bank_block`, with the coherent log-weight divisor)
and three kernels written in CUDA C++ for `sm_90a`:

- K1, the 'all'-mode grouped online-softmax estimator (`_grouped_stream` +
  `_estimate_kernel_block_grouped`, entry `estimate_fused`), and
- K3, its coherent mode pooling each component's logits over the T rows of
  a coherence block with the alpha blend (entry `estimate_fused_coherent`),
  both in `csrc/grouped_estimate.cu`;
- K4, the top-k selection estimator (`_grouped_stream_topk` +
  `_estimate_kernel_block_grouped_topk`, entry `estimate_fused_topk`) in
  `csrc/grouped_topk.cu`.

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
    elif name == "grouped_topk":
        lib.grouped_topk_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.grouped_topk_launch.restype = i32
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


def _grouped_reference(r2, kb, t_coh, coh_alpha, chunk):
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
        out.append(torch.einsum("nk,nkd->nd", torch.softmax(lg, dim=-1), z))
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


def grouped_estimate_topk_reference(r2: torch.Tensor, kb: KernelBankBlock,
                                    k_sel: int,
                                    chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K4: per row the k_sel components of largest
    logit (ties keep the lower index: a stable descending sort), combined
    with the softmax renormalized over them; k_sel = 1 is the argmax
    component's estimate. r2 (N, 2M) -> (N, 2D)."""
    pin_fp32()
    flat = _flat_bank(kb)
    out = []
    for i0 in range(0, r2.shape[0], chunk):
        lg, z = _stream_reference(r2[i0:i0 + chunk], kb, flat)
        ls, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
        ls, idx = ls[:, :k_sel], idx[:, :k_sel]
        zs = torch.gather(z, 1, idx[..., None].expand(-1, -1, z.shape[-1]))
        if k_sel == 1:
            out.append(zs[:, 0])
            continue
        w = torch.exp(ls - ls[:, :1])
        out.append((w[..., None] * zs).sum(1) / w.sum(1, keepdim=True))
    return torch.cat(out) if out else r2.new_zeros((0, kb.b.shape[1]))


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
            out: torch.Tensor, *args) -> None:
    """Launch on r2's device and current stream; raise on a cudaError."""
    dev = r2.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib_fn(r2.data_ptr(), kb.pw.data_ptr(), kb.mu.data_ptr(),
                     kb.b.data_ptr(), kb.logw.data_ptr(), out.data_ptr(),
                     *args, stream)
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
            out, n, k_comp, two_m, two_d)
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
    if not 2 <= t_coh <= tile_rows(two_m, two_d) or n % t_coh:
        raise ValueError(f"grouped_estimate_coherent takes N rows of whole "
                         f"T-row blocks, 2 <= T <= "
                         f"{tile_rows(two_m, two_d)}; got N={n}, T={t_coh}")
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    _launch("grouped_estimate_coherent",
            _library("grouped_estimate").grouped_estimate_coherent_launch,
            r2, kb, out, n, k_comp, two_m, two_d, int(t_coh),
            float(coh_alpha))
    grouped_estimate_coherent.launches += 1
    return out


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
            _library("grouped_topk").grouped_topk_launch, r2, kb, out, n,
            k_comp, two_m, two_d, int(k_sel))
    grouped_estimate_topk.launches += 1
    return out


_WRAPPERS: list = []


def register_wrappers(*fns) -> None:
    """Give each kernel wrapper a launch count of 0 and list it for
    `reset_launch_counts` / `launch_counts`."""
    for fn in fns:
        fn.launches = 0
        _WRAPPERS.append(fn)


register_wrappers(grouped_estimate, grouped_estimate_coherent,
                  grouped_estimate_topk)


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


def coherent_kernel_eligible(bank: PreparedBank, t: int) -> bool:
    """Can K3 pool T-snapshot blocks of this bank? 1 < T <= the kernel's
    tile rows (64 at 2M, 2D <= 128, else 32), and 2M, 2D <= 256. A rule of
    the shapes, decided before any launch."""
    _, d, m = bank.filters.shape
    two_m, two_d = 2 * m, 2 * d
    return (two_m <= MAX_WIDTH and two_d <= MAX_WIDTH
            and 1 < t <= tile_rows(two_m, two_d))


def estimate_fused_coherent(bank: PreparedBank, r: torch.Tensor,
                            alpha: float = 1.0,
                            cache: Optional[dict] = None) -> torch.Tensor:
    """Coherent 'all'-mode estimate of blocks r (B, T, M) -> (B, T, D): the
    drop-in for `gmm_estimator.estimate_coherent(bank, r, 'all', alpha=)`.
    T = 1 runs K1; T within `coherent_kernel_eligible` runs K3 with the
    alpha blend in the kernel; larger T takes the einsum estimator.
    `cache`: see `lowered`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, _ = r.shape
    if t == 1:
        return estimate_fused(bank, r[:, 0, :], cache)[:, None, :]
    if not coherent_kernel_eligible(bank, t):
        return gmm_estimator.estimate_coherent(bank, r, "all", 512, alpha)
    h2 = grouped_estimate_coherent(_r2(r), lowered(bank, cache, t, alpha),
                                   t, alpha)
    d = bank.filters.shape[1]
    return _h(h2, d, r.dtype).reshape(b, t, d)


def topk_mode_eligible(d: int, k_comp: int, m: int, k_sel) -> bool:
    """Can K4 serve selection mode `k_sel` for a bank of K components,
    channel dim D and observation dim M? An int (not a bool)
    1 <= k <= min(8, K - 1) (k = K is the 'all' combine), and
    2M, 2D <= 256. Dims-based, so a service can decide before any bank
    exists."""
    if not isinstance(k_sel, int) or isinstance(k_sel, bool):
        return False
    return (1 <= k_sel <= min(TOPK_KERNEL_MAX, k_comp - 1)
            and 2 * m <= MAX_WIDTH and 2 * d <= MAX_WIDTH)


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
