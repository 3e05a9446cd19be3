"""Hand-written CUDA kernels of the estimation path and their plain versions.

Port of `quantized_channel_estimation_tpu/estimators/pallas_kernels.py`,
main-path subset: the block-GEMM bank layout (`KernelBankBlock`,
`_cplx_block`, `kernel_bank_block`) and the 'all'-mode grouped online-softmax
estimator K1 (`_grouped_stream` + `_estimate_kernel_block_grouped`, launched
by `estimate_packed_block_grouped`, entry `estimate_fused`), written in CUDA
C++ for `sm_90a` in `csrc/grouped_estimate.cu`.

The CUDA sources are compiled with `nvcc` into a shared library with a plain
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
from typing import Dict, NamedTuple

import torch

from quantized_channel_estimation_torch.models.gmm_estimator import (
    PreparedBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    started together. Sources whose library is newer are skipped. Returns
    each compiled source's compiler output (register and shared-memory
    use from `-Xptxas -v`); raises if any compile fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "grouped_estimate":
        lib.grouped_estimate_launch.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.grouped_estimate_launch.restype = i32


# ---------------------------------------------------------------------------
# bank layout
# ---------------------------------------------------------------------------

class KernelBankBlock(NamedTuple):
    """PreparedBank in the real block layout of the estimation kernel.

    Each complex matrix B is embedded as the real 2x2 block
    [[B_re, B_im], [-B_im, B_re]], so with r2 = [r_re | r_im] (N, 2M),
    r2 @ Bblk = [Re(r B) | Im(r B)]. Per component the precision block
    (2M, 2M) and the filter block (2M, 2D) are concatenated column-wise.

    pw:   (K, 2M, 2M+2D)  [Pblk | Wblk], Pblk from conj(P_k), Wblk from W_k^T
    mu:   (K, 2M)         [Re mu~ | Im mu~], mu~_k = means_r_k @ conj(P_k)
    b:    (K, 2D)         [Re bias | Im bias]
    logw: (K,)            log weights + 2 sum log diag(P_k), floored at -1e30
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


def kernel_bank_block(bank: PreparedBank) -> KernelBankBlock:
    """Lower a PreparedBank to the kernel layout. Dead components carry
    log-weight -inf; the -1e30 floor keeps the online softmax exact (their
    exp underflows to 0 as soon as a live logit appears)."""
    pin_fp32()
    pc = bank.prec_chol_r.conj()                           # (K, M, M)
    mu = torch.matmul(bank.means_r[:, None, :], pc)[:, 0]  # (K, M)
    wt = bank.filters.transpose(-1, -2)                    # (K, M, D)
    diag = torch.diagonal(bank.prec_chol_r, dim1=-2, dim2=-1).real
    logw = torch.clamp(bank.log_weights + 2.0 * torch.log(diag).sum(-1),
                       min=-1e30)
    pw = torch.cat([_cplx_block(pc), _cplx_block(wt)], dim=-1)
    f32 = torch.float32
    return KernelBankBlock(
        pw.to(f32).contiguous(),
        torch.cat([mu.real, mu.imag], dim=-1).to(f32).contiguous(),
        torch.cat([bank.bias.real, bank.bias.imag], dim=-1).to(f32)
        .contiguous(),
        logw.to(f32).contiguous())


# ---------------------------------------------------------------------------
# K1: grouped online-softmax estimator
# ---------------------------------------------------------------------------

def grouped_estimate_reference(r2: torch.Tensor, kb: KernelBankBlock,
                               chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K1: for yz_k = r2 @ pw_k,
    h2_n = sum_k softmax_k(logw_k - |yz_k[:, :2M] - mu_k|^2)
                 (yz_k[:, 2M:] + b_k), r2 (N, 2M) -> (N, 2D)."""
    pin_fp32()
    two_m = r2.shape[1]
    k_comp, _, s_cols = kb.pw.shape
    flat = kb.pw.permute(1, 0, 2).reshape(two_m, k_comp * s_cols)
    out = []
    for i0 in range(0, r2.shape[0], chunk):
        yz = (r2[i0:i0 + chunk] @ flat).reshape(-1, k_comp, s_cols)
        dy = yz[..., :two_m] - kb.mu[None]
        p = torch.softmax(kb.logw[None] - (dy * dy).sum(-1), dim=-1)
        z = yz[..., two_m:] + kb.b[None]
        out.append(torch.einsum("nk,nkd->nd", p, z))
    return torch.cat(out) if out else r2.new_zeros((0, kb.b.shape[1]))


def _check_cuda(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def grouped_estimate(r2: torch.Tensor, kb: KernelBankBlock) -> torch.Tensor:
    """K1 on r2 (N, 2M) float32 -> (N, 2D) float32. On a CUDA tensor it
    launches the CUDA kernel (2M and 2D at most 256) on the current stream
    and raises on any refusal; on a CPU tensor it computes the plain
    version."""
    if not r2.is_cuda:
        return grouped_estimate_reference(r2, kb)
    n, two_m = r2.shape
    k_comp, _, s_cols = kb.pw.shape
    two_d = s_cols - two_m
    if not (1 <= two_m <= 256 and 1 <= two_d <= 256):
        raise ValueError(f"grouped_estimate takes 2M, 2D <= 256; got "
                         f"2M={two_m}, 2D={two_d}")
    dev = r2.device
    _check_cuda("r2", r2, (n, two_m), dev)
    _check_cuda("pw", kb.pw, (k_comp, two_m, s_cols), dev)
    _check_cuda("mu", kb.mu, (k_comp, two_m), dev)
    _check_cuda("b", kb.b, (k_comp, two_d), dev)
    _check_cuda("logw", kb.logw, (k_comp,), dev)
    out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _library("grouped_estimate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.grouped_estimate_launch(
            r2.data_ptr(), kb.pw.data_ptr(), kb.mu.data_ptr(),
            kb.b.data_ptr(), kb.logw.data_ptr(), out.data_ptr(),
            n, k_comp, two_m, two_d, stream)
    if err != 0:
        raise RuntimeError(f"grouped_estimate launch failed: cudaError {err}")
    grouped_estimate.launches += 1
    return out


grouped_estimate.launches = 0


def estimate_fused(bank: PreparedBank, r: torch.Tensor) -> torch.Tensor:
    """'all'-mode estimate of complex observations r (N, M) -> (N, D)
    through K1: the drop-in for `gmm_estimator.estimate(bank, r, 'all')`."""
    d = bank.filters.shape[1]
    r2 = torch.cat([r.real, r.imag], dim=-1).to(torch.float32).contiguous()
    h2 = grouped_estimate(r2, kernel_bank_block(bank))
    return torch.complex(h2[:, :d], h2[:, d:]).to(r.dtype)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    grouped_estimate.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launch count of every kernel wrapper, by kernel name."""
    return {"grouped_estimate": grouped_estimate.launches}
