"""The hand-written factored (MFA, Woodbury) estimation kernels and their
plain versions.

Port of the factored section of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`
(:1919-2305): `FactKernelBank`, `fact_kernel_bank`, and the entries
`estimate_fused_factored` (K11), `estimate_fused_factored_coherent` (K12)
and `estimate_fused_factored_stats` (K13). The three kernels are one CUDA
C++ template with COH and STATS flags in `csrc/fact_estimate.cu`, built and
bound by `estimators.kernels` (nvcc, ctypes, launch counts); shard states of
K13 merge with `circ_kernels.merge_stats`.

Differences of layout from the TPU kernels, none of arithmetic:

- the TPU kernel holds the whole bank in VMEM and forms beta and gamma of
  every component at once, reducing |beta - T mu|^2 and broadcasting the
  weights through block-indicator GEMMs. The CUDA kernel streams the bank
  one component at a time (an online softmax, as K1 does), so the layout
  keeps each component's operands together: its forward slab (T and P2)
  and its combine slab (-R and Lambda), and no indicator matrices;
- complex rows and operands are interleaved [re, im] pairs, the memory
  layout of a complex64 tensor (the TPU kernel takes [Re | Im] split
  copies);
- coherence blocks are block-major (the T rows of a block consecutive), as
  in K3, K7 and K10, not the TPU's T-major tiles;
- the range rule `fact_kernel_eligible` is the CUDA kernel's (D <= 128,
  M <= 64, any K in one launch, T up to a tile's rows), in place of the
  TPU's 13 MiB VMEM gates `_fact_kernel_eligible` / `_fact_tile_n` and its
  T <= 16 cap `_check_t_coh`; beyond it the entries raise and
  `harness.stages` takes the `torch.matmul` pipeline of
  `models.mfa_bank`.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators.circ_kernels import (
    _cplx_interleaved, _hc, _pool, _x2)
from quantized_channel_estimation_torch.estimators.mp_circ_kernels import (
    _interleave)
from quantized_channel_estimation_torch.models.mfa_bank import FactoredBank
from quantized_channel_estimation_torch.ops.precision import pin_fp32

FACT_MAX_D = 128   # channel dims of the factored kernels
FACT_MAX_M = 64    # latent rank of the factored kernels


def fact_tile_rows(d: int, m: int) -> int:
    """Rows of one tile of the factored kernels (8 warps of 8 rows while
    D <= 64 and M <= 32, else of 4; `dispatch` in csrc/fact_estimate.cu):
    the largest coherence block K12 pools."""
    return 64 if d <= 64 and m <= 32 else 32


def fact_kernel_eligible(d: int, k: int, m: int, t: int = 1) -> bool:
    """Can the factored kernels serve a bank of K components over D dims
    at latent rank M, pooling T-snapshot blocks? D <= 128, M <= 64, T
    within a tile's rows; any K (the kernel streams the bank one component
    at a time). A rule of the shapes, decided before any launch."""
    return (1 <= d <= FACT_MAX_D and 1 <= m <= FACT_MAX_M and k >= 1
            and 1 <= t <= fact_tile_rows(d, m))


# ---------------------------------------------------------------------------
# bank layout
# ---------------------------------------------------------------------------

class FactKernelBank(NamedTuple):
    """`mfa_bank.FactoredBank` lowered for the factored kernels, one slab
    per component, every complex quantity as interleaved [re, im] pairs
    (the JAX `FactKernelBank` holds the same numbers as split [Re | Im]
    operands over all components at once).

    fwd:   (K, 2D, 4M)  interleaved row @ fwd_k = [beta | gamma], each 2M
                        interleaved: the embeddings of T_k^T and P2_k^T
    comb:  (K, 4M, 2D)  [beta | gamma] @ comb_k = gamma Lambda^T - beta R^T
                        interleaved: the embeddings of -R_k^T, Lambda_k^T
    tmu:   (K, 2M)      T mu, interleaved
    lcoef: (K, 3D)      [2 Re(mu_r) / e | 2 Im(mu_r) / e | -1 / e] against
                        [Re r | Im r | |r|^2]
    const: (K,)         logw - logdet - mu_r^H diag(1/e) mu_r, dead
                        components at a finite -1e30 (the row constant
                        -D log pi cancels in the softmax); for T > 1 the
                        logw part divided by 1 - a + a T
    bias:  (K, 2D)      interleaved
    a1:    (K, 2D)      interleaved: psi c / e
    """
    fwd: torch.Tensor
    comb: torch.Tensor
    tmu: torch.Tensor
    lcoef: torch.Tensor
    const: torch.Tensor
    bias: torch.Tensor
    a1: torch.Tensor


def fact_kernel_bank(bank: FactoredBank, t_coh: int = 1,
                     coh_alpha: float = 1.0) -> FactKernelBank:
    """Lower a FactoredBank. t_coh > 1 lays `const` out for the coherent
    kernel K12, whose logit of a row is lg + a (sum_T lg - lg): the mixture
    log-weight is divided by that blend's coefficient 1 - a + a T so that
    it enters once per block, while logdet and the mean term count once per
    snapshot."""
    pin_fp32()
    inv_e = bank.inv_e.to(bank.t_mat.real.dtype)
    fwd = torch.cat([_cplx_interleaved(bank.t_mat.transpose(-1, -2)),
                     _cplx_interleaved(bank.p2_mat.transpose(-1, -2))],
                    dim=2)
    comb = torch.cat([-_cplx_interleaved(bank.r_t),
                      _cplx_interleaved(bank.lam_t)], dim=1)
    lcoef = torch.cat([2.0 * bank.means_r.real * inv_e,
                       2.0 * bank.means_r.imag * inv_e, -inv_e], dim=1)
    mu2 = (bank.means_r.abs() ** 2 * inv_e).sum(-1)
    const = torch.clamp(bank.log_weights - bank.logdet - mu2, min=-1e30)
    if t_coh > 1:
        lw = torch.clamp(bank.log_weights, min=-1e30)
        const = const - lw + lw / (1.0 - coh_alpha + coh_alpha * t_coh)
    f32 = torch.float32
    return FactKernelBank(*(x.to(f32).contiguous() for x in (
        fwd, comb, _interleave(bank.t_mu.real, bank.t_mu.imag), lcoef,
        const, _interleave(bank.bias.real, bank.bias.imag),
        _interleave(bank.a1.real, bank.a1.imag))))


def lowered(bank: FactoredBank, cache: Optional[dict] = None, t_coh: int = 1,
            coh_alpha: float = 1.0) -> FactKernelBank:
    """`fact_kernel_bank(bank, t_coh, coh_alpha)`, kept in `cache` (a dict
    the caller holds beside the bank) under (T, alpha), so a bank served
    many times is lowered once per layout."""
    key = (1, 1.0) if t_coh <= 1 else (int(t_coh), float(coh_alpha))
    if cache is None:
        return fact_kernel_bank(bank, *key)
    if key not in cache:
        cache[key] = fact_kernel_bank(bank, *key)
    return cache[key]


# ---------------------------------------------------------------------------
# plain versions: the kernels' own arithmetic in float32
# ---------------------------------------------------------------------------

def _fact_reference(x2, fkb, t_coh, coh_alpha, stats, chunk):
    pin_fp32()
    k, two_d, four_m = fkb.fwd.shape
    d, two_m = two_d // 2, four_m // 2
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    fwd = fkb.fwd.permute(1, 0, 2).reshape(two_d, k * four_m)
    comb = fkb.comb.reshape(k * four_m, two_d)
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    ms, dens, outs = [], [], []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        u = (xc @ fwd).reshape(n, k, four_m)             # [beta | gamma]
        diff = u[..., :two_m] - fkb.tmu[None]
        x3 = xc.reshape(n, d, 2)
        z = torch.cat([x3[..., 0], x3[..., 1], (x3 * x3).sum(-1)], dim=-1)
        lg = z @ fkb.lcoef.T + (diff * diff).sum(-1) + fkb.const[None]
        lg = _pool(lg, t_coh, coh_alpha)
        m = lg.max(-1).values
        p = torch.exp(lg - m[:, None])
        den = p.sum(-1)
        w = p if stats else p / den[:, None]
        a = (w @ fkb.a1).reshape(n, d, 2)
        h = torch.stack([a[..., 0] * x3[..., 0] - a[..., 1] * x3[..., 1],
                         a[..., 0] * x3[..., 1] + a[..., 1] * x3[..., 0]],
                        dim=-1).reshape(n, two_d)
        h = h + w @ fkb.bias + (w[..., None] * u).reshape(n, -1) @ comb
        ms.append(m)
        dens.append(den)
        outs.append(h)
    out = torch.cat(outs) if outs else x2.new_zeros((0, two_d))
    if not stats:
        return out
    if not ms:
        return x2.new_zeros((0,)), x2.new_zeros((0,)), out
    return torch.cat(ms), torch.cat(dens), out


def fact_estimate_reference(x2: torch.Tensor, fkb: FactKernelBank,
                            chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K11: the forward GEMM to [beta | gamma] of
    every component, the expanded quadratic logit
    [Re r | Im r | |r|^2] @ lcoef + |beta - T mu|^2 + const, softmax, the
    combine GEMM plus the bias and diagonal terms, all in float32.
    x2 (N, 2D) interleaved -> (N, 2D) interleaved."""
    return _fact_reference(x2, fkb, 1, 1.0, False, chunk)


def fact_estimate_coherent_reference(x2: torch.Tensor, fkb: FactKernelBank,
                                     t_coh: int, coh_alpha: float = 1.0,
                                     chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K12: K11 with the rows taken as N / T
    blocks of T consecutive rows and each logit replaced by lg + a (s - lg),
    s the block sum. fkb from `fact_kernel_bank(bank, t_coh, coh_alpha)`."""
    return _fact_reference(x2, fkb, t_coh, coh_alpha, False, chunk)


def fact_estimate_stats_reference(x2: torch.Tensor, fkb: FactKernelBank,
                                  chunk: int = 8192):
    """Plain PyTorch version of K13: K11 stopped before the normalisation:
    m (N,), den (N,) and the un-normalised accumulator (N, 2D)
    interleaved."""
    return _fact_reference(x2, fkb, 1, 1.0, True, chunk)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, x2: torch.Tensor, fkb: FactKernelBank, t_coh: int,
            coh_alpha: float, stats: bool):
    """Validate, allocate and launch on x2's device and current stream;
    raise on any refusal. Returns out, or (m, den, out) for stats."""
    n, two_d = x2.shape
    k, _, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    if (two_d % 2 or four_m % 4 or n % t_coh
            or not fact_kernel_eligible(d, k, m, t_coh)):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with D <= "
            f"{FACT_MAX_D}, M <= {FACT_MAX_M} and T <= "
            f"{fact_tile_rows(d, m)}; got N={n}, D={d}, M={m}, K={k}, "
            f"T={t_coh}")
    dev = x2.device
    kernels._check_cuda("x2", x2, (n, two_d), dev)
    kernels._check_cuda("fwd", fkb.fwd, (k, two_d, four_m), dev)
    kernels._check_cuda("comb", fkb.comb, (k, four_m, two_d), dev)
    kernels._check_cuda("tmu", fkb.tmu, (k, 2 * m), dev)
    kernels._check_cuda("lcoef", fkb.lcoef, (k, 3 * d), dev)
    kernels._check_cuda("const", fkb.const, (k,), dev)
    kernels._check_cuda("bias", fkb.bias, (k, two_d), dev)
    kernels._check_cuda("a1", fkb.a1, (k, two_d), dev)
    out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
    m_out = den = None
    if stats:
        m_out = torch.empty((n,), dtype=torch.float32, device=dev)
        den = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        lib = kernels._library("fact_estimate")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fact_estimate_launch(
                x2.data_ptr(), fkb.fwd.data_ptr(), fkb.comb.data_ptr(),
                fkb.tmu.data_ptr(), fkb.lcoef.data_ptr(),
                fkb.const.data_ptr(), fkb.bias.data_ptr(),
                fkb.a1.data_ptr(), out.data_ptr(),
                m_out.data_ptr() if stats else None,
                den.data_ptr() if stats else None, n, d, m, k, int(t_coh),
                float(coh_alpha), int(stats), stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return (m_out, den, out) if stats else out


def fact_estimate(x2: torch.Tensor, fkb: FactKernelBank) -> torch.Tensor:
    """K11 on x2 (N, 2D) float32 interleaved -> (N, 2D). On a CUDA tensor
    it launches the CUDA kernel on the current stream and raises on any
    refusal; on a CPU tensor it computes the plain version."""
    if not x2.is_cuda:
        return fact_estimate_reference(x2, fkb)
    out = _launch("fact_estimate", x2, fkb, 1, 1.0, False)
    if x2.shape[0]:
        fact_estimate.launches += 1
    return out


def fact_estimate_coherent(x2: torch.Tensor, fkb: FactKernelBank, t_coh: int,
                           coh_alpha: float = 1.0) -> torch.Tensor:
    """K12 on x2 (N, 2D), N / T blocks of T consecutive rows (2 <= T <=
    `fact_tile_rows`), fkb from `fact_kernel_bank(bank, t_coh, coh_alpha)`.
    CUDA kernel on a CUDA tensor, plain version on the CPU."""
    if t_coh < 2:
        raise ValueError(f"fact_estimate_coherent takes T >= 2; got {t_coh}")
    if not x2.is_cuda:
        return fact_estimate_coherent_reference(x2, fkb, t_coh, coh_alpha)
    out = _launch("fact_estimate_coherent", x2, fkb, t_coh, coh_alpha, False)
    if x2.shape[0]:
        fact_estimate_coherent.launches += 1
    return out


def fact_estimate_stats(x2: torch.Tensor, fkb: FactKernelBank):
    """K13 on x2 (N, 2D) -> (m (N,), den (N,), acc (N, 2D) un-normalised).
    CUDA kernel on a CUDA tensor, plain version on the CPU."""
    if not x2.is_cuda:
        return fact_estimate_stats_reference(x2, fkb)
    res = _launch("fact_estimate_stats", x2, fkb, 1, 1.0, True)
    if x2.shape[0]:
        fact_estimate_stats.launches += 1
    return res


kernels.register_wrappers(fact_estimate, fact_estimate_coherent,
                          fact_estimate_stats)


# ---------------------------------------------------------------------------
# entries on complex observations and factored banks
# ---------------------------------------------------------------------------

def _check_eligible(bank: FactoredBank, t: int) -> None:
    k, m, d = bank.t_mat.shape
    if not fact_kernel_eligible(d, k, m, t):
        raise ValueError(
            f"the factored kernels take D <= {FACT_MAX_D}, M <= {FACT_MAX_M} "
            f"and T <= {fact_tile_rows(d, m)}; got D={d}, M={m}, K={k}, "
            f"T={t}")


def estimate_fused_factored(bank: FactoredBank, r: torch.Tensor,
                            cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode factored estimate of r (N, D) complex -> (N, D) through
    K11: the kernel analog of `mfa_bank.estimate_factored` (selection modes
    stay on the pipeline). Raises outside `fact_kernel_eligible`
    (`harness.stages.estimate_factored` sends those to the pipeline).
    `cache`: see `lowered`."""
    _check_eligible(bank, 1)
    return _hc(fact_estimate(_x2(r), lowered(bank, cache)), r.dtype)


def estimate_fused_factored_coherent(bank: FactoredBank, r: torch.Tensor,
                                     alpha: float = 1.0,
                                     cache: Optional[dict] = None
                                     ) -> torch.Tensor:
    """Coherent 'all'-mode factored estimate of blocks r (B, T, D) ->
    (B, T, D): the kernel analog of `mfa_bank.estimate_factored_coherent`.
    T = 1 runs K11; T within `fact_kernel_eligible` runs K12 with the alpha
    blend in the kernel; beyond the rule it raises. `cache`: see
    `lowered`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, D) blocks, got {tuple(r.shape)}")
    b, t, d = r.shape
    if t == 1:
        return estimate_fused_factored(bank, r[:, 0, :], cache)[:, None, :]
    _check_eligible(bank, t)
    h2 = fact_estimate_coherent(_x2(r), lowered(bank, cache, t, alpha), t,
                                alpha)
    return _hc(h2, r.dtype).reshape(b, t, d)


def estimate_fused_factored_stats(bank: FactoredBank, r: torch.Tensor):
    """Kernel analog of `mfa_bank.estimate_factored_stats` through K13:
    (m (N,), den (N,), acc (N, D) complex64) of a (component shard of a)
    factored bank, in the logit convention of `mfa_bank._stats_chunk`, so
    kernel and pipeline shard states merge with `circ_kernels.merge_stats`.
    """
    _check_eligible(bank, 1)
    m, den, acc2 = fact_estimate_stats(_x2(r), fact_kernel_bank(bank))
    return m, den, _hc(acc2, torch.complex64)
