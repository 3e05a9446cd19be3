"""The hand-written multi-pilot circulant estimation kernel K10 (flat and
coherent) and its plain versions.

Port of the multi-pilot section of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`:
`MpCircKernelBank`, `mp_circ_kernel_bank` (with `blocks`), and the entries
`estimate_fused_circulant_mp` and `estimate_fused_circulant_mp_coherent`.
Both forms are one CUDA C++ template with a COH flag in
`csrc/mp_circ_estimate.cu`, built and bound by `estimators.kernels` (nvcc,
ctypes, launch counts); the tile product, the pool over a coherence block
and the softmax are those of the single-pilot kernels
(`csrc/circ_common.cuh`).

Differences of layout from the TPU kernel, none of arithmetic:

- the observation rows are a complex64 tensor's interleaved [re, im]
  pairs, pilot-major: (N, P*D) complex viewed as (N*P, D) is each pilot's
  segment as a row, so the forward transform is K6's first phase with the
  one (2D, 2D) operand on P*N rows. The TPU kernel takes a
  [Re r_1..Re r_P | Im r_1..Im r_P] split copy and P mostly-zero (2PD, D)
  operands, a work-around for its lane slicing;
- the features of the logit product are ordered [u | |u_p|^2 | pairs] (see
  `MpCircKernelBank`), the u part being the transformed row itself; the
  CUDA kernel forms one group of them at a time in shared memory, so a
  tile's rows do not shrink with P;
- the combine operands are (P + 1) interleaved (K, 2D) slabs;
- coherence blocks are block-major (the T rows of a block consecutive);
- the eligibility rule `mp_circ_kernel_eligible` is the CUDA kernel's range
  (D, K <= 128, T up to a tile's rows, and the tile within a block's
  shared memory, which bounds P), in place of the TPU's resident-bank
  budget. The TPU package has no stats form of this kernel, so a bank of
  more than 128 components is not split: beyond the rule the entries raise
  and `harness.stages` takes the `torch.fft` pipeline.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators.circ_kernels import (
    CIRC_MAX_D, CIRC_MAX_K, _cplx_interleaved, _hc, _pool, _x2,
    circ_tile_rows)
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBankMP)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

SMEM_BLOCK_BYTES = 232_448   # shared memory one block can use on sm_90
RING_FLOATS = 2 * 4096       # the two-buffer operand ring (circ_common.cuh)


def mp_circ_smem_bytes(d: int, k: int, p: int) -> int:
    """Shared memory of one block of K10: a tile of `circ_tile_rows(d)`
    rows of [u (2PD) | one feature group (2D) | w (K)] floats, rounded up
    to whole float4s, and the operand ring (`row_stride` and `launch` in
    csrc/mp_circ_estimate.cu)."""
    stride = (2 * p * d + 2 * d + k + 3) & ~3
    return 4 * (circ_tile_rows(d) * stride + RING_FLOATS)


def mp_circ_kernel_eligible(d: int, k: int, p: int, t: int = 1) -> bool:
    """Can K10 serve a multi-pilot bank of K components over D bins and P
    pilots, pooling T-snapshot blocks? D, K <= 128, T within a tile's rows
    and the tile within a block's shared memory (at D = K = 64 that admits
    P <= 4). A rule of the shapes, decided before any launch."""
    return (1 <= d <= CIRC_MAX_D and 1 <= k <= CIRC_MAX_K and p >= 1
            and 1 <= t <= circ_tile_rows(d)
            and mp_circ_smem_bytes(d, k, p) <= SMEM_BLOCK_BYTES)


# ---------------------------------------------------------------------------
# bank layout
# ---------------------------------------------------------------------------

class MpCircKernelBank(NamedTuple):
    """`structured_bank.CirculantBankMP` lowered for K10: one operand a
    phase, every complex quantity as interleaved [re, im] pairs (the JAX
    `MpCircKernelBank` holds the same numbers split into Re and Im
    operands, the forward transform once per pilot).

    bfwd:  (2D, 2D)  right-multiplication by F^T on interleaved rows
    lcoef: (F, K)    F = D (3P + P (P-1)) feature rows, against
                     [u | |u_1|^2 .. |u_P|^2 | v_12 v_13 .. v_(P-1)P]:
                     rows 2 (p D + c), + 1: 2 Re pm_p, 2 Im pm_p,
                     pm = prec @ mean; rows 2PD + p D + c: -Re prec_pp;
                     then per pair p < q, v_pq = conj(u_p) u_q interleaved:
                     rows 2c, 2c + 1: -2 Re prec_pq, +2 Im prec_pq
    const: (K,)      logw - logdet - m^H prec m - PD log pi (the row
                     constant stays; it cancels in the softmax), dead
                     components at a finite -1e30; for T > 1 the logw part
                     divided by 1 - a + a T
    comb:  (P+1, K, 2D)  slab 0 the bias, slab p the filter of pilot p,
                     interleaved per bin
    binv:  (2D, 2D)  right-multiplication by conj(F)
    """
    bfwd: torch.Tensor
    lcoef: torch.Tensor
    const: torch.Tensor
    comb: torch.Tensor
    binv: torch.Tensor


def _interleave(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(K, D) real pairs -> (K, 2D) with [re, im] interleaved per bin."""
    return torch.stack([re, im], dim=-1).reshape(re.shape[0], -1)


def mp_circ_kernel_bank(bank: CirculantBankMP, blocks=None, t_coh: int = 1,
                        coh_alpha: float = 1.0) -> MpCircKernelBank:
    """Lower a CirculantBankMP. The logit constants come from
    `structured_bank._mp_consts`, the one computation of the expanded
    quadratic shared with the `torch.fft` pipeline. `blocks=(n1, n2)`
    builds the kron(F_n1, F_n2) basis. t_coh > 1 lays `const` out for the
    coherent form, whose logit of a row is lg + a (sum_T lg - lg): the
    mixture log-weight is divided by that blend's coefficient 1 - a + a T
    so that it enters once per block."""
    pin_fp32()
    k, d, p = bank.mean_rf.shape
    f = sb._dft_matrix(d, blocks, bank.mean_rf.dtype, bank.mean_rf.device)
    mc = sb._mp_consts(bank)
    const = mc.const_k
    if t_coh > 1:
        lw = torch.clamp(bank.log_weights, min=-1e30)
        const = const - lw + lw / (1.0 - coh_alpha + coh_alpha * t_coh)
    coefs = [_interleave(2.0 * mc.pm_flat.real, 2.0 * mc.pm_flat.imag)]
    coefs += [-mc.prec_re[:, :, pi, pi] for pi in range(p)]
    coefs += [_interleave(-2.0 * mc.prec_re[:, :, pi, qi],
                          2.0 * mc.prec_im[:, :, pi, qi])
              for pi in range(p) for qi in range(pi + 1, p)]
    comb = torch.stack(
        [_interleave(bank.bias_f.real, bank.bias_f.imag)]
        + [_interleave(bank.filt_f[:, :, pi].real, bank.filt_f[:, :, pi].imag)
           for pi in range(p)])
    f32 = torch.float32
    return MpCircKernelBank(_cplx_interleaved(f.T).to(f32).contiguous(),
                            torch.cat(coefs, dim=1).T.to(f32).contiguous(),
                            const.to(f32).contiguous(),
                            comb.to(f32).contiguous(),
                            _cplx_interleaved(f.conj()).to(f32).contiguous())


def lowered(bank: CirculantBankMP, cache: Optional[dict] = None, blocks=None,
            t_coh: int = 1, coh_alpha: float = 1.0) -> MpCircKernelBank:
    """`mp_circ_kernel_bank(bank, blocks, t_coh, coh_alpha)`, kept in
    `cache` (a dict the caller holds beside the bank) under
    (blocks, T, alpha), so a bank served many times is lowered once per
    layout."""
    key = (blocks, 1, 1.0) if t_coh <= 1 else (blocks, int(t_coh),
                                               float(coh_alpha))
    if cache is None:
        return mp_circ_kernel_bank(bank, *key)
    if key not in cache:
        cache[key] = mp_circ_kernel_bank(bank, *key)
    return cache[key]


# ---------------------------------------------------------------------------
# plain versions: the kernel's own arithmetic in float32
# ---------------------------------------------------------------------------

def _mp_reference(x2, ckb, t_coh, coh_alpha, chunk):
    pin_fp32()
    two_d = ckb.bfwd.shape[0]
    d, p = two_d // 2, ckb.comb.shape[0] - 1
    k = ckb.const.shape[0]
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    comb = ckb.comb.permute(1, 0, 2).reshape(k, (p + 1) * two_d)
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    outs = []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        u = (xc.reshape(n * p, two_d) @ ckb.bfwd).reshape(n, p, d, 2)
        ur, ui = u[..., 0], u[..., 1]                        # (n, P, D)
        feats = [u.reshape(n, p * two_d), (ur * ur + ui * ui).reshape(n, -1)]
        for pi in range(p):
            for qi in range(pi + 1, p):                      # conj(u_p) u_q
                feats.append(torch.stack(
                    [ur[:, pi] * ur[:, qi] + ui[:, pi] * ui[:, qi],
                     ur[:, pi] * ui[:, qi] - ui[:, pi] * ur[:, qi]],
                    dim=-1).reshape(n, two_d))
        lg = torch.cat(feats, dim=-1) @ ckb.lcoef + ckb.const[None]
        w = torch.softmax(_pool(lg, t_coh, coh_alpha), dim=-1)
        c = (w @ comb).reshape(n, p + 1, d, 2)
        fr, fi = c[:, 1:, :, 0], c[:, 1:, :, 1]
        hr = c[:, 0, :, 0] + (fr * ur - fi * ui).sum(1)
        hi = c[:, 0, :, 1] + (fr * ui + fi * ur).sum(1)
        outs.append(torch.stack([hr, hi], dim=-1).reshape(n, two_d)
                    @ ckb.binv)
    return torch.cat(outs) if outs else x2.new_zeros((0, two_d))


def mp_circ_estimate_reference(x2: torch.Tensor, ckb: MpCircKernelBank,
                               chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K10: the forward DFT GEMM of each pilot
    segment, the expanded quadratic logit from one (F, K) product, softmax,
    the P + 1 combine products, inverse DFT GEMM, all in float32.
    x2 (N, 2PD) interleaved, pilot-major -> (N, 2D) interleaved."""
    return _mp_reference(x2, ckb, 1, 1.0, chunk)


def mp_circ_estimate_coherent_reference(x2: torch.Tensor,
                                        ckb: MpCircKernelBank, t_coh: int,
                                        coh_alpha: float = 1.0,
                                        chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the coherent K10: the flat form with the
    rows taken as N / T blocks of T consecutive rows and each logit
    replaced by lg + a (s - lg), s the block sum. ckb from
    `mp_circ_kernel_bank(bank, blocks, t_coh, coh_alpha)`."""
    return _mp_reference(x2, ckb, t_coh, coh_alpha, chunk)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, x2: torch.Tensor, ckb: MpCircKernelBank, t_coh: int,
            coh_alpha: float) -> torch.Tensor:
    """Validate, allocate and launch on x2's device and current stream;
    raise on any refusal."""
    n = x2.shape[0]
    two_d = ckb.bfwd.shape[0]
    d, p = two_d // 2, ckb.comb.shape[0] - 1
    k = ckb.const.shape[0]
    if n % t_coh or not mp_circ_kernel_eligible(d, k, p, t_coh):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with D, K <= "
            f"{CIRC_MAX_D}, {CIRC_MAX_K}, T <= {circ_tile_rows(d)} and "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory; got N={n}, D={d}, "
            f"K={k}, P={p}, T={t_coh} ({mp_circ_smem_bytes(d, k, p)} bytes)")
    dev = x2.device
    feat = d * (3 * p + p * (p - 1))
    kernels._check_cuda("x2", x2, (n, p * two_d), dev)
    kernels._check_cuda("bfwd", ckb.bfwd, (two_d, two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (feat, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (p + 1, k, two_d), dev)
    kernels._check_cuda("binv", ckb.binv, (two_d, two_d), dev)
    out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
    if n:
        lib = kernels._library("mp_circ_estimate")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp_circ_estimate_launch(
                x2.data_ptr(), ckb.bfwd.data_ptr(), ckb.lcoef.data_ptr(),
                ckb.const.data_ptr(), ckb.comb.data_ptr(),
                ckb.binv.data_ptr(), out.data_ptr(), n, d, p, k, int(t_coh),
                float(coh_alpha), stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def mp_circ_estimate(x2: torch.Tensor, ckb: MpCircKernelBank) -> torch.Tensor:
    """K10 on x2 (N, 2PD) float32 interleaved, pilot-major -> (N, 2D). On a
    CUDA tensor it launches the CUDA kernel on the current stream and
    raises on any refusal; on a CPU tensor it computes the plain version."""
    if not x2.is_cuda:
        return mp_circ_estimate_reference(x2, ckb)
    out = _launch("mp_circ_estimate", x2, ckb, 1, 1.0)
    if x2.shape[0]:
        mp_circ_estimate.launches += 1
    return out


def mp_circ_estimate_coherent(x2: torch.Tensor, ckb: MpCircKernelBank,
                              t_coh: int,
                              coh_alpha: float = 1.0) -> torch.Tensor:
    """The coherent K10 on x2 (N, 2PD), N / T blocks of T consecutive rows
    (2 <= T <= `circ_tile_rows`), ckb from `mp_circ_kernel_bank(bank,
    blocks, t_coh, coh_alpha)`. CUDA kernel on a CUDA tensor, plain version
    on the CPU."""
    if t_coh < 2:
        raise ValueError(f"mp_circ_estimate_coherent takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return mp_circ_estimate_coherent_reference(x2, ckb, t_coh, coh_alpha)
    out = _launch("mp_circ_estimate_coherent", x2, ckb, t_coh, coh_alpha)
    if x2.shape[0]:
        mp_circ_estimate_coherent.launches += 1
    return out


kernels.register_wrappers(mp_circ_estimate, mp_circ_estimate_coherent)


# ---------------------------------------------------------------------------
# entries on complex observations and multi-pilot banks
# ---------------------------------------------------------------------------

def _check_eligible(bank: CirculantBankMP, t: int) -> None:
    k, d, p = bank.mean_rf.shape
    if not mp_circ_kernel_eligible(d, k, p, t):
        raise ValueError(
            f"the multi-pilot circulant kernel takes D, K <= {CIRC_MAX_D}, "
            f"{CIRC_MAX_K}, T <= {circ_tile_rows(d)} and a tile within "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory; got D={d}, K={k}, "
            f"P={p}, T={t} ({mp_circ_smem_bytes(d, k, p)} bytes)")


def estimate_fused_circulant_mp(bank: CirculantBankMP, r: torch.Tensor,
                                blocks=None,
                                cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode multi-pilot structured estimate of r (N, P*D) complex ->
    (N, D) through K10: the kernel analog of
    `structured_bank.estimate_circulant_mp` (selection modes stay on the
    `torch.fft` path). Raises outside `mp_circ_kernel_eligible`
    (`harness.stages.estimate_circulant` sends those to the pipeline).
    `cache`: see `lowered`."""
    _check_eligible(bank, 1)
    return _hc(mp_circ_estimate(_x2(r), lowered(bank, cache, blocks)),
               r.dtype)


def estimate_fused_circulant_mp_coherent(bank: CirculantBankMP,
                                         r: torch.Tensor, alpha: float = 1.0,
                                         blocks=None,
                                         cache: Optional[dict] = None
                                         ) -> torch.Tensor:
    """Coherent 'all'-mode multi-pilot structured estimate of blocks
    r (B, T, P*D) -> (B, T, D): the kernel analog of
    `structured_bank.estimate_circulant_mp_coherent`. T = 1 runs the flat
    form; T within `mp_circ_kernel_eligible` runs the coherent form with
    the alpha blend in the kernel; beyond the rule it raises. `cache`: see
    `lowered`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, P*D) blocks, got "
                         f"{tuple(r.shape)}")
    b, t, _ = r.shape
    if t == 1:
        return estimate_fused_circulant_mp(bank, r[:, 0, :], blocks,
                                           cache)[:, None, :]
    _check_eligible(bank, t)
    h2 = mp_circ_estimate_coherent(_x2(r), lowered(bank, cache, blocks, t,
                                                   alpha), t, alpha)
    return _hc(h2, r.dtype).reshape(b, t, -1)
