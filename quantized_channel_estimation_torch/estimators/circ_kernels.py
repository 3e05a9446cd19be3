"""The hand-written circulant (FFT-domain) estimation kernels and their
plain versions.

Port of the structured-bank section of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`:
`CircKernelBank`, `circ_kernel_bank` (with `blocks`), and the
entries `estimate_fused_circulant` (K6), `estimate_fused_circulant_coherent`
(K7), `estimate_fused_circulant_stats` (K8) and
`estimate_fused_circulant_coherent_stats` (K9). The four kernels are one
CUDA C++ template with COH and STATS flags in `csrc/circ_estimate.cu`,
built and bound by `estimators.kernels` (nvcc, ctypes, launch counts);
shard states merge with `kernels.merge_stats`.

Differences of layout from the TPU kernels, none of arithmetic:

- complex rows are interleaved [re, im] pairs, the memory layout of a
  complex64 tensor, so the kernels read the observations and write the
  estimates in place of the [Re | Im] split copies of the TPU path; the
  bank operands are laid out to match (see `CircKernelBank`);
- coherence blocks are block-major (the T rows of a block consecutive), as
  in `ops.scm.flatten_coherence` and K3, not the TPU's T-major tiles;
- the eligibility rule `circ_kernel_eligible` is the CUDA kernel's range
  (D <= 128, T up to a tile's rows), in place of the TPU's resident-bank
  budget; beyond it the entries raise and `harness.stages` takes the
  `torch.fft` pipeline. One launch
  takes K <= 128 components; a larger bank is split over K into shards of
  128, each through the stats kernel (K8 / K9), merged with `merge_stats`
  and inverse-transformed once.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators.kernels import merge_stats
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

CIRC_MAX_D = 128   # bins of the circulant kernels
CIRC_MAX_K = 128   # components of the circulant kernels


def circ_tile_rows(d: int) -> int:
    """Rows of one tile of the circulant kernels (8 warps of 8 rows up to
    D = 64, else of 4; `dispatch` in csrc/circ_estimate.cu): the largest
    coherence block K7/K9 pool."""
    return 64 if d <= 64 else 32


def circ_kernel_eligible(d: int, k: int, t: int = 1) -> bool:
    """Can the circulant kernels serve a bank of K components over D bins,
    pooling T-snapshot blocks? D <= 128 and T within a tile's rows; any K
    (more than 128 components are split into shards, see
    `estimate_fused_circulant`). A rule of the shapes, decided before any
    launch."""
    return 1 <= d <= CIRC_MAX_D and k >= 1 and 1 <= t <= circ_tile_rows(d)


# ---------------------------------------------------------------------------
# bank layout
# ---------------------------------------------------------------------------

class CircKernelBank(NamedTuple):
    """`structured_bank.CirculantBank` lowered for the circulant kernels:
    one operand a phase, every complex quantity as interleaved [re, im]
    pairs (the JAX `CircKernelBank` holds the same numbers split into Re
    and Im operands).

    bfwd:  (2D, 2D)  right-multiplication by F^T on interleaved rows
    lcoef: (3D, K)   rows 2c, 2c+1: 2 Re cm, -2 Im cm; rows 2D + c: -prec,
                     cm = conj(mean_rf) prec, against [u | |u|^2]
    const: (K,)      logw - mu2 + logdet, dead components floored at -1e30
                     (the row-constant -D log pi cancels in the softmax);
                     for T > 1 the logw part divided by 1 - a + a T
    comb:  (K, 4D)   per bin [Re bias, Im bias, Re filt, Im filt]
    binv:  (2D, 2D)  right-multiplication by conj(F)
    """
    bfwd: torch.Tensor
    lcoef: torch.Tensor
    const: torch.Tensor
    comb: torch.Tensor
    binv: torch.Tensor


def _cplx_interleaved(b: torch.Tensor) -> torch.Tensor:
    """(..., D, P) complex -> (..., 2D, 2P) real with [x_re, x_im] rows
    interleaved @ it = [Re(x b), Im(x b)] interleaved: the 2x2 block
    [[re, im], [-im, re]] of every entry."""
    d, p = b.shape[-2:]
    top = torch.stack([b.real, b.imag], dim=-1)        # rows 2d
    bot = torch.stack([-b.imag, b.real], dim=-1)       # rows 2d + 1
    return torch.stack([top, bot], dim=-3).reshape(b.shape[:-2]
                                                   + (2 * d, 2 * p))


def circ_kernel_bank(bank: CirculantBank, blocks=None, t_coh: int = 1,
                     coh_alpha: float = 1.0) -> CircKernelBank:
    """Lower a CirculantBank. `blocks=(n1, n2)` builds the
    kron(F_n1, F_n2) basis, so block-circulant banks ride the same kernels:
    the transform is a matrix either way. t_coh > 1 lays `const` out for
    the coherent kernels K7/K9, whose logit of a row is
    lg + a (sum_T lg - lg): the mixture log-weight is divided by that
    blend's coefficient 1 - a + a T so that it enters once per block, while
    the log-det and mean terms count once per snapshot."""
    pin_fp32()
    k, d = bank.spec_cr.shape
    f = sb._dft_matrix(d, blocks, bank.mean_rf.dtype, bank.mean_rf.device)
    prec = 1.0 / bank.spec_cr
    cm = bank.mean_rf.conj() * prec
    mu2 = (bank.mean_rf.abs() ** 2 * prec).sum(-1)
    logdet = -torch.log(bank.spec_cr).sum(-1)
    lw = torch.clamp(bank.log_weights, min=-1e30)
    lw_div = 1.0 - coh_alpha + coh_alpha * t_coh
    const = torch.clamp(lw - mu2 + logdet, min=-1e30)
    if t_coh > 1:
        const = const - lw + lw / lw_div
    lcoef = torch.cat(
        [torch.stack([2.0 * cm.real, -2.0 * cm.imag], dim=-1).reshape(
            k, 2 * d).T, -prec.T], dim=0)
    comb = torch.stack([bank.bias_f.real, bank.bias_f.imag,
                        bank.filt_f.real, bank.filt_f.imag],
                       dim=-1).reshape(k, 4 * d)
    f32 = torch.float32
    return CircKernelBank(_cplx_interleaved(f.T).to(f32).contiguous(),
                          lcoef.to(f32).contiguous(),
                          const.to(f32).contiguous(),
                          comb.to(f32).contiguous(),
                          _cplx_interleaved(f.conj()).to(f32).contiguous())


def lowered(bank: CirculantBank, cache: Optional[dict] = None, blocks=None,
            t_coh: int = 1, coh_alpha: float = 1.0):
    """The kernel layouts of `bank`, one `circ_kernel_bank(shard, blocks,
    t_coh, coh_alpha)` per shard of at most 128 components (a tuple of
    one for K <= 128), kept in `cache` (a dict the caller holds beside the
    bank) under (blocks, T, alpha), so a bank served many times is lowered
    once per layout."""
    key = (blocks, 1, 1.0) if t_coh <= 1 else (blocks, int(t_coh),
                                               float(coh_alpha))
    if cache is not None and key in cache:
        return cache[key]
    k = bank.spec_cr.shape[0]
    ckbs = tuple(circ_kernel_bank(
        CirculantBank(*(x[k0:k0 + CIRC_MAX_K] for x in bank)), *key)
        for k0 in range(0, k, CIRC_MAX_K))
    if cache is not None:
        cache[key] = ckbs
    return ckbs


def _x2(r: torch.Tensor) -> torch.Tensor:
    """Complex observations (..., D) -> float32 rows of interleaved
    [re, im] pairs (n, 2D): a view of a contiguous complex64 tensor."""
    x = torch.view_as_real(r.to(torch.complex64).contiguous())
    return x.reshape(-1, 2 * r.shape[-1])


def _hc(h2: torch.Tensor, dtype) -> torch.Tensor:
    """float32 interleaved rows (n, 2D) -> complex (n, D) of `dtype`."""
    return torch.view_as_complex(h2.reshape(h2.shape[0], -1, 2)).to(dtype)


# ---------------------------------------------------------------------------
# plain versions: the kernels' own arithmetic in float32
# ---------------------------------------------------------------------------

def _circ_logits(x2: torch.Tensor, ckb: CircKernelBank):
    """Forward transform and logits of rows x2 (n, 2D): u (n, D, 2) and
    lg (n, K) = [u | |u|^2] @ lcoef + const (the expanded quadratic)."""
    u = x2 @ ckb.bfwd
    u3 = u.reshape(u.shape[0], -1, 2)
    z = torch.cat([u, (u3 * u3).sum(-1)], dim=-1)
    return u3, z @ ckb.lcoef + ckb.const[None]


def _pool(lg: torch.Tensor, t_coh: int, coh_alpha: float) -> torch.Tensor:
    """lg + a (s - lg), s the sum over each block of T consecutive rows
    (a >= 1: s)."""
    if t_coh <= 1:
        return lg
    lg3 = lg.reshape(-1, t_coh, lg.shape[-1])
    s = lg3.sum(1, keepdim=True)
    out = s.expand_as(lg3) if coh_alpha >= 1.0 \
        else lg3 + coh_alpha * (s - lg3)
    return out.reshape(lg.shape)


def _combine(u3: torch.Tensor, w: torch.Tensor,
             ckb: CircKernelBank) -> torch.Tensor:
    """h = w @ bias + (w @ filt) * u, interleaved (n, 2D)."""
    c = (w @ ckb.comb).reshape(w.shape[0], -1, 4)
    ur, ui = u3[..., 0], u3[..., 1]
    hr = c[..., 0] + c[..., 2] * ur - c[..., 3] * ui
    hi = c[..., 1] + c[..., 2] * ui + c[..., 3] * ur
    return torch.stack([hr, hi], dim=-1).reshape(w.shape[0], -1)


def _circ_reference(x2, ckb, t_coh, coh_alpha, stats, chunk):
    pin_fp32()
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    ms, dens, outs = [], [], []
    for i0 in range(0, x2.shape[0], chunk):
        u3, lg = _circ_logits(x2[i0:i0 + chunk], ckb)
        lg = _pool(lg, t_coh, coh_alpha)
        m = lg.max(-1).values
        p = torch.exp(lg - m[:, None])
        den = p.sum(-1)
        if stats:
            ms.append(m)
            dens.append(den)
            outs.append(_combine(u3, p, ckb))
        else:
            outs.append(_combine(u3, p / den[:, None], ckb) @ ckb.binv)
    out = torch.cat(outs) if outs else x2.new_zeros((0, x2.shape[1]))
    if not stats:
        return out
    if not ms:
        return x2.new_zeros((0,)), x2.new_zeros((0,)), out
    return torch.cat(ms), torch.cat(dens), out


def circ_estimate_reference(x2: torch.Tensor, ckb: CircKernelBank,
                            chunk: int = 16384) -> torch.Tensor:
    """Plain PyTorch version of K6: forward DFT GEMM, the expanded
    quadratic logit from one (3D, K) product, softmax, combine, inverse DFT
    GEMM, all in float32. x2 (N, 2D) interleaved -> (N, 2D) interleaved."""
    return _circ_reference(x2, ckb, 1, 1.0, False, chunk)


def circ_estimate_coherent_reference(x2: torch.Tensor, ckb: CircKernelBank,
                                     t_coh: int, coh_alpha: float = 1.0,
                                     chunk: int = 16384) -> torch.Tensor:
    """Plain PyTorch version of K7: K6 with the rows taken as N / T blocks
    of T consecutive rows and each logit replaced by lg + a (s - lg), s the
    block sum. ckb from `circ_kernel_bank(bank, blocks, t_coh,
    coh_alpha)`."""
    return _circ_reference(x2, ckb, t_coh, coh_alpha, False, chunk)


def circ_estimate_stats_reference(x2: torch.Tensor, ckb: CircKernelBank,
                                  chunk: int = 16384):
    """Plain PyTorch version of K8: K6 stopped before the normalisation and
    the inverse transform: m (N,), den (N,) and the un-normalised
    DFT-domain accumulator (N, 2D) interleaved."""
    return _circ_reference(x2, ckb, 1, 1.0, True, chunk)


def circ_estimate_coherent_stats_reference(x2: torch.Tensor,
                                           ckb: CircKernelBank, t_coh: int,
                                           coh_alpha: float = 1.0,
                                           chunk: int = 16384):
    """Plain PyTorch version of K9: the stats form of K7, m and den per
    row (equal within a block at alpha >= 1)."""
    return _circ_reference(x2, ckb, t_coh, coh_alpha, True, chunk)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
            coh_alpha: float, stats: bool):
    """Validate, allocate and launch on x2's device and current stream;
    raise on any refusal. Returns out, or (m, den, out) for stats."""
    n, two_d = x2.shape
    d = two_d // 2
    k = ckb.const.shape[0]
    if (two_d % 2 or k > CIRC_MAX_K or n % t_coh
            or not circ_kernel_eligible(d, k, t_coh)):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with D, K <= "
            f"{CIRC_MAX_D}, {CIRC_MAX_K} and T <= {circ_tile_rows(d)}; got "
            f"N={n}, D={d}, K={k}, T={t_coh}")
    dev = x2.device
    kernels._check_cuda("x2", x2, (n, two_d), dev)
    kernels._check_cuda("bfwd", ckb.bfwd, (two_d, two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (3 * d, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (k, 4 * d), dev)
    kernels._check_cuda("binv", ckb.binv, (two_d, two_d), dev)
    out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
    m = den = None
    if stats:
        m = torch.empty((n,), dtype=torch.float32, device=dev)
        den = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        lib = kernels._library("circ_estimate")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.circ_estimate_launch(
                x2.data_ptr(), ckb.bfwd.data_ptr(), ckb.lcoef.data_ptr(),
                ckb.const.data_ptr(), ckb.comb.data_ptr(),
                ckb.binv.data_ptr(), out.data_ptr(),
                m.data_ptr() if stats else None,
                den.data_ptr() if stats else None, n, d, k, int(t_coh),
                float(coh_alpha), int(stats), stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return (m, den, out) if stats else out


def circ_estimate(x2: torch.Tensor, ckb: CircKernelBank) -> torch.Tensor:
    """K6 on x2 (N, 2D) float32 interleaved -> (N, 2D). On a CUDA tensor it
    launches the CUDA kernel on the current stream and raises on any
    refusal; on a CPU tensor it computes the plain version."""
    if not x2.is_cuda:
        return circ_estimate_reference(x2, ckb)
    out = _launch("circ_estimate", x2, ckb, 1, 1.0, False)
    if x2.shape[0]:
        circ_estimate.launches += 1
    return out


def circ_estimate_coherent(x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
                           coh_alpha: float = 1.0) -> torch.Tensor:
    """K7 on x2 (N, 2D), N / T blocks of T consecutive rows (2 <= T <=
    `circ_tile_rows`), ckb from `circ_kernel_bank(bank, blocks, t_coh,
    coh_alpha)`. CUDA kernel on a CUDA tensor, plain version on the CPU."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent takes T >= 2; got {t_coh}")
    if not x2.is_cuda:
        return circ_estimate_coherent_reference(x2, ckb, t_coh, coh_alpha)
    out = _launch("circ_estimate_coherent", x2, ckb, t_coh, coh_alpha, False)
    if x2.shape[0]:
        circ_estimate_coherent.launches += 1
    return out


def circ_estimate_stats(x2: torch.Tensor, ckb: CircKernelBank):
    """K8 on x2 (N, 2D) -> (m (N,), den (N,), acc (N, 2D) in the DFT
    domain). CUDA kernel on a CUDA tensor, plain version on the CPU."""
    if not x2.is_cuda:
        return circ_estimate_stats_reference(x2, ckb)
    res = _launch("circ_estimate_stats", x2, ckb, 1, 1.0, True)
    if x2.shape[0]:
        circ_estimate_stats.launches += 1
    return res


def circ_estimate_coherent_stats(x2: torch.Tensor, ckb: CircKernelBank,
                                 t_coh: int, coh_alpha: float = 1.0):
    """K9 on x2 (N, 2D) of T-row blocks -> per-row (m (N,), den (N,)) and
    acc (N, 2D) in the DFT domain. CUDA kernel on a CUDA tensor, plain
    version on the CPU."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent_stats takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return circ_estimate_coherent_stats_reference(x2, ckb, t_coh,
                                                      coh_alpha)
    res = _launch("circ_estimate_coherent_stats", x2, ckb, t_coh, coh_alpha,
                  True)
    if x2.shape[0]:
        circ_estimate_coherent_stats.launches += 1
    return res


kernels.register_wrappers(circ_estimate, circ_estimate_coherent,
                          circ_estimate_stats, circ_estimate_coherent_stats)


# ---------------------------------------------------------------------------
# entries on complex observations and circulant banks
# ---------------------------------------------------------------------------

def _merged(states, blocks, dtype) -> torch.Tensor:
    """Per-row stats states of disjoint component shards -> the estimate:
    merge, normalise, one inverse transform. -> (N, D) complex."""
    _, den, acc = merge_stats(*zip(*states))
    return sb.unitary_ifft(_hc(acc / den[:, None], torch.complex64),
                           blocks).to(dtype)


def estimate_fused_circulant(bank: CirculantBank, r: torch.Tensor,
                             blocks=None,
                             cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode structured estimate of r (N, M) complex -> (N, D): the
    kernel analog of `structured_bank.estimate_circulant` (`blocks` selects
    the kron basis of block-circulant banks; selection modes stay on the
    `torch.fft` path). K <= 128 is one launch of K6; a larger bank runs K8
    on each shard of 128 components and merges the states. `cache`: see
    `lowered`."""
    ckbs = lowered(bank, cache, blocks)
    x2 = _x2(r)
    if len(ckbs) == 1:
        return _hc(circ_estimate(x2, ckbs[0]), r.dtype)
    return _merged([circ_estimate_stats(x2, c) for c in ckbs], blocks,
                   r.dtype)


def estimate_fused_circulant_coherent(bank: CirculantBank, r: torch.Tensor,
                                      alpha: float = 1.0, blocks=None,
                                      cache: Optional[dict] = None
                                      ) -> torch.Tensor:
    """Coherent 'all'-mode structured estimate of blocks r (B, T, M) ->
    (B, T, D): the kernel analog of
    `structured_bank.estimate_circulant_coherent`. T = 1 runs K6; T within
    `circ_kernel_eligible` runs K7 with the alpha blend in the kernel (K9
    per shard and a merge for K > 128); a larger T raises
    (`harness.stages.estimate_circulant_coherent` sends it to the
    `torch.fft` coherent path). `cache`: see `lowered`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, d = r.shape
    if t == 1:
        return estimate_fused_circulant(bank, r[:, 0, :], blocks,
                                        cache)[:, None, :]
    if not circ_kernel_eligible(d, bank.spec_cr.shape[0], t):
        raise ValueError(
            f"the coherent circulant kernels take D <= {CIRC_MAX_D} and "
            f"T <= {circ_tile_rows(d)}; got D={d}, T={t}")
    ckbs = lowered(bank, cache, blocks, t, alpha)
    x2 = _x2(r)
    if len(ckbs) == 1:
        h = _hc(circ_estimate_coherent(x2, ckbs[0], t, alpha), r.dtype)
    else:
        h = _merged([circ_estimate_coherent_stats(x2, c, t, alpha)
                     for c in ckbs], blocks, r.dtype)
    return h.reshape(b, t, d)


def estimate_fused_circulant_stats(bank: CirculantBank, r: torch.Tensor,
                                   blocks=None):
    """Kernel analog of `structured_bank.estimate_circulant_stats` through
    K8: (m (N,), den (N,), acc (N, D) complex64 in the DFT domain) of a
    (component shard of a) bank, `blocks` selecting the kron basis of a
    block-circulant one; a bank past one launch's 128 components runs K8
    on each 128-component part and merges the states. Merge kernel states
    with kernel states (`merge_stats`): their logits drop the row constant
    -D log pi."""
    x2 = _x2(r)
    m, den, acc2 = merge_stats(*zip(*[circ_estimate_stats(x2, c)
                                      for c in lowered(bank, None, blocks)]))
    return m, den, _hc(acc2, torch.complex64)


def estimate_fused_circulant_coherent_stats(bank: CirculantBank,
                                            r: torch.Tensor,
                                            alpha: float = 1.0, blocks=None):
    """Kernel analog of
    `structured_bank.estimate_circulant_coherent_stats` through K9:
    per-block state (m (B,), den (B,)) at alpha >= 1, per-snapshot ((B, T))
    below, acc (B, T, D) complex64 in the DFT domain."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, d = r.shape
    x2 = _x2(r)
    if t == 1:
        states = [circ_estimate_stats(x2, c)
                  for c in lowered(bank, None, blocks)]
    else:
        states = [circ_estimate_coherent_stats(x2, c, t, alpha)
                  for c in lowered(bank, None, blocks, t, alpha)]
    m, den, acc2 = merge_stats(*zip(*states))
    acc = _hc(acc2, torch.complex64).reshape(b, t, d)
    m, den = m.reshape(b, t), den.reshape(b, t)
    if alpha >= 1.0:
        return m[:, 0], den[:, 0], acc
    return m, den, acc
