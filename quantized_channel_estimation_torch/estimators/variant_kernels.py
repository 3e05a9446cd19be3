"""Variants of the dense estimation kernel K1, opt-in and for measurement.

Port of the rest of the dense part of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`, with two
kernels written in CUDA C++ for `sm_90a`:

- K14a, the Karatsuba-layout estimator (`_estimate_kernel`, launched by
  `estimate_packed`, entry `estimate`) in `csrc/karatsuba_estimate.cu`:
  K1's 'all'-mode estimate with three real products per complex product
  (`KernelBank`, `kernel_bank`, plain version `reference_estimate_packed`),
  each of them six bf16 tensor-core products of three-plane splits
  accumulated in fp32, as K1's; the bank's planes are split and laid out
  once in the kernel's units (`karatsuba_operands`), and
  `karatsuba_tc_reference` is the plain version of the kernel's
  arithmetic;
- K14b, K1's GEMM-precision modes (`_estimate_kernel_block_grouped_bf16`,
  `_estimate_kernel_block_grouped_split`, the `mode=` of
  `estimate_packed_block_grouped` / `estimate_block_grouped`) in
  `csrc/grouped_tc_estimate.cu`: 'bf16', 'split2' and 'split3', one to
  three bf16 tensor-core products on K1's wgmma stream
  (`csrc/grouped_tc_stream.cuh`, where K1 runs six), the bank split into
  hi / lo bf16 planes (`kernels.split_planes`) and laid out in the
  stream's shared-memory layout (`kernels.tc_operands`, with K1's third
  plane; `kernels.lowered_tc` caches planes and layout beside the bank);
  one wrapper, and one launch count, a mode
  (`grouped_tc_bf16`, `grouped_tc_split2`, `grouped_tc_split3`).
  `grouped_tc_estimate_reference` is the plain version of the stream's
  arithmetic for any of its product counts, K1's six included.

`mode='f32'` is K1 itself (`kernels.grouped_estimate`), and `estimate_block`
is that same call: `tile_n` and `group` are MXU knobs with no counterpart
here. Neither kernel is on a default path; the tools under
`quantized_channel_estimation_torch.tools` measure them.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU; each counts its
launches (`kernels.register_wrappers`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators.kernels import TcOperands
from quantized_channel_estimation_torch.models.gmm_estimator import (
    PreparedBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

KARATSUBA_MAX = 128   # M and D of K14a
MODES = {"bf16": 1, "split2": 2, "split3": 3}   # K14b: tensor-core passes


# ---------------------------------------------------------------------------
# K14a: the Karatsuba layout
# ---------------------------------------------------------------------------

class KernelBank(NamedTuple):
    """PreparedBank in the Karatsuba layout of K14a, all real.

    A complex product y = r B with r = rr + i ri, B = B_re + i B_im runs as
    p1 = rr B_re, p2 = ri B_im, p3 = (rr + ri)(B_re + B_im), Re y = p1 - p2,
    Im y = p3 - p1 - p2, so the bank holds B_re, B_im and the sum plane.

    pc_re / pc_im / pc_s: (K, M, M)  conj(P_k) (+ sum plane)
    wt_re / wt_im / wt_s: (K, M, D)  W_k^T (+ sum plane)
    mu_re / mu_im:        (K, M)     mu~_k = means_r_k @ conj(P_k)
    b_re / b_im:          (K, D)     bias_k
    logw:                 (K,)       log weights + 2 sum log diag(P_k),
                                     floored at -1e30
    (JAX keeps mu and b as (K, 1, M) / (K, 1, D).)
    """
    pc_re: torch.Tensor
    pc_im: torch.Tensor
    pc_s: torch.Tensor
    wt_re: torch.Tensor
    wt_im: torch.Tensor
    wt_s: torch.Tensor
    mu_re: torch.Tensor
    mu_im: torch.Tensor
    b_re: torch.Tensor
    b_im: torch.Tensor
    logw: torch.Tensor


def kernel_bank(bank: PreparedBank) -> KernelBank:
    """Lower a PreparedBank to the Karatsuba layout (JAX `kernel_bank`).
    Dead components carry log-weight -inf; the -1e30 floor keeps the online
    softmax exact (their exp underflows to 0 once a live logit appears)."""
    pin_fp32()
    pc = bank.prec_chol_r.conj()                           # (K, M, M)
    mu = torch.matmul(bank.means_r[:, None, :], pc)[:, 0]  # (K, M)
    wt = bank.filters.transpose(-1, -2)                    # (K, M, D)
    diag = torch.diagonal(bank.prec_chol_r, dim1=-2, dim2=-1).real
    logw = torch.clamp(bank.log_weights + 2.0 * torch.log(diag).sum(-1),
                       min=-1e30)
    f32 = torch.float32

    def real(x):
        return x.real.to(f32).contiguous()

    def imag(x):
        return x.imag.to(f32).contiguous()

    pc_re, pc_im, wt_re, wt_im = real(pc), imag(pc), real(wt), imag(wt)
    return KernelBank(pc_re, pc_im, pc_re + pc_im, wt_re, wt_im,
                      wt_re + wt_im, real(mu), imag(mu), real(bank.bias),
                      imag(bank.bias), logw.to(f32).contiguous())


def reference_estimate_packed(kb: KernelBank, r_re: torch.Tensor,
                              r_im: torch.Tensor, chunk: int = 8192):
    """Plain PyTorch version of K14a (JAX `reference_estimate_packed`): the
    same estimate with complex products, r_re / r_im (N, M) float32 ->
    (h_re, h_im), each (N, D) float32."""
    pin_fp32()
    pc = torch.complex(kb.pc_re, kb.pc_im)
    wt = torch.complex(kb.wt_re, kb.wt_im)
    mu = torch.complex(kb.mu_re, kb.mu_im)
    b = torch.complex(kb.b_re, kb.b_im)
    out = []
    for i0 in range(0, r_re.shape[0], chunk):
        r = torch.complex(r_re[i0:i0 + chunk], r_im[i0:i0 + chunk])
        y = torch.einsum("nm,kmp->knp", r, pc)
        quad = (y - mu[:, None, :]).abs().square().sum(-1)    # (K, n)
        w = torch.softmax(kb.logw[:, None] - quad, dim=0)
        z = torch.einsum("nm,kmd->knd", r, wt) + b[:, None, :]
        out.append(torch.einsum("kn,knd->nd", w.to(z.dtype), z))
    h = (torch.cat(out) if out
         else r_re.new_zeros((0, kb.b_re.shape[1]), dtype=torch.complex64))
    return h.real.contiguous(), h.imag.contiguous()


def _check_karatsuba_widths(m: int, d: int) -> None:
    if not (1 <= m <= KARATSUBA_MAX and 1 <= d <= KARATSUBA_MAX):
        raise ValueError(f"the Karatsuba estimator K14a takes M, D <= "
                         f"{KARATSUBA_MAX}; got M={m}, D={d}")


SIX_PRODUCTS = ((0, 2), (1, 1), (2, 0), (1, 0), (0, 1), (0, 0))
"""The six bf16 products of an fp32 product, in the kernels' issue order:
(plane of the rows, plane of the bank), planes 0 = hi, 1 = lo, 2 = lo2
(`kernels.split_planes3`): hi.lo2, lo.lo, lo2.hi, lo.hi, hi.lo, hi.hi."""


def karatsuba_piece(m: int, d: int) -> int:
    """Columns of one piece of K14a's bank: 64 while M, D <= 64, else 32
    (three accumulators and up to four value pieces of output in
    registers)."""
    return 64 if m <= 64 and d <= 64 else 32


class KaratsubaOperands(NamedTuple):
    """The bank as K14a streams it, unit by unit: per component, piece of
    PW columns (`karatsuba_piece`; the logit half's ceil(M / PW) pieces of
    conj(P_k), then the value half's ceil(D / PW) of W_k^T), operand (B_re,
    B_im, B_s) and 64-deep contraction chunk, the PW x 64 transpose of each
    bf16 plane (hi, lo, lo2 of `kernels.split_planes3`) in the 128-byte
    swizzle (`kernels._sw128`), padding zero; and each piece's vector
    values [Re | Im] (mu_k over the logit pieces, b_k over the value
    pieces).

    hi, lo, lo2: (K, pieces, 3, ceil(M / 64), PW, 64) bfloat16
    vec:         (K, pieces, 2, PW)                    float32
    """
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor
    vec: torch.Tensor


def _karatsuba_units(x: torch.Tensor, pw: int) -> torch.Tensor:
    """(K, 3, M, X) planes of one half -> (K, ceil(X / pw), 3, ceil(M / 64),
    pw, 64): a piece's columns, a chunk's contraction rows, transposed;
    zero-padded."""
    k_comp, _, m, x_cols = x.shape
    n_ch, pieces = -(-m // 64), -(-x_cols // pw)
    x = torch.nn.functional.pad(x, (0, pieces * pw - x_cols,
                                    0, n_ch * 64 - m))
    return x.reshape(k_comp, 3, n_ch, 64, pieces, pw).permute(0, 4, 1, 2, 5,
                                                              3)


def _karatsuba_vec(re: torch.Tensor, im: torch.Tensor,
                   pw: int) -> torch.Tensor:
    """(K, X) re / im -> (K, ceil(X / pw), 2, pw), zero-padded."""
    k_comp, x_cols = re.shape
    pieces = -(-x_cols // pw)
    both = torch.nn.functional.pad(torch.stack([re, im], 1),
                                   (0, pieces * pw - x_cols))
    return both.reshape(k_comp, 2, pieces, pw).transpose(1, 2)


def karatsuba_operands(kb: KernelBank) -> KaratsubaOperands:
    """Split kb's six planes into bf16 hi / lo / lo2 and lay them out as
    K14a's units (`KaratsubaOperands`); once per bank (`estimate` keeps
    them in its cache)."""
    m, d = kb.pc_re.shape[1], kb.wt_re.shape[2]
    pw = karatsuba_piece(m, d)
    x = torch.cat([
        _karatsuba_units(torch.stack([kb.pc_re, kb.pc_im, kb.pc_s], 1), pw),
        _karatsuba_units(torch.stack([kb.wt_re, kb.wt_im, kb.wt_s], 1), pw)],
        1)
    planes = (kernels._sw128(p).contiguous()
              for p in kernels.split_planes3(x.contiguous()))
    vec = torch.cat([_karatsuba_vec(kb.mu_re, kb.mu_im, pw),
                     _karatsuba_vec(kb.b_re, kb.b_im, pw)], 1)
    return KaratsubaOperands(*planes, vec.contiguous())


def check_karatsuba_operands(ops: KaratsubaOperands, kb: KernelBank,
                             device) -> None:
    """Raise unless ops holds the units and vectors of a bank of kb's shape
    on `device` (`karatsuba_operands`)."""
    k_comp, m, _ = kb.pc_re.shape
    d = kb.wt_re.shape[2]
    pw = karatsuba_piece(m, d)
    pieces = -(-m // pw) + -(-d // pw)
    units = (k_comp, pieces, 3, -(-m // 64), pw, 64)
    fields = [("hi", ops.hi, torch.bfloat16, units),
              ("lo", ops.lo, torch.bfloat16, units),
              ("lo2", ops.lo2, torch.bfloat16, units),
              ("vec", ops.vec, torch.float32, (k_comp, pieces, 2, pw))]
    for name, t, dtype, shape in fields:
        if (t is None or t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            got = ("None" if t is None
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"karatsuba_estimate: operand {name} must be "
                             f"contiguous {dtype} {shape} on {device} "
                             f"(`karatsuba_operands`), got {got}")


def karatsuba_tc_reference(kb: KernelBank, r_re: torch.Tensor,
                           r_im: torch.Tensor, chunk: int = 8192):
    """Plain PyTorch version of the kernel's arithmetic: p1 = rr B_re, p2 =
    ri B_im, p3 = (rr + ri) B_s, each the six bf16 products of `tc_products`
    with the bank's bf16 planes, Re = p1 - p2 and Im = (p3 - p1) - p2, then
    the logits, softmax and combine in float32. r_re / r_im (N, M) ->
    (h_re, h_im) (N, D). `reference_estimate_packed` is the same function
    with complex float32 products."""
    pin_fp32()

    def split(*xs):
        return [[p.to(torch.float32) for p in kernels.split_planes3(x)]
                for x in xs]

    pc = split(kb.pc_re, kb.pc_im, kb.pc_s)
    wt = split(kb.wt_re, kb.wt_im, kb.wt_s)
    out_re, out_im = [], []
    for i0 in range(0, r_re.shape[0], chunk):
        rr, ri = r_re[i0:i0 + chunk], r_im[i0:i0 + chunk]
        rs = rr + ri

        def product(b):
            p1, p2 = tc_products(rr, b[0], 6), tc_products(ri, b[1], 6)
            p3 = tc_products(rs, b[2], 6)
            return p1 - p2, (p3 - p1) - p2

        y_re, y_im = product(pc)                               # (K, n, M)
        quad = ((y_re - kb.mu_re[:, None]).square()
                + (y_im - kb.mu_im[:, None]).square()).sum(-1)   # (K, n)
        w = torch.softmax(kb.logw[:, None] - quad, dim=0)
        z_re, z_im = product(wt)                               # (K, n, D)
        out_re.append(torch.einsum("kn,knd->nd", w,
                                   z_re + kb.b_re[:, None]))
        out_im.append(torch.einsum("kn,knd->nd", w,
                                   z_im + kb.b_im[:, None]))
    if not out_re:
        empty = r_re.new_zeros((0, kb.b_re.shape[1]))
        return empty, empty.clone()
    return torch.cat(out_re), torch.cat(out_im)


def _check_karatsuba_widths(m: int, d: int) -> None:
    if not (1 <= m <= KARATSUBA_MAX and 1 <= d <= KARATSUBA_MAX):
        raise ValueError(f"the Karatsuba estimator K14a takes M, D <= "
                         f"{KARATSUBA_MAX}; got M={m}, D={d}")


def karatsuba_estimate(r_re: torch.Tensor, r_im: torch.Tensor,
                       kb: KernelBank,
                       operands: Optional[KaratsubaOperands] = None):
    """K14a on r_re / r_im (N, M) float32 -> (h_re, h_im), each (N, D)
    float32, any N. On a CUDA tensor it launches the CUDA kernel (M and D
    at most 128) on the current stream with the bank's `operands`
    (`karatsuba_operands(kb)`, laid out in the call when None) and raises
    on any refusal; on a CPU tensor it computes the plain version."""
    if not r_re.is_cuda:
        return reference_estimate_packed(kb, r_re, r_im)
    n, m = r_re.shape
    k_comp, _, d = kb.wt_re.shape
    _check_karatsuba_widths(m, d)
    dev = r_re.device
    check = kernels._check_cuda
    check("r_re", r_re, (n, m), dev)
    check("r_im", r_im, (n, m), dev)
    for name in ("pc_re", "pc_im", "pc_s"):
        check(name, getattr(kb, name), (k_comp, m, m), dev)
    for name in ("wt_re", "wt_im", "wt_s"):
        check(name, getattr(kb, name), (k_comp, m, d), dev)
    check("mu_re", kb.mu_re, (k_comp, m), dev)
    check("mu_im", kb.mu_im, (k_comp, m), dev)
    check("b_re", kb.b_re, (k_comp, d), dev)
    check("b_im", kb.b_im, (k_comp, d), dev)
    check("logw", kb.logw, (k_comp,), dev)
    if operands is None:
        operands = karatsuba_operands(kb)
    check_karatsuba_operands(operands, kb, dev)
    h_re = torch.empty((n, d), dtype=torch.float32, device=dev)
    h_im = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0:
        return h_re, h_im
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels._library("karatsuba_estimate").karatsuba_estimate_launch(
            r_re.data_ptr(), r_im.data_ptr(), operands.hi.data_ptr(),
            operands.lo.data_ptr(), operands.lo2.data_ptr(),
            operands.vec.data_ptr(), kb.logw.data_ptr(), h_re.data_ptr(),
            h_im.data_ptr(), n, k_comp, m, d, stream)
    if err != 0:
        raise RuntimeError(f"karatsuba_estimate launch failed: cudaError "
                           f"{err}")
    karatsuba_estimate.launches += 1
    return h_re, h_im


def estimate_packed(kb: KernelBank, r_re: torch.Tensor, r_im: torch.Tensor,
                    operands: Optional[KaratsubaOperands] = None):
    """'all'-mode estimation in the Karatsuba layout (JAX
    `estimate_packed`): r_re / r_im (N, M) float32 -> (h_re, h_im) (N, D)
    float32 through K14a. Any N: the kernel masks the ragged tile, so there
    is no `tile_n` and no padding."""
    return karatsuba_estimate(r_re, r_im, kb, operands)


def estimate(bank: PreparedBank, r: torch.Tensor,
             cache: Optional[dict] = None) -> torch.Tensor:
    """Drop-in Karatsuba replacement for `gmm_estimator.estimate(bank, r,
    'all')` (JAX `estimate`): complex r (N, M) -> (N, D) through K14a.
    `cache`: a dict held beside the bank for its Karatsuba layout and, on a
    card, its `karatsuba_operands` ("karatsuba", "karatsuba_operands").
    Raises past M, D <= 128, on any device: there is no fallback."""
    _, d, m = bank.filters.shape
    _check_karatsuba_widths(m, d)
    cache = {} if cache is None else cache
    if "karatsuba" not in cache:
        cache["karatsuba"] = kernel_bank(bank)
    kb = cache["karatsuba"]
    operands = None
    if r.is_cuda:
        if "karatsuba_operands" not in cache:
            cache["karatsuba_operands"] = karatsuba_operands(kb)
        operands = cache["karatsuba_operands"]
    h_re, h_im = karatsuba_estimate(r.real.to(torch.float32).contiguous(),
                                    r.imag.to(torch.float32).contiguous(),
                                    kb, operands)
    return torch.complex(h_re, h_im).to(r.dtype)


# ---------------------------------------------------------------------------
# K14b: the GEMM-precision modes
# ---------------------------------------------------------------------------

def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def tc_products(rows: torch.Tensor, flats, passes: int) -> torch.Tensor:
    """The products of the wgmma kernels for rows (n, W) float32: rows
    split into bf16 planes (hi, lo, lo2 as `kernels.split_planes3`), and the
    `passes` products of a row plane and a bank plane (flats: the bank's
    planes as float32 matrices, (2M, K (2M+2D)) for K1's stream, (K, M, X)
    for K14a's), each a float32 product of bf16 values (exact), summed in
    the kernel's issue order: hi.hi, hi.lo, lo.hi for 1-3 passes;
    `SIX_PRODUCTS` (hi.lo2, lo.lo, lo2.hi, lo.hi, hi.lo, hi.hi) for 6 (the
    row's plane first)."""
    hi = _round_bf16(rows)
    lo = _round_bf16(rows - hi)
    r_planes = (hi, lo, _round_bf16((rows - hi) - lo))
    order = (SIX_PRODUCTS if passes == 6
             else ((0, 0), (0, 1), (1, 0))[:passes])
    yz = None
    for a, b in order:
        term = r_planes[a] @ flats[b]
        yz = term if yz is None else yz + term
    return yz


def grouped_tc_estimate_reference(r2: torch.Tensor,
                                  kb: kernels.KernelBankBlock, planes,
                                  passes: int, chunk: int = 8192,
                                  t_coh: int = 1,
                                  coh_alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the wgmma stream's arithmetic: K1 (K3 at
    t_coh > 1) with yz_k = `tc_products` of r2 and the bank's bf16 planes
    (`kernels.split_planes` for 1-3 passes, K14b's modes: r_hi pw_hi,
    + r_hi pw_lo at passes >= 2, + r_lo pw_hi at 3; `kernels.split_planes3`
    for K1's 6), the logits, pooling, softmax and combine in float32. r2
    (N, 2M) -> (N, 2D). K1's plain version is `kernels.grouped_estimate_reference`,
    the same function with one float32 product."""
    pin_fp32()
    k_comp, two_m, s_cols = kb.pw.shape
    flats = [p.to(torch.float32).permute(1, 0, 2).reshape(
        two_m, k_comp * s_cols) for p in planes[:3 if passes == 6 else 2]]
    return kernels._grouped_reference(
        r2, kb, t_coh, coh_alpha, chunk,
        products=lambda rows: tc_products(rows, flats, passes))


def _grouped_tc(r2: torch.Tensor, kb: kernels.KernelBankBlock, planes,
                passes: int, wrapper, operands) -> torch.Tensor:
    """Launch K14b with `passes` bf16 tensor-core products, counted on
    `wrapper` (one registered wrapper a mode); operands:
    `kernels.tc_operands(kb)`, laid out here when None."""
    if not r2.is_cuda:
        return grouped_tc_estimate_reference(r2, kb, planes, passes)
    n, k_comp, two_m, two_d = kernels._check_inputs(
        wrapper.__name__, r2, kb, kernels.TC_MAX_WIDTH)
    for name, p in zip(("pw_hi", "pw_lo"), planes):
        if (p.device != r2.device or p.dtype != torch.bfloat16
                or tuple(p.shape) != tuple(kb.pw.shape)
                or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous bfloat16 "
                             f"{tuple(kb.pw.shape)} on {r2.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if operands is None:
        operands = kernels.tc_operands(kb)
    kernels.check_tc_operands(wrapper.__name__, operands, kb, r2.device)
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    with torch.cuda.device(r2.device):
        stream = torch.cuda.current_stream(r2.device).cuda_stream
        err = kernels._library(
            "grouped_tc_estimate").grouped_tc_estimate_launch(
            r2.data_ptr(), operands.hi.data_ptr(), operands.lo.data_ptr(),
            operands.vec.data_ptr(), kb.logw.data_ptr(),
            out.data_ptr(), n, k_comp, two_m, two_d, passes, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError "
                           f"{err}")
    wrapper.launches += 1
    return out


def grouped_tc_bf16(r2: torch.Tensor, kb: kernels.KernelBankBlock,
                    planes, operands: Optional[TcOperands] = None
                    ) -> torch.Tensor:
    """K14b in mode 'bf16' (one pass, r_hi pw_hi) on r2 (N, 2M) float32 ->
    (N, 2D) float32; planes = `kernels.split_planes(kb.pw)` (or the first
    two of `kernels.split_planes3`), operands = `kernels.tc_operands(kb)`
    (laid out in the call when None; `kernels.lowered_tc` keeps them beside
    a bank). On a CUDA tensor it launches the CUDA kernel
    (2M and 2D at most 256) on the current stream and raises on any
    refusal; on a CPU tensor it computes the plain version."""
    return _grouped_tc(r2, kb, planes, 1, grouped_tc_bf16, operands)


def grouped_tc_split2(r2: torch.Tensor, kb: kernels.KernelBankBlock,
                      planes, operands: Optional[TcOperands] = None
                      ) -> torch.Tensor:
    """K14b in mode 'split2' (r_hi pw_hi + r_hi pw_lo); otherwise as
    `grouped_tc_bf16`."""
    return _grouped_tc(r2, kb, planes, 2, grouped_tc_split2, operands)


def grouped_tc_split3(r2: torch.Tensor, kb: kernels.KernelBankBlock,
                      planes, operands: Optional[TcOperands] = None
                      ) -> torch.Tensor:
    """K14b in mode 'split3' (r_hi pw_hi + r_hi pw_lo + r_lo pw_hi);
    otherwise as `grouped_tc_bf16`."""
    return _grouped_tc(r2, kb, planes, 3, grouped_tc_split3, operands)


kernels.register_wrappers(karatsuba_estimate, grouped_tc_bf16,
                          grouped_tc_split2, grouped_tc_split3)
TC_WRAPPERS = {"bf16": grouped_tc_bf16, "split2": grouped_tc_split2,
               "split3": grouped_tc_split3}


def estimate_packed_block_grouped(kb: kernels.KernelBankBlock,
                                  r2: torch.Tensor, mode: str = "f32",
                                  t_coh: int = 1, coh_alpha: float = 1.0,
                                  planes=None,
                                  operands: Optional[TcOperands] = None
                                  ) -> torch.Tensor:
    """K1's estimate of r2 (N, 2M) float32 -> (N, 2D) in GEMM-precision
    mode `mode` (JAX `estimate_packed_block_grouped`): 'f32' is K1 (K3 at
    t_coh > 1, r2 block-major, kb from `kernel_bank_block(bank, t_coh,
    coh_alpha)`); 'bf16', 'split2' and 'split3' are K14b with `planes`
    (default: split from kb.pw); `operands`: the bank's `tc_operands`
    (default: laid out in the call; K1 and K3 read all three planes). The
    coherent pool is f32-only: t_coh > 1 with another mode raises
    NotImplementedError; an unknown mode raises ValueError."""
    if mode == "f32":
        if t_coh > 1:
            return kernels.grouped_estimate_coherent(r2, kb, t_coh,
                                                     coh_alpha, operands)
        return kernels.grouped_estimate(r2, kb, operands)
    if mode in MODES:
        if t_coh > 1:
            raise NotImplementedError("coherent pooling is f32-only")
        return TC_WRAPPERS[mode](
            r2, kb, kernels.split_planes(kb.pw) if planes is None else planes,
            operands)
    raise ValueError(f"unknown mode {mode!r}")


def estimate_block_grouped(bank: PreparedBank, r: torch.Tensor,
                           mode: str = "f32",
                           cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode estimate of complex r (N, M) -> (N, D) in GEMM-precision
    mode `mode` (JAX `estimate_block_grouped`): 'f32' through K1, 'bf16' /
    'split2' / 'split3' through K14b. `cache`: a dict held beside the bank
    for its layout, planes and tensor-core operands (`lowered_tc`)."""
    if mode in MODES or mode == "f32":
        kb, planes, operands = kernels.lowered_tc(bank, cache)
    else:
        kb, planes, operands = kernels.lowered(bank, cache), None, None
    h2 = estimate_packed_block_grouped(kb, kernels._r2(r), mode,
                                       planes=planes, operands=operands)
    return kernels._h(h2, bank.filters.shape[1], r.dtype)


def estimate_block(bank: PreparedBank, r: torch.Tensor,
                   cache: Optional[dict] = None) -> torch.Tensor:
    """JAX `estimate_block`, the grouped kernel at group 1: here K1 itself,
    `estimate_block_grouped(bank, r, 'f32', cache)`."""
    return estimate_block_grouped(bank, r, "f32", cache)
