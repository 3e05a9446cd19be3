"""The hand-written factored (MFA, Woodbury) estimation kernels and their
plain versions.

Port of the factored section of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`
(:1919-2305): `FactKernelBank`, `fact_kernel_bank`, and the entries
`estimate_fused_factored` (K11), `estimate_fused_factored_coherent` (K12)
and `estimate_fused_factored_stats` (K13). The three kernels are one CUDA
C++ template with COH and STATS flags in `csrc/fact_estimate.cu`, built and
bound by `estimators.kernels` (nvcc, ctypes, launch counts); shard states of
K13 merge with `circ_kernels.merge_stats`. The kernel runs both products on
Hopper's tensor cores as six exact bf16 products of three-plane splits
(`kernels.split_planes3`), accumulated in fp32: the bank's planes of fwd and
comb are laid out once in its units (`fact_tc_operands`, cached beside the
bank by `lowered_tc`), and `fact_tc_reference` is the plain version of that
arithmetic.

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
- the range rule `fact_kernel_eligible` is the CUDA kernels' (the
  template's D <= 128, M <= 64, `fact_narrow`; past it the wide form while
  the scratch of its least launch fits, `fact_wide_eligible`; any K in one
  launch, T <= 64 at every width), a superset of the TPU's 13 MiB VMEM
  gate `_fact_kernel_eligible` (with its T <= 16 cap `_check_t_coh` for
  the coherent form); beyond it the entries raise and `harness.stages`
  takes the `torch.matmul` pipeline of `models.mfa_bank`.

Past the template's rule the entries launch the wide form,
`csrc/fact_wide_estimate.cu` (`fact_wide_launch`, counted apart:
`fact_estimate_wide`, `fact_estimate_coherent_wide`,
`fact_estimate_stats_wide`), on the product template of the wide circulant
kernels: the forward product to [beta | gamma] of every component at once,
the quadratic terms in float64, the logit product over [x | |x|^2], the
softmax, the combine product over the weighted [beta | gamma] and the
fold of bias and a1 o x in float64; the intermediates in global scratch,
rows cut into launches within `kernels.WIDE_SCRATCH`.
`fact_wide_operands` lays a `FactKernelBank` out as its units (cached by
`lowered_tc`), and `fact_wide_reference` is the plain version of its
arithmetic.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import tc_units as tu
from quantized_channel_estimation_torch.estimators.mp_circ_kernels import (
    _cplx_interleaved, _hc, _interleave, _pool, _x2)
from quantized_channel_estimation_torch.estimators.variant_kernels import (
    tc_products)
from quantized_channel_estimation_torch.models.mfa_bank import FactoredBank
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import profiling

FACT_MAX_D = 128   # channel dims of the factored kernels' template
FACT_MAX_M = 64    # latent rank of the factored kernels' template
FACT_MAX_T = 64    # rows of a coherence block the kernels pool


def fact_tile_rows(d: int, m: int) -> int:
    """Rows of one consumer warpgroup's tile of the factored kernels
    (csrc/fact_estimate.cu and csrc/fact_wide_estimate.cu: 64 at every
    width), the largest coherence block K12 pools: every T the fp32
    template took (64 rows while D <= 64 and M <= 32, else 32) and more."""
    return FACT_MAX_T


def fact_narrow(d: int, k: int, m: int, t: int = 1) -> bool:
    """Does the template (csrc/fact_estimate.cu) take these widths? D <=
    128, M <= 64, T within a tile's rows; any K (the kernel streams the
    bank one component at a time)."""
    return (1 <= d <= FACT_MAX_D and 1 <= m <= FACT_MAX_M and k >= 1
            and 1 <= t <= fact_tile_rows(d, m))


def fact_wide_row_bytes(d: int, k: int, m: int) -> int:
    """Scratch bytes of one row in the wide form: the three bf16 planes of
    its widest product's contraction (2D, the 3D features or K 4M), u
    (K 4M), its K logits and its offset."""
    widest = max(tu.chunks(2 * d), tu.chunks(3 * d),
                 tu.chunks(4 * k * m))
    return 384 * widest + 16 * k * m + 4 * k + 4


def fact_wide_eligible(d: int, k: int, m: int, t: int = 1) -> bool:
    """Does the wide form (csrc/fact_wide_estimate.cu) take these widths?
    Any D, K, M >= 1 with K 4M < 2^30 whose 128 T rows (the least launch:
    whole blocks, whole pairs of 64-row tiles) keep their scratch within
    `kernels.WIDE_SCRATCH` (at K = M = 1 every D <= 29120 at T = 16 and
    <= 7274 at T = 64; at D = 64, K = 1 every M <= 13104 at T = 16), T <=
    64."""
    return (d >= 1 and k >= 1 and m >= 1 and 4 * k * m < 1 << 30
            and 1 <= t <= FACT_MAX_T
            and 128 * t * fact_wide_row_bytes(d, k, m)
            <= kernels.WIDE_SCRATCH)


FACT_FUSED_MIN_D = 129   # channel dims of the fused kernel
FACT_FUSED_MAX_D = 256
FACT_FUSED_MAX_M = 16    # latent rank of the fused kernel (4M <= 64)


def fact_fused_fits(d: int, m: int, t: int = 1) -> bool:
    """Does the fused kernel (csrc/fact_fused_estimate.cu) take these
    widths? 129 <= D <= 256 (x of a 64-row tile in fp32 beside the rings
    in 227 KB; each consumer warpgroup's half of the output, 64 rows x D
    columns, in registers), M <= 16 (u as the combine's A fragments in
    registers), T <= 64; any K. Only its wrappers launch it: the entries
    keep the wide form, which `tools/mfa_bank_bench.py fused_reach`
    measured faster from K = 4 on (PERF.md §6)."""
    return (FACT_FUSED_MIN_D <= d <= FACT_FUSED_MAX_D
            and 1 <= m <= FACT_FUSED_MAX_M and 1 <= t <= FACT_MAX_T)


def fact_kernel_eligible(d: int, k: int, m: int, t: int = 1) -> bool:
    """Can the factored kernels serve a bank of K components over D dims
    at latent rank M, pooling T-snapshot blocks? The template where it
    takes the widths (`fact_narrow`), else the wide form
    (`fact_wide_eligible`: any K, T <= 64, D and M while 128 T rows fit the
    scratch). A superset of the JAX package's Pallas rule
    (`_fact_kernel_eligible`, with T <= 16 for the coherent form): D to
    10334 at K = M = 1, M to 2475 at D = 64, K to 39 at D = 256, M = 16
    there. A rule of the shapes, decided before any launch."""
    return fact_narrow(d, k, m, t) or fact_wide_eligible(d, k, m, t)


def _rule(d: int, k: int, m: int, t: int) -> str:
    """The rule's statement at these widths, for the errors."""
    return (f"the factored kernels take D <= {FACT_MAX_D}, M <= "
            f"{FACT_MAX_M} and T <= {FACT_MAX_T}, or in their wide form "
            f"T <= {FACT_MAX_T}, K 4M < 2^30 and 128 T rows within "
            f"{kernels.WIDE_SCRATCH} bytes of scratch; got D={d}, M={m}, "
            f"K={k}, T={t} ({fact_wide_row_bytes(d, k, m)} scratch bytes a "
            f"row)")


def fact_bound(n: int, d: int, k: int, m: int, t_coh: int = 1,
               stats: bool = False) -> dict:
    """The least time an H100 could take for K11-K13's function on n rows
    of a K-component factored bank at D dims and rank M
    (`profiling.bound_ms`: operations at the card's peaks against bytes at
    its memory rate):

    - the forward and combine products as the kernels' six bf16 products
      of 2 n K (2D 4M + 4M 2D) on the tensor cores;
    - the epilogue, 2 n K (3D + 2M + 6D) fp32 operations (the diagonal and
      quadratic logit terms, the bias and a1 o x terms), and 3 n K more
      for the coherent pooling;
    - the rows read once, the output (and m, den) written once, and the
      bank's operands (fwd, comb, T mu, lcoef, const, bias, a1) read once.

    Returns {"bound_ms", "bound_by", "fp32_flops", "tc_flops", "bytes"}."""
    two_d, four_m = 2 * d, 4 * m
    tc = 6.0 * 2 * n * k * (two_d * four_m + four_m * two_d)
    epi = 2.0 * n * k * (3 * d + 2 * m + 6 * d) + (
        3.0 * n * k if t_coh > 1 else 0.0)
    out = (2 * n if stats else 0) + n * two_d
    bank = k * (2 * two_d * four_m + 2 * m + 3 * d + 1 + 2 * two_d)
    nbytes = 4.0 * (n * two_d + out + bank)
    ms, by = profiling.bound_ms(epi, tc, nbytes)
    return {"bound_ms": ms, "bound_by": by, "fp32_flops": epi,
            "tc_flops": tc, "bytes": nbytes}


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
# the tensor-core layout of the bank
# ---------------------------------------------------------------------------

def _chunks(w: int) -> int:
    """64-deep contraction chunks the kernel gives w columns: 1, 2 or 4."""
    return 1 if w <= 64 else 2 if w <= 128 else 4


def fact_tc_shape(d: int, m: int):
    """(PW, NCX, NCU) of the kernel's instantiation at these widths
    (`fact_dispatch` in csrc/fact_estimate.cu): NCX chunks of the forward
    contraction 2D, NCU of the combine's 4M, and the columns of a piece: 64
    while both are at most 2, 16 where both are 4, else 32."""
    ncx, ncu = _chunks(2 * d), _chunks(4 * m)
    pw = 16 if (ncx, ncu) == (4, 4) else 32 if 4 in (ncx, ncu) else 64
    return pw, ncx, ncu


class FactTcOperands(NamedTuple):
    """The bank as the kernel streams it. hi, lo, lo2: the bf16 planes
    (`kernels.split_planes3`) of fwd and comb as units, per component its
    ceil(4M / PW) forward pieces of NCX units, then its ceil(2D / PW)
    combine pieces of NCU units (`fact_tc_shape`), each unit the PW x 64
    transpose of one piece's columns over one 64-deep contraction chunk in
    the 128-byte swizzle (`kernels._sw128`), padding zero; rec: each
    component's record, T mu (2M, zero-padded to a multiple of 4), then per
    bin d the 8 floats (l0_d, l1_d, l2_d, 0, Re b_d, Im b_d, Re a1_d,
    Im a1_d) of lcoef, bias and a1. The same for every (T, alpha) layout:
    those differ in `const` only, which the kernel reads from the layout.

    hi, lo, lo2: (K, units, PW, 64) bfloat16
    rec:         (K, 2Mp + 8D)     float32
    """
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor
    rec: torch.Tensor


def _fact_units(w: torch.Tensor, nc: int, pw: int) -> torch.Tensor:
    """(K, rows, cols) -> (K, ceil(cols / pw) nc, pw, 64): per piece of pw
    columns its nc chunks of 64 contraction rows, transposed; zero-padded."""
    k_comp, rows, cols = w.shape
    pieces = -(-cols // pw)
    w = torch.nn.functional.pad(w, (0, pieces * pw - cols,
                                    0, nc * 64 - rows))
    return w.reshape(k_comp, nc, 64, pieces, pw).permute(
        0, 3, 1, 4, 2).reshape(k_comp, pieces * nc, pw, 64)


def fact_tc_operands(fkb: FactKernelBank) -> FactTcOperands:
    """Split the bank's fwd and comb into bf16 hi / lo / lo2 and lay them
    out as the kernel's units, with each component's record
    (`FactTcOperands`); once per bank (`lowered_tc` keeps them)."""
    k_comp, two_d, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    pw, ncx, ncu = fact_tc_shape(d, m)
    units = torch.cat([_fact_units(fkb.fwd, ncx, pw),
                       _fact_units(fkb.comb, ncu, pw)], 1)
    planes = (kernels._sw128(p).contiguous()
              for p in kernels.split_planes3(units.contiguous()))
    tmu = torch.nn.functional.pad(fkb.tmu, (0, -(-2 * m // 4) * 4 - 2 * m))
    lc = fkb.lcoef.reshape(k_comp, 3, d).transpose(1, 2)     # (K, D, 3)
    per_bin = torch.cat([lc, torch.zeros_like(lc[..., :1]),
                         fkb.bias.reshape(k_comp, d, 2),
                         fkb.a1.reshape(k_comp, d, 2)], -1)
    rec = torch.cat([tmu, per_bin.reshape(k_comp, 8 * d)], 1)
    return FactTcOperands(*planes, rec.contiguous())


def check_fact_tc_operands(kernel: str, ops: FactTcOperands,
                           fkb: FactKernelBank, device) -> None:
    """Raise unless ops holds the units and records of a bank of fkb's
    shape on `device` (`fact_tc_operands`)."""
    k_comp, two_d, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    pw, ncx, ncu = fact_tc_shape(d, m)
    units = -(-four_m // pw) * ncx + -(-two_d // pw) * ncu
    fields = [("hi", ops.hi, torch.bfloat16, (k_comp, units, pw, 64)),
              ("lo", ops.lo, torch.bfloat16, (k_comp, units, pw, 64)),
              ("lo2", ops.lo2, torch.bfloat16, (k_comp, units, pw, 64)),
              ("rec", ops.rec, torch.float32,
               (k_comp, -(-2 * m // 4) * 4 + 8 * d))]
    for name, t, dtype, shape in fields:
        if (t is None or t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            got = ("None" if t is None
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"{kernel}: operand {name} must be contiguous "
                             f"{dtype} {shape} on {device} "
                             f"(`fact_tc_operands`), got {got}")


def lowered_tc(bank: FactoredBank, cache: Optional[dict] = None):
    """The kernel's operands of the bank: `fact_tc_operands` of its T = 1
    layout where the template takes its widths (`fact_narrow`), else the
    wide form's `fact_wide_operands` (the same for every T <= 64); kept in
    `cache` ("fact_tc_operands" or "fact_wide_operands") beside the layouts
    of `lowered`, so a bank served many times is split and laid out once."""
    k, m, d = bank.t_mat.shape
    wide = not fact_narrow(d, k, m)
    key = "fact_wide_operands" if wide else "fact_tc_operands"
    lay = fact_wide_operands if wide else fact_tc_operands
    if cache is None:
        return lay(lowered(bank))
    if key not in cache:
        cache[key] = lay(lowered(bank, cache))
    return cache[key]


# ---------------------------------------------------------------------------
# the wide form's layout (csrc/fact_wide_estimate.cu)
# ---------------------------------------------------------------------------

def fact_wide_units(d: int, k: int, m: int) -> int:
    """Units (64 columns x 64 deep) of the wide form's bank: the forward
    operand's NQ x NPD, the logit's KP x NF, the combine's NPD x NQ (NPD,
    NF, NQ, KP the 64-wide pieces of 2D, 3D, K 4M and K; `fact_wide_units`
    in csrc/fact_wide_estimate.cu)."""
    return (2 * tu.chunks(2 * d) * tu.chunks(4 * k * m)
            + tu.chunks(k) * tu.chunks(3 * d))


def fact_wide_logit_operand(fkb: FactKernelBank) -> torch.Tensor:
    """The logit operand (3D, K) against the features [x | |x|^2] (x the
    row's interleaved [re, im] pairs): rows 2d, 2d + 1 the Re and Im
    coefficients of bin d, rows 2D + d its |x_d|^2 coefficient (`lcoef`
    re-ordered)."""
    k, three_d = fkb.lcoef.shape
    lc = fkb.lcoef.reshape(k, 3, three_d // 3)
    return torch.cat([lc[:, :2].transpose(1, 2).reshape(k, -1), lc[:, 2]],
                     1).T


def _wide_products(fkb: FactKernelBank):
    """The three products' operands of the wide form: fwd (2D, K 4M), the
    logit operand (3D, K) and comb (K 4M, 2D)."""
    k, two_d, four_m = fkb.fwd.shape
    return (fkb.fwd.permute(1, 0, 2).reshape(two_d, k * four_m),
            fact_wide_logit_operand(fkb), fkb.comb.reshape(k * four_m, two_d))


def fact_wide_tc_units(fkb: FactKernelBank) -> torch.Tensor:
    """The bank's three product operands in float32 as the wide form's
    units (`fact_wide_units` of them, (units, 64, 64)), each product's
    pieces one after another, a piece's chunks consecutive, each unit the
    transpose of its operand's 64 x 64 block: fwd, the logit operand
    (`fact_wide_logit_operand`), comb."""
    return torch.cat([tu.piece_major(
        w, 64 * tu.chunks(w.shape[0]), 64 * tu.chunks(w.shape[1])
    ).reshape(-1, 64, 64) for w in _wide_products(fkb)])


def fact_wide_operands(fkb: FactKernelBank) -> tu.UnitOperands:
    """Split the bank's product operands into bf16 hi / lo / lo2 and lay
    them out as the wide form's units (`fact_wide_tc_units`, in the
    128-byte swizzle). The same for every (T, alpha) layout of a bank;
    once per bank (`lowered_tc` keeps them)."""
    return tu.UnitOperands(*(kernels._sw128(pl).contiguous()
                             for pl in kernels.split_planes3(
                                 fact_wide_tc_units(fkb).contiguous())))


# ---------------------------------------------------------------------------
# the fused kernel's layout (csrc/fact_fused_estimate.cu)
# ---------------------------------------------------------------------------

class FusedPlan(NamedTuple):
    """How the fused kernel splits a bank of D dims at rank M (`fused_plan`
    in csrc/fact_fused_estimate.cu): nc 64-deep chunks of 2D, half c of
    them (the first ceil(nc / 2), then the rest) a block's of the pair,
    and of a half, consumer warpgroup w's ncw[c][w] chunks (the first
    ceil(half / 2), then the rest) from column cb[c][w]; nu 32-column
    halves of 4M its forward product takes; pcs[c][w] the warpgroup's
    64-column output pieces below 2D; u[c][w] its units a component
    (forward chunks, then combine pieces) at off[c][w] of the component's
    `units`; rec_floats a record's floats (T mu padded to a multiple of 4,
    then 8 a bin of 64)."""
    nc: int
    nu: int
    ncw: tuple
    cb: tuple
    pcs: tuple
    u: tuple
    off: tuple
    units: int
    rec_floats: int


def fact_fused_plan(d: int, m: int) -> FusedPlan:
    """The fused kernel's split of a bank of D dims at rank M."""
    nc = tu.chunks(2 * d)
    halves = ((nc + 1) // 2, nc - (nc + 1) // 2)
    ncw, cb, pcs, u, off = [], [], [], [], []
    at = units = 0
    for half in halves:
        row = [(half + 1) // 2, half - (half + 1) // 2]
        ncw.append(tuple(row))
        cb.append(tuple(64 * (at + sum(row[:w])) for w in range(2)))
        at += half
        pcs.append(tuple(tu.chunks(min(64 * n_w, 2 * d - c))
                         for n_w, c in zip(row, cb[-1])))
        u.append(tuple(n_w + p for n_w, p in zip(row, pcs[-1])))
        off.append((units, units + u[-1][0]))
        units += sum(u[-1])
    return FusedPlan(nc, -(-4 * m // 32), tuple(ncw), tuple(cb), tuple(pcs),
                     tuple(u), tuple(off), units,
                     -(-2 * m // 4) * 4 + 8 * 64)


class FactFusedOperands(NamedTuple):
    """The bank as the fused kernel streams it. hi, lo, lo2: the bf16
    planes (`kernels.split_planes3`) of its units, per component each
    (half c, warpgroup w)'s u[c][w] units at off[c][w] (`fact_fused_plan`):
    the warpgroup's forward units (for each 64-deep chunk j of its columns
    of 2D: the 64 x 64 transpose of fwd_k's rows cb + 64 j + [0, 64) x its
    4M columns, padded to 64), then its combine pieces (for each 64-column
    piece p of its output: the transpose of comb_k's 4M rows, padded to
    64, x columns cb + 64 p + [0, 64)), each in the 128-byte swizzle
    (`kernels._sw128`), padding zero; rec: per component and (half,
    warpgroup) T mu (2M, zero-padded to a multiple of 4), then per bin b of
    the warpgroup's 64 the 8 floats (l0_b, l1_b, l2_b, 0, Re b_b, Im b_b,
    Re a1_b, Im a1_b) of lcoef, bias and a1, bins past D zero. The same
    for every (T, alpha) layout: those differ in `const` only.

    hi, lo, lo2: (K, units, 64, 64)   bfloat16
    rec:         (K, 4, rec_floats)   float32
    """
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor
    rec: torch.Tensor


def _quarters(pl: FusedPlan):
    """(half, warpgroup, first column, chunks, output pieces) of each
    quarter of 2D, in the layout's order."""
    return [(c, w, pl.cb[c][w], pl.ncw[c][w], pl.pcs[c][w])
            for c in range(2) for w in range(2)]


def fact_fused_units(fkb: FactKernelBank) -> torch.Tensor:
    """The bank's fwd and comb in float32 as the fused kernel's units
    ((K, units, 64, 64), before the split and the swizzle; see
    `FactFusedOperands`)."""
    k, two_d, four_m = fkb.fwd.shape
    pl = fact_fused_plan(two_d // 2, four_m // 4)
    fwd = torch.nn.functional.pad(fkb.fwd, (0, 64 - four_m,
                                            0, 64 * pl.nc - two_d))
    comb = torch.nn.functional.pad(fkb.comb, (0, 64 * pl.nc - two_d,
                                              0, 64 - four_m))
    units = []
    for _, _, cb, ncw, pcs in _quarters(pl):
        units.append(fwd[:, cb:cb + 64 * ncw].reshape(
            k, ncw, 64, 64).transpose(-1, -2))
        units.append(comb[:, :, cb:cb + 64 * pcs].reshape(
            k, 64, pcs, 64).permute(0, 2, 3, 1))
    return torch.cat(units, 1)


def fact_fused_operands(fkb: FactKernelBank) -> FactFusedOperands:
    """Split the bank's fwd and comb into bf16 hi / lo / lo2 and lay them
    out as the fused kernel's units, with each component's records
    (`FactFusedOperands`); once per bank (`lowered_tc` keeps them)."""
    k, two_d, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    pl = fact_fused_plan(d, m)
    planes = (kernels._sw128(p).contiguous() for p in kernels.split_planes3(
        fact_fused_units(fkb).contiguous()))
    tmu = torch.nn.functional.pad(fkb.tmu, (0, -(-2 * m // 4) * 4 - 2 * m))
    lc = fkb.lcoef.reshape(k, 3, d).transpose(1, 2)          # (K, D, 3)
    per_bin = torch.cat([lc, torch.zeros_like(lc[..., :1]),
                         fkb.bias.reshape(k, d, 2),
                         fkb.a1.reshape(k, d, 2)], -1)
    per_bin = torch.nn.functional.pad(per_bin, (0, 0, 0, 32 * pl.nc + 64 - d))
    rec = torch.stack([torch.cat([tmu, per_bin[:, cb // 2:cb // 2 + 64]
                                  .reshape(k, 8 * 64)], 1)
                       for _, _, cb, _, _ in _quarters(pl)], 1)
    return FactFusedOperands(*planes, rec.contiguous())


def check_fact_fused_operands(kernel: str, ops: FactFusedOperands,
                              fkb: FactKernelBank, device) -> None:
    """Raise unless ops holds the units and records of a bank of fkb's
    shape on `device` (`fact_fused_operands`)."""
    k, two_d, four_m = fkb.fwd.shape
    pl = fact_fused_plan(two_d // 2, four_m // 4)
    units = (k, pl.units, 64, 64)
    fields = [("hi", ops.hi, torch.bfloat16, units),
              ("lo", ops.lo, torch.bfloat16, units),
              ("lo2", ops.lo2, torch.bfloat16, units),
              ("rec", ops.rec, torch.float32, (k, 4, pl.rec_floats))]
    for name, t, dtype, shape in fields:
        if (t is None or t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            got = ("None" if t is None
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"{kernel}: operand {name} must be contiguous "
                             f"{dtype} {shape} on {device} "
                             f"(`fact_fused_operands`), got {got}")


# ---------------------------------------------------------------------------
# plain versions: the kernels' own arithmetic in float32
# ---------------------------------------------------------------------------

def _fact_reference(x2, fkb, t_coh, coh_alpha, stats, chunk, six=False):
    """The plain versions: the two products in float32 or (six) as the
    kernel's six bf16 products, everything else in float32."""
    pin_fp32()
    k, two_d, four_m = fkb.fwd.shape
    d, two_m = two_d // 2, four_m // 2
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    fwd = fkb.fwd.permute(1, 0, 2).reshape(two_d, k * four_m)
    comb = fkb.comb.reshape(k * four_m, two_d)
    if six:
        fwd6 = [p.to(x2.dtype) for p in kernels.split_planes3(fkb.fwd)]
        comb6 = [p.to(x2.dtype) for p in kernels.split_planes3(fkb.comb)]
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    ms, dens, outs = [], [], []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        if six:                                      # [beta | gamma]
            u = tc_products(xc, fwd6, 6).transpose(0, 1)
        else:
            u = (xc @ fwd).reshape(n, k, four_m)
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
        if six:   # the kernel's order: C_k = u_k comb_k, then w C
            h = h + w @ fkb.bias + torch.einsum(
                "kn,knd->nd", w.T, tc_products(u.transpose(0, 1), comb6, 6))
        else:
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


def fact_tc_reference(x2: torch.Tensor, fkb: FactKernelBank, t_coh: int = 1,
                      coh_alpha: float = 1.0, stats: bool = False,
                      chunk: int = 8192):
    """Plain PyTorch version of the kernel's arithmetic: K11 (K12 at
    t_coh > 1, K13 with `stats`) with [beta | gamma] = x fwd_k and C_k =
    [beta | gamma] comb_k each the six bf16 products of
    `variant_kernels.tc_products` (both operands split into hi, lo, lo2;
    [beta | gamma] split as the kernel splits its accumulator), the logits,
    pooling, softmax and the fold w (C + bias + a1 o x) in float32. For the
    CPU tests; nothing on the main path calls it. `fact_estimate_reference`
    is the same function with float32 products."""
    return _fact_reference(x2, fkb, t_coh, coh_alpha, stats, chunk, True)


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


def fact_fused_reference(x2: torch.Tensor, fkb: FactKernelBank,
                         t_coh: int = 1, coh_alpha: float = 1.0,
                         chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the fused K11's arithmetic (K12 at t_coh >
    1, fkb from `fact_kernel_bank(bank, t_coh, coh_alpha)`), walked as the
    kernel walks it: the forward u = x fwd as the sum of the four blocks'
    partial products over their quarters of 2D (`fact_fused_plan`: (P0 +
    P1) + (P2 + P3)), each the sum in order of its 64-deep chunks' six
    bf16 products (`variant_kernels.tc_products`), the diagonal term
    likewise the sum of the quarters' [Re x | Im x | |x|^2] . lcoef, the
    logit (const + lin) + |beta - T mu|^2, the pool, then an online
    softmax over the components: h = h sc + p (bias_k + a1_k o x), and h
    += p C_k with C_k = u_k comb_k six bf16 products, out = h / den; all in
    float32. On float64 rows the same walk with plain products in float64.
    x2 (N, 2D) interleaved -> (N, 2D). For the CPU tests and chip_smoke's
    checks; nothing on the main path calls it where a card is present."""
    pin_fp32()
    k, two_d, four_m = fkb.fwd.shape
    d, two_m = two_d // 2, four_m // 2
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    dt = x2.dtype
    six = dt != torch.float64
    f = FactKernelBank(*(v.to(dt) for v in fkb))
    pl = fact_fused_plan(d, four_m // 4)
    quarters = [[slice(c, min(c + 64, two_d))
                 for c in range(cb, min(cb + 64 * ncw, two_d), 64)]
                for _, _, cb, ncw, _ in _quarters(pl)]
    fwd = f.fwd.permute(1, 0, 2).reshape(two_d, k * four_m)
    lc = f.lcoef.reshape(k, 3, d).permute(2, 1, 0)            # (D, 3, K)
    if six:
        fwd6 = [p.to(dt) for p in kernels.split_planes3(fkb.fwd.permute(
            1, 0, 2).reshape(two_d, k * four_m))]
        comb6 = [p.to(dt) for p in kernels.split_planes3(fkb.comb)]
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    outs = []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        x3 = xc.reshape(n, d, 2)
        z = torch.stack([x3[..., 0], x3[..., 1],
                         x3[..., 0] * x3[..., 0] + x3[..., 1] * x3[..., 1]],
                        -1)                                   # (n, D, 3)
        parts, lins = [], []
        for chunks in quarters:
            part = None
            for s in chunks:
                acc = (tc_products(xc[:, s], [p[s] for p in fwd6], 6) if six
                       else xc[:, s] @ fwd[s])
                part = acc if part is None else part + acc
            parts.append(part)
            b = slice(chunks[0].start // 2, chunks[-1].stop // 2)
            lins.append(z[:, b].reshape(n, -1) @ lc[b].reshape(-1, k))
        u = ((parts[0] + parts[1]) + (parts[2] + parts[3])).reshape(
            n, k, four_m)
        lin = (lins[0] + lins[1]) + (lins[2] + lins[3])
        diff = u[..., :two_m] - f.tmu[None]
        lg = _pool((f.const[None] + lin) + (diff * diff).sum(-1), t_coh,
                   coh_alpha)
        m_run = torch.full((n,), -torch.inf, dtype=dt, device=xc.device)
        den = torch.zeros((n,), dtype=dt, device=xc.device)
        h = torch.zeros((n, two_d), dtype=dt, device=xc.device)
        for j in range(k):
            m_new = torch.maximum(m_run, lg[:, j])
            sc = torch.where(m_run == -torch.inf, torch.zeros_like(m_run),
                             torch.exp(m_run - m_new))[:, None]
            p = torch.exp(lg[:, j] - m_new)[:, None]
            den = den * sc[:, 0] + p[:, 0]
            m_run = m_new
            bb, a = f.bias[j].reshape(d, 2), f.a1[j].reshape(d, 2)
            hb = torch.stack([bb[:, 0] + a[:, 0] * x3[..., 0]
                              - a[:, 1] * x3[..., 1],
                              bb[:, 1] + a[:, 0] * x3[..., 1]
                              + a[:, 1] * x3[..., 0]], -1).reshape(n, two_d)
            c = (tc_products(u[:, j], [pl[j] for pl in comb6], 6) if six
                 else u[:, j] @ f.comb[j])
            h = (h * sc + p * hb) + p * c
        outs.append(h / den[:, None])
    return torch.cat(outs) if outs else x2.new_zeros((0, two_d))


def fact_wide_reference(x2: torch.Tensor, fkb: FactKernelBank,
                        t_coh: int = 1, coh_alpha: float = 1.0,
                        stats: bool = False, chunk: int = 8192):
    """Plain PyTorch version of the wide K11's arithmetic (K12 at t_coh >
    1, fkb from `fact_kernel_bank(bank, t_coh, coh_alpha)`; K13 with
    `stats`), its products walked as the kernel walks its units: the
    forward product u = x fwd (all components' [beta | gamma]) and the
    combine [w_k u_k] comb each a compensated sum over 64-deep chunks of
    the six bf16 products of `tc_units.six` (`tc_units.walked`); the
    quadratic terms |beta_k - T mu_k|^2 in float64, rounded once; the logit
    over the features [x | |x|^2] padded to whole 64-deep chunks, each
    16-deep step's six products added in a compensated sum with const and
    the quadratic term, whose error is folded in after the row's offset (its
    largest logit among the first 64 components) is taken off; the pool in
    float64, the softmax in float32; the fold sum_k w_k bias_k + (sum_k w_k
    a1_k) o x in float64, rounded once with the combine. x2 (N, 2D)
    float32 interleaved -> (N, 2D); `stats`: (m (N,), den (N,), h (N, 2D))
    instead, the un-normalised weights exp(l - max l) and m = fl(o + max
    l), o the row's offset. For the CPU tests and chip_smoke's checks;
    nothing on the main path calls it where a card is present."""
    pin_fp32()
    k, two_d, four_m = fkb.fwd.shape
    d, two_m = two_d // 2, four_m // 2
    fwd, coef, comb = _wide_products(fkb)
    wf = 64 * tu.chunks(3 * d)
    coef = torch.nn.functional.pad(coef, (0, 0, 0, wf - 3 * d))
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    tmu, bias, a1 = (v.double() for v in (fkb.tmu, fkb.bias, fkb.a1))
    ms, dens, outs = [], [], []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        u = tu.walked(xc, fwd).reshape(n, k, four_m)
        quad = ((u[..., :two_m].double() - tmu) ** 2).sum(-1).float()
        x3 = xc.reshape(n, d, 2)
        z = torch.nn.functional.pad(torch.cat(
            [xc, x3[..., 0] * x3[..., 0] + x3[..., 1] * x3[..., 1]], 1),
            (0, wf - 3 * d))
        lg = lost = torch.zeros(n, k, dtype=xc.dtype, device=xc.device)
        for c in range(0, wf, 16):
            lg, lost = tu.kahan(lg, lost, tu.six(z[:, c:c + 16],
                                                   coef[c:c + 16]))
        lg, lost = tu.kahan(lg, lost, fkb.const[None])
        lg, lost = tu.kahan(lg, lost, quad)
        off = lg[:, :64].max(-1, keepdim=True).values   # the row's offset
        off = torch.where(off > -1e29, off, torch.zeros_like(off))
        lg = _pool(((lg - off) - lost).double(), t_coh, coh_alpha).float()
        if stats:
            mx = lg.max(-1, keepdim=True).values
            mx = torch.where(mx > -torch.inf, mx, 0.0)
            o = _pool(off.double(), t_coh, coh_alpha)
            w = torch.exp(lg - mx)
            ms.append((o + mx.double()).float()[:, 0])
            dens.append(w.sum(-1))
        else:
            w = torch.softmax(lg, -1)
        lin = tu.walked((u * w[..., None]).reshape(n, k * four_m), comb)
        wd = w.double()
        wa = (wd @ a1).reshape(n, d, 2)
        xd = x3.double()
        ax = torch.stack([wa[..., 0] * xd[..., 0] - wa[..., 1] * xd[..., 1],
                          wa[..., 0] * xd[..., 1] + wa[..., 1] * xd[..., 0]],
                         -1).reshape(n, two_d)
        outs.append(((lin.double() + wd @ bias) + ax).float())
    out = torch.cat(outs) if outs else x2.new_zeros((0, two_d))
    if not stats:
        return out
    if not ms:
        return x2.new_zeros((0,)), x2.new_zeros((0,)), out
    return torch.cat(ms), torch.cat(dens), out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_inputs(x2: torch.Tensor, fkb: FactKernelBank) -> None:
    """Raise unless x2 and the layout's fields are contiguous float32 of
    matching shapes on x2's device."""
    n, two_d = x2.shape
    k, _, four_m = fkb.fwd.shape
    d, m, dev = two_d // 2, four_m // 4, x2.device
    kernels._check_cuda("x2", x2, (n, two_d), dev)
    kernels._check_cuda("fwd", fkb.fwd, (k, two_d, four_m), dev)
    kernels._check_cuda("comb", fkb.comb, (k, four_m, two_d), dev)
    kernels._check_cuda("tmu", fkb.tmu, (k, 2 * m), dev)
    kernels._check_cuda("lcoef", fkb.lcoef, (k, 3 * d), dev)
    kernels._check_cuda("const", fkb.const, (k,), dev)
    kernels._check_cuda("bias", fkb.bias, (k, two_d), dev)
    kernels._check_cuda("a1", fkb.a1, (k, two_d), dev)


def _launch(name: str, x2: torch.Tensor, fkb: FactKernelBank, t_coh: int,
            coh_alpha: float, stats: bool, ops: Optional[FactTcOperands]):
    """Validate, allocate and launch on x2's device and current stream with
    the bank's operands `ops` (laid out here when None); raise on any
    refusal. Returns out, or (m, den, out) for stats."""
    n, two_d = x2.shape
    k, _, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    if (two_d % 2 or four_m % 4 or n % t_coh
            or not fact_narrow(d, k, m, t_coh)):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with D <= "
            f"{FACT_MAX_D}, M <= {FACT_MAX_M} and T <= "
            f"{fact_tile_rows(d, m)}; got N={n}, D={d}, M={m}, K={k}, "
            f"T={t_coh}" + ("" if n % t_coh else
                            "; past the template, the wide form"))
    dev = x2.device
    _check_inputs(x2, fkb)
    if ops is None:
        ops = fact_tc_operands(fkb)
    check_fact_tc_operands(name, ops, fkb, dev)
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
                x2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                ops.lo2.data_ptr(), ops.rec.data_ptr(),
                fkb.const.data_ptr(), out.data_ptr(),
                m_out.data_ptr() if stats else None,
                den.data_ptr() if stats else None, n, d, m, k, int(t_coh),
                float(coh_alpha), int(stats), stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return (m_out, den, out) if stats else out


def fact_estimate(x2: torch.Tensor, fkb: FactKernelBank,
                  operands: Optional[FactTcOperands] = None) -> torch.Tensor:
    """K11 on x2 (N, 2D) float32 interleaved -> (N, 2D). On a CUDA tensor
    it launches the CUDA kernel on the current stream with the bank's
    `operands` (`fact_tc_operands(fkb)`, laid out in the call when None) and
    raises on any refusal; on a CPU tensor it computes the plain version."""
    if not x2.is_cuda:
        return fact_estimate_reference(x2, fkb)
    out = _launch("fact_estimate", x2, fkb, 1, 1.0, False, operands)
    if x2.shape[0]:
        fact_estimate.launches += 1
    return out


def fact_estimate_coherent(x2: torch.Tensor, fkb: FactKernelBank, t_coh: int,
                           coh_alpha: float = 1.0,
                           operands: Optional[FactTcOperands] = None
                           ) -> torch.Tensor:
    """K12 on x2 (N, 2D), N / T blocks of T consecutive rows (2 <= T <=
    `fact_tile_rows`), fkb from `fact_kernel_bank(bank, t_coh, coh_alpha)`,
    `operands` as for `fact_estimate` (any layout of the bank). CUDA kernel
    on a CUDA tensor, plain version on the CPU."""
    if t_coh < 2:
        raise ValueError(f"fact_estimate_coherent takes T >= 2; got {t_coh}")
    if not x2.is_cuda:
        return fact_estimate_coherent_reference(x2, fkb, t_coh, coh_alpha)
    out = _launch("fact_estimate_coherent", x2, fkb, t_coh, coh_alpha, False,
                  operands)
    if x2.shape[0]:
        fact_estimate_coherent.launches += 1
    return out


def fact_estimate_stats(x2: torch.Tensor, fkb: FactKernelBank,
                        operands: Optional[FactTcOperands] = None):
    """K13 on x2 (N, 2D) -> (m (N,), den (N,), acc (N, 2D) un-normalised),
    `operands` as for `fact_estimate`. CUDA kernel on a CUDA tensor, plain
    version on the CPU."""
    if not x2.is_cuda:
        return fact_estimate_stats_reference(x2, fkb)
    res = _launch("fact_estimate_stats", x2, fkb, 1, 1.0, True, operands)
    if x2.shape[0]:
        fact_estimate_stats.launches += 1
    return res


def fact_wide_launch_rows(n: int, d: int, k: int, m: int,
                          t_coh: int = 1) -> int:
    """Rows of one launch of the wide form: all n, or as many as keep its
    scratch within `kernels.WIDE_SCRATCH` (`fact_wide_row_bytes` a row), a
    multiple of 128 T (whole blocks, whole pairs of 64-row tiles)."""
    step = 128 * t_coh
    rows = max(step, kernels.WIDE_SCRATCH // fact_wide_row_bytes(d, k, m)
               // step * step)
    return min(n, rows)


def _launch_wide(wrapper, x2: torch.Tensor, fkb: FactKernelBank, t_coh: int,
                 coh_alpha: float, stats: bool,
                 ops: Optional[tu.UnitOperands]):
    """Launch the wide form (csrc/fact_wide_estimate.cu) on x2's device and
    current stream, one launch for each row chunk
    (`fact_wide_launch_rows`), and add one to `wrapper`'s count for each:
    -> out (N, 2D), or (m, den, out) for stats; raise on any refusal."""
    name = wrapper.__name__
    n, two_d = x2.shape
    k, _, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    if (two_d % 2 or four_m % 4 or n % t_coh
            or not fact_wide_eligible(d, k, m, t_coh)):
        raise ValueError(f"{name} takes N rows of whole T-row blocks; "
                         + _rule(d, k, m, t_coh) + f", N={n}")
    dev, f32 = x2.device, torch.float32
    _check_inputs(x2, fkb)
    out = torch.empty((n, two_d), dtype=f32, device=dev)
    m_out = den = None
    if stats:
        m_out = torch.empty((n,), dtype=f32, device=dev)
        den = torch.empty((n,), dtype=f32, device=dev)
    if n:
        if ops is None:
            ops = fact_wide_operands(fkb)
        tu.check_units(name, ops, fact_wide_units(d, k, m), dev,
                       "fact_wide_operands")
        rows = fact_wide_launch_rows(n, d, k, m, t_coh)
        chunks = max(tu.chunks(two_d), tu.chunks(3 * d),
                     tu.chunks(k * four_m))
        a = torch.empty((3, kernels.wide_row_tiles(rows) * chunks, 64, 64),
                        dtype=torch.bfloat16, device=dev)
        u = torch.empty((rows, k * four_m), dtype=f32, device=dev)
        lg = torch.empty((rows, k), dtype=f32, device=dev)
        offs = torch.empty((rows,), dtype=f32, device=dev)
        lib = kernels._library("fact_wide_estimate")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for i0 in range(0, n, rows):
                i1 = min(n, i0 + rows)
                err = lib.fact_wide_launch(
                    x2[i0:i1].data_ptr(), ops.hi.data_ptr(),
                    ops.lo.data_ptr(), ops.lo2.data_ptr(),
                    fkb.tmu.data_ptr(), fkb.const.data_ptr(),
                    fkb.bias.data_ptr(), fkb.a1.data_ptr(),
                    out[i0:i1].data_ptr(),
                    m_out[i0:i1].data_ptr() if stats else None,
                    den[i0:i1].data_ptr() if stats else None, a.data_ptr(),
                    u.data_ptr(), lg.data_ptr(), offs.data_ptr(), i1 - i0, d,
                    m, k, ops.hi.shape[0], int(t_coh), float(coh_alpha),
                    int(stats), stream)
                if err != 0:
                    raise RuntimeError(f"{name} launch failed: cudaError "
                                       f"{err}")
                wrapper.launches += 1
    return (m_out, den, out) if stats else out


def fact_estimate_wide(x2: torch.Tensor, fkb: FactKernelBank,
                       operands: Optional[tu.UnitOperands] = None
                       ) -> torch.Tensor:
    """K11's wide form on x2 (N, 2D) -> (N, 2D), `operands` from
    `fact_wide_operands(fkb)` (laid out in the call when None); the entries
    launch it past the template's rule. On a CUDA tensor it launches the
    CUDA kernels (`fact_wide_eligible`) and raises on any refusal; on a CPU
    tensor it computes the plain version `fact_wide_reference`."""
    if not x2.is_cuda:
        return fact_wide_reference(x2, fkb)
    return _launch_wide(fact_estimate_wide, x2, fkb, 1, 1.0, False,
                        operands)


def fact_estimate_coherent_wide(x2: torch.Tensor, fkb: FactKernelBank,
                                t_coh: int, coh_alpha: float = 1.0,
                                operands: Optional[tu.UnitOperands]
                                = None) -> torch.Tensor:
    """K12's wide form on x2 (N, 2D), N / T blocks of T consecutive rows (2
    <= T <= 64), fkb from `fact_kernel_bank(bank, t_coh, coh_alpha)`,
    `operands` as for `fact_estimate_wide` (any layout of the bank). CUDA
    kernels on a CUDA tensor, the plain version `fact_wide_reference` on
    the CPU."""
    if t_coh < 2:
        raise ValueError(f"fact_estimate_coherent_wide takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return fact_wide_reference(x2, fkb, t_coh, coh_alpha)
    return _launch_wide(fact_estimate_coherent_wide, x2, fkb, t_coh,
                        coh_alpha, False, operands)


def fact_estimate_stats_wide(x2: torch.Tensor, fkb: FactKernelBank,
                             operands: Optional[tu.UnitOperands] = None):
    """K13's wide form on x2 (N, 2D) -> (m (N,), den (N,), acc (N, 2D)
    un-normalised), `operands` as for `fact_estimate_wide`. CUDA kernels on
    a CUDA tensor, the plain version `fact_wide_reference` on the CPU."""
    if not x2.is_cuda:
        return fact_wide_reference(x2, fkb, stats=True)
    return _launch_wide(fact_estimate_stats_wide, x2, fkb, 1, 1.0, True,
                        operands)


def _launch_fused(wrapper, x2: torch.Tensor, fkb: FactKernelBank,
                  t_coh: int, coh_alpha: float,
                  ops: Optional[FactFusedOperands]) -> torch.Tensor:
    """Launch the fused kernel (csrc/fact_fused_estimate.cu) on x2's
    device and current stream with the bank's operands `ops` (laid out here
    when None), one launch for all rows, and add one to `wrapper`'s count:
    -> out (N, 2D); raise on any refusal."""
    name = wrapper.__name__
    n, two_d = x2.shape
    k, _, four_m = fkb.fwd.shape
    d, m = two_d // 2, four_m // 4
    if (two_d % 2 or four_m % 4 or n % t_coh
            or not fact_fused_fits(d, m, t_coh)):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with "
            f"{FACT_FUSED_MIN_D} <= D <= {FACT_FUSED_MAX_D}, M <= "
            f"{FACT_FUSED_MAX_M} and T <= {FACT_MAX_T}; got N={n}, D={d}, "
            f"M={m}, K={k}, T={t_coh}")
    dev = x2.device
    _check_inputs(x2, fkb)
    if ops is None:
        ops = fact_fused_operands(fkb)
    check_fact_fused_operands(name, ops, fkb, dev)
    out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
    if n:
        lib = kernels._library("fact_fused_estimate")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fact_fused_launch(
                x2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                ops.lo2.data_ptr(), ops.rec.data_ptr(), fkb.const.data_ptr(),
                out.data_ptr(), n, d, m, k, int(t_coh), float(coh_alpha),
                stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        wrapper.launches += 1
    return out


def fact_estimate_fused(x2: torch.Tensor, fkb: FactKernelBank,
                        operands: Optional[FactFusedOperands] = None
                        ) -> torch.Tensor:
    """K11 on the fused kernel: x2 (N, 2D) -> (N, 2D), `operands` from
    `fact_fused_operands(fkb)` (laid out in the call when None); the
    entries keep the wide form (`fact_fused_fits`). On a CUDA tensor
    it launches the CUDA kernel (`fact_fused_fits`) and raises on any
    refusal; on a CPU tensor it computes the plain version
    `fact_fused_reference`."""
    if not x2.is_cuda:
        return fact_fused_reference(x2, fkb)
    return _launch_fused(fact_estimate_fused, x2, fkb, 1, 1.0, operands)


def fact_estimate_coherent_fused(x2: torch.Tensor, fkb: FactKernelBank,
                                 t_coh: int, coh_alpha: float = 1.0,
                                 operands: Optional[FactFusedOperands]
                                 = None) -> torch.Tensor:
    """K12 on the fused kernel: x2 (N, 2D), N / T blocks of T consecutive
    rows (2 <= T <= 64), fkb from `fact_kernel_bank(bank, t_coh,
    coh_alpha)`, `operands` as for `fact_estimate_fused` (any layout of the
    bank). CUDA kernel on a CUDA tensor, the plain version
    `fact_fused_reference` on the CPU."""
    if t_coh < 2:
        raise ValueError(f"fact_estimate_coherent_fused takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return fact_fused_reference(x2, fkb, t_coh, coh_alpha)
    return _launch_fused(fact_estimate_coherent_fused, x2, fkb, t_coh,
                         coh_alpha, operands)


kernels.register_wrappers(fact_estimate, fact_estimate_coherent,
                          fact_estimate_stats, fact_estimate_wide,
                          fact_estimate_coherent_wide,
                          fact_estimate_stats_wide, fact_estimate_fused,
                          fact_estimate_coherent_fused)


# ---------------------------------------------------------------------------
# entries on complex observations and factored banks
# ---------------------------------------------------------------------------

def _check_eligible(bank: FactoredBank, t: int) -> bool:
    """Raise unless the factored kernels take the bank at T; return whether
    the wide form does (`fact_narrow` decides, from the shapes alone)."""
    k, m, d = bank.t_mat.shape
    if not fact_kernel_eligible(d, k, m, t):
        raise ValueError(_rule(d, k, m, t))
    return not fact_narrow(d, k, m, t)


def estimate_fused_factored(bank: FactoredBank, r: torch.Tensor,
                            cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode factored estimate of r (N, D) complex -> (N, D) through
    K11 (its wide form past the template's rule): the kernel analog of
    `mfa_bank.estimate_factored` (selection modes stay on the pipeline).
    Raises outside `fact_kernel_eligible` (`harness.stages.estimate_factored`
    sends those to the pipeline). `cache`: see `lowered` and
    `lowered_tc`."""
    wide = _check_eligible(bank, 1)
    ops = lowered_tc(bank, cache) if r.is_cuda else None
    est = fact_estimate_wide if wide else fact_estimate
    return _hc(est(_x2(r), lowered(bank, cache), ops), r.dtype)


def estimate_fused_factored_coherent(bank: FactoredBank, r: torch.Tensor,
                                     alpha: float = 1.0,
                                     cache: Optional[dict] = None
                                     ) -> torch.Tensor:
    """Coherent 'all'-mode factored estimate of blocks r (B, T, D) ->
    (B, T, D): the kernel analog of `mfa_bank.estimate_factored_coherent`.
    T = 1 runs K11; T within `fact_kernel_eligible` runs K12 (the
    template's or the wide one) with the alpha blend in the kernel; beyond
    the rule it raises. `cache`: see `lowered` and `lowered_tc`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, D) blocks, got {tuple(r.shape)}")
    b, t, d = r.shape
    if t == 1:
        return estimate_fused_factored(bank, r[:, 0, :], cache)[:, None, :]
    wide = _check_eligible(bank, t)
    ops = lowered_tc(bank, cache) if r.is_cuda else None
    est = fact_estimate_coherent_wide if wide else fact_estimate_coherent
    h2 = est(_x2(r), lowered(bank, cache, t, alpha), t, alpha, ops)
    return _hc(h2, r.dtype).reshape(b, t, d)


def estimate_fused_factored_stats(bank: FactoredBank, r: torch.Tensor,
                                  cache: Optional[dict] = None):
    """Kernel analog of `mfa_bank.estimate_factored_stats` through K13 (its
    wide form past the template's rule): (m (N,), den (N,), acc (N, D)
    complex64) of a (component shard of a) factored bank, in the logit
    convention of `mfa_bank._stats_chunk`, so kernel and pipeline shard
    states merge with `kernels.merge_stats`. `cache`: see `lowered` and
    `lowered_tc`."""
    wide = _check_eligible(bank, 1)
    ops = lowered_tc(bank, cache) if r.is_cuda else None
    est = fact_estimate_stats_wide if wide else fact_estimate_stats
    m, den, acc2 = est(_x2(r), lowered(bank, cache), ops)
    return m, den, _hc(acc2, torch.complex64)
