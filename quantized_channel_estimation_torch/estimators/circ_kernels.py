"""The hand-written circulant (FFT-domain) estimation kernels and their
plain versions.

Port of the structured-bank section of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`:
`CircKernelBank`, `circ_kernel_bank` (with `blocks`), and the
entries `estimate_fused_circulant` (K6), `estimate_fused_circulant_coherent`
(K7), `estimate_fused_circulant_stats` (K8) and
`estimate_fused_circulant_coherent_stats` (K9). The four kernels are the
multi-pilot template of `mp_circ_kernels` at one pilot (its COH and STATS
flags, `csrc/mp_circ_estimate.cu`), on Hopper's tensor cores: the
features [u | |u|^2] are K10's at P = 1, the logit coefficients are the
same numbers, and the combine (K, 4D) is K10's two slabs (bias, filter).
`circ_tc_operands` lays a `CircKernelBank` out as that template's bf16
units (cached per shard by `lowered_tc`), and `circ_tc_reference` is the
plain version of that arithmetic; shard states merge with
`kernels.merge_stats`.

Differences of layout from the TPU kernels, none of arithmetic:

- complex rows are interleaved [re, im] pairs, the memory layout of a
  complex64 tensor, so the kernels read the observations and write the
  estimates in place of the [Re | Im] split copies of the TPU path; the
  bank operands are laid out to match (see `CircKernelBank`);
- coherence blocks are block-major (the T rows of a block consecutive), as
  in `ops.scm.flatten_coherence` and K3, not the TPU's T-major tiles;
- the eligibility rule `circ_kernel_eligible` is the CUDA kernels' range
  (D <= 672, T up to a warpgroup's 64 live rows), in place of the TPU's
  resident-bank budget (D <= 652 at K = 1); beyond it the entries raise
  and `harness.stages` takes the `torch.fft` pipeline. One launch takes
  K <= 128 components; a larger bank is split over K into shards of 128,
  each through the stats kernel (K8 / K9), merged with `merge_stats` and
  inverse-transformed once.

Past D = 128 (`CIRC_MAX_D`, the template's edge) the same wrappers launch
one of two kernels, by one rule of the shapes (`circ_route`):

- K6 / K7 wherever the transform splits into two levels of at most 64
  points (`circ_fact_blocks`: the DFT at 314 of the 544 widths 129-672,
  and kron bases of two such DFTs), and K8 / K9 there too where the
  launch's K and T are among those it was measured faster at
  (`circ_stats_fact_eligible`: 3 K <= D, few dense odd-prime stages, two
  sweeps only without them), run the factorised kernel,
  `csrc/circ_fact_estimate.cu`, K8 / K9 its STATS form (counted apart:
  `circ_estimate_fact`, `circ_estimate_coherent_fact`,
  `circ_estimate_stats_fact`, `circ_estimate_coherent_stats_fact`): one
  launch a tile of 16 rows, the transforms as Stockham stages in shared
  memory with the bins left in a permuted order (`circ_fact_perm`), the
  logit and the combine on the tensor cores, nothing in global memory
  between; the STATS form keeps each row's offset, writes m and den and
  the accumulator in natural bin order in place of the normalisation and
  the inverse. `circ_fact_operands` lays a `CircKernelBank` out for it
  (cached per shard by `lowered_tc`), `circ_fact_reference` is its plain
  version;
- the other wide widths (230 of them: a prime factor past 64, as 652 = 4
  x 163), and K8 / K9 where the rule leaves them, run the kernels' dense
  wide form, `csrc/circ_wide_estimate.cu`
  (counted apart: `circ_estimate_wide` and its coherent and stats
  siblings): the
  four products cut into 64-deep chunks on one wgmma template, each
  chunk's six bf16 products into a fresh accumulator, the chunks in a
  compensated sum, the intermediates (u, the logits, h) in global scratch
  between the passes, rows cut into launches within
  `kernels.WIDE_SCRATCH`. `circ_wide_operands` lays a `CircKernelBank`
  out as its units (cached per shard by `lowered_tc`), `circ_wide_rows`
  is the plain version of its row layout.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU: the public wrappers
that of the kernel they launch on a card (`_plain`: the factorised one
where `circ_route` says 'fact').
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import tc_units as tu
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.estimators.kernels import merge_stats
from quantized_channel_estimation_torch.estimators.mp_circ_kernels import (
    CIRC_MAX_D, CIRC_MAX_K, _cplx_interleaved, _hc, _odd_points, _pool, _x2)
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import profiling


CIRC_WIDE_MAX_D = mk.WIDE_MAX_D   # bins of the wide form: 672
CIRC_MAX_T = mk.WIDE_MAX_T       # rows of a coherence block pooled: 64


def circ_tile_rows(d: int) -> int:
    """Live rows of one warpgroup of the circulant kernels at D bins
    (`mp_circ_kernels.mp_circ_tile_rows` at one pilot, pooled, at the
    widest launch of 128 components: 64 at every D <= 128; the wide form
    past it pools any block of up to 64 rows): the largest coherence
    block K7 / K9 pool."""
    if d > CIRC_MAX_D:
        return CIRC_MAX_T
    return mk.mp_circ_tile_rows(d, CIRC_MAX_K, 1, 2)


def circ_kernel_eligible(d: int, k: int, t: int = 1) -> bool:
    """Can the circulant kernels serve a bank of K components over D bins,
    pooling T-snapshot blocks? D <= 672 (the template up to 128, its wide
    form past it; a superset of the JAX package's Pallas rule, which stops
    at D = 652) and T within a warpgroup's live rows at the widest launch
    (`circ_tile_rows`: T <= 64 at every D; a narrower launch or T = 1
    leaves at least as many); any K (more than 128 components are split
    into shards, see `estimate_fused_circulant`). A rule of the shapes,
    decided before any launch."""
    return (1 <= d <= CIRC_WIDE_MAX_D and k >= 1
            and 1 <= t <= circ_tile_rows(d))


def circ_bound(n: int, d: int, k: int, t_coh: int = 1,
               stats: bool = False) -> dict:
    """The least time an H100 could take for K6-K9's function on n rows of
    a K-component launch at D bins (`profiling.bound_ms`: operations at
    the card's peaks against bytes at its memory rate):

    - the forward transform and, except for the stats forms, the inverse
      as FFTs, 5 D log2 D fp32 operations a row each (a block-DFT basis
      costs the same);
    - the logit and combine products as the kernels' six bf16 products of
      2 n (3D K + 4 K D) on the tensor cores;
    - the epilogue, n (11 D + 5 K) fp32 operations (|u|^2, the combine per
      bin, the softmax), and 3 n K more for the coherent pooling;
    - the rows read once, the output (and m, den) written once, and the
      bank's logit and combine operands read once.

    Returns {"bound_ms", "bound_by", "fp32_flops", "tc_flops", "bytes"}
    and "bound_dft_ms": the same with both transforms counted as the
    kernels compute them, dense (2D, 2D) products on six bf16 products,
    and their operands read once (the bound of the kernels' algorithm,
    not of the function)."""
    two_d = 2 * d
    n_tr = 1 if stats else 2
    fft = n_tr * 5.0 * d * math.log2(max(d, 2)) * n
    epi = n * (11.0 * d + 5.0 * k + (3.0 * k if t_coh > 1 else 0.0))
    tc = 6.0 * 2 * n * (3 * d * k + 4 * k * d)
    out = (2 * n if stats else 0) + n * two_d
    nbytes = 4.0 * (n * two_d + out + 3 * d * k + k + 4 * k * d)
    ms, by = profiling.bound_ms(fft + epi, tc, nbytes)
    dense = n_tr * two_d * two_d
    dft_ms, _ = profiling.bound_ms(epi, tc + 6.0 * 2 * n * dense,
                                   nbytes + 4.0 * dense)
    return {"bound_ms": ms, "bound_by": by, "fp32_flops": fft + epi,
            "tc_flops": tc, "bytes": nbytes, "bound_dft_ms": dft_ms}


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
    # past the template's D the transform is built in complex128 and
    # rounded once: a complex64 exp of D^2-sized integer phases times a
    # rounded 2 pi / D errs by ~9e-6 an entry at D = 512, and the float64
    # evaluation of such a layout lay 6.7e-4 of the estimate's scale from
    # the float64 `torch.fft` pipeline (D = 512, K = 16, the bank and rows
    # of `tools.circ_kernel_bench`'s d512 leg); up to D = 128 the
    # construction is the JAX package's (`linalg.unitary_dft` in
    # complex64), which the parity tests hold the layout to
    f = sb._dft_matrix(d, blocks, torch.complex128 if d > CIRC_MAX_D
                       else bank.mean_rf.dtype, bank.mean_rf.device)
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


# ---------------------------------------------------------------------------
# the tensor-core layout of the bank: K10's units at one pilot
# ---------------------------------------------------------------------------

def circ_mp_bank(ckb: CircKernelBank) -> mk.MpCircKernelBank:
    """The bank as K10's layout at P = 1: bfwd, lcoef (K6's rows 2 Re cm,
    -2 Im cm are K10's 2 Re pm, 2 Im pm with pm = prec mean; -prec on
    |u|^2), const (K6's, without the row constant -D log pi) and binv as
    they are; comb (K, 4D) of [br, bi, fr, fi] per bin as the two
    interleaved slabs (2, K, 2D), bias then filter."""
    k, four_d = ckb.comb.shape
    comb = ckb.comb.reshape(k, four_d // 4, 2, 2).permute(2, 0, 1, 3)
    return mk.MpCircKernelBank(ckb.bfwd, ckb.lcoef, ckb.const,
                               comb.reshape(2, k, four_d // 2).contiguous(),
                               ckb.binv)


def circ_tc_operands(ckb: CircKernelBank,
                     stats: bool = False) -> tu.UnitOperands:
    """The bank's bf16 units as the template streams them at one pilot
    (`mp_circ_kernels.mp_circ_tc_operands` of `circ_mp_bank`): 15 at D =
    K = 64, the stats forms' without the inverse operand's (11). The same
    for every (T, alpha) layout of a bank."""
    return mk.mp_circ_tc_operands(circ_mp_bank(ckb), stats)


def _units(ckb: CircKernelBank, stats: bool) -> int:
    return mk.mp_circ_units(ckb.bfwd.shape[0] // 2, ckb.const.shape[0], 1,
                            stats)


# ---------------------------------------------------------------------------
# the wide form's layout (csrc/circ_wide_estimate.cu)
# ---------------------------------------------------------------------------

def circ_wide_units(d: int, k: int, stats: bool = False) -> int:
    """Units (64 columns x 64 deep) of the wide form's bank: the forward
    operand's NPD x NPD, the logit's KP x NZ, the combine's NPD x 2 x KP
    and, except for the stats forms, the inverse's NPD x NPD (NPD, NZ, KP
    the 64-wide pieces of 2D, 3D and K): the wide K10's units at one pilot
    (`mp_circ_kernels.mp_circ_wide_units`)."""
    return mk.mp_circ_wide_units(d, k, 1, stats)


def circ_wide_tc_units(ckb: CircKernelBank,
                       stats: bool = False) -> torch.Tensor:
    """The bank's four operands in float32 as the wide form's units
    (`circ_wide_units` of them, (units, 64, 64)): the wide K10's at one
    pilot (`mp_circ_kernels.mp_circ_wide_tc_units` of `circ_mp_bank`), each
    product's pieces one after another, a piece's chunks consecutive: the
    forward operand bfwd (2D, 2D); the logit operand lcoef (3D, K) against
    [u | |u|^2]; for each 64-column piece j of 2D the bias slab's piece j,
    then the filter slab's, so one block's two pieces are a bin's (bias,
    filter); the inverse binv (2D, 2D), except for the stats forms."""
    return mk.mp_circ_wide_tc_units(circ_mp_bank(ckb), stats)


def circ_wide_operands(ckb: CircKernelBank,
                       stats: bool = False) -> tu.UnitOperands:
    """Split the bank's operands into bf16 hi / lo / lo2 and lay them out
    as the wide form's units (`circ_wide_tc_units`, in the 128-byte
    swizzle); the stats forms' without the inverse. The same for every (T,
    alpha) layout of a bank; once per bank (`lowered_tc` keeps them)."""
    return tu.UnitOperands(*(kernels._sw128(pl).contiguous()
                             for pl in kernels.split_planes3(
                                 circ_wide_tc_units(ckb, stats)
                                 .contiguous())))


def circ_operands(ckb: CircKernelBank, stats: bool = False, blocks=None,
                  t_coh: int = 1):
    """The operands of the kernel that serves ckb's D, K and T
    (`circ_route`, in the basis `blocks`): the template's units
    (`circ_tc_operands`) up to D = 128; past it the factorised kernel's
    (`circ_fact_operands`) or the wide form's units
    (`circ_wide_operands`)."""
    route = circ_route(ckb.bfwd.shape[0] // 2, blocks, stats,
                       ckb.const.shape[0], t_coh)
    if route == "fact":
        return circ_fact_operands(ckb, blocks)
    return (circ_wide_operands if route == "wide" else circ_tc_operands)(
        ckb, stats)


def circ_wide_rows(x: torch.Tensor, features: bool = False) -> torch.Tensor:
    """Rows x (N, W) float32 -> their three bf16 planes as the wide form's
    products read them: (3, tiles, ceil(W / 64), 64, 64), the wide K1's
    row layout (`kernels.wide_row_planes`, which splits the rows); with
    `features`, x is u (N, 2D) and the rows are its logit features [u |
    |u|^2] (N, 3D): on a CUDA tensor the wide form's feature split
    (`circ_wide_features_launch`; uncounted: the wrappers count their
    launch), on a CPU tensor this plain version."""
    if not features:
        return kernels.wide_row_planes(x)
    n, two_d = x.shape
    if not x.is_cuda:
        u3 = x.reshape(n, -1, 2)
        return kernels.wide_row_planes(torch.cat([x, (u3 * u3).sum(-1)],
                                                 dim=1))
    kernels._check_cuda("u", x, (n, two_d), x.device)
    a = torch.empty((3, kernels.wide_row_tiles(n), tu.chunks(two_d // 2 * 3),
                     64, 64), dtype=torch.bfloat16, device=x.device)
    if n == 0:
        return a.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernels._library("circ_wide_estimate").circ_wide_features_launch(
            x.data_ptr(), a.data_ptr(), n, two_d, 1, stream)
    if err != 0:
        raise RuntimeError(f"circ_wide_features launch failed: cudaError "
                           f"{err}")
    return a


def lowered_tc(bank: CirculantBank, cache: Optional[dict] = None,
               blocks=None, stats: bool = False, t_coh: int = 1):
    """The kernels' operands of each shard of `bank` (`circ_operands` of
    its T = 1 layouts, `lowered`: the template's up to D = 128, past it the
    factorised kernel's or the wide form's, `circ_route` at the shard's K
    and at T = t_coh), kept in `cache` under ("circ_tc_operands", blocks,
    stats), ("circ_fact_operands", ...) or ("circ_wide_operands", ...)
    beside the layouts (the tuple of the shards' names where their routes
    differ), so a bank served many times is split and laid out once."""
    d = bank.spec_cr.shape[1]
    ckbs = lowered(bank, cache, blocks)
    names = tuple(_OPERANDS[circ_route(d, blocks, stats, c.const.shape[0],
                                       t_coh)] for c in ckbs)
    key = (names[0] if len(set(names)) == 1 else names, blocks, bool(stats))
    if cache is not None and key in cache:
        return cache[key]
    ops = tuple(circ_operands(c, stats, blocks, t_coh) for c in ckbs)
    if cache is not None:
        cache[key] = ops
    return ops


# ---------------------------------------------------------------------------
# the factorised kernel's layout (csrc/circ_fact_estimate.cu)
# ---------------------------------------------------------------------------

CIRC_FACT_MAX_N = 64    # points of one level of the factorised transform
CIRC_FACT_ROWS = 16     # rows of the factorised kernel's tile (kRows)


def circ_fact_split(d: int) -> Optional[Tuple[int, int]]:
    """The factorised kernel's split of a D-point DFT: (d1, d2) with d1 d2
    = D and 2 <= d1 <= d2 <= 64, d1 the largest divisor of D at most
    sqrt(D) (the most balanced split: 512 -> (16, 32), 672 -> (24, 28),
    357 -> (17, 21), 144 -> (12, 12)); None where none exists (a prime
    factor past 64, or a prime D)."""
    best = None
    for d1 in range(2, math.isqrt(d) + 1):
        if d % d1 == 0 and d // d1 <= CIRC_FACT_MAX_N:
            best = (d1, d // d1)
    return best


def circ_fact_blocks(d: int, blocks=None) -> Optional[Tuple[int, int]]:
    """The levels (d1, d2) of the factorised kernel for a bank over D bins
    in the DFT basis (`circ_fact_split`) or in the kron(F_n1, F_n2) basis
    `blocks` ((n1, n2) itself where 2 <= n1, n2 <= 64); None where the
    kernel cannot take the transform."""
    if blocks is None:
        return circ_fact_split(d)
    n1, n2 = (int(b) for b in blocks)
    ok = 2 <= n1 <= CIRC_FACT_MAX_N and 2 <= n2 <= CIRC_FACT_MAX_N
    return (n1, n2) if ok and n1 * n2 == d else None


def circ_stats_fact_eligible(d: int, k: int, t: int = 1,
                             blocks=None) -> bool:
    """Does the route send the stats forms K8 / K9 of a K-component launch
    at D bins, T-row blocks, to the factorised kernel's STATS form? A
    transform that splits (`circ_fact_blocks` in the basis `blocks`), and
    only where the kernel was measured faster than the dense wide form
    (`tools/circ_fact_bench.py stats_reach`, PERF.md §6): 3 K <= D (past
    it the products outweigh the dense forward transform the kernel saves:
    D = 144 at K = 64, D = 336 and 357 at K = 128 lost), dense odd-prime
    stages of at most D / 10 points an output in all (`_odd_points`: 129 =
    3 x 43, 133 = 7 x 19 and 185 = 5 x 37 lost, 357 = 17 x 21 won), and a
    block of T rows past one 16-row tile (two sweeps, the transform
    recomputed) only without odd-prime stages (D = 200, T = 64 lost)."""
    levels = circ_fact_blocks(d, blocks)
    if levels is None:
        return False
    odd = _odd_points(levels[0]) + _odd_points(levels[1])
    return 3 * k <= d and 10 * odd <= d and (t <= CIRC_FACT_ROWS or odd == 0)


def circ_route(d: int, blocks=None, stats: bool = False, k: int = 1,
               t: int = 1) -> str:
    """Which kernel serves the circulant wrappers at D bins: 'template'
    (`csrc/mp_circ_estimate.cu`) up to D = 128; past it the factorised
    kernel ('fact', `csrc/circ_fact_estimate.cu`) for K6 / K7 wherever the
    transform splits (`circ_fact_blocks`) and for the stats forms K8 / K9
    (its STATS form) where `circ_stats_fact_eligible` admits the launch's K
    and T, else the dense wide form ('wide', `csrc/circ_wide_estimate.cu`).
    A rule of the shapes, decided before any launch."""
    if d <= CIRC_MAX_D:
        return "template"
    if stats:
        return "fact" if circ_stats_fact_eligible(d, k, t, blocks) else "wide"
    return "fact" if circ_fact_blocks(d, blocks) is not None else "wide"


_OPERANDS = {"template": "circ_tc_operands", "wide": "circ_wide_operands",
             "fact": "circ_fact_operands"}


def circ_fact_perm(d: int, blocks=None) -> torch.Tensor:
    """The bin at each position of the factorised transform's output
    (long, (D,)): position p d2 + q holds bin p + d1 q of the DFT, and bin
    p d2 + q of the kron basis (its natural order)."""
    d1, d2 = circ_fact_blocks(d, blocks)
    pos = torch.arange(d)
    if blocks is not None:
        return pos
    return pos // d2 + d1 * (pos % d2)


def _fact_tables(d1: int, d2: int, kron: bool, device=None):
    """(W_d1, W_d2, cross) in complex128: W_n[t] = exp(-2 pi i t / n) and
    cross[p d2 + b] = exp(-2 pi i p b / D) / sqrt(D) (1 / sqrt(D) for the
    kron basis), the exponents reduced mod n before the phase is formed."""
    d = d1 * d2

    def w(n, e):
        return torch.exp(-2j * math.pi * (e % n).to(torch.float64) / n)

    t1 = w(d1, torch.arange(d1, device=device))
    t2 = w(d2, torch.arange(d2, device=device))
    pb = torch.outer(torch.arange(d1, device=device),
                     torch.arange(d2, device=device)).reshape(-1)
    cross = (torch.ones(d, dtype=torch.complex128, device=device) if kron
             else w(d, pb)) / math.sqrt(d)
    return t1, t2, cross


def _dft(table: torch.Tensor) -> torch.Tensor:
    """The n-point DFT matrix W_n^{jk} from the table W_n[t]."""
    n = table.shape[0]
    e = torch.outer(torch.arange(n, device=table.device),
                    torch.arange(n, device=table.device)) % n
    return table[e]


def circ_fact_transform(xc: torch.Tensor, d1: int, d2: int,
                        kron: bool = False,
                        inverse: bool = False) -> torch.Tensor:
    """Plain version of the factorised kernel's transforms on complex rows
    (n, D) in their own precision (complex64: the tables rounded once from
    complex128): forward, d2 DFTs of d1 points over a (x[a d2 + b]), the
    cross twiddle with 1 / sqrt(D), d1 DFTs of d2 points over b, the bins
    left at positions p d2 + q (`circ_fact_perm`); inverse, the mirrored
    steps from that order into natural order. Each level is its factor's
    dense DFT."""
    n, d = xc.shape
    t1, t2, cross = (t.to(xc.dtype) for t in _fact_tables(d1, d2, kron,
                                                           xc.device))
    f1, f2, cross = _dft(t1), _dft(t2), cross.reshape(d1, d2)
    x3 = xc.reshape(n, d1, d2)
    if not inverse:
        a = (x3.transpose(1, 2) @ f1).transpose(1, 2) * cross
        return (a @ f2).reshape(n, d)
    g = (x3 @ f2.conj()) * cross.conj()
    return (g.transpose(1, 2) @ f1.conj()).transpose(1, 2).reshape(n, d)


def _fact_real(x2: torch.Tensor, d1: int, d2: int, kron: bool,
               inverse: bool) -> torch.Tensor:
    """`circ_fact_transform` on interleaved real rows (n, 2D)."""
    xc = torch.view_as_complex(x2.reshape(x2.shape[0], -1, 2).contiguous())
    out = circ_fact_transform(xc, d1, d2, kron, inverse)
    return torch.view_as_real(out).reshape(x2.shape)


def circ_fact_bank(ckb: CircKernelBank, blocks=None) -> CircKernelBank:
    """ckb with its per-bin rows of lcoef (2c, 2c + 1, 2D + c) and columns
    of comb (4c .. 4c + 3) in the factorised transform's order
    (`circ_fact_perm`); bfwd and binv as they are (the factorised route
    does not read them)."""
    d = ckb.bfwd.shape[0] // 2
    perm = circ_fact_perm(d, blocks).to(ckb.lcoef.device)
    rows = torch.cat([torch.stack([2 * perm, 2 * perm + 1], -1).reshape(-1),
                      2 * d + perm])
    cols = (4 * perm[:, None] + torch.arange(4, device=perm.device)
            ).reshape(-1)
    return CircKernelBank(ckb.bfwd, ckb.lcoef[rows].contiguous(), ckb.const,
                          ckb.comb[:, cols].contiguous(), ckb.binv)


class CircFactOperands(NamedTuple):
    """The factorised kernel's operands of a bank, over the kernel's
    padded row of dp = d1 (d2 | 1) slots (`circ_fact_slots`; the pad
    slots' rows and columns zero): each bf16 plane (hi, lo, lo2 of the
    three-plane split) holds the permuted lcoef's mma.sync B fragments
    ((k16 step, n8 tile) of the (3 dp, K) product, 32 lanes of four
    values), then the permuted comb's ((n8 tile, k16 step) of the (K, 4 dp)
    product), `circ_fact_units(d1, d2, K)` lanes of four; tw the float32
    tables W_d1, W_d2 and the cross twiddle over the dp slots as
    interleaved [re, im] pairs; the levels (d1, d2) and whether the basis
    is kron's."""
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor
    tw: torch.Tensor
    d1: int
    d2: int
    kron: bool


def circ_fact_slots(d1: int, d2: int) -> torch.Tensor:
    """The kernel's shared-memory slot of each position a d2 + b of the
    transform's output (long, (d1 d2,)): lines of d2 | 1 slots, an odd
    stride that puts the lines a half-warp reads at one offset on distinct
    banks."""
    pos = torch.arange(d1 * d2)
    return pos // d2 * (d2 | 1) + pos % d2


def circ_fact_units(d1: int, d2: int, k: int) -> int:
    """Lanes (of four bf16) of each plane of `CircFactOperands` over dp =
    d1 (d2 | 1) slots: the logit's ceil(3 dp / 16) x ceil(K / 8)
    fragments and the combine's ceil(4 dp / 8) x ceil(K / 16), 32 lanes
    each."""
    dp = d1 * (d2 | 1)
    return 32 * (-(-3 * dp // 16) * -(-k // 8) + -(-4 * dp // 8) * -(-k // 16))


def _b_fragments(m: torch.Tensor, k_major: bool) -> torch.Tensor:
    """A (depth, cols) operand -> its mma.sync m16n8k16 B fragments, (k16
    step, n8 tile) in that order (`k_major`) or (n8 tile, k16 step), each
    32 lanes of four values: lane 4 g + q holds rows 2q, 2q + 1, 2q + 8, 2q
    + 9 of the step in column g of the tile; zero-padded."""
    depth, cols = m.shape
    a, b = -(-depth // 16), -(-cols // 8)
    pad = m.new_zeros((16 * a, 8 * b))
    pad[:depth, :cols] = m
    six = pad.reshape(a, 2, 4, 2, b, 8)     # step, half, q, pair, tile, g
    order = (0, 4, 5, 2, 1, 3) if k_major else (4, 0, 5, 2, 1, 3)
    return six.permute(*order).reshape(-1, 4)


def circ_fact_operands(ckb: CircKernelBank, blocks=None) -> CircFactOperands:
    """Lay ckb out for the factorised kernel in the transform basis
    `blocks` (None: the DFT): lcoef and comb permuted (`circ_fact_bank`)
    onto the kernel's padded slots, split into bf16 hi / lo / lo2 and laid
    out as B fragments; the tables built in float64 and rounded once. The
    same for every (T, alpha) layout of a bank; once per bank (`lowered_tc`
    keeps them)."""
    d = ckb.bfwd.shape[0] // 2
    levels = circ_fact_blocks(d, blocks)
    if levels is None:
        raise ValueError(f"the factorised kernel takes no D = {d} transform"
                         f" (blocks={blocks}): circ_fact_blocks")
    d1, d2 = levels
    dp, k = d1 * (d2 | 1), ckb.const.shape[0]
    fb = circ_fact_bank(ckb, blocks)
    slot = circ_fact_slots(d1, d2).to(ckb.lcoef.device)
    lcoef = fb.lcoef.new_zeros((3 * dp, k))
    lcoef[2 * slot] = fb.lcoef[0:2 * d:2]
    lcoef[2 * slot + 1] = fb.lcoef[1:2 * d:2]
    lcoef[2 * dp + slot] = fb.lcoef[2 * d:]
    comb = fb.comb.new_zeros((k, dp, 4))
    comb[:, slot] = fb.comb.reshape(k, d, 4)
    frags = torch.cat([_b_fragments(lcoef, True),
                       _b_fragments(comb.reshape(k, 4 * dp), False)])
    planes = kernels.split_planes3(frags.contiguous())
    t1, t2, cross = _fact_tables(d1, d2, blocks is not None,
                                 ckb.lcoef.device)
    cross_p = cross.new_zeros((dp,))
    cross_p[slot] = cross
    tw = torch.view_as_real(torch.cat([t1, t2, cross_p])).to(torch.float32)
    return CircFactOperands(*(pl.contiguous() for pl in planes),
                            tw.reshape(-1).contiguous(), d1, d2,
                            blocks is not None)


def circ_basis_blocks(ckb: CircKernelBank):
    """The transform basis of a layout, read from bfwd's column of point
    1: None for the DFT, (n1, n2) for kron(F_n1, F_n2); raises for any
    other matrix. Reads 2D values back from the layout's device."""
    d = ckb.bfwd.shape[0] // 2
    row = ckb.bfwd[2].double().cpu()
    col = torch.complex(row[0::2], row[1::2])        # F[:, 1]
    k = torch.arange(d)
    tol = 1e-5 / math.sqrt(d)

    def near(n2):
        want = torch.exp(-2j * math.pi * (k % n2).double() / n2) / math.sqrt(d)
        return float((col - want).abs().max()) <= tol

    if near(d):
        return None
    phase = -float(torch.angle(col[1]))
    if phase > 0:
        n2 = round(2 * math.pi / phase)
        if 1 <= n2 < d and d % n2 == 0 and near(n2):
            return (d // n2, n2)
    raise ValueError("the layout's transform is neither the DFT nor a kron "
                     "basis of two DFTs")


def circ_fact_reference(x2: torch.Tensor, ckb: CircKernelBank,
                        t_coh: int = 1, coh_alpha: float = 1.0, blocks=None,
                        chunk: int = 16384, stats: bool = False):
    """Plain PyTorch version of the factorised kernel (K6 at t_coh = 1, K7
    above; with `stats` K8 / K9) in x2's precision: the factorised
    transform (`circ_fact_transform`), the logit and combine of the
    permuted layout (`circ_fact_bank`) as `circ_estimate_reference`
    computes them, the inverse into natural order. x2 (N, 2D) interleaved
    -> (N, 2D); with `stats` (m (N,), den (N,), acc (N, 2D)), acc the
    un-normalised DFT-domain accumulator taken back to natural bin
    order."""
    d = x2.shape[1] // 2
    d1, d2 = circ_fact_blocks(d, blocks)
    kron = blocks is not None
    out = _circ_reference(
        x2, circ_fact_bank(ckb, blocks), t_coh, coh_alpha, stats, chunk,
        lambda x: _fact_real(x, d1, d2, kron, False),
        lambda h: _fact_real(h, d1, d2, kron, True))
    if not stats:
        return out
    m, den, acc = out
    pos = torch.argsort(circ_fact_perm(d, blocks)).to(acc.device)
    return m, den, acc.reshape(-1, d, 2)[:, pos].reshape(acc.shape)


# ---------------------------------------------------------------------------
# plain versions: the kernels' own arithmetic in float32
# ---------------------------------------------------------------------------

def _circ_logits(x2: torch.Tensor, ckb: CircKernelBank, fwd=None):
    """Forward transform (x2 @ bfwd, or `fwd`) and logits of rows x2 (n,
    2D): u (n, D, 2) and lg (n, K) = [u | |u|^2] @ lcoef + const (the
    expanded quadratic)."""
    u = x2 @ ckb.bfwd if fwd is None else fwd(x2)
    u3 = u.reshape(u.shape[0], -1, 2)
    z = torch.cat([u, (u3 * u3).sum(-1)], dim=-1)
    return u3, z @ ckb.lcoef + ckb.const[None]


def _combine(u3: torch.Tensor, w: torch.Tensor,
             ckb: CircKernelBank) -> torch.Tensor:
    """h = w @ bias + (w @ filt) * u, interleaved (n, 2D)."""
    c = (w @ ckb.comb).reshape(w.shape[0], -1, 4)
    ur, ui = u3[..., 0], u3[..., 1]
    hr = c[..., 0] + c[..., 2] * ur - c[..., 3] * ui
    hi = c[..., 1] + c[..., 2] * ui + c[..., 3] * ur
    return torch.stack([hr, hi], dim=-1).reshape(w.shape[0], -1)


def _circ_reference(x2, ckb, t_coh, coh_alpha, stats, chunk, fwd=None,
                    inv=None):
    """The plain K6-K9 on x2's rows, chunk rows (whole blocks) at a time;
    the transforms by bfwd and binv, or by the functions `fwd` and `inv`
    of interleaved rows."""
    pin_fp32()
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    ms, dens, outs = [], [], []
    for i0 in range(0, x2.shape[0], chunk):
        u3, lg = _circ_logits(x2[i0:i0 + chunk], ckb, fwd)
        lg = _pool(lg, t_coh, coh_alpha)
        m = lg.max(-1).values
        p = torch.exp(lg - m[:, None])
        den = p.sum(-1)
        if stats:
            ms.append(m)
            dens.append(den)
            outs.append(_combine(u3, p, ckb))
        else:
            h = _combine(u3, p / den[:, None], ckb)
            outs.append(h @ ckb.binv if inv is None else inv(h))
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


def circ_tc_reference(x2: torch.Tensor, ckb: CircKernelBank, t_coh: int = 1,
                      coh_alpha: float = 1.0, stats: bool = False,
                      chunk: int = 16384):
    """Plain PyTorch version of the tensor-core arithmetic of K6-K9
    (`mp_circ_kernels.mp_circ_tc_reference` at one pilot): the flat form
    at t_coh = 1, the coherent one above; `stats` returns (m, den, acc) as
    the stats forms do. For the CPU tests; nothing on the main path calls
    it."""
    return mk.mp_circ_tc_reference(x2, circ_mp_bank(ckb), t_coh, coh_alpha,
                                   chunk, stats)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_bank(x2: torch.Tensor, ckb: CircKernelBank) -> None:
    """Raise unless x2 and the bank's layout are float32, contiguous, of
    matching widths and on x2's device."""
    n, two_d = x2.shape
    d, k, dev = two_d // 2, ckb.const.shape[0], x2.device
    kernels._check_cuda("x2", x2, (n, two_d), dev)
    kernels._check_cuda("bfwd", ckb.bfwd, (two_d, two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (3 * d, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (k, 4 * d), dev)
    kernels._check_cuda("binv", ckb.binv, (two_d, two_d), dev)


def _route(d: int, ckb: CircKernelBank, ops, stats: bool, t_coh: int) -> str:
    """`circ_route` for a launch of ckb's K at T = t_coh: past D = 128 the
    factorised kernel's operands name its route; otherwise the basis
    matters only where D splits, and is then read from the layout
    (`circ_basis_blocks`)."""
    if d <= CIRC_MAX_D:
        return "template"
    if isinstance(ops, CircFactOperands):
        return "fact"
    if circ_fact_split(d) is None:
        return "wide"
    return circ_route(d, circ_basis_blocks(ckb), stats, ckb.const.shape[0],
                      t_coh)


def _launch(wrapper, wide, fact, x2: torch.Tensor, ckb: CircKernelBank,
            t_coh: int, coh_alpha: float, stats: bool, ops):
    """Validate, allocate and launch on x2's device and current stream
    with the bank's operands `ops` (laid out here when None): the template
    at one pilot up to D = 128, counted on `wrapper`; past it
    (`_route`) the factorised kernel (`_launch_fact`), counted on `fact`,
    or the wide form (`_launch_wide`), counted on `wide`; raise on any
    refusal. Returns out, or (m, den, out) for stats."""
    n, two_d = x2.shape
    d = two_d // 2
    k = ckb.const.shape[0]
    if (two_d % 2 or k > CIRC_MAX_K or n % t_coh
            or not circ_kernel_eligible(d, k, t_coh)):
        raise ValueError(
            f"{wrapper.__name__} takes N rows of whole T-row blocks with "
            f"D <= {CIRC_WIDE_MAX_D}, K <= {CIRC_MAX_K} and T <= "
            f"{circ_tile_rows(d)}; got N={n}, D={d}, K={k}, T={t_coh}")
    if d > CIRC_MAX_D:
        if _route(d, ckb, ops, stats, t_coh) == "fact":
            return _launch_fact(fact, x2, ckb, t_coh, coh_alpha, stats, ops)
        return _launch_wide(wide, x2, ckb, t_coh, coh_alpha, stats, ops)
    _check_bank(x2, ckb)
    if ops is None:
        ops = circ_tc_operands(ckb, stats)
    tu.check_units(wrapper.__name__, ops, _units(ckb, stats), x2.device,
                   "circ_tc_operands" + (" with stats=True" if stats else ""))
    res = mk.launch_tc(wrapper.__name__, x2, ops, ckb.const, d, 1, t_coh,
                       coh_alpha, stats)
    if n:
        wrapper.launches += 1
    return res


def circ_wide_launch_rows(n: int, d: int, k: int, t_coh: int = 1) -> int:
    """Rows of one launch of the wide form: all n, or as many as keep its
    scratch within `kernels.WIDE_SCRATCH`, a multiple of 128 T (whole
    blocks, whole pairs of 64-row tiles). A row costs its three bf16 planes
    of the widest product's contraction (3D, or K), u (2D), its K logits
    and its offset."""
    per_row = (384 * max(tu.chunks(3 * d), tu.chunks(k)) + 8 * d + 4 * k + 4)
    step = 128 * t_coh
    rows = max(step, kernels.WIDE_SCRATCH // per_row // step * step)
    return min(n, rows)


def _launch_wide(wrapper, x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
                 coh_alpha: float, stats: bool,
                 ops: Optional[tu.UnitOperands]):
    """Launch the wide form (csrc/circ_wide_estimate.cu) on x2's device
    and current stream, one launch of `circ_wide_launch` for each row
    chunk (`circ_wide_launch_rows`), and add one to `wrapper`'s count for
    each: -> out (N, 2D), or with `stats` (m (N,), den (N,), out); raise on
    any refusal. Takes any 1 <= D <= 672 (the wrappers send it D > 128)."""
    name = wrapper.__name__
    n, two_d = x2.shape
    d = two_d // 2
    k = ckb.const.shape[0]
    if (two_d % 2 or not 1 <= d <= CIRC_WIDE_MAX_D or not 1 <= k <= CIRC_MAX_K
            or not 1 <= t_coh <= CIRC_MAX_T or n % t_coh):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with D <= "
            f"{CIRC_WIDE_MAX_D}, K <= {CIRC_MAX_K} and T <= {CIRC_MAX_T}; "
            f"got N={n}, D={d}, K={k}, T={t_coh}")
    _check_bank(x2, ckb)
    dev, f32 = x2.device, torch.float32
    out = torch.empty((n, two_d), dtype=f32, device=dev)
    m = den = None
    if stats:
        m = torch.empty((n,), dtype=f32, device=dev)
        den = torch.empty((n,), dtype=f32, device=dev)
    result = (m, den, out) if stats else out
    if n == 0:
        return result
    if ops is None:
        ops = circ_wide_operands(ckb, stats)
    tu.check_units(name, ops, circ_wide_units(d, k, stats), dev,
                   "circ_wide_operands" + (" with stats=True" if stats
                                           else ""))
    rows = circ_wide_launch_rows(n, d, k, t_coh)
    a = torch.empty((3, kernels.wide_row_tiles(rows),
                     max(tu.chunks(3 * d), tu.chunks(k)), 64, 64),
                    dtype=torch.bfloat16, device=dev)
    u = torch.empty((rows, two_d), dtype=f32, device=dev)
    lg = torch.empty((rows, k), dtype=f32, device=dev)
    offs = torch.empty((rows,), dtype=f32, device=dev)
    lib = kernels._library("circ_wide_estimate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i0 in range(0, n, rows):
            i1 = min(n, i0 + rows)
            err = lib.circ_wide_launch(
                x2[i0:i1].data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                ops.lo2.data_ptr(), ckb.const.data_ptr(),
                out[i0:i1].data_ptr(), m[i0:i1].data_ptr() if stats else None,
                den[i0:i1].data_ptr() if stats else None, a.data_ptr(),
                u.data_ptr(), lg.data_ptr(), offs.data_ptr(), i1 - i0, d, k,
                ops.hi.shape[0], int(t_coh), float(coh_alpha), int(stats),
                stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
            wrapper.launches += 1
    return result


def _launch_fact(wrapper, x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
                 coh_alpha: float, stats: bool,
                 ops: Optional[CircFactOperands]):
    """Launch the factorised kernel (csrc/circ_fact_estimate.cu) on x2's
    device and current stream with the bank's operands `ops` (laid out
    here in the layout's own basis, `circ_basis_blocks`, when None), and
    add one to `wrapper`'s count: -> out (N, 2D), or with `stats` (its
    STATS form, K8 / K9) (m (N,), den (N,), acc (N, 2D) in natural bin
    order); raise on any refusal. Takes D = d1 d2 with 2 <= d1, d2 <= 64
    up to D = 672 (the wrappers send it D > 128), K <= 128 and T <=
    64."""
    name = wrapper.__name__
    n, two_d = x2.shape
    d = two_d // 2
    k = ckb.const.shape[0]
    if (two_d % 2 or not 1 <= d <= CIRC_WIDE_MAX_D or not 1 <= k <= CIRC_MAX_K
            or not 1 <= t_coh <= CIRC_MAX_T or n % t_coh):
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks with D <= "
            f"{CIRC_WIDE_MAX_D}, K <= {CIRC_MAX_K} and T <= {CIRC_MAX_T}; "
            f"got N={n}, D={d}, K={k}, T={t_coh}")
    dev = x2.device
    kernels._check_cuda("x2", x2, (n, two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (3 * d, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (k, 4 * d), dev)
    f32 = torch.float32
    out = torch.empty((n, two_d), dtype=f32, device=dev)
    m = den = None
    if stats:
        m = torch.empty((n,), dtype=f32, device=dev)
        den = torch.empty((n,), dtype=f32, device=dev)
    result = (m, den, out) if stats else out
    if n == 0:
        return result
    if ops is None:
        ops = circ_fact_operands(ckb, circ_basis_blocks(ckb))
    if not isinstance(ops, CircFactOperands):
        raise ValueError(f"{name} takes the factorised kernel's operands "
                         f"(`circ_fact_operands`), got {type(ops).__name__}")
    units = circ_fact_units(ops.d1, ops.d2, k)
    n_tw = 2 * (ops.d1 + ops.d2 + ops.d1 * (ops.d2 | 1))
    for label, t, shape, dtype in (
            ("hi", ops.hi, (units, 4), torch.bfloat16),
            ("lo", ops.lo, (units, 4), torch.bfloat16),
            ("lo2", ops.lo2, (units, 4), torch.bfloat16),
            ("tw", ops.tw, (n_tw,), torch.float32)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: operand {label} must be contiguous {dtype} {shape} "
                f"on {dev} (`circ_fact_operands` at D={d}, K={k}), got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels._library("circ_fact_estimate").circ_fact_launch(
            x2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
            ops.lo2.data_ptr(), ckb.const.data_ptr(), ops.tw.data_ptr(),
            out.data_ptr(), m.data_ptr() if stats else None,
            den.data_ptr() if stats else None, n, d, ops.d1, ops.d2, k, units,
            int(t_coh), float(coh_alpha), int(stats), int(ops.kron), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    return result


def circ_estimate_fact(x2: torch.Tensor, ckb: CircKernelBank,
                       operands: Optional[CircFactOperands] = None
                       ) -> torch.Tensor:
    """K6 on the factorised kernel: x2 (N, 2D) -> (N, 2D), `operands`
    from `circ_fact_operands(ckb, blocks)` (laid out in the call, in the
    layout's own basis, when None); `circ_estimate` launches it past D =
    128 where `circ_route` says 'fact'. On a CUDA tensor it launches the
    CUDA kernel (any D = d1 d2 <= 672 with 2 <= d1, d2 <= 64) and raises on
    any refusal; on a CPU tensor it computes the plain version
    `circ_fact_reference`."""
    if not x2.is_cuda:
        return circ_fact_reference(x2, ckb, 1, 1.0, _blocks_of(ckb,
                                                               operands))
    return _launch_fact(circ_estimate_fact, x2, ckb, 1, 1.0, False, operands)


def circ_estimate_coherent_fact(x2: torch.Tensor, ckb: CircKernelBank,
                                t_coh: int, coh_alpha: float = 1.0,
                                operands: Optional[CircFactOperands] = None
                                ) -> torch.Tensor:
    """K7 on the factorised kernel: `circ_estimate_coherent` (which
    launches it past D = 128 where `circ_route` says 'fact'), 2 <= T <=
    64. On a CPU tensor the plain version `circ_fact_reference`."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent_fact takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return circ_fact_reference(x2, ckb, t_coh, coh_alpha,
                                   _blocks_of(ckb, operands))
    return _launch_fact(circ_estimate_coherent_fact, x2, ckb, t_coh,
                        coh_alpha, False, operands)


def circ_estimate_stats_fact(x2: torch.Tensor, ckb: CircKernelBank,
                             operands: Optional[CircFactOperands] = None):
    """K8 on the factorised kernel (its STATS form): x2 (N, 2D) -> (m
    (N,), den (N,), acc (N, 2D) in the DFT domain, natural bin order),
    `operands` from `circ_fact_operands(ckb, blocks)` (laid out in the
    call, in the layout's own basis, when None); `circ_estimate_stats`
    launches it past D = 128 where `circ_route` says 'fact'. On a CUDA
    tensor it launches the CUDA kernel and raises on any refusal; on a CPU
    tensor it computes the plain version `circ_fact_reference(...,
    stats=True)`."""
    if not x2.is_cuda:
        return circ_fact_reference(x2, ckb, 1, 1.0,
                                   _blocks_of(ckb, operands), stats=True)
    return _launch_fact(circ_estimate_stats_fact, x2, ckb, 1, 1.0, True,
                        operands)


def circ_estimate_coherent_stats_fact(
        x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
        coh_alpha: float = 1.0,
        operands: Optional[CircFactOperands] = None):
    """K9 on the factorised kernel: `circ_estimate_coherent_stats` (which
    launches it past D = 128 where `circ_route` says 'fact'), 2 <= T <=
    64, per-row (m, den) and acc in natural bin order. On a CPU tensor the
    plain version `circ_fact_reference(..., stats=True)`."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent_stats_fact takes T >= 2; "
                         f"got {t_coh}")
    if not x2.is_cuda:
        return circ_fact_reference(x2, ckb, t_coh, coh_alpha,
                                   _blocks_of(ckb, operands), stats=True)
    return _launch_fact(circ_estimate_coherent_stats_fact, x2, ckb, t_coh,
                        coh_alpha, True, operands)


def _blocks_of(ckb: CircKernelBank, ops: Optional[CircFactOperands]):
    """The basis of the factorised route: the operands' own, else the
    layout's (`circ_basis_blocks`)."""
    if not isinstance(ops, CircFactOperands):
        return circ_basis_blocks(ckb)
    return (ops.d1, ops.d2) if ops.kron else None


def _plain(x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
           coh_alpha: float, stats: bool, ops):
    """The public wrappers on a CPU tensor: the plain version of the kernel
    they launch on a card (`_route`), the factorised kernel's
    (`circ_fact_reference`, in the layout's basis) where it takes the
    transform, else the dense one (`_circ_reference`)."""
    d = x2.shape[1] // 2
    if _route(d, ckb, ops, stats, t_coh) == "fact":
        return circ_fact_reference(x2, ckb, t_coh, coh_alpha,
                                   _blocks_of(ckb, ops), stats=stats)
    return _circ_reference(x2, ckb, t_coh, coh_alpha, stats, 16384)


def circ_estimate(x2: torch.Tensor, ckb: CircKernelBank,
                  operands: Optional[tu.UnitOperands] = None
                  ) -> torch.Tensor:
    """K6 on x2 (N, 2D) float32 interleaved -> (N, 2D). On a CUDA tensor it
    launches the CUDA kernel on the current stream (past D = 128 the
    factorised kernel, `circ_estimate_fact`, where `circ_route` says
    'fact', else the wide form, `circ_estimate_wide`) with the bank's
    `operands` (`circ_operands(ckb)`, laid out in the call when None) and
    raises on any refusal; on a CPU tensor it computes the plain version
    of that kernel."""
    if not x2.is_cuda:
        return _plain(x2, ckb, 1, 1.0, False, operands)
    return _launch(circ_estimate, circ_estimate_wide, circ_estimate_fact, x2,
                   ckb, 1, 1.0, False, operands)


def circ_estimate_coherent(x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
                           coh_alpha: float = 1.0,
                           operands: Optional[tu.UnitOperands] = None
                           ) -> torch.Tensor:
    """K7 on x2 (N, 2D), N / T blocks of T consecutive rows (2 <= T <=
    `circ_tile_rows`), ckb from `circ_kernel_bank(bank, blocks, t_coh,
    coh_alpha)`, `operands` as for `circ_estimate` (any layout of the
    bank). CUDA kernel on a CUDA tensor (past D = 128
    `circ_estimate_coherent_wide`), plain version on the CPU."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent takes T >= 2; got {t_coh}")
    if not x2.is_cuda:
        return _plain(x2, ckb, t_coh, coh_alpha, False, operands)
    return _launch(circ_estimate_coherent, circ_estimate_coherent_wide,
                   circ_estimate_coherent_fact, x2, ckb, t_coh, coh_alpha,
                   False, operands)


def circ_estimate_stats(x2: torch.Tensor, ckb: CircKernelBank,
                        operands: Optional[tu.UnitOperands] = None):
    """K8 on x2 (N, 2D) -> (m (N,), den (N,), acc (N, 2D) in the DFT
    domain), `operands` from `circ_operands(ckb, stats=True)` (laid out
    in the call when None). CUDA kernel on a CUDA tensor (past D = 128
    `circ_estimate_stats_fact` where `circ_route` says 'fact', else
    `circ_estimate_stats_wide`), plain version on the CPU."""
    if not x2.is_cuda:
        return _plain(x2, ckb, 1, 1.0, True, operands)
    return _launch(circ_estimate_stats, circ_estimate_stats_wide,
                   circ_estimate_stats_fact, x2, ckb, 1, 1.0, True, operands)


def circ_estimate_coherent_stats(x2: torch.Tensor, ckb: CircKernelBank,
                                 t_coh: int, coh_alpha: float = 1.0,
                                 operands: Optional[tu.UnitOperands] = None):
    """K9 on x2 (N, 2D) of T-row blocks -> per-row (m (N,), den (N,)) and
    acc (N, 2D) in the DFT domain, `operands` as for
    `circ_estimate_stats`. CUDA kernel on a CUDA tensor (past D = 128
    `circ_estimate_coherent_stats_fact` where `circ_route` says 'fact',
    else `circ_estimate_coherent_stats_wide`), plain version on the
    CPU."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent_stats takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return _plain(x2, ckb, t_coh, coh_alpha, True, operands)
    return _launch(circ_estimate_coherent_stats,
                   circ_estimate_coherent_stats_wide,
                   circ_estimate_coherent_stats_fact, x2, ckb, t_coh,
                   coh_alpha, True, operands)


def circ_estimate_wide(x2: torch.Tensor, ckb: CircKernelBank,
                       operands: Optional[tu.UnitOperands] = None
                       ) -> torch.Tensor:
    """K6's wide form on x2 (N, 2D) -> (N, 2D), `operands` from
    `circ_wide_operands(ckb)` (laid out in the call when None);
    `circ_estimate` launches it past D = 128. On a CUDA tensor it launches
    the CUDA kernels (any D <= 672) and raises on any refusal; on a CPU
    tensor it computes the plain version."""
    if not x2.is_cuda:
        return circ_estimate_reference(x2, ckb)
    return _launch_wide(circ_estimate_wide, x2, ckb, 1, 1.0, False, operands)


def circ_estimate_coherent_wide(x2: torch.Tensor, ckb: CircKernelBank,
                                t_coh: int, coh_alpha: float = 1.0,
                                operands: Optional[tu.UnitOperands] = None
                                ) -> torch.Tensor:
    """K7's wide form: `circ_estimate_coherent` (which launches it past D
    = 128) at any D <= 672, 2 <= T <= 64. On a CPU tensor the plain
    version."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent_wide takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return circ_estimate_coherent_reference(x2, ckb, t_coh, coh_alpha)
    return _launch_wide(circ_estimate_coherent_wide, x2, ckb, t_coh,
                        coh_alpha, False, operands)


def circ_estimate_stats_wide(x2: torch.Tensor, ckb: CircKernelBank,
                             operands: Optional[tu.UnitOperands] = None):
    """K8's wide form: `circ_estimate_stats` (which launches it past D =
    128 where the transform does not split) at any D <= 672 -> (m (N,),
    den (N,), acc (N, 2D)), `operands`
    from `circ_wide_operands(ckb, stats=True)`. On a CPU tensor the plain
    version."""
    if not x2.is_cuda:
        return circ_estimate_stats_reference(x2, ckb)
    return _launch_wide(circ_estimate_stats_wide, x2, ckb, 1, 1.0, True,
                        operands)


def circ_estimate_coherent_stats_wide(
        x2: torch.Tensor, ckb: CircKernelBank, t_coh: int,
        coh_alpha: float = 1.0,
        operands: Optional[tu.UnitOperands] = None):
    """K9's wide form: `circ_estimate_coherent_stats` (which launches it
    past D = 128 where the transform does not split) at any D <= 672, 2 <=
    T <= 64. On a CPU tensor the plain version."""
    if t_coh < 2:
        raise ValueError(f"circ_estimate_coherent_stats_wide takes T >= 2; "
                         f"got {t_coh}")
    if not x2.is_cuda:
        return circ_estimate_coherent_stats_reference(x2, ckb, t_coh,
                                                      coh_alpha)
    return _launch_wide(circ_estimate_coherent_stats_wide, x2, ckb, t_coh,
                        coh_alpha, True, operands)


kernels.register_wrappers(circ_estimate, circ_estimate_coherent,
                          circ_estimate_stats, circ_estimate_coherent_stats,
                          circ_estimate_wide, circ_estimate_coherent_wide,
                          circ_estimate_stats_wide,
                          circ_estimate_coherent_stats_wide,
                          circ_estimate_fact, circ_estimate_coherent_fact,
                          circ_estimate_stats_fact,
                          circ_estimate_coherent_stats_fact)


# ---------------------------------------------------------------------------
# entries on complex observations and circulant banks
# ---------------------------------------------------------------------------

def _ops(bank, r, cache, blocks, stats, n_shards, t_coh=1):
    """The shards' operands for a launch on r's device (`lowered_tc`), or
    Nones on the CPU, where the wrappers take their plain versions."""
    if r.is_cuda:
        return lowered_tc(bank, cache, blocks, stats, t_coh)
    return (None,) * n_shards


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
    `lowered` and `lowered_tc`."""
    ckbs = lowered(bank, cache, blocks)
    x2 = _x2(r)
    ops = _ops(bank, r, cache, blocks, len(ckbs) > 1, len(ckbs))
    if len(ckbs) == 1:
        return _hc(circ_estimate(x2, ckbs[0], ops[0]), r.dtype)
    return _merged([circ_estimate_stats(x2, c, o)
                    for c, o in zip(ckbs, ops)], blocks, r.dtype)


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
    `torch.fft` coherent path). `cache`: see `lowered` and `lowered_tc`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, d = r.shape
    if t == 1:
        return estimate_fused_circulant(bank, r[:, 0, :], blocks,
                                        cache)[:, None, :]
    if not circ_kernel_eligible(d, bank.spec_cr.shape[0], t):
        raise ValueError(
            f"the coherent circulant kernels take D <= {CIRC_WIDE_MAX_D} "
            f"and T <= {circ_tile_rows(d)}; got D={d}, T={t}")
    ckbs = lowered(bank, cache, blocks, t, alpha)
    x2 = _x2(r)
    ops = _ops(bank, r, cache, blocks, len(ckbs) > 1, len(ckbs), t)
    if len(ckbs) == 1:
        h = _hc(circ_estimate_coherent(x2, ckbs[0], t, alpha, ops[0]),
                r.dtype)
    else:
        h = _merged([circ_estimate_coherent_stats(x2, c, t, alpha, o)
                     for c, o in zip(ckbs, ops)], blocks, r.dtype)
    return h.reshape(b, t, d)


def estimate_fused_circulant_stats(bank: CirculantBank, r: torch.Tensor,
                                   blocks=None, cache: Optional[dict] = None):
    """Kernel analog of `structured_bank.estimate_circulant_stats` through
    K8: (m (N,), den (N,), acc (N, D) complex64 in the DFT domain) of a
    (component shard of a) bank, `blocks` selecting the kron basis of a
    block-circulant one; a bank past one launch's 128 components runs K8
    on each 128-component part and merges the states. Merge kernel states
    with kernel states (`merge_stats`): their logits drop the row constant
    -D log pi. `cache`: see `lowered` and `lowered_tc`."""
    x2 = _x2(r)
    ckbs = lowered(bank, cache, blocks)
    ops = _ops(bank, r, cache, blocks, True, len(ckbs))
    m, den, acc2 = merge_stats(*zip(*[circ_estimate_stats(x2, c, o)
                                      for c, o in zip(ckbs, ops)]))
    return m, den, _hc(acc2, torch.complex64)


def estimate_fused_circulant_coherent_stats(bank: CirculantBank,
                                            r: torch.Tensor,
                                            alpha: float = 1.0, blocks=None,
                                            cache: Optional[dict] = None):
    """Kernel analog of
    `structured_bank.estimate_circulant_coherent_stats` through K9:
    per-block state (m (B,), den (B,)) at alpha >= 1, per-snapshot ((B, T))
    below, acc (B, T, D) complex64 in the DFT domain. `cache`: see
    `lowered` and `lowered_tc`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    b, t, d = r.shape
    x2 = _x2(r)
    ckbs = lowered(bank, cache, blocks, t, alpha)
    ops = _ops(bank, r, cache, blocks, True, len(ckbs), t)
    if t == 1:
        states = [circ_estimate_stats(x2, c, o) for c, o in zip(ckbs, ops)]
    else:
        states = [circ_estimate_coherent_stats(x2, c, t, alpha, o)
                  for c, o in zip(ckbs, ops)]
    m, den, acc2 = merge_stats(*zip(*states))
    acc = _hc(acc2, torch.complex64).reshape(b, t, d)
    m, den = m.reshape(b, t), den.reshape(b, t)
    if alpha >= 1.0:
        return m[:, 0], den[:, 0], acc
    return m, den, acc
