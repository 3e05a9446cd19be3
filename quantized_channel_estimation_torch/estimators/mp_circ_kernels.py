"""The hand-written multi-pilot circulant estimation kernel K10 (flat and
coherent) and its plain versions.

Port of the multi-pilot section of
`quantized_channel_estimation_tpu/estimators/pallas_kernels.py`:
`MpCircKernelBank`, `mp_circ_kernel_bank` (with `blocks`), and the entries
`estimate_fused_circulant_mp` and `estimate_fused_circulant_mp_coherent`.
Both forms are one CUDA C++ template with COH and STATS flags in
`csrc/mp_circ_estimate.cu`, built and bound by `estimators.kernels` (nvcc,
ctypes, launch counts); at one pilot the same template is the circulant
kernels K6-K9 of `circ_kernels` (`launch_tc` launches either). The kernel
runs its four products (forward transform, logit, combine, inverse
transform) on Hopper's tensor cores as six exact bf16 products of
three-plane splits (`kernels.split_planes3`), accumulated in fp32: the
bank's operands are laid out once as the units the kernel streams
(`mp_circ_tc_operands`, cached beside the bank by `lowered_tc`), and
`mp_circ_tc_reference` is the plain version of that arithmetic.

Differences of layout from the TPU kernel, none of arithmetic:

- the observation rows are a complex64 tensor's interleaved [re, im]
  pairs, pilot-major: segment p of a row is the left operand of the one
  (2D, 2D) forward operand. The TPU kernel takes a
  [Re r_1..Re r_P | Im r_1..Im r_P] split copy and P mostly-zero (2PD, D)
  operands, a work-around for its lane slicing;
- the features of the logit product are ordered [u | |u_p|^2 | pairs] (see
  `MpCircKernelBank`), the u part being the transformed row itself; the
  CUDA kernel forms them a 64-deep chunk at a time in registers, and takes
  the rows of each |u_p|^2 group in the order of its threads' own bins
  (`mp_circ_tc_operands`);
- the combine operands are (P + 1) interleaved (K, 2D) slabs;
- coherence blocks are block-major (the T rows of a block consecutive);
- the eligibility rule `mp_circ_kernel_eligible` is the CUDA kernels'
  range in place of the TPU's resident-bank budget: the template takes D,
  K <= 128, T up to a warpgroup's live rows and a warpgroup's u within a
  block's shared memory beside the operand ring (which bounds P); every
  other shape up to D = 672, any K, any P whose rows fit the scratch and T
  <= 64 takes the wide form (below). Beyond the rule the entries raise and
  `harness.stages` takes the `torch.fft` pipeline.

Past the template's rule the entries launch the kernel's wide form,
`csrc/circ_wide_estimate.cu` (`mp_circ_wide_launch`, counted apart:
`mp_circ_estimate_wide`, `mp_circ_estimate_coherent_wide`), the wide
circulant kernels' passes at P pilots: the forward product over the N P
pilot rows of 2D, the features a 64-deep chunk at a time, the logit product
over K in column slices, the softmax, the P + 1 combine slabs of one
64-column slice in one block, the inverse product; the intermediates in
global scratch, rows cut into launches within `kernels.WIDE_SCRATCH`.
`mp_circ_wide_operands` lays a `MpCircKernelBank` out as its units (cached
by `lowered_tc`), and `mp_circ_wide_reference` is the plain version of its
arithmetic.

Past the template's rule, wherever the transform splits into two levels
of at most 64 points (`circ_kernels.circ_fact_blocks`), the tile's buffers
fit a block's shared memory and the kernel was measured faster than the
wide form (`mp_circ_fact_eligible`: K <= 64, 3K <= D, few dense odd-prime
stages), the entries launch the factorised kernel instead,
`csrc/mp_circ_fact_estimate.cu` (`mp_circ_fact_launch`, counted apart:
`mp_circ_estimate_fact`, `mp_circ_estimate_coherent_fact`): one launch a
tile of 16 or 32 rows, the P forward transforms and the inverse as K6's
Stockham stages in shared memory (`csrc/circ_fact_common.cuh`), the bins
left in a permuted order (`circ_kernels.circ_fact_perm`), the features
formed a k16 step at a time from the P transforms on chip, the logit and
the combine on the tensor cores, nothing in global memory between.
`mp_circ_route` is the one rule of the shapes that picks among the three;
`mp_circ_fact_operands` lays a `MpCircKernelBank` out for the factorised
kernel (cached by `lowered_tc(..., fact=True)`), and
`mp_circ_fact_reference` is its plain version.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import tc_units as tu
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBankMP)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import profiling

CIRC_MAX_D = 128   # bins of the circulant kernels
CIRC_MAX_K = 128   # components of one launch of the circulant kernels
WIDE_MAX_D = 672   # bins of the wide form: 2D = 1344, 21 chunks of 64
WIDE_MAX_T = 64    # rows of a coherence block the wide form pools
SMEM_BLOCK_BYTES = 232_448   # shared memory one block can use on sm_90
UNIT_BYTES = 3 * 64 * 64 * 2  # a unit: 64 columns x 64 deep, three planes


def _cplx_interleaved(b: torch.Tensor) -> torch.Tensor:
    """(..., D, P) complex -> (..., 2D, 2P) real with [x_re, x_im] rows
    interleaved @ it = [Re(x b), Im(x b)] interleaved: the 2x2 block
    [[re, im], [-im, re]] of every entry."""
    d, p = b.shape[-2:]
    top = torch.stack([b.real, b.imag], dim=-1)        # rows 2d
    bot = torch.stack([-b.imag, b.real], dim=-1)       # rows 2d + 1
    return torch.stack([top, bot], dim=-3).reshape(b.shape[:-2]
                                                   + (2 * d, 2 * p))


def _x2(r: torch.Tensor) -> torch.Tensor:
    """Complex observations (..., D) -> float32 rows of interleaved
    [re, im] pairs (n, 2D): a view of a contiguous complex64 tensor."""
    x = torch.view_as_real(r.to(torch.complex64).contiguous())
    return x.reshape(-1, 2 * r.shape[-1])


def _hc(h2: torch.Tensor, dtype) -> torch.Tensor:
    """float32 interleaved rows (n, 2D) -> complex (n, D) of `dtype`."""
    return torch.view_as_complex(h2.reshape(h2.shape[0], -1, 2)).to(dtype)


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


def _pieces(w: int) -> int:
    """64-column pieces (or 64-deep chunks) the kernel gives w columns: 1,
    2 or 4."""
    return 1 if w <= 64 else 2 if w <= 128 else 4


def mp_circ_units(d: int, k: int, p: int, stats: bool = False) -> int:
    """Units (64 columns x 64 deep) of the bank a tile streams: the forward
    operand once a pilot, the logit's feature groups for each 64-column
    piece of K, the P + 1 combine slabs and, except for the stats form, the
    inverse operand (`mp_circ_estimate_launch` in
    csrc/mp_circ_estimate.cu)."""
    npd, kp = _pieces(2 * d), _pieces(k)
    ncd = (npd + 1) // 2
    pairs = p * (p - 1) // 2
    return (p * npd * npd + kp * (p * npd + p * ncd + pairs * npd)
            + npd * (p + 1) * kp + (0 if stats else npd * npd))


def mp_circ_smem_bytes(d: int, k: int, p: int, t: int = 1, wgs: int = 1,
                       half: bool = False) -> int:
    """Shared memory of one block of K10 with the least ring it runs with
    (`mp_smem` in csrc/mp_circ_estimate.cu): the 1024-byte alignment, two
    ring stages of one unit and two barriers, each of `wgs` warpgroups' u (a
    live thread's float4 slots for each pilot, 64-column piece of 2D and
    column group below 2D; 128 live threads, or 64 with `half`) and, for
    the coherent form (t > 1), its pool rows (64 or 32 rows of 64 or 128
    logits and 8 floats of padding), else with two pieces of K its stash
    of the first piece's logits (8 float4 slots a live thread)."""
    npd, kp = _pieces(2 * d), _pieces(k)
    tl = 8 if 2 * d >= 64 else (2 * d + 7) // 8
    live, rows = (64, 32) if half else (128, 64)
    pool = (rows * (64 * kp + 8) * 4 if t > 1
            else live * 128 if kp > 1 else 0)
    return (1024 + 2 * (UNIT_BYTES + 16)
            + wgs * (p * npd * tl * live * 16 + pool))


def mp_circ_tile_rows(d: int, k: int, p: int, t: int = 1) -> int:
    """Live rows of one warpgroup of K10 at these widths (`mp_plan` in
    csrc/mp_circ_estimate.cu): 64 where its u and a ring of two units fit a
    block's shared memory, else 32 (`half`), 0 where neither fits. The
    largest coherence block the kernel pools."""
    for rows, half in ((64, False), (32, True)):
        if mp_circ_smem_bytes(d, k, p, t, 1, half) <= SMEM_BLOCK_BYTES:
            return rows
    return 0


def mp_circ_narrow(d: int, k: int, p: int, t: int = 1) -> bool:
    """Does the template (csrc/mp_circ_estimate.cu) take these widths? D,
    K <= 128, P >= 1, and T within the live rows of a warpgroup where one
    warpgroup's u fits a block's shared memory beside a ring of two units
    (every P <= 4 at any D and K, with T <= 64 at D <= 64; P <= 11 at D = K
    = 64 and P <= 5 at D = K = 128, with T <= 32)."""
    return (1 <= d <= CIRC_MAX_D and 1 <= k <= CIRC_MAX_K and p >= 1
            and 1 <= t <= mp_circ_tile_rows(d, k, p, t))


def mp_circ_wide_row_bytes(d: int, k: int, p: int) -> int:
    """Scratch bytes of one row in the wide form: the three bf16 planes of
    its widest product's contraction (the P pilot rows of 2D, the F =
    D (3P + P (P-1)) features, or K), u (P 2D), its K logits and its
    offset."""
    feat = d * (3 * p + p * (p - 1))
    return (384 * max(p * tu.chunks(2 * d), tu.chunks(feat), tu.chunks(k))
            + 8 * p * d + 4 * k + 4)


def mp_circ_wide_eligible(d: int, k: int, p: int, t: int = 1) -> bool:
    """Does the wide form (csrc/circ_wide_estimate.cu) take these widths?
    D <= 672 (`WIDE_MAX_D`), any K and P >= 1 whose 128 T rows (the least
    launch: whole blocks, whole pairs of 64-row tiles) keep their scratch
    within `kernels.WIDE_SCRATCH` (at D = 1 every P <= 1180 at T = 1 and
    <= 293 at T = 16; at D = 357 P <= 60 and 14), T <= 64."""
    return (1 <= d <= WIDE_MAX_D and k >= 1 and p >= 1
            and 1 <= t <= WIDE_MAX_T
            and 128 * t * mp_circ_wide_row_bytes(d, k, p)
            <= kernels.WIDE_SCRATCH)


def mp_circ_kernel_eligible(d: int, k: int, p: int, t: int = 1) -> bool:
    """Can K10 serve a multi-pilot bank of K components over D bins and P
    pilots, pooling T-snapshot blocks? The template where it takes the
    widths (`mp_circ_narrow`), else the wide form (`mp_circ_wide_eligible`:
    D <= 672, any K, T <= 64, P while 128 T rows fit the scratch). A
    superset of the JAX package's Pallas rule (`_mp_circ_kernel_eligible`,
    with T <= 16 for the coherent form): D <= 357, K <= 8090, P <= 202
    there. A rule of the shapes, decided before any launch."""
    return mp_circ_narrow(d, k, p, t) or mp_circ_wide_eligible(d, k, p, t)


MP_FACT_MAX_P = 16    # pilots of the factorised kernel
FACT_THREADS = 512    # threads of one block of the factorised kernel


def mp_circ_fact_steps(p: int) -> list:
    """The k16 steps of one 8-slot block of the factorised kernel's logit,
    in its order (`mp_circ_fact_estimate.cu`): ('u', a, a) for each pilot,
    ('v', a, b) for each pair a < b in row-major order, ('sq', 2i, 2i + 1)
    for the |u|^2 features two pilots a step (pilot 2i + 1 = P: none)."""
    return ([("u", a, a) for a in range(p)]
            + [("v", a, b) for a in range(p) for b in range(a + 1, p)]
            + [("sq", a, a + 1) for a in range(0, p, 2)])


def mp_circ_fact_row_stride(dp: int) -> int:
    """float2 from one row of the kernel's u regions to the next: whole
    8-slot blocks, plus 4 (4 mod 16: the four rows a half-warp reads at one
    slot on distinct banks)."""
    return 8 * -(-dp // 8) + 4


def mp_circ_fact_smem(d1: int, d2: int, p: int, k: int, t: int,
                      mt: int) -> int:
    """Shared memory of one block of the factorised K10 with MT mma row
    tiles (R = 16 MT rows a sub-tile; `smem_bytes` in
    csrc/mp_circ_fact_estimate.cu): P regions of R rows of u, a scratch
    (the larger of a region, the logit's partial sums of its warps and the
    weights' planes), the logits of a tile's rows, the twiddles and the
    step table."""
    dp, kpad, ntk = d1 * (d2 | 1), -(-k // 8) * 8, -(-k // 8)
    ksplit = FACT_THREADS // 32 // -(-ntk // (4 if mt == 1 else 2))
    r = 16 * mt
    region = r * mp_circ_fact_row_stride(dp)
    region += region % 2
    scratch = max(region, ksplit * r * kpad, 3 * mt * -(-k // 16) * 32 * 2)
    scratch += scratch % 2
    rows_cta = r // t * t if t <= r else t
    return (8 * (p * region + scratch) + 4 * rows_cta * kpad
            + 8 * (d1 + d2 + dp) + 4 * len(mp_circ_fact_steps(p)))


def mp_circ_fact_plan(d1: int, d2: int, p: int, k: int, t: int = 1):
    """The factorised kernel's tile at these widths (`mp_circ_fact_plan` in
    csrc/mp_circ_fact_estimate.cu): (MT, shared-memory bytes), MT = 2 (32
    rows) where its buffers fit a block's shared memory, else 1 (16 rows);
    None where neither fits or the widths are past the kernel's range."""
    if not (2 <= d1 <= 64 and 2 <= d2 <= 64 and d1 * d2 <= WIDE_MAX_D
            and 1 <= p <= MP_FACT_MAX_P and 1 <= k <= CIRC_MAX_K
            and 1 <= t <= WIDE_MAX_T):
        return None
    for mt in (2, 1):
        smem = mp_circ_fact_smem(d1, d2, p, k, t, mt)
        if smem <= SMEM_BLOCK_BYTES:
            return mt, smem
    return None


def _odd_points(n: int) -> int:
    """The points of the dense odd-prime stages of an n-point level, as the
    kernel splits it (`radices` in csrc/circ_fact_common.cuh: 4s, a 2,
    then odd primes): their sum, each a dense DFT of that many points an
    output."""
    while n % 4 == 0:
        n //= 4
    if n % 2 == 0:
        n //= 2
    total, f = 0, 3
    while f * f <= n:
        while n % f == 0:
            total, n = total + f, n // f
        f += 2
    return total + (n if n > 1 else 0)


def mp_circ_fact_eligible(d: int, k: int, p: int, t: int = 1,
                          blocks=None) -> bool:
    """Does the route send these widths to the factorised kernel
    (csrc/mp_circ_fact_estimate.cu)? Past the template's rule
    (`mp_circ_narrow` false), within the wide form's (so that the three
    routes together take exactly `mp_circ_kernel_eligible`), a transform
    that splits into two levels of at most 64 points
    (`circ_kernels.circ_fact_blocks` in the basis `blocks`), T <= 64 and a
    tile whose buffers fit (`mp_circ_fact_plan`: P <= 4 at D = 256, K =
    32; P <= 3 at D = 357); and only where the kernel was measured faster
    than the dense wide form (`tools/circ_fact_bench.py reach`, PERF.md
    §6): K <= 64 and 3 K <= D (past them the products outweigh the
    dense transforms the kernel saves), dense odd-prime stages of at most
    D / 10 points an output in all (`_odd_points`: each output of such a
    stage reads all its r points; 357 = 17 x 21 passes, 129 = 3 x 43 does
    not), and a block of T rows past the tile's (two sweeps, the P
    transforms recomputed) only without odd-prime stages."""
    from quantized_channel_estimation_torch.estimators import circ_kernels
    if mp_circ_narrow(d, k, p, t) or not mp_circ_wide_eligible(d, k, p, t):
        return False
    levels = circ_kernels.circ_fact_blocks(d, blocks)
    plan = (None if levels is None or t > WIDE_MAX_T
            else mp_circ_fact_plan(*levels, p, k, t))
    if plan is None:
        return False
    odd = _odd_points(levels[0]) + _odd_points(levels[1])
    return (k <= 64 and 3 * k <= d and 10 * odd <= d
            and (t <= 16 * plan[0] or odd == 0))


def mp_circ_route(d: int, k: int, p: int, t: int = 1, blocks=None) -> str:
    """Which kernel serves K10 at these widths (in the basis `blocks`):
    'template' (`csrc/mp_circ_estimate.cu`, `mp_circ_narrow`), 'fact' (the
    factorised kernel, `mp_circ_fact_eligible`) or 'wide' (the dense wide
    form, `csrc/circ_wide_estimate.cu`); a rule of the shapes, decided
    before any launch. Raises outside `mp_circ_kernel_eligible`."""
    if not mp_circ_kernel_eligible(d, k, p, t):
        raise ValueError(_rule(d, k, p, t))
    if mp_circ_narrow(d, k, p, t):
        return "template"
    return "fact" if mp_circ_fact_eligible(d, k, p, t, blocks) else "wide"


def mp_circ_bound(n: int, d: int, k: int, p: int, t_coh: int = 1) -> dict:
    """The least time an H100 could take for K10's function on n rows of P
    pilots, a K-component bank at D bins (`profiling.bound_ms`: operations
    at the card's peaks against bytes at its memory rate):

    - the P forward transforms and the inverse as FFTs, 5 D log2 D fp32
      operations a row each;
    - the logit and combine products as the kernel's six bf16 products of
      2 n (F K + (P + 1) K 2D), F = D (3P + P (P-1)), on the tensor cores;
    - the epilogue, n (11 P D + 3 P (P-1) D + 5 K) fp32 operations (|u_p|^2,
      the pair features, the combine per bin and pilot, the softmax), and
      3 n K more for the coherent pooling;
    - the rows (n, 2PD) read once, the output (n, 2D) written once, and the
      bank's logit and combine operands read once.

    Returns {"bound_ms", "bound_by", "fp32_flops", "tc_flops", "bytes"}
    and "bound_dft_ms": the same with the transforms counted as the
    kernels compute them, dense (2D, 2D) products of six bf16 products
    (P + 1 of them a row), and their operand read once (the bound of the
    kernels' algorithm, not of the function)."""
    two_d = 2 * d
    feat = d * (3 * p + p * (p - 1))
    fft = (p + 1) * 5.0 * d * math.log2(max(d, 2)) * n
    epi = n * (11.0 * p * d + 3.0 * p * (p - 1) * d + 5.0 * k
               + (3.0 * k if t_coh > 1 else 0.0))
    tc = 6.0 * 2 * n * (feat * k + (p + 1) * k * two_d)
    nbytes = 4.0 * (n * (p + 1) * two_d + feat * k + k + (p + 1) * k * two_d)
    ms, by = profiling.bound_ms(fft + epi, tc, nbytes)
    dft_ms, _ = profiling.bound_ms(
        epi, tc + 6.0 * 2 * n * (p + 1) * two_d * two_d,
        nbytes + 4.0 * 2 * two_d * two_d)
    return {"bound_ms": ms, "bound_by": by, "fp32_flops": fft + epi,
            "tc_flops": tc, "bytes": nbytes, "bound_dft_ms": dft_ms}


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
    so that it enters once per block. Past D = 128 the transform is built in
    complex128 and rounded once, as `circ_kernels.circ_kernel_bank` builds
    it (a complex64 construction errs by ~9e-6 an entry at D = 512); up to
    D = 128 it is the JAX package's complex64 construction, which the
    parity tests hold the layout to."""
    pin_fp32()
    k, d, p = bank.mean_rf.shape
    f = sb._dft_matrix(d, blocks, torch.complex128 if d > CIRC_MAX_D
                       else bank.mean_rf.dtype, bank.mean_rf.device)
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
# the tensor-core layout of the bank
# ---------------------------------------------------------------------------

def _sq_order(d: int) -> torch.Tensor:
    """The bin behind each row of a |u_p|^2 group's 64-deep chunks as the
    kernel forms them (-1: a zero row): row 64 c + kappa of chunk c, kappa =
    16 s + 8 e + 2 q + h (k16 step s, register pair e, lane % 4 = q, half
    h), is A slot i = 4 s + 2 e + h of the threads of lane % 4 = q, which
    hold bin 64 c + 32 (i // 8) + 4 (i % 8) + q of u_p (their own column
    pair 8 (i % 8) + 2 q of piece 2 c + i // 8)."""
    kappa = torch.arange(64)
    s, e = kappa // 16, (kappa // 8) % 2
    q, h = (kappa % 8) // 2, kappa % 2
    i = 4 * s + 2 * e + h
    bins = torch.cat([64 * c + 32 * (i // 8) + 4 * (i % 8) + q
                      for c in range((_pieces(2 * d) + 1) // 2)])
    return torch.where(bins < d, bins, -1)


def mp_circ_tc_units(ckb: MpCircKernelBank,
                     stats: bool = False) -> torch.Tensor:
    """The bank's four operands in float32 as the units of one tile, in the
    kernel's order (`mp_circ_units` of them, (units, 64, 64)): the forward
    operand's units (c, j) for each pilot; for each 64-column piece of K
    the logit operand's rows of the u_p groups (pieces of 2D), the |u_p|^2
    groups (`_sq_order`) and the pair groups; for each piece j of 2D the
    units of the P + 1 combine slabs over the chunks of K; the inverse
    operand's units (j, jo) for each output piece jo, except for the stats
    form (`stats`), which streams no inverse."""
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    npd, kp = _pieces(two_d), _pieces(k)
    w2, wk = 64 * npd, 64 * kp
    fwd = tu.blocks(ckb.bfwd, w2, w2)
    units = [fwd[c, j] for _ in range(p) for c in range(npd)
             for j in range(npd)]
    lc = ckb.lcoef
    order = _sq_order(d).to(lc.device)
    groups = [tu.blocks(lc[2 * pi * d:2 * (pi + 1) * d], w2, wk)
              for pi in range(p)]
    sq0 = 2 * p * d
    for pi in range(p):
        rows = lc[sq0 + pi * d + order.clamp(min=0)]
        rows = torch.where(order[:, None] >= 0, rows, torch.zeros_like(rows))
        groups.append(tu.blocks(rows, order.numel(), wk))
    v0 = 3 * p * d
    groups += [tu.blocks(lc[v0 + i * two_d:v0 + (i + 1) * two_d], w2, wk)
               for i in range(p * (p - 1) // 2)]
    units += [g[c, kc] for kc in range(kp) for g in groups
              for c in range(g.shape[0])]
    comb = [tu.blocks(ckb.comb[si], wk, w2) for si in range(p + 1)]
    units += [comb[si][kc, j] for j in range(npd) for si in range(p + 1)
              for kc in range(kp)]
    if not stats:
        inv = tu.blocks(ckb.binv, w2, w2)
        units += [inv[j, jo] for jo in range(npd) for j in range(npd)]
    return torch.stack(units)


def mp_circ_tc_operands(ckb: MpCircKernelBank,
                        stats: bool = False) -> tu.UnitOperands:
    """Split the bank's operands into bf16 hi / lo / lo2 and lay them out
    as the kernel's units (`tc_units.UnitOperands`; the stats form's
    without the inverse); once per bank (`lowered_tc` keeps them)."""
    return tu.UnitOperands(*(kernels._sw128(pl).contiguous()
                             for pl in kernels.split_planes3(
                                 mp_circ_tc_units(ckb, stats).contiguous())))


def check_mp_circ_tc_operands(kernel: str, ops: tu.UnitOperands,
                              ckb: MpCircKernelBank, device) -> None:
    """Raise unless ops holds the units of a bank of ckb's shape on
    `device` (`mp_circ_tc_operands`)."""
    two_d = ckb.bfwd.shape[0]
    tu.check_units(kernel, ops, mp_circ_units(two_d // 2, ckb.const.shape[0],
                                           ckb.comb.shape[0] - 1), device,
                "mp_circ_tc_operands")


def lowered_tc(bank: CirculantBankMP, cache: Optional[dict] = None,
               blocks=None, wide: bool = False, fact: bool = False):
    """The kernel's operands of the bank (`mp_circ_tc_operands` of its
    T = 1 layout; with `wide`, the wide form's `mp_circ_wide_operands`;
    with `fact`, the factorised kernel's `mp_circ_fact_operands` in the
    basis `blocks`), kept in `cache` under ("mp_circ_tc_operands",
    blocks), ("mp_circ_wide_operands", blocks) or
    ("mp_circ_fact_operands", blocks) beside the layouts of `lowered`, so
    a bank served many times is split and laid out once."""
    if fact:
        key = ("mp_circ_fact_operands", blocks)

        def lay(ckb):
            return mp_circ_fact_operands(ckb, blocks)
    else:
        key = ("mp_circ_wide_operands" if wide else "mp_circ_tc_operands",
               blocks)
        lay = mp_circ_wide_operands if wide else mp_circ_tc_operands
    if cache is None:
        return lay(lowered(bank, None, blocks))
    if key not in cache:
        cache[key] = lay(lowered(bank, cache, blocks))
    return cache[key]


# ---------------------------------------------------------------------------
# the wide form's layout (csrc/circ_wide_estimate.cu, `mp_circ_wide_launch`)
# ---------------------------------------------------------------------------

def mp_circ_wide_units(d: int, k: int, p: int, stats: bool = False) -> int:
    """Units (64 columns x 64 deep) of the wide form's bank: the forward
    operand's NPD x NPD, the logit's KP x NF, the combine's NPD x (P + 1) x
    KP and, except for the stats forms of K8 / K9 (P = 1), the inverse's
    NPD x NPD (NPD, NF, KP the 64-wide pieces of 2D, F and K; `wide_units`
    in csrc/circ_wide_estimate.cu)."""
    npd, kp = tu.chunks(2 * d), tu.chunks(k)
    nf = tu.chunks(d * (3 * p + p * (p - 1)))
    return ((1 if stats else 2) * npd * npd + kp * nf
            + npd * (p + 1) * kp)


def mp_circ_wide_tc_units(ckb: MpCircKernelBank,
                          stats: bool = False) -> torch.Tensor:
    """The bank's four operands in float32 as the wide form's units
    (`mp_circ_wide_units` of them, (units, 64, 64)), each product's pieces
    one after another, a piece's chunks consecutive: the forward operand
    bfwd (2D, 2D); the logit operand lcoef (F, K) in its own row order
    [u_1..u_P | |u_p|^2 | v_pq]; for each 64-column piece j of 2D the piece
    j of the bias slab, then of each pilot's filter slab, so that one
    block's pieces are a bin's (bias, filt_1 .. filt_P); the inverse binv
    (2D, 2D), except for the stats forms (`stats`, the wide K8 / K9 at one
    pilot)."""
    two_d = ckb.bfwd.shape[0]
    k, feat = ckb.const.shape[0], ckb.lcoef.shape[0]
    w2, wf, wk = 64 * tu.chunks(two_d), 64 * tu.chunks(feat), 64 * tu.chunks(k)
    units = [tu.piece_major(ckb.bfwd, w2, w2),
             tu.piece_major(ckb.lcoef, wf, wk),
             torch.stack([tu.piece_major(slab, wk, w2) for slab in ckb.comb],
                         1)]
    if not stats:
        units.append(tu.piece_major(ckb.binv, w2, w2))
    return torch.cat([u.reshape(-1, 64, 64) for u in units])


def mp_circ_wide_operands(ckb: MpCircKernelBank) -> tu.UnitOperands:
    """Split the bank's operands into bf16 hi / lo / lo2 and lay them out
    as the wide form's units (`mp_circ_wide_tc_units`, in the 128-byte
    swizzle). The same for every (T, alpha) layout of a bank; once per bank
    (`lowered_tc(..., wide=True)` keeps them)."""
    return tu.UnitOperands(*(kernels._sw128(pl).contiguous()
                             for pl in kernels.split_planes3(
                                 mp_circ_wide_tc_units(ckb).contiguous())))


def _mp_features(u: torch.Tensor) -> torch.Tensor:
    """u (n, P, D, 2) float32 -> the logit features (n, F): [u_1..u_P |
    |u_p|^2 | v_pq = conj(u_p) u_q for p < q, interleaved], each value
    rounded as the wide form's feature split rounds it."""
    n, p, d, _ = u.shape
    ur, ui = u[..., 0], u[..., 1]
    feats = [u.reshape(n, -1), (ur * ur + ui * ui).reshape(n, -1)]
    for pi in range(p):
        for qi in range(pi + 1, p):
            feats.append(torch.stack(
                [ur[:, pi] * ur[:, qi] + ui[:, pi] * ui[:, qi],
                 ur[:, pi] * ui[:, qi] - ui[:, pi] * ur[:, qi]],
                dim=-1).reshape(n, 2 * d))
    return torch.cat(feats, dim=-1)


def mp_circ_wide_rows(u: torch.Tensor, p: int) -> torch.Tensor:
    """u (N, P 2D) float32 -> the three bf16 planes of its logit features
    (N, F) as the wide form's logit product reads them: (3, tiles,
    ceil(F / 64), 64, 64), the wide K1's row layout
    (`kernels.wide_row_planes`). On a CUDA tensor the wide form's feature
    split (`circ_wide_features_launch`; uncounted: the wrappers count their
    launch), on a CPU tensor this plain version."""
    n, width = u.shape
    two_d = width // p
    if not u.is_cuda:
        return kernels.wide_row_planes(
            _mp_features(u.reshape(n, p, two_d // 2, 2)))
    kernels._check_cuda("u", u, (n, width), u.device)
    feat = two_d // 2 * (3 * p + p * (p - 1))
    a = torch.empty((3, kernels.wide_row_tiles(n), tu.chunks(feat), 64, 64),
                    dtype=torch.bfloat16, device=u.device)
    if n == 0:
        return a.zero_()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = kernels._library("circ_wide_estimate").circ_wide_features_launch(
            u.data_ptr(), a.data_ptr(), n, two_d, p, stream)
    if err != 0:
        raise RuntimeError(f"circ_wide_features launch failed: cudaError "
                           f"{err}")
    return a


# ---------------------------------------------------------------------------
# the factorised kernel's layout (csrc/mp_circ_fact_estimate.cu)
# ---------------------------------------------------------------------------

def mp_circ_fact_bank(ckb: MpCircKernelBank, blocks=None) -> MpCircKernelBank:
    """ckb with the per-bin rows of every feature group of lcoef (u_p: 2 (p
    D + c), + 1; |u_p|^2: 2 P D + p D + c; v_pq: 3 P D + 2 i D + 2c, + 1)
    and the columns of every comb slab (2c, 2c + 1) in the factorised
    transform's order (`circ_kernels.circ_fact_perm`); bfwd and binv as
    they are (the factorised route does not read them)."""
    from quantized_channel_estimation_torch.estimators import circ_kernels
    two_d = ckb.bfwd.shape[0]
    d, p = two_d // 2, ckb.comb.shape[0] - 1
    perm = circ_kernels.circ_fact_perm(d, blocks).to(ckb.lcoef.device)
    pair = torch.stack([2 * perm, 2 * perm + 1], -1).reshape(-1)
    rows = ([2 * pi * d + pair for pi in range(p)]
            + [2 * p * d + pi * d + perm for pi in range(p)]
            + [3 * p * d + 2 * i * d + pair
               for i in range(p * (p - 1) // 2)])
    return MpCircKernelBank(ckb.bfwd, ckb.lcoef[torch.cat(rows)].contiguous(),
                            ckb.const, ckb.comb[:, :, pair].contiguous(),
                            ckb.binv)


class MpCircFactOperands(NamedTuple):
    """The factorised K10's operands of a bank over the kernel's padded row
    of dp = d1 (d2 | 1) slots (`circ_kernels.circ_fact_slots`; the pad
    slots' rows and columns zero): each bf16 plane (hi, lo, lo2 of the
    three-plane split) holds the permuted lcoef's mma.sync B fragments
    ((k16 step, n8 tile) of the (16 S ceil(dp / 8), K) product in the
    kernel's step order, `mp_circ_fact_steps`), then the permuted comb's
    ((n8 tile, k16 step) of the (K, 8 (P + 1) ceil(dp / 4)) product: the P
    + 1 slabs' [re, im] of 4 slots a tile), `mp_circ_fact_units(d1, d2, P,
    K)` lanes of four; tw the float32 tables W_d1, W_d2 and the cross
    twiddle over the dp slots as interleaved [re, im] pairs; the levels
    (d1, d2), whether the basis is kron's, and P."""
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor
    tw: torch.Tensor
    d1: int
    d2: int
    kron: bool
    p: int


def mp_circ_fact_units(d1: int, d2: int, p: int, k: int) -> int:
    """Lanes (of four bf16) of each plane of `MpCircFactOperands`: the
    logit's S ceil(dp / 8) k16 steps x ceil(K / 8) n8 tiles and the
    combine's (P + 1) ceil(dp / 4) n8 tiles x ceil(K / 16) k16 steps, 32
    lanes each (dp = d1 (d2 | 1), S = `len(mp_circ_fact_steps(P))`)."""
    dp = d1 * (d2 | 1)
    return 32 * (-(-dp // 8) * len(mp_circ_fact_steps(p)) * -(-k // 8)
                 + -(-dp // 4) * (p + 1) * -(-k // 16))


def _fact_logit_rows(d: int, p: int, slot_pos: torch.Tensor) -> torch.Tensor:
    """The row of the permuted lcoef (`mp_circ_fact_bank`) behind each row
    of the kernel's logit operand, -1 for a zero row: 8-slot block j's
    steps (`mp_circ_fact_steps`), column c of a step at slot 8j + (c % 8) //
    2 + 4 (c // 8), part c % 2, for u_p and v_pq; for |u_a|^2, |u_b|^2 at
    slot 8j + (c % 8) // 2 + 4 (c % 2) of pilot a (c < 8) or b.
    slot_pos: the position behind each slot (-1 at a pad)."""
    nsb = -(-slot_pos.shape[0] // 8)
    pos = torch.full((8 * nsb,), -1, dtype=torch.long)
    pos[:slot_pos.shape[0]] = slot_pos
    c = torch.arange(16)
    pairs = {(a, b): i for i, (a, b) in enumerate(
        (a, b) for a in range(p) for b in range(a + 1, p))}
    out = []
    for j in range(nsb):
        for kind, a, b in mp_circ_fact_steps(p):
            if kind == "sq":
                pil = torch.where(c < 8, a, b)
                at = pos[8 * j + (c % 8) // 2 + 4 * (c % 2)]
                row = 2 * p * d + pil * d + at
                ok = (at >= 0) & (pil < p)
            else:
                at = pos[8 * j + (c % 8) // 2 + 4 * (c // 8)]
                first = (2 * a * d if kind == "u"
                         else 3 * p * d + 2 * pairs[(a, b)] * d)
                row = first + 2 * at + c % 2
                ok = at >= 0
            out.append(torch.where(ok, row, -1))
    return torch.cat(out)


def _fact_comb_cols(d: int, p: int, slot_pos: torch.Tensor) -> torch.Tensor:
    """The column of the permuted comb slabs flattened ((P + 1) 2D, slab
    major) behind each column of the kernel's combine operand, -1 for a
    zero column: group j's P + 1 n8 tiles, tile s column c slab s's [re,
    im] (c % 2) of slot 4j + c // 2."""
    ng = -(-slot_pos.shape[0] // 4)
    pos = torch.full((4 * ng,), -1, dtype=torch.long)
    pos[:slot_pos.shape[0]] = slot_pos
    c = torch.arange(8)
    out = []
    for j in range(ng):
        at = pos[4 * j + c // 2]
        for s in range(p + 1):
            out.append(torch.where(at >= 0, s * 2 * d + 2 * at + c % 2, -1))
    return torch.cat(out)


def _gather_rows(m: torch.Tensor, idx: torch.Tensor, dim: int):
    """m's rows (dim 0) or columns (dim 1) at idx, zero where idx is -1."""
    idx = idx.to(m.device)
    taken = m.index_select(dim, idx.clamp(min=0))
    keep = (idx >= 0).to(m.dtype)
    return taken * (keep[:, None] if dim == 0 else keep[None, :])


def mp_circ_fact_operands(ckb: MpCircKernelBank,
                          blocks=None) -> MpCircFactOperands:
    """Lay ckb out for the factorised K10 in the transform basis `blocks`
    (None: the DFT): lcoef's rows and the comb slabs' columns permuted
    (`mp_circ_fact_bank`) onto the kernel's padded slots in its step and
    tile order, split into bf16 hi / lo / lo2 and laid out as B fragments;
    the tables built in float64 and rounded once, as
    `circ_kernels.circ_fact_operands` builds K6's. The same for every (T,
    alpha) layout of a bank; once per bank (`lowered_tc(..., fact=True)`
    keeps them)."""
    from quantized_channel_estimation_torch.estimators import circ_kernels
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    levels = circ_kernels.circ_fact_blocks(d, blocks)
    if levels is None:
        raise ValueError(f"the factorised kernel takes no D = {d} transform"
                         f" (blocks={blocks}): circ_fact_blocks")
    d1, d2 = levels
    dp = d1 * (d2 | 1)
    fb = mp_circ_fact_bank(ckb, blocks)
    slot = circ_kernels.circ_fact_slots(d1, d2)
    slot_pos = torch.full((dp,), -1, dtype=torch.long)
    slot_pos[slot] = torch.arange(d)
    lcoef = _gather_rows(fb.lcoef, _fact_logit_rows(d, p, slot_pos), 0)
    comb = _gather_rows(fb.comb.permute(1, 0, 2).reshape(k, -1),
                        _fact_comb_cols(d, p, slot_pos), 1)
    frags = torch.cat([circ_kernels._b_fragments(lcoef, True),
                       circ_kernels._b_fragments(comb, False)])
    planes = kernels.split_planes3(frags.contiguous())
    t1, t2, cross = circ_kernels._fact_tables(d1, d2, blocks is not None,
                                              ckb.lcoef.device)
    cross_p = cross.new_zeros((dp,))
    cross_p[slot.to(cross.device)] = cross
    tw = torch.view_as_real(torch.cat([t1, t2, cross_p])).to(torch.float32)
    return MpCircFactOperands(*(pl.contiguous() for pl in planes),
                              tw.reshape(-1).contiguous(), d1, d2,
                              blocks is not None, p)


# ---------------------------------------------------------------------------
# plain versions: the kernel's own arithmetic in float32
# ---------------------------------------------------------------------------

def _mp_reference(x2, ckb, t_coh, coh_alpha, chunk, fwd=None, inv=None):
    """The plain K10 on x2's rows, chunk rows (whole blocks) at a time; the
    transforms by bfwd and binv, or by the functions `fwd` and `inv` of
    interleaved rows (n, 2D)."""
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
        xp = xc.reshape(n * p, two_d)
        u = (xp @ ckb.bfwd if fwd is None else fwd(xp)).reshape(n, p, d, 2)
        ur, ui = u[..., 0], u[..., 1]                        # (n, P, D)
        lg = _mp_features(u) @ ckb.lcoef + ckb.const[None]
        w = torch.softmax(_pool(lg, t_coh, coh_alpha), dim=-1)
        c = (w @ comb).reshape(n, p + 1, d, 2)
        fr, fi = c[:, 1:, :, 0], c[:, 1:, :, 1]
        hr = c[:, 0, :, 0] + (fr * ur - fi * ui).sum(1)
        hi = c[:, 0, :, 1] + (fr * ui + fi * ur).sum(1)
        h = torch.stack([hr, hi], dim=-1).reshape(n, two_d)
        outs.append(h @ ckb.binv if inv is None else inv(h))
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


def mp_circ_fact_reference(x2: torch.Tensor, ckb: MpCircKernelBank,
                           t_coh: int = 1, coh_alpha: float = 1.0,
                           blocks=None, chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the factorised K10 (flat at t_coh = 1,
    coherent above; ckb from `mp_circ_kernel_bank(bank, blocks, t_coh,
    coh_alpha)`) in x2's precision: the factorised transform of each pilot
    segment (`circ_kernels.circ_fact_transform`), the logit over [u_p |
    |u_p|^2 | v_pq], the softmax (pooled over T-row blocks) and the combine
    h = c_bias + sum_p c_filt_p u_p on the permuted layout
    (`mp_circ_fact_bank`), and the inverse into natural order. In float32
    the logit and the combine run as `mp_circ_wide_reference` runs them
    (six bf16 products a step in compensated sums, which keep float32's
    accuracy on pooled logits, where plain float32 products lose it); in
    float64 they are plain products (`_mp_reference`'s arithmetic), the
    function itself. x2 (N, 2PD) interleaved, pilot-major
    -> (N, 2D). For the CPU tests and chip_smoke's checks; nothing on the
    main path calls it where a card is present."""
    from quantized_channel_estimation_torch.estimators import circ_kernels
    d = ckb.bfwd.shape[0] // 2
    d1, d2 = circ_kernels.circ_fact_blocks(d, blocks)
    kron = blocks is not None
    run = _mp_reference if x2.dtype == torch.float64 else _mp_walked
    return run(x2, mp_circ_fact_bank(ckb, blocks), t_coh, coh_alpha, chunk,
               lambda x: circ_kernels._fact_real(x, d1, d2, kron, False),
               lambda h: circ_kernels._fact_real(h, d1, d2, kron, True))


def _chunked(rows: torch.Tensor, w: torch.Tensor, width: int):
    """rows @ w with the contraction zero-padded to `width` and cut into
    64-deep chunks, each chunk's `tc_units.six` added in order in float32."""
    rows = torch.nn.functional.pad(rows, (0, width - rows.shape[1]))
    w = torch.nn.functional.pad(w, (0, 0, 0, width - w.shape[0]))
    out = tu.six(rows[:, :64], w[:64])
    for c in range(64, width, 64):
        out = out + tu.six(rows[:, c:c + 64], w[c:c + 64])
    return out


def mp_circ_tc_reference(x2: torch.Tensor, ckb: MpCircKernelBank,
                         t_coh: int = 1, coh_alpha: float = 1.0,
                         chunk: int = 8192, stats: bool = False):
    """Plain PyTorch version of K10's arithmetic (the coherent form at
    t_coh > 1): each of the four products as the kernel cuts it, every
    64-deep chunk of the forward, combine and inverse contractions the six
    bf16 products of `tc_units.six` into a fresh float32 result, added in
    order; every 16-deep chunk of the logit's feature groups (u_p; |u_p|^2;
    each pair) likewise, added in a compensated (Kahan) sum with const, whose
    error is folded in after the row's offset (its largest logit among the
    first 64 components) is taken off; the features, pooling, softmax and
    complex combine in float32. For the CPU tests; nothing on the main path
    calls it. `mp_circ_estimate_reference` is the same function with
    float32 products. x2 (N, 2PD) float32 -> (N, 2D); `stats`: the stats
    form's (m (N,), den (N,), h (N, 2D)) instead, the un-normalised
    weights exp(l - max l) and m = fl(o + max l), o the row's offset (the
    coherent form: pooled as the logits are, in float64)."""
    pin_fp32()
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    w2, wk = 64 * _pieces(two_d), 64 * _pieces(k)
    w_sq = 64 * ((_pieces(two_d) + 1) // 2)
    lc = ckb.lcoef
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    ms, dens, outs = [], [], []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        xp = xc.reshape(n, p, two_d)
        u = [_chunked(xp[:, pi], ckb.bfwd, w2).reshape(n, d, 2)
             for pi in range(p)]
        feats = [(u[pi].reshape(n, two_d), lc[2 * pi * d:2 * (pi + 1) * d],
                  w2) for pi in range(p)]
        feats += [((u[pi] * u[pi]).sum(-1),
                   lc[2 * p * d + pi * d:2 * p * d + (pi + 1) * d], w_sq)
                  for pi in range(p)]
        v0 = 3 * p * d
        for i, (pi, qi) in enumerate((a, b) for a in range(p)
                                     for b in range(a + 1, p)):
            ur, ui, vr, vi = (u[pi][..., 0], u[pi][..., 1], u[qi][..., 0],
                              u[qi][..., 1])
            feats.append((torch.stack([ur * vr + ui * vi, ur * vi - ui * vr],
                                      -1).reshape(n, two_d),
                          lc[v0 + i * two_d:v0 + (i + 1) * two_d], w2))
        lg = lost = torch.zeros(n, k, dtype=xc.dtype, device=xc.device)
        for z, coef, width in feats:
            z = torch.nn.functional.pad(z, (0, width - z.shape[1]))
            coef = torch.nn.functional.pad(coef,
                                           (0, 0, 0, width - coef.shape[0]))
            for c in range(0, width, 16):
                lg, lost = tu.kahan(lg, lost, tu.six(z[:, c:c + 16],
                                                 coef[c:c + 16]))
        lg, lost = tu.kahan(lg, lost, ckb.const[None])
        off = lg[:, :64].max(-1, keepdim=True).values   # the row's offset
        off = torch.where(off > -1e29, off, torch.zeros_like(off))
        lg = _pool((lg - off) - lost, t_coh, coh_alpha)
        if stats:
            o = _pool(off.double(), t_coh, coh_alpha)
            mx = lg.max(-1, keepdim=True).values
            mx = torch.where(mx > -torch.inf, mx, 0.0)
            m = (o + mx.double()).float()
            w = torch.exp(lg - mx)
            ms.append(m[:, 0])
            dens.append(w.sum(-1))
        else:
            w = torch.softmax(lg, -1)
        h = _chunked(w, ckb.comb[0], wk).reshape(n, d, 2)
        hr, hi = h[..., 0], h[..., 1]
        wpad = torch.nn.functional.pad(w, (0, wk - k))
        cpad = torch.nn.functional.pad(ckb.comb, (0, 0, 0, wk - k))
        for pi in range(p):
            ur, ui = u[pi][..., 0], u[pi][..., 1]
            for c in range(0, wk, 64):
                f = tu.six(wpad[:, c:c + 64], cpad[pi + 1, c:c + 64]).reshape(
                    n, d, 2)
                fr, fi = f[..., 0], f[..., 1]
                hr, hi = hr + fr * ur - fi * ui, hi + fr * ui + fi * ur
        h = torch.stack([hr, hi], -1).reshape(n, two_d)
        outs.append(h if stats else _chunked(h, ckb.binv, w2))
    out = torch.cat(outs) if outs else x2.new_zeros((0, two_d))
    if not stats:
        return out
    if not ms:
        return x2.new_zeros((0,)), x2.new_zeros((0,)), out
    return torch.cat(ms), torch.cat(dens), out


def mp_circ_wide_reference(x2: torch.Tensor, ckb: MpCircKernelBank,
                           t_coh: int = 1, coh_alpha: float = 1.0,
                           chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the wide K10's arithmetic (the coherent
    form at t_coh > 1; ckb from `mp_circ_kernel_bank(bank, blocks, t_coh,
    coh_alpha)`), its products walked as the kernel walks its units: the
    forward transform of the N P pilot rows, the combine slabs and the
    inverse transform each a compensated sum over 64-deep chunks of the
    six bf16 products of `tc_units.six` (`tc_units.walked`); the logit over
    the features [u | |u_p|^2 | v_pq] (`_mp_features`) padded to whole
    64-deep chunks, each 16-deep step's six products added in a compensated
    sum with const, whose error is folded in after the row's offset (its
    largest logit among the first 64 components) is taken off; the pool and
    softmax in float32; h = c_bias + c_filt_1 u_1 + ... + c_filt_P u_P per
    bin, pilot by pilot. x2 (N, 2PD) float32 interleaved, pilot-major ->
    (N, 2D). For the CPU tests and chip_smoke's checks; nothing on the main
    path calls it where a card is present."""
    return _mp_walked(x2, ckb, t_coh, coh_alpha, chunk)


def _mp_walked(x2, ckb, t_coh, coh_alpha, chunk, fwd=None, inv=None):
    """`mp_circ_wide_reference`'s arithmetic; the transforms the walked
    products by bfwd and binv, or the functions `fwd` and `inv` of
    interleaved rows (n, 2D)."""
    pin_fp32()
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    feat = ckb.lcoef.shape[0]
    wf = 64 * tu.chunks(feat)
    coef = torch.nn.functional.pad(ckb.lcoef, (0, 0, 0, wf - feat))
    if x2.shape[0] % t_coh:
        raise ValueError(f"{x2.shape[0]} rows are no whole number of "
                         f"T={t_coh} blocks")
    chunk = max(t_coh, chunk // t_coh * t_coh)   # whole blocks per chunk
    outs = []
    for i0 in range(0, x2.shape[0], chunk):
        xc = x2[i0:i0 + chunk]
        n = xc.shape[0]
        xp = xc.reshape(n * p, two_d)
        u = (tu.walked(xp, ckb.bfwd) if fwd is None else fwd(xp)).reshape(
            n, p, d, 2)
        z = torch.nn.functional.pad(_mp_features(u), (0, wf - feat))
        lg = lost = torch.zeros(n, k, dtype=xc.dtype, device=xc.device)
        for c in range(0, wf, 16):
            lg, lost = tu.kahan(lg, lost,
                                tu.six(z[:, c:c + 16], coef[c:c + 16]))
        lg, lost = tu.kahan(lg, lost, ckb.const[None])
        off = lg[:, :64].max(-1, keepdim=True).values   # the row's offset
        off = torch.where(off > -1e29, off, torch.zeros_like(off))
        w = torch.softmax(_pool((lg - off) - lost, t_coh, coh_alpha), -1)
        h = tu.walked(w, ckb.comb[0]).reshape(n, d, 2)
        hr, hi = h[..., 0], h[..., 1]
        for pi in range(p):
            f = tu.walked(w, ckb.comb[pi + 1]).reshape(n, d, 2)
            fr, fi = f[..., 0], f[..., 1]
            ur, ui = u[:, pi, :, 0], u[:, pi, :, 1]
            hr, hi = hr + fr * ur - fi * ui, hi + fr * ui + fi * ur
        h = torch.stack([hr, hi], -1).reshape(n, two_d)
        outs.append(tu.walked(h, ckb.binv) if inv is None else inv(h))
    return torch.cat(outs) if outs else x2.new_zeros((0, two_d))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _rule(d: int, k: int, p: int, t: int) -> str:
    """The rule's statement at these widths, for the errors."""
    return (f"the multi-pilot circulant kernel takes D, K <= {CIRC_MAX_D}, "
            f"{CIRC_MAX_K}, T up to a warpgroup's live rows and a "
            f"warpgroup's u within {SMEM_BLOCK_BYTES} bytes of shared "
            f"memory beside a ring of two units, or in its wide form D <= "
            f"{WIDE_MAX_D}, T <= {WIDE_MAX_T} and 128 T rows within "
            f"{kernels.WIDE_SCRATCH} bytes of scratch; got D={d}, K={k}, "
            f"P={p}, T={t} ({mp_circ_tile_rows(d, k, p, t)} live rows, "
            f"{mp_circ_smem_bytes(d, k, p, t)} bytes at 64, "
            f"{mp_circ_wide_row_bytes(d, k, p)} scratch bytes a row)")


def _launch(name: str, x2: torch.Tensor, ckb: MpCircKernelBank, t_coh: int,
            coh_alpha: float,
            ops: Optional[tu.UnitOperands]) -> torch.Tensor:
    """Validate, allocate and launch on x2's device and current stream with
    the bank's operands `ops` (laid out here when None); raise on any
    refusal."""
    n = x2.shape[0]
    two_d = ckb.bfwd.shape[0]
    d, p = two_d // 2, ckb.comb.shape[0] - 1
    k = ckb.const.shape[0]
    if n % t_coh or not mp_circ_narrow(d, k, p, t_coh):
        raise ValueError(f"{name} takes N rows of whole T-row blocks; "
                         + _rule(d, k, p, t_coh) + f", N={n}"
                         + ("" if n % t_coh else
                            "; past the template, mp_circ_estimate_wide"))
    dev = x2.device
    feat = d * (3 * p + p * (p - 1))
    kernels._check_cuda("x2", x2, (n, p * two_d), dev)
    kernels._check_cuda("bfwd", ckb.bfwd, (two_d, two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (feat, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (p + 1, k, two_d), dev)
    kernels._check_cuda("binv", ckb.binv, (two_d, two_d), dev)
    if ops is None:
        ops = mp_circ_tc_operands(ckb)
    check_mp_circ_tc_operands(name, ops, ckb, dev)
    return launch_tc(name, x2, ops, ckb.const, d, p, t_coh, coh_alpha,
                     False)


def launch_tc(name: str, x2: torch.Tensor, ops: tu.UnitOperands,
              const: torch.Tensor, d: int, p: int, t_coh: int,
              coh_alpha: float, stats: bool):
    """Allocate the outputs and launch csrc/mp_circ_estimate.cu on x2's
    device and current stream, the inputs validated by the caller (K10's
    `_launch`, `circ_kernels._launch`); raise on any refusal. Returns out
    (N, 2D), or for `stats` (m (N,), den (N,), out)."""
    n, dev = x2.shape[0], x2.device
    out = torch.empty((n, 2 * d), dtype=torch.float32, device=dev)
    m = den = None
    if stats:
        m = torch.empty((n,), dtype=torch.float32, device=dev)
        den = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        lib = kernels._library("mp_circ_estimate")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp_circ_estimate_launch(
                x2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                ops.lo2.data_ptr(), const.data_ptr(), out.data_ptr(),
                m.data_ptr() if stats else None,
                den.data_ptr() if stats else None, n, d, p, const.shape[0],
                ops.hi.shape[0], int(t_coh), float(coh_alpha), int(stats),
                stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return (m, den, out) if stats else out


def mp_circ_estimate(x2: torch.Tensor, ckb: MpCircKernelBank,
                     operands: Optional[tu.UnitOperands] = None
                     ) -> torch.Tensor:
    """K10 on x2 (N, 2PD) float32 interleaved, pilot-major -> (N, 2D). On a
    CUDA tensor it launches the CUDA kernel on the current stream with the
    bank's `operands` (`mp_circ_tc_operands(ckb)`, laid out in the call
    when None) and raises on any refusal; on a CPU tensor it computes the
    plain version."""
    if not x2.is_cuda:
        return mp_circ_estimate_reference(x2, ckb)
    out = _launch("mp_circ_estimate", x2, ckb, 1, 1.0, operands)
    if x2.shape[0]:
        mp_circ_estimate.launches += 1
    return out


def mp_circ_estimate_coherent(x2: torch.Tensor, ckb: MpCircKernelBank,
                              t_coh: int, coh_alpha: float = 1.0,
                              operands: Optional[tu.UnitOperands] = None
                              ) -> torch.Tensor:
    """The coherent K10 on x2 (N, 2PD), N / T blocks of T consecutive rows
    (2 <= T <= `mp_circ_tile_rows`), ckb from `mp_circ_kernel_bank(bank,
    blocks, t_coh, coh_alpha)`, `operands` as for `mp_circ_estimate` (any
    layout of the bank). CUDA kernel on a CUDA tensor, plain version on the
    CPU."""
    if t_coh < 2:
        raise ValueError(f"mp_circ_estimate_coherent takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return mp_circ_estimate_coherent_reference(x2, ckb, t_coh, coh_alpha)
    out = _launch("mp_circ_estimate_coherent", x2, ckb, t_coh, coh_alpha,
                  operands)
    if x2.shape[0]:
        mp_circ_estimate_coherent.launches += 1
    return out


def mp_circ_wide_launch_rows(n: int, d: int, k: int, p: int,
                             t_coh: int = 1) -> int:
    """Rows of one launch of the wide form: all n, or as many as keep its
    scratch within `kernels.WIDE_SCRATCH` (`mp_circ_wide_row_bytes` a
    row), a multiple of 128 T (whole blocks, whole pairs of 64-row tiles of
    rows and of pilot rows)."""
    step = 128 * t_coh
    rows = max(step, kernels.WIDE_SCRATCH // mp_circ_wide_row_bytes(d, k, p)
               // step * step)
    return min(n, rows)


def _launch_wide(wrapper, x2: torch.Tensor, ckb: MpCircKernelBank,
                 t_coh: int, coh_alpha: float,
                 ops: Optional[tu.UnitOperands]) -> torch.Tensor:
    """Launch the wide form (csrc/circ_wide_estimate.cu,
    `mp_circ_wide_launch`) on x2's device and current stream, one launch
    for each row chunk (`mp_circ_wide_launch_rows`), and add one to
    `wrapper`'s count for each: -> out (N, 2D); raise on any refusal."""
    name = wrapper.__name__
    n = x2.shape[0]
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    if n % t_coh or not mp_circ_wide_eligible(d, k, p, t_coh):
        raise ValueError(f"{name} takes N rows of whole T-row blocks; "
                         + _rule(d, k, p, t_coh) + f", N={n}")
    dev, f32 = x2.device, torch.float32
    feat = d * (3 * p + p * (p - 1))
    kernels._check_cuda("x2", x2, (n, p * two_d), dev)
    kernels._check_cuda("bfwd", ckb.bfwd, (two_d, two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (feat, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (p + 1, k, two_d), dev)
    kernels._check_cuda("binv", ckb.binv, (two_d, two_d), dev)
    out = torch.empty((n, two_d), dtype=f32, device=dev)
    if n == 0:
        return out
    if ops is None:
        ops = mp_circ_wide_operands(ckb)
    tu.check_units(name, ops, mp_circ_wide_units(d, k, p), dev,
                "mp_circ_wide_operands")
    rows = mp_circ_wide_launch_rows(n, d, k, p, t_coh)
    units = max(kernels.wide_row_tiles(rows * p) * tu.chunks(two_d),
                kernels.wide_row_tiles(rows) * max(
                    tu.chunks(feat), tu.chunks(k), tu.chunks(two_d)))
    a = torch.empty((3, units, 64, 64), dtype=torch.bfloat16, device=dev)
    u = torch.empty((rows, p * two_d), dtype=f32, device=dev)
    lg = torch.empty((rows, k), dtype=f32, device=dev)
    offs = torch.empty((rows,), dtype=f32, device=dev)
    lib = kernels._library("circ_wide_estimate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i0 in range(0, n, rows):
            i1 = min(n, i0 + rows)
            err = lib.mp_circ_wide_launch(
                x2[i0:i1].data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
                ops.lo2.data_ptr(), ckb.const.data_ptr(),
                out[i0:i1].data_ptr(), a.data_ptr(), u.data_ptr(),
                lg.data_ptr(), offs.data_ptr(), i1 - i0, d, p, k,
                ops.hi.shape[0], int(t_coh), float(coh_alpha), stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
            wrapper.launches += 1
    return out


def mp_circ_estimate_wide(x2: torch.Tensor, ckb: MpCircKernelBank,
                          operands: Optional[tu.UnitOperands] = None
                          ) -> torch.Tensor:
    """K10's wide form on x2 (N, 2PD) -> (N, 2D), `operands` from
    `mp_circ_wide_operands(ckb)` (laid out in the call when None); the
    entries launch it past the template's rule. On a CUDA tensor it
    launches the CUDA kernels (`mp_circ_wide_eligible`) and raises on any
    refusal; on a CPU tensor it computes the plain version
    `mp_circ_wide_reference`."""
    if not x2.is_cuda:
        return mp_circ_wide_reference(x2, ckb)
    return _launch_wide(mp_circ_estimate_wide, x2, ckb, 1, 1.0, operands)


def mp_circ_estimate_coherent_wide(x2: torch.Tensor, ckb: MpCircKernelBank,
                                   t_coh: int, coh_alpha: float = 1.0,
                                   operands: Optional[tu.UnitOperands]
                                   = None) -> torch.Tensor:
    """The coherent K10's wide form on x2 (N, 2PD), N / T blocks of T
    consecutive rows (2 <= T <= 64), ckb from `mp_circ_kernel_bank(bank,
    blocks, t_coh, coh_alpha)`, `operands` as for `mp_circ_estimate_wide`
    (any layout of the bank). CUDA kernels on a CUDA tensor, the plain
    version `mp_circ_wide_reference` on the CPU."""
    if t_coh < 2:
        raise ValueError(f"mp_circ_estimate_coherent_wide takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return mp_circ_wide_reference(x2, ckb, t_coh, coh_alpha)
    return _launch_wide(mp_circ_estimate_coherent_wide, x2, ckb, t_coh,
                        coh_alpha, operands)


def _launch_fact(wrapper, x2: torch.Tensor, ckb: MpCircKernelBank,
                 t_coh: int, coh_alpha: float,
                 ops: Optional[MpCircFactOperands]) -> torch.Tensor:
    """Launch the factorised kernel (csrc/mp_circ_fact_estimate.cu) on
    x2's device and current stream with the bank's operands `ops` (laid
    out here in the layout's own basis, `circ_kernels.circ_basis_blocks`,
    when None), and add one to `wrapper`'s count: -> out (N, 2D); raise on
    any refusal. Takes D = d1 d2 with 2 <= d1, d2 <= 64 up to D = 672, K <=
    128, T <= 64 and P <= 16 where the tile's buffers fit
    (`mp_circ_fact_plan`; the entries send it `mp_circ_fact_eligible`)."""
    from quantized_channel_estimation_torch.estimators import circ_kernels
    name = wrapper.__name__
    n = x2.shape[0]
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    if ops is not None and (not isinstance(ops, MpCircFactOperands)
                            or ops.p != p):
        raise ValueError(f"{name} takes the factorised kernel's operands "
                         f"(`mp_circ_fact_operands`) of a {p}-pilot bank, "
                         f"got {type(ops).__name__}")
    blocks = (circ_kernels.circ_basis_blocks(ckb) if ops is None
              else (ops.d1, ops.d2) if ops.kron else None)
    levels = circ_kernels.circ_fact_blocks(d, blocks)
    plan = (None if levels is None or n % t_coh
            else mp_circ_fact_plan(*levels, p, k, t_coh))
    if plan is None:
        raise ValueError(
            f"{name} takes N rows of whole T-row blocks, D = d1 d2 with 2 <= "
            f"d1, d2 <= {circ_kernels.CIRC_FACT_MAX_N} up to D = "
            f"{WIDE_MAX_D}, K <= {CIRC_MAX_K}, T <= {WIDE_MAX_T} and P <= "
            f"{MP_FACT_MAX_P} where the tile's buffers fit "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory; got N={n}, D={d}, "
            f"K={k}, P={p}, T={t_coh} (levels {levels})")
    dev = x2.device
    feat = d * (3 * p + p * (p - 1))
    kernels._check_cuda("x2", x2, (n, p * two_d), dev)
    kernels._check_cuda("lcoef", ckb.lcoef, (feat, k), dev)
    kernels._check_cuda("const", ckb.const, (k,), dev)
    kernels._check_cuda("comb", ckb.comb, (p + 1, k, two_d), dev)
    out = torch.empty((n, two_d), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    if ops is None:
        ops = mp_circ_fact_operands(ckb, blocks)
    units = mp_circ_fact_units(ops.d1, ops.d2, p, k)
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
                f"on {dev} (`mp_circ_fact_operands` at D={d}, K={k}, P={p}),"
                f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels._library("mp_circ_fact_estimate").mp_circ_fact_launch(
            x2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
            ops.lo2.data_ptr(), ckb.const.data_ptr(), ops.tw.data_ptr(),
            out.data_ptr(), n, d, ops.d1, ops.d2, p, k, units, int(t_coh),
            float(coh_alpha), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def _blocks_of(ckb: MpCircKernelBank, ops: Optional[MpCircFactOperands]):
    """The basis of the factorised route: the operands' own, else the
    layout's (`circ_kernels.circ_basis_blocks`)."""
    from quantized_channel_estimation_torch.estimators import circ_kernels
    if ops is None:
        return circ_kernels.circ_basis_blocks(ckb)
    return (ops.d1, ops.d2) if ops.kron else None


def mp_circ_estimate_fact(x2: torch.Tensor, ckb: MpCircKernelBank,
                          operands: Optional[MpCircFactOperands] = None
                          ) -> torch.Tensor:
    """K10 on the factorised kernel: x2 (N, 2PD) -> (N, 2D), `operands`
    from `mp_circ_fact_operands(ckb, blocks)` (laid out in the call, in the
    layout's own basis, when None); the entries launch it where
    `mp_circ_route` says 'fact'. On a CUDA tensor it launches the CUDA
    kernel and raises on any refusal; on a CPU tensor it computes the plain
    version `mp_circ_fact_reference`."""
    if not x2.is_cuda:
        return mp_circ_fact_reference(x2, ckb, 1, 1.0,
                                      _blocks_of(ckb, operands))
    return _launch_fact(mp_circ_estimate_fact, x2, ckb, 1, 1.0, operands)


def mp_circ_estimate_coherent_fact(x2: torch.Tensor, ckb: MpCircKernelBank,
                                   t_coh: int, coh_alpha: float = 1.0,
                                   operands: Optional[MpCircFactOperands]
                                   = None) -> torch.Tensor:
    """The coherent K10 on the factorised kernel: x2 (N, 2PD), N / T blocks
    of T consecutive rows (2 <= T <= 64), ckb from
    `mp_circ_kernel_bank(bank, blocks, t_coh, coh_alpha)`, `operands` as
    for `mp_circ_estimate_fact` (any layout of the bank). CUDA kernel on a
    CUDA tensor, the plain version `mp_circ_fact_reference` on the CPU."""
    if t_coh < 2:
        raise ValueError(f"mp_circ_estimate_coherent_fact takes T >= 2; got "
                         f"{t_coh}")
    if not x2.is_cuda:
        return mp_circ_fact_reference(x2, ckb, t_coh, coh_alpha,
                                      _blocks_of(ckb, operands))
    return _launch_fact(mp_circ_estimate_coherent_fact, x2, ckb, t_coh,
                        coh_alpha, operands)


kernels.register_wrappers(mp_circ_estimate, mp_circ_estimate_coherent,
                          mp_circ_estimate_wide,
                          mp_circ_estimate_coherent_wide,
                          mp_circ_estimate_fact,
                          mp_circ_estimate_coherent_fact)


# ---------------------------------------------------------------------------
# entries on complex observations and multi-pilot banks
# ---------------------------------------------------------------------------

_ESTIMATES = {"template": (mp_circ_estimate, mp_circ_estimate_coherent),
              "wide": (mp_circ_estimate_wide, mp_circ_estimate_coherent_wide),
              "fact": (mp_circ_estimate_fact, mp_circ_estimate_coherent_fact)}


def _route_ops(bank: CirculantBankMP, r: torch.Tensor, t: int, blocks,
               cache: Optional[dict]):
    """The route of the bank at T (`mp_circ_route`, from the shapes alone;
    raises outside the rule), its flat and coherent wrappers and, for a
    CUDA tensor, its operands (`lowered_tc`)."""
    k, d, p = bank.mean_rf.shape
    route = mp_circ_route(d, k, p, t, blocks)
    ops = (lowered_tc(bank, cache, blocks, route == "wide", route == "fact")
           if r.is_cuda else None)
    return _ESTIMATES[route], ops


def estimate_fused_circulant_mp(bank: CirculantBankMP, r: torch.Tensor,
                                blocks=None,
                                cache: Optional[dict] = None) -> torch.Tensor:
    """'all'-mode multi-pilot structured estimate of r (N, P*D) complex ->
    (N, D) through K10 (past the template's rule its factorised kernel or
    its wide form, `mp_circ_route`): the
    kernel analog of `structured_bank.estimate_circulant_mp` (selection
    modes stay on the `torch.fft` path). Raises outside
    `mp_circ_kernel_eligible` (`harness.stages.estimate_circulant` sends
    those to the pipeline). `cache`: see `lowered` and `lowered_tc`."""
    (est, _), ops = _route_ops(bank, r, 1, blocks, cache)
    return _hc(est(_x2(r), lowered(bank, cache, blocks), ops), r.dtype)


def estimate_fused_circulant_mp_coherent(bank: CirculantBankMP,
                                         r: torch.Tensor, alpha: float = 1.0,
                                         blocks=None,
                                         cache: Optional[dict] = None
                                         ) -> torch.Tensor:
    """Coherent 'all'-mode multi-pilot structured estimate of blocks
    r (B, T, P*D) -> (B, T, D): the kernel analog of
    `structured_bank.estimate_circulant_mp_coherent`. T = 1 runs the flat
    form; T within `mp_circ_kernel_eligible` runs the coherent form (the
    template's, the factorised or the wide one, `mp_circ_route`) with the
    alpha blend in the kernel; beyond
    the rule it raises. `cache`: see `lowered` and `lowered_tc`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, P*D) blocks, got "
                         f"{tuple(r.shape)}")
    b, t, _ = r.shape
    if t == 1:
        return estimate_fused_circulant_mp(bank, r[:, 0, :], blocks,
                                           cache)[:, None, :]
    (_, est), ops = _route_ops(bank, r, t, blocks, cache)
    h2 = est(_x2(r), lowered(bank, cache, blocks, t, alpha), t, alpha, ops)
    return _hc(h2, r.dtype).reshape(b, t, -1)
