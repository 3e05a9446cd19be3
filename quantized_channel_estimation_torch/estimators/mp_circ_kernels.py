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
- the eligibility rule `mp_circ_kernel_eligible` is the CUDA kernel's range
  (D, K <= 128, T up to a warpgroup's live rows, and a warpgroup's u within
  a block's shared memory beside the operand ring, which bounds P), in
  place of the TPU's resident-bank budget. The TPU package has no stats
  form of this kernel, so a bank of more than 128 components is not split:
  beyond the rule the entries raise and `harness.stages` takes the
  `torch.fft` pipeline.

A wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain PyTorch version only for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators.variant_kernels import (
    tc_products)
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBankMP)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

CIRC_MAX_D = 128   # bins of the circulant kernels
CIRC_MAX_K = 128   # components of one launch of the circulant kernels
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


def mp_circ_kernel_eligible(d: int, k: int, p: int, t: int = 1) -> bool:
    """Can K10 serve a multi-pilot bank of K components over D bins and P
    pilots, pooling T-snapshot blocks? D, K <= 128, P >= 1, and T within
    the live rows of a warpgroup where one warpgroup's u fits a block's
    shared memory beside a ring of two units (every P <= 4 at any D and K,
    with T <= 64 at D <= 64; P <= 11 at D = K = 64 and P <= 5 at D = K =
    128, with T <= 32). A rule of the shapes, decided before any launch."""
    return (1 <= d <= CIRC_MAX_D and 1 <= k <= CIRC_MAX_K and p >= 1
            and 1 <= t <= mp_circ_tile_rows(d, k, p, t))


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
# the tensor-core layout of the bank
# ---------------------------------------------------------------------------

class MpCircTcOperands(NamedTuple):
    """The bank as K10 streams it: the bf16 planes (`kernels.split_planes3`)
    of its four operands as the sequence of units one tile consumes
    (`mp_circ_tc_units`), each unit the 64 x 64 transpose of one 64-column
    piece of an operand over one 64-deep contraction chunk in the 128-byte
    swizzle (`kernels._sw128`), padding zero. The same for every (T, alpha)
    layout of a bank: those differ in `const` only, which the kernel reads
    from the layout.

    hi, lo, lo2: (units, 64, 64) bfloat16
    """
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor


def _blocks(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(R, C) zero-padded to (rows, cols) -> (rows / 64, cols / 64, 64, 64):
    block [c, j] is the transpose of rows [64 c, 64 c + 64) x columns
    [64 j, 64 j + 64)."""
    w = torch.nn.functional.pad(w, (0, cols - w.shape[1],
                                    0, rows - w.shape[0]))
    return w.reshape(rows // 64, 64, cols // 64, 64).permute(0, 2, 3, 1)


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
    fwd = _blocks(ckb.bfwd, w2, w2)
    units = [fwd[c, j] for _ in range(p) for c in range(npd)
             for j in range(npd)]
    lc = ckb.lcoef
    order = _sq_order(d).to(lc.device)
    groups = [_blocks(lc[2 * pi * d:2 * (pi + 1) * d], w2, wk)
              for pi in range(p)]
    sq0 = 2 * p * d
    for pi in range(p):
        rows = lc[sq0 + pi * d + order.clamp(min=0)]
        rows = torch.where(order[:, None] >= 0, rows, torch.zeros_like(rows))
        groups.append(_blocks(rows, order.numel(), wk))
    v0 = 3 * p * d
    groups += [_blocks(lc[v0 + i * two_d:v0 + (i + 1) * two_d], w2, wk)
               for i in range(p * (p - 1) // 2)]
    units += [g[c, kc] for kc in range(kp) for g in groups
              for c in range(g.shape[0])]
    comb = [_blocks(ckb.comb[si], wk, w2) for si in range(p + 1)]
    units += [comb[si][kc, j] for j in range(npd) for si in range(p + 1)
              for kc in range(kp)]
    if not stats:
        inv = _blocks(ckb.binv, w2, w2)
        units += [inv[j, jo] for jo in range(npd) for j in range(npd)]
    return torch.stack(units)


def mp_circ_tc_operands(ckb: MpCircKernelBank,
                        stats: bool = False) -> MpCircTcOperands:
    """Split the bank's operands into bf16 hi / lo / lo2 and lay them out
    as the kernel's units (`MpCircTcOperands`; the stats form's without the
    inverse); once per bank (`lowered_tc` keeps them)."""
    return MpCircTcOperands(*(kernels._sw128(pl).contiguous()
                              for pl in kernels.split_planes3(
                                  mp_circ_tc_units(ckb, stats).contiguous())))


def check_units(kernel: str, ops: MpCircTcOperands, units: int, device,
                source: str) -> None:
    """Raise unless ops holds `units` units on `device`, as `source` lays
    them out."""
    shape = (units, 64, 64)
    for name, t in zip(MpCircTcOperands._fields, ops):
        if (t is None or t.device != device or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape or not t.is_contiguous()):
            got = ("None" if t is None
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"{kernel}: operand {name} must be contiguous "
                             f"torch.bfloat16 {shape} on {device} "
                             f"(`{source}`), got {got}")


def check_mp_circ_tc_operands(kernel: str, ops: MpCircTcOperands,
                              ckb: MpCircKernelBank, device) -> None:
    """Raise unless ops holds the units of a bank of ckb's shape on
    `device` (`mp_circ_tc_operands`)."""
    two_d = ckb.bfwd.shape[0]
    check_units(kernel, ops, mp_circ_units(two_d // 2, ckb.const.shape[0],
                                           ckb.comb.shape[0] - 1), device,
                "mp_circ_tc_operands")


def lowered_tc(bank: CirculantBankMP, cache: Optional[dict] = None,
               blocks=None) -> MpCircTcOperands:
    """The kernel's operands of the bank (`mp_circ_tc_operands` of its
    T = 1 layout), kept in `cache` under ("mp_circ_tc_operands", blocks)
    beside the layouts of `lowered`, so a bank served many times is split
    and laid out once."""
    key = ("mp_circ_tc_operands", blocks)
    if cache is None:
        return mp_circ_tc_operands(lowered(bank, None, blocks))
    if key not in cache:
        cache[key] = mp_circ_tc_operands(lowered(bank, cache, blocks))
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


def _six(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The six bf16 products of rows (n, c) and one c-deep chunk w (c,
    cols), both split into hi, lo, lo2, summed in the kernel's order
    (`variant_kernels.tc_products`) into a fresh float32 result."""
    return tc_products(rows, [pl.to(rows.dtype)
                              for pl in kernels.split_planes3(w)], 6)


def _kahan(total: torch.Tensor, lost: torch.Tensor, part: torch.Tensor):
    """total += part in a compensated (Kahan) sum: total - lost is the
    running value, lost the rounding error total has taken on."""
    y = part - lost
    nxt = total + y
    return nxt, (nxt - total) - y


def _chunked(rows: torch.Tensor, w: torch.Tensor, width: int):
    """rows @ w with the contraction zero-padded to `width` and cut into
    64-deep chunks, each chunk's `_six` added in order in float32."""
    rows = torch.nn.functional.pad(rows, (0, width - rows.shape[1]))
    w = torch.nn.functional.pad(w, (0, 0, 0, width - w.shape[0]))
    out = _six(rows[:, :64], w[:64])
    for c in range(64, width, 64):
        out = out + _six(rows[:, c:c + 64], w[c:c + 64])
    return out


def mp_circ_tc_reference(x2: torch.Tensor, ckb: MpCircKernelBank,
                         t_coh: int = 1, coh_alpha: float = 1.0,
                         chunk: int = 8192, stats: bool = False):
    """Plain PyTorch version of K10's arithmetic (the coherent form at
    t_coh > 1): each of the four products as the kernel cuts it, every
    64-deep chunk of the forward, combine and inverse contractions the six
    bf16 products of `_six` into a fresh float32 result, added in order;
    every 16-deep chunk of the logit's feature groups (u_p; |u_p|^2; each
    pair) likewise, added in a compensated (Kahan) sum with const, whose
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
                lg, lost = _kahan(lg, lost, _six(z[:, c:c + 16],
                                                 coef[c:c + 16]))
        lg, lost = _kahan(lg, lost, ckb.const[None])
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
                f = _six(wpad[:, c:c + 64], cpad[pi + 1, c:c + 64]).reshape(
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


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _rule(d: int, k: int, p: int, t: int) -> str:
    """The rule's statement at these widths, for the errors."""
    return (f"the multi-pilot circulant kernel takes D, K <= {CIRC_MAX_D}, "
            f"{CIRC_MAX_K}, T up to a warpgroup's live rows and a "
            f"warpgroup's u within {SMEM_BLOCK_BYTES} bytes of shared "
            f"memory beside a ring of two units; got D={d}, K={k}, P={p}, "
            f"T={t} ({mp_circ_tile_rows(d, k, p, t)} live rows, "
            f"{mp_circ_smem_bytes(d, k, p, t)} bytes at 64)")


def _launch(name: str, x2: torch.Tensor, ckb: MpCircKernelBank, t_coh: int,
            coh_alpha: float,
            ops: Optional[MpCircTcOperands]) -> torch.Tensor:
    """Validate, allocate and launch on x2's device and current stream with
    the bank's operands `ops` (laid out here when None); raise on any
    refusal."""
    n = x2.shape[0]
    two_d = ckb.bfwd.shape[0]
    d, p = two_d // 2, ckb.comb.shape[0] - 1
    k = ckb.const.shape[0]
    if n % t_coh or not mp_circ_kernel_eligible(d, k, p, t_coh):
        raise ValueError(f"{name} takes N rows of whole T-row blocks; "
                         + _rule(d, k, p, t_coh) + f", N={n}")
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


def launch_tc(name: str, x2: torch.Tensor, ops: MpCircTcOperands,
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
                     operands: Optional[MpCircTcOperands] = None
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
                              operands: Optional[MpCircTcOperands] = None
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


kernels.register_wrappers(mp_circ_estimate, mp_circ_estimate_coherent)


# ---------------------------------------------------------------------------
# entries on complex observations and multi-pilot banks
# ---------------------------------------------------------------------------

def _check_eligible(bank: CirculantBankMP, t: int) -> None:
    k, d, p = bank.mean_rf.shape
    if not mp_circ_kernel_eligible(d, k, p, t):
        raise ValueError(_rule(d, k, p, t))


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
    ops = lowered_tc(bank, cache, blocks) if r.is_cuda else None
    return _hc(mp_circ_estimate(_x2(r), lowered(bank, cache, blocks), ops),
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
    ops = lowered_tc(bank, cache, blocks) if r.is_cuda else None
    h2 = mp_circ_estimate_coherent(_x2(r), lowered(bank, cache, blocks, t,
                                                   alpha), t, alpha, ops)
    return _hc(h2, r.dtype).reshape(b, t, -1)
