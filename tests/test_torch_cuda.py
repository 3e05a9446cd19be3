"""The port's CUDA kernels (K1-K5, the circulant K6-K9, the multi-pilot
circulant K10, the factored K11-K13, and K1's variants K14a, K14b and the
floor probe K15) against their plain versions on the card, the split-K
forms' shard merges against one launch, K1 / K3, K6-K13, K14a and K14b
over many NaN-poisoned launches (`tools.tc_repeat_check`), the
kernel-measurement tools and `utils.profiling` on the card, the
estimation service on the card (one device and a 2 x 2 in-process mesh),
the inverse-EM Toeplitz fit on the card, and the quantized EM
(CSI-free training) on the card against the port on the CPU, with
`run_gmm_quant` launching its kernels, the spectra-native EM against the
CPU from one state, K6 / K7 on its spectra-fed bank, and the streamed
pilots on the card; the VAE on the card (no kernel of its own): its train
step against the CPU's on the same draws, the NaN guard, its epochs free
of host synchronization, bit-identical resume from a card checkpoint,
structured estimation against dense, and its service; the other channel
models on the card: urban-macro and Kronecker-MIMO draws in law, the
coloring factors' jitter ladder against the CPU, and a MIMO `run_gmm`
launching K1 and K3.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: 1e-4 of the output scale (max |kernel - plain| / max |plain|);
both are float32 with the products summed in another order. For the top-k
kernel, rows whose k-th and (k+1)-th logits lie within 1e-3 are left out
of the comparison: the two sums may order such near-ties differently. The
circulant kernels expand the quadratic logit, which cancels, and pool it
over T rows for K7 / K9 (K10 sums it group by group where its plain
version runs one long product); where that pushes kernel and plain version
past 1e-4 of each other, both are held against the plain version in
float64, the kernel to within twice the plain version's own error. K1 and
K3, six bf16 tensor-core products, are also held to that float64 rule
where their plain version agrees within 1e-4, since 1e-4 alone passes a
three-product split too; so is K14a, six bf16 products for each of its
three real products, and so are the factored kernels K11-K13, six bf16
products for each of their two products, and the multi-pilot K10 and, at
one pilot, K6-K9, six bf16 products for each of their four (K8 / K9 on
each of m, den and the accumulator, and on the merged quotient), and
their wide form past D = 128 (`csrc/circ_wide_estimate.cu`), K6-K9's
factorised kernel past D = 128 where the transform splits
(`csrc/circ_fact_estimate.cu`, K8 / K9 its STATS form, against its plain
version `circ_fact_reference`; the factorised and dense wide stats states
merged across the two routes), K10's wide form past the template's rule,
against its own plain version `mp_circ_wide_reference`, and K10's factorised
kernel where the transform splits and its tile fits
(`csrc/mp_circ_fact_estimate.cu`, against `mp_circ_fact_reference`). The
repeated launches of K14a, K10, K6-K9 (the wide forms and the factorised
kernels on NaN-filled outputs too) and K11-K13 are bit for bit the first.
"""
import math
import os

import numpy as np
import pytest
import torch

from quantized_channel_estimation_torch.estimators import circ_kernels as tck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as tmk)
from quantized_channel_estimation_torch.estimators import (
    variant_kernels as tvk)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.tools import tc_repeat_check

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bank(d, k, n_pilots, dev, n_dead=0, seed=0):
    a_mat = tp.pilot_matrix(d, n_pilots, 2, device=dev)
    q = tq.design_quantizer(10.0, 2).to(dev)
    return tge.prepare_bank(_gmm_params(d, k, dev, n_dead, seed), 10.0, a_mat,
                            2, q)


def _gmm_params(d, k, dev, n_dead=0, seed=0):
    """The seeded GMM of `_bank`: random covariances of trace D, zero
    means, uniform weights (n_dead of them at 1e-9)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.complex(torch.randn(k, d, d, generator=g),
                      torch.randn(k, d, d, generator=g)).to(torch.complex64)
    covs = a @ a.mH / d + torch.eye(d)
    covs = covs * (d / torch.diagonal(covs, dim1=-2, dim2=-1).real.sum(-1))[
        :, None, None]
    w = torch.full((k,), 1.0 / k)
    w[:n_dead] = 1e-9
    params = tg.GmmParams(w / w.sum(),
                          torch.zeros(k, d, dtype=torch.complex64), covs,
                          tl.robust_precision_cholesky(covs))
    return tg.GmmParams(*(x.to(dev) for x in params))


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n_pilots,n,n_dead", [
    (8, 4, 1, 1000, 0),      # 2M = 2D = 16: the narrowest instantiation
    (64, 64, 1, 4097, 3),    # main-path widths, ragged N, dead components
    (64, 8, 2, 333, 0),      # 2M = 256
    (128, 4, 1, 100, 1),     # 2M = 2D = 256
    (24, 5, 1, 50, 0),       # widths that are no multiple of 32
    (64, 64, 1, 2 * 132 * 128 + 3, 2),  # 128-row blocks, two waves
])
def test_grouped_estimate_matches_plain(d, k, n_pilots, n, n_dead):
    dev = _card()
    bank = _bank(d, k, n_pilots, dev, n_dead)
    assert int(torch.isinf(bank.log_weights).sum()) == n_dead
    kb = tkn.kernel_bank_block(bank)
    g = torch.Generator(device=dev).manual_seed(1)
    r2 = (torch.randint(0, 2, (n, 2 * d * n_pilots), generator=g,
                        device=dev).float() - 0.5) * 1.4
    before = tkn.grouped_estimate.launches
    got = tkn.grouped_estimate(r2, kb)
    torch.cuda.synchronize()
    assert tkn.grouped_estimate.launches == before + 1
    want = tkn.grouped_estimate_reference(r2, kb)
    assert got.shape == want.shape == (n, 2 * d)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-4, err


@pytest.mark.cuda
def test_grouped_estimate_refuses_bad_inputs():
    dev = _card()
    kb = tkn.kernel_bank_block(_bank(8, 4, 1, dev))
    r2 = torch.zeros(10, 16, device=dev)
    with pytest.raises(ValueError):
        tkn.grouped_estimate(r2.double(), kb)
    with pytest.raises(ValueError):
        tkn.grouped_estimate(torch.zeros(16, 10, device=dev).T, kb)
    with pytest.raises(ValueError):
        tkn.grouped_estimate(torch.zeros(10, 12, device=dev), kb)
    with pytest.raises(ValueError):
        tkn.grouped_estimate(r2, kb._replace(logw=kb.logw.cpu()))
    big = tkn.KernelBankBlock(torch.zeros(1, 2050, 2052, device=dev),
                              torch.zeros(1, 2050, device=dev),
                              torch.zeros(1, 2, device=dev),
                              torch.zeros(1, device=dev))
    with pytest.raises(ValueError, match="2048"):
        tkn.grouped_estimate(torch.zeros(3, 2050, device=dev), big)
    empty = tkn.grouped_estimate(r2[:0], kb)
    assert empty.shape == (0, 16)


@pytest.mark.cuda
def test_estimate_fused_on_card_matches_einsum_estimator():
    dev = _card()
    bank = _bank(16, 8, 1, dev, n_dead=1)
    g = torch.Generator(device=dev).manual_seed(2)
    r = torch.complex(torch.randn(500, 16, generator=g, device=dev),
                      torch.randn(500, 16, generator=g, device=dev))
    got = tkn.estimate_fused(bank, r)
    want = tge.estimate(bank, r, "all")
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-4 and not math.isnan(err)
    assert got.dtype == torch.complex64
    assert np.isfinite(got.abs().cpu().numpy()).all()


def _rows(n, width, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, 2, (n, width), generator=g,
                          device=dev).float() - 0.5) * 1.4


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n_pilots,n_blocks,t,alpha,n_dead", [
    (8, 4, 1, 500, 2, 1.0, 0),       # narrowest; blocks inside a warp
    (64, 64, 1, 1001, 4, 1.0, 3),    # main-path widths, ragged, dead
    (16, 8, 1, 100, 8, 0.25, 0),     # T = RPW, in-warp pool with blend
    (64, 64, 1, 333, 16, 0.25, 0),   # blocks across warps (shared memory)
    (64, 64, 1, 77, 64, 1.0, 0),     # T = the tile's 64 rows
    (64, 8, 2, 101, 3, 0.5, 0),      # 2M = 256 (32-row tile), T = 3
    (128, 4, 1, 50, 32, 1.0, 1),     # 2M = 2D = 256, T = the 32-row tile
    (24, 5, 1, 40, 6, 0.0, 0),       # widths no multiple of 32, alpha 0
])
def test_grouped_estimate_coherent_matches_plain(d, k, n_pilots, n_blocks, t,
                                                 alpha, n_dead):
    dev = _card()
    bank = _bank(d, k, n_pilots, dev, n_dead)
    kb = tkn.kernel_bank_block(bank, t, alpha)
    r2 = _rows(n_blocks * t, 2 * d * n_pilots, dev)
    before = tkn.grouped_estimate_coherent.launches
    got = tkn.grouped_estimate_coherent(r2, kb, t, alpha)
    torch.cuda.synchronize()
    assert tkn.grouped_estimate_coherent.launches == before + 1
    want = tkn.grouped_estimate_coherent_reference(r2, kb, t, alpha)
    assert got.shape == want.shape == (n_blocks * t, 2 * d)
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    if t <= 16:
        assert err < 1e-4, err
    else:
        # a pooled logit sums T row logits; its float32 rounding grows with
        # T and reaches the output at ~1e-4 by T = 32. Held instead: the
        # kernel is as accurate as the plain float32 version, both against
        # the plain version in float64
        exact = tkn.grouped_estimate_coherent_reference(
            r2.double(), tkn.KernelBankBlock(*(x.double() for x in kb)), t,
            alpha)
        err_kernel = float((got - exact).abs().max()) / scale
        err_plain = float((want - exact).abs().max()) / scale
        assert err_kernel <= 2 * err_plain + 1e-5, (err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("t,alpha,n_blocks", [
    (2, 1.0, 16001),    # quad-group shuffles (xor 4)
    (16, 0.5, 1001),    # a thread's two rows, then shuffles
    (64, 1.0, 301),     # a warpgroup's 64 logits through shared memory
    (5, 0.25, 2001),    # no power of two: shared memory, 60-row tiles
])
def test_grouped_estimate_coherent_pooling_routes(t, alpha, n_blocks):
    """K3 at 2M = 2D = 128 (the main path's widths, 16 components, one
    dead) through each pooling route of the wgmma stream, with 64-row
    blocks (T = 16, 5) and 128-row blocks (T = 2, 64) and a ragged last
    tile; held as in `test_grouped_estimate_coherent_matches_plain`."""
    dev = _card()
    bank = _bank(64, 16, 1, dev, n_dead=1)
    kb = tkn.kernel_bank_block(bank, t, alpha)
    r2 = _rows(n_blocks * t, 128, dev)
    before = tkn.grouped_estimate_coherent.launches
    got = tkn.grouped_estimate_coherent(r2, kb, t, alpha,
                                        tkn.tc_operands(kb))
    torch.cuda.synchronize()
    assert tkn.grouped_estimate_coherent.launches == before + 1
    want = tkn.grouped_estimate_coherent_reference(r2, kb, t, alpha)
    assert got.shape == want.shape == (n_blocks * t, 128)
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    if t <= 16:
        assert err < 1e-4, err
    else:
        exact = tkn.grouped_estimate_coherent_reference(
            r2.double(), tkn.KernelBankBlock(*(x.double() for x in kb)), t,
            alpha)
        err_kernel = float((got - exact).abs().max()) / scale
        err_plain = float((want - exact).abs().max()) / scale
        assert err_kernel <= 2 * err_plain + 1e-5, (err_kernel, err_plain)


@pytest.mark.cuda
def test_grouped_estimate_repeated_launches_match_plain():
    """K1 and K3 launched 100 times at each shape of
    `tools.tc_repeat_check.F32_SHAPES` (64- and 128-row blocks, the
    one-stage ring of the widest bank, each pooling route), each launch
    after a fill of every SM's shared memory with NaN, each bit for bit the
    first launch and held against the plain version: a race that one
    launch may not show fails here."""
    dev = _card()
    shapes = tc_repeat_check.F32_SHAPES
    n_k1 = sum(1 for s in shapes if s[5] == 1)
    before = (tkn.grouped_estimate.launches,
              tkn.grouped_estimate_coherent.launches)
    runs = tc_repeat_check.repeat_check(dev, repeats=100,
                                        modes=("f32",))["kernel"]
    assert tkn.grouped_estimate.launches == before[0] + 100 * n_k1
    assert (tkn.grouped_estimate_coherent.launches
            == before[1] + 100 * (len(shapes) - n_k1))
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
def test_grouped_estimate_keeps_fp32_accuracy(t):
    """K1 (t = 1) and K3 at T = 4 on the tools' headline bank (K = D = 64,
    2 bits, 10 dB) are no less accurate than float32: the max |error|
    against the plain version in float64 at most twice the float32 plain
    version's own. K14b's split3, which drops the 2^-16 terms yet stays
    within 1e-4 of the plain version, fails the same rule."""
    from quantized_channel_estimation_torch.tools import common
    dev = _card()
    bank, q = common.headline_bank(dev)
    kb = tkn.kernel_bank_block(bank, t, 1.0)
    r2 = tkn._r2(common.observations(dev, q, 8192))
    kb64 = type(kb)(*(x.double() for x in kb))
    if t == 1:
        got = tkn.grouped_estimate(r2, kb)
        want = tkn.grouped_estimate_reference(r2, kb)
        want64 = tkn.grouped_estimate_reference(r2.double(), kb64)
    else:
        got = tkn.grouped_estimate_coherent(r2, kb, t, 1.0)
        want = tkn.grouped_estimate_coherent_reference(r2, kb, t, 1.0)
        want64 = tkn.grouped_estimate_coherent_reference(r2.double(), kb64,
                                                         t, 1.0)

    def err(x):
        return float((x.double() - want64).abs().max())

    assert torch.isfinite(got).all()
    assert err(got) <= 2 * err(want), (err(got), err(want))
    if t == 1:
        split3 = tvk.grouped_tc_split3(r2, kb, tkn.split_planes(kb.pw))
        assert _rel(split3, want) < 1e-4
        assert err(split3) > 2 * err(want), (err(split3), err(want))


def _near_tie_rows(r2, kb, k_sel, gap=1e-3):
    """Rows whose k-th and (k+1)-th logits lie within `gap`: float32 sums
    in another order may order them differently."""
    lg = tkn.component_logits(r2, kb).sort(-1, descending=True).values
    if k_sel >= lg.shape[1]:
        return torch.zeros(lg.shape[0], dtype=torch.bool, device=lg.device)
    return (lg[:, k_sel - 1] - lg[:, k_sel]) < gap


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n_pilots,n,k_sel,n_dead", [
    (8, 4, 1, 1000, 1, 0),
    (64, 64, 1, 4097, 1, 3),
    (64, 64, 1, 4097, 2, 0),
    (64, 64, 1, 777, 4, 5),
    (64, 64, 1, 1000, 8, 0),
    (64, 8, 2, 333, 3, 0),       # 2M = 256
    (128, 4, 1, 100, 3, 1),      # 2M = 2D = 256, k = the live count
    (24, 5, 1, 50, 4, 0),        # widths no multiple of 32
    (64, 64, 1, 1, 1, 0),        # N = 1
    (64, 1, 1, 300, 1, 0),       # K = 1
    (64, 64, 1, 127, 4, 0),      # a 128-row tile less one
    (64, 64, 1, 129, 2, 0),      # a tile and one row
    (64, 8, 1, 500, 1, 7),       # all but one component at weight 1e-9
    (16, 8, 1, 257, 8, 0),       # 2M = 32: a 256-row tile and one, k = K = 8
])
def test_grouped_estimate_topk_matches_plain(d, k, n_pilots, n, k_sel,
                                             n_dead):
    dev = _card()
    bank = _bank(d, k, n_pilots, dev, n_dead)
    kb = tkn.kernel_bank_block(bank)
    r2 = _rows(n, 2 * d * n_pilots, dev)
    before = tkn.grouped_estimate_topk.launches
    got = tkn.grouped_estimate_topk(r2, kb, k_sel)
    torch.cuda.synchronize()
    assert tkn.grouped_estimate_topk.launches == before + 1
    want = tkn.grouped_estimate_topk_reference(r2, kb, k_sel)
    assert got.shape == want.shape == (n, 2 * d)
    assert torch.isfinite(got).all()
    keep = ~_near_tie_rows(r2, kb, k_sel)
    assert int(keep.sum()) > 0.9 * n
    err = float((got - want)[keep].abs().max() / want.abs().max())
    assert err < 1e-4, err


@pytest.mark.cuda
def test_coherent_and_topk_refuse_bad_inputs():
    dev = _card()
    bank = _bank(8, 4, 1, dev)
    kb = tkn.kernel_bank_block(bank)
    r2 = torch.zeros(12, 16, device=dev)
    for t in (1, 5, 65):            # T = 1, N % T != 0, T > the tile
        with pytest.raises(ValueError, match="T"):
            tkn.grouped_estimate_coherent(r2 if t != 65 else
                                          torch.zeros(130, 16, device=dev),
                                          kb, t)
    for k_sel in (0, 5, 9):         # k < 1, k > K, k > 8
        with pytest.raises(ValueError, match="k"):
            tkn.grouped_estimate_topk(r2, kb, k_sel)
    with pytest.raises(ValueError):
        tkn.grouped_estimate_topk(r2.double(), kb, 1)
    assert tkn.grouped_estimate_coherent(r2[:0], kb, 2).shape == (0, 16)
    assert tkn.grouped_estimate_topk(r2[:0], kb, 2).shape == (0, 16)


# ------------------------------------- the split-K stats kernels K2 and K5

# 2M and 2D of each template instantiation (csrc/grouped_estimate.cu and
# csrc/grouped_topk.cu dispatch on columns a lane: 2 up to 64, 4 up to 128,
# 8 up to 256)
WIDTH_OF_COLS = {2: 40, 4: 128, 8: 256}
K2_COLS = [(2, 2), (2, 4), (4, 2), (4, 4), (2, 8), (8, 2), (4, 8), (8, 4),
           (8, 8)]
K5_COLS = [(cp, cw) for cp in (2, 4, 8) for cw in (2, 4, 8)]


def _rand_kb(two_m, two_d, k, dev, n_dead=0, seed=0):
    """A random kernel bank of any widths (the stats kernels need no GMM):
    logits of a few units' spread at every width (pooled over 16 rows they
    stay within float32's reach of the plain version), dead components at
    the -1e30 floor."""
    g = torch.Generator().manual_seed(seed)
    pw = 0.3 * torch.randn(k, two_m, two_m + two_d,
                           generator=g) / math.sqrt(two_m)
    logw = 0.5 * torch.randn(k, generator=g)
    logw[:n_dead] = -1e30
    kb = tkn.KernelBankBlock(pw, 0.3 * torch.randn(k, two_m, generator=g),
                             torch.randn(k, two_d, generator=g), logw)
    return tkn.KernelBankBlock(*(x.to(dev).contiguous() for x in kb))


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _near_order_ties(r2, kb, k_sel, gap=1e-3):
    """Rows whose top k_sel + 1 logits hold two within `gap` of each other
    but not equal: float32 sums in another order may order them
    differently, and K5 writes its candidates in that order. Dead
    components sit exactly at the -1e30 floor in both, ordered by index."""
    lg = tkn.component_logits(r2, kb).sort(-1, descending=True).values
    top = lg[:, :k_sel + 1]
    gaps = top[:, :-1] - top[:, 1:]
    return ((gaps > 0) & (gaps < gap)).any(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("cp,cw", K2_COLS)
def test_grouped_estimate_stats_match_plain_at_every_width(cp, cw):
    """K2 flat (ragged N, dead components) and coherent (T = 4 at alpha
    0.5, pooled in a warp; T = 16 at alpha 1, pooled through shared memory)
    at each instantiation: each
    of m, den, acc against the plain version, and two shards merged with
    `merge_stats` against one K1 / K3 launch over the whole bank."""
    dev = _card()
    two_m, two_d = WIDTH_OF_COLS[cp], WIDTH_OF_COLS[cw]
    kb = _rand_kb(two_m, two_d, 6, dev, n_dead=2)
    halves = [tkn.KernelBankBlock(*(x[lo:lo + 3] for x in kb))
              for lo in (0, 3)]
    for t, alpha, n in ((1, 1.0, 1001), (4, 0.5, 4 * 251),
                        (16, 1.0, 16 * 77)):
        r2 = _rows(n, two_m, dev)
        # a random bank's logw stands for the coherent layout's divided one
        if t == 1:
            launch, plain = tkn.grouped_estimate_stats, \
                tkn.grouped_estimate_stats_reference
            args, whole = (), tkn.grouped_estimate(r2, kb)
        else:
            launch, plain = tkn.grouped_estimate_coherent_stats, \
                tkn.grouped_estimate_coherent_stats_reference
            args = (t, alpha)
            whole = tkn.grouped_estimate_coherent(r2, kb, t, alpha)
        before = launch.launches
        states = [launch(r2, h, *args) for h in halves]
        torch.cuda.synchronize()
        assert launch.launches == before + 2
        for h, got in zip(halves, states):
            for g_part, w_part in zip(got, plain(r2, h, *args)):
                assert g_part.shape == w_part.shape
                assert torch.isfinite(g_part).all()
                assert _rel(g_part, w_part) < 1e-4
        _, den, acc = tkn.merge_stats(*zip(*states))
        assert _rel(acc / den[:, None], whole) < 1e-4
        _, den, acc = launch(r2, kb, *args)
        assert _rel(acc / den[:, None], whole) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cp,cw", K5_COLS)
def test_grouped_estimate_topk_stats_match_plain_at_every_width(cp, cw):
    """K5 at each instantiation for k in {1, 3, 8}: the candidates against
    the plain version (rows with near-ties among the top k + 1 logits left
    out), and two shards merged with `merge_topk` against one K4 launch
    (rows near a tie at the k-th place left out)."""
    dev = _card()
    two_m, two_d = WIDTH_OF_COLS[cp], WIDTH_OF_COLS[cw]
    kb = _rand_kb(two_m, two_d, 16, dev, n_dead=3, seed=cp * 10 + cw)
    halves = [tkn.KernelBankBlock(*(x[lo:lo + 8] for x in kb))
              for lo in (0, 8)]
    r2 = _rows(777, two_m, dev)
    for k_sel in (1, 3, 8):
        before = tkn.grouped_estimate_topk_stats.launches
        cands = [tkn.grouped_estimate_topk_stats(r2, h, k_sel)
                 for h in halves]
        torch.cuda.synchronize()
        assert tkn.grouped_estimate_topk_stats.launches == before + 2
        for h, (l, z) in zip(halves, cands):
            l_p, z_p = tkn.grouped_estimate_topk_stats_reference(r2, h, k_sel)
            assert l.shape == (777, k_sel) and z.shape == (777, k_sel, two_d)
            keep = ~_near_order_ties(r2, h, k_sel)
            assert int(keep.sum()) > 0.8 * 777
            assert _rel(l[keep], l_p[keep]) < 1e-4
            assert _rel(z[keep], z_p[keep]) < 1e-4
        got = tkn.merge_topk(*zip(*cands), k_sel)
        want = tkn.grouped_estimate_topk(r2, kb, k_sel)
        keep = ~_near_tie_rows(r2, kb, k_sel)
        assert _rel(got[keep], want[keep]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("two_m,two_d,k,n,k_sel,n_dead", [
    (128, 128, 1, 1, 8, 0),     # N = 1, K = 1: seven empty slots
    (128, 128, 5, 127, 8, 0),   # K = 5 < k = 8; a 128-row tile less one
    (128, 128, 6, 129, 3, 5),   # all but one component dead; a tile + 1
    (40, 40, 3, 255, 8, 0),     # the 256-row tile of 2M <= 64, less one
    (256, 256, 4, 65, 8, 1),    # the 64-row tile of 2M = 256, and one
])
def test_grouped_estimate_topk_stats_at_the_tile_edges(two_m, two_d, k, n,
                                                       k_sel, n_dead):
    """K5 at the edges of its tiles and of its k range: the candidates
    against the plain version (rows with near-ties left out), the empty
    slots of a bank smaller than k at -inf and zeros in both."""
    dev = _card()
    kb = _rand_kb(two_m, two_d, k, dev, n_dead=n_dead, seed=k + n)
    r2 = _rows(n, two_m, dev)
    before = tkn.grouped_estimate_topk_stats.launches
    l, z = tkn.grouped_estimate_topk_stats(r2, kb, k_sel)
    torch.cuda.synchronize()
    assert tkn.grouped_estimate_topk_stats.launches == before + 1
    l_p, z_p = tkn.grouped_estimate_topk_stats_reference(r2, kb, k_sel)
    assert l.shape == (n, k_sel) and z.shape == (n, k_sel, two_d)
    assert torch.equal(torch.isinf(l), torch.isinf(l_p))
    assert bool((z[:, k:] == 0).all())
    keep = ~_near_order_ties(r2, kb, k_sel)
    assert int(keep.sum()) > 0.8 * n
    live = torch.isfinite(l_p[keep])
    assert _rel(l[keep][live], l_p[keep][live]) < 1e-4
    assert _rel(z[keep], z_p[keep]) < 1e-4


@pytest.mark.cuda
def test_stats_kernels_refuse_bad_inputs_and_one_past_the_rule():
    """The widths' edge (2M = 2048 runs, in the wide form past 2M, 2D =
    256; 2050 is refused by the wrappers and taken by the einsum stats
    path in the entries; K5 takes the same widths, its wide form past 256),
    K5's k range and a shard smaller than k (padded with -inf and
    zeros)."""
    dev = _card()
    kb = _rand_kb(16, 16, 3, dev)
    r2 = _rows(12, 16, dev)
    for k_sel in (0, 9):
        with pytest.raises(ValueError, match="k"):
            tkn.grouped_estimate_topk_stats(r2, kb, k_sel)
    l, z = tkn.grouped_estimate_topk_stats(r2, kb, 5)
    l_p, z_p = tkn.grouped_estimate_topk_stats_reference(r2, kb, 5)
    assert torch.isinf(l[:, 3:]).all() and bool((z[:, 3:] == 0).all())
    assert torch.equal(torch.isinf(l_p), torch.isinf(l))
    assert _rel(z, z_p) < 1e-4
    with pytest.raises(ValueError, match="T"):
        tkn.grouped_estimate_coherent_stats(r2, kb, 5)
    wide = _rand_kb(2050, 16, 2, dev)
    with pytest.raises(ValueError, match="2048"):
        tkn.grouped_estimate_stats(_rows(3, 2050, dev), wide)
    with pytest.raises(ValueError, match="2048"):
        tkn.grouped_estimate_topk_stats(_rows(3, 2050, dev),
                                        _rand_kb(2050, 16, 2, dev), 2)
    kb258 = _rand_kb(258, 16, 2, dev)
    for got, want in zip(tkn.grouped_estimate_topk_stats(_rows(3, 258, dev),
                                                         kb258, 2),
                         tkn.grouped_estimate_topk_stats_reference(
                             _rows(3, 258, dev), kb258, 2)):
        assert _rel(got, want) < 1e-4
    edge = _rand_kb(2048, 16, 2, dev)
    before = tkn.grouped_estimate_stats_wide.launches
    for got, want in zip(tkn.grouped_estimate_stats(_rows(70, 2048, dev),
                                                    edge),
                         tkn.grouped_estimate_stats_reference(
                             _rows(70, 2048, dev), edge)):
        assert _rel(got, want) < 1e-4
    assert tkn.grouped_estimate_stats_wide.launches == before + 1
    for m_out, _, acc in (tkn.grouped_estimate_stats(r2[:0], kb),
                          tkn.grouped_estimate_coherent_stats(r2[:0], kb, 2)):
        assert m_out.shape == (0,) and acc.shape == (0, 16)
    # the entries past the rule: the einsum stats path, on the card
    bank = _bank(8, 4, 129, dev)                     # M = 1032: 2M = 2064
    assert not tkn.fused_kernel_eligible(8, 1032)
    g = torch.Generator(device=dev).manual_seed(4)
    r = torch.complex(torch.randn(64, 1032, generator=g, device=dev),
                      torch.randn(64, 1032, generator=g, device=dev))
    before = tkn.launch_counts()
    for got, want in zip(tkn.estimate_fused_stats(bank, r),
                         tge.estimate_stats(bank, r)):
        assert _rel(got, want) < 1e-5
    assert tkn.launch_counts() == before
    with pytest.raises(ValueError, match="256"):
        tkn.estimate_fused_topk_stats(bank, r, 2)


@pytest.mark.cuda
def test_f1_wide_dense_bank_takes_the_einsum_estimator():
    """Fault F1: a dense bank past the dense kernels' widths (2M = 2064:
    129 pilots at D = 8) through `stages.estimate_auto` and
    `kernels.estimate_fused_coherent` at T = 1 returns the einsum
    estimator's answer instead of raising, and launches no kernel."""
    dev = _card()
    bank = _bank(8, 4, 129, dev, n_dead=1)
    g = torch.Generator(device=dev).manual_seed(5)
    r = torch.complex(torch.randn(512, 1032, generator=g, device=dev),
                      torch.randn(512, 1032, generator=g, device=dev))
    want = tge.estimate(bank, r, "all")
    before = tkn.launch_counts()
    for got in (stages.estimate_auto(bank, r, "all"),
                tkn.estimate_fused_coherent(bank, r[:, None])[:, 0],
                stages.estimate_coherent_auto(bank, r[:, None], "all")[:, 0]):
        assert got.shape == want.shape and torch.isfinite(got.abs()).all()
        assert _rel(got, want) < 1e-5
    assert tkn.launch_counts() == before


@pytest.mark.cuda
def test_wide_dense_bank_takes_the_wide_kernels():
    """A dense bank with 2M = 512 (four pilots, D = 64, one dead
    component) through `stages.estimate_auto`, the coherent entries at T =
    1 and 4 and the stats entries: the wide K1, K3 and K2, within 1e-4 of
    the einsum estimator's scale, no einsum call and no launch of the
    stream's K1 - K3. The T = 4 blocks pool four logits of a few hundred
    each, which moves any two float32 versions about 1e-4 apart: past
    1e-4 of the einsum estimator they are held, as chip_smoke's
    `compare64`, to twice the plain float32 version's error against its
    float64 evaluation."""
    dev = _card()
    bank = _bank(64, 8, 4, dev, n_dead=1)
    g = torch.Generator(device=dev).manual_seed(5)
    r = torch.complex(torch.randn(2048, 256, generator=g, device=dev),
                      torch.randn(2048, 256, generator=g, device=dev))
    want = tge.estimate(bank, r, "all")
    rb = r.reshape(512, 4, 256)
    want_b = tge.estimate_coherent(bank, rb, "all", 512, 0.5)
    names = ("estimate", "estimate_coherent", "estimate_stats",
             "estimate_coherent_stats")
    saved = {n: getattr(tge, n) for n in names}

    def refuse(*args, **kwargs):
        raise AssertionError("the einsum estimator was reached")

    before = tkn.launch_counts()
    try:
        for n in names:
            setattr(tge, n, refuse)
        got = [stages.estimate_auto(bank, r, "all"),
               tkn.estimate_fused_coherent(bank, r[:, None])[:, 0],
               stages.estimate_coherent_auto(bank, r[:, None], "all")[:, 0]]
        got_b = tkn.estimate_fused_coherent(bank, rb, 0.5)
        _, den, acc = tkn.estimate_fused_stats(bank, r)
        _, den_b, acc_b = tkn.estimate_fused_coherent_stats(bank, rb, 0.5)
    finally:
        for n, fn in saved.items():
            setattr(tge, n, fn)
    for x in got + [acc / den[:, None]]:
        assert x.shape == want.shape and _rel(x, want) < 1e-4
    kb4 = tkn.kernel_bank_block(bank, 4, 0.5)
    r2b = tkn._r2(rb)
    plain = tkn._h(tkn.grouped_estimate_coherent_reference(r2b, kb4, 4, 0.5),
                   64, torch.complex128).reshape(want_b.shape)
    exact = tkn._h(tkn.grouped_estimate_coherent_reference(
        r2b.double(), tkn.KernelBankBlock(*(x.double() for x in kb4)), 4,
        0.5), 64, torch.complex128).reshape(want_b.shape)

    def err(x):
        return float((x.to(torch.complex128) - exact).abs().max())

    for x in (got_b, acc_b / den_b[..., None]):
        assert x.shape == want_b.shape
        assert _rel(x, want_b) < 1e-4 or err(x) <= 2 * err(plain), (
            _rel(x, want_b), err(x), err(plain))
    after = tkn.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"grouped_estimate_wide": 3,
                     "grouped_estimate_coherent_wide": 1,
                     "grouped_estimate_stats_wide": 1,
                     "grouped_estimate_coherent_stats_wide": 1}, moved


# the wide form: (2M, 2D, K, N, dead components)
WIDE_CASES = [
    (512, 512, 4, 1000, 1),     # D = 256 at one pilot: four column slices
    (512, 128, 5, 777, 0),      # four pilots at D = 64
    (640, 128, 3, 1201, 1),     # five pilots at D = 64: 2M = 640
    (512, 256, 4, 333, 0),      # two pilots at D = 128
    (400, 400, 3, 2 * 132 * 128 + 5, 2),   # no multiple of 64, two waves
    (272, 16, 6, 500, 0),       # just past the stream's 2M
    (16, 300, 2, 130, 0),       # just past the stream's 2D, odd pieces
]


@pytest.mark.cuda
@pytest.mark.parametrize("two_m,two_d,k,n,n_dead", WIDE_CASES)
def test_grouped_wide_matches_plain(two_m, two_d, k, n, n_dead):
    """The wide K1, K2 (flat, and coherent at T = 4, alpha 0.5) and K3 (T
    = 4, alpha 1; T = 3, alpha 0.25) against their plain versions within
    1e-4 of the scale, ragged N and dead components; K2 on two component
    shards merged with `merge_stats` against one wide K1 launch; the
    stream's own wrappers route there and count nothing of their own."""
    dev = _card()
    kb = _rand_kb(two_m, two_d, k, dev, n_dead)
    ops = tkn.tc_operands(kb)
    r2 = _rows(n, two_m, dev)
    before = tkn.launch_counts()
    got = tkn.grouped_estimate(r2, kb, ops)
    want = tkn.grouped_estimate_reference(r2, kb)
    assert got.shape == want.shape == (n, two_d)
    assert torch.isfinite(got).all() and _rel(got, want) < 1e-4
    for g_x, w_x in zip(tkn.grouped_estimate_stats(r2, kb, ops),
                        tkn.grouped_estimate_stats_reference(r2, kb)):
        assert _rel(g_x, w_x) < 1e-4
    half = k // 2
    shards = [tkn.KernelBankBlock(*(x[sl].contiguous() for x in kb))
              for sl in (slice(0, half), slice(half, k))]
    _, den, acc = tkn.merge_stats(*zip(*(tkn.grouped_estimate_stats_wide(
        r2, s) for s in shards)))
    assert _rel(acc / den[:, None], got) < 1e-5
    for t, alpha in ((4, 1.0), (3, 0.25)):
        rows = r2[:n // t * t]
        kb_t = kb._replace(logw=kb.logw / (1 - alpha + alpha * t))
        got_t = tkn.grouped_estimate_coherent(rows, kb_t, t, alpha, ops)
        want_t = tkn.grouped_estimate_coherent_reference(rows, kb_t, t,
                                                         alpha)
        assert torch.isfinite(got_t).all() and _rel(got_t, want_t) < 1e-4
    rows = r2[:n // 4 * 4]
    for g_x, w_x in zip(
            tkn.grouped_estimate_coherent_stats(rows, kb, 4, 0.5, ops),
            tkn.grouped_estimate_coherent_stats_reference(rows, kb, 4, 0.5)):
        assert _rel(g_x, w_x) < 1e-4
    after = tkn.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"grouped_estimate_wide": 1,
                     "grouped_estimate_stats_wide": 3,
                     "grouped_estimate_coherent_wide": 2,
                     "grouped_estimate_coherent_stats_wide": 1}, moved


@pytest.mark.cuda
@pytest.mark.parametrize("two_m,t", [(512, 1), (640, 3), (400, 16)])
def test_grouped_wide_row_planes_read_back_bit_for_bit(two_m, t):
    """The wide form's first kernel lays r2's three bf16 planes out as its
    plain version `wide_row_planes` does, bit for bit (padding zero)."""
    dev = _card()
    r2 = torch.randn(3 * 64 + 7 - (3 * 64 + 7) % t, two_m, device=dev)
    got = tkn.wide_row_planes(r2, t)
    want = tkn.wide_row_planes(r2.cpu(), t)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_pilots,k,t", [
    (256, 1, 4, 1), (64, 4, 4, 1), (256, 1, 4, 4), (64, 5, 4, 4),
    (64, 7, 4, 1), (64, 7, 4, 4),       # 2M = 896: JAX's chunk rule at K = 4
    (128, 7, 2, 1), (128, 7, 2, 4),     # 2M = 1792: JAX's whole-bank rule
])
def test_grouped_wide_keeps_fp32_accuracy(d, n_pilots, k, t):
    """The wide K1 (t = 1) and K3 (T = 4) on GMM banks at 2M = 512, 640,
    896 and 1792 (2 bits, 10 dB): max |error| against the plain version in
    float64 at most twice the float32 plain version's own; K1 also within
    1e-4 of the plain version's scale, and K2 on two component shards,
    merged with `merge_stats`, held to the same float64 rule (K3 pools
    four logits of a few hundred each, which moves both float32 versions
    apart by about that much, so the float64 rule alone holds it, as
    chip_smoke's `compare64` holds K3 past T = 16)."""
    dev = _card()
    bank = _bank(d, k, n_pilots, dev, n_dead=1 if k > 2 else 0)
    kb = tkn.kernel_bank_block(bank, t, 1.0)
    kb64 = type(kb)(*(x.double() for x in kb))
    r2 = _rows(2048, 2 * d * n_pilots, dev)
    if t == 1:
        got = tkn.grouped_estimate(r2, kb)
        want = tkn.grouped_estimate_reference(r2, kb)
        want64 = tkn.grouped_estimate_reference(r2.double(), kb64)
    else:
        got = tkn.grouped_estimate_coherent(r2, kb, t, 1.0)
        want = tkn.grouped_estimate_coherent_reference(r2, kb, t, 1.0)
        want64 = tkn.grouped_estimate_coherent_reference(r2.double(), kb64,
                                                         t, 1.0)

    def err(x):
        return float((x.double() - want64).abs().max())

    assert torch.isfinite(got).all()
    assert t > 1 or _rel(got, want) < 1e-4, _rel(got, want)
    assert err(got) <= 2 * err(want), (err(got), err(want))
    if t == 1:
        shards = [tkn.KernelBankBlock(*(x[sl].contiguous() for x in kb))
                  for sl in (slice(0, k // 2), slice(k // 2, k))]
        _, den, acc = tkn.merge_stats(*zip(*(
            tkn.grouped_estimate_stats(r2, s) for s in shards)))
        merged = acc / den[:, None]
        assert torch.isfinite(merged).all()
        assert err(merged) <= 2 * err(want), (err(merged), err(want))


@pytest.mark.cuda
def test_grouped_wide_repeated_launches_match_plain():
    """The wide K1 and K3 launched 20 times at each shape of
    `tools.tc_repeat_check.WIDE_SHAPES`, each launch after a fill of every
    SM's shared memory with NaN, each bit for bit the first launch and held
    against the plain version."""
    dev = _card()
    shapes = tc_repeat_check.WIDE_SHAPES
    n_k1 = sum(1 for s in shapes if s[5] == 1)
    before = (tkn.grouped_estimate_wide.launches,
              tkn.grouped_estimate_coherent_wide.launches)
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("wide",))["kernel"]
    assert tkn.grouped_estimate_wide.launches == before[0] + 20 * n_k1
    assert (tkn.grouped_estimate_coherent_wide.launches
            == before[1] + 20 * (len(shapes) - n_k1))
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


# the wide K4 / K5: (2M, 2D, K, N, k, dead components)
WIDE_TOPK_CASES = [
    (512, 512, 32, 1000, 1, 2),     # D = 256 at one pilot
    (512, 512, 32, 1000, 4, 2),
    (512, 128, 5, 777, 4, 0),       # four pilots at D = 64
    (640, 128, 9, 1201, 8, 1),      # five pilots at D = 64, k = 8
    (400, 400, 6, 2 * 132 * 128 + 5, 3, 2),  # no multiple of 64, 2 waves
    (272, 16, 6, 500, 5, 0),        # just past the stream's 2M, k = K - 1
    (16, 300, 2, 130, 1, 0),        # just past the stream's 2D
    (2048, 16, 3, 70, 2, 0),        # the edge 2M = 2048
]
WIDE_TIE_REL = 1e-5   # the wide cases' tie gap: 1e-5 of the logit, >= 1e-3


def _wide_keep(r2, kb, k_sel, order=False):
    """Rows the wide top-k is compared on: those whose k-th and (k+1)-th
    logits (`order`: any two of the top k + 1) are further apart than
    max(1e-3, 1e-5 |logit|). At 2M = 512 a logit is a sum of hundreds of
    squares and reaches the hundreds, where 1e-3 is a few float32 ulps."""
    lg = tkn.component_logits(r2, kb)
    if not order:
        return ~tc_repeat_check.topk_near_ties(lg, k_sel, 1e-3, WIDE_TIE_REL)
    top = lg.sort(-1, descending=True).values[:, :k_sel + 1]
    gaps = top[:, :-1] - top[:, 1:]
    return ~((gaps < torch.clamp(WIDE_TIE_REL * top[:, :-1].abs(), min=1e-3))
             & (top[:, 1:] > -1e29)).any(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("two_m,two_d,k,n,k_sel,n_dead", WIDE_TOPK_CASES)
def test_grouped_wide_topk_matches_plain(two_m, two_d, k, n, k_sel, n_dead):
    """The wide K4 and K5 against their plain versions within 1e-4 of the
    scale on the rows not near a tie (at least 90%), through the narrow
    wrappers, which route there; K5's candidates on the rows without a
    near tie among the top k + 1."""
    dev = _card()
    kb = _rand_kb(two_m, two_d, k, dev, n_dead, seed=two_m + k)
    ops = tkn.tc_operands(kb)
    r2 = _rows(n, two_m, dev)
    before = tkn.launch_counts()
    got = tkn.grouped_estimate_topk(r2, kb, k_sel, ops)
    l, z = tkn.grouped_estimate_topk_stats(r2, kb, k_sel, ops)
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    moved = {x: after[x] - before[x] for x in after if after[x] != before[x]}
    assert moved == {"grouped_estimate_topk_wide": 1,
                     "grouped_estimate_topk_stats_wide": 1}, moved
    want = tkn.grouped_estimate_topk_reference(r2, kb, k_sel)
    assert got.shape == want.shape == (n, two_d)
    assert torch.isfinite(got).all()
    keep = _wide_keep(r2, kb, k_sel)
    assert int(keep.sum()) >= 0.9 * n
    assert _rel(got[keep], want[keep]) < 1e-4
    l_p, z_p = tkn.grouped_estimate_topk_stats_reference(r2, kb, k_sel)
    assert l.shape == (n, k_sel) and z.shape == (n, k_sel, two_d)
    keep = _wide_keep(r2, kb, k_sel, order=True)
    assert int(keep.sum()) >= 0.8 * n
    assert _rel(l[keep], l_p[keep]) < 1e-4
    assert _rel(z[keep], z_p[keep]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_pilots,k,k_sel", [
    (256, 1, 32, 1), (256, 1, 32, 4), (64, 5, 8, 1), (64, 5, 8, 4),
])
def test_grouped_wide_topk_keeps_fp32_accuracy(d, n_pilots, k, k_sel):
    """The wide K4 on GMM banks at 2M = 512 and 640 (2 bits, 10 dB, one
    dead component): on the rows not near a tie (at least 90%) it picks
    the components the plain version in float64 picks, and its max |error|
    against that float64 version is at most twice the float32 plain
    version's own."""
    dev = _card()
    bank = _bank(d, k, n_pilots, dev, n_dead=1)
    kb = tkn.kernel_bank_block(bank)
    kb64 = type(kb)(*(x.double() for x in kb))
    r2 = _rows(2048, 2 * d * n_pilots, dev)
    got = tkn.grouped_estimate_topk(r2, kb, k_sel)
    want = tkn.grouped_estimate_topk_reference(r2, kb, k_sel)
    want64 = tkn.grouped_estimate_topk_reference(r2.double(), kb64, k_sel)
    keep = _wide_keep(r2, kb, k_sel)
    assert int(keep.sum()) >= 0.9 * r2.shape[0]
    l, _ = tkn.grouped_estimate_topk_stats(r2, kb, k_sel)
    lg64 = tkn.component_logits(r2.double(), kb64)
    picked = lg64.sort(dim=-1, descending=True, stable=True).indices[:, :k_sel]
    mine = (tkn.component_logits(r2, kb)
            .sort(dim=-1, descending=True, stable=True).indices[:, :k_sel])
    assert torch.isfinite(l).all()
    assert torch.equal(picked[keep].sort(-1).values,
                       mine[keep].sort(-1).values)

    def err(x):
        return float((x.double() - want64)[keep].abs().max())

    assert torch.isfinite(got).all()
    assert _rel(got[keep], want[keep]) < 1e-4
    assert err(got) <= 2 * err(want), (err(got), err(want))


@pytest.mark.cuda
@pytest.mark.parametrize("k,k_sel,n_dead", [(32, 1, 2), (32, 4, 2), (6, 4, 1)])
def test_wide_topk_shards_merge_to_one_launch(k, k_sel, n_dead):
    """The wide K5 on two component shards (at K = 6 and k = 4 each shard
    holds fewer components than k: its empty slots at -inf and zeros, as
    the plain version's), each against the plain version, merged with
    `merge_topk` within 1e-5 of one wide K4 launch (2M = 2D = 512)."""
    dev = _card()
    kb = _rand_kb(512, 512, k, dev, n_dead, seed=k + k_sel)
    r2 = _rows(1500, 512, dev)
    shards = [tkn.KernelBankBlock(*(x[sl].contiguous() for x in kb))
              for sl in (slice(0, k // 2), slice(k // 2, k))]
    cands = []
    for shard in shards:
        l, z = tkn.grouped_estimate_topk_stats_wide(r2, shard, k_sel)
        l_p, z_p = tkn.grouped_estimate_topk_stats_reference(r2, shard,
                                                             k_sel)
        assert torch.equal(torch.isinf(l), torch.isinf(l_p))
        assert bool((z[:, k // 2:] == 0).all())
        keep = _wide_keep(r2, shard, k_sel, order=True)
        assert int(keep.sum()) >= 0.8 * r2.shape[0]
        live = torch.isfinite(l_p[keep])
        assert _rel(l[keep][live], l_p[keep][live]) < 1e-4
        assert _rel(z[keep], z_p[keep]) < 1e-4
        cands.append((l, z))
    merged = tkn.merge_topk(*zip(*cands), k_sel)
    one = tkn.grouped_estimate_topk_wide(r2, kb, k_sel)
    keep = _wide_keep(r2, kb, k_sel)
    assert int(keep.sum()) >= 0.9 * r2.shape[0]
    assert _rel(merged[keep], one[keep]) < 1e-5


@pytest.mark.cuda
def test_wide_topk_refuses_one_past_the_rule():
    """2M = 2050 is refused by every top-k wrapper and entry, k outside
    its range too; 2M = 2048 runs; N = 0 launches nothing."""
    dev = _card()
    kb = _rand_kb(2050, 16, 3, dev)
    r2 = _rows(5, 2050, dev)
    for fn in (tkn.grouped_estimate_topk, tkn.grouped_estimate_topk_stats,
               tkn.grouped_estimate_topk_wide,
               tkn.grouped_estimate_topk_stats_wide):
        with pytest.raises(ValueError, match="2048"):
            fn(r2, kb, 1)
    bank = _bank(8, 4, 129, dev)                     # M = 1032: 2M = 2064
    assert not tkn.topk_kernel_eligible(bank, 1)
    r = torch.complex(_rows(4, 1032, dev), _rows(4, 1032, dev, seed=2))
    with pytest.raises(ValueError, match="2048"):
        tkn.estimate_fused_topk(bank, r, 1)
    with pytest.raises(ValueError, match="2048"):
        tkn.estimate_fused_topk_stats(bank, r, 1)
    kb = _rand_kb(512, 512, 3, dev)
    r2 = _rows(5, 512, dev)
    for k_sel in (0, 4, 9):                         # k > K for K4, k > 8
        with pytest.raises(ValueError, match="k"):
            tkn.grouped_estimate_topk_wide(r2, kb, k_sel)
    with pytest.raises(ValueError, match="k"):
        tkn.grouped_estimate_topk_stats_wide(r2, kb, 9)
    before = tkn.launch_counts()
    assert tkn.grouped_estimate_topk_wide(r2[:0], kb, 2).shape == (0, 512)
    l, z = tkn.grouped_estimate_topk_stats_wide(r2[:0], kb, 2)
    assert l.shape == (0, 2) and z.shape == (0, 2, 512)
    assert tkn.launch_counts() == before
    edge = _rand_kb(2048, 16, 3, dev)
    r2 = _rows(70, 2048, dev)
    assert _rel(tkn.grouped_estimate_topk(r2, edge, 2),
                tkn.grouped_estimate_topk_reference(r2, edge, 2)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k_sel", [1, 4])
def test_wide_topk_cuts_rows_to_its_scratch(monkeypatch, k_sel):
    """Past `WIDE_SCRATCH` the wide K4 and K5 run in row chunks, one
    counted launch each, bit for bit the one launch's outputs (a scratch
    of a few rows' worth here: 1000 rows in chunks of 256 for K4)."""
    dev = _card()
    kb = _rand_kb(512, 512, 6, dev, 1, seed=k_sel)
    r2 = _rows(1000, 512, dev)
    whole = (tkn.grouped_estimate_topk_wide(r2, kb, k_sel),
             *tkn.grouped_estimate_topk_stats_wide(r2, kb, k_sel))
    planes = 6 * 512
    per_row = (planes * (k_sel + 1) + 4 * (6 + 3 * k_sel)
               + (4 * k_sel * 512 if k_sel > 1 else 0))
    monkeypatch.setattr(tkn, "WIDE_SCRATCH",
                        (planes + 4) * 128 * 6 + 256 * per_row)
    before = (tkn.grouped_estimate_topk_wide.launches,
              tkn.grouped_estimate_topk_stats_wide.launches)
    cut = (tkn.grouped_estimate_topk_wide(r2, kb, k_sel),
           *tkn.grouped_estimate_topk_stats_wide(r2, kb, k_sel))
    chunks = [-(-1000 // tkn._wide_topk_rows(1000, 6, 512, 512, k_sel,
                                              stats)) for stats in (0, 1)]
    assert chunks[0] == 4 and chunks[1] > 1
    assert tkn.grouped_estimate_topk_wide.launches == before[0] + chunks[0]
    assert (tkn.grouped_estimate_topk_stats_wide.launches
            == before[1] + chunks[1])
    for x, y in zip(cut, whole):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
def test_wide_topk_repeated_launches_match_plain():
    """The wide K4 and K5 launched 20 times at each shape of
    `tools.tc_repeat_check.WIDE_TOPK_SHAPES`, each launch after a NaN fill
    of every SM's shared memory and on the memory of the last launch's
    outputs filled with NaN, each bit for bit the first launch, K4's first
    held against the plain version."""
    dev = _card()
    shapes = tc_repeat_check.WIDE_TOPK_SHAPES
    before = (tkn.grouped_estimate_topk_wide.launches,
              tkn.grouped_estimate_topk_stats_wide.launches)
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("wide_topk",))["kernel"]
    n_k4 = sum(1 for s in shapes if s[5] <= s[2])
    assert tkn.grouped_estimate_topk_wide.launches == before[0] + 20 * n_k4
    assert (tkn.grouped_estimate_topk_stats_wide.launches
            == before[1] + 20 * len(shapes))
    assert len(runs) == len(shapes) + n_k4
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
def test_wide_bank_int_modes_take_the_wide_topk():
    """A dense bank with 2M = 512 (four pilots, D = 64, one dead
    component) in int modes through `stages.estimate_auto` (k = 1, 4), the
    service (mode 1, use_kernels=True), `estimate_sharded` over an
    in-process 1 x 2 mesh (k = 4) and the service over that mesh (mode
    2): the wide K4 and K5, within 1e-4 of the einsum estimator's scale on
    the rows not near a tie, with the einsum estimator made to raise and
    no launch of the narrow K4 / K5."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    dev = _card()
    bank = _bank(64, 8, 4, dev, n_dead=1)
    g = torch.Generator(device=dev).manual_seed(5)
    r = torch.complex(torch.randn(2048, 256, generator=g, device=dev),
                      torch.randn(2048, 256, generator=g, device=dev))
    kb = tkn.kernel_bank_block(bank)
    r2 = tkn._r2(r)
    want = {k: tge.estimate(bank, r, k) for k in (1, 2, 4)}
    keep = {k: _wide_keep(r2, kb, k) for k in (1, 2, 4)}
    saved = tge.estimate

    def refuse(*args, **kwargs):
        raise AssertionError("the einsum estimator was reached")

    mesh = pmesh.make_local_mesh(1, 2)
    before = tkn.launch_counts()
    try:
        tge.estimate = refuse
        got = {("estimate_auto", k): stages.estimate_auto(bank, r, k)
               for k in (1, 4)}
        got[("estimate_sharded", 4)] = pmesh.estimate_sharded(mesh, bank, r,
                                                              4)
        for mode, m in ((1, None), (2, mesh)):
            svc = serving.EstimationService(
                _gmm_params(64, 8, dev, n_dead=1),
                tp.pilot_matrix(64, 4, 2, device=dev), 2, mode=mode,
                use_kernels=True, mesh=m, device=dev)
            try:
                got[("service", mode)] = svc.submit(
                    r[:512].cpu().numpy(), 10.0, timeout=60.0)
            finally:
                svc.close()
    finally:
        tge.estimate = saved
    for (label, k), x in got.items():
        x = torch.as_tensor(x, device=dev)
        n = x.shape[0]
        assert int(keep[k][:n].sum()) >= 0.9 * n
        assert _rel(x[keep[k][:n]], want[k][:n][keep[k][:n]]) < 1e-4, label
    after = tkn.launch_counts()
    moved = {x: after[x] - before[x] for x in after if after[x] != before[x]}
    assert set(moved) == {"grouped_estimate_topk_wide",
                          "grouped_estimate_topk_stats_wide"}, moved


@pytest.mark.cuda
def test_service_on_card_matches_einsum_estimator():
    from quantized_channel_estimation_torch import serving
    dev = _card()
    d, k = 16, 8
    g = torch.Generator().manual_seed(3)
    a = torch.complex(torch.randn(k, d, d, generator=g),
                      torch.randn(k, d, d, generator=g))
    covs = a @ a.mH / d + torch.eye(d)
    params = tg.GmmParams(torch.full((k,), 1.0 / k),
                          torch.zeros(k, d, dtype=torch.complex64), covs,
                          tl.robust_precision_cholesky(covs))
    a_mat = tp.pilot_matrix(d, 1, 2, device=dev)
    r = torch.complex(torch.randn(64, d, generator=g),
                      torch.randn(64, d, generator=g)).numpy()
    bank = tge.prepare_bank(tg.GmmParams(*(x.to(dev) for x in params)), 5.0,
                            a_mat, 2, tq.design_quantizer(5.0, 2).to(dev))
    rt = torch.as_tensor(r, device=dev)
    for mode, req, want, kernel in (
            ("all", r, tge.estimate(bank, rt, "all"), "grouped_estimate"),
            ("all", r.reshape(16, 4, d),
             tge.estimate_coherent(bank, rt.reshape(16, 4, d)),
             "grouped_estimate_coherent"),
            (2, r, tge.estimate(bank, rt, 2), "grouped_estimate_topk")):
        svc = serving.EstimationService(params, a_mat, 2, mode=mode,
                                        max_delay_ms=1.0)
        try:
            before = tkn.launch_counts()[kernel]
            got = svc.submit(req, 5.0, timeout=30)
            assert tkn.launch_counts()[kernel] > before
            want_np = want.cpu().numpy()
            assert got.shape == want_np.shape
            assert np.abs(got - want_np).max() < 1e-4
            assert svc.metrics()["requests_failed"] == 0
        finally:
            svc.close(timeout=30)


def _mesh_service_pair(kind, dev, mesh):
    """A one-device service and one over `mesh` of one seeded prior (D = K
    = 64; factored: M = 16) on the card."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.models import mfa
    d, k = 64, 64
    g = torch.Generator().manual_seed(11)
    if kind == "factored":
        lam = torch.complex(torch.randn(k, d, 16, generator=g),
                            torch.randn(k, d, 16, generator=g)) * 0.35
        prior = mfa.MfaParams(torch.full((k,), 1.0 / k),
                              torch.zeros(k, d, dtype=torch.complex64), lam,
                              0.1 + torch.rand(k, d, generator=g))
        return [serving.EstimationService.from_mfa(
            prior, 1.0 + 0.0j, 2, max_delay_ms=1.0, device=dev, mesh=m)
            for m in (None, mesh)]
    a = torch.complex(torch.randn(k, d, d, generator=g),
                      torch.randn(k, d, d, generator=g))
    covs = a @ a.mH / d + torch.eye(d)
    params = tg.GmmParams(torch.full((k,), 1.0 / k),
                          torch.zeros(k, d, dtype=torch.complex64), covs,
                          tl.robust_precision_cholesky(covs))
    return [serving.EstimationService(
        params, np.eye(d, dtype=np.complex64), 2, max_delay_ms=1.0,
        device=dev, mesh=m, structured=kind == "structured")
        for m in (None, mesh)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,stats_kernels", [
    ("dense", ("grouped_estimate_stats", "grouped_estimate_coherent_stats")),
    ("structured", ("circ_estimate_stats", "circ_estimate_coherent_stats")),
    ("factored", ("fact_estimate_stats",))])
def test_mesh_service_matches_one_device_service_over_many_microbatches(
        kind, stats_kernels):
    """A 2 x 2 in-process mesh, each component shard on its own stream:
    60 requests of ragged sizes, flat and T = 4 blocks at three SNRs, sent
    in bursts of three threads so that microbatches follow each other on
    the worker's stream; every answer within 1e-4 of scale of the
    one-device service's, and each stats kernel of the bank launched."""
    import threading
    from quantized_channel_estimation_torch.parallel import mesh as pm
    dev = _card()
    one, svc = _mesh_service_pair(kind, dev, pm.make_local_mesh(2, 2))
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(60):
        n = int(rng.integers(1, 40)) * 4
        x = (rng.standard_normal((n, 64))
             + 1j * rng.standard_normal((n, 64))).astype(np.complex64)
        reqs.append((x.reshape(n // 4, 4, 64) if i % 2 else x,
                     (-5.0, 5.0, 15.0)[i % 3]))
    try:
        want = [one.submit(x, snr, timeout=60) for x, snr in reqs]
        before = tkn.launch_counts()
        got = [None] * len(reqs)

        def client(lo):
            for i in range(lo, len(reqs), 3):
                got[i] = svc.submit(*reqs[i], timeout=60)

        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        after = tkn.launch_counts()
        for name in stats_kernels:
            assert after[name] > before[name], name
        for g_i, w_i in zip(got, want):
            assert g_i is not None and g_i.shape == w_i.shape
            assert np.abs(g_i - w_i).max() <= 1e-4 * np.abs(w_i).max()
        m = svc.metrics()
        assert m["requests_failed"] == 0 and m["microbatches"] >= 20
    finally:
        one.close(timeout=60)
        svc.close(timeout=60)


@pytest.mark.cuda
def test_toeplitz_fit_on_card_is_toeplitz_and_resumes():
    """The inverse-EM Toeplitz fit at D = K = 64 on 20000 SCM channels on
    the card: finite, Toeplitz covariances (each of the first four
    off-diagonals constant to 5e-2 of the diagonal), and a resume from the
    fit's spectrum (as `run_gmm`'s segments resume) that does not step the
    lower bound back by more than 0.02."""
    from quantized_channel_estimation_torch.ops import scm
    dev = _card()
    h, _ = scm.generate_channels(torch.Generator(dev).manual_seed(4), 20000,
                                 scm.ScmConfig(64, 1))
    cfg = tg.GmmConfig(n_components=64, cov_type="toeplitz", max_iter=10,
                       tol=0.0)
    first = tg.fit(torch.Generator(dev).manual_seed(5), h, cfg)
    assert first.n_iter == 10 and all(map(math.isfinite, first.lb_history))
    resumed = tg.fit_resume(first.params, h, cfg._replace(max_iter=5),
                            spectrum=first.spectrum)
    assert all(map(math.isfinite, resumed.lb_history))
    assert float(resumed.lower_bound) >= float(first.lower_bound) - 0.02
    for p in resumed.params:
        assert torch.isfinite(torch.view_as_real(p) if p.is_complex()
                              else p).all()
    covs = resumed.params.covariances
    diag = torch.diagonal(covs, dim1=-2, dim2=-1).abs().mean(-1)
    for off in range(1, 5):
        d_off = torch.diagonal(covs, off, -2, -1)
        spread = (d_off - d_off.mean(-1, keepdim=True)).abs().amax(-1)
        assert torch.all(spread < 5e-2 * diag), off


# ------------------------------------------ the quantized EM (CSI-free)

def _quant_data(n_bits, n=4000, d=16, k=8):
    """2-bit (or 1-bit / unquantized) SCM pilots at 5 dB on the CPU, the
    port's k-means labels, and the quantizer."""
    from quantized_channel_estimation_torch.models import kmeans
    from quantized_channel_estimation_torch.ops import observation, scm
    from quantized_channel_estimation_torch.ops.cplx import cplx2real
    gen = torch.Generator().manual_seed(6)
    h, _ = scm.generate_channels(gen, n, scm.ScmConfig(d, 1))
    q = tq.design_quantizer(5.0, n_bits)
    r = observation.observe(gen, h, 5.0, tp.pilot_matrix(d, 1, n_bits),
                            n_bits, q)
    labels = kmeans.kmeans(gen, cplx2real(r, dim=-1), k).labels
    return r, labels, q


@pytest.mark.cuda
@pytest.mark.parametrize("cov_type,n_bits", [
    ("full", 2), ("full", 1), ("full", math.inf), ("toeplitz", 2),
    ("diag", 2), ("circulant", 2)])
def test_quant_em_on_card_matches_cpu_per_iteration(cov_type, n_bits):
    """The quantized EM on the card against the port on the CPU from the
    same k-means labels: the lower bound after each of 5 iterations to
    rtol 1e-4; every recovered covariance keeps its floor (min eigenvalue
    >= reg_covar within float32 rounding of its norm)."""
    from quantized_channel_estimation_torch.models import gmm_quant as tgq
    dev = _card()
    r, labels, q = _quant_data(n_bits)
    cfg = tg.GmmConfig(n_components=8, cov_type=cov_type, max_iter=5,
                       tol=0.0, chunk_size=1024)
    fits = []
    for device in ("cpu", dev):
        x = r.to(device)
        diag = cov_type == "diag"
        stats = tg._stats_from_labels(x, labels.to(device), 8, 1024, diag)
        fits.append(tgq.fit_from_stats(
            torch.Generator(device).manual_seed(0), x, stats, cfg, n_bits,
            10 ** -0.5, None if q is None else q.to(device)))
    cpu, card = fits
    assert card.n_iter == cpu.n_iter == 5
    np.testing.assert_allclose(card.lb_history, cpu.lb_history, rtol=1e-4)
    covs = card.params.covariances
    w = torch.linalg.eigvalsh(covs).min(-1).values
    assert torch.all(w >= cfg.reg_covar
                     - 2e-6 * torch.linalg.matrix_norm(covs))


@pytest.mark.cuda
def test_psd_project_polar_keeps_its_floor_on_card():
    """The Newton-Schulz projection at K = D = 64 on the card: near-zero
    negative spectra come out >= the floor (within 1e-7), and random
    Hermitian matrices match the eigh clip to 1e-4 (relative Frobenius)."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    d, floor = 64, 1e-5
    a = torch.complex(torch.randn(64, d, d, generator=g),
                      torch.randn(64, d, d, generator=g))
    qmat, _ = torch.linalg.qr(a)
    for negscale in (1e-3, 1e-5, 1e-7):
        lam = torch.ones(d)
        lam[:8] = -negscale * d
        h = tl.hermitize((qmat * lam) @ qmat.mH).to(dev)
        got = tl.psd_project_polar(h, floor)
        assert float(torch.linalg.eigvalsh(got).min()) >= floor - 1e-7
    h = tl.hermitize(a @ a.mH / d - 0.3 * torch.eye(d)).to(dev)
    want = tl.psd_project(h, floor)
    got = tl.psd_project_polar(h, floor)
    rel = torch.linalg.matrix_norm(got - want) / torch.linalg.matrix_norm(
        want)
    assert float(rel.max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("change,kernel", [
    ({}, "grouped_estimate"),
    (dict(cov_type="circulant", n_coherence=2), "circ_estimate")])
def test_run_gmm_quant_on_card_launches_its_kernel(tmp_path, change, kernel):
    """`run_gmm_quant` at a small size on the card: the GMM column through
    K1 (dense) or K6 and K7 (circulant, coherence blocks of 2) once an
    SNR, the MSE finite and falling with SNR."""
    from quantized_channel_estimation_torch.harness import run_gmm_quant
    _card()
    cfg = run_gmm_quant.QuantGmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        max_iter=10, snrs=(-5, 5, 15), results_dir=str(tmp_path),
        cache_dir=str(tmp_path / "c"), **change)
    tkn.reset_launch_counts()
    mse, rate, _ = run_gmm_quant.run(cfg, verbose=False)
    counts = tkn.launch_counts()
    assert counts[kernel] == 3
    if change:
        assert counts["circ_estimate_coherent"] == 3
    col = mse["blmmse_gmm_quant"]
    assert all(map(math.isfinite, col)) and col[0] > col[-1]
    assert all(map(math.isfinite, sum(rate.values(), [])))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [2, 1, math.inf])
def test_spectra_fit_on_card_matches_cpu_per_iteration(n_bits):
    """The spectra-native circulant EM on the card against the port on the
    CPU from one state (a CPU fit of 2 iterations, resumed for 5 on each
    device, tol 0): the lower bound after each iteration to rtol 1e-4, the
    spectra to 1e-3 of scale, every spectrum positive."""
    from quantized_channel_estimation_torch.models import gmm_quant as tgq
    dev = _card()
    r, _, q = _quant_data(n_bits, d=32)
    cfg = tg.GmmConfig(n_components=8, cov_type="circulant", max_iter=5,
                       tol=0.0, chunk_size=1024)
    first = tgq.fit_circulant_spectra(torch.Generator().manual_seed(0), r,
                                      cfg._replace(max_iter=2), n_bits,
                                      10 ** -0.5, q)
    fits = [tgq.fit_circulant_spectra_resume(
        torch.Generator(device).manual_seed(1),
        type(first)(*(x.to(device) if isinstance(x, torch.Tensor) else x
                      for x in first)),
        r.to(device), cfg, n_bits, 10 ** -0.5,
        None if q is None else q.to(device)) for device in ("cpu", dev)]
    cpu, card = fits
    assert card.n_iter == cpu.n_iter == 5
    np.testing.assert_allclose(card.lb_history, cpu.lb_history, rtol=1e-4)
    assert torch.all(card.spectra > 0) and torch.all(card.spec_quant > 0)
    assert _rel(card.spectra.cpu(), cpu.spectra) < 1e-3


@pytest.mark.cuda
def test_circ_kernels_on_a_spectra_fed_bank_match_plain():
    """K6 and K7 (T = 4) on the bank of a CSI-free spectra fit at D = 64
    (`stages.prepare_bank_circulant_spectra`, no dense covariance): one
    launch each through the stages, against their plain versions (1e-4 of
    scale, or the float64 rule)."""
    from quantized_channel_estimation_torch.models import gmm_quant as tgq
    dev = _card()
    r, _, q = _quant_data(2, n=8000, d=64)
    r = r.to(dev)
    q = q.to(dev)
    res = tgq.fit_circulant_spectra(
        torch.Generator(dev).manual_seed(0), r[:6000],
        tg.GmmConfig(n_components=16, cov_type="circulant", max_iter=8,
                     chunk_size=2048), 2, 10 ** -0.5, q)
    dummy = torch.zeros((16, 1, 1), dtype=torch.complex64, device=dev)
    bank = stages.prepare_bank_circulant_spectra(
        tg.GmmParams(res.weights, res.means, dummy, dummy), res.spectra, 5.0,
        torch.tensor(1.0 + 0.0j, device=dev), 2, q)
    rows = r[6000:]
    before = tkn.launch_counts()
    got = stages.estimate_circulant(bank, rows)
    got_c = stages.estimate_circulant_coherent(bank, rows.reshape(-1, 4, 64))
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert after["circ_estimate"] == before["circ_estimate"] + 1
    assert after["circ_estimate_coherent"] == (
        before["circ_estimate_coherent"] + 1)
    x2 = tck._x2(rows)
    for t, out in ((1, got), (4, got_c)):
        ckb = tck.circ_kernel_bank(bank, None, t, 1.0)
        f64 = type(ckb)(*(x.double() for x in ckb))
        if t == 1:
            want = tck.circ_estimate_reference(x2, ckb)
            want64 = tck.circ_estimate_reference(x2.double(), f64)
        else:
            want = tck.circ_estimate_coherent_reference(x2, ckb, t, 1.0)
            want64 = tck.circ_estimate_coherent_reference(x2.double(), f64,
                                                          t, 1.0)
        _held(tck._x2(out.reshape(-1, 64)), want, want64)


@pytest.mark.cuda
def test_stream_quantized_pilots_on_card():
    """`stages.stream_quantized_pilots` on the card (three slabs, the last
    ragged, the scalar pilot): each slab is generate + observe from its
    spawned generators (1e-6 of scale), the summed covariance is
    `sample_cov`'s (1e-5 of scale), and every value a quantizer label."""
    from quantized_channel_estimation_torch.ops import scm
    dev = _card()
    scm_cfg = scm.ScmConfig(64, 1)
    q = tq.design_quantizer(5.0, 2).to(dev)
    x0 = torch.tensor(1.0 + 0.0j, device=dev)
    r, cov = stages.stream_quantized_pilots(
        np.random.SeedSequence(1), np.random.SeedSequence(2), 2500, scm_cfg,
        5.0, x0, 2, q, slab=1000, gen_chunk=512, want_cov=True, device=dev)
    hs, rs = [], []
    for i, (s_d, s_o) in enumerate(zip(np.random.SeedSequence(1).spawn(3),
                                       np.random.SeedSequence(2).spawn(3))):
        h, _ = stages.generate_channels(stages.seed_generator(s_d, dev),
                                        min(1000, 2500 - 1000 * i), scm_cfg,
                                        512)
        hs.append(h)
        rs.append(stages.observe(stages.seed_generator(s_o, dev), h, 5.0, x0,
                                 2, q))
    want = torch.cat(rs)
    assert r.shape == (2500, 64) and r.device.type == "cuda"
    assert _rel(r, want) < 1e-6
    assert _rel(cov, stages.sample_cov(torch.cat(hs))) < 1e-5
    labels = q.labels.to(torch.float32)
    assert bool(torch.isin(r.real, labels).all())
    assert bool(torch.isin(r.imag, labels).all())


# ------------------------------------------------ the circulant kernels

def _circ_bank(d, k, dev, n_dead=0, blocks=None, seed=0, p=1, n_bits=2,
               multi=False):
    """A seeded circulant bank at 10 dB, non-zero means: under the scalar
    pilot x0 = 1, or for p > 1 the multi-pilot bank under the P-pilot
    matrix kron(x, I) of `pilots.pilot_matrix`; `multi` at p = 1: the
    multi-pilot form of the x0 = 1 bank (K10 at one pilot)."""
    rng = np.random.default_rng(seed)
    spectra = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    means = (0.2 * (rng.standard_normal((k, d))
                    + 1j * rng.standard_normal((k, d)))).astype(np.complex64)
    w = np.full((k,), 1.0 / k, np.float32)
    w[:n_dead] = 1e-9
    dummy = torch.zeros((k, 1, 1), dtype=torch.complex64, device=dev)
    params = tg.GmmParams(torch.as_tensor(w / w.sum(), device=dev),
                          torch.as_tensor(means, device=dev), dummy, dummy)
    q = tq.design_quantizer(10.0, n_bits)
    if multi and p == 1:
        return tsb._prepare_circulant_mp(
            torch.as_tensor(spectra, device=dev), params.means,
            params.weights, n_bits,
            torch.ones(1, dtype=torch.complex64, device=dev),
            torch.tensor(0.1, dtype=torch.float32).item(), blocks,
            None if q is None else q.to(dev), 1e-6, 1e-2)
    a = torch.tensor(1.0 + 0.0j) if p == 1 \
        else tp.pilot_matrix(d, p, n_bits, device=dev)
    return tsb.prepare_bank_circulant(
        params, 10.0, a, n_bits, None if q is None else q.to(dev),
        blocks=blocks, spectra=torch.as_tensor(spectra, device=dev))


def _f64(ckb):
    return type(ckb)(*(x.double() for x in ckb))


def _held(got, want, want64, ceiling=None):
    """1e-4 of the plain version, or as accurate as it against float64
    (and, with `ceiling`, within that fraction of the scale of the float64
    plain version)."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = float(want.abs().max())
    if float((got - want).abs().max()) / scale < 1e-4:
        return
    err_kernel = float((got.double() - want64).abs().max()) / scale
    err_plain = float((want.double() - want64).abs().max()) / scale
    assert err_kernel <= 2 * err_plain + 1e-5, (err_kernel, err_plain)
    assert ceiling is None or err_kernel <= ceiling, (err_kernel, ceiling)


# the template at one pilot: one, two and four 64-column pieces of 2D, one
# and two of K, one and two warpgroups a block, ragged sizes, dead
# components, K and D that are no multiple of 32, the kron basis
CIRC_SHAPES = [
    (8, 4, 1000, 0, None),
    (32, 40, 4097, 3, None),
    (16, 100, 333, 0, None),
    (64, 8, 77, 1, None),
    (64, 64, 10000, 5, None),
    (64, 128, 1001, 0, (8, 8)),
    (128, 4, 100, 1, None),
    (100, 50, 517, 2, None),
    (128, 128, 2049, 0, (8, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n,n_dead,blocks", CIRC_SHAPES)
def test_circ_estimate_matches_plain(d, k, n, n_dead, blocks):
    dev = _card()
    bank = _circ_bank(d, k, dev, n_dead, blocks)
    assert int(torch.isinf(bank.log_weights).sum()) == n_dead
    ckb = tck.circ_kernel_bank(bank, blocks)
    x2 = _rows(n, 2 * d, dev)
    before = tkn.launch_counts()
    got = tck.circ_estimate(x2, ckb)
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert after["circ_estimate"] == before["circ_estimate"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    _held(got, tck.circ_estimate_reference(x2, ckb),
          tck.circ_estimate_reference(x2.double(), _f64(ckb)))
    # the entry on complex observations, against the torch.fft pipeline
    r = torch.view_as_complex(x2.reshape(n, d, 2).contiguous())
    got_c = tck.estimate_fused_circulant(bank, r, blocks)
    want_c = tsb.estimate_circulant(bank, r, "all", 16384, blocks, "fft")
    assert got_c.dtype == torch.complex64
    assert float((got_c - want_c).abs().max() / want_c.abs().max()) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n_blocks,t,alpha,n_dead", [
    (8, 4, 500, 2, 1.0, 0),        # blocks inside a warp's rows
    (64, 64, 1001, 4, 1.0, 3),     # main-path widths, ragged, dead
    (64, 64, 333, 3, 0.25, 0),     # T that does not divide the tile
    (16, 8, 100, 8, 0.25, 0),      # T = a warp's rows
    (64, 40, 77, 16, 0.0, 1),      # blocks across warps, alpha 0
    (64, 64, 9, 64, 1.0, 0),       # T = a warpgroup's 64 rows
    (128, 128, 50, 32, 0.5, 2),    # D = 128: T = 32
    (100, 50, 41, 5, 1.0, 0),      # widths no multiple of 32
])
def test_circ_estimate_coherent_matches_plain(d, k, n_blocks, t, alpha,
                                              n_dead):
    dev = _card()
    bank = _circ_bank(d, k, dev, n_dead)
    ckb = tck.circ_kernel_bank(bank, None, t, alpha)
    x2 = _rows(n_blocks * t, 2 * d, dev)
    before = tck.circ_estimate_coherent.launches
    got = tck.circ_estimate_coherent(x2, ckb, t, alpha)
    torch.cuda.synchronize()
    assert tck.circ_estimate_coherent.launches == before + 1
    _held(got, tck.circ_estimate_coherent_reference(x2, ckb, t, alpha),
          tck.circ_estimate_coherent_reference(x2.double(), _f64(ckb), t,
                                               alpha))
    if alpha == 0.0:      # the per-snapshot estimator
        flat = tck.circ_estimate(x2, tck.circ_kernel_bank(bank))
        assert float((got - flat).abs().max() / flat.abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n,t,alpha,n_dead", [
    (64, 64, 4097, 1, 1.0, 3),
    (32, 40, 1000, 1, 1.0, 0),
    (128, 128, 333, 1, 1.0, 1),
    (64, 64, 1001, 4, 1.0, 3),
    (64, 64, 1001, 4, 0.25, 0),
    (16, 8, 100, 8, 0.5, 1),
    (128, 100, 50, 32, 1.0, 0),
    # shards of 128 components, as a bank of 256 is served: a service
    # microbatch of 512 rows and a larger batch
    (64, 256, 512, 1, 1.0, 3),
    (64, 256, 20000, 1, 1.0, 0),
    (64, 256, 128, 4, 1.0, 0),
    (64, 256, 5000, 4, 0.5, 3),
])
def test_circ_stats_match_plain_and_two_shards_merge(d, k, n, t, alpha,
                                                     n_dead):
    """K8 (T = 1) and K9 on the two halves of the bank: each state against
    the plain stats, and the states merged with `merge_stats` and
    inverse-transformed once against K6 / K7 over the whole bank (past one
    launch's 128 components: against the plain states merged likewise)."""
    dev = _card()
    bank = _circ_bank(d, k, dev, n_dead)
    x2 = _rows(n * t, 2 * d, dev)
    name = "circ_estimate_stats" if t == 1 else "circ_estimate_coherent_stats"
    states, plain = [], []
    for lo, hi in ((0, k // 2), (k // 2, k)):
        ckb = tck.circ_kernel_bank(
            tsb.CirculantBank(*(x[lo:hi] for x in bank)), None, t, alpha)
        before = tkn.launch_counts()[name]
        if t == 1:
            got = tck.circ_estimate_stats(x2, ckb)
            want = tck.circ_estimate_stats_reference(x2, ckb)
            want64 = tck.circ_estimate_stats_reference(x2.double(), _f64(ckb))
        else:
            got = tck.circ_estimate_coherent_stats(x2, ckb, t, alpha)
            want = tck.circ_estimate_coherent_stats_reference(x2, ckb, t,
                                                              alpha)
            want64 = tck.circ_estimate_coherent_stats_reference(
                x2.double(), _f64(ckb), t, alpha)
        torch.cuda.synchronize()
        assert tkn.launch_counts()[name] == before + 1
        assert got[0].shape == got[1].shape == (n * t,)
        for g, w, w64 in zip(got, want, want64):
            _held(g, w, w64)
        states.append(got)
        plain.append(want)

    def merge(sts):
        _, den, acc = tck.merge_stats(*zip(*sts))
        return tck._x2(tsb.unitary_ifft(tck._hc(acc / den[:, None],
                                                torch.complex64)))

    merged = merge(states)
    if k > tck.CIRC_MAX_K:
        whole = merge(plain)
    elif t == 1:
        whole = tck.circ_estimate(x2, tck.circ_kernel_bank(bank))
    else:
        whole = tck.circ_estimate_coherent(
            x2, tck.circ_kernel_bank(bank, None, t, alpha), t, alpha)
    assert float((merged - whole).abs().max() / whole.abs().max()) < 1e-4


@pytest.mark.cuda
def test_circ_kernels_refuse_bad_inputs():
    dev = _card()
    bank = _circ_bank(8, 4, dev)
    ckb = tck.circ_kernel_bank(bank)
    x2 = torch.zeros(12, 16, device=dev)
    with pytest.raises(ValueError):
        tck.circ_estimate(x2.double(), ckb)
    with pytest.raises(ValueError):
        tck.circ_estimate(torch.zeros(16, 12, device=dev).T, ckb)
    with pytest.raises(ValueError):
        tck.circ_estimate(torch.zeros(12, 18, device=dev), ckb)
    with pytest.raises(ValueError):
        tck.circ_estimate(x2, ckb._replace(const=ckb.const.cpu()))
    for t, rows in ((1, x2), (5, x2), (65, torch.zeros(130, 16, device=dev))):
        with pytest.raises(ValueError, match="T"):   # T = 1, N % T, T > tile
            tck.circ_estimate_coherent(rows, ckb, t)
        with pytest.raises(ValueError, match="T"):
            tck.circ_estimate_coherent_stats(rows, ckb, t)
    wide = _circ_bank(673, 2, dev)                   # D past the kernels
    with pytest.raises(ValueError, match="672"):
        tck.circ_estimate(torch.zeros(3, 1346, device=dev),
                          tck.circ_kernel_bank(wide))
    many = tck.circ_kernel_bank(_circ_bank(8, 130, dev))   # one launch's K
    with pytest.raises(ValueError, match="128"):
        tck.circ_estimate(x2, many)
    r = torch.zeros(3, 673, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="method='kernel'"):
        stages.estimate_circulant(wide, r, method="kernel")
    with pytest.raises(ValueError, match="coherent circulant kernels"):
        tck.estimate_fused_circulant_coherent(
            bank, torch.zeros(2, 65, 8, dtype=torch.complex64, device=dev))
    before = tkn.launch_counts()
    assert tck.circ_estimate(x2[:0], ckb).shape == (0, 16)
    m, den, acc = tck.circ_estimate_stats(x2[:0], ckb)
    assert m.shape == den.shape == (0,) and acc.shape == (0, 16)
    assert tck.circ_estimate_coherent(x2[:0], ckb, 2).shape == (0, 16)
    assert tkn.launch_counts() == before             # nothing to launch


def _ifft_rows(acc, den):
    """Merged stats (float64) -> the inverse-transformed quotient, rows of
    interleaved [re, im] pairs."""
    q = tck._hc(acc / den[:, None], torch.complex128)
    return torch.view_as_real(tsb.unitary_ifft(q)).reshape(q.shape[0], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("d,k,n", [(64, 64, 8192), (128, 128, 2048)])
def test_circ_estimate_keeps_fp32_accuracy(stats, t, d, k, n):
    """K6-K9, six bf16 products for each of the template's products at one
    pilot, are no less accurate than float32: the max |error| against the
    plain version in float64 at most twice the float32 plain version's
    own, flat and coherent (T = 4, alpha 1), with dead components; the
    stats forms (K8, K9) on the two halves of the bank, for each of m, den
    and the accumulator, and for the states merged with `merge_stats` and
    inverse-transformed once. The operands laid out once give the same bits
    as those laid out in the call."""
    dev = _card()
    bank = _circ_bank(d, k, dev, n_dead=2)
    x2 = _rows(n, 2 * d, dev)

    def err(x, want64):
        return float((x.double() - want64).abs().max())

    def runs(ckb):
        """(launch(operands), plain, plain in float64) of the form."""
        c64 = _f64(ckb)
        if not stats and t == 1:
            return ((lambda o: tck.circ_estimate(x2, ckb, o)),
                    tck.circ_estimate_reference(x2, ckb),
                    tck.circ_estimate_reference(x2.double(), c64))
        if not stats:
            return ((lambda o: tck.circ_estimate_coherent(x2, ckb, t, 1.0,
                                                          o)),
                    tck.circ_estimate_coherent_reference(x2, ckb, t, 1.0),
                    tck.circ_estimate_coherent_reference(x2.double(), c64,
                                                         t, 1.0))
        if t == 1:
            return ((lambda o: tck.circ_estimate_stats(x2, ckb, o)),
                    tck.circ_estimate_stats_reference(x2, ckb),
                    tck.circ_estimate_stats_reference(x2.double(), c64))
        return ((lambda o: tck.circ_estimate_coherent_stats(x2, ckb, t, 1.0,
                                                            o)),
                tck.circ_estimate_coherent_stats_reference(x2, ckb, t, 1.0),
                tck.circ_estimate_coherent_stats_reference(x2.double(), c64,
                                                           t, 1.0))

    if not stats:
        ckb = tck.circ_kernel_bank(bank, None, t, 1.0)
        run, want, want64 = runs(ckb)
        got = run(None)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert err(got, want64) <= 2 * err(want, want64)
        assert torch.equal(run(tck.circ_tc_operands(ckb)), got)
        return
    states, plain, exact = [], [], []
    for lo, hi in ((0, k // 2), (k // 2, k)):
        ckb = tck.circ_kernel_bank(
            tsb.CirculantBank(*(x[lo:hi] for x in bank)), None, t, 1.0)
        run, want, want64 = runs(ckb)
        got = run(None)
        torch.cuda.synchronize()
        for g, w, w64 in zip(got, want, want64):
            assert torch.isfinite(g).all()
            assert err(g, w64) <= 2 * err(w, w64), (err(g, w64), err(w, w64))
        again = run(tck.circ_tc_operands(ckb, True))
        assert all(torch.equal(a, b) for a, b in zip(again, got))
        states.append(got)
        plain.append(want)
        exact.append(want64)

    def merged(sts):
        _, den, acc = tck.merge_stats(*zip(*[[x.double() for x in st]
                                             for st in sts]))
        return _ifft_rows(acc, den)

    whole64 = merged(exact)
    assert err(merged(states), whole64) <= 2 * err(merged(plain), whole64)


@pytest.mark.cuda
def test_circ_repeated_launches_match_plain():
    """K6-K9 launched 100 times at each shape of
    `tools.tc_repeat_check.CIRC_SHAPES` (one and two warpgroups a block,
    one, two and four pieces of 2D, a 128-component shard, D = K = 128,
    each pool), each launch after a fill of every SM's shared memory with
    NaN, each bit for bit the first launch and held against the plain
    version."""
    dev = _card()
    shapes = tc_repeat_check.CIRC_SHAPES
    names = {(False, False): "circ_estimate",
             (True, False): "circ_estimate_coherent",
             (False, True): "circ_estimate_stats",
             (True, True): "circ_estimate_coherent_stats"}
    before = tkn.launch_counts()
    runs = tc_repeat_check.repeat_check(dev, repeats=100,
                                        modes=("circ",))["kernel"]
    after = tkn.launch_counts()
    for (coh, stats), name in names.items():
        n = sum(1 for *_, t, _, st in shapes if (t > 1, st) == (coh, stats))
        assert after[name] == before[name] + 100 * n, name
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
def test_wide_bank_splits_over_k_on_card():
    """K = 300 components: three shards through K8 / K9, merged; the
    `torch.fft` pipeline over the whole bank agrees."""
    dev = _card()
    bank = _circ_bank(64, 300, dev, n_dead=4)
    g = torch.Generator(device=dev).manual_seed(2)
    r = torch.complex(torch.randn(512, 64, generator=g, device=dev),
                      torch.randn(512, 64, generator=g, device=dev))
    before = tkn.launch_counts()
    got = tck.estimate_fused_circulant(bank, r)
    got_b = tck.estimate_fused_circulant_coherent(bank, r.reshape(128, 4, 64),
                                                  0.5)
    after = tkn.launch_counts()
    assert after["circ_estimate_stats"] == before["circ_estimate_stats"] + 3
    assert after["circ_estimate_coherent_stats"] \
        == before["circ_estimate_coherent_stats"] + 3
    want = tsb.estimate_circulant(bank, r, method="fft")
    want_b = tsb.estimate_circulant_coherent(bank, r.reshape(128, 4, 64),
                                             alpha=0.5, method="fft")
    assert float((got - want).abs().max() / want.abs().max()) < 2e-4
    assert float((got_b - want_b).abs().max() / want_b.abs().max()) < 2e-4


# the wide form of K6-K9 past D = 128: (D, K, T, alpha, dead components,
# blocks), the widths of chip_smoke's phase 3l
CIRC_WIDE_CASES = [
    (129, 1, 1, 1.0, 0, None),
    (129, 16, 4, 0.25, 1, None),
    (192, 64, 16, 1.0, 2, None),
    (256, 16, 1, 1.0, 2, (16, 16)),
    (512, 64, 64, 0.25, 1, None),
    (640, 16, 4, 1.0, 1, None),
    (672, 16, 16, 0.25, 1, None),
    (672, 1, 4, 1.0, 0, None),
]
CIRC_WIDE_NAMES = {(False, False): "circ_estimate_wide",
                   (True, False): "circ_estimate_coherent_wide",
                   (False, True): "circ_estimate_stats_wide",
                   (True, True): "circ_estimate_coherent_stats_wide"}


CIRC_FACT_NAMES = {(False, False): "circ_estimate_fact",
                   (True, False): "circ_estimate_coherent_fact",
                   (False, True): "circ_estimate_stats_fact",
                   (True, True): "circ_estimate_coherent_stats_fact"}


def _circ_forms(x2, ckb, t, alpha, operands=(None, None), dense=False):
    """K6 (K7 at t > 1) and K8 (K9) on x2 through the public wrappers, or
    with `dense` through the dense wide form's own wrappers (the public
    ones take the factorised kernel where D splits): (out, m, den, acc)."""
    if t == 1:
        k6 = tck.circ_estimate_wide if dense else tck.circ_estimate
        k8 = tck.circ_estimate_stats_wide if dense else tck.circ_estimate_stats
        return (k6(x2, ckb, operands[0]), *k8(x2, ckb, operands[1]))
    k7 = (tck.circ_estimate_coherent_wide if dense
          else tck.circ_estimate_coherent)
    k9 = (tck.circ_estimate_coherent_stats_wide if dense
          else tck.circ_estimate_coherent_stats)
    return (k7(x2, ckb, t, alpha, operands[0]),
            *k9(x2, ckb, t, alpha, operands[1]))


def _circ_plain(x2, ckb, t, alpha, blocks="dense"):
    """The plain versions of `_circ_forms`' outputs: each form's route's
    (`circ_fact_reference` in the basis `blocks`, K8 / K9 with
    `stats=True`, where `blocks` is not 'dense' and the route is 'fact'),
    else the dense ones."""
    out = (_route_plain(x2, ckb, t, alpha, False, blocks),)
    return out + _route_plain(x2, ckb, t, alpha, True, blocks)


def _route_plain(x2, ckb, t, alpha, stats, blocks=None):
    """The plain version of the kernel a public wrapper launches for ckb
    at T = t (`_route_name`; 'dense' for `blocks`: the dense one)."""
    d = x2.shape[1] // 2
    if blocks != "dense" and tck.circ_route(d, blocks, stats,
                                            ckb.const.shape[0], t) == "fact":
        return tck.circ_fact_reference(x2, ckb, t, alpha, blocks,
                                       stats=stats)
    return tck._circ_reference(x2, ckb, t, alpha, stats, 16384)


def _route_name(d, t, stats=False, blocks=None, k=1):
    """The wrapper that counts a public K6-K9 launch of K components past
    D = 128."""
    names = (CIRC_FACT_NAMES
             if tck.circ_route(d, blocks, stats, k, t) == "fact"
             else CIRC_WIDE_NAMES)
    return names[(t > 1, stats)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,t,alpha,n_dead,blocks", CIRC_WIDE_CASES)
def test_circ_wide_matches_plain(d, k, t, alpha, n_dead, blocks):
    """Past D = 128 the circulant wrappers launch K6 / K7 on the
    factorised kernel where the transform splits (every case here), and
    K8 / K9 on its STATS form where `circ_route` admits their K and T
    (else on the dense wide form): each within 1e-4 of the scale of its
    plain version (where the float32 plain version's own rounding of logits
    pooled over T rows pushes the two apart, held to the float64 rule and
    within 1e-4 of the float64 plain version, `_held`), one launch each
    counted on those wrappers and none on the template's; the wide form's
    row split (`circ_wide_rows`, rows and u's features) bit for bit its
    plain layout."""
    dev = _card()
    bank = _circ_bank(d, k, dev, n_dead=n_dead, blocks=blocks)
    x2 = _rows(2049 // t * t, 2 * d, dev)
    for feats in (False, True):
        assert torch.equal(
            tck.circ_wide_rows(x2, feats).cpu().view(torch.int16),
            tck.circ_wide_rows(x2.cpu(), feats).view(torch.int16))
    ckb = tck.circ_kernel_bank(bank, blocks, t, alpha)
    before = tkn.launch_counts()
    got = _circ_forms(x2, ckb, t, alpha)
    after = tkn.launch_counts()
    for g, w, w64 in zip(got, _circ_plain(x2, ckb, t, alpha, blocks),
                         _circ_plain(x2.double(), _f64(ckb), t, alpha,
                                     blocks)):
        _held(g, w, w64, ceiling=1e-4)
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {
        _route_name(d, t, False, blocks, k): 1,
        _route_name(d, t, True, blocks, k): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("d", [512, 672])
def test_circ_wide_keeps_fp32_accuracy(d, t):
    """The wide K6-K9 (through the dense wide form's own wrappers) are no
    less accurate than float32 at the widths of JAX's tool and of
    the rule's edge: each output's (and each of m, den and acc's) max
    |error| against the plain version in float64 at most twice the
    float32 plain version's own; the operands laid out once give the same
    bits as those laid out in the call."""
    dev = _card()
    bank = _circ_bank(d, 16, dev, n_dead=2)
    x2 = _rows(4096, 2 * d, dev)
    ckb = tck.circ_kernel_bank(bank, None, t, 1.0)
    got = _circ_forms(x2, ckb, t, 1.0, dense=True)
    want = _circ_plain(x2, ckb, t, 1.0)
    want64 = _circ_plain(x2.double(), _f64(ckb), t, 1.0)
    for g, w, w64 in zip(got, want, want64):
        e_k = float((g.double() - w64).abs().max())
        e_p = float((w.double() - w64).abs().max())
        assert torch.isfinite(g).all() and e_k <= 2 * e_p, (e_k, e_p)
    again = _circ_forms(x2, ckb, t, 1.0, (tck.circ_wide_operands(ckb),
                                          tck.circ_wide_operands(ckb, True)),
                        dense=True)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("t,alpha", [(1, 1.0), (4, 0.5)])
def test_circ_wide_shards_merge_to_one_launch(t, alpha):
    """At D = 256 the K8 (K9) of the public wrappers (the factorised
    kernel: 256 = 16 x 16) on the two halves of a 64-component bank,
    merged with `merge_stats` and inverse-transformed once, equal one K6
    (K7) launch over the whole bank within 1e-4 of the scale (the
    template's own merge test's tolerance: the two sides round the softmax
    over other sets of components); a 200-component bank through the
    entries (two shards, each on its route: the 128-component one on the
    dense wide form, 3 K > D, the 72-component one on the factorised
    kernel; merged) equals its plain states merged (`_held`: where they
    part by more than 1e-4, both against those states in float64)."""
    dev = _card()
    d = 256
    bank = _circ_bank(d, 64, dev, n_dead=3)
    x2 = _rows(1024, 2 * d, dev)
    states = []
    for lo, hi in ((0, 32), (32, 64)):
        ckb = tck.circ_kernel_bank(
            tsb.CirculantBank(*(x[lo:hi] for x in bank)), None, t, alpha)
        states.append(_circ_forms(x2, ckb, t, alpha)[1:])
    _, den, acc = tck.merge_stats(*zip(*states))
    merged = tck._x2(tsb.unitary_ifft(tck._hc(acc / den[:, None],
                                              torch.complex64)))
    one = _circ_forms(x2, tck.circ_kernel_bank(bank, None, t, alpha), t,
                      alpha)[0]
    assert _rel(merged, one) < 1e-4
    big = _circ_bank(d, 200, dev, n_dead=4, seed=1)
    r = tck._hc(_rows(512, 2 * d, dev, seed=3), torch.complex64)
    before = tkn.launch_counts()
    if t == 1:
        got = tck.estimate_fused_circulant(big, r)
    else:
        got = tck.estimate_fused_circulant_coherent(
            big, r.reshape(-1, t, d), alpha)
    after = tkn.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {CIRC_WIDE_NAMES[(t > 1, True)]: 1,
                                          CIRC_FACT_NAMES[(t > 1, True)]: 1}
    x2 = tck._x2(r)

    def plain_merged(double):
        sts = [_route_plain(x2.double() if double else x2,
                            _f64(c) if double else c, t, alpha, True, None)
               for c in tck.lowered(big, None, None, t, alpha)]
        _, den, acc = tck.merge_stats(*zip(*sts))
        q = tck._hc(acc / den[:, None],
                    torch.complex128 if double else torch.complex64)
        return torch.view_as_real(tsb.unitary_ifft(q)).reshape(512, -1)

    _held(torch.view_as_real(got.reshape(512, d)).reshape(512, -1),
          plain_merged(False), plain_merged(True), ceiling=1e-4)


@pytest.mark.cuda
def test_circ_wide_refuses_one_past_the_rule():
    """D = 673 is refused by every circulant wrapper, wide or not, and by
    the stages' 'kernel' method ('auto' takes the `torch.fft` pipeline); T
    = 65, K = 129 and the template's operands are refused at D = 200; N =
    0 launches nothing; D = 672 runs."""
    dev = _card()
    past = tck.circ_kernel_bank(_circ_bank(673, 2, dev))
    x2 = _rows(8, 1346, dev)
    for fn in (tck.circ_estimate, tck.circ_estimate_stats,
               tck.circ_estimate_wide, tck.circ_estimate_stats_wide):
        with pytest.raises(ValueError, match="672"):
            fn(x2, past)
    for fn in (tck.circ_estimate_coherent, tck.circ_estimate_coherent_wide):
        with pytest.raises(ValueError, match="672"):
            fn(x2, past, 4)
    bank = _circ_bank(673, 2, dev)
    r = tck._hc(x2, torch.complex64)
    with pytest.raises(ValueError, match="method='kernel'"):
        stages.estimate_circulant(bank, r, method="kernel")
    assert torch.equal(stages.estimate_circulant(bank, r),
                       tsb.estimate_circulant(bank, r, method="fft"))
    ckb = tck.circ_kernel_bank(_circ_bank(200, 4, dev))
    x2 = _rows(130, 400, dev)
    with pytest.raises(ValueError, match="T"):
        tck.circ_estimate_coherent(x2, ckb, 65)
    with pytest.raises(ValueError, match="T"):
        tck.circ_estimate_coherent_stats_wide(x2, ckb, 65)
    many = tck.circ_kernel_bank(_circ_bank(200, 129, dev))
    with pytest.raises(ValueError, match="128"):
        tck.circ_estimate(x2, many)
    tc_ops = tck.circ_tc_operands(tck.circ_kernel_bank(_circ_bank(64, 4,
                                                                  dev)))
    with pytest.raises(ValueError, match="circ_wide_operands"):
        tck.circ_estimate_wide(x2, ckb, tc_ops)
    with pytest.raises(ValueError, match="circ_fact_operands"):
        tck.circ_estimate(x2, ckb, tc_ops)   # D = 200 = 10 x 20
    before = tkn.launch_counts()
    assert tck.circ_estimate(x2[:0], ckb).shape == (0, 400)
    m, den, acc = tck.circ_estimate_stats_wide(x2[:0], ckb)
    assert m.shape == den.shape == (0,) and acc.shape == (0, 400)
    assert tkn.launch_counts() == before
    edge = tck.circ_kernel_bank(_circ_bank(672, 3, dev, n_dead=1))
    x2 = _rows(300, 1344, dev)
    assert _rel(tck.circ_estimate(x2, edge),
                tck.circ_estimate_reference(x2, edge)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
def test_circ_wide_cuts_rows_to_its_scratch(monkeypatch, t):
    """Past `WIDE_SCRATCH` the wide K6-K9 (through their own wrappers) run
    in row chunks of whole blocks, one counted launch each,
    bit for bit the one launch's outputs (a scratch of 512 rows' worth
    here: 2000 rows in four chunks)."""
    dev = _card()
    d, k = 200, 8
    ckb = tck.circ_kernel_bank(_circ_bank(d, k, dev, n_dead=1), None, t, 1.0)
    x2 = _rows(2000, 2 * d, dev)
    whole = _circ_forms(x2, ckb, t, 1.0, dense=True)
    per_row = 384 * 10 + 8 * d + 4 * k + 4       # 3D = 600: 10 chunks
    monkeypatch.setattr(tkn, "WIDE_SCRATCH", 512 * per_row + 100)
    assert tck.circ_wide_launch_rows(2000, d, k, t) == 512
    before = tkn.launch_counts()
    cut = _circ_forms(x2, ckb, t, 1.0, dense=True)
    after = tkn.launch_counts()
    for stats in (False, True):
        name = CIRC_WIDE_NAMES[(t > 1, stats)]
        assert after[name] == before[name] + 4
    for a, b in zip(cut, whole):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_circ_wide_repeated_launches_match_plain():
    """The wide K6-K9 launched 20 times at each shape of
    `tools.tc_repeat_check.WIDE_CIRC_SHAPES` (one past the template's D,
    D = 512 over two waves of blocks, the rule's edge, a 128-component
    shard, the pool at T = 3, 4 and 64), each launch after a NaN fill of
    every SM's shared memory and on the memory of the last launch's
    outputs filled with NaN, each bit for bit the first launch, which is
    held against the plain version."""
    dev = _card()
    shapes = tc_repeat_check.WIDE_CIRC_SHAPES
    before = tkn.launch_counts()
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("wide_circ",))["kernel"]
    after = tkn.launch_counts()
    for (coh, stats), name in CIRC_WIDE_NAMES.items():
        n = sum(1 for *_, t, _, st in shapes if (t > 1, st) == (coh, stats))
        assert after[name] == before[name] + 20 * n, name
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


# the factorised K6 / K7 (csrc/circ_fact_estimate.cu): widths that split
# into two levels of at most 64 points (144 = 12 x 12, 357 = 17 x 21, 512 =
# 16 x 32, 672 = 24 x 28), K = 1, 16 and 128, T = 1, 4 and 64
CIRC_FACT_CASES = [(d, k, t) for d in (144, 357, 512, 672)
                   for k in (1, 16, 128) for t in (1, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,t", CIRC_FACT_CASES)
def test_circ_fact_matches_plain(d, k, t):
    """The factorised kernel, with dead components: within 1e-4 of the
    scale of its plain version `circ_fact_reference` (or, where the
    float32 plain version's own rounding pushes the two apart, within
    1e-4 of the float64 one and no further from it than twice the float32
    plain version, `_held`) and no less accurate than float32 (the float64
    rule: its max |error| against the float64 plain version at most twice
    the float32 plain version's); one launch counted on its wrapper, none
    on the dense wide form's."""
    dev = _card()
    alpha = 0.25 if t == 64 else 1.0
    bank = _circ_bank(d, k, dev, n_dead=min(2, k - 1))
    x2 = _rows(2048 // t * t, 2 * d, dev)
    ckb = tck.circ_kernel_bank(bank, None, t, alpha)
    before = tkn.launch_counts()
    got = (tck.circ_estimate_coherent(x2, ckb, t, alpha) if t > 1
           else tck.circ_estimate(x2, ckb))
    after = tkn.launch_counts()
    want = tck.circ_fact_reference(x2, ckb, t, alpha)
    want64 = tck.circ_fact_reference(x2.double(), _f64(ckb), t, alpha)
    _held(got, want, want64, ceiling=1e-4)
    e_k = float((got.double() - want64).abs().max())
    e_p = float((want.double() - want64).abs().max())
    assert e_k <= 2 * e_p, (e_k, e_p)
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {_route_name(d, t, False, None,
                                                            k): 1}


@pytest.mark.cuda
def test_circ_fact_takes_the_kron_basis_and_the_operands_it_is_given():
    """The kron(F_16, F_16) basis at D = 256 through the entry (its
    operands from `lowered_tc`) and through the wrapper with the operands
    laid out in the call (the basis read from the layout): the same bits,
    within 1e-4 of the plain version; N = 0 launches nothing; the dense
    wide form's operands are refused."""
    dev = _card()
    blocks = (16, 16)
    bank = _circ_bank(256, 16, dev, n_dead=1, blocks=blocks)
    r = tck._hc(_rows(1024, 512, dev), torch.complex64)
    cache = {}
    entry = tck.estimate_fused_circulant(bank, r, blocks, cache)
    assert isinstance(cache[("circ_fact_operands", blocks, False)][0],
                      tck.CircFactOperands)
    ckb = tck.lowered(bank, cache, blocks)[0]
    x2 = tck._x2(r)
    got = tck.circ_estimate(x2, ckb)
    assert torch.equal(tck._x2(entry), got)
    want = tck.circ_fact_reference(x2, ckb, 1, 1.0, blocks)
    want64 = tck.circ_fact_reference(x2.double(), _f64(ckb), 1, 1.0, blocks)
    _held(got, want, want64, ceiling=1e-4)
    before = tkn.launch_counts()
    assert tck.circ_estimate_fact(x2[:0], ckb).shape == (0, 512)
    assert tkn.launch_counts() == before
    with pytest.raises(ValueError, match="circ_fact_operands"):
        tck.circ_estimate_fact(x2, ckb, tck.circ_wide_operands(ckb))


@pytest.mark.cuda
def test_circ_fact_repeated_launches_match_plain():
    """The factorised K6-K9 launched 20 times at each shape of
    `tools.tc_repeat_check.FACT_CIRC_SHAPES` (one past the template's D,
    D = 512 over two waves of blocks, the rule's edge at K = 128, the pool
    at T = 3, 4 and 64, the kron basis; the stats forms K8 / K9 at most of
    these), each launch after a NaN fill of every SM's shared memory and
    on the memory of the last launch's outputs filled with NaN, each bit
    for bit the first launch, which is held against the plain version (K8
    / K9: each of m, den and acc)."""
    dev = _card()
    shapes = tc_repeat_check.FACT_CIRC_SHAPES
    before = tkn.launch_counts()
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("fact_circ",))["kernel"]
    after = tkn.launch_counts()
    for (coh, stats), name in CIRC_FACT_NAMES.items():
        n = sum(1 for s in shapes if (s[4] > 1, s[7]) == (coh, stats))
        assert n and after[name] == before[name] + 20 * n, name
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


# the factorised K8 / K9 (the STATS form of csrc/circ_fact_estimate.cu),
# launched through their own wrappers (some of these shapes the route
# leaves to the dense wide form: D = 129, T = 64 at D = 672): (D, K, T,
# alpha, dead components, blocks): one past the template's D (3 x 43), D =
# 512 (16 x 32) and the rule's edge 672 (24 x 28), K = 1, 16, 128, T = 1,
# 4 and 64 (two sweeps), the kron basis
CIRC_FACT_STATS_CASES = [
    (129, 1, 1, 1.0, 0, None), (129, 16, 4, 0.25, 1, None),
    (512, 16, 1, 1.0, 2, None), (512, 128, 4, 1.0, 2, None),
    (512, 64, 64, 0.25, 1, None), (672, 128, 1, 1.0, 2, None),
    (672, 16, 64, 1.0, 2, None), (672, 1, 4, 1.0, 0, None),
    (256, 16, 4, 0.5, 2, (16, 16)), (256, 16, 1, 1.0, 1, (16, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,t,alpha,n_dead,blocks", CIRC_FACT_STATS_CASES)
def test_circ_fact_stats_matches_plain(d, k, t, alpha, n_dead, blocks):
    """The factorised K8 / K9 through their own wrappers (the operands
    laid out in the layout's basis): each of m, den and acc (natural bin
    order) within 1e-4 of the scale of its plain version
    `circ_fact_reference(..., stats=True)` (or `_held`'s float64 rule
    within 1e-4 of the float64 one); one launch counted on the factorised
    stats wrapper and none on the dense wide form's."""
    dev = _card()
    bank = _circ_bank(d, k, dev, n_dead=n_dead, blocks=blocks)
    x2 = _rows(2048 // t * t, 2 * d, dev)
    ckb = tck.circ_kernel_bank(bank, blocks, t, alpha)
    before = tkn.launch_counts()
    got = (tck.circ_estimate_coherent_stats_fact(x2, ckb, t, alpha) if t > 1
           else tck.circ_estimate_stats_fact(x2, ckb))
    after = tkn.launch_counts()
    want = tck.circ_fact_reference(x2, ckb, t, alpha, blocks, stats=True)
    want64 = tck.circ_fact_reference(x2.double(), _f64(ckb), t, alpha, blocks,
                                     stats=True)
    for g, w, w64 in zip(got, want, want64):
        _held(g, w, w64, ceiling=1e-4)
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {CIRC_FACT_NAMES[(t > 1,
                                                                 True)]: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("d", [512, 672])
def test_circ_fact_stats_keeps_fp32_accuracy(d, t):
    """The factorised K8 / K9 are no less accurate than float32 at the
    widths of JAX's tool and of the rule's edge: each of m, den and acc's
    max |error| against the plain version in float64 at most twice the
    float32 plain version's own; the operands laid out once give the same
    bits as those laid out in the call."""
    dev = _card()
    bank = _circ_bank(d, 16, dev, n_dead=2)
    x2 = _rows(4096, 2 * d, dev)
    ckb = tck.circ_kernel_bank(bank, None, t, 1.0)

    def run(ops=None):
        if t > 1:
            return tck.circ_estimate_coherent_stats_fact(x2, ckb, t, 1.0, ops)
        return tck.circ_estimate_stats_fact(x2, ckb, ops)

    got = run()
    want = tck.circ_fact_reference(x2, ckb, t, 1.0, stats=True)
    want64 = tck.circ_fact_reference(x2.double(), _f64(ckb), t, 1.0,
                                     stats=True)
    for g, w, w64 in zip(got, want, want64):
        e_k = float((g.double() - w64).abs().max())
        e_p = float((w.double() - w64).abs().max())
        assert torch.isfinite(g).all() and e_k <= 2 * e_p, (e_k, e_p)
    again = run(tck.circ_fact_operands(ckb))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("t,alpha", [(1, 1.0), (4, 0.5)])
def test_circ_fact_and_wide_stats_merge_across_routes(t, alpha):
    """One shard's state from the factorised K8 (K9) and the other's from
    the dense wide form at D = 512 (two halves of a 32-component bank)
    merge: every pairing of the two routes, merged with `merge_stats` and
    inverse-transformed once, within 1e-4 of the scale of one K6 (K7)
    launch over the whole bank; each shard's two states agree on m, den
    and the quotient acc / den within 1e-4 of the scale (the logit
    convention, the row constant -D log pi dropped, is one)."""
    dev = _card()
    d = 512
    bank = _circ_bank(d, 32, dev, n_dead=3)
    x2 = _rows(1024, 2 * d, dev)
    states = []
    for lo, hi in ((0, 16), (16, 32)):
        ckb = tck.circ_kernel_bank(
            tsb.CirculantBank(*(x[lo:hi] for x in bank)), None, t, alpha)
        fact = _circ_forms(x2, ckb, t, alpha)[1:]
        wide = _circ_forms(x2, ckb, t, alpha, dense=True)[1:]
        for f, w in zip(fact[:2], wide[:2]):
            assert _rel(f, w) < 1e-4
        assert _rel(fact[2] / fact[1][:, None],
                    wide[2] / wide[1][:, None]) < 1e-4
        states.append((fact, wide))
    one = _circ_forms(x2, tck.circ_kernel_bank(bank, None, t, alpha), t,
                      alpha)[0]
    for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
        _, den, acc = tck.merge_stats(*zip(states[0][i], states[1][j]))
        merged = tck._x2(tsb.unitary_ifft(tck._hc(acc / den[:, None],
                                                  torch.complex64)))
        assert _rel(merged, one) < 1e-4, (i, j)


@pytest.mark.cuda
def test_circ_fact_stats_refuses_past_its_edges():
    """The factorised stats wrappers refuse T = 65, K = 129, a width that
    does not split (652 = 4 x 163), D = 673 and the dense wide form's
    operands; K9 refuses T = 1; the launch refuses a null m or den when
    stats is set (cudaErrorInvalidValue); N = 0 launches nothing and
    returns empty states; D = 652 keeps the dense wide K8."""
    dev = _card()
    ckb = tck.circ_kernel_bank(_circ_bank(200, 4, dev))
    x2 = _rows(130, 400, dev)
    with pytest.raises(ValueError, match="T"):
        tck.circ_estimate_coherent_stats_fact(x2, ckb, 65)
    with pytest.raises(ValueError, match="T >= 2"):
        tck.circ_estimate_coherent_stats_fact(x2, ckb, 1)
    many = tck.circ_kernel_bank(_circ_bank(200, 129, dev))
    with pytest.raises(ValueError, match="128"):
        tck.circ_estimate_stats_fact(x2, many)
    with pytest.raises(ValueError, match="circ_fact_operands"):
        tck.circ_estimate_stats_fact(x2, ckb, tck.circ_wide_operands(ckb,
                                                                     True))
    with pytest.raises(ValueError, match="circ_fact_operands"):
        tck.circ_estimate_stats(x2, ckb, tck.circ_wide_operands(ckb, True))
    past = tck.circ_kernel_bank(_circ_bank(673, 2, dev))
    with pytest.raises(ValueError, match="672"):
        tck.circ_estimate_stats_fact(_rows(8, 1346, dev), past)
    odd = tck.circ_kernel_bank(_circ_bank(652, 2, dev))
    x652 = _rows(64, 1304, dev)
    with pytest.raises(ValueError, match="652"):
        tck.circ_estimate_stats_fact(x652, odd)
    before = tkn.launch_counts()
    m, den, acc = tck.circ_estimate_stats_fact(x2[:0], ckb)
    assert m.shape == den.shape == (0,) and acc.shape == (0, 400)
    assert tkn.launch_counts() == before
    got = tck.circ_estimate_stats(x652, odd)
    after = tkn.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"circ_estimate_stats_wide": 1}
    for g, w in zip(got, tck._circ_reference(x652, odd, 1, 1.0, True, 16384)):
        assert _rel(g, w) < 1e-4
    ops = tck.circ_fact_operands(ckb)
    out = torch.empty_like(x2)
    m = torch.empty(130, device=dev)
    lib = tkn._library("circ_fact_estimate")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m_ptr, den_ptr in ((None, m.data_ptr()), (m.data_ptr(), None)):
        err = lib.circ_fact_launch(
            x2.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
            ops.lo2.data_ptr(), ckb.const.data_ptr(), ops.tw.data_ptr(),
            out.data_ptr(), m_ptr, den_ptr, 130, 200, ops.d1, ops.d2, 4,
            ops.hi.shape[0], 1, 1.0, 1, 0, stream)
        assert err == 1, err        # cudaErrorInvalidValue


@pytest.mark.cuda
def test_structured_service_on_card_matches_fft_pipeline():
    from quantized_channel_estimation_torch import serving
    dev = _card()
    d, k = 16, 8
    rng = np.random.default_rng(3)
    spectra = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    weights = np.full((k,), 1.0 / k, np.float32)
    means = np.zeros((k, d), np.complex64)
    r = (rng.standard_normal((64, d))
         + 1j * rng.standard_normal((64, d))).astype(np.complex64)
    dummy = torch.zeros((k, 1, 1), dtype=torch.complex64, device=dev)
    bank = tsb.prepare_bank_circulant(
        tg.GmmParams(torch.as_tensor(weights, device=dev),
                     torch.as_tensor(means, device=dev), dummy, dummy), 5.0,
        torch.tensor(1.0 + 0.0j), 2, tq.design_quantizer(5.0, 2).to(dev),
        spectra=torch.as_tensor(spectra, device=dev))
    rt = torch.as_tensor(r, device=dev)
    svc = serving.EstimationService.from_circulant_spectra(
        weights, means, spectra, 1.0 + 0.0j, 2, max_delay_ms=1.0)
    try:
        for req, want, kernel in (
                (r, tsb.estimate_circulant(bank, rt, method="fft"),
                 "circ_estimate"),
                (r.reshape(16, 4, d),
                 tsb.estimate_circulant_coherent(bank, rt.reshape(16, 4, d),
                                                 method="fft"),
                 "circ_estimate_coherent")):
            before = tkn.launch_counts()[kernel]
            got = svc.submit(req, 5.0, timeout=30)
            assert tkn.launch_counts()[kernel] > before
            want_np = want.cpu().numpy()
            assert got.shape == want_np.shape
            assert np.abs(got - want_np).max() < 1e-4
        assert svc.metrics()["requests_failed"] == 0
    finally:
        svc.close(timeout=30)


# ------------------------------------- the multi-pilot circulant kernel K10

def _mp_bank(p, d, k, dev, n_dead=0, blocks=None, n_bits=2):
    bank = _circ_bank(d, k, dev, n_dead, blocks, p=p, n_bits=n_bits,
                      multi=True)
    assert isinstance(bank, tsb.CirculantBankMP)
    return bank


# every width of the template (one, two and four 64-column pieces of 2D,
# one and two of K), P = 1, 2, 3, 4, ragged sizes, dead components, widths
# that are no multiple of 32, the kron basis, the three bit widths, and the
# edges of the rule (the largest P at D = K = 64 and at D = K = 128, both
# with 32 live rows a warpgroup, K = 128 at D = 64 and P = 4)
MP_SHAPES = [
    (1, 64, 64, 4097, 2, None, 2),
    (2, 8, 4, 1000, 0, None, 2),
    (3, 32, 40, 4097, 3, None, 2),
    (4, 16, 100, 333, 0, None, 2),
    (2, 64, 8, 77, 1, None, 1),
    (2, 64, 64, 10000, 5, None, 2),
    (3, 64, 64, 2049, 0, None, "inf"),
    (4, 64, 64, 4097, 2, (8, 8), 2),
    (4, 64, 128, 1001, 0, None, 2),
    (2, 128, 4, 100, 1, None, 2),
    (3, 100, 50, 517, 2, None, 2),
    (4, 128, 128, 2049, 0, (8, 16), 2),
    (16, 16, 8, 129, 0, None, 2),
    (11, 64, 64, 300, 2, None, 2),
    (5, 128, 128, 300, 0, None, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("p,d,k,n,n_dead,blocks,n_bits", MP_SHAPES)
def test_mp_circ_estimate_matches_plain(p, d, k, n, n_dead, blocks, n_bits):
    dev = _card()
    assert tmk.mp_circ_kernel_eligible(d, k, p)
    bank = _mp_bank(p, d, k, dev, n_dead, blocks, n_bits)
    assert int(torch.isinf(bank.log_weights).sum()) == n_dead
    ckb = tmk.mp_circ_kernel_bank(bank, blocks)
    x2 = _rows(n, 2 * p * d, dev)
    before = tkn.launch_counts()
    got = tmk.mp_circ_estimate(x2, ckb)
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert after["mp_circ_estimate"] == before["mp_circ_estimate"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert got.shape == (n, 2 * d)
    _held(got, tmk.mp_circ_estimate_reference(x2, ckb),
          tmk.mp_circ_estimate_reference(x2.double(), _f64(ckb)))
    # the entry on complex observations, against the torch.fft pipeline
    r = torch.view_as_complex(x2.reshape(n, p * d, 2).contiguous())
    got_c = stages.estimate_circulant(bank, r, blocks=blocks)
    assert tkn.launch_counts()["mp_circ_estimate"] \
        == after["mp_circ_estimate"] + 1
    want_c = tsb.estimate_circulant(bank, r, "all", 16384, blocks, "fft")
    assert got_c.dtype == torch.complex64 and got_c.shape == (n, d)
    assert float((got_c - want_c).abs().max() / want_c.abs().max()) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("p,d,k,n_blocks,t,alpha,n_dead", [
    (2, 8, 4, 500, 2, 1.0, 0),        # blocks inside a warp's rows
    (2, 64, 64, 1001, 4, 1.0, 3),     # main-path widths, ragged, dead
    (3, 64, 64, 333, 3, 0.25, 0),     # T that does not divide the tile
    (4, 16, 8, 100, 8, 0.25, 0),      # T = a warp's rows
    (2, 64, 40, 77, 16, 0.0, 1),      # blocks across warps, alpha 0
    (4, 64, 64, 9, 64, 1.0, 0),       # largest P and T at D = K = 64
    (4, 128, 128, 50, 32, 0.5, 2),    # largest P, D, K and T of the rule
    (3, 100, 50, 41, 5, 1.0, 0),      # widths no multiple of 32
])
def test_mp_circ_estimate_coherent_matches_plain(p, d, k, n_blocks, t, alpha,
                                                 n_dead):
    dev = _card()
    assert tmk.mp_circ_kernel_eligible(d, k, p, t)
    bank = _mp_bank(p, d, k, dev, n_dead)
    ckb = tmk.mp_circ_kernel_bank(bank, None, t, alpha)
    x2 = _rows(n_blocks * t, 2 * p * d, dev)
    before = tmk.mp_circ_estimate_coherent.launches
    got = tmk.mp_circ_estimate_coherent(x2, ckb, t, alpha)
    torch.cuda.synchronize()
    assert tmk.mp_circ_estimate_coherent.launches == before + 1
    _held(got, tmk.mp_circ_estimate_coherent_reference(x2, ckb, t, alpha),
          tmk.mp_circ_estimate_coherent_reference(x2.double(), _f64(ckb), t,
                                                  alpha))
    if alpha == 0.0:      # the per-snapshot estimator
        flat = tmk.mp_circ_estimate(x2, tmk.mp_circ_kernel_bank(bank))
        assert float((got - flat).abs().max() / flat.abs().max()) < 1e-4
    rb = torch.view_as_complex(
        x2.reshape(n_blocks, t, p * d, 2).contiguous())
    got_c = stages.estimate_circulant_coherent(bank, rb, alpha=alpha)
    assert tmk.mp_circ_estimate_coherent.launches == before + 2
    want_c = tsb.estimate_circulant_coherent(bank, rb, "all", 4096, alpha,
                                             None, "fft")
    assert got_c.shape == (n_blocks, t, d)
    assert float((got_c - want_c).abs().max() / want_c.abs().max()) < 3e-4


@pytest.mark.cuda
def test_mp_circ_kernel_refuses_bad_inputs_and_one_past_the_rule():
    dev = _card()
    bank = _mp_bank(2, 8, 4, dev)
    ckb = tmk.mp_circ_kernel_bank(bank)
    x2 = torch.zeros(12, 32, device=dev)
    with pytest.raises(ValueError):
        tmk.mp_circ_estimate(x2.double(), ckb)
    with pytest.raises(ValueError):
        tmk.mp_circ_estimate(torch.zeros(32, 12, device=dev).T, ckb)
    with pytest.raises(ValueError):
        tmk.mp_circ_estimate(torch.zeros(12, 48, device=dev), ckb)  # P = 3
    with pytest.raises(ValueError):
        tmk.mp_circ_estimate(x2, ckb._replace(const=ckb.const.cpu()))
    for t, rows in ((1, x2), (5, x2), (65, torch.zeros(130, 32, device=dev))):
        with pytest.raises(ValueError, match="T"):   # T = 1, N % T, T > tile
            tmk.mp_circ_estimate_coherent(rows, ckb, t)
    # one past the template's rule: P = 12 at D = K = 64 and P = 6 at D =
    # K = 128, D = 129, K = 129, T past a warpgroup's 32 live rows. The
    # template refuses them; the entries and the stages take the kernel
    # `mp_circ_route` names: the wide form, or at T = 33 (D = 128 = 8 x 16,
    # K = 8) the factorised kernel
    for p, d, k, t in ((12, 64, 64, 1), (6, 128, 128, 1), (2, 129, 4, 1),
                       (2, 8, 129, 1), (3, 128, 8, 33)):
        assert not tmk.mp_circ_narrow(d, k, p, t)
        assert tmk.mp_circ_kernel_eligible(d, k, p, t)
        wide = _mp_bank(p, d, k, dev)
        r = torch.zeros(2, t, p * d, dtype=torch.complex64, device=dev)
        r = r[:, 0] if t == 1 else r
        with pytest.raises(ValueError, match="shared memory"):
            x2w = torch.zeros(2 * t, 2 * p * d, device=dev)
            ckb_w = tmk.mp_circ_kernel_bank(wide, None, t)
            tmk.mp_circ_estimate(x2w, ckb_w) if t == 1 \
                else tmk.mp_circ_estimate_coherent(x2w, ckb_w, t)
        name = ("mp_circ_estimate" + ("_coherent" if t > 1 else "") + "_"
                + tmk.mp_circ_route(d, k, p, t))
        before = tkn.launch_counts()
        got = (stages.estimate_circulant if t == 1
               else stages.estimate_circulant_coherent)(wide, r,
                                                        method="kernel")
        after = tkn.launch_counts()
        assert torch.isfinite(torch.view_as_real(got)).all()
        assert {n: after[n] - before[n] for n in after
                if after[n] != before[n]} == {name: 1}
    before = tkn.launch_counts()
    assert tmk.mp_circ_estimate(x2[:0], ckb).shape == (0, 16)
    assert tmk.mp_circ_estimate_coherent(x2[:0], ckb, 2).shape == (0, 16)
    assert tkn.launch_counts() == before             # nothing to launch


# the wide K10: (P, D, K, N, dead components, T, alpha, blocks): one past
# the template's D, flat and pooled, the kron basis, K past one and past
# two logit slices (the softmax past 128 components), a P past the
# template's shared memory, D = 1 at many pilots, the pool at T = 3, 4, 16
# and 64
MP_WIDE_CASES = [
    (2, 129, 8, 2049, 1, 1, 1.0, None),
    (3, 144, 16, 4 * 257, 1, 4, 0.25, None),
    (2, 144, 8, 3 * 341, 0, 3, 0.5, None),
    (2, 256, 32, 2048, 2, 1, 1.0, (16, 16)),
    (2, 64, 300, 2049, 3, 1, 1.0, None),
    (2, 16, 1024, 4 * 256, 2, 4, 0.25, None),
    (12, 64, 16, 515, 0, 1, 1.0, None),
    (40, 1, 4, 16 * 20, 1, 16, 1.0, None),
    (4, 189, 8, 16 * 64, 1, 16, 1.0, None),
    (2, 200, 8, 64 * 9, 0, 64, 1.0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("p,d,k,n,n_dead,t,alpha,blocks", MP_WIDE_CASES)
def test_mp_circ_wide_matches_plain(p, d, k, n, n_dead, t, alpha, blocks):
    """The wide K10 (flat, or coherent at T > 1) within 1e-4 of the scale
    of its plain version `mp_circ_wide_reference` (where the two part by
    more, held to the float64 rule and within 1e-4 of the function in
    float64, `_held`), one launch counted on its own wrapper and none on
    another; its feature split (`mp_circ_wide_rows`) bit for bit the plain
    layout; and where the template's rule stops, the stages' 'auto'
    route launches the kernel `mp_circ_route` names there once and gives
    the same bits as that kernel's wrapper: the wide form, or the
    factorised kernel where the transform splits and its tile fits."""
    dev = _card()
    bank = _mp_bank(p, d, k, dev, n_dead, blocks)
    ckb = tmk.mp_circ_kernel_bank(bank, blocks, t, alpha)
    x2 = _rows(n, 2 * p * d, dev)
    u = _rows(300, 2 * p * d, dev, seed=5)
    assert torch.equal(tmk.mp_circ_wide_rows(u, p).cpu().view(torch.int16),
                       tmk.mp_circ_wide_rows(u.cpu(), p).view(torch.int16))
    name = "mp_circ_estimate" + ("_coherent" if t > 1 else "") + "_wide"
    before = tkn.launch_counts()
    got = (tmk.mp_circ_estimate_wide(x2, ckb) if t == 1
           else tmk.mp_circ_estimate_coherent_wide(x2, ckb, t, alpha))
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert {m: after[m] - before[m] for m in after
            if after[m] != before[m]} == {name: 1}
    _held(got, tmk.mp_circ_wide_reference(x2, ckb, t, alpha),
          tmk._mp_reference(x2.double(), _f64(ckb), t, alpha, 8192),
          ceiling=1e-4)
    if tmk.mp_circ_narrow(d, k, p, t):
        return
    if tmk.mp_circ_route(d, k, p, t, blocks) == "fact":
        name = "mp_circ_estimate" + ("_coherent" if t > 1 else "") + "_fact"
        got = (tmk.mp_circ_estimate_fact(x2, ckb) if t == 1
               else tmk.mp_circ_estimate_coherent_fact(x2, ckb, t, alpha))
        after = tkn.launch_counts()
    r = torch.view_as_complex(x2.reshape(n // t, t, p * d, 2).contiguous())
    if t == 1:
        got_c = stages.estimate_circulant(bank, r[:, 0], blocks=blocks)
    else:
        got_c = stages.estimate_circulant_coherent(bank, r, alpha=alpha,
                                                   blocks=blocks)
    assert tkn.launch_counts()[name] == after[name] + 1
    assert torch.equal(torch.view_as_real(got_c).reshape(n, 2 * d), got)


@pytest.mark.cuda
def test_mp_circ_wide_refuses_past_its_edges():
    """The wide K10 refuses D = 673, T = 65, a P whose 128 T rows pass the
    scratch, whole-block violations and the template's operands; N = 0
    launches nothing; past the rule 'auto' takes the `torch.fft`
    pipeline and 'kernel' raises."""
    dev = _card()
    ckb = tmk.mp_circ_kernel_bank(_mp_bank(2, 144, 4, dev))
    x2 = _rows(130, 4 * 144, dev)
    with pytest.raises(ValueError, match="T"):
        tmk.mp_circ_estimate_coherent_wide(x2, ckb, 65)
    with pytest.raises(ValueError, match="whole"):
        tmk.mp_circ_estimate_coherent_wide(x2, ckb, 4)
    with pytest.raises(ValueError, match="mp_circ_wide_operands"):
        tmk.mp_circ_estimate_wide(x2, ckb, tmk.mp_circ_tc_operands(
            tmk.mp_circ_kernel_bank(_mp_bank(2, 64, 4, dev))))
    before = tkn.launch_counts()
    assert tmk.mp_circ_estimate_wide(x2[:0], ckb).shape == (0, 288)
    assert tkn.launch_counts() == before
    for p, d, k, t in ((2, 673, 2, 1), (25, 128, 2, 16)):
        assert not tmk.mp_circ_kernel_eligible(d, k, p, t)
        past = _mp_bank(p, d, k, dev)
        rows = torch.zeros(t, 2 * p * d, device=dev)
        with pytest.raises(ValueError, match="multi-pilot circulant kernel"):
            (tmk.mp_circ_estimate_wide(rows, tmk.mp_circ_kernel_bank(past))
             if t == 1 else tmk.mp_circ_estimate_coherent_wide(
                 rows, tmk.mp_circ_kernel_bank(past, None, t), t))
        r = tmk._hc(rows, torch.complex64)
        r = r if t == 1 else r.reshape(1, t, p * d)
        est = (stages.estimate_circulant if t == 1
               else stages.estimate_circulant_coherent)
        with pytest.raises(ValueError, match="method='kernel'"):
            est(past, r, method="kernel")
        assert torch.equal(est(past, r), est(past, r, method="fft"))
    assert tkn.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
def test_mp_circ_wide_cuts_rows_to_its_scratch(monkeypatch, t):
    """Past `WIDE_SCRATCH` the wide K10 runs in row chunks of whole
    blocks, one counted launch each, bit for bit the one launch's output
    (a scratch of 512 rows' worth here: 2000 rows in four chunks)."""
    dev = _card()
    p, d, k = 2, 144, 200
    ckb = tmk.mp_circ_kernel_bank(_mp_bank(p, d, k, dev, n_dead=1), None, t,
                                  1.0)
    x2 = _rows(2000, 2 * p * d, dev)

    def run():
        return (tmk.mp_circ_estimate_wide(x2, ckb) if t == 1
                else tmk.mp_circ_estimate_coherent_wide(x2, ckb, t, 1.0))

    whole = run()
    per_row = tmk.mp_circ_wide_row_bytes(d, k, p)
    monkeypatch.setattr(tkn, "WIDE_SCRATCH", 512 * per_row + 100)
    assert tmk.mp_circ_wide_launch_rows(2000, d, k, p, t) == 512
    name = "mp_circ_estimate" + ("_coherent" if t > 1 else "") + "_wide"
    before = tkn.launch_counts()[name]
    cut = run()
    assert tkn.launch_counts()[name] == before + 4
    assert torch.equal(cut.view(torch.int32), whole.view(torch.int32))


@pytest.mark.cuda
def test_mp_circ_wide_repeated_launches_match_plain():
    """The wide K10 launched 20 times at each shape of
    `tools.tc_repeat_check.WIDE_MPCIRC_SHAPES`, each launch after a NaN
    fill of every SM's shared memory and on the memory of the last
    launch's output filled with NaN, each bit for bit the first launch,
    which is held against the plain version."""
    dev = _card()
    shapes = tc_repeat_check.WIDE_MPCIRC_SHAPES
    before = (tmk.mp_circ_estimate_wide.launches,
              tmk.mp_circ_estimate_coherent_wide.launches)
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("wide_mpcirc",))["kernel"]
    n_coh = sum(1 for s in shapes if s[5] > 1)
    assert tmk.mp_circ_estimate_wide.launches == before[0] + 20 * (
        len(shapes) - n_coh)
    assert tmk.mp_circ_estimate_coherent_wide.launches == before[1] \
        + 20 * n_coh
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


# the factorised K10 (csrc/mp_circ_fact_estimate.cu): (P, D, K, N, dead
# components, T, alpha, blocks): the served D = 256, K = 32 flat and
# pooled, 12 x 12 at T = 3, 16-row tiles (D = 336, K = 64; 357 = 17 x 21 at
# P = 3; 189 = 9 x 21 at P = 4), T = 64 past a tile's rows (two sweeps),
# one past the template's D (3 x 43), the kron basis, P past the
# template's shared memory at D = 64, K = 128, a single component; the
# route takes all but D = 129, T = 64 at D = 200 and K = 128 (the wide
# form is faster there), which run through the wrappers alone
MP_FACT_CASES = [
    (2, 256, 32, 2049, 2, 1, 1.0, None),
    (2, 256, 32, 4 * 512, 2, 4, 1.0, None),
    (3, 144, 16, 3 * 341, 1, 3, 0.5, None),
    (2, 336, 64, 1025, 3, 1, 1.0, None),
    (3, 357, 8, 4 * 256, 1, 4, 1.0, None),
    (4, 189, 8, 16 * 40, 1, 16, 1.0, None),
    (2, 200, 8, 64 * 9, 0, 64, 0.25, None),
    (2, 129, 8, 1001, 1, 1, 1.0, None),
    (2, 256, 16, 1000, 2, 1, 1.0, (16, 16)),
    (12, 64, 16, 515, 0, 1, 1.0, None),
    (2, 256, 128, 1024, 3, 64, 1.0, None),
    (2, 256, 1, 1000, 0, 1, 1.0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("p,d,k,n,n_dead,t,alpha,blocks", MP_FACT_CASES)
def test_mp_circ_fact_matches_plain(p, d, k, n, n_dead, t, alpha, blocks):
    """The factorised K10 (flat, or coherent at T > 1) with the operands
    laid out in the call (the basis read from the layout): within 1e-4 of
    the scale of its plain version `mp_circ_fact_reference` (where the two
    part by more, within 1e-4 of the float64 one and no further from it
    than twice the float32 plain version, `_held`) and no less accurate
    than float32 (the float64 rule: its max |error| against the function in
    float64 at most twice that of the float32 plain products,
    `_mp_reference`); one launch counted on its wrapper and none on
    another; where `mp_circ_route` says 'fact', the entry the same bits."""
    dev = _card()
    bank = _mp_bank(p, d, k, dev, n_dead, blocks)
    ckb = tmk.mp_circ_kernel_bank(bank, blocks, t, alpha)
    x2 = _rows(n, 2 * p * d, dev)
    name = "mp_circ_estimate" + ("_coherent" if t > 1 else "") + "_fact"
    before = tkn.launch_counts()
    got = (tmk.mp_circ_estimate_fact(x2, ckb) if t == 1
           else tmk.mp_circ_estimate_coherent_fact(x2, ckb, t, alpha))
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert {m: after[m] - before[m] for m in after
            if after[m] != before[m]} == {name: 1}
    want = tmk.mp_circ_fact_reference(x2, ckb, t, alpha, blocks)
    want64 = tmk.mp_circ_fact_reference(x2.double(), _f64(ckb), t, alpha,
                                        blocks)
    _held(got, want, want64, ceiling=1e-4)
    e_k = float((got.double() - want64).abs().max())
    e_p = float((tmk._mp_reference(x2, ckb, t, alpha, 8192).double()
                 - want64).abs().max())
    assert e_k <= 2 * e_p, (e_k, e_p)
    if tmk.mp_circ_route(d, k, p, t, blocks) != "fact":
        assert (d, k, t) in ((129, 8, 1), (200, 8, 64), (256, 128, 64))
        return
    r = torch.view_as_complex(x2.reshape(n // t, t, p * d, 2).contiguous())
    entry = (tmk.estimate_fused_circulant_mp(bank, r[:, 0], blocks) if t == 1
             else tmk.estimate_fused_circulant_mp_coherent(bank, r, alpha,
                                                           blocks))
    assert tkn.launch_counts()[name] == after[name] + 1
    assert torch.equal(torch.view_as_real(entry).reshape(n, 2 * d), got)


@pytest.mark.cuda
def test_mp_circ_fact_plan_is_the_kernels():
    """`mp_circ_fact_plan`, the rule's budget, is the kernel's own
    (`mp_circ_fact_plan` in csrc/mp_circ_fact_estimate.cu) at every width,
    pilot count, K and T of a grid, to the byte."""
    import ctypes
    _card()
    lib = tkn._library("mp_circ_fact_estimate")
    mt = ctypes.c_int(0)
    for d in (129, 144, 189, 200, 256, 336, 357, 512, 600, 64, 24):
        d1, d2 = tck.circ_fact_split(d)
        for p, k, t in ((1, 1, 1), (2, 8, 3), (2, 32, 4), (2, 128, 64),
                        (3, 32, 1), (3, 64, 16), (4, 8, 1), (5, 32, 1),
                        (8, 16, 64), (16, 1, 1), (17, 1, 1)):
            smem = lib.mp_circ_fact_plan(d1, d2, p, k, t, ctypes.byref(mt))
            got = (mt.value, smem) if smem else None
            assert got == tmk.mp_circ_fact_plan(d1, d2, p, k, t), (d, p, k, t)


@pytest.mark.cuda
def test_mp_circ_fact_refuses_past_its_edges():
    """The factorised K10 refuses a width that does not split (D = 249 = 3
    x 83), a P whose tile does not fit (D = 357, P = 4), T = 65, whole-block
    violations and the wide form's operands; N = 0 launches nothing."""
    dev = _card()
    ckb = tmk.mp_circ_kernel_bank(_mp_bank(2, 144, 4, dev))
    x2 = _rows(130, 4 * 144, dev)
    with pytest.raises(ValueError, match="whole T-row blocks"):
        tmk.mp_circ_estimate_coherent_fact(x2, ckb, 65)
    with pytest.raises(ValueError, match="whole T-row blocks"):
        tmk.mp_circ_estimate_coherent_fact(x2, ckb, 4)
    with pytest.raises(ValueError, match="mp_circ_fact_operands"):
        tmk.mp_circ_estimate_fact(x2, ckb, tmk.mp_circ_wide_operands(ckb))
    before = tkn.launch_counts()
    assert tmk.mp_circ_estimate_fact(x2[:0], ckb).shape == (0, 288)
    assert tkn.launch_counts() == before
    for p, d in ((3, 249), (4, 357)):
        past = tmk.mp_circ_kernel_bank(_mp_bank(p, d, 1, dev))
        with pytest.raises(ValueError, match="whole T-row blocks"):
            tmk.mp_circ_estimate_fact(_rows(4, 2 * p * d, dev), past)
        assert tmk.mp_circ_route(d, 1, p) == "wide"
    assert tkn.launch_counts() == before


@pytest.mark.cuda
def test_mp_circ_fact_repeated_launches_match_plain():
    """The factorised K10 launched 20 times at each shape of
    `tools.tc_repeat_check.FACT_MPCIRC_SHAPES` (D = 256 over two waves of
    blocks, T = 3 at alpha 0.5, the most pilots at D = 357, T = 64 past a
    tile's rows, the kron basis), each launch after a NaN fill of every
    SM's shared memory and on the memory of the last launch's output
    filled with NaN, each bit for bit the first launch, which is held
    against the plain version."""
    dev = _card()
    shapes = tc_repeat_check.FACT_MPCIRC_SHAPES
    before = tkn.launch_counts()
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("fact_mpcirc",))["kernel"]
    after = tkn.launch_counts()
    for coh, name in ((False, "mp_circ_estimate_fact"),
                      (True, "mp_circ_estimate_coherent_fact")):
        n = sum(1 for s in shapes if (s[5] > 1) == coh)
        assert after[name] == before[name] + 20 * n, name
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("p,d,k,n", [
    (2, 64, 64, 8192),      # the headline widths: two warpgroups a block
    (4, 64, 64, 8192),      # one warpgroup of 64 rows
    (4, 128, 128, 2048),    # the widest: 32 live rows, two pieces of K
])
def test_mp_circ_estimate_keeps_fp32_accuracy(t, p, d, k, n):
    """K10, six bf16 products for each of its four products, is no less
    accurate than float32: the max |error| against the plain version in
    float64 at most twice the float32 plain version's own, flat and
    coherent (T = 4, alpha 1), with dead components (the rule
    `test_fact_kernels_keep_fp32_accuracy` holds K11-K13 to). The operands
    laid out once give the same bits as those laid out in the call."""
    dev = _card()
    bank = _mp_bank(p, d, k, dev, n_dead=2)
    ckb = tmk.mp_circ_kernel_bank(bank, None, t, 1.0)
    x2 = _rows(n, 2 * p * d, dev)
    ops = tmk.mp_circ_tc_operands(ckb)
    if t == 1:
        run = lambda o: tmk.mp_circ_estimate(x2, ckb, o)  # noqa: E731
        want = tmk.mp_circ_estimate_reference(x2, ckb)
        want64 = tmk.mp_circ_estimate_reference(x2.double(), _f64(ckb))
    else:
        run = lambda o: tmk.mp_circ_estimate_coherent(  # noqa: E731
            x2, ckb, t, 1.0, o)
        want = tmk.mp_circ_estimate_coherent_reference(x2, ckb, t, 1.0)
        want64 = tmk.mp_circ_estimate_coherent_reference(
            x2.double(), _f64(ckb), t, 1.0)
    got = run(None)
    torch.cuda.synchronize()

    def err(x):
        return float((x.double() - want64).abs().max())

    assert torch.isfinite(got).all()
    assert err(got) <= 2 * err(want), (err(got), err(want))
    assert torch.equal(run(ops), got)


@pytest.mark.cuda
def test_mp_circ_repeated_launches_match_plain():
    """K10 flat and coherent launched 100 times at each shape of
    `tools.tc_repeat_check.MPCIRC_SHAPES` (one and two warpgroups a block,
    32 live rows, one, two and four pieces of 2D, two of K, each pool), each
    launch after a fill of every SM's shared memory with NaN, each bit for
    bit the first launch and held against the plain version."""
    dev = _card()
    shapes = tc_repeat_check.MPCIRC_SHAPES
    before = (tmk.mp_circ_estimate.launches,
              tmk.mp_circ_estimate_coherent.launches)
    runs = tc_repeat_check.repeat_check(dev, repeats=100,
                                        modes=("mpcirc",))["kernel"]
    n_coh = sum(1 for s in shapes if s[5] > 1)
    assert tmk.mp_circ_estimate.launches == before[0] + 100 * (
        len(shapes) - n_coh)
    assert tmk.mp_circ_estimate_coherent.launches == before[1] + 100 * n_coh
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
def test_multipilot_structured_service_on_card_matches_fft_pipeline():
    from quantized_channel_estimation_torch import serving
    dev = _card()
    p, d, k = 2, 16, 8
    rng = np.random.default_rng(3)
    spectra = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    weights = np.full((k,), 1.0 / k, np.float32)
    means = np.zeros((k, d), np.complex64)
    r = (rng.standard_normal((64, p * d))
         + 1j * rng.standard_normal((64, p * d))).astype(np.complex64)
    a = tp.pilot_matrix(d, p, 2, device=dev)
    dummy = torch.zeros((k, 1, 1), dtype=torch.complex64, device=dev)
    bank = tsb.prepare_bank_circulant(
        tg.GmmParams(torch.as_tensor(weights, device=dev),
                     torch.as_tensor(means, device=dev), dummy, dummy), 5.0,
        a, 2, tq.design_quantizer(5.0, 2).to(dev),
        spectra=torch.as_tensor(spectra, device=dev))
    rt = torch.as_tensor(r, device=dev)
    svc = serving.EstimationService.from_circulant_spectra(
        weights, means, spectra, a.cpu().numpy(), 2, max_delay_ms=1.0,
        use_kernels=True)
    try:
        for req, want, kernel in (
                (r, tsb.estimate_circulant(bank, rt, method="fft"),
                 "mp_circ_estimate"),
                (r.reshape(16, 4, p * d),
                 tsb.estimate_circulant_coherent(
                     bank, rt.reshape(16, 4, p * d), method="fft"),
                 "mp_circ_estimate_coherent")):
            before = tkn.launch_counts()[kernel]
            got = svc.submit(req, 5.0, timeout=30)
            assert tkn.launch_counts()[kernel] > before
            want_np = want.cpu().numpy()
            assert got.shape == want_np.shape
            assert np.abs(got - want_np).max() < 1e-4
        assert svc.metrics()["requests_failed"] == 0
    finally:
        svc.close(timeout=30)


# ---------------------------------------------------------------------------
# the factored (MFA) kernels K11-K13
# ---------------------------------------------------------------------------

def _fact_bank(d, k, m, dev, n_dead=0, zero_mean=False, n_bits=2, seed=0):
    """A factored bank of seeded MFA parameters (loadings of unit total
    power, psi on [0.05, 0.35]) at 10 dB under x0 = 1, and observations
    drawn from the mixture."""
    from quantized_channel_estimation_torch.models import mfa as tmfa
    from quantized_channel_estimation_torch.models import mfa_bank as tmb
    from quantized_channel_estimation_torch.ops import observation as tob
    g = torch.Generator().manual_seed(seed)

    def cr(*shape):
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)) * math.sqrt(0.5)

    w = torch.rand(k, generator=g) + 0.5
    w[:n_dead] = 1e-9
    params = tmfa.MfaParams(
        w / w.sum(), torch.zeros(k, d, dtype=torch.complex64) if zero_mean
        else 0.3 * cr(k, d), math.sqrt(0.8 / m) * cr(k, d, m),
        0.05 + 0.3 * torch.rand(k, d, generator=g))
    params = tmfa.MfaParams(*(x.to(dev) for x in params))
    q = tq.design_quantizer(10.0, n_bits)
    q = None if q is None else q.to(dev)
    bank = tmb.prepare_bank_factored(params, 10.0, torch.tensor(1.0 + 0j),
                                     n_bits, q)

    def observe(n):
        gd = torch.Generator(device=dev).manual_seed(seed + 1)
        c = torch.randint(0, k, (n,), generator=gd, device=dev)
        z = torch.complex(torch.randn(n, m, generator=gd, device=dev),
                          torch.randn(n, m, generator=gd, device=dev))
        e = torch.complex(torch.randn(n, d, generator=gd, device=dev),
                          torch.randn(n, d, generator=gd, device=dev))
        h = (params.means[c] + math.sqrt(0.5) * (
            (params.lambdas[c] @ z[:, :, None])[..., 0]
            + params.psis[c].sqrt() * e))
        return tob.observe(gd, h, 10.0, None, n_bits, q)
    return bank, observe


# (D, M) covering every instantiation: forward contraction chunks NCX = 1,
# 2, 4 (D <= 32, 64, 128) by combine contraction chunks NCU = 1, 2, 4
# (M <= 16, 32, 64)
FACT_WIDTHS = [(24, 6), (64, 16), (128, 9), (32, 20), (48, 32), (128, 24),
               (20, 40), (64, 64), (128, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", FACT_WIDTHS)
def test_fact_kernels_match_plain_at_every_width(d, m):
    """K11, K13 and K12 (T = 4 at alpha 0.25, the tile's largest T at
    alpha 1) of every instantiation against their plain versions, with a
    ragged N and dead components; where float32 sums in another order push
    K12 past 1e-4, both against the float64 evaluation."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    bank, observe = _fact_bank(d, 9, m, dev, n_dead=2)
    t_max = tfk.fact_tile_rows(d, m)
    x2 = tck._x2(observe(t_max * 37))
    fkb = tfk.fact_kernel_bank(bank)
    before = dict(tkn.launch_counts())
    got = tfk.fact_estimate(x2[:1001], fkb)
    want = tfk.fact_estimate_reference(x2[:1001], fkb)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    stats = tfk.fact_estimate_stats(x2[:1001], fkb)
    plain = tfk.fact_estimate_stats_reference(x2[:1001], fkb)
    torch.cuda.synchronize()
    for g, w in zip(stats, plain):
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        assert float((g - w).abs().max() / w.abs().max()) < 1e-4
    for t, alpha in ((4, 0.25), (t_max, 1.0)):
        rows = x2[:(x2.shape[0] // t) * t]
        fkb_t = tfk.fact_kernel_bank(bank, t, alpha)
        got = tfk.fact_estimate_coherent(rows, fkb_t, t, alpha)
        want = tfk.fact_estimate_coherent_reference(rows, fkb_t, t, alpha)
        want64 = tfk.fact_estimate_coherent_reference(
            rows.double(), type(fkb_t)(*(x.double() for x in fkb_t)), t,
            alpha)
        _held(got, want, want64)
    after = tkn.launch_counts()
    assert after["fact_estimate"] == before["fact_estimate"] + 1
    assert after["fact_estimate_stats"] == before["fact_estimate_stats"] + 1
    assert (after["fact_estimate_coherent"]
            == before["fact_estimate_coherent"] + 2)


@pytest.mark.cuda
def test_fact_kernels_refuse_bad_inputs_and_one_past_the_rule():
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    from quantized_channel_estimation_torch.models import mfa_bank as tmb
    dev = _card()
    bank, observe = _fact_bank(16, 4, 6, dev)
    fkb = tfk.fact_kernel_bank(bank)
    x2 = tck._x2(observe(64))
    with pytest.raises(ValueError):
        tfk.fact_estimate(x2.double(), fkb)
    with pytest.raises(ValueError):
        tfk.fact_estimate(x2, fkb._replace(const=fkb.const.cpu()))
    with pytest.raises(ValueError):
        tfk.fact_estimate(x2[:, :30], fkb)
    with pytest.raises(ValueError, match="T <= 64"):
        tfk.fact_estimate_coherent(x2.repeat(2, 1), tfk.fact_kernel_bank(
            bank, 128), 128)
    assert tfk.fact_estimate(x2[:0], fkb).shape == (0, 32)
    # the edges of the rule launch; one past them raises
    for d, m, t in ((128, 64, 64), (64, 32, 64), (65, 16, 33), (1, 1, 1)):
        wide, obs_w = _fact_bank(d, 2, m, dev)
        rw = obs_w(4 * t)
        h = tfk.estimate_fused_factored_coherent(wide, rw.reshape(4, t, d))
        torch.cuda.synchronize()
        assert torch.isfinite(h).all()
    # one past the template's D or M: the wide form launches; one past
    # the tile's T: every form refuses
    for d, m, t in ((129, 4, 1), (64, 65, 1), (64, 16, 65), (128, 64, 65)):
        wide = tmb.FactoredBank(
            torch.zeros(2, device=dev),
            *(torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype in (
                ((2, d), torch.complex64), ((2, d), torch.float32),
                ((2, m, d), torch.complex64), ((2, m), torch.complex64),
                ((2,), torch.float32), ((2, m, d), torch.complex64),
                ((2, m, d), torch.complex64), ((2, m, d), torch.complex64),
                ((2, d), torch.complex64), ((2, d), torch.complex64))))
        r = torch.zeros(t, d, dtype=torch.complex64, device=dev)
        if t == 1:
            before = tkn.launch_counts()["fact_estimate_wide"]
            h = tfk.estimate_fused_factored_coherent(wide, r[None])
            torch.cuda.synchronize()
            assert torch.isfinite(h).all() and h.shape == (1, 1, d)
            assert tkn.launch_counts()["fact_estimate_wide"] == before + 1
            continue
        with pytest.raises(ValueError, match="factored kernels take"):
            tfk.estimate_fused_factored_coherent(wide, r[None])
        with pytest.raises(ValueError, match="fact_kernel_eligible"):
            stages.estimate_factored_coherent(wide, r[None], method="kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K11", "K12", "K13"])
@pytest.mark.parametrize("d,m,k,n", [
    (64, 16, 64, 8192),     # the headline widths: A in registers
    (32, 6, 9, 4097),       # one forward chunk, padded 4M
    (128, 64, 6, 1001),     # the widest: 16-column pieces, A in shared memory
])
def test_fact_kernels_keep_fp32_accuracy(kernel, d, m, k, n):
    """K11, K12 (T = 4, alpha 1) and K13 (its un-normalised accumulator),
    six bf16 products for each of their two products, are no less accurate
    than float32: the max |error| against the plain version in float64 at
    most twice the float32 plain version's own, with dead components (the
    rule `test_grouped_estimate_keeps_fp32_accuracy` holds K1 to). The
    operands laid out once give the same bits as those laid out in the
    call."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    bank, observe = _fact_bank(d, k, m, dev, n_dead=2)
    x2 = tck._x2(observe(n - n % 4))
    t = 4 if kernel == "K12" else 1
    fkb = tfk.fact_kernel_bank(bank, t, 1.0)
    f64 = type(fkb)(*(x.double() for x in fkb))
    ops = tfk.fact_tc_operands(fkb)
    if kernel == "K11":
        run = lambda o: tfk.fact_estimate(x2, fkb, o)  # noqa: E731
        want = tfk.fact_estimate_reference(x2, fkb)
        want64 = tfk.fact_estimate_reference(x2.double(), f64)
    elif kernel == "K12":
        run = lambda o: tfk.fact_estimate_coherent(  # noqa: E731
            x2, fkb, 4, 1.0, o)
        want = tfk.fact_estimate_coherent_reference(x2, fkb, 4, 1.0)
        want64 = tfk.fact_estimate_coherent_reference(x2.double(), f64, 4,
                                                      1.0)
    else:
        run = lambda o: tfk.fact_estimate_stats(x2, fkb, o)[2]  # noqa: E731
        want = tfk.fact_estimate_stats_reference(x2, fkb)[2]
        want64 = tfk.fact_estimate_stats_reference(x2.double(), f64)[2]
    got = run(None)
    torch.cuda.synchronize()

    def err(x):
        return float((x.double() - want64).abs().max())

    assert torch.isfinite(got).all()
    assert err(got) <= 2 * err(want), (err(got), err(want))
    assert torch.equal(run(ops), got)


@pytest.mark.cuda
def test_fact_repeated_launches_match_plain():
    """K11, K12 and K13 launched 100 times at each shape of
    `tools.tc_repeat_check.FACT_SHAPES` (the combine's A in registers with
    one and two warpgroups, A in shared memory with 64-, 32- and 16-column
    pieces, each pooling route), each launch after a fill of every SM's
    shared memory with NaN, each bit for bit the first launch and held
    against the plain version."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    shapes = tc_repeat_check.FACT_SHAPES
    names = {"K11": tfk.fact_estimate, "K12": tfk.fact_estimate_coherent,
             "K13": tfk.fact_estimate_stats}
    before = {k: fn.launches for k, fn in names.items()}
    runs = tc_repeat_check.repeat_check(dev, repeats=100,
                                        modes=("fact",))["kernel"]
    for key, fn in names.items():
        assert fn.launches == before[key] + 100 * sum(
            1 for s in shapes if s[-1] == key)
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


# the wide K11-K13: (D, K, M, N, dead components, T, alpha, kernel): one
# past the template's D and M, the JAX rule's reach (K 39 at D = 256, M =
# 16; K 10 at M = 64; K 19 at D = 512; K 2 at D = 2048; K = 1 at D = 5551,
# M = 16, at D = 64, M = 2475 and at D = 10334 at T = 16), K past one logit
# slice, the pool at T = 4 and 16
FACT_WIDE_CASES = [
    (129, 4, 4, 2049, 1, 1, 1.0, "K11"),
    (144, 8, 8, 4 * 257, 1, 4, 0.25, "K12"),
    (128, 4, 96, 1001, 1, 1, 1.0, "K13"),
    (96, 3, 72, 16 * 64, 0, 16, 1.0, "K12"),
    (256, 39, 16, 2049, 3, 1, 1.0, "K11"),
    (256, 10, 64, 2048, 2, 1, 1.0, "K13"),
    (512, 19, 16, 4 * 256, 2, 4, 1.0, "K12"),
    (2048, 2, 32, 513, 0, 1, 1.0, "K11"),
    (5551, 1, 16, 257, 0, 1, 1.0, "K11"),
    (64, 1, 2475, 513, 0, 1, 1.0, "K11"),
    (10334, 1, 1, 16 * 16, 0, 16, 1.0, "K12"),
    (136, 200, 2, 1001, 3, 1, 1.0, "K13"),
]
FACT_WIDE_NAMES = {"K11": "fact_estimate_wide",
                   "K12": "fact_estimate_coherent_wide",
                   "K13": "fact_estimate_stats_wide"}


def _fact_wide_run(tfk, kernel, x2, fkb, t, alpha, ops=None):
    if kernel == "K11":
        return (tfk.fact_estimate_wide(x2, fkb, ops),)
    if kernel == "K12":
        return (tfk.fact_estimate_coherent_wide(x2, fkb, t, alpha, ops),)
    return tfk.fact_estimate_stats_wide(x2, fkb, ops)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,m,n,n_dead,t,alpha,kernel", FACT_WIDE_CASES)
def test_fact_wide_matches_plain(d, k, m, n, n_dead, t, alpha, kernel):
    """The wide K11, K12 or K13 within 1e-4 of the scale of its plain
    version `fact_wide_reference` (K13: each of m, den and the
    accumulator; where the two part by more, held to the float64 rule and
    within 1e-4 of the function in float64, `_held`), one launch counted
    on its own wrapper and none on another; for K11 and K12 the stages'
    'auto' route launches it once more and gives the same bits."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    assert not tfk.fact_narrow(d, k, m, t)
    bank, observe = _fact_bank(d, k, m, dev, n_dead=n_dead)
    r = observe(n)
    x2 = tck._x2(r)
    fkb = tfk.fact_kernel_bank(bank, t, alpha)
    stats = kernel == "K13"
    name = FACT_WIDE_NAMES[kernel]
    before = tkn.launch_counts()
    got = _fact_wide_run(tfk, kernel, x2, fkb, t, alpha)
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert {w: after[w] - before[w] for w in after
            if after[w] != before[w]} == {name: 1}
    want = tfk.fact_wide_reference(x2, fkb, t, alpha, stats)
    want64 = tfk._fact_reference(x2.double(), _f64(fkb), t, alpha, stats,
                                 8192)
    for g, w, w64 in zip(got, want, want64) if stats else (
            (got[0], want, want64),):
        _held(g, w, w64, ceiling=1e-4)
    if stats:
        return
    if t == 1:
        via = stages.estimate_factored(bank, r)
    else:
        via = stages.estimate_factored_coherent(bank, r.reshape(-1, t, d),
                                                alpha=alpha)
    assert tkn.launch_counts()[name] == after[name] + 1
    assert torch.equal(tck._x2(via.reshape(n, d)), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K11", "K12", "K13"])
def test_fact_wide_keeps_fp32_accuracy(kernel):
    """The wide K11, K12 (T = 4, alpha 1) and K13 at D = 256, K = 32, M =
    16 (the JAX docstring's widths), six bf16 products a 64-deep chunk in
    compensated sums: the max |error| against the plain version in
    float64 at most twice the float32 plain version's own, with dead
    components; the operands laid out once give the same bits as those
    laid out in the call."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    d, k, m, n = 256, 32, 16, 8192
    bank, observe = _fact_bank(d, k, m, dev, n_dead=2)
    x2 = tck._x2(observe(n))
    t = 4 if kernel == "K12" else 1
    fkb = tfk.fact_kernel_bank(bank, t, 1.0)
    stats = kernel == "K13"
    got = _fact_wide_run(tfk, kernel, x2, fkb, t, 1.0)
    plain = tfk._fact_reference(x2, fkb, t, 1.0, stats, 8192)
    exact = tfk._fact_reference(x2.double(), _f64(fkb), t, 1.0, stats, 8192)
    for g, p, e in zip(got, plain, exact) if stats else (
            (got[0], plain, exact),):
        scale = float(e.abs().max())
        err_k = float((g.double() - e).abs().max()) / scale
        err_p = float((p.double() - e).abs().max()) / scale
        assert err_k <= 2 * err_p, (err_k, err_p)
    ops = tfk.fact_wide_operands(fkb)
    again = _fact_wide_run(tfk, kernel, x2, fkb, t, 1.0, ops)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_fact_wide_refuses_past_its_edges():
    """The wide K11-K13 refuse T = 65, whole-block violations and the
    template's operands; N = 0 launches nothing; past the rule 'auto'
    takes the `torch.matmul` pipeline and 'kernel' raises."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    from quantized_channel_estimation_torch.models import mfa_bank as tmb
    dev = _card()
    bank, observe = _fact_bank(144, 4, 4, dev)
    fkb = tfk.fact_kernel_bank(bank)
    x2 = tck._x2(observe(130))
    with pytest.raises(ValueError, match="T"):
        tfk.fact_estimate_coherent_wide(x2, fkb, 65)
    with pytest.raises(ValueError, match="whole"):
        tfk.fact_estimate_coherent_wide(x2, fkb, 4)
    with pytest.raises(ValueError, match="fact_wide_operands"):
        tfk.fact_estimate_wide(x2, fkb, tfk.fact_wide_operands(
            tfk.fact_kernel_bank(_fact_bank(144, 4, 5, dev)[0])))
    before = tkn.launch_counts()
    assert tfk.fact_estimate_wide(x2[:0], fkb).shape == (0, 288)
    m, den, acc = tfk.fact_estimate_stats_wide(x2[:0], fkb)
    assert m.shape == den.shape == (0,) and acc.shape == (0, 288)
    assert tkn.launch_counts() == before
    r = observe(130).reshape(2, 65, 144)
    with pytest.raises(ValueError, match="factored kernels take"):
        tfk.estimate_fused_factored_coherent(bank, r)
    with pytest.raises(ValueError, match="fact_kernel_eligible"):
        stages.estimate_factored_coherent(bank, r, method="kernel")
    assert torch.equal(stages.estimate_factored_coherent(bank, r),
                       tmb.estimate_factored_coherent(bank, r, "all", 1024))
    assert tkn.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
def test_fact_wide_cuts_rows_to_its_scratch(monkeypatch, t):
    """Past `WIDE_SCRATCH` the wide K11 / K12 runs in row chunks of whole
    blocks, one counted launch each, bit for bit the one launch's output
    (a scratch of 512 rows' worth here: 2000 rows in four chunks)."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    d, k, m = 144, 130, 2
    bank, observe = _fact_bank(d, k, m, dev, n_dead=1)
    fkb = tfk.fact_kernel_bank(bank, t, 1.0)
    x2 = tck._x2(observe(2000))
    kernel = "K12" if t > 1 else "K11"
    whole = _fact_wide_run(tfk, kernel, x2, fkb, t, 1.0)[0]
    per_row = tfk.fact_wide_row_bytes(d, k, m)
    monkeypatch.setattr(tkn, "WIDE_SCRATCH", 512 * per_row + 100)
    assert tfk.fact_wide_launch_rows(2000, d, k, m, t) == 512
    name = FACT_WIDE_NAMES[kernel]
    before = tkn.launch_counts()[name]
    cut = _fact_wide_run(tfk, kernel, x2, fkb, t, 1.0)[0]
    assert tkn.launch_counts()[name] == before + 4
    assert torch.equal(cut.view(torch.int32), whole.view(torch.int32))


@pytest.mark.cuda
def test_fact_wide_repeated_launches_match_plain():
    """The wide K11-K13 launched 20 times at each shape of
    `tools.tc_repeat_check.WIDE_FACT_SHAPES`, each launch after a NaN fill
    of every SM's shared memory and on the memory of the last launch's
    outputs filled with NaN, each bit for bit the first launch, which is
    held against the plain version."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    shapes = tc_repeat_check.WIDE_FACT_SHAPES
    names = {key: getattr(tfk, name) for key, name in
             FACT_WIDE_NAMES.items()}
    before = {key: fn.launches for key, fn in names.items()}
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("wide_fact",))["kernel"]
    for key, fn in names.items():
        assert fn.launches == before[key] + 20 * sum(
            1 for s in shapes if s[-1] == key)
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


# the fused K11 / K12: (D, K, M, N, dead components, T, alpha, kernel): one
# past the template's D, the served D = 256, K = 32, M = 16 (a ragged last
# tile, T = 4), the JAX rule's K = 39, a ragged half (2D = 510, M = 7), M =
# 3 over halves of 4 and 3 chunks, the pool at T = 3, 16 and 64, one
# component
FACT_FUSED_CASES = [
    (129, 4, 4, 2049, 1, 1, 1.0, "K11"),
    (256, 32, 16, 4097, 2, 1, 1.0, "K11"),
    (256, 32, 16, 4 * 1025, 2, 4, 1.0, "K12"),
    (256, 39, 16, 2049, 3, 1, 1.0, "K11"),
    (255, 9, 7, 333, 1, 1, 1.0, "K11"),
    (200, 7, 3, 3 * 333, 0, 3, 0.5, "K12"),
    (144, 8, 8, 16 * 65, 1, 16, 0.25, "K12"),
    (192, 3, 16, 64 * 10, 1, 64, 1.0, "K12"),
    (256, 1, 16, 2049, 0, 1, 1.0, "K11"),
    (256, 1, 16, 4 * 513, 0, 4, 1.0, "K12"),
]
FACT_FUSED_NAMES = {"K11": "fact_estimate_fused",
                    "K12": "fact_estimate_coherent_fused"}


def _fact_fused_run(tfk, kernel, x2, fkb, t, alpha, ops=None):
    if kernel == "K11":
        return tfk.fact_estimate_fused(x2, fkb, ops)
    return tfk.fact_estimate_coherent_fused(x2, fkb, t, alpha, ops)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,m,n,n_dead,t,alpha,kernel", FACT_FUSED_CASES)
def test_fact_fused_matches_plain(d, k, m, n, n_dead, t, alpha, kernel):
    """The fused K11 or K12 within 1e-4 of the scale of its plain version
    `fact_fused_reference` (or, where the two part by more, held to the
    float64 rule, `_held`), one launch counted on its own wrapper and none
    on another; the stages' 'auto' route keeps the wide form, launches
    it not at all and agrees with it likewise."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    assert tfk.fact_fused_fits(d, m, t)
    bank, observe = _fact_bank(d, k, m, dev, n_dead=n_dead)
    r = observe(n)
    x2 = tck._x2(r)
    fkb = tfk.fact_kernel_bank(bank, t, alpha)
    name = FACT_FUSED_NAMES[kernel]
    before = tkn.launch_counts()
    got = _fact_fused_run(tfk, kernel, x2, fkb, t, alpha)
    torch.cuda.synchronize()
    after = tkn.launch_counts()
    assert {w: after[w] - before[w] for w in after
            if after[w] != before[w]} == {name: 1}
    want = tfk.fact_fused_reference(x2, fkb, t, alpha)
    want64 = tfk._fact_reference(x2.double(), _f64(fkb), t, alpha, False,
                                 8192)
    _held(got, want, want64, ceiling=1e-4)
    if t == 1:
        via = stages.estimate_factored(bank, r)
    else:
        via = stages.estimate_factored_coherent(bank, r.reshape(-1, t, d),
                                                alpha=alpha)
    assert tkn.launch_counts()[name] == after[name]
    _held(tck._x2(via.reshape(n, d)), got, want64, ceiling=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K11", "K12"])
def test_fact_fused_keeps_fp32_accuracy(kernel):
    """The fused K11 and K12 (T = 4, alpha 1) at D = 256, K = 32, M = 16:
    the max |error| against the plain version in float64 at most twice the
    float32 plain version's own, with dead components; the operands laid
    out once give the same bits as those laid out in the call."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    d, k, m, n = 256, 32, 16, 8192
    bank, observe = _fact_bank(d, k, m, dev, n_dead=2)
    x2 = tck._x2(observe(n))
    t = 4 if kernel == "K12" else 1
    fkb = tfk.fact_kernel_bank(bank, t, 1.0)
    got = _fact_fused_run(tfk, kernel, x2, fkb, t, 1.0)
    plain = tfk._fact_reference(x2, fkb, t, 1.0, False, 8192)
    exact = tfk._fact_reference(x2.double(), _f64(fkb), t, 1.0, False, 8192)
    scale = float(exact.abs().max())
    err_k = float((got.double() - exact).abs().max()) / scale
    err_p = float((plain.double() - exact).abs().max()) / scale
    assert err_k <= 2 * err_p, (err_k, err_p)
    ops = tfk.fact_fused_operands(fkb)
    assert torch.equal(_fact_fused_run(tfk, kernel, x2, fkb, t, 1.0, ops),
                       got)


@pytest.mark.cuda
def test_fact_fused_refuses_past_its_edges():
    """The fused wrappers refuse one past their tile's edges (D = 257, D =
    128, M = 17, T = 65), whole-block violations and another bank's
    operands; N = 0 launches nothing; the entries launch them not at
    all."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    for d, m in ((257, 16), (128, 8), (200, 17)):
        bank, observe = _fact_bank(d, 4, m, dev)
        with pytest.raises(ValueError, match="D <= 256"):
            tfk.fact_estimate_fused(tck._x2(observe(64)),
                                    tfk.fact_kernel_bank(bank))
        before = tkn.launch_counts()
        tfk.estimate_fused_factored(bank, observe(64))
        after = tkn.launch_counts()
        assert after["fact_estimate_fused"] == before["fact_estimate_fused"]
    bank, observe = _fact_bank(144, 4, 4, dev)
    fkb = tfk.fact_kernel_bank(bank)
    x2 = tck._x2(observe(130))
    with pytest.raises(ValueError, match="T <= 64"):
        tfk.fact_estimate_coherent_fused(x2, fkb, 65)
    with pytest.raises(ValueError, match="whole"):
        tfk.fact_estimate_coherent_fused(x2, fkb, 4)
    with pytest.raises(ValueError, match="fact_fused_operands"):
        tfk.fact_estimate_fused(x2, fkb, tfk.fact_fused_operands(
            tfk.fact_kernel_bank(_fact_bank(144, 5, 4, dev)[0])))
    before = tkn.launch_counts()
    assert tfk.fact_estimate_fused(x2[:0], fkb).shape == (0, 288)
    assert tkn.launch_counts() == before


@pytest.mark.cuda
def test_fact_fused_merges_with_wide_k13_shards():
    """At D = 256, K = 32, M = 16: two component shards through the wide
    K13 (K13 has no fused form), merged, within 1e-4 of the scale of the
    fused K11 over the whole bank."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    d, k, m = 256, 32, 16
    bank, observe = _fact_bank(d, k, m, dev, n_dead=2)
    x2 = tck._x2(observe(2048))
    flat = tfk.fact_kernel_bank(bank)
    states = [tfk.fact_estimate_stats_wide(x2, tfk.FactKernelBank(
        *(x[j * k // 2:(j + 1) * k // 2] for x in flat))) for j in range(2)]
    _, den, acc = tck.merge_stats(*zip(*states))
    whole = tfk.fact_estimate_fused(x2, flat)
    assert float((acc / den[:, None] - whole).abs().max()
                 / whole.abs().max()) < 1e-4


@pytest.mark.cuda
def test_fact_fused_repeated_launches_match_plain():
    """The fused K11 / K12 launched 20 times at each shape of
    `tools.tc_repeat_check.FUSED_FACT_SHAPES`, each launch after a NaN fill
    of every SM's shared memory and on the memory of the last launch's
    outputs filled with NaN, each bit for bit the first launch, which is
    held against the plain version."""
    from quantized_channel_estimation_torch.estimators import (
        fact_kernels as tfk)
    dev = _card()
    shapes = tc_repeat_check.FUSED_FACT_SHAPES
    names = {key: getattr(tfk, name) for key, name in
             FACT_FUSED_NAMES.items()}
    before = {key: fn.launches for key, fn in names.items()}
    runs = tc_repeat_check.repeat_check(dev, repeats=20,
                                        modes=("fused_fact",))["kernel"]
    for key, fn in names.items():
        assert fn.launches == before[key] + 20 * sum(
            1 for s in shapes if s[-1] == key)
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
def test_factored_service_on_card_matches_pipeline():
    """`from_mfa` on the card: flat requests through K11 and T = 4 blocks
    through K12, each answer within 1e-4 of the `torch.matmul` pipeline."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.models import mfa as tmfa
    from quantized_channel_estimation_torch.models import mfa_bank as tmb
    dev = _card()
    g = torch.Generator().manual_seed(3)
    k, d, m = 8, 32, 8
    params = tmfa.MfaParams(
        torch.full((k,), 1.0 / k),
        torch.zeros(k, d, dtype=torch.complex64),
        torch.complex(torch.randn(k, d, m, generator=g),
                      torch.randn(k, d, m, generator=g)) * 0.25,
        0.1 + 0.3 * torch.rand(k, d, generator=g))
    svc = serving.EstimationService.from_mfa(params, 1.0, 2, max_delay_ms=1.0,
                                             device=dev)
    try:
        assert svc.factored and svc.use_kernels
        rng = np.random.default_rng(0)
        r = (rng.choice([-0.6, 0.6], (64, d))
             + 1j * rng.choice([-0.6, 0.6], (64, d))).astype(np.complex64)
        before = tkn.launch_counts()
        flat = svc.submit(r, 10.0, timeout=60.0)
        blocks = svc.submit(r.reshape(16, 4, d), 10.0, timeout=60.0)
        after = tkn.launch_counts()
        assert after["fact_estimate"] > before["fact_estimate"]
        assert (after["fact_estimate_coherent"]
                > before["fact_estimate_coherent"])
        bank = svc._banks[svc._snap(10.0)].bank
        rt = torch.as_tensor(r, device=dev)
        want = tmb.estimate_factored(bank, rt).cpu().numpy()
        want_b = tmb.estimate_factored_coherent(
            bank, rt.reshape(16, 4, d)).cpu().numpy()
        assert np.abs(flat - want).max() / np.abs(want).max() < 1e-4
        assert np.abs(blocks - want_b).max() / np.abs(want_b).max() < 1e-4
    finally:
        svc.close(timeout=60.0)


# ---------------------------------------------------------------------------
# K1's variants: K14a (Karatsuba), K14b (bf16 tensor cores), K15 (the floor
# probe). K14b's bf16 products are exact in float32 on both sides, so it is
# held against its plain version like the float32 kernels (1e-4).
# ---------------------------------------------------------------------------

_rand_karatsuba = tc_repeat_check.random_karatsuba_bank


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k,n,n_dead", [
    (64, 64, 64, 4097, 3),   # main-path widths, ragged N, dead components
    (12, 12, 5, 333, 0),     # widths no multiple of 16
    (40, 100, 6, 515, 1),    # M <= 64 < D: 32-column pieces, 4 value pieces
    (128, 40, 6, 300, 0),    # D <= 64 < M: two contraction chunks
    (128, 128, 4, 200, 1),   # the widest
    (64, 64, 64, 20000, 2),  # two consumer warpgroups a block
    (64, 32, 8, 3 * 132 * 128 + 5, 0),  # three waves of 128-row blocks
    (64, 64, 1, 1, 0),       # N = 1, K = 1
    (64, 64, 5, 127, 4),     # a 128-row block less one; all dead but one
    (64, 64, 5, 129, 0),     # a block and one row
    (33, 65, 3, 100, 0),     # odd widths, 32-column pieces
    (100, 20, 3, 64, 0),     # two chunks, one padded value piece
])
def test_karatsuba_estimate_matches_plain(m, d, k, n, n_dead):
    dev = _card()
    kb = _rand_karatsuba(m, d, k, dev, n_dead)
    r_re, r_im = _rows(n, m, dev), _rows(n, m, dev, seed=2)
    before = tvk.karatsuba_estimate.launches
    h_re, h_im = tvk.karatsuba_estimate(r_re, r_im, kb)
    torch.cuda.synchronize()
    assert tvk.karatsuba_estimate.launches == before + 1
    w_re, w_im = tvk.reference_estimate_packed(kb, r_re, r_im)
    got, want = torch.cat([h_re, h_im], -1), torch.cat([w_re, w_im], -1)
    assert got.shape == (n, 2 * d) and torch.isfinite(got).all()
    assert _rel(got, want) < 1e-4
    # the operands laid out once give the same bits
    again = torch.cat(tvk.karatsuba_estimate(
        r_re, r_im, kb, tvk.karatsuba_operands(kb)), -1)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k,n,n_dead", [
    (64, 64, 16, 4097, 3),    # main-path widths
    (40, 100, 6, 515, 1),     # 32-column pieces
    (128, 128, 4, 200, 1),    # the widest
])
def test_karatsuba_estimate_keeps_fp32_accuracy(m, d, k, n, n_dead):
    """K14a, six bf16 products for each of its three real products, is no
    less accurate than float32: the max |error| against the plain version
    in float64 at most twice the float32 plain version's own, with dead
    components (the rule `test_grouped_estimate_keeps_fp32_accuracy` holds
    K1 to)."""
    dev = _card()
    kb = _rand_karatsuba(m, d, k, dev, n_dead)
    r_re, r_im = _rows(n, m, dev), _rows(n, m, dev, seed=2)
    got = torch.cat(tvk.karatsuba_estimate(r_re, r_im, kb), -1)
    want = torch.cat(tvk.reference_estimate_packed(kb, r_re, r_im), -1)
    want64 = torch.cat(tvk.reference_estimate_packed(
        tvk.KernelBank(*(x.double() for x in kb)), r_re.double(),
        r_im.double()), -1)

    def err(x):
        return float((x.double() - want64).abs().max())

    assert torch.isfinite(got).all()
    assert err(got) <= 2 * err(want), (err(got), err(want))


@pytest.mark.cuda
def test_karatsuba_repeated_launches_match_plain():
    """K14a launched 100 times at each shape of
    `tools.tc_repeat_check.KARATSUBA_SHAPES`, each launch after a fill of
    every SM's shared memory with NaN, each bit for bit the first launch
    and within 1e-4 of the plain version."""
    dev = _card()
    shapes = tc_repeat_check.KARATSUBA_SHAPES
    before = tvk.karatsuba_estimate.launches
    runs = tc_repeat_check.repeat_check(dev, repeats=100,
                                        modes=("karatsuba",))["kernel"]
    assert tvk.karatsuba_estimate.launches == before + 100 * len(shapes)
    assert len(runs) == len(shapes)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs


@pytest.mark.cuda
def test_karatsuba_estimate_is_k1_on_a_bank():
    """The same function as K1 on one bank (dead components, ragged N)."""
    dev = _card()
    bank = _bank(32, 8, 1, dev, n_dead=2)
    r = torch.complex(_rows(1001, 32, dev), _rows(1001, 32, dev, seed=3))
    got = tvk.estimate(bank, r)
    want = tkn.estimate_fused(bank, r)
    assert _rel(torch.view_as_real(got), torch.view_as_real(want)) < 1e-4
    with pytest.raises(ValueError, match="128"):
        tvk.karatsuba_estimate(_rows(4, 130, dev), _rows(4, 130, dev),
                               _rand_karatsuba(130, 8, 2, dev))
    kb = _rand_karatsuba(8, 8, 2, dev)
    with pytest.raises(ValueError):
        tvk.karatsuba_estimate(_rows(4, 8, dev).double(), _rows(4, 8, dev),
                               kb)
    empty = tvk.karatsuba_estimate(_rows(4, 8, dev)[:0], _rows(4, 8, dev)[:0],
                                   kb)
    assert empty[0].shape == (0, 8)
    with pytest.raises(ValueError, match="karatsuba_operands"):
        tvk.karatsuba_estimate(_rows(4, 8, dev), _rows(4, 8, dev), kb,
                               tvk.karatsuba_operands(_rand_karatsuba(
                                   8, 8, 3, dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "split2", "split3"])
@pytest.mark.parametrize("two_m,two_d,k,n,n_dead", [
    (128, 128, 16, 4097, 3),  # main-path widths, ragged N, dead components
    (24, 24, 5, 333, 0),      # D = 12: widths no multiple of 16
    (40, 100, 6, 515, 1),     # 2D = 100: two value pieces, one padded
    (256, 256, 4, 200, 1),    # the widest: one warpgroup, 4 chunks
    (256, 24, 3, 70, 0),      # 2M = 256, one padded value piece
    (128, 128, 1, 1, 0),      # N = 1, K = 1
    (128, 128, 5, 127, 4),    # a 128-row block less one; all dead but one
    (128, 128, 5, 129, 0),    # a block and one row
    (64, 192, 3, 65, 0),      # 2D = 192: the widest two-warpgroup block
    (128, 128, 64, 3 * 132 * 128 + 5, 0),  # three waves of 132 blocks
])
def test_grouped_tc_matches_plain(mode, two_m, two_d, k, n, n_dead):
    dev = _card()
    kb = _rand_kb(two_m, two_d, k, dev, n_dead)
    planes = tkn.split_planes(kb.pw)
    r2 = _rows(n, two_m, dev)
    wrapper = tvk.TC_WRAPPERS[mode]
    before = wrapper.launches
    got = wrapper(r2, kb, planes)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = tvk.grouped_tc_estimate_reference(r2, kb, planes, tvk.MODES[mode])
    assert got.shape == (n, two_d) and torch.isfinite(got).all()
    assert _rel(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "split2", "split3"])
def test_grouped_tc_repeated_launches_match_plain(mode):
    """K14b launched 100 times at each shape of `tools.tc_repeat_check`
    (the shared-memory-A path at 2M > 128 with one and two warpgroups, one
    block to three waves, and a main-path shape), each launch after a fill
    of every SM's shared memory with NaN and held against the plain
    version: a race that one launch may not show fails here."""
    dev = _card()
    wrapper = tvk.TC_WRAPPERS[mode]
    before = wrapper.launches
    got = tc_repeat_check.repeat_check(dev, repeats=100, modes=(mode,))
    runs = got["kernel"]
    assert wrapper.launches == before + 100 * len(tc_repeat_check.SHAPES)
    assert len(runs) == len(tc_repeat_check.SHAPES)
    assert not {k: v for k, v in runs.items() if v["failures"]}, runs
    assert max(v["max_err"] for v in runs.values()) < 1e-4


@pytest.mark.cuda
def test_precision_modes_on_a_bank_within_jax_bounds():
    """Each mode's estimate against K1 (`mode='f32'`) within the JAX tests'
    bounds (relative norms 3e-2, 1e-4, 3e-2), the planes cached beside the
    bank; refusals as on the CPU."""
    dev = _card()
    bank = _bank(64, 16, 1, dev, n_dead=1)
    r = torch.complex(_rows(2000, 64, dev), _rows(2000, 64, dev, seed=3))
    cache = {}
    f32 = tvk.estimate_block_grouped(bank, r, "f32", cache)
    for mode, bound in (("bf16", 3e-2), ("split3", 1e-4), ("split2", 3e-2)):
        got = tvk.estimate_block_grouped(bank, r, mode, cache)
        rel = float(torch.linalg.vector_norm(got - f32)
                    / torch.linalg.vector_norm(f32))
        assert rel < bound, (mode, rel)
    kb, planes, ops = tkn.lowered_tc(bank, cache)
    assert cache["tc_operands"] is ops
    with pytest.raises(ValueError, match="bfloat16"):
        tvk.grouped_tc_split3(tkn._r2(r), kb, (kb.pw, planes[1]))
    with pytest.raises(ValueError, match="tc_operands"):
        tvk.grouped_tc_split3(tkn._r2(r), kb, planes, ops._replace(
            vec=ops.vec[:, :-1].contiguous()))
    with pytest.raises(NotImplementedError):
        tvk.estimate_packed_block_grouped(kb, tkn._r2(r), "split3", t_coh=4)


PROBE_COLS = [(2, 2), (2, 4), (4, 2), (4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("cp,cw", PROBE_COLS)
def test_floor_probe_matches_plain_at_every_width(cp, cw):
    """Every variant at each instantiation (ragged N, dead components past
    component 0: full_fixedmax anchors at logw_0), `full` bit for bit K1."""
    from quantized_channel_estimation_torch.tools import (
        kernel_floor_probe as tfp)
    dev = _card()
    two_m, two_d = {2: 40, 4: 128}[cp], {2: 40, 4: 128}[cw]
    kb = _rand_kb(two_m, two_d, 6, dev)
    kb = kb._replace(logw=torch.cat([kb.logw[:1], torch.full(
        (2,), -1e30, device=dev), kb.logw[3:]]))
    r2 = _rows(1001, two_m, dev)
    for name in tfp.VARIANTS:
        if name == "square_only" and two_d > two_m:
            with pytest.raises(ValueError, match="2D <= 2M"):
                tfp.floor_probe(r2, kb, name)
            continue
        before = tfp.floor_probe.launches
        got = tfp.floor_probe(r2, kb, name)
        torch.cuda.synchronize()
        assert tfp.floor_probe.launches == before + 1
        want = tfp.floor_probe_reference(r2, kb, name)
        assert got.shape == (1001, two_d) and torch.isfinite(got).all()
        assert _rel(got, want) < 1e-4, name
    assert torch.equal(tfp.floor_probe(r2, kb, "full"),
                       tkn.grouped_estimate(r2, kb))
    with pytest.raises(ValueError, match="128"):
        tfp.floor_probe(_rows(3, 256, dev), _rand_kb(256, 16, 2, dev), "full")


@pytest.mark.cuda
def test_kernel_tools_run_on_card_at_a_small_size():
    from quantized_channel_estimation_torch.tools import (
        kernel_bench, kernel_floor_probe, kernel_split_bench)
    _card()
    small = ["--n-ant", "16", "--components", "8", "--repeats", "2"]
    tkn.reset_launch_counts()
    probe = kernel_floor_probe.main(small + ["--batch", "4096"])
    bench = kernel_bench.main(small + ["--batch", "4096"])
    split = kernel_split_bench.main(small + ["--n-train", "4000",
                                             "--n-val", "4096",
                                             "--max-iter", "5"])
    counts = tkn.launch_counts()
    for name in ("floor_probe", "karatsuba_estimate", "grouped_estimate",
                 "grouped_tc_bf16", "grouped_tc_split2", "grouped_tc_split3"):
        assert counts[name] >= 1, name
    assert all(v > 0 for v in probe["ms"].values())
    assert all(v > 0 for v in bench["ms"].values())
    assert split["rows"][20.0]["kernel_split3"]["rel_to_f32"] < 1e-3


@pytest.mark.cuda
def test_profiling_on_card():
    from quantized_channel_estimation_torch.utils import profiling
    dev = _card()
    kb = _rand_kb(40, 40, 4, dev)
    r2 = _rows(4096, 40, dev)
    assert profiling.device_ms(lambda: tkn.grouped_estimate(r2, kb), 3) > 0
    with pytest.raises(RuntimeError):
        with profiling.no_implicit_transfers():
            float(r2.sum())
    assert torch.cuda.get_sync_debug_mode() == 0
    timer = profiling.Timer()
    with timer.section("k1", barrier_tree=tkn.grouped_estimate(r2, kb)):
        pass
    assert timer.counts == {"k1": 1}


# ---------------------------------------------------------------------------
# the VAE on the card
# ---------------------------------------------------------------------------

VAE_SNRS = (-10.0, 0.0, 10.0, 20.0)


def _vae_case(mode, dev, d=32, n=2000):
    """(cfg, model, state, step, channels, pilot, quantizers) on `dev`."""
    from quantized_channel_estimation_torch.models import vae as tv
    from quantized_channel_estimation_torch.ops import scm as tscm
    cfg = tv.VaeConfig(n_antennas=d, latent_dim=8, n_layers=3,
                       vae_mode=mode, batch_size=128, epochs=3,
                       steps_per_epoch=10)
    h, _ = stages.generate_channels(torch.Generator().manual_seed(40), n,
                                    tscm.ScmConfig(d, 1))
    a = tp.pilot_matrix(d, 1, 2)
    qs = [tq.design_quantizer(s, 2) for s in VAE_SNRS]
    model, state = tv.init_vae(torch.Generator().manual_seed(41), cfg)
    model, state = model.to(dev), tv.VaeTrainState(*(x.to(dev)
                                                     for x in state))
    step = tv.make_train_step(model, cfg, a.to(dev), VAE_SNRS,
                              [q.to(dev) for q in qs])
    return cfg, model, state, step, h.to(dev), a.to(dev), [q.to(dev)
                                                         for q in qs]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["genie", "noisy", "real"])
def test_vae_step_on_card_matches_cpu(mode):
    """Five Adam steps on the card and on the CPU from one state on the
    same draws: the loss to rtol 1e-5, the parameters and moments to 1e-5
    of their scale, the same count."""
    from quantized_channel_estimation_torch.models import vae as tv
    dev = _card()
    _, _, st_c, step_c, h_c, _, _ = _vae_case(mode, "cpu")
    _, _, st_g, step_g, h_g, _, _ = _vae_case(mode, dev)
    gen = torch.Generator().manual_seed(42)
    for _ in range(5):
        d = step_c.draw(gen, h_c.shape[0])
        st_c, l_c = step_c.apply(st_c, h_c, d)
        st_g, l_g = step_g.apply(st_g, h_g, tv.StepDraws(
            *(None if x is None else x.to(dev) for x in d)))
        np.testing.assert_allclose(float(l_g), float(l_c), rtol=1e-5)
    for g, c in zip(st_g[:3], st_c[:3]):
        assert float((g.cpu() - c).abs().max()) <= 1e-5 * float(c.abs().max())
    assert int(st_g.count) == int(st_c.count) == 5


@pytest.mark.cuda
def test_vae_nan_guard_and_epochs_without_host_reads_on_card():
    """A poisoned batch leaves parameters, moments and count unchanged on
    the card; a block of epochs runs with no host synchronization
    (`set_sync_debug_mode('error')`)."""
    dev = _card()
    _, _, state, step, h, _, _ = _vae_case("noisy", dev)
    gen = torch.Generator(dev).manual_seed(43)
    state, _ = step(state, h, gen)
    new, loss = step(state, torch.full_like(h, complex("nan")), gen)
    assert not bool(torch.isfinite(loss))
    for got, want in zip(new[:4], state[:4]):
        assert torch.equal(got, want)
    assert int(new.step) == int(state.step) + 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, means = step.run_epochs(state, h,
                                       np.random.SeedSequence(44), 0, 10, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert means.shape == (2,) and bool(torch.isfinite(means).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["genie", "noisy", "real"])
def test_vae_graph_epochs_replay_the_eager_steps(mode):
    """Epochs as CUDA-graph replays of one step equal the eager steps bit
    for bit (state and mean losses), also on a second call that reuses the
    captured graph."""
    dev = _card()
    _, _, state, step, h, _, _ = _vae_case(mode, dev)
    stream = np.random.SeedSequence(47)
    eager = step.run_epochs(state, h, stream, 3, 10, 2, cuda_graph=False)
    for _ in range(2):
        graphed = step.run_epochs(state, h, stream, 3, 10, 2,
                                  cuda_graph=True)
        assert torch.equal(graphed[1], eager[1])
        assert all(torch.equal(x, y) for x, y in zip(graphed[0], eager[0]))


@pytest.mark.cuda
def test_vae_resume_on_card_is_bit_identical(tmp_path):
    from quantized_channel_estimation_torch.models import vae as tv
    dev = _card()
    cfg, _, _, _, h, a, qs = _vae_case("real", dev)
    cfg2 = cfg._replace(epochs=2)
    path = str(tmp_path / "ckpt")
    _, _, l1 = tv.train(0, cfg2, h, a, VAE_SNRS, qs, verbose=False,
                        checkpoint_path=path)
    _, s2, l2 = tv.train(0, cfg, h, a, VAE_SNRS, qs, verbose=False,
                         checkpoint_path=path)
    _, s3, l3 = tv.train(0, cfg, h, a, VAE_SNRS, qs, verbose=False)
    assert l2[:2] == l1 and l2 == l3
    for got, want in zip(s2, s3):
        assert got.device.type == "cuda" and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [2, 1, math.inf])
def test_vae_structured_estimate_matches_dense_on_card(n_bits):
    """The per-sample circulant path against the dense solve on the card,
    and the card against the CPU, to 1e-4 of the scale."""
    from quantized_channel_estimation_torch.models import vae as tv
    dev = _card()
    cfg, model, state, _, h, a, _ = _vae_case("noisy", dev)
    cfg = cfg._replace(n_bits=n_bits)
    q = tq.design_quantizer(10.0, n_bits)
    q = None if q is None else q.to(dev)
    r = stages.observe(torch.Generator(dev).manual_seed(45), h[:512], 10.0,
                       a, n_bits, q)
    outs = [tv.estimate(model, state.params, cfg, r, 10.0, a, q,
                        structured=s) for s in (False, True)]
    cpu = tv.estimate(model.cpu(), state.params.cpu(), cfg, r.cpu(), 10.0,
                      a.cpu(), None if q is None else q.to("cpu"),
                      structured=True)
    for got in (outs[1], cpu.to(dev)):
        scale = float(outs[0].abs().max())
        assert float((got - outs[0]).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_vae_service_on_card_matches_direct():
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.models import vae as tv
    dev = _card()
    cfg, model, state, _, h, a, _ = _vae_case("noisy", dev)
    q = tq.design_quantizer(5.0, 2).to(dev)
    r = stages.observe(torch.Generator(dev).manual_seed(46), h[:256], 5.0, a,
                       2, q)
    svc = serving.VaeEstimationService(model, state.params, cfg, a,
                                       max_delay_ms=1.0)
    try:
        assert svc.structured and svc.device.type == "cuda"
        for t in (1, 4):
            req = r.cpu().numpy().reshape((-1, t, r.shape[-1]) if t > 1
                                          else r.shape)
            got = svc.submit(req, 5.0, timeout=60.0)
            want = tv.estimate(model, state.params, cfg, r, 5.0, a, q,
                               coherence=t, structured=True)
            np.testing.assert_allclose(got.reshape(want.shape),
                                       want.cpu().numpy(), atol=1e-4)
        assert svc.metrics()["requests_failed"] == 0
    finally:
        svc.close(timeout=60.0)


@pytest.mark.cuda
def test_mimo_and_macro_generation_on_card_in_law():
    """The other channel models drawn on the card: MIMO unit power per
    entry and unit genie diagonals, the coherence draws of one sample with
    the dense np.kron(C_MS, C_BS) as covariance (atol 0.12); urban-macro
    powers inside the path-loss range [1, 1.5^3.5]; every output on the
    card and owning its storage; no host synchronization while drawing."""
    from quantized_channel_estimation_torch.ops import scm, scm_mimo
    dev = _card()
    gen = torch.Generator(dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h, t_bs, t_ms = scm_mimo.generate_channels_mimo(
            gen, 1500, scm_mimo.ScmMimoConfig(16, 4, n_path=2))
        hc, tc_bs, tc_ms = scm_mimo.generate_channels_mimo(
            gen, 2, scm_mimo.ScmMimoConfig(4, 3, n_path=1,
                                           n_coherence=8000))
        hm, tm = scm.generate_channels_urban_macro(
            gen, 3000, scm.UrbanMacroConfig(n_antennas=16))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for x in (h, t_bs, t_ms, hm, tm):
        assert x.is_cuda and x.untyped_storage().nbytes() == \
            x.numel() * x.element_size()
    assert h.shape == (1500, 64) and hm.shape == (3000, 16)
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.1
    np.testing.assert_allclose(t_bs[:, 0].real.cpu().numpy(), 1.0, atol=1e-3)
    np.testing.assert_allclose(t_ms[:, 0].real.cpu().numpy(), 1.0, atol=1e-3)
    for b in range(2):
        c_true = np.kron(tl.toeplitz_from_first_row(tc_ms[b]).cpu().numpy(),
                         tl.toeplitz_from_first_row(tc_bs[b]).cpu().numpy())
        emp = (hc[b].T @ hc[b].conj()).cpu().numpy() / hc.shape[1]
        np.testing.assert_allclose(emp, c_true, atol=0.12)
    t0 = tm[:, 0].real.cpu().numpy()
    assert t0.min() > 1.0 - 1e-3 and t0.max() < 1.5 ** 3.5 + 1e-3


@pytest.mark.cuda
def test_mimo_coloring_ladder_on_card_matches_cpu():
    """The jitter ladder on the card (cuSOLVER) against the CPU (LAPACK) on
    truncated Toeplitz matrices at a 2-degree spread, numerically
    rank-deficient: each factor finite and lower triangular, its L L^H the
    covariance jittered at the rung its device chose (to 1e-5 relative),
    the card's L L^H the CPU's to 1e-5 of scale, and no host
    synchronization on the card."""
    from quantized_channel_estimation_torch.ops import scm
    dev = _card()
    g = torch.Generator().manual_seed(3)
    gains = torch.rand(256, 2, generator=g, dtype=torch.float64)
    gains = gains / gains.sum(-1, keepdim=True)
    fs = scm.sample_psd((torch.rand(256, 2, generator=g,
                                    dtype=torch.float64) - 0.5) * 180,
                        gains, 16, 2.0)
    t = (torch.fft.fft(fs.to(torch.complex64), dim=-1) / fs.shape[-1])[:, :16]
    c = tl.toeplitz_from_first_row(t)
    l_cpu = tl.robust_chol_lower(c)
    c_dev = c.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        l_gpu = tl.robust_chol_lower(c_dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    d = torch.diagonal(c, dim1=-2, dim2=-1).real.mean(-1)[:, None, None]
    eye = torch.eye(16)
    for l in (l_cpu, l_gpu.cpu()):
        assert bool(torch.isfinite(torch.view_as_real(l)).all())
        assert torch.equal(l, torch.tril(l))
        llh = l @ l.mH
        rel = torch.stack([
            torch.linalg.norm(llh - (c + s * d * eye), dim=(-2, -1))
            / torch.linalg.norm(c, dim=(-2, -1))
            for s in (0.0, 1e-6, 1e-4, 1e-2)]).amin(0)
        assert float(rel.max()) < 1e-5
    llh_cpu, llh_gpu = l_cpu @ l_cpu.mH, (l_gpu @ l_gpu.mH).cpu()
    assert float((llh_gpu - llh_cpu).abs().max()) < 1e-5 * float(
        llh_cpu.abs().max())


@pytest.mark.cuda
def test_mimo_run_gmm_on_card_launches_k1_and_k3(tmp_path):
    """`run_gmm` on Kronecker-MIMO channels at a small size on the card
    (8 x 4 antennas, K = 8, blocks of T = 4 at alpha 0.25): the GMM column
    through K1 and the coherent column through K3 once an SNR, the kron
    genie below the GMM column at the top SNR, every row finite."""
    from quantized_channel_estimation_torch.harness import run_gmm
    _card()
    cfg = run_gmm.GmmBenchConfig(
        channel_model="mimo", n_antennas=8, n_antennas_ms=4, n_path=2,
        n_components=8, n_train=4000, n_val=800, n_coherence=4,
        coherence_alpha=0.25, snrs=(-5, 5, 15), gmm_max_iter=20,
        results_dir=str(tmp_path), cache_dir=str(tmp_path / "c"))
    tkn.reset_launch_counts()
    mse, rate, _ = run_gmm.run(cfg, verbose=False)
    counts = tkn.launch_counts()
    assert counts["grouped_estimate"] == 3
    assert counts["grouped_estimate_coherent"] == 3
    assert mse["blmmse_genie"][-1] < mse["blmmse_gmm"][-1] \
        < mse["LS_glob"][-1]
    for col in (*mse.values(), *rate.values()):
        assert all(map(math.isfinite, col))
    assert any("_model=mimo8x4-coh4_" in f for f in os.listdir(tmp_path / "c"))
