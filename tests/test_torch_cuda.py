"""The port's CUDA kernels (K1, K3, K4, the circulant K6-K9 and the
multi-pilot circulant K10) against their plain versions on the card, and
the estimation service on the card.

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
float64, the kernel to within twice the plain version's own error.
"""
import math

import numpy as np
import pytest
import torch

from quantized_channel_estimation_torch.estimators import circ_kernels as tck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as tmk)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bank(d, k, n_pilots, dev, n_dead=0, seed=0):
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
    params = tg.GmmParams(*(x.to(dev) for x in params))
    a_mat = tp.pilot_matrix(d, n_pilots, 2, device=dev)
    q = tq.design_quantizer(10.0, 2).to(dev)
    return tge.prepare_bank(params, 10.0, a_mat, 2, q)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n_pilots,n,n_dead", [
    (8, 4, 1, 1000, 0),      # 2M = 2D = 16: the narrowest instantiation
    (64, 64, 1, 4097, 3),    # main-path widths, ragged N, dead components
    (64, 8, 2, 333, 0),      # 2M = 256
    (128, 4, 1, 100, 1),     # 2M = 2D = 256
    (24, 5, 1, 50, 0),       # widths that are no multiple of 32
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
    big = tkn.KernelBankBlock(torch.zeros(1, 258, 260, device=dev),
                              torch.zeros(1, 258, device=dev),
                              torch.zeros(1, 2, device=dev),
                              torch.zeros(1, device=dev))
    with pytest.raises(ValueError, match="256"):
        tkn.grouped_estimate(torch.zeros(3, 258, device=dev), big)
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


# ------------------------------------------------ the circulant kernels

def _circ_bank(d, k, dev, n_dead=0, blocks=None, seed=0, p=1, n_bits=2):
    """A seeded circulant bank at 10 dB, non-zero means: under the scalar
    pilot x0 = 1, or for p > 1 the multi-pilot bank under the P-pilot
    matrix kron(x, I) of `pilots.pilot_matrix`."""
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
    a = torch.tensor(1.0 + 0.0j) if p == 1 \
        else tp.pilot_matrix(d, p, n_bits, device=dev)
    return tsb.prepare_bank_circulant(
        params, 10.0, a, n_bits, None if q is None else q.to(dev),
        blocks=blocks, spectra=torch.as_tensor(spectra, device=dev))


def _f64(ckb):
    return type(ckb)(*(x.double() for x in ckb))


def _held(got, want, want64):
    """1e-4 of the plain version, or as accurate as it against float64."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = float(want.abs().max())
    if float((got - want).abs().max()) / scale < 1e-4:
        return
    err_kernel = float((got.double() - want64).abs().max()) / scale
    err_plain = float((want.double() - want64).abs().max()) / scale
    assert err_kernel <= 2 * err_plain + 1e-5, (err_kernel, err_plain)


# every (CD, CK) instantiation of the template, ragged sizes, dead
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
    (64, 64, 9, 64, 1.0, 0),       # T = the tile's 64 rows
    (128, 128, 50, 32, 0.5, 2),    # D = 128: T = the 32-row tile
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
    wide = _circ_bank(130, 2, dev)                   # D past the kernels
    with pytest.raises(ValueError, match="128"):
        tck.circ_estimate(torch.zeros(3, 260, device=dev),
                          tck.circ_kernel_bank(wide))
    many = tck.circ_kernel_bank(_circ_bank(8, 130, dev))   # one launch's K
    with pytest.raises(ValueError, match="128"):
        tck.circ_estimate(x2, many)
    r = torch.zeros(3, 130, dtype=torch.complex64, device=dev)
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
    bank = _circ_bank(d, k, dev, n_dead, blocks, p=p, n_bits=n_bits)
    assert isinstance(bank, tsb.CirculantBankMP)
    return bank


# every (CD, CK) instantiation of the template, P = 2, 3, 4, ragged sizes,
# dead components, widths that are no multiple of 32, the kron basis, the
# three bit widths, and the edges of the rule (the largest P at D = K = 64
# and at D = K = 128, K = 128 at D = 64 and P = 4)
MP_SHAPES = [
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
    # one past the rule: P = 5 at D = K = 64 and at D = K = 128, D = 129,
    # K = 129 (no stats form to split over), T past the 32-row tile
    for p, d, k, t in ((5, 64, 64, 1), (5, 128, 128, 1), (2, 129, 4, 1),
                       (2, 8, 129, 1), (2, 128, 8, 33)):
        assert not tmk.mp_circ_kernel_eligible(d, k, p, t)
        wide = _mp_bank(p, d, k, dev)
        r = torch.zeros(2, t, p * d, dtype=torch.complex64, device=dev)
        r = r[:, 0] if t == 1 else r
        before = tkn.launch_counts()
        with pytest.raises(ValueError, match="method='kernel'"):
            (stages.estimate_circulant if t == 1
             else stages.estimate_circulant_coherent)(wide, r,
                                                      method="kernel")
        with pytest.raises(ValueError, match="multi-pilot circulant kernel"):
            (tmk.estimate_fused_circulant_mp if t == 1
             else tmk.estimate_fused_circulant_mp_coherent)(wide, r)
        with pytest.raises(ValueError, match="shared memory"):
            x2w = torch.zeros(2 * t, 2 * p * d, device=dev)
            ckb_w = tmk.mp_circ_kernel_bank(wide, None, t)
            tmk.mp_circ_estimate(x2w, ckb_w) if t == 1 \
                else tmk.mp_circ_estimate_coherent(x2w, ckb_w, t)
        # 'auto' takes the torch.fft pipeline there and launches nothing
        (stages.estimate_circulant if t == 1
         else stages.estimate_circulant_coherent)(wide, r)
        assert tkn.launch_counts() == before
    before = tkn.launch_counts()
    assert tmk.mp_circ_estimate(x2[:0], ckb).shape == (0, 16)
    assert tmk.mp_circ_estimate_coherent(x2[:0], ckb, 2).shape == (0, 16)
    assert tkn.launch_counts() == before             # nothing to launch


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


# (D, M) covering every instantiation: bins a lane CW = 1, 2, 4 (D <= 32,
# 64, 128) by complex outputs a lane CF = 1, 2, 4 (2M <= 32, 64, 128)
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
    for d, m, t in ((128, 64, 32), (64, 32, 64), (1, 1, 1)):
        wide, obs_w = _fact_bank(d, 2, m, dev)
        rw = obs_w(4 * t)
        h = tfk.estimate_fused_factored_coherent(wide, rw.reshape(4, t, d))
        torch.cuda.synchronize()
        assert torch.isfinite(h).all()
    for d, m, t in ((129, 4, 1), (64, 65, 1), (64, 33, 64), (65, 16, 33)):
        wide = tmb.FactoredBank(
            torch.zeros(2, device=dev),
            *(torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype in (
                ((2, d), torch.complex64), ((2, d), torch.float32),
                ((2, m, d), torch.complex64), ((2, m), torch.complex64),
                ((2,), torch.float32), ((2, m, d), torch.complex64),
                ((2, m, d), torch.complex64), ((2, m, d), torch.complex64),
                ((2, d), torch.complex64), ((2, d), torch.complex64))))
        r = torch.zeros(t, d, dtype=torch.complex64, device=dev)
        with pytest.raises(ValueError, match="factored kernels take"):
            tfk.estimate_fused_factored_coherent(wide, r[None])
        with pytest.raises(ValueError, match="fact_kernel_eligible"):
            stages.estimate_factored_coherent(wide, r[None], method="kernel")


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
