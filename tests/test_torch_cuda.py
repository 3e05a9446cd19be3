"""The port's CUDA kernels (K1, K3, K4) against their plain versions on
the card, and the estimation service on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: 1e-4 of the output scale (max |kernel - plain| / max |plain|);
both are float32 with the products summed in another order. For the top-k
kernel, rows whose k-th and (k+1)-th logits lie within 1e-3 are left out
of the comparison: the two sums may order such near-ties differently.
"""
import math

import numpy as np
import pytest
import torch

from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
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
