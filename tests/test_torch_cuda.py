"""The port's CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: 1e-4 of the output scale (max |kernel - plain| / max |plain|);
both are float32 with the products summed in another order.
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
