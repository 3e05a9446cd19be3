"""Parity of the port's GMM estimator, kernel bank layout and the plain
version of kernel K1 with the JAX package.

Tolerances: bank preparation and the einsum estimator at float64 to rtol
1e-9 (Cholesky solves of Cr matrices with condition ~1e3 in another
order); the kernel layout, built in float64 then rounded to float32 in
both packages, to rtol 1e-6; the plain K1 against JAX's interpret-mode
Pallas kernel on identical float32 inputs to 1e-5 of the output scale
(float32 sums in another order). The CUDA kernel is held against its plain
version on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as jpk
from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_estimator as jge
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, K = 8, 4


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _params(rng, dead=True, zero_mean=False):
    a = (rng.standard_normal((K, D, D)) + 1j * rng.standard_normal((K, D, D)))
    covs = a @ np.conj(np.swapaxes(a, -1, -2)) / D + 0.2 * np.eye(D)
    tr = np.real(np.trace(covs, axis1=-2, axis2=-1))[:, None, None]
    covs = covs * D / tr
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    w = np.array([0.4, 0.3, 0.3 - 1e-5, 1e-5]) if dead else np.full(K, 1 / K)
    means = np.zeros((K, D), complex) if zero_mean else 0.3 * (
        rng.standard_normal((K, D)) + 1j * rng.standard_normal((K, D)))
    return w, means, covs, prec


def _banks(rng, n_bits, n_pilots, snr=10.0, **kw):
    w, means, covs, prec = _params(rng, **kw)
    a = np.asarray(jp.pilot_matrix(D, n_pilots, n_bits, dtype=jnp.complex128))
    qj = jq.design_quantizer(snr, n_bits)
    qt = None if qj is None else tq.ScalarQuantizer(
        *(torch.as_tensor(np.asarray(x)) for x in qj))
    bj = jge.prepare_bank(jg.GmmParams(*(jnp.asarray(x) for x in (
        w, means, covs, prec))), snr, jnp.asarray(a), n_bits, qj)
    bt = tge.prepare_bank(tg.GmmParams(*(torch.as_tensor(x) for x in (
        w, means, covs, prec))), snr, torch.as_tensor(a), n_bits, qt)
    return bj, bt


def _obs(rng, n, m, dtype=np.complex128):
    r = (rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m)))
    return (np.sign(r.real) + 1j * np.sign(r.imag)).astype(dtype) / 1.4


@pytest.mark.parametrize("n_bits,n_pilots", [(2, 1), (1, 1), (math.inf, 1),
                                             (2, 2)])
def test_prepare_bank_matches_jax(rng, n_bits, n_pilots):
    bj, bt = _banks(rng, n_bits, n_pilots)
    assert float(bt.log_weights[-1]) == -math.inf   # dead component masked
    for g, w in zip(bt, bj):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("mode", ["all", 1, 2, 0.9])
def test_estimate_modes_match_jax(rng, mode):
    bj, bt = _banks(rng, 2, 1)
    r = _obs(rng, 300, D)
    got = tge.estimate(bt, torch.as_tensor(r), mode, chunk_size=128)
    want = jge.estimate(bj, jnp.asarray(r), mode, 128)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(
        _np(tge.responsibilities(bt, torch.as_tensor(r))),
        np.asarray(jge.responsibilities(bj, jnp.asarray(r))), rtol=1e-9,
        atol=1e-14)


def test_estimate_stats_match_jax(rng):
    bj, bt = _banks(rng, 2, 1)
    r = _obs(rng, 200, D)
    got = tge.estimate_stats(bt, torch.as_tensor(r), 64)
    want = jge.estimate_stats(bj, jnp.asarray(r), 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-8)
    m, den, acc = got
    np.testing.assert_allclose(
        _np(acc / den[:, None]),
        _np(tge.estimate(bt, torch.as_tensor(r), "all")), rtol=1e-5,
        atol=1e-8)


def test_selection_weights_edge_modes():
    p = torch.tensor([[0.5, 0.3, 0.2], [0.1, 0.1, 0.8]], dtype=torch.float64)
    np.testing.assert_allclose(_np(tge._selection_weights(p, 1)),
                               [[1, 0, 0], [0, 0, 1]])
    np.testing.assert_allclose(
        _np(tge._selection_weights(p, 0.75)),
        np.asarray(jge._selection_weights(jnp.asarray(p.numpy()), 0.75)))


@pytest.mark.parametrize("n_pilots", [1, 2])
def test_kernel_bank_block_matches_jax(rng, n_pilots):
    bj, bt = _banks(rng, 2, n_pilots)
    kj = jpk.kernel_bank_block(bj)
    kt = tkn.kernel_bank_block(bt)
    m2 = 2 * D * n_pilots
    assert kt.pw.shape == (K, m2, m2 + 2 * D) and kt.pw.dtype == torch.float32
    np.testing.assert_allclose(kt.pw.numpy(), np.asarray(kj.pw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(kt.mu.numpy(), np.asarray(kj.mu)[:, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kt.b.numpy(), np.asarray(kj.b)[:, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kt.logw.numpy(), np.asarray(kj.logw),
                               rtol=1e-6)
    assert kt.logw[-1].item() == float(np.float32(-1e30))  # dead floor


def _kb_from_jax(kj):
    return tkn.KernelBankBlock(
        torch.as_tensor(np.asarray(kj.pw)),
        torch.as_tensor(np.asarray(kj.mu)[:, 0]),
        torch.as_tensor(np.asarray(kj.b)[:, 0]),
        torch.as_tensor(np.asarray(kj.logw)))


@pytest.mark.parametrize("n_rows,dead", [(256, False), (200, True)])
def test_plain_k1_matches_jax_interpret_kernel(rng, n_rows, dead):
    """The same float32 bank and rows through JAX's Pallas kernel (interpret
    mode, tile 128, group 2) and the port's plain K1; the ragged N=200 is
    zero-padded for JAX only."""
    bj, _ = _banks(rng, 2, 1, dead=dead)
    kj = jpk.kernel_bank_block(bj)
    r2 = np.concatenate([(rng.standard_normal((n_rows, D)) > 0) - 0.5,
                         (rng.standard_normal((n_rows, D)) > 0) - 0.5],
                        axis=-1).astype(np.float32) * 1.3
    pad = np.zeros((256, 2 * D), np.float32)
    pad[:n_rows] = r2
    want = np.asarray(jpk.estimate_packed_block_grouped(
        kj, jnp.asarray(pad), 128, 2, True))[:n_rows]
    got = tkn.grouped_estimate_reference(torch.as_tensor(r2), _kb_from_jax(kj),
                                         chunk=96)
    assert got.shape == (n_rows, 2 * D)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-5, err


def test_wrapper_on_cpu_is_the_plain_version(rng):
    _, bt = _banks(rng, 2, 1)
    kb = tkn.kernel_bank_block(bt)
    r2 = torch.as_tensor(rng.standard_normal((70, 2 * D)).astype(np.float32))
    before = tkn.grouped_estimate.launches
    got = tkn.grouped_estimate(r2, kb)
    assert torch.equal(got, tkn.grouped_estimate_reference(r2, kb))
    assert tkn.grouped_estimate.launches == before   # no kernel launched
    assert tkn.launch_counts()["grouped_estimate"] == before


def test_estimate_fused_matches_einsum_estimator(rng):
    _, bt = _banks(rng, 2, 1)
    bt32 = tge.PreparedBank(*(x.to(torch.complex64) if x.is_complex()
                              else x.to(torch.float32) for x in bt))
    r = torch.as_tensor(_obs(rng, 150, D, np.complex64))
    got = tkn.estimate_fused(bt32, r)
    want = tge.estimate(bt32, r, "all")
    assert got.dtype == torch.complex64
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) < 1e-4
    np.testing.assert_allclose(_np(tst.estimate_auto(bt32, r, "all")),
                               _np(got))
    # int modes within the top-k rule go through K4's plain version
    want2 = tge.estimate(bt32, r, 2)
    err2 = (tst.estimate_auto(bt32, r, 2) - want2).abs().max() \
        / want2.abs().max()
    assert float(err2) < 1e-4
    np.testing.assert_allclose(_np(tst.estimate_auto(bt32, r, 0.9)),
                               _np(tge.estimate(bt32, r, 0.9)))
