"""Parity of the plain version of kernel K4 (top-k selection estimation)
with the JAX package, its tie and dead-component behaviour, and the port's
eligibility rules.

Tolerances: the plain K4 against JAX's interpret-mode Pallas kernel on
identical float32 inputs, and against the port's float64 einsum estimator,
to 1e-5 of the output scale (float32 sums in another order); exact ties
are decided exactly (the lower index wins), so those outputs agree to
float32 rounding of one combine.
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

D, K = 8, 8


def _banks(rng, n_dead=0, snr=10.0):
    """The same float64 GMM of K components (the first n_dead below the
    dead floor) prepared by both packages at 2 bits, one pilot."""
    a = rng.standard_normal((K, D, D)) + 1j * rng.standard_normal((K, D, D))
    covs = a @ np.conj(np.swapaxes(a, -1, -2)) / D + 0.2 * np.eye(D)
    covs = covs * D / np.real(np.trace(covs, axis1=-2, axis2=-1))[:, None,
                                                                   None]
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    w = np.full(K, 1.0)
    w[:n_dead] = 1e-6
    w /= w.sum()
    means = 0.3 * (rng.standard_normal((K, D))
                   + 1j * rng.standard_normal((K, D)))
    a_mat = np.asarray(jp.pilot_matrix(D, 1, 2, dtype=jnp.complex128))
    qj = jq.design_quantizer(snr, 2)
    qt = tq.ScalarQuantizer(*(torch.as_tensor(np.array(x)) for x in qj))
    bj = jge.prepare_bank(jg.GmmParams(*(jnp.asarray(x) for x in (
        w, means, covs, prec))), snr, jnp.asarray(a_mat), 2, qj)
    bt = tge.prepare_bank(tg.GmmParams(*(torch.as_tensor(x) for x in (
        w, means, covs, prec))), snr, torch.as_tensor(a_mat), 2, qt)
    assert int(torch.isinf(bt.log_weights).sum()) == n_dead
    return bj, bt


def _obs(rng, n):
    r = rng.standard_normal((n, D)) + 1j * rng.standard_normal((n, D))
    return ((np.sign(r.real) + 1j * np.sign(r.imag)) / 1.4).astype(
        np.complex64)


def _kb_from_jax(kj):
    return tkn.KernelBankBlock(
        torch.as_tensor(np.asarray(kj.pw)),
        torch.as_tensor(np.asarray(kj.mu)[:, 0]),
        torch.as_tensor(np.asarray(kj.b)[:, 0]),
        torch.as_tensor(np.asarray(kj.logw)))


def _plain(kb, r, k_sel):
    r2 = torch.as_tensor(np.concatenate([r.real, r.imag], -1)
                         .astype(np.float32))
    h2 = tkn.grouped_estimate_topk_reference(r2, kb, k_sel, chunk=64)
    return (h2[:, :D] + 1j * h2[:, D:]).numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("k_sel,n,n_dead", [(1, 200, 0), (2, 200, 2),
                                            (4, 150, 0), (4, 256, 3)])
def test_plain_k4_matches_jax_kernel_and_einsum(rng, k_sel, n, n_dead):
    bj, bt = _banks(rng, n_dead)
    r = _obs(rng, n)
    want_kernel = np.asarray(jpk.estimate_fused_topk(bj, jnp.asarray(r),
                                                     k_sel, interpret=True))
    got = _plain(_kb_from_jax(jpk.kernel_bank_block(bj)), r, k_sel)
    assert _rel(got, want_kernel) < 1e-5
    want_einsum = tge.estimate(bt, torch.as_tensor(r.astype(np.complex128)),
                               k_sel).numpy()
    assert _rel(got, want_einsum) < 1e-5
    # the same through the port's entries, on its own bank layout
    bt32 = tge.PreparedBank(*(x.to(torch.complex64) if x.is_complex()
                              else x.to(torch.float32) for x in bt))
    rt = torch.as_tensor(r)
    before = tkn.grouped_estimate_topk.launches
    for got2 in (tkn.estimate_fused_topk(bt32, rt, k_sel),
                 tst.estimate_auto(bt32, rt, k_sel)):
        assert got2.dtype == torch.complex64 and got2.shape == (n, D)
        assert _rel(got2.numpy(), want_einsum) < 1e-5
    assert tkn.grouped_estimate_topk.launches == before   # CPU: plain


def _tie_bank(rng, logw):
    """A float32 kernel bank of 3 components whose precision parts, means
    (and given log-weights) make some logits exactly equal, while their
    filter parts differ."""
    two_m = two_d = 4
    p = rng.standard_normal((two_m, two_m)).astype(np.float32)
    mu = rng.standard_normal(two_m).astype(np.float32)
    pw = np.stack([np.concatenate(
        [p, rng.standard_normal((two_m, two_d)).astype(np.float32)], 1)
        for _ in range(3)])
    b = rng.standard_normal((3, two_d)).astype(np.float32)
    return pw, np.stack([mu] * 3), b, np.asarray(logw, np.float32)


@pytest.mark.parametrize("k_sel,logw,chosen", [
    (1, [0.0, 0.0, -50.0], [0]),       # 0 and 1 tie for first
    (2, [50.0, 0.0, 0.0], [0, 1]),     # 1 and 2 tie for second
])
def test_exact_ties_keep_the_lower_index(rng, k_sel, logw, chosen):
    pw, mu, b, lw = _tie_bank(rng, logw)
    kb = tkn.KernelBankBlock(*(torch.as_tensor(x) for x in (pw, mu, b, lw)))
    r2 = rng.standard_normal((20, 4)).astype(np.float32)
    got = tkn.grouped_estimate_topk_reference(torch.as_tensor(r2), kb,
                                              k_sel).numpy()
    lg = tkn.component_logits(torch.as_tensor(r2), kb).numpy()
    z = np.einsum("nm,kmd->nkd", r2, pw[:, :, 4:]) + b[None]
    w = np.exp(lg[:, chosen] - lg[:, chosen[:1]])
    want = (w[..., None] * z[:, chosen]).sum(1) / w.sum(1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # JAX's Pallas kernel (interpret mode, one component a GEMM) agrees
    kj = jpk.KernelBankBlock(jnp.asarray(pw), jnp.asarray(mu[:, None]),
                             jnp.asarray(b[:, None]), jnp.asarray(lw))
    pad = np.zeros((128, 4), np.float32)
    pad[:20] = r2
    want_j = np.asarray(jpk.estimate_packed_block_grouped_topk(
        kj, jnp.asarray(pad), 128, 1, k_sel, True))[:20]
    np.testing.assert_allclose(got, want_j, rtol=1e-5, atol=1e-5)


def test_dead_components_are_never_selected_over_live_ones(rng):
    n_dead = 2
    bj, bt = _banks(rng, n_dead)
    kb = tkn.kernel_bank_block(bt)
    r = _obs(rng, 100)
    r2 = torch.as_tensor(np.concatenate([r.real, r.imag], -1))
    order = tkn.component_logits(r2, kb).argsort(-1, descending=True)
    assert bool((order[:, :K - n_dead] >= n_dead).all())
    # k beyond the live count: the dead ones add zero weight
    live = K - n_dead
    np.testing.assert_allclose(_plain(kb, r, live + 1), _plain(kb, r, live),
                               rtol=1e-6, atol=1e-7)
    want = np.asarray(jpk.estimate_fused_topk(bj, jnp.asarray(r), live + 1,
                                              interpret=True))
    assert _rel(_plain(kb, r, live + 1), want) < 1e-5


@pytest.mark.parametrize("d,k_comp,m,k_sel,ok", [
    (64, 64, 64, 1, True), (64, 64, 64, 8, True), (64, 64, 64, 9, False),
    (64, 64, 64, 0, False), (16, 4, 16, 3, True), (16, 4, 16, 4, False),
    (16, 2, 16, 1, True), (64, 64, 64, True, False),
    (64, 64, 64, 0.9, False), (64, 64, 64, "all", False),
    (128, 8, 128, 2, True), (129, 8, 1025, 2, False), (64, 8, 1025, 2, False),
])
def test_topk_mode_eligible_rule(d, k_comp, m, k_sel, ok):
    assert tkn.topk_mode_eligible(d, k_comp, m, k_sel) is ok


def test_topk_entry_refuses_ineligible_modes(rng):
    _, bt = _banks(rng)
    r = torch.as_tensor(_obs(rng, 8))
    assert tkn.topk_kernel_eligible(bt, 7)
    for mode in (0, K, 9, 0.9, "all"):
        assert not tkn.topk_kernel_eligible(bt, mode)
        with pytest.raises(ValueError, match="top-k"):
            tkn.estimate_fused_topk(bt, r, mode)
    assert tkn.TOPK_KERNEL_MAX == 8


@pytest.mark.parametrize("two_m,two_d,rows", [(16, 16, 64), (128, 128, 64),
                                              (130, 16, 64), (64, 256, 64)])
def test_coherent_tile_rule(two_m, two_d, rows):
    """K3's largest T is its tile's rows: one consumer warpgroup's 64 at
    every width (the fp32 stream's tile held 32 rows past 2M, 2D = 128)."""
    assert tkn.tile_rows(two_m, two_d) == rows
    bank = tge.PreparedBank(
        torch.zeros(2), torch.zeros(2, two_m // 2, dtype=torch.complex64),
        torch.eye(two_m // 2, dtype=torch.complex64).repeat(2, 1, 1),
        torch.zeros(2, two_d // 2, two_m // 2, dtype=torch.complex64),
        torch.zeros(2, two_d // 2, dtype=torch.complex64))
    assert tkn.coherent_kernel_eligible(bank, rows)
    assert not tkn.coherent_kernel_eligible(bank, rows + 1)
    assert math.isclose(tkn.kernel_bank_block(bank, 4, 0.5).logw[0].item(),
                        0.0)
