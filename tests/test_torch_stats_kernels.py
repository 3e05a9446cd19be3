"""Parity of the plain versions of the split-K kernels with the JAX package:
K2, the stats form of K1 / K3 (the un-normalised online-softmax state of
a component shard), and K5, the stats form of K4 (a shard's top-k
candidates), against JAX's interpret-mode Pallas kernels on shared numpy
inputs; their shard merges against the plain K1 / K3 / K4 over the whole
bank; and the dense kernels' shape rule `fused_kernel_eligible`, past which
every entry takes the einsum estimator (banks with 2M or 2D > 256).

Tolerances: 1e-5 of each output's scale (max |port - JAX| / max |JAX|):
float32 products summed in another order. Merged shard states against the
one-pass plain kernel: 1e-5 of the scale as well (one more exp and sum).
Exact ties are decided exactly (the lower component index wins), so those
merges agree to float32 rounding of one combine.
"""
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
from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, K, T = 8, 8, 4


def _banks(rng, n_dead=0, snr=5.0):
    """The same float64 GMM of K components (the first n_dead below the
    dead floor) prepared by both packages at 2 bits, one pilot; the port's
    bank in float32 / complex64 as its kernels take it."""
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
    bt32 = tge.PreparedBank(*(x.to(torch.complex64) if x.is_complex()
                              else x.to(torch.float32) for x in bt))
    return bj, bt32


def _obs(rng, n):
    r = rng.standard_normal((n, D)) + 1j * rng.standard_normal((n, D))
    return ((np.sign(r.real) + 1j * np.sign(r.imag)) / 1.4).astype(
        np.complex64)


def _r2(r):
    return np.concatenate([r.real, r.imag], -1).astype(np.float32)


def _kb_from_jax(kj):
    return tkn.KernelBankBlock(
        torch.as_tensor(np.asarray(kj.pw)),
        torch.as_tensor(np.asarray(kj.mu)[:, 0]),
        torch.as_tensor(np.asarray(kj.b)[:, 0]),
        torch.as_tensor(np.asarray(kj.logw)))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _shards(bank, parts=2):
    """The bank's components in `parts` equal shards, in component order."""
    k = bank.log_weights.shape[0] // parts
    return [tge.PreparedBank(*(x[i * k:(i + 1) * k] for x in bank))
            for i in range(parts)]


# ----------------------------------------------------------------- K2

@pytest.mark.parametrize("n_dead", [0, 2])
def test_plain_k2_matches_jax_kernel(rng, n_dead):
    """The plain K2 state on JAX's own kernel layout against
    `estimate_packed_block_grouped_stats(interpret=True)` (its m and den
    lane-broadcast columns read at column 0)."""
    bj, _ = _banks(rng, n_dead)
    kj = jpk.kernel_bank_block(bj)
    r2 = _r2(_obs(rng, 256))
    m_j, den_j, acc_j = (np.asarray(x) for x in
                         jpk.estimate_packed_block_grouped_stats(
                             kj, jnp.asarray(r2), 256, 4, True))
    m, den, acc = tkn.grouped_estimate_stats_reference(
        torch.as_tensor(r2), _kb_from_jax(kj), chunk=64)
    _close(m, m_j[:, 0])
    _close(den, den_j[:, 0])
    _close(acc, acc_j)
    # the state is K1's before its division
    _close(acc / den[:, None], tkn.grouped_estimate_reference(
        torch.as_tensor(r2), _kb_from_jax(kj)))


def test_estimate_fused_stats_matches_jax_and_the_einsum_convention(rng):
    """The port's entry (the plain K2 on the CPU) against JAX's
    `estimate_fused_stats(interpret=True)`, and in the logit convention of
    `gmm_estimator.estimate_stats`, so kernel and einsum states merge."""
    bj, bt = _banks(rng, 1)
    r = _obs(rng, 200)
    m_j, den_j, acc_j = (np.asarray(x) for x in jpk.estimate_fused_stats(
        bj, jnp.asarray(r), interpret=True))
    before = tkn.grouped_estimate_stats.launches
    m, den, acc = tkn.estimate_fused_stats(bt, torch.as_tensor(r))
    assert tkn.grouped_estimate_stats.launches == before     # CPU: plain
    assert acc.dtype == torch.complex64 and acc.shape == (200, D)
    _close(m, m_j)
    _close(den, den_j)
    _close(acc, acc_j)
    m_e, den_e, acc_e = tge.estimate_stats(bt, torch.as_tensor(r))
    _close(m, m_e)
    _close(acc / den[:, None], acc_e / den_e[:, None])


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_coherent_k2_matches_jax(rng, alpha):
    """The coherent state per block at alpha = 1 ((B,) m and den) and per
    snapshot below ((B, T)), against JAX's
    `estimate_fused_coherent_stats(interpret=True)`."""
    bj, bt = _banks(rng)
    rb = _obs(rng, 64 * T).reshape(64, T, D)
    m_j, den_j, acc_j = (np.asarray(x) for x in
                         jpk.estimate_fused_coherent_stats(
                             bj, jnp.asarray(rb), interpret=True,
                             alpha=alpha))
    m, den, acc = tkn.estimate_fused_coherent_stats(bt, torch.as_tensor(rb),
                                                    alpha)
    want_shape = (64,) if alpha >= 1.0 else (64, T)
    assert m.shape == den.shape == want_shape
    _close(m, m_j)
    _close(den, den_j)
    _close(acc, acc_j)


@pytest.mark.parametrize("t,alpha", [(1, 1.0), (T, 1.0), (T, 0.25)])
def test_two_k2_shards_merge_to_the_plain_k1_and_k3(rng, t, alpha):
    """Two component shards' states merged with `merge_stats` against the
    plain K1 (t = 1) or K3 over the whole bank; a kernel shard merges with
    an einsum shard alike (one logit convention)."""
    _, bt = _banks(rng, 1)
    r = torch.as_tensor(_obs(rng, 48 * T))
    lo, hi = _shards(bt)
    if t == 1:
        want = tkn.estimate_fused(bt, r)
        pairs = ((tkn.estimate_fused_stats(lo, r),
                  tkn.estimate_fused_stats(hi, r)),
                 (tkn.estimate_fused_stats(lo, r),
                  tge.estimate_stats(hi, r)))
    else:
        r = r.reshape(-1, t, D)
        want = tkn.estimate_fused_coherent(bt, r, alpha)
        pairs = ((tkn.estimate_fused_coherent_stats(lo, r, alpha),
                  tkn.estimate_fused_coherent_stats(hi, r, alpha)),
                 (tkn.estimate_fused_coherent_stats(lo, r, alpha),
                  tge.estimate_coherent_stats(hi, r, 512, alpha)))
    for states in pairs:
        _, den, acc = tkn.merge_stats(*zip(*states))
        den = den.reshape(den.shape + (1,) * (acc.dim() - den.dim()))
        _close(acc / den, want)


# ----------------------------------------------------------------- K5

@pytest.mark.parametrize("k_sel", [1, 3])
def test_plain_k5_matches_jax_kernel(rng, k_sel):
    """The plain K5 candidates on JAX's layout against
    `estimate_packed_block_grouped_topk_stats(interpret=True)` (its logits
    lane-broadcast, 128 columns a slot)."""
    bj, _ = _banks(rng, 2)
    kj = jpk.kernel_bank_block(bj)
    r2 = _r2(_obs(rng, 256))
    l_j, z_j = (np.asarray(x) for x in
                jpk.estimate_packed_block_grouped_topk_stats(
                    kj, jnp.asarray(r2), 256, 4, k_sel, True))
    l, z = tkn.grouped_estimate_topk_stats_reference(
        torch.as_tensor(r2), _kb_from_jax(kj), k_sel, chunk=64)
    assert l.shape == (256, k_sel) and z.shape == (256, k_sel, 2 * D)
    _close(l, l_j[:, ::128])
    _close(z, z_j.reshape(256, k_sel, 2 * D))
    assert bool((l[:, :-1] >= l[:, 1:]).all())       # sorted descending


def test_merge_topk_matches_jax(rng):
    """The port's `merge_topk` against JAX's on shared candidate lists of
    three shards, with exact ties across shards."""
    n, k, two_d = 64, 3, 2 * D
    ls = [-np.sort(-rng.integers(0, 6, (n, k)).astype(np.float32), 1)
          for _ in range(3)]
    zs = [rng.standard_normal((n, k, two_d)).astype(np.float32)
          for _ in range(3)]
    for k_sel in (1, 2, 3):
        want = np.asarray(jpk.merge_topk([jnp.asarray(x) for x in ls],
                                         [jnp.asarray(x) for x in zs],
                                         k_sel))
        got = tkn.merge_topk([torch.as_tensor(x) for x in ls],
                             [torch.as_tensor(x) for x in zs], k_sel)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _tie_bank(rng, logw):
    """A float32 kernel bank of 4 components with one precision part and
    mean, so their logits differ by exactly their log-weights, and
    different filter parts."""
    two_m = two_d = 4
    p = rng.standard_normal((two_m, two_m)).astype(np.float32)
    pw = np.stack([np.concatenate(
        [p, rng.standard_normal((two_m, two_d)).astype(np.float32)], 1)
        for _ in range(4)])
    mu = np.stack([rng.standard_normal(two_m).astype(np.float32)] * 4)
    b = rng.standard_normal((4, two_d)).astype(np.float32)
    return tkn.KernelBankBlock(*(torch.as_tensor(x) for x in (
        pw, mu, b, np.asarray(logw, np.float32))))


@pytest.mark.parametrize("k_sel,logw", [
    (1, [-50.0, 0.0, 0.0, -50.0]),    # 1 (shard 0) and 2 (shard 1) tie
    (2, [50.0, 0.0, 0.0, 0.0]),       # 1, 2 and 3 tie for second
    (3, [0.0, -9.0, 1.0, 0.5]),       # no tie
])
def test_two_k5_shards_merge_to_the_plain_k4(rng, k_sel, logw):
    """Two shards' candidates, concatenated in component order and merged
    with a stable top-k, against the plain K4 over the whole bank: exact
    ties keep the lower component index across shards too."""
    kb = _tie_bank(rng, logw)
    r2 = torch.as_tensor(rng.standard_normal((40, 4)).astype(np.float32))
    halves = [tkn.KernelBankBlock(*(x[lo:lo + 2] for x in kb))
              for lo in (0, 2)]
    cands = [tkn.grouped_estimate_topk_stats(r2, h, k_sel) for h in halves]
    got = tkn.merge_topk(*zip(*cands), k_sel)
    want = tkn.grouped_estimate_topk_reference(r2, kb, k_sel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the lower index's filter, not the higher one's, where they tie
    z = (r2 @ kb.pw[:, :, 4:] + kb.b[:, None]).transpose(0, 1)  # (N, K, 2D)
    if k_sel == 1:
        np.testing.assert_allclose(got.numpy(), z[:, 1].numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_k5_pads_a_shard_smaller_than_k(rng):
    """A shard of fewer than k_sel components fills its last slots with
    logit -inf and zero estimates, which carry no weight in the merge."""
    kb = _tie_bank(rng, [0.0, -1.0, 0.5, -2.0])
    r2 = torch.as_tensor(rng.standard_normal((10, 4)).astype(np.float32))
    l, z = tkn.grouped_estimate_topk_stats(
        r2, tkn.KernelBankBlock(*(x[:2] for x in kb)), 3)
    assert torch.isinf(l[:, 2]).all() and bool((z[:, 2] == 0).all())
    shards = [tkn.grouped_estimate_topk_stats(
        r2, tkn.KernelBankBlock(*(x[i:i + 1] for x in kb)), 3)
        for i in range(4)]
    np.testing.assert_allclose(
        tkn.merge_topk(*zip(*shards), 3).numpy(),
        tkn.grouped_estimate_topk_reference(r2, kb, 3).numpy(), rtol=1e-6,
        atol=1e-6)


def test_estimate_fused_topk_stats_merges_to_estimate_fused_topk(rng):
    """The port's entry on two bank shards, merged, against the one-bank
    top-k entry (the plain K4 on the CPU)."""
    _, bt = _banks(rng, 2)
    r = torch.as_tensor(_obs(rng, 300))
    for k_sel in (1, 4):
        cands = [tkn.estimate_fused_topk_stats(h, r, k_sel)
                 for h in _shards(bt)]
        got = tkn._h(tkn.merge_topk(*zip(*cands), k_sel), D, r.dtype)
        _close(got, tkn.estimate_fused_topk(bt, r, k_sel))


# ----------------------------------------------------------------- F1

def _wide_bank(rng, d, m, k=3):
    """A float32 bank of channel dim D and observation dim M (random
    filters and means, a well-conditioned precision Cholesky)."""
    def cr(*shape):
        return torch.as_tensor((rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape)).astype(
                                    np.complex64))
    chol = torch.eye(m, dtype=torch.complex64) + 0.02 * torch.triu(
        cr(k, m, m), 1)
    return tge.PreparedBank(torch.log(torch.full((k,), 1.0 / k)),
                            0.1 * cr(k, m), chol, 0.1 * cr(k, d, m),
                            0.1 * cr(k, d))


@pytest.mark.parametrize("d,m,ok", [
    (128, 128, True), (8, 128, True), (129, 8, False), (8, 129, False),
    (8, 160, False), (0, 8, False),
])
def test_fused_kernel_eligible_rule(d, m, ok):
    assert tkn.fused_kernel_eligible(d, m) is ok


@pytest.mark.parametrize("d,m", [(8, 136), (130, 8)])
def test_wide_banks_never_reach_the_dense_kernels(monkeypatch, rng, d, m):
    """Fault F1: past 2M, 2D <= 256 every 'all'-mode entry (`estimate_auto`,
    `estimate_fused_coherent` at T = 1, the stats entries) is the einsum
    estimator; the kernels' own entries are never called."""
    bank = _wide_bank(rng, d, m)
    r = torch.as_tensor((rng.standard_normal((24, m))
                         + 1j * rng.standard_normal((24, m))).astype(
                             np.complex64))

    def refuse(*args, **kwargs):
        raise AssertionError("a dense kernel was reached past its widths")

    for name in ("estimate_fused", "grouped_estimate",
                 "grouped_estimate_reference", "grouped_estimate_stats",
                 "grouped_estimate_coherent", "grouped_estimate_topk"):
        monkeypatch.setattr(tkn, name, refuse)
    want = tge.estimate(bank, r, "all")
    _close(tst.estimate_auto(bank, r, "all"), want)
    _close(tst.estimate_coherent_auto(bank, r[:, None], "all")[:, 0], want)
    _close(tkn.estimate_fused_coherent(bank, r[:, None])[:, 0], want)
    _, den, acc = tkn.estimate_fused_stats(bank, r)
    _close(acc / den[:, None], want)
    rb = r.reshape(6, 4, m)
    for got, want in zip(tkn.estimate_fused_coherent_stats(bank, rb),
                         tge.estimate_coherent_stats(bank, rb, 512)):
        _close(got, want)
    with pytest.raises(ValueError, match="256"):
        tkn.estimate_fused_topk_stats(bank, r, 1)


def test_service_width_check_is_the_stages_rule(monkeypatch, rng):
    """The service refuses use_kernels=True where `fused_kernel_eligible`
    says no: the one rule the stages use."""
    a = rng.standard_normal((4, D, D)) + 1j * rng.standard_normal((4, D, D))
    covs = (a @ np.conj(np.swapaxes(a, -1, -2)) / D + np.eye(D)).astype(
        np.complex64)
    params = tg.GmmParams(np.full(4, 0.25, np.float32),
                          np.zeros((4, D), np.complex64), covs,
                          np.asarray(jl.robust_precision_cholesky(
                              jnp.asarray(covs))).astype(np.complex64))
    eye = np.eye(D, dtype=np.complex64)
    seen = []

    def never(d, m):
        seen.append((d, m))
        return False

    monkeypatch.setattr(tkn, "fused_kernel_eligible", never)
    with pytest.raises(ValueError, match="2M, 2D"):
        serving.EstimationService(params, eye, 2, device="cpu",
                                  use_kernels=True)
    assert (D, D) in seen
