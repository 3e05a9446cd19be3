"""The plain versions of the port's circulant kernels (K6-K9) against the
JAX package's Pallas kernels in interpret mode.

On the CPU a wrapper of `estimators.circ_kernels` computes its kernel's
plain PyTorch version, the arithmetic the CUDA kernel repeats on the card
(`tests/test_torch_cuda.py` holds the two together there). Here that
arithmetic is held against the JAX package's `estimate_fused_circulant`,
`estimate_fused_circulant_coherent`, `estimate_fused_circulant_stats` and
`estimate_fused_circulant_coherent_stats` with `interpret=True`, as the JAX
tests run them on the CPU, on one bank made by the JAX package and carried
over with `structured_bank.bank_from_numpy`.

Tolerance: 2e-4 of the output scale, the JAX tests' own for these kernels
(`tests/test_structured_bank.py`): both sides are float32 and expand the
quadratic logit |u|^2 prec - 2 Re(u conj(m) prec), which cancels, with the
products summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import structured_bank as jsb
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.models import structured_bank as tsb

torch.set_num_threads(2)

D, K = 32, 8
TOL = 2e-4


def _banks(n_dead=0, blocks=None, snr=10.0, k=K, d=D, seed=0):
    """One circulant bank (2-bit, non-zero means, n_dead dead components)
    prepared by the JAX package from seeded spectra, and its port copy."""
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    means = (0.3 * (rng.standard_normal((k, d))
                    + 1j * rng.standard_normal((k, d)))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    w[:n_dead] = 1e-9
    w /= w.sum()
    dummy = jnp.zeros((k, 1, 1), jnp.complex64)
    params = jg.GmmParams(jnp.asarray(w), jnp.asarray(means), dummy, dummy)
    jbank = jsb.prepare_bank_circulant(
        params, snr, 1.0 + 0.0j, 2, jq.design_quantizer(snr, 2),
        blocks=blocks, spectra=jnp.asarray(spec))
    assert int(np.isinf(np.asarray(jbank.log_weights)).sum()) == n_dead
    return jbank, tsb.bank_from_numpy(jbank)


def _obs(n, d=D, seed=1):
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.5, 0.5, 1.5]) * 0.6
    return (rng.choice(levels, (n, d))
            + 1j * rng.choice(levels, (n, d))).astype(np.complex64)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


@pytest.mark.parametrize("n,blocks,n_dead", [
    (300, None, 0), (77, None, 2), (300, (4, 8), 0), (1, (4, 8), 1)])
def test_plain_k6_matches_jax_interpret_kernel(n, blocks, n_dead):
    jbank, tbank = _banks(n_dead, blocks)
    r = _obs(n)
    before = tkn.launch_counts()
    got = ck.estimate_fused_circulant(tbank, torch.as_tensor(r),
                                      blocks=blocks)
    assert tkn.launch_counts() == before            # the CPU launches nothing
    assert got.dtype == torch.complex64
    want = pk.estimate_fused_circulant(jbank, jnp.asarray(r), interpret=True,
                                       blocks=blocks)
    _close(got, want)
    # and the FFT pipeline of either package, to the same tolerance
    _close(got, jsb.estimate_circulant(jbank, jnp.asarray(r), "all", 16384,
                                       blocks, "fft"))


@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("alpha", [1.0, 0.25])
@pytest.mark.parametrize("blocks,n_dead,n_blocks", [(None, 0, 100),
                                                    ((4, 8), 2, 37)])
def test_plain_k7_matches_jax_interpret_kernel(t, alpha, blocks, n_dead,
                                               n_blocks):
    jbank, tbank = _banks(n_dead, blocks)
    r = _obs(n_blocks * t).reshape(n_blocks, t, D)
    got = ck.estimate_fused_circulant_coherent(tbank, torch.as_tensor(r),
                                               alpha=alpha, blocks=blocks)
    want = pk.estimate_fused_circulant_coherent(
        jbank, jnp.asarray(r), alpha=alpha, interpret=True, blocks=blocks)
    _close(got, want)


def test_coherent_entry_at_t1_is_the_flat_kernel():
    jbank, tbank = _banks()
    r = torch.as_tensor(_obs(50))
    flat = ck.estimate_fused_circulant(tbank, r)
    got = ck.estimate_fused_circulant_coherent(tbank, r[:, None, :], 0.25)
    assert torch.equal(got[:, 0], flat)
    with pytest.raises(ValueError, match="blocks"):
        ck.estimate_fused_circulant_coherent(tbank, r)


@pytest.mark.parametrize("n,n_dead", [(300, 0), (77, 2)])
def test_plain_k8_matches_jax_interpret_kernel(n, n_dead):
    jbank, tbank = _banks(n_dead)
    r = _obs(n)
    got = ck.estimate_fused_circulant_stats(tbank, torch.as_tensor(r))
    want = pk.estimate_fused_circulant_stats(jbank, jnp.asarray(r),
                                             interpret=True)
    assert got[0].shape == got[1].shape == (n,) and got[2].shape == (n, D)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("t,alpha,blocks", [
    (2, 1.0, None), (4, 1.0, (4, 8)), (4, 0.25, None), (3, 0.25, (4, 8))])
def test_plain_k9_matches_jax_interpret_kernel(t, alpha, blocks):
    jbank, tbank = _banks(1, blocks)
    r = _obs(60 * t).reshape(60, t, D)
    got = ck.estimate_fused_circulant_coherent_stats(
        tbank, torch.as_tensor(r), alpha=alpha, blocks=blocks)
    want = pk.estimate_fused_circulant_coherent_stats(
        jbank, jnp.asarray(r), alpha=alpha, interpret=True, blocks=blocks)
    lead = (60,) if alpha >= 1.0 else (60, t)     # per block / per snapshot
    assert got[0].shape == got[1].shape == lead
    assert got[2].shape == (60, t, D)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("t,alpha", [(1, 1.0), (4, 1.0), (4, 0.25)])
def test_two_shard_stats_merge_reproduces_the_kernel_estimate(t, alpha):
    """K8 + K8 (K9 + K9) over the two halves of the bank, merged with
    `merge_stats` and inverse-transformed once, equals K6 (K7) over the
    whole bank, and JAX's `merge_stats` merges the same states alike."""
    _, tbank = _banks(n_dead=1)
    r = torch.as_tensor(_obs(64 * t))
    states = []
    for lo, hi in ((0, K // 2), (K // 2, K)):
        shard = tsb.CirculantBank(*(x[lo:hi] for x in tbank))
        if t == 1:
            states.append(ck.estimate_fused_circulant_stats(shard, r))
        else:
            states.append(ck.estimate_fused_circulant_coherent_stats(
                shard, r.reshape(64, t, D), alpha=alpha))
    ms, dens, accs = zip(*states)
    m, den, acc = ck.merge_stats(ms, dens, accs)
    if t == 1:
        want = ck.estimate_fused_circulant(tbank, r)
        got = tsb.unitary_ifft(acc / den[:, None])
    else:
        want = ck.estimate_fused_circulant_coherent(
            tbank, r.reshape(64, t, D), alpha=alpha)
        den_rows = den[:, None, None] if alpha >= 1.0 else den[..., None]
        got = tsb.unitary_ifft(acc / den_rows)
    _close(got, want.numpy(), 1e-5)
    if t == 1 or alpha < 1.0:
        flat = [[np.asarray(x).reshape(-1) for x in ms],
                [np.asarray(x).reshape(-1) for x in dens],
                [np.asarray(x).reshape(-1, D) for x in accs]]
        jm, jden, jacc = pk.merge_stats(*[[jnp.asarray(x) for x in part]
                                          for part in flat])
        _close(m.reshape(-1), jm, 1e-6)
        _close(den.reshape(-1), jden, 1e-6)
        _close(acc.reshape(-1, D), jacc, 1e-6)


@pytest.mark.parametrize("blocks", [None, (4, 8)])
def test_circ_kernel_bank_holds_the_jax_operands(blocks):
    """The port's operands are JAX's, re-laid as interleaved [re, im]
    pairs; `const` for T > 1 is JAX's `const - lw + lw / lw_div`."""
    jbank, tbank = _banks(n_dead=1, blocks=blocks)
    j = pk.circ_kernel_bank(jbank, blocks)
    t = ck.circ_kernel_bank(tbank, blocks)
    bfwd = np.asarray(t.bfwd)
    np.testing.assert_allclose(bfwd[0::2, 0::2], np.asarray(j.bfwd_r)[:D],
                               atol=1e-6)
    np.testing.assert_allclose(bfwd[1::2, 0::2], np.asarray(j.bfwd_r)[D:],
                               atol=1e-6)
    np.testing.assert_allclose(bfwd[0::2, 1::2], np.asarray(j.bfwd_i)[:D],
                               atol=1e-6)
    np.testing.assert_allclose(bfwd[1::2, 1::2], np.asarray(j.bfwd_i)[D:],
                               atol=1e-6)
    binv, jbinv = np.asarray(t.binv), np.asarray(j.binv)
    np.testing.assert_allclose(binv[0::2, 0::2], jbinv[:D, :D], atol=1e-6)
    np.testing.assert_allclose(binv[0::2, 1::2], jbinv[:D, D:], atol=1e-6)
    np.testing.assert_allclose(binv[1::2, 0::2], jbinv[D:, :D], atol=1e-6)
    np.testing.assert_allclose(binv[1::2, 1::2], jbinv[D:, D:], atol=1e-6)
    lcoef, jl = np.asarray(t.lcoef), np.asarray(j.lcoef)
    np.testing.assert_allclose(lcoef[0:2 * D:2], jl[:D], rtol=1e-5)
    np.testing.assert_allclose(lcoef[1:2 * D:2], jl[D:2 * D], rtol=1e-5)
    np.testing.assert_allclose(lcoef[2 * D:], jl[2 * D:], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(t.const), np.asarray(j.const)[0],
                               rtol=1e-5)
    comb = np.asarray(t.comb).reshape(K, D, 4)
    for i, name in enumerate(("bias_r", "bias_i", "filt_r", "filt_i")):
        np.testing.assert_allclose(comb[..., i], np.asarray(getattr(j, name)),
                                   rtol=1e-5, atol=1e-7)
    assert t.const[0] == -1e30                       # the dead component
    lw = np.maximum(np.asarray(jbank.log_weights), -1e30)
    t4 = ck.circ_kernel_bank(tbank, blocks, 4, 0.25)
    want = np.asarray(j.const)[0] - lw + lw / (1 - 0.25 + 0.25 * 4)
    np.testing.assert_allclose(np.asarray(t4.const), want, rtol=1e-5)


def test_eligibility_rule_reads_shapes_only():
    assert ck.circ_kernel_eligible(64, 64) and ck.circ_kernel_eligible(1, 1)
    assert ck.circ_kernel_eligible(128, 128, 32)
    assert ck.circ_kernel_eligible(64, 40, 64)      # K no multiple of 32
    assert ck.circ_kernel_eligible(64, 1000)        # split over K
    assert not ck.circ_kernel_eligible(ck.CIRC_WIDE_MAX_D + 1, 8)
    assert not ck.circ_kernel_eligible(128, 8, 65)  # past 64 live rows
    assert not ck.circ_kernel_eligible(64, 8, 65)
    assert ck.circ_tile_rows(64) == 64 and ck.circ_tile_rows(65) == 64


def test_banks_wider_than_one_launch_split_over_k():
    """K > 128: shards of 128 components through the stats form, merged;
    equal to the FFT pipeline over the whole bank, flat and coherent."""
    _, tbank = _banks(n_dead=3, k=260, d=8)
    cache = {}
    assert len(ck.lowered(tbank, cache)) == 3
    assert ck.lowered(tbank, cache) is cache[(None, 1, 1.0)]
    r = torch.as_tensor(_obs(48, d=8))
    _close(ck.estimate_fused_circulant(tbank, r, cache=cache),
           tsb.estimate_circulant(tbank, r, method="fft").numpy(), 1e-4)
    rb = r.reshape(12, 4, 8)
    _close(ck.estimate_fused_circulant_coherent(tbank, rb, 0.5, cache=cache),
           tsb.estimate_circulant_coherent(tbank, rb, alpha=0.5,
                                           method="fft").numpy(), 1e-4)
    assert set(cache) == {(None, 1, 1.0), (None, 4, 0.5)}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _, tbank = _banks()
    ckb = ck.circ_kernel_bank(tbank)
    x2 = ck._x2(torch.as_tensor(_obs(10)))
    assert x2.shape == (10, 2 * D) and x2.dtype == torch.float32
    with pytest.raises(ValueError, match="T >= 2"):
        ck.circ_estimate_coherent(x2, ckb, 1)
    with pytest.raises(ValueError, match="T >= 2"):
        ck.circ_estimate_coherent_stats(x2, ckb, 1)
    with pytest.raises(ValueError, match="whole number"):
        ck.circ_estimate_coherent(x2, ckb, 3)
    assert ck.circ_estimate(x2[:0], ckb).shape == (0, 2 * D)
    m, den, acc = ck.circ_estimate_stats(x2[:0], ckb)
    assert m.shape == den.shape == (0,) and acc.shape == (0, 2 * D)
    assert {"circ_estimate", "circ_estimate_coherent", "circ_estimate_stats",
            "circ_estimate_coherent_stats"} <= set(tkn.launch_counts())
