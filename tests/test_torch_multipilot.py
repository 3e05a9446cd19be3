"""The port's multi-pilot structured banks (`CirculantBankMP`) and the plain
version of the multi-pilot circulant kernel K10 against the JAX package.

`models.structured_bank` (the multi-pilot half: bank preparation under a
kron(x, I) pilot at every bit width, `_mp_consts`, the `torch.fft` / DFT-GEMM
pipelines in every selection mode, the coherent estimator, the two stats
forms and their shard merge), `estimators.mp_circ_kernels` (the bank layout
and the plain K10, flat and coherent, which a wrapper computes on the CPU)
and the dispatch rule of `harness.stages`, on inputs made from numpy seeds
and fed to both packages. JAX runs on the CPU in x64 (`tests/conftest.py`),
its Pallas kernel in interpret mode, as its own tests run it.

Tolerances, with their reasons:
- 5e-5 of a field's scale for the bank fields (float32 transforms and P x P
  Cholesky factors of O(1) values on both sides; measured 2.2e-5 in
  `bias_f` = mu_f (1 - filt . gx), whose bracket cancels to a few percent at
  10 dB, and the spectra extracted from complex64 covariances carry 1e-6);
  1-bit banks 5e-3: the
  arcsine's derivative diverges at +-1, where the lag-0 entry of each
  diagonal block of Cy sits, so that entry's float32 rounding (1e-7) moves
  asin by its square root, and the P x P inverse carries it into `prec_f`,
  `logdet` and `filt_f` (measured up to 1.9e-3 between the packages; each
  is as far from the port's float64 prepare, which both are also held to);
- 1e-5 of the output scale for float32 estimates, `_mp_consts` and the flat
  stats states (4e-5 for the coherent states: a logit pooled over T = 4
  snapshots is four times as large, and den and acc take on its float32
  rounding); JAX computes its multi-pilot logits in float32 at any input
  type, so a float64 request is held to the same 1e-5, and the port's
  float64 'dft' to its own 'fft' at rtol 1e-9;
- the structured bank against the port's own dense bank: 3e-5, the JAX
  tests' own (`tests/test_structured_bank.py`), and 1e-6 where both are
  prepared and evaluated in float64 (measured 2e-7: the factorization is
  exact). 1-bit float32 banks 1e-2: the JAX tests hold theirs to 2e-3 on a
  fitted prior; on this seeded prior the arcsine moves both float32 banks
  1e-3 to 5e-3 off the float64 one (measured 2.0e-3 to 6.6e-3 between them,
  2.6e-3 to 8.4e-3 between the JAX package's own two); 1-bit selection modes
  by rows, 97% of them within tolerance (a near-tie may pick another
  component; measured 98.4% to 100% of 256 rows);
- 2e-4 of the output scale for the plain K10 against JAX's interpret-mode
  kernel, the JAX tests' own for it (`tests/test_pallas_kernels.py`): both
  sides are float32 and expand the quadratic u^H Prec u, whose P^2 terms
  cancel, with the products summed in another order.
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
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, K = 16, 6


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol=1e-5):
    """max |got - want| within tol of the scale of want."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < tol, err


def _basis(d, blocks):
    def f(n):
        k = np.arange(n)
        return np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)
    return f(d) if blocks is None else np.kron(f(blocks[0]), f(blocks[1]))


def _prior(seed, k=K, d=D, n_dead=0, blocks=None):
    """A seeded (block-)circulant prior for both packages: weights, non-zero
    means, spectra, and the dense covariances F^H diag(s) F."""
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    means = (0.3 * (rng.standard_normal((k, d))
                    + 1j * rng.standard_normal((k, d)))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    w[:n_dead] = 1e-9
    w /= w.sum()
    f = _basis(d, blocks)
    covs = np.einsum("fd,kf,fe->kde", f.conj(), spec.astype(np.complex128),
                     f).astype(np.complex64)
    dummy = np.zeros((k, 1, 1), np.complex64)
    jp = jg.GmmParams(*(jnp.asarray(x) for x in (w, means, covs, dummy)))
    tpar = tg.GmmParams(*(torch.as_tensor(x) for x in (w, means, covs,
                                                       dummy)))
    return jp, tpar, spec


def _pilot(p, d=D, seed=7):
    """A = kron(x, I) for a seeded complex pilot vector of unit mean power."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(p) + 1j * rng.standard_normal(p)
    x = (x * np.sqrt(p) / np.linalg.norm(x)).astype(np.complex64)
    return np.kron(x[:, None], np.eye(d)).astype(np.complex64)


def _banks(p, n_bits=2, blocks=None, n_dead=1, snr=5.0, seed=0, k=K, d=D):
    """One multi-pilot bank prepared by the JAX package and carried over."""
    jp, _, spec = _prior(seed, k, d, n_dead, blocks)
    jbank = jsb.prepare_bank_circulant(
        jp, snr, jnp.asarray(_pilot(p, d)), n_bits,
        jq.design_quantizer(snr, n_bits, "uniform"), blocks=blocks,
        spectra=jnp.asarray(spec))
    assert isinstance(jbank, jsb.CirculantBankMP)
    tbank = tsb.bank_from_numpy(jbank)
    assert isinstance(tbank, tsb.CirculantBankMP)
    return jbank, tbank


def _obs(n, m, seed=1, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.5, 0.5, 1.5]) * 0.6
    return (rng.choice(levels, (n, m))
            + 1j * rng.choice(levels, (n, m))).astype(dtype)


def _shard(bank, lo, hi):
    return type(bank)(*(x[lo:hi] for x in bank))


# ---------------------------------------------------------- bank preparation

@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("n_bits", ["inf", 1, 2])
@pytest.mark.parametrize("blocks,from_spectra", [(None, True),
                                                 ((4, 4), False)])
def test_prepare_bank_multipilot_matches_jax(p, n_bits, blocks, from_spectra):
    """Non-zero means, two dead components, a complex pilot vector; from
    `spectra=` and from the dense covariances."""
    jp, tpar, spec = _prior(3, n_dead=2, blocks=blocks)
    a = _pilot(p)
    qj = jq.design_quantizer(10.0, n_bits, "uniform")
    qt = tq.design_quantizer(10.0, n_bits, "uniform")
    jb = jsb.prepare_bank_circulant(
        jp, 10.0, jnp.asarray(a), n_bits, qj, blocks=blocks,
        spectra=jnp.asarray(spec) if from_spectra else None)
    tb = tsb.prepare_bank_circulant(
        tpar, 10.0, torch.as_tensor(a), n_bits, qt, blocks=blocks,
        spectra=torch.as_tensor(spec) if from_spectra else None)
    assert isinstance(tb, tsb.CirculantBankMP) and tb._fields == jb._fields
    assert tb.mean_rf.shape == (K, D, p) and tb.prec_f.shape == (K, D, p, p)
    assert int(torch.isinf(tb.log_weights).sum()) == 2
    # the float64 prepare of the port, which both float32 banks are held to
    t64 = tsb.prepare_bank_circulant(
        tg.GmmParams(tpar.weights.double(), tpar.means.to(torch.complex128),
                     tpar.covariances.to(torch.complex128), None),
        10.0, torch.as_tensor(a).to(torch.complex128), n_bits,
        qt, blocks=blocks,
        spectra=torch.as_tensor(spec).double() if from_spectra else None)
    tol = 5e-3 if n_bits == 1 else 5e-5
    for name, got, want, ref in zip(tb._fields, tb, jb, t64):
        got, want, ref = _np(got), np.asarray(want), _np(ref)
        assert got.dtype == want.dtype, name
        if name == "log_weights":
            assert np.array_equal(np.isinf(got), np.isinf(want))
            got, want, ref = got[2:], want[2:], ref[2:]
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < tol, name
        assert np.abs(got - ref).max() / scale < tol, name
        assert np.abs(want - ref).max() / scale < tol, name
    # the bank is O(K D P^2)
    assert sum(x.numel() for x in tb) == 2 * K + K * D * (2 * p + p * p + 1)


def test_bank_from_numpy_and_the_stages_entries_take_either_bank():
    jp, tpar, spec = _prior(4)
    a = _pilot(2)
    qj, qt = jq.design_quantizer(0.0, 2), tq.design_quantizer(0.0, 2)
    jb = jsb.prepare_bank_circulant(jp, 0.0, jnp.asarray(a), 2, qj)
    carried = tsb.bank_from_numpy(jb)
    assert carried._fields == jb._fields
    for got, want in zip(carried, jb):
        assert np.array_equal(_np(got), np.asarray(want))
    for tb in (tst.prepare_bank_circulant(tpar, 0.0, torch.as_tensor(a), 2,
                                          qt),
               tst.prepare_bank_circulant_spectra(
                   tpar._replace(covariances=tpar.prec_chol),
                   torch.as_tensor(spec), 0.0, torch.as_tensor(a), 2, qt)):
        assert isinstance(tb, tsb.CirculantBankMP)
        for got, want in zip(tb, jb):
            _close(got, want, 2e-5)
    # the single-pilot bank is still the five-field one
    one = tsb.bank_from_numpy(jsb.prepare_bank_circulant(
        jp, 0.0, 1.0 + 0.0j, 2, qj))
    assert isinstance(one, tsb.CirculantBank)


@pytest.mark.parametrize("p", [2, 3])
def test_mp_consts_match_jax(p):
    jb, tb = _banks(p)
    jc, tc = jsb._mp_consts(jb), tsb._mp_consts(tb)
    assert tc._fields == jc._fields
    for name, got, want in zip(tc._fields, tc, jc):
        assert _np(got).dtype == np.asarray(want).dtype, name
        _close(got, want)
    assert tc.const_k[0] <= -1e30 and torch.isfinite(tc.const_k).all()


# ---------------------------------------------------------------- estimation

@pytest.mark.parametrize("mode", ["all", 1, 2, 0.9])
@pytest.mark.parametrize("p,blocks", [(2, None), (3, (4, 4)), (4, None)])
def test_estimate_circulant_mp_matches_jax(mode, p, blocks):
    jb, tb = _banks(p, blocks=blocks)
    r = _obs(200, p * D)
    rt = torch.as_tensor(r)
    want = jsb.estimate_circulant_mp(jb, jnp.asarray(r), mode, 64, blocks,
                                     "xla")
    got = tsb.estimate_circulant_mp(tb, rt, mode, 64, blocks, "fft")
    assert got.dtype == torch.complex64 and got.shape == (200, D)
    _close(got, want)
    _close(tsb.estimate_circulant_mp(tb, rt, mode, 64, blocks, "dft"), want,
           2e-5)                                 # the complex64 DFT matrix
    # `estimate_circulant` dispatches on the bank type, in both packages
    assert torch.equal(tsb.estimate_circulant(tb, rt, mode, 64, blocks), got)
    _close(got, jsb.estimate_circulant(jb, jnp.asarray(r), mode, 64, blocks,
                                       "xla"))
    assert tsb.estimate_circulant_mp(tb, rt[:0], mode).shape == (0, D)
    # a float64 request against the float32 bank computes in float64
    r64 = torch.as_tensor(r.astype(np.complex128))
    got64 = tsb.estimate_circulant_mp(tb, r64, mode, 64, blocks, "fft")
    assert got64.dtype == torch.complex128
    _close(got64, want)
    np.testing.assert_allclose(
        _np(tsb.estimate_circulant_mp(tb, r64, mode, 64, blocks, "dft")),
        _np(got64), rtol=1e-9, atol=1e-11)
    with pytest.raises(ValueError, match="P\\*D"):
        tsb.estimate_circulant_mp(tb, rt[:, :D], mode)


@pytest.mark.parametrize("alpha", [1.0, 0.25, 0.0])
@pytest.mark.parametrize("mode,p", [("all", 2), (1, 3), ("all", 4)])
def test_estimate_circulant_mp_coherent_matches_jax(alpha, mode, p):
    jb, tb = _banks(p)
    r = _obs(240, p * D).reshape(60, 4, p * D)
    rt = torch.as_tensor(r)
    want = jsb.estimate_circulant_mp_coherent(jb, jnp.asarray(r), mode, 16,
                                              alpha, None, "xla")
    got = tsb.estimate_circulant_mp_coherent(tb, rt, mode, 16, alpha)
    assert got.shape == (60, 4, D)
    _close(got, want)
    assert torch.equal(
        tsb.estimate_circulant_coherent(tb, rt, mode, 16, alpha), got)
    _close(tsb.estimate_circulant_mp_coherent(tb, rt, mode, 16, alpha, None,
                                              "dft"), want, 2e-5)
    if alpha == 0.0:      # the independent per-snapshot estimator
        _close(got.reshape(-1, D), tsb.estimate_circulant_mp(
            tb, rt.reshape(-1, p * D), mode), 2e-6)
    with pytest.raises(ValueError, match="blocks"):
        tsb.estimate_circulant_mp_coherent(tb, rt[0])


@pytest.mark.parametrize("p,blocks", [(2, None), (3, (4, 4))])
def test_mp_stats_and_shard_merge_match_jax(p, blocks):
    jb, tb = _banks(p, blocks=blocks)
    r = _obs(256, p * D)
    rt = torch.as_tensor(r)
    got = tsb.estimate_circulant_mp_stats(tb, rt, 100, blocks)
    want = jsb.estimate_circulant_mp_stats(jb, jnp.asarray(r), 100, blocks)
    assert got[0].shape == got[1].shape == (256,) and got[2].shape == (256, D)
    for g, w in zip(got, want):
        _close(g, w)
    # two component shards, merged, inverse-transformed once
    states = [tsb.estimate_circulant_mp_stats(_shard(tb, lo, hi), rt, 100,
                                              blocks)
              for lo, hi in ((0, K // 2), (K // 2, K))]
    _, den, acc = ck.merge_stats(*zip(*states))
    _close(tsb.unitary_ifft(acc / den[:, None], blocks),
           jsb.estimate_circulant_mp(jb, jnp.asarray(r), "all", 8192, blocks,
                                     "xla"))


@pytest.mark.parametrize("alpha", [1.0, 0.25])
@pytest.mark.parametrize("p", [2, 3])
def test_mp_coherent_stats_and_shard_merge_match_jax(alpha, p):
    jb, tb = _banks(p)
    r = _obs(240, p * D).reshape(60, 4, p * D)
    rt = torch.as_tensor(r)
    got = tsb.estimate_circulant_mp_coherent_stats(tb, rt, 25, alpha)
    want = jsb.estimate_circulant_mp_coherent_stats(jb, jnp.asarray(r), 25,
                                                    alpha)
    lead = (60,) if alpha >= 1.0 else (60, 4)   # per block / per snapshot
    assert got[0].shape == got[1].shape == lead and got[2].shape == (60, 4, D)
    for g, w in zip(got, want):
        _close(g, w, 4e-5)
    states = [tsb.estimate_circulant_mp_coherent_stats(
        _shard(tb, lo, hi), rt, 25, alpha) for lo, hi in ((0, 2), (2, K))]
    _, den, acc = ck.merge_stats(*zip(*states))
    den = den[:, None, None] if alpha >= 1.0 else den[..., None]
    _close(tsb.unitary_ifft(acc / den),
           jsb.estimate_circulant_mp_coherent(jb, jnp.asarray(r), "all", 2048,
                                              alpha, None, "xla"))
    with pytest.raises(ValueError, match="blocks"):
        tsb.estimate_circulant_mp_coherent_stats(tb, rt[0])


@pytest.mark.parametrize("n_bits,tol", [("inf", 3e-5), (1, 1e-2), (2, 3e-5)])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_multipilot_matches_the_ports_dense_bank(p, n_bits, tol):
    """kron(x, I) pilots: the per-bin P x P bank reproduces the port's own
    dense prepare and estimate on a circulant prior, at every bit width,
    flat and (2-bit) on coherence blocks; in float64 to rounding."""
    _, tpar, _ = _prior(5, n_dead=0)
    a = tp.pilot_matrix(D, p, n_bits)
    q = tq.design_quantizer(10.0, n_bits, "uniform")
    rt = torch.as_tensor(_obs(256, p * D, seed=9))
    dense = tge.prepare_bank(tpar, 10.0, a, n_bits, q)
    mp = tsb.prepare_bank_circulant(tpar, 10.0, a, n_bits, q)
    par64 = tg.GmmParams(tpar.weights.double(),
                         tpar.means.to(torch.complex128),
                         tpar.covariances.to(torch.complex128), None)
    a64, r64 = a.to(torch.complex128), rt.to(torch.complex128)
    _close(tsb.estimate_circulant(
        tsb.prepare_bank_circulant(par64, 10.0, a64, n_bits, q), r64),
        tge.estimate(tge.prepare_bank(par64, 10.0, a64, n_bits, q), r64,
                     "all"), 1e-6)
    for mode in ("all", 1, 2):
        hd = tge.estimate(dense, rt, mode)
        hs = tsb.estimate_circulant(mp, rt, mode)
        if n_bits == 1 and mode != "all":
            row = (hs - hd).norm(dim=-1) / hd.norm(dim=-1).clamp(min=1e-12)
            assert float((row < tol).float().mean()) > 0.97, mode
        else:
            _close(hs, hd, tol)
    if n_bits == 2:
        rb = rt.reshape(64, 4, p * D)
        for alpha in (1.0, 0.25):
            _close(tsb.estimate_circulant_coherent(mp, rb, "all", 16, alpha),
                   tge.estimate_coherent(dense, rb, "all", 16, alpha), tol)


# ------------------------------------------------------------ the plain K10

@pytest.mark.parametrize("p,n,blocks,n_dead", [
    (2, 300, None, 0), (2, 77, None, 3), (3, 130, (4, 4), 1),
    (4, 100, None, 2), (2, 1, (4, 4), 0)])
def test_plain_k10_matches_jax_interpret_kernel(p, n, blocks, n_dead):
    jb, tb = _banks(p, blocks=blocks, n_dead=n_dead)
    r = _obs(n, p * D)
    before = tkn.launch_counts()
    got = mk.estimate_fused_circulant_mp(tb, torch.as_tensor(r), blocks)
    assert tkn.launch_counts() == before            # the CPU launches nothing
    assert got.dtype == torch.complex64 and got.shape == (n, D)
    want = pk.estimate_fused_circulant_mp(jb, jnp.asarray(r), interpret=True,
                                          blocks=blocks)
    _close(got, want, 2e-4)
    # and the pipeline of either package, to the same tolerance
    _close(got, jsb.estimate_circulant_mp(jb, jnp.asarray(r), "all", 8192,
                                          blocks, "xla"), 2e-4)
    _close(got, tsb.estimate_circulant_mp(tb, torch.as_tensor(r), "all",
                                          8192, blocks), 2e-4)


@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("alpha", [1.0, 0.25])
@pytest.mark.parametrize("p,blocks,n_dead", [(2, None, 0), (3, (4, 4), 2)])
def test_plain_k10_coherent_matches_jax_interpret_kernel(t, alpha, p, blocks,
                                                         n_dead):
    jb, tb = _banks(p, blocks=blocks, n_dead=n_dead)
    n_blocks = 37
    r = _obs(n_blocks * t, p * D).reshape(n_blocks, t, p * D)
    got = mk.estimate_fused_circulant_mp_coherent(tb, torch.as_tensor(r),
                                                  alpha, blocks)
    assert got.shape == (n_blocks, t, D)
    want = pk.estimate_fused_circulant_mp_coherent(
        jb, jnp.asarray(r), alpha=alpha, interpret=True, blocks=blocks)
    _close(got, want, 2e-4)
    _close(got, tsb.estimate_circulant_mp_coherent(
        tb, torch.as_tensor(r), "all", 2048, alpha, blocks), 2e-4)


def test_k10_coherent_entry_at_t1_is_the_flat_kernel():
    _, tb = _banks(2)
    r = torch.as_tensor(_obs(50, 2 * D))
    flat = mk.estimate_fused_circulant_mp(tb, r)
    got = mk.estimate_fused_circulant_mp_coherent(tb, r[:, None, :], 0.25)
    assert torch.equal(got[:, 0], flat)
    with pytest.raises(ValueError, match="blocks"):
        mk.estimate_fused_circulant_mp_coherent(tb, r)


@pytest.mark.parametrize("p,blocks", [(2, None), (3, (4, 4)), (4, None)])
def test_mp_circ_kernel_bank_holds_the_jax_operands(p, blocks):
    """The port's operands are JAX's up to the layout: interleaved [re, im]
    pairs, the features ordered [u | |u_p|^2 | pairs], one forward
    transform for every pilot; `const` for T > 1 is JAX's
    `const - lw + lw / lw_div`."""
    jb, tb = _banks(p, blocks=blocks, n_dead=1)
    j = pk.mp_circ_kernel_bank(jb, blocks)
    t = mk.mp_circ_kernel_bank(tb, blocks)
    feat = D * (3 * p + p * (p - 1))
    assert t.lcoef.shape == (feat, K) and t.comb.shape == (p + 1, K, 2 * D)
    # the forward operand: JAX's pilot-0 blocks, [Re | Im] rows -> interleaved
    bfwd = np.asarray(t.bfwd)
    jr, ji = np.asarray(j.bfwd_r)[0], np.asarray(j.bfwd_i)[0]
    np.testing.assert_allclose(bfwd[0::2, 0::2], jr[:D], atol=1e-6)
    np.testing.assert_allclose(bfwd[1::2, 0::2], jr[p * D:p * D + D],
                               atol=1e-6)
    np.testing.assert_allclose(bfwd[0::2, 1::2], ji[:D], atol=1e-6)
    np.testing.assert_allclose(bfwd[1::2, 1::2], ji[p * D:p * D + D],
                               atol=1e-6)
    binv, jbinv = np.asarray(t.binv), np.asarray(j.binv)
    np.testing.assert_allclose(binv[0::2, 0::2], jbinv[:D, :D], atol=1e-6)
    np.testing.assert_allclose(binv[0::2, 1::2], jbinv[:D, D:], atol=1e-6)
    np.testing.assert_allclose(binv[1::2, 0::2], jbinv[D:, :D], atol=1e-6)
    np.testing.assert_allclose(binv[1::2, 1::2], jbinv[D:, D:], atol=1e-6)
    # lcoef: JAX's rows [ur_p; ui_p; |u_p|^2] per pilot, then [Re; Im] per
    # pair; the port's [u interleaved, pilot-major | |u_p|^2 | pairs
    # interleaved]
    lcoef, jl = np.asarray(t.lcoef), np.asarray(j.lcoef)
    kw = dict(rtol=1e-5, atol=1e-6)
    for pi in range(p):
        u = lcoef[2 * pi * D:2 * (pi + 1) * D]
        np.testing.assert_allclose(u[0::2], jl[3 * pi * D:(3 * pi + 1) * D],
                                   **kw)
        np.testing.assert_allclose(
            u[1::2], jl[(3 * pi + 1) * D:(3 * pi + 2) * D], **kw)
        np.testing.assert_allclose(
            lcoef[(2 * p + pi) * D:(2 * p + pi + 1) * D],
            jl[(3 * pi + 2) * D:(3 * pi + 3) * D], **kw)
    n_pairs = p * (p - 1) // 2
    for i in range(n_pairs):
        v = lcoef[3 * p * D + 2 * i * D:3 * p * D + 2 * (i + 1) * D]
        jv = jl[3 * p * D + 2 * i * D:3 * p * D + 2 * (i + 1) * D]
        np.testing.assert_allclose(v[0::2], jv[:D], **kw)
        np.testing.assert_allclose(v[1::2], jv[D:], **kw)
    np.testing.assert_allclose(np.asarray(t.const), np.asarray(j.const)[0],
                               rtol=1e-5)
    comb = np.asarray(t.comb).reshape(p + 1, K, D, 2)
    np.testing.assert_allclose(comb[0, ..., 0], np.asarray(j.bias_r), **kw)
    np.testing.assert_allclose(comb[0, ..., 1], np.asarray(j.bias_i), **kw)
    np.testing.assert_allclose(comb[1:, ..., 0], np.asarray(j.filt_r), **kw)
    np.testing.assert_allclose(comb[1:, ..., 1], np.asarray(j.filt_i), **kw)
    assert t.const[0] <= -1e30 and np.isfinite(np.asarray(t.const)).all()
    lw = np.maximum(np.asarray(jb.log_weights), -1e30)
    t4 = mk.mp_circ_kernel_bank(tb, blocks, 4, 0.25)
    want = np.asarray(j.const)[0] - lw + lw / (1 - 0.25 + 0.25 * 4)
    np.testing.assert_allclose(np.asarray(t4.const), want, rtol=1e-5)
    # the layouts are kept per (blocks, T, alpha)
    cache = {}
    assert mk.lowered(tb, cache, blocks) is mk.lowered(tb, cache, blocks)
    mk.lowered(tb, cache, blocks, 4, 0.25)
    assert set(cache) == {(blocks, 1, 1.0), (blocks, 4, 0.25)}


def test_mp_eligibility_rule_reads_shapes_only():
    assert mk.mp_circ_kernel_eligible(64, 64, 2)
    assert mk.mp_circ_kernel_eligible(64, 64, 4, 64)
    assert mk.mp_circ_kernel_eligible(64, 128, 4)
    assert mk.mp_circ_kernel_eligible(128, 128, 4, 32)
    assert mk.mp_circ_kernel_eligible(24, 40, 3, 16)    # no powers of two
    assert mk.mp_circ_kernel_eligible(16, 8, 16)
    assert mk.mp_circ_narrow(64, 64, 11)                # 32 live rows
    assert not mk.mp_circ_narrow(64, 64, 12)            # past shared memory
    assert mk.mp_circ_narrow(128, 128, 5)
    assert not mk.mp_circ_narrow(128, 128, 6)
    # past the template's rule its wide form takes the bank
    assert mk.mp_circ_kernel_eligible(129, 8, 2)
    assert mk.mp_circ_kernel_eligible(64, 129, 2)
    assert not mk.mp_circ_kernel_eligible(64, 64, 2, 65)  # past its T = 64
    assert mk.mp_circ_kernel_eligible(128, 64, 3, 33)
    # a warpgroup's u beside a ring of two units, in bytes
    assert mk.mp_circ_smem_bytes(64, 64, 2) == 1024 + 2 * 24592 + 65536
    assert mk.mp_circ_smem_bytes(64, 64, 4) == 181280
    assert mk.mp_circ_smem_bytes(64, 64, 12, half=True) \
        > mk.SMEM_BLOCK_BYTES


def test_mp_method_dispatch_and_refusals():
    """The one dispatch rule, `stages.estimate_circulant`, for a
    multi-pilot bank: 'auto' and 'kernel' reach K10's entry for 'all'
    within `mp_circ_kernel_eligible` (its plain version on the CPU);
    selection modes and shapes past the rule take the `torch.fft` pipeline
    under 'auto' and raise under 'kernel'; the kernel entries raise past
    the rule and never choose the pipeline themselves."""
    _, tb = _banks(2)
    r = torch.as_tensor(_obs(50, 2 * D))
    via_kernel = mk.estimate_fused_circulant_mp(tb, r)
    assert torch.equal(tst.estimate_circulant(tb, r), via_kernel)
    assert torch.equal(tst.estimate_circulant(tb, r, method="kernel"),
                       via_kernel)
    fft = tsb.estimate_circulant_mp(tb, r)
    assert torch.equal(fft, tst.estimate_circulant(tb, r, method="fft"))
    assert not torch.equal(fft, via_kernel)
    _close(via_kernel, fft, 2e-4)
    assert torch.equal(tst.estimate_circulant(tb, r, 2),
                       tsb.estimate_circulant_mp(tb, r, 2))
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant(tb, r, 1, method="kernel")
    for bad in ("mxu", "kernel", "auto"):
        with pytest.raises(ValueError, match="unknown method"):
            tsb.estimate_circulant_mp(tb, r, "all", method=bad)
    rb = r[:48].reshape(12, 4, 2 * D)
    cache = {}
    assert torch.equal(
        tst.estimate_circulant_coherent(tb, rb, alpha=0.5, cache=cache),
        mk.estimate_fused_circulant_mp_coherent(tb, rb, 0.5))
    assert set(cache) == {(None, 4, 0.5)}
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant_coherent(tb, rb, 0.9, method="kernel")
    # T past a tile's rows: the fft coherent pipeline; the entry raises
    t = ck.circ_tile_rows(D) + 1
    rt = torch.as_tensor(_obs(2 * t, 2 * D)).reshape(2, t, 2 * D)
    assert torch.equal(tst.estimate_circulant_coherent(tb, rt),
                       tsb.estimate_circulant_mp_coherent(tb, rt))
    with pytest.raises(ValueError, match="multi-pilot circulant kernel"):
        mk.estimate_fused_circulant_mp_coherent(tb, rt)
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant_coherent(tb, rt, method="kernel")
    # K past one launch of the template, and P past the shared memory of a
    # block: the template refuses them, the wide form takes them
    for p, k, d in ((2, ck.CIRC_MAX_K + 2, 4), (12, 4, 64)):
        _, wide = _banks(p, k=k, d=d, n_dead=0)
        rw = torch.as_tensor(_obs(12, p * d))
        assert not mk.mp_circ_narrow(d, k, p)
        assert mk.mp_circ_kernel_eligible(d, k, p)
        via_wide = mk.estimate_fused_circulant_mp(wide, rw)
        assert torch.equal(tst.estimate_circulant(wide, rw), via_wide)
        assert torch.equal(tst.estimate_circulant(wide, rw, method="kernel"),
                           via_wide)
        _close(via_wide, tsb.estimate_circulant_mp(wide, rw), 2e-4)


def test_mp_wrappers_refuse_what_the_kernel_does_not_take():
    _, tb = _banks(3)
    ckb = mk.mp_circ_kernel_bank(tb)
    x2 = ck._x2(torch.as_tensor(_obs(10, 3 * D)))
    assert x2.shape == (10, 6 * D) and x2.dtype == torch.float32
    with pytest.raises(ValueError, match="T >= 2"):
        mk.mp_circ_estimate_coherent(x2, ckb, 1)
    with pytest.raises(ValueError, match="whole number"):
        mk.mp_circ_estimate_coherent(x2, ckb, 3)
    assert mk.mp_circ_estimate(x2[:0], ckb).shape == (0, 2 * D)
    assert {"mp_circ_estimate", "mp_circ_estimate_coherent"} \
        <= set(tkn.launch_counts())
