"""The port's FFT-domain structured banks against the JAX package.

`ops.linalg` spectra helpers, `ops.cplx` products, and
`models.structured_bank` (bank preparation at every bit width, the
`torch.fft` / DFT-GEMM estimation pipelines in every selection mode, the
coherent estimator, the two stats forms and their shard merge) on inputs
made from numpy seeds and fed to both packages. JAX runs on the CPU in x64
(`tests/conftest.py`).

Tolerances, with their reasons:
- 1e-6 for the spectra helpers and 1e-5 for the bank fields: float32
  transforms of O(1) values on both sides. 1-bit banks 5e-4: the arcsine's
  derivative diverges at +-1, where the lag-0 entry of Cy / c0 sits, so
  the float32 rounding of that entry (1e-7) moves asin by its square root
  (measured 2.4e-4 between the packages; the JAX tests hold their own
  1-bit bank to 2e-3). Both packages are also held against the arcsine law
  on the dense matrix in float64;
- rtol 1e-9 for the `torch.fft` pipeline where both packages compute in
  float64 (a float64 copy of one bank, complex128 observations, D = 16:
  JAX scales its FFTs by a float32 sqrt(D), exact only for such D, and
  mode 1: JAX casts the combine weights to float32, exact only for the
  one-hot weights of top-1); the other modes 5e-7 of the output scale,
  the float32 weights. JAX's 'dft' method multiplies by a complex64 DFT matrix at any input type, so
  it is held to 5e-5, and the port's float64 'dft' to its own 'fft';
- 1e-5 of the output scale for float32 estimates and stats states (4e-5
  for the coherent states: a logit pooled over T = 4 snapshots is four
  times as large, and den and acc take on its float32 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import structured_bank as jsb
from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.ops import cplx as tc
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, K = 32, 8


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
    if blocks is None:
        return np.asarray(jl.unitary_dft(d, jnp.complex128))
    return np.kron(np.asarray(jl.unitary_dft(blocks[0], jnp.complex128)),
                   np.asarray(jl.unitary_dft(blocks[1], jnp.complex128)))


def _prior(rng, k=K, d=D, n_dead=0, mean=0.3):
    spec = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    means = (mean * (rng.standard_normal((k, d))
                     + 1j * rng.standard_normal((k, d)))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    w[:n_dead] = 1e-9
    return w / w.sum(), means, spec


def _params(w, means, spec, blocks=None):
    """Both packages' GmmParams of the prior, with the dense covariances
    F^H diag(s) F (the precision factors are not read by the structured
    path)."""
    f = _basis(spec.shape[1], blocks)
    covs = np.einsum("fd,kf,fe->kde", f.conj(), spec.astype(np.complex128),
                     f).astype(np.complex64)
    dummy = np.zeros((len(w), 1, 1), np.complex64)
    return (jg.GmmParams(*(jnp.asarray(x) for x in (w, means, covs, dummy))),
            tg.GmmParams(*(torch.as_tensor(x) for x in (w, means, covs,
                                                        dummy))))


def _quantizers(snr, n_bits):
    qj = jq.design_quantizer(snr, n_bits, "uniform")
    qt = tq.design_quantizer(snr, n_bits, "uniform")
    return qj, qt


def _obs(rng, n, d=D, dtype=np.complex64):
    levels = np.array([-1.5, -0.5, 0.5, 1.5]) * 0.6
    return (rng.choice(levels, (n, d))
            + 1j * rng.choice(levels, (n, d))).astype(dtype)


def _banks(rng, snr=5.0, n_bits=2, blocks=None, n_dead=1, d=D):
    """One bank prepared by the JAX package and carried over."""
    w, means, spec = _prior(rng, d=d, n_dead=n_dead)
    jp, _ = _params(w, means, spec, blocks)
    jbank = jsb.prepare_bank_circulant(
        jp, snr, 1.0 + 0.0j, n_bits, _quantizers(snr, n_bits)[0],
        blocks=blocks, spectra=jnp.asarray(spec))
    return jbank, tsb.bank_from_numpy(jbank)


def _banks64(jbank):
    """float64 copies of one bank for both packages."""
    arrs = [np.asarray(x) for x in jbank]
    arrs = [a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
            for a in arrs]
    return (jsb.CirculantBank(*(jnp.asarray(a) for a in arrs)),
            tsb.bank_from_numpy(arrs))


# ------------------------------------------------------------------ linalg

@pytest.mark.parametrize("blocks", [None, (4, 6)])
def test_circulant_spectra_helpers_match_jax(rng, blocks):
    d = 24
    s = rng.uniform(0.1, 3.0, (5, d)).astype(np.float32)
    f = _basis(d, blocks)
    c = np.einsum("fd,kf,fe->kde", f.conj(), s.astype(np.complex128),
                  f).astype(np.complex64)
    got = tl.circulant_diag_spectra(torch.as_tensor(c), blocks)
    assert got.dtype == torch.float32
    _close(got, jl.circulant_diag_spectra(jnp.asarray(c), blocks), 1e-6)
    _close(got, s, 2e-6)
    rows = tl.circulant_first_rows(torch.as_tensor(s), blocks)
    _close(rows, jl.circulant_first_rows(jnp.asarray(s), blocks), 1e-6)
    _close(rows, c[:, 0, :], 5e-6)
    back = tl.circulant_spectra_from_first_rows(rows, blocks)
    _close(back, jl.circulant_spectra_from_first_rows(
        jnp.asarray(_np(rows)), blocks), 1e-6)
    _close(back, s, 2e-6)                               # the round trip
    # a covariance that is not circulant: the Rayleigh diagonal of either
    a = (rng.standard_normal((2, d, d))
         + 1j * rng.standard_normal((2, d, d))).astype(np.complex64)
    h = a @ a.conj().transpose(0, 2, 1)
    _close(tl.circulant_diag_spectra(torch.as_tensor(h), blocks),
           jl.circulant_diag_spectra(jnp.asarray(h), blocks), 1e-6)
    if blocks is not None:
        with pytest.raises(ValueError, match="incompatible"):
            tl.circulant_diag_spectra(torch.as_tensor(c), (4, 5))


@pytest.mark.parametrize("blocks", [None, (4, 6)])
def test_unitary_fft_matches_jax_and_the_dft_matrix(rng, blocks):
    d = 24
    x = (rng.standard_normal((3, d))
         + 1j * rng.standard_normal((3, d))).astype(np.complex64)
    u = tsb.unitary_fft(torch.as_tensor(x), blocks)
    _close(u, jsb.unitary_fft(jnp.asarray(x), blocks), 1e-6)
    _close(u, x @ _basis(d, blocks).T, 1e-6)
    # the complex64 DFT matrix of either package takes exp() of float32
    # phases up to 2 pi d: 1e-5 of rounding, against each other and the
    # float64 basis
    _close(tsb._dft_matrix(d, blocks), jsb._dft_matrix(d, blocks), 2e-5)
    _close(tsb._dft_matrix(d, blocks), _basis(d, blocks), 2e-5)
    _close(tsb.unitary_ifft(u, blocks), x, 1e-6)
    for method in ("fft", "dft"):
        _close(tsb._inv(tsb._fwd(torch.as_tensor(x), blocks, method), blocks,
                        method), x, 2e-6 if method == "fft" else 4e-5)


def test_cplx_products_match_jax(rng):
    a = (rng.standard_normal((7, 5))
         + 1j * rng.standard_normal((7, 5))).astype(np.complex64)
    b = (rng.standard_normal((5, 6))
         + 1j * rng.standard_normal((5, 6))).astype(np.complex64)
    w = rng.standard_normal((4, 7, 5)).astype(np.float32)
    ta, tb, tw = (torch.as_tensor(x) for x in (a, b, w))
    ja, jb, jw = (jnp.asarray(x) for x in (a, b, w))
    _close(tc.cmatmul(ta, tb), jc.cmatmul(ja, jb))
    got = tc.cmatmul_realout(ta, tb)
    assert not got.is_complex()
    _close(got, jc.cmatmul_realout(ja, jb))
    _close(tc.rcmatmul(tw, tb), jc.rcmatmul(jw, jb))


# ---------------------------------------------------------- bank preparation

@pytest.mark.parametrize("n_bits", ["inf", 1, 2, 3])
@pytest.mark.parametrize("blocks,from_spectra", [(None, False), (None, True),
                                                 ((4, 8), False),
                                                 ((4, 8), True)])
def test_prepare_bank_circulant_matches_jax(rng, n_bits, blocks,
                                            from_spectra):
    """Non-zero means, two dead components, a complex pilot x0 I; from the
    dense covariances and from `spectra=`."""
    w, means, spec = _prior(rng, n_dead=2)
    jp, tp = _params(w, means, spec, blocks)
    x0 = 1.0 + 0.5j
    qj, qt = _quantizers(10.0, n_bits)
    kw = dict(blocks=blocks)
    jb = jsb.prepare_bank_circulant(
        jp, 10.0, jnp.asarray(x0, jnp.complex64) * jnp.eye(
            D, dtype=jnp.complex64), n_bits, qj,
        spectra=jnp.asarray(spec) if from_spectra else None, **kw)
    tb = tsb.prepare_bank_circulant(
        tp, 10.0, torch.tensor(x0, dtype=torch.complex64) * torch.eye(
            D, dtype=torch.complex64), n_bits, qt,
        spectra=torch.as_tensor(spec) if from_spectra else None, **kw)
    tol = 5e-4 if n_bits == 1 else 1e-5
    assert int(torch.isinf(tb.log_weights).sum()) == 2
    for name, got, want in zip(tb._fields, tb, jb):
        got, want = _np(got), np.asarray(want)
        assert got.dtype == want.dtype, name
        if name == "log_weights":
            assert np.array_equal(np.isinf(got), np.isinf(want))
            got, want = got[2:], want[2:]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < tol, (name, err)
    # the bank is O(K D): the log-weights and four (K, D) fields
    assert sum(x.numel() for x in tb) == K + 4 * K * D
    if n_bits == 1:
        # the arcsine law on the dense matrix, in float64
        f = _basis(D, blocks)
        sy = abs(x0) ** 2 * spec.astype(np.float64) + 10.0 ** -1.0
        cy = np.einsum("fd,kf,fe->kde", f.conj(), sy.astype(complex), f)
        cy = cy / sy.mean(-1)[:, None, None]
        cr = (2 / np.pi) * (np.arcsin(np.clip(cy.real, -1, 1))
                            + 1j * np.arcsin(np.clip(cy.imag, -1, 1)))
        want = np.einsum("fd,kde,fe->kf", f, cr, f.conj()).real + 1e-6
        _close(tb.spec_cr, want, 1e-3)
        _close(jb.spec_cr, want, 1e-3)


def test_prepare_bank_takes_a_scalar_pilot_and_spectra_of_any_fit(rng):
    w, means, spec = _prior(rng)
    jp, tp = _params(w, means, spec)
    _close(tsb.spectra_from_params(tp), jsb.spectra_from_params(jp), 1e-6)
    qj, qt = _quantizers(0.0, 2)
    jb = jsb.prepare_bank_circulant(jp, 0.0, 1.0 + 0.0j, 2, qj)
    for a in (1.0 + 0.0j, torch.tensor(1.0 + 0.0j),
              torch.eye(D, dtype=torch.complex64)):
        tb = tsb.prepare_bank_circulant(tp, 0.0, a, 2, qt)
        for got, want in zip(tb, jb):
            _close(got, want)
    # the stages entries: from the fit, and from spectra alone
    for tb in (tst.prepare_bank_circulant(tp, 0.0, 1.0 + 0.0j, 2, qt),
               tst.prepare_bank_circulant_spectra(
                   tp._replace(covariances=tp.prec_chol),
                   torch.as_tensor(spec), 0.0, 1.0 + 0.0j, 2, qt)):
        for got, want in zip(tb, jb):
            _close(got, want)
    carried = tsb.bank_from_numpy(jb)
    assert carried._fields == jb._fields
    for got, want in zip(carried, jb):
        assert np.array_equal(_np(got), np.asarray(want))


def test_pilot_refusals(rng):
    w, means, spec = _prior(rng)
    _, tp = _params(w, means, spec)
    with pytest.raises(ValueError, match="kron"):
        tsb.prepare_bank_circulant(tp, 10.0, torch.ones(D, D,
                                                        dtype=torch.complex64),
                                   2, _quantizers(10.0, 2)[1])
    with pytest.raises(ValueError, match="pilot shape"):
        tsb.prepare_bank_circulant(tp, 10.0, torch.ones(
            D // 2, D, dtype=torch.complex64), "inf")
    eye = torch.eye(D, dtype=torch.complex64)
    assert tsb._pilot_scalar(2.0 * eye, D) == 2.0
    assert tsb._pilot_scalar(0.5j, D) == 0.5j
    with pytest.raises(ValueError, match="scaled identity"):
        tsb._pilot_scalar(eye + torch.diag(torch.arange(D).to(eye.dtype)), D)
    with pytest.raises(ValueError, match="M = D"):
        tsb._pilot_scalar(torch.ones(2 * D, D, dtype=torch.complex64), D)
    x = torch.tensor([1.0, -1.0j], dtype=torch.complex64)
    kron = torch.kron(x[:, None], eye)
    assert torch.equal(tsb._pilot_vector(kron, D), x)
    assert tsb._pilot_vector(eye, D).shape == (1,)
    # a multi-pilot kron(x, I) is no refusal: the per-bin P x P bank, as the
    # JAX package prepares it (1e-5 of each field's scale, as the
    # single-pilot fields above)
    jp, _ = _params(w, means, spec)
    qj, qt = _quantizers(10.0, 2)
    tb = tsb.prepare_bank_circulant(tp, 10.0, kron, 2, qt)
    jb = jsb.prepare_bank_circulant(jp, 10.0, jnp.asarray(_np(kron)), 2, qj)
    assert isinstance(tb, tsb.CirculantBankMP) and tb._fields == jb._fields
    for got, want in zip(tb, jb):
        _close(got, want)


# ---------------------------------------------------------------- estimation

@pytest.mark.parametrize("mode", ["all", 1, 2, 0.9])
@pytest.mark.parametrize("blocks", [None, (4, 4)])
def test_estimate_circulant_matches_jax_f64(rng, mode, blocks):
    d = 16
    jb, _ = _banks(rng, blocks=blocks, d=d)
    jb64, tb64 = _banks64(jb)
    r = _obs(rng, 200, d, np.complex128)
    rt = torch.as_tensor(r)
    got = tsb.estimate_circulant(tb64, rt, mode, 64, blocks, "fft")
    assert got.dtype == torch.complex128 and got.shape == (200, d)
    want = np.asarray(jsb.estimate_circulant(jb64, jnp.asarray(r), mode, 64,
                                             blocks, "fft"))
    if mode == 1:
        np.testing.assert_allclose(_np(got), want, rtol=1e-9, atol=1e-11)
    else:
        _close(got, want, 5e-7)
    got_dft = tsb.estimate_circulant(tb64, rt, mode, 64, blocks, "dft")
    np.testing.assert_allclose(_np(got_dft), _np(got), rtol=1e-9, atol=1e-11)
    _close(got_dft, jsb.estimate_circulant(jb64, jnp.asarray(r), mode, 64,
                                           blocks, "dft"), 5e-5)


@pytest.mark.parametrize("mode", ["all", 2])
def test_estimate_circulant_matches_jax_f32(rng, mode):
    """A float32 bank and complex64 observations; a float64 request against
    the float32 bank computes in float64, as JAX's promotion does."""
    jb, tb = _banks(rng)
    r = _obs(rng, 300)
    got = tsb.estimate_circulant(tb, torch.as_tensor(r), mode, 128, None,
                                 "fft")
    assert got.dtype == torch.complex64
    _close(got, jsb.estimate_circulant(jb, jnp.asarray(r), mode, 128, None,
                                       "fft"))
    r64 = r.astype(np.complex128)
    got64 = tsb.estimate_circulant(tb, torch.as_tensor(r64), mode, 128, None,
                                   "fft")
    assert got64.dtype == torch.complex128
    want64 = jsb.estimate_circulant(jb, jnp.asarray(r64), mode, 128, None,
                                    "fft")
    assert want64.dtype == jnp.complex128
    _close(got64, want64, 5e-7)      # JAX's float32 sqrt(32)
    assert tsb.estimate_circulant(tb, torch.as_tensor(r[:0]), mode, 128, None,
                                  "fft").shape == (0, D)


@pytest.mark.parametrize("alpha", [1.0, 0.25, 0.0])
@pytest.mark.parametrize("mode", ["all", 1])
def test_estimate_circulant_coherent_matches_jax_f64(rng, alpha, mode):
    d = 16
    jb, _ = _banks(rng, d=d)
    jb64, tb64 = _banks64(jb)
    r = _obs(rng, 240, d, np.complex128).reshape(60, 4, d)
    got = tsb.estimate_circulant_coherent(tb64, torch.as_tensor(r), mode, 16,
                                          alpha, None, "fft")
    want = np.asarray(jsb.estimate_circulant_coherent(
        jb64, jnp.asarray(r), mode, 16, alpha, None, "fft"))
    if mode == 1:
        np.testing.assert_allclose(_np(got), want, rtol=1e-9, atol=1e-11)
    else:
        _close(got, want, 5e-7)
    np.testing.assert_allclose(
        _np(tsb.estimate_circulant_coherent(tb64, torch.as_tensor(r), mode,
                                            16, alpha, None, "dft")),
        _np(got), rtol=1e-9, atol=1e-11)
    if alpha == 0.0:      # the independent per-snapshot estimator
        flat = tsb.estimate_circulant(tb64, torch.as_tensor(r.reshape(-1, d)),
                                      mode, 64, None, "fft")
        np.testing.assert_allclose(_np(got).reshape(-1, d), _np(flat),
                                   rtol=1e-9, atol=1e-11)
    with pytest.raises(ValueError, match="blocks"):
        tsb.estimate_circulant_coherent(tb64, torch.as_tensor(r[0]))


@pytest.mark.parametrize("blocks", [None, (4, 8)])
def test_stats_and_shard_merge_match_jax(rng, blocks):
    jb, tb = _banks(rng, blocks=blocks)
    r = _obs(rng, 256)
    got = tsb.estimate_circulant_stats(tb, torch.as_tensor(r), 100, blocks)
    want = jsb.estimate_circulant_stats(jb, jnp.asarray(r), 100, blocks)
    assert got[0].shape == got[1].shape == (256,) and got[2].shape == (256, D)
    for g, w in zip(got, want):
        _close(g, w)
    # two component shards, merged, inverse-transformed once
    states = [tsb.estimate_circulant_stats(
        tsb.CirculantBank(*(x[lo:hi] for x in tb)), torch.as_tensor(r), 100,
        blocks) for lo, hi in ((0, K // 2), (K // 2, K))]
    _, den, acc = ck.merge_stats(*zip(*states))
    merged = tsb.unitary_ifft(acc / den[:, None], blocks)
    _close(merged, jsb.estimate_circulant(jb, jnp.asarray(r), "all", 16384,
                                          blocks, "fft"))


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_coherent_stats_and_shard_merge_match_jax(rng, alpha):
    jb, tb = _banks(rng)
    r = _obs(rng, 240).reshape(60, 4, D)
    got = tsb.estimate_circulant_coherent_stats(tb, torch.as_tensor(r), 25,
                                                alpha)
    want = jsb.estimate_circulant_coherent_stats(jb, jnp.asarray(r), 25,
                                                 alpha)
    lead = (60,) if alpha >= 1.0 else (60, 4)   # per block / per snapshot
    assert got[0].shape == got[1].shape == lead
    for g, w in zip(got, want):
        _close(g, w, 4e-5)
    states = [tsb.estimate_circulant_coherent_stats(
        tsb.CirculantBank(*(x[lo:hi] for x in tb)), torch.as_tensor(r), 25,
        alpha) for lo, hi in ((0, 3), (3, K))]
    _, den, acc = ck.merge_stats(*zip(*states))
    den = den[:, None, None] if alpha >= 1.0 else den[..., None]
    _close(tsb.unitary_ifft(acc / den),
           jsb.estimate_circulant_coherent(jb, jnp.asarray(r), "all", 4096,
                                           alpha, None, "fft"))


def test_method_dispatch_and_refusals(rng):
    """The one dispatch rule, `stages.estimate_circulant`: 'auto' and
    'kernel' reach the kernel entry for 'all' within the eligibility rule
    (its plain version on the CPU); selection modes and widths past the
    rule take the `torch.fft` pipeline under 'auto' and raise under
    'kernel'. `structured_bank` itself is the pipeline only, and the kernel
    entries raise past the rule."""
    jb, tb = _banks(rng)
    r = torch.as_tensor(_obs(rng, 50))
    via_kernel = ck.estimate_fused_circulant(tb, r)
    assert torch.equal(tst.estimate_circulant(tb, r), via_kernel)
    assert torch.equal(tst.estimate_circulant(tb, r, method="kernel"),
                       via_kernel)
    fft = tsb.estimate_circulant(tb, r)
    assert torch.equal(fft, tsb.estimate_circulant(tb, r, method="fft"))
    assert torch.equal(fft, tst.estimate_circulant(tb, r, method="fft"))
    assert not torch.equal(fft, via_kernel)
    _close(via_kernel, fft, 2e-4)
    assert torch.equal(tst.estimate_circulant(tb, r, 2),
                       tsb.estimate_circulant(tb, r, 2, method="fft"))
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant(tb, r, 1, method="kernel")
    with pytest.raises(ValueError, match="unknown method"):
        tst.estimate_circulant(tb, r, 1, method="mxu")
    for bad in ("mxu", "kernel", "auto"):
        with pytest.raises(ValueError, match="unknown method"):
            tsb.estimate_circulant(tb, r, 1, method=bad)
    rb = r[:48].reshape(12, 4, D)
    assert torch.equal(
        tst.estimate_circulant_coherent(tb, rb, alpha=0.5),
        ck.estimate_fused_circulant_coherent(tb, rb, 0.5))
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant_coherent(tb, rb, 0.9, method="kernel")
    with pytest.raises(ValueError, match="blocks"):
        tst.estimate_circulant_coherent(tb, rb[0])
    # D past the rule: 'auto' is the fft pipeline, 'kernel' raises
    d = ck.CIRC_WIDE_MAX_D + 1
    w, means, spec = _prior(rng, k=2, d=d)
    dummy = torch.zeros(2, 1, 1, dtype=torch.complex64)
    wide = tsb.prepare_bank_circulant(
        tg.GmmParams(torch.as_tensor(w), torch.as_tensor(means), dummy,
                     dummy), 5.0, 1.0 + 0.0j, "inf",
        spectra=torch.as_tensor(spec))
    rw = torch.as_tensor(_obs(rng, 12, d))
    assert not ck.circ_kernel_eligible(d, 2)
    assert torch.equal(tst.estimate_circulant(wide, rw),
                       tsb.estimate_circulant(wide, rw, method="fft"))
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant(wide, rw, method="kernel")
    # T past a tile's rows: the fft coherent pipeline; the kernel entry
    # raises instead of choosing another path
    t = ck.circ_tile_rows(D) + 1
    rt = torch.as_tensor(_obs(rng, 2 * t)).reshape(2, t, D)
    assert torch.equal(
        tst.estimate_circulant_coherent(tb, rt),
        tsb.estimate_circulant_coherent(tb, rt, method="fft"))
    with pytest.raises(ValueError, match="coherent circulant kernels"):
        ck.estimate_fused_circulant_coherent(tb, rt)
    with pytest.raises(ValueError, match="method='kernel'"):
        tst.estimate_circulant_coherent(tb, rt, method="kernel")
