"""The port's spectra-native circulant quantized EM
(`models.gmm_quant.fit_circulant_spectra`, the frontier-D CSI-free
trainer) against the JAX package.

Data: 3GPP channels (D = 16) observed through the JAX observation stage at
5 dB, the same complex64 rows in both packages. The statistics pass and
the recovery are held on a shared state at 1, 2 and inf bits (statistics
to 1e-5 of their scale, spectra to 1e-4 of scale); the EM per iteration
from a shared JAX result carried across by `gmm.quant_circ_fit_from_numpy`
through both `fit_circulant_spectra_resume`s (tol 0, 6 iterations: lower
bound rtol 2e-5, spectra 1e-4 of scale). The JAX loop runs un-jitted with
its `while_loop` replaced by one that keeps every state (`_recorded`). The
Gauss-Newton restarts draw from different streams in the two packages;
these inputs take none, which each test asserts by fitting again with
another generator. The streamed init is held against JAX's with both
k-means replaced by shared centres. Then the quality bands of JAX's
`TestQuantCircSpectra` on the port alone (D = 24), segmented fits, and
the refusals.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_quant as jgq
from quantized_channel_estimation_tpu.models import kmeans as jkm
from quantized_channel_estimation_tpu.ops import cov_recovery as jcr
from quantized_channel_estimation_tpu.ops import observation as jobs
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as jscm
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import em_driver
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_quant as tgq
from quantized_channel_estimation_torch.models import kmeans as tkm
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, K, N, SNR, CHUNK = 16, 4, 2000, 5.0, 512
SIGMA2 = 10 ** (-SNR / 10)
INF = jq.INF_BITS


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def channels():
    h, _ = jscm.generate_channels(jax.random.PRNGKey(3), N,
                                  jscm.ScmConfig(D, 1))
    return np.asarray(h)


def _observe(h, n_bits, snr=SNR, key=4):
    """(r numpy complex64, JAX quantizer, port quantizer)."""
    q = jq.design_quantizer(snr, n_bits)
    r = jobs.observe(jax.random.PRNGKey(key), jnp.asarray(h), snr,
                     jp.pilot_matrix(h.shape[-1], 1, n_bits), n_bits, q)
    tqz = None if q is None else tq.ScalarQuantizer(
        *(torch.as_tensor(np.array(v)) for v in q))
    return np.array(r).astype(np.complex64), q, tqz


def _pos_tau(q, n_bits):
    if q is None or n_bits == 1:
        return None
    return jcr.positive_thresholds(q)


@contextlib.contextmanager
def _recorded():
    """Run the JAX spectra EM's outer loop as a Python loop over its jitted
    body, keeping the initial state and the state after every iteration;
    every other `while_loop` is left as it is."""
    states = []
    orig = jax.lax.while_loop

    def recording(cond, body, init):
        if not isinstance(init, jgq._QStateCirc):
            return orig(cond, body, init)
        body_j, cond_j = jax.jit(body), jax.jit(cond)
        s = init
        states.append(s)
        while bool(cond_j(s)):
            s = body_j(s)
            states.append(s)
        return s

    jax.lax.while_loop = recording
    try:
        yield states
    finally:
        jax.lax.while_loop = orig


def _cfgs(**kw):
    kw = {**dict(n_components=K, cov_type="circulant", chunk_size=CHUNK),
          **kw}
    return jg.GmmConfig(**kw), tg.GmmConfig(**kw)


@pytest.mark.parametrize("n_bits", [1, 2, INF])
def test_accumulate_and_recover_match_jax(channels, n_bits):
    """One statistics pass and one recovery on JAX's init state: every
    statistic to 1e-5 of its scale, the recovered channel and quantized
    spectra to 1e-4 of scale; the restart stream unused."""
    r, q, tqz = _observe(channels, n_bits)
    jcfg, tcfg = _cfgs()
    state = jgq._circ_state0(jax.random.PRNGKey(5), jnp.asarray(r), jcfg)
    pos_tau = _pos_tau(q, n_bits)
    chunks, mask = jg._chunk(jnp.asarray(r), CHUNK)
    want = jgq._accumulate_circ(chunks, mask, jnp.log(state.weights),
                                state.means_f, state.spec_quant, pos_tau,
                                n_bits)
    t_tau = None if pos_tau is None else torch.as_tensor(np.array(pos_tau))
    got = tgq._accumulate_circ(
        torch.as_tensor(r), torch.log(torch.as_tensor(np.array(
            state.weights))), torch.as_tensor(np.array(state.means_f)),
        torch.as_tensor(np.array(state.spec_quant)), t_tau, CHUNK)
    for name in ("nk", "sx_f", "sxx_f", "log_norm"):
        _close(getattr(got, name), getattr(want, name), 1e-5)
    if pos_tau is None:
        assert got.spec_q1 is None and got.below is None
    else:
        _close(got.spec_q1, want.spec_q1, 1e-5)
        _close(got.below, want.below, 1e-5)

    spec_want = jgq._recover_circ(want, jcfg, n_bits, SIGMA2, q, pos_tau,
                                  state.spec_quant, jax.random.PRNGKey(6))
    results = [tgq._recover_circ(got, tcfg, n_bits, SIGMA2, tqz, t_tau,
                                 torch.as_tensor(np.array(state.spec_quant)),
                                 torch.Generator().manual_seed(seed))
               for seed in (0, 1)]
    for g, w in zip(results[0], spec_want):
        _close(g, w, 1e-4)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def _jax_resume(r, q, jcfg, n_bits, first):
    with _recorded() as states:
        want = jgq.fit_circulant_spectra_resume.__wrapped__(
            jax.random.PRNGKey(8), first, jnp.asarray(r), jcfg, n_bits,
            SIGMA2, q)
    return want, [float(s.lower_bound) for s in states[1:]]


@pytest.mark.parametrize("n_bits,zero_mean", [(1, True), (2, True),
                                              (INF, True), (2, False)])
def test_em_per_iteration_from_a_shared_state(channels, n_bits, zero_mean):
    """Both `fit_circulant_spectra_resume`s from one JAX fit of 2
    iterations (carried across by `gmm.quant_circ_fit_from_numpy`), tol 0:
    the lower bound after each of 6 iterations to rtol 2e-5, the spectra,
    quantized spectra, weights and means to 1e-4 of scale; no restart
    (another generator, the same fit)."""
    r, q, tqz = _observe(channels, n_bits)
    jcfg, tcfg = _cfgs(max_iter=6, tol=0.0, zero_mean=zero_mean)
    first = jgq.fit_circulant_spectra(jax.random.PRNGKey(7), jnp.asarray(r),
                                      jcfg._replace(max_iter=2), n_bits,
                                      SIGMA2, q)
    want, want_lb = _jax_resume(r, q, jcfg, n_bits, first)
    prev = tg.quant_circ_fit_from_numpy(
        first.weights, first.means, first.spectra, first.spec_quant,
        lower_bound=float(first.lower_bound), n_iter=int(first.n_iter),
        converged=bool(first.converged))
    assert prev.n_iter == 2 and prev.lb_history == []
    fits = [tgq.fit_circulant_spectra_resume(
        torch.Generator().manual_seed(seed), prev, torch.as_tensor(r), tcfg,
        n_bits, SIGMA2, tqz) for seed in (0, 1)]
    got = fits[0]
    assert got.n_iter == int(want.n_iter) == 6 == len(want_lb)
    np.testing.assert_allclose(got.lb_history, want_lb, rtol=2e-5)
    assert float(got.lower_bound) == got.lb_history[-1]
    for name in ("spectra", "spec_quant", "weights", "means"):
        _close(getattr(got, name), getattr(want, name), 1e-4)
    assert not got.converged and not bool(want.converged)
    assert fits[1].lb_history == got.lb_history
    assert torch.equal(fits[1].spectra, got.spectra)


def test_streamed_init_matches_jax(channels, monkeypatch):
    """`_streamed_init_stats` of both packages with their k-means replaced
    by the same centres (the DFTs of K means of prefix rows, [Re, Im]
    stacked): the hard-assignment statistics of every chunk, Nk exactly,
    the sums to 1e-5 of scale; the prefix JAX clusters is the port's."""
    r, _, _ = _observe(channels, 2)
    jcfg, tcfg = _cfgs(chunk_size=300)
    # generic centres (means of K groups of prefix rows): the DFTs of
    # single quantized rows lie at exact ties with many rows
    u = np.fft.fft(r[:40 * K].reshape(K, 40, D).mean(1), axis=-1) / np.sqrt(D)
    centers = np.concatenate([u.real, u.imag], -1).astype(np.float32)
    seen = {}

    def fake_jax(key, x, k, max_iter=50, **kw):
        seen["jax"] = x.shape
        return jkm.KMeansResult(jnp.asarray(centers),
                                jnp.zeros(x.shape[0], jnp.int32))

    def fake_port(gen, x, k, max_iter=50, **kw):
        seen["port"] = tuple(x.shape)
        return tkm.KMeansResult(torch.as_tensor(centers),
                                torch.zeros(x.shape[0], dtype=torch.long))

    monkeypatch.setattr(jkm, "kmeans", fake_jax)
    monkeypatch.setattr(tkm, "kmeans", fake_port)
    want = jgq._streamed_init_stats(jax.random.PRNGKey(0), jnp.asarray(r),
                                    jcfg)
    got = tgq._streamed_init_stats(torch.Generator().manual_seed(0),
                                   torch.as_tensor(r), tcfg)
    assert seen["jax"] == seen["port"] == (N, 2 * D)   # min(N, 4096) rows
    assert torch.equal(got.nk, torch.as_tensor(np.asarray(want.nk)))
    assert float(got.nk.sum()) == N
    _close(got.sx, want.sx, 1e-5)
    _close(got.sxx, want.sxx, 1e-5)


# --- the quality bands of JAX's TestQuantCircSpectra, on the port ---

D_Q = 24


@pytest.fixture(scope="module")
def quality_data():
    """Port-drawn 3GPP channels at D = 24 (14000 train, 2000 validation)
    and their 2-bit observations at 5 dB."""
    from quantized_channel_estimation_torch.ops import scm as tscm
    gen = torch.Generator().manual_seed(9)
    h, _ = tst.generate_channels(gen, 16000, tscm.ScmConfig(D_Q, 1))
    q = tq.design_quantizer(SNR, 2)
    a = tst.pilot_matrix(D_Q, 1, 2, device="cpu")
    r_tr = tst.observe(torch.Generator().manual_seed(30), h[:14000], SNR, a,
                       2, q)
    r_val = tst.observe(torch.Generator().manual_seed(32), h[14000:], SNR,
                        a, 2, q)
    return h[14000:], r_tr, r_val, q, a


def _spectra_nmse(res, h_val, r_val, q, a):
    dummy = torch.zeros((K, 1, 1), dtype=torch.complex64)
    bank = tst.prepare_bank_circulant_spectra(
        tg.GmmParams(res.weights, res.means, dummy, dummy), res.spectra,
        SNR, a, 2, q)
    return tst.nmse(tst.estimate_circulant(bank, r_val), h_val)


def test_spectra_fit_quality_band(quality_data):
    """The spectra fit's NMSE within 1.15x of the dense-recovery `fit` on
    the same data (JAX's band), every spectrum positive; the spectra banks
    serve below 1."""
    h_val, r_tr, r_val, q, a = quality_data
    cfg = tg.GmmConfig(n_components=K, cov_type="circulant", max_iter=15,
                       chunk_size=2048)
    res = tgq.fit_circulant_spectra(torch.Generator().manual_seed(34), r_tr,
                                    cfg, 2, SIGMA2, q)
    assert torch.all(res.spectra > 0) and torch.all(res.spec_quant > 0)
    m_s = _spectra_nmse(res, h_val, r_val, q, a)
    fit_d = tgq.fit(torch.Generator().manual_seed(34), r_tr, cfg, 2, SIGMA2,
                    q)
    bank_d = tst.prepare_bank_circulant(fit_d.params, SNR, a, 2, q)
    m_d = tst.nmse(tst.estimate_circulant(bank_d, r_val), h_val)
    assert 0 < m_s < 1.15 * m_d, (m_s, m_d)


def test_streamed_init_quality(quality_data, monkeypatch):
    """With the budget forced to 0 the one-device fit takes the streamed
    init and reaches the dense init's quality (within 1.15x)."""
    h_val, r_tr, r_val, q, a = quality_data
    cfg = tg.GmmConfig(n_components=K, cov_type="circulant", max_iter=14,
                       chunk_size=2048)

    def run_fit():
        res = tgq.fit_circulant_spectra(torch.Generator().manual_seed(43),
                                        r_tr, cfg, 2, SIGMA2, q)
        return _spectra_nmse(res, h_val, r_val, q, a)

    m_dense = run_fit()
    streamed = []
    orig = tgq._streamed_init_stats
    monkeypatch.setattr(tgq, "_INIT_ELEM_BUDGET", 0)
    monkeypatch.setattr(tgq, "_streamed_init_stats", lambda *args: (
        streamed.append(1), orig(*args))[1])
    m_stream = run_fit()
    assert streamed == [1]
    assert np.isfinite(m_stream) and m_stream < 1.15 * m_dense, (
        m_stream, m_dense)


def test_segmented_spectra_fit_tracks_the_continuous_fit(channels):
    """Two segments of 6 through `em_driver.fit_segmented` over
    `fit_circulant_spectra_resume` (JAX's
    `test_spectra_fit_resume_tracks_continuous`): the final lower bound
    within rtol 2e-3 of the continuous 12-iteration fit's and its spectra
    close; the history and iteration count are the 12 iterations'."""
    r, _, tqz = _observe(channels, 2, key=13)
    r = torch.as_tensor(r)
    _, cfg = _cfgs(max_iter=12, tol=0.0, chunk_size=2048)
    full = tgq.fit_circulant_spectra(torch.Generator().manual_seed(14), r,
                                     cfg, 2, SIGMA2, tqz)
    half = cfg._replace(max_iter=6)
    gen = torch.Generator().manual_seed(14)
    seg = em_driver.fit_segmented(
        lambda: tgq.fit_circulant_spectra(gen, r, half, 2, SIGMA2, tqz),
        lambda prev: tgq.fit_circulant_spectra_resume(
            torch.Generator().manual_seed(15), prev, r, half, 2, SIGMA2,
            tqz),
        n_segments=2)
    assert seg.n_iter == 12 and len(seg.lb_history) == 12
    np.testing.assert_allclose(float(seg.lower_bound),
                               float(full.lower_bound), rtol=2e-3)
    np.testing.assert_allclose(seg.spectra.numpy(), full.spectra.numpy(),
                               rtol=0.1, atol=0.02)
    # no restart fired, so the resume continued the whole fit exactly
    np.testing.assert_allclose(seg.lb_history, full.lb_history, rtol=1e-6)


@pytest.mark.parametrize("fn", ["fit_circulant_spectra",
                                "fit_circulant_spectra_resume"])
def test_refusals(channels, fn):
    """JAX's refusals: another cov_type (both entries, in both packages),
    and an n-bit fit without its quantizer."""
    r, q, tqz = _observe(channels[:256], 2)
    cfg = tg.GmmConfig(n_components=2, cov_type="full", max_iter=2)
    prev = tgq.QuantCircFitResult(*(torch.ones(2, D) for _ in range(4)),
                                  torch.tensor(0.0), 0, False, [])
    args = (() if fn == "fit_circulant_spectra" else (prev,))
    with pytest.raises(ValueError, match="circulant"):
        getattr(tgq, fn)(torch.Generator(), *args, torch.as_tensor(r), cfg,
                         2, SIGMA2, tqz)
    with pytest.raises(ValueError, match="circulant"):
        getattr(jgq, fn)(jax.random.PRNGKey(0),
                         *(() if not args else (jgq.QuantCircFitResult(
                             *(jnp.ones((2, D)) for _ in range(4)),
                             jnp.zeros(()), jnp.zeros((), jnp.int32),
                             jnp.zeros((), bool)),)),
                         jnp.asarray(r), jg.GmmConfig(n_components=2,
                                                      max_iter=2),
                         2, SIGMA2, q)
    with pytest.raises(ValueError, match="needs the quantizer"):
        getattr(tgq, fn)(torch.Generator(), *args, torch.as_tensor(r),
                         cfg._replace(cov_type="circulant"), 2, SIGMA2, None)
