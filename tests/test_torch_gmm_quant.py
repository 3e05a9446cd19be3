"""The port's quantized EM (`models.gmm_quant`, CSI-free training) against
the JAX package.

Data: 3GPP channels (D = 16) observed through the JAX observation stage at
5 dB, the same complex64 rows in both packages. Each EM is held from the
JAX k-means labels (the port's `gmm._stats_from_labels` into
`gmm_quant.fit_from_stats`): the initial state and the lower bound after
each of 5 iterations to rtol 2e-5, the recovered and the quantized
covariances to 1e-4 of their scale, in every dense covariance type at 1,
2 and inf bits where the type takes them, with a Lloyd quantizer, and
with non-zero means
(1-bit 'circulant' drifts past 1e-4 in float32 in both packages: its
covariances are held against the float64 fit instead). The
JAX loop runs un-jitted with its `while_loop` replaced by one that keeps
every state (`_recorded`), so each iteration is read once. The
Gauss-Newton restarts draw from different streams in the two packages;
these inputs take none, which each test asserts by fitting again with
another generator. Then the refusals, the dead-component guard, and
`fit_resume` continuing like JAX's, with the Toeplitz spectrum deviation
held by its own test.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_quant as jgq
from quantized_channel_estimation_tpu.models import kmeans as jk
from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import observation as jobs
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as jscm
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_quant as tgq
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, K, N, SNR, CHUNK = 16, 4, 2000, 5.0, 1024
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


def _observe(h, n_bits, qtype="uniform"):
    """(r numpy complex64, JAX quantizer, port quantizer) at 5 dB."""
    q = jq.design_quantizer(SNR, n_bits, qtype)
    r = jobs.observe(jax.random.PRNGKey(4), jnp.asarray(h), SNR,
                     jp.pilot_matrix(D, 1, n_bits), n_bits, q)
    tqz = None if q is None else tq.ScalarQuantizer(
        *(torch.as_tensor(np.array(v)) for v in q))
    return np.array(r).astype(np.complex64), q, tqz


@contextlib.contextmanager
def _recorded():
    """Run the JAX quantized EM's outer loop as a Python loop over its
    jitted body, keeping the initial state and the state after every
    iteration; every other `while_loop` is left as it is."""
    states = []
    orig = jax.lax.while_loop

    def recording(cond, body, init):
        if not isinstance(init, (jgq._QState, jgq._QStateDiag)):
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


def _cfgs(cov_type, **kw):
    kw = dict(n_components=K, cov_type=cov_type, max_iter=5, tol=0.0,
              chunk_size=CHUNK,
              blocks=(4, 4) if cov_type == "block-toeplitz" else None, **kw)
    return jg.GmmConfig(**kw), tg.GmmConfig(**kw)


def _jax_fit(r, jcfg, n_bits, q, key=jax.random.PRNGKey(5)):
    with _recorded() as states:
        fit = jgq.fit.__wrapped__(key, jnp.asarray(r), jcfg, n_bits, SIGMA2,
                                  q)
    return fit, states


def _port_from_labels(r, tcfg, n_bits, q, labels, seed=0):
    diag = tcfg.cov_type in ("diag", "spherical")
    xt = torch.as_tensor(r)
    stats = tg._stats_from_labels(xt, torch.as_tensor(labels), K, CHUNK,
                                  diag)
    return tgq.fit_from_stats(torch.Generator().manual_seed(seed), xt, stats,
                              tcfg, n_bits, SIGMA2, q), stats


def _kmeans_labels(r, jcfg, key=jax.random.PRNGKey(5)):
    """The labels of the k-means inside JAX `fit` (its init key)."""
    k_init, _ = jax.random.split(key)
    return np.array(jk.kmeans(
        k_init, jc.cplx2real(jnp.asarray(r), axis=-1).astype(jnp.float32),
        K, max_iter=jcfg.kmeans_iter).labels)


def _min_eig_floor(covs, reg):
    """Every recovered covariance keeps its floor: min eigenvalue >=
    reg_covar, within float32 rounding of its norm."""
    covs = torch.as_tensor(covs)
    w = torch.linalg.eigvalsh(covs).min(-1).values
    nrm = torch.linalg.matrix_norm(covs)
    assert torch.all(w >= reg - 2e-6 * nrm), (w, nrm)


CASES = [("full", 1, "uniform"), ("full", 2, "uniform"),
         ("full", INF, "uniform"), ("toeplitz", 1, "uniform"),
         ("toeplitz", 2, "uniform"), ("toeplitz", INF, "uniform"),
         ("block-toeplitz", 1, "uniform"), ("block-toeplitz", 2, "uniform"),
         ("block-toeplitz", INF, "uniform"), ("diag", 2, "uniform"),
         ("diag", INF, "uniform"), ("spherical", 2, "uniform"),
         ("spherical", INF, "uniform"), ("circulant", 1, "uniform"),
         ("circulant", 2, "uniform"), ("circulant", INF, "uniform"),
         ("full", 3, "lloyd"), ("full", 2, "non-zero means"),
         ("diag", 2, "non-zero means")]
# held against float64 (see the test)
FLOAT64_RULE = {("circulant", 1)}


@pytest.mark.parametrize("cov_type,n_bits,qtype", CASES)
def test_quant_em_from_jax_kmeans_labels_matches_per_iteration(
        channels, cov_type, n_bits, qtype):
    zero_mean = qtype != "non-zero means"
    r, q, tqz = _observe(channels, n_bits, "lloyd" if qtype == "lloyd"
                         else "uniform")
    jcfg, tcfg = _cfgs(cov_type, zero_mean=zero_mean)
    jfit, states = _jax_fit(r, jcfg, n_bits, q)
    labels = _kmeans_labels(r, jcfg)
    got, stats = _port_from_labels(r, tcfg, n_bits, tqz, labels)
    diag = cov_type in ("diag", "spherical")

    # the same initial state: the port's init from the JAX labels is JAX's
    f2 = tgq._prep(torch.as_tensor(r), tcfg, n_bits, tqz)[1]
    state0 = (tgq._diag_state0(stats, tcfg) if diag
              else tgq._state0(stats, tcfg, f2))
    for g, w in zip(state0, states[0]):
        _close(g, w, 1e-5)

    want_lb = [float(s.lower_bound) for s in states[1:]]
    assert got.n_iter == int(jfit.n_iter) == 5 == len(want_lb)
    np.testing.assert_allclose(got.lb_history, want_lb, rtol=2e-5)
    assert float(got.lower_bound) == got.lb_history[-1]
    pairs = ((got.params.covariances, jfit.params.covariances),
             (got.cov_quant, jfit.cov_quant))
    if (cov_type, n_bits) in FLOAT64_RULE:
        # the arcsine law of the projected, nearly singular normalized Cy
        # amplifies float32 rounding: both packages lie ~1e-4 of the scale
        # off the float64 fit (the port's, from the same labels), so each
        # is held against it, the port within twice JAX's error
        ref, _ = _port_from_labels(r.astype(np.complex128), tcfg, n_bits,
                                   tqz, labels)
        for (g, w), r64 in zip(pairs, (ref.params.covariances,
                                       ref.cov_quant)):
            r64 = _np(r64)
            e_port, e_jax = (np.abs(_np(x) - r64).max() / np.abs(r64).max()
                             for x in (g, w))
            assert e_port <= 2.0 * e_jax and e_port <= 1e-3, (e_port, e_jax)
    else:
        for g, w in pairs:
            _close(g, w, 1e-4)
    _close(got.params.weights, jfit.params.weights, 1e-4)
    if cov_type in ("toeplitz", "block-toeplitz"):
        _close(got.spectrum, states[-1].sigma_spec, 1e-4)
    else:
        assert got.spectrum is None
    if diag:
        off = _np(got.params.covariances) * (1 - np.eye(D))
        assert np.abs(off).max() == 0.0
    else:
        _min_eig_floor(got.params.covariances, tcfg.reg_covar)
    # no Gauss-Newton restart: another restart stream, the same fit
    again, _ = _port_from_labels(r, tcfg, n_bits, tqz, labels, seed=1)
    assert again.lb_history == got.lb_history
    assert torch.equal(again.params.covariances, got.params.covariances)


@pytest.mark.parametrize("cov_type,n_bits,error,match", [
    ("diag", 1, NotImplementedError, "unidentifiable"),
    ("spherical", 1, NotImplementedError, "unidentifiable"),
    ("block-circulant", 2, NotImplementedError, "supported are"),
    ("tied", INF, NotImplementedError, "supported are"),
    ("full", 2, ValueError, "needs the quantizer"),
])
def test_refusals(channels, cov_type, n_bits, error, match):
    """JAX's refusals (1-bit diagonal models, unknown types), raised before
    any work; an n-bit fit without its quantizer too."""
    r, q, tqz = _observe(channels[:200], n_bits)
    cfg = tg.GmmConfig(n_components=2, cov_type=cov_type, max_iter=2)
    with pytest.raises(error, match=match):
        tgq.fit(torch.Generator().manual_seed(0), torch.as_tensor(r), cfg,
                n_bits, SIGMA2, None if error is ValueError else tqz)
    if error is NotImplementedError:
        with pytest.raises(error, match=match):
            jgq.fit(jax.random.PRNGKey(0), jnp.asarray(r),
                    jg.GmmConfig(n_components=2, cov_type=cov_type,
                                 max_iter=2), n_bits, SIGMA2, q)


@pytest.mark.parametrize("cov_type", ["full", "diag"])
def test_dead_component_is_parked(channels, cov_type):
    """A component that k-means left empty (Nk < 2) is parked at a
    unit-power prior (identity covariances, ~zero weight) every iteration,
    as in JAX: the same labels through both loops agree (lower bound
    rtol 2e-5, covariances 1e-4 of scale) and the fit stays finite."""
    r, q, tqz = _observe(channels, 2)
    jcfg, tcfg = _cfgs(cov_type)
    labels = _kmeans_labels(r, jcfg)
    labels[labels == K - 1] = 0          # component K-1 empty
    got, stats = _port_from_labels(r, tcfg, 2, tqz, labels)
    assert float(stats.nk[K - 1]) == 0.0
    assert np.all(np.isfinite(got.lb_history))
    covs = _np(got.params.covariances)[K - 1]
    eye = np.eye(D)
    want_dead = eye if cov_type == "diag" else eye * (1 + tcfg.reg_covar)
    np.testing.assert_allclose(covs, want_dead, atol=1e-6)
    assert float(got.params.weights[K - 1]) < 1e-6

    # JAX from the same labels: its loop run from the statistics of the
    # numpy one-hot assignment
    onehot = np.eye(K, dtype=np.float32)[labels]
    diag = cov_type == "diag"
    init = jg._Stats(
        jnp.asarray(onehot.sum(0)), jnp.asarray(onehot.T @ r),
        jnp.asarray(onehot.T @ np.abs(r) ** 2 if diag else np.einsum(
            "nk,nd,ne->kde", onehot, r, r.conj())), jnp.asarray(0.0))
    nk0 = init.nk + 10.0 * jnp.finfo(jnp.float32).eps
    means0 = jnp.zeros((K, D), jnp.complex64)
    pos_tau = jnp.asarray(np.asarray(q.thresholds)[2:])
    chunks, mask = jg._chunk(jnp.asarray(r), CHUNK)
    inf_, minf = jnp.asarray(jnp.inf, jnp.float32), jnp.asarray(
        -jnp.inf, jnp.float32)
    with _recorded() as states:
        if diag:
            vq0 = init.sxx / nk0[:, None] + jcfg.reg_covar
            jfit = jgq._run_quant_em_diag(
                jgq._QStateDiag(nk0 / nk0.sum(), means0, vq0, vq0, minf,
                                inf_, jnp.zeros((), jnp.int32)),
                chunks, mask, N, jcfg, 2, SIGMA2, q, pos_tau,
                jax.random.PRNGKey(1))
        else:
            eye_j = jnp.eye(D, dtype=jnp.complex64)
            cq0 = (init.sxx / nk0[:, None, None].astype(jnp.complex64)
                   + jcfg.reg_covar * eye_j)
            jfit = jgq._run_quant_em(
                jgq._QState(nk0 / nk0.sum(), means0, cq0, cq0,
                            jnp.zeros((K, 1), jnp.float32), minf, inf_,
                            jnp.zeros((), jnp.int32)),
                chunks, mask, N, jcfg, 2, SIGMA2, q, pos_tau, False, None,
                eye_j, jax.random.PRNGKey(1))
    np.testing.assert_allclose(
        got.lb_history, [float(s.lower_bound) for s in states[1:]],
        rtol=2e-5)
    _close(got.params.covariances, jfit.params.covariances, 1e-4)
    _close(got.cov_quant, jfit.cov_quant, 1e-4)


@pytest.mark.parametrize("cov_type", ["full", "toeplitz", "diag",
                                      "circulant"])
def test_fit_resume_continues_like_jax(channels, cov_type):
    """`fit_resume` from the same JAX fit (3 iterations, carried across by
    `gmm.quant_fit_from_numpy`): JAX `fit_resume`'s lower bound after each
    of 5 more iterations (rtol 2e-5) and its parameters (1e-4 of scale);
    the resumed fit does not step back (the JAX test's 1e-3). A Toeplitz
    fit carried across has no spectrum, so both recover it from the
    covariances."""
    r, q, tqz = _observe(channels, 2)
    jcfg, tcfg = _cfgs(cov_type)
    first = jgq.fit(jax.random.PRNGKey(2), jnp.asarray(r),
                    jcfg._replace(max_iter=3), 2, SIGMA2, q)
    with _recorded() as states:
        want = jgq.fit_resume.__wrapped__(jax.random.PRNGKey(3), first,
                                          jnp.asarray(r), jcfg, 2, SIGMA2, q)
    prev = tg.quant_fit_from_numpy(
        [np.asarray(p) for p in first.params], np.asarray(first.cov_quant),
        lower_bound=float(first.lower_bound), n_iter=int(first.n_iter),
        converged=bool(first.converged))
    assert prev.spectrum is None and prev.n_iter == 3
    got = tgq.fit_resume(torch.Generator().manual_seed(0), prev,
                         torch.as_tensor(r), tcfg, 2, SIGMA2, tqz)
    assert got.n_iter == int(want.n_iter) == 5
    np.testing.assert_allclose(
        got.lb_history, [float(s.lower_bound) for s in states[1:]],
        rtol=2e-5)
    for g, w in zip(got.params[:3], want.params[:3]):
        _close(g, w, 1e-4)
    _close(got.cov_quant, want.cov_quant, 1e-4)
    assert float(got.lower_bound) >= float(first.lower_bound) - 1e-3


def test_toeplitz_resume_from_the_spectrum_tracks_the_whole_fit(channels):
    """Deviation: the port's Toeplitz result carries its inverse-EM
    spectrum and `fit_resume(..., spectrum=)` continues from it, so 3 + 5
    iterations are the whole 8-iteration fit's (lower bounds to rtol
    1e-6); JAX's way (no spectrum: recovered from the saved covariances)
    is farther from the whole fit."""
    r, q, tqz = _observe(channels, 2)
    jcfg, tcfg = _cfgs("toeplitz")
    labels = _kmeans_labels(r, jcfg)
    whole, _ = _port_from_labels(r, tcfg._replace(max_iter=8), 2, tqz,
                                 labels)
    first, _ = _port_from_labels(r, tcfg._replace(max_iter=3), 2, tqz,
                                 labels)
    assert first.spectrum.shape == (K, 2 * D)
    xt = torch.as_tensor(r)
    resumed = {
        way: tgq.fit_resume(torch.Generator().manual_seed(0), first, xt,
                            tcfg, 2, SIGMA2, tqz, spectrum=spectrum)
        for way, spectrum in (("spectrum", first.spectrum),
                              ("recovered", None))}
    np.testing.assert_allclose(resumed["spectrum"].lb_history,
                               whole.lb_history[3:], rtol=1e-6)
    _close(resumed["spectrum"].params.covariances,
           whole.params.covariances, 1e-5)
    gap = {way: np.abs(np.subtract(res.lb_history,
                                   whole.lb_history[3:])).max()
           for way, res in resumed.items()}
    assert gap["spectrum"] < gap["recovered"], gap
