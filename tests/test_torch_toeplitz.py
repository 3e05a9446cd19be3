"""The port's inverse-EM Toeplitz fit, `fit_resume` and segmented fits
against the JAX package.

The closed-form pieces (the oversampled DFT frame, the Gram-solve spectrum
recovery, the PSD projection, the best circulant approximation, the
Toeplitz M-step from shared statistics) are held at float64 to rtol 1e-8.
The EMs are held at complex64 (the JAX EM keeps float32 statistics) from
the JAX k-means labels on well-conditioned Toeplitz mixtures: the lower
bound after each of 5 iterations to rtol 1e-4 (the port reaches about
3e-7 there). `fit_resume` continues the same JAX parameters as JAX does,
and `em_driver.fit_segmented` is held to the rules of
`tests/test_segmented.py`, with a `torch.save` checkpointer.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import kmeans as jk
from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_torch.models import em_driver
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import scm as tscm

torch.set_num_threads(2)

K, N = 3, 1200


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _frame(d, blocks=None):
    """The float64 inverse-EM frame of the JAX package."""
    if blocks is None:
        return np.asarray(jl.oversampled_dft(d, jnp.complex128))
    return np.kron(np.asarray(jl.oversampled_dft(blocks[0], jnp.complex128)),
                   np.asarray(jl.oversampled_dft(blocks[1], jnp.complex128)))


def _toeplitz_mixture(rng, d, blocks=None):
    """N complex64 samples of K zero-mean Gaussians whose covariances are
    F2^H diag(s) F2 + 0.05 I for the frame of `blocks` (condition at most
    ~1e3, so float32 E-steps stay accurate)."""
    f2 = _frame(d, blocks)
    spec = (rng.uniform(0.05, 2.0, (K, f2.shape[0]))
            * (0.3 + 2.0 * np.arange(K))[:, None])
    covs = np.einsum("fd,kf,fe->kde", f2.conj(), spec, f2) + 0.05 * np.eye(d)
    lab = rng.integers(0, K, N)
    w = (rng.standard_normal((N, d)) + 1j * rng.standard_normal((N, d))) \
        / np.sqrt(2)
    x = np.empty((N, d), complex)
    for k in range(K):
        x[lab == k] = w[lab == k] @ np.linalg.cholesky(covs[k]).T
    return x.astype(np.complex64)


@pytest.mark.parametrize("n", [1, 6, 16])
def test_oversampled_dft_matches_jax_f64(n):
    got = tl.oversampled_dft(n, torch.complex128).numpy()
    np.testing.assert_allclose(got, _frame(n), rtol=1e-8, atol=1e-15)
    assert got.shape == (2 * n, n)
    np.testing.assert_allclose(got.conj().T @ got, np.eye(n), atol=1e-12)


@pytest.mark.parametrize("d,blocks", [(8, None), (6, (2, 3))])
def test_spectrum_from_covariance_matches_jax_f64(rng, d, blocks):
    f2 = _frame(d, blocks)
    spec = rng.uniform(0.1, 2.0, (K, f2.shape[0]))
    covs = np.einsum("fd,kf,fe->kde", f2.conj(), spec, f2) + 1e-3 * np.eye(d)
    want = np.asarray(jl.spectrum_from_covariance(jnp.asarray(covs),
                                                  jnp.asarray(f2), 1e-5))
    got = tl.spectrum_from_covariance(torch.as_tensor(covs),
                                      torch.as_tensor(f2.copy()),
                                      1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8)
    # it reconstructs the covariances it was given (200 steps: within
    # 2.1% of scale here), where the frame diagonal is off by half
    def error(spectrum):
        back = np.einsum("fd,kf,fe->kde", f2.conj(), spectrum, f2)
        return np.abs(back - covs).max() / np.abs(covs).max()

    naive = np.einsum("fd,kde,fe->kf", f2, covs, f2.conj()).real
    assert error(got) < 0.05 < 0.4 < error(naive)


def test_psd_project_and_best_circulant_match_jax_f64(rng):
    x = rng.standard_normal((3, 8, 8)) + 1j * rng.standard_normal((3, 8, 8))
    x = x + x.conj().transpose(0, 2, 1)
    for floor in (0.0, 0.1):
        np.testing.assert_allclose(
            tl.psd_project(torch.as_tensor(x), floor).numpy(),
            np.asarray(jl.psd_project(jnp.asarray(x), floor)),
            rtol=1e-8, atol=1e-12)
    assert np.linalg.eigvalsh(tl.psd_project(torch.as_tensor(x),
                                             0.1).numpy()).min() > 0.1 - 1e-9
    t = rng.standard_normal((4, 8)) + 1j * rng.standard_normal((4, 8))
    t[:, 0] = np.abs(t[:, 0]) + 4.0
    np.testing.assert_allclose(
        tl.best_circulant_approximation(torch.as_tensor(t)).numpy(),
        np.asarray(jl.best_circulant_approximation(jnp.asarray(t))),
        rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("zero_mean", [True, False])
def test_m_step_toeplitz_matches_jax_f64(rng, zero_mean):
    d = 6
    x = _toeplitz_mixture(rng, d).astype(np.complex128)[:300]
    resp = rng.dirichlet(np.ones(K), size=300)
    stats = (resp.sum(0), resp.T @ x,
             np.einsum("nk,nd,ne->kde", resp, x, x.conj()))
    f2 = _frame(d)
    prev = np.stack([np.cov(x[i::K].T) + 0.1 * np.eye(d) for i in range(K)])
    sigma = rng.uniform(0.1, 2.0, (K, 2 * d))
    want = jg._m_step_toeplitz(
        jg._Stats(*(jnp.asarray(a) for a in stats + (0.0,))),
        jg.GmmConfig(n_components=K, zero_mean=zero_mean),
        jnp.asarray(prev), jnp.asarray(sigma), jnp.asarray(f2))
    got = tg._m_step_toeplitz(
        tg._Stats(*(torch.as_tensor(a) for a in stats + (np.float64(0.0),))),
        tg.GmmConfig(n_components=K, zero_mean=zero_mean),
        torch.as_tensor(prev), torch.as_tensor(sigma), torch.as_tensor(f2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-8,
                                   atol=1e-12)
    # the trust region holds the step within [0.1, 10] x the old spectrum
    assert np.all(_np(got[3]) >= 0.1 * sigma - 1e-12)
    assert np.all(_np(got[3]) <= 10.0 * sigma + 1e-12)


@pytest.mark.parametrize("cov_type,d,blocks", [("toeplitz", 6, None),
                                               ("block-toeplitz", 6, (2, 3))])
def test_inverse_em_from_jax_kmeans_labels_matches_per_iteration(
        rng, cov_type, d, blocks):
    """The inverse-EM loop from the JAX k-means labels: init statistics to
    rtol 1e-5, the lower bound after each of 5 iterations to rtol 1e-4, the
    spectra, covariances and weights to 1e-4 of their scale."""
    h = _toeplitz_mixture(rng, d, blocks)
    key = jax.random.PRNGKey(3)
    kw = dict(n_components=K, chunk_size=512, tol=0.0, cov_type=cov_type,
              blocks=blocks)
    jcfg = jg.GmmConfig(**kw)
    labels = np.asarray(jk.kmeans(
        key, jc.cplx2real(jnp.asarray(h), axis=-1).astype(jnp.float32), K,
        max_iter=jcfg.kmeans_iter).labels)
    jstats = jg._init_resp_stats(key, jnp.asarray(h), jcfg, False, 512)
    xt = torch.as_tensor(h)
    tstats = tg._stats_from_labels(xt, torch.as_tensor(labels), K, 512)
    for g, w in zip(tstats, jstats):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    f2j = jg._oversampled_dft_for(jcfg, d, jnp.complex64)
    f2t = tg._oversampled_dft_for(tg.GmmConfig(**kw), d, torch.complex64)
    np.testing.assert_allclose(_np(f2t), np.asarray(f2j), atol=1e-6)
    n_it = 5
    state, _, n_iter, _, hist = tg._em_loop(
        xt, tstats, tg.GmmConfig(max_iter=n_it, **kw), "inv-em", None, f2t)
    assert n_iter == n_it and state.sigma.shape == (K, f2t.shape[0])
    want = []
    for i in range(1, n_it + 1):
        jstate, _ = jg._em_loop(jnp.asarray(h), jstats,
                                jcfg._replace(max_iter=i), "inv-em", f2j)
        want.append(float(jstate.lower_bound))
    np.testing.assert_allclose(hist, want, rtol=1e-4)
    for got, ref in ((state.sigma, jstate.sigma_spec),
                     (state.covs, jstate.covs),
                     (state.weights, jstate.weights)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("cov_type", ["full", "toeplitz"])
def test_fit_resume_continues_like_jax(rng, cov_type):
    """`fit_resume` from the same JAX parameters (a 3-iteration JAX fit):
    iterations, lower bound (rtol 1e-4) and parameters (1e-4 of scale) of
    JAX `fit_resume`; the resumed fit does not step back."""
    h = _toeplitz_mixture(rng, 6)
    cfg = dict(n_components=K, cov_type=cov_type, max_iter=3, tol=0.0,
               chunk_size=512)
    first = jg.fit(jax.random.PRNGKey(0), jnp.asarray(h), jg.GmmConfig(**cfg))
    cfg["max_iter"] = 5
    want = jg.fit_resume(first.params, jnp.asarray(h), jg.GmmConfig(**cfg))
    got = tg.fit_resume([np.asarray(p) for p in first.params],
                        torch.as_tensor(h), tg.GmmConfig(**cfg))
    assert got.n_iter == int(want.n_iter) == 5 and len(got.lb_history) == 5
    assert float(got.lower_bound) == pytest.approx(float(want.lower_bound),
                                                   rel=1e-4)
    assert float(got.lower_bound) >= float(first.lower_bound) - 1e-3
    for g, w in zip(got.params, want.params):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30))


def test_fit_resume_refuses_other_types_and_keeps_the_lower_bound(rng):
    """The JAX resume rule on the port's own Toeplitz fit: a resumed fit
    does not lose more than 1e-3, a second resume may step back by
    O(reg_covar) at the boundary (the saved covariances carry re-added
    jitter) but not by more than 0.02."""
    h = torch.as_tensor(_toeplitz_mixture(rng, 6))
    cfg = tg.GmmConfig(n_components=2, cov_type="toeplitz", max_iter=3,
                       tol=0.0, chunk_size=1024)
    first = tg.fit(torch.Generator().manual_seed(0), h, cfg)
    resumed = tg.fit_resume(first.params, h, cfg._replace(max_iter=10))
    assert float(resumed.lower_bound) >= float(first.lower_bound) - 1e-3
    again = tg.fit_resume(resumed.params, h, cfg._replace(max_iter=5))
    assert float(again.lower_bound) >= float(resumed.lower_bound) - 0.02
    c = again.params.covariances[0]
    for off in range(1, 4):
        diag = torch.diagonal(c, offset=off)
        assert (diag - diag.mean()).abs().max() \
            < 5e-2 * torch.diagonal(c).abs().mean()
    for cov_type in ("circulant", "diag", "spherical", "block-circulant"):
        with pytest.raises(NotImplementedError, match="fit_resume supports"):
            tg.fit_resume(first.params, h, cfg._replace(cov_type=cov_type))


# ---------------------------------------------------------------------------
# segmented fits (tests/test_segmented.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def channels():
    h, _ = tscm.generate_channels(torch.Generator().manual_seed(7), 2000,
                                  tscm.ScmConfig(16))
    return h


class _TorchSaveCheckpointer:
    """A checkpointer of the duck type `fit_segmented` reads: one
    `torch.save` file a step."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.root, f"step_{step}.pt")

    def latest_step(self):
        steps = [int(f[5:-3]) for f in os.listdir(self.root)
                 if f.startswith("step_")]
        return max(steps) if steps else None

    def save(self, step, result):
        torch.save(tuple(result), self._path(step))

    def restore(self, step, example_result):
        fields = torch.load(self._path(step), weights_only=False)
        return type(example_result)(*fields)


def test_segmented_matches_continuous_toeplitz(channels):
    """3 segments x 4 iterations track one continuous 12-iteration
    Toeplitz fit (the spectrum recovery at every boundary)."""
    cfg = tg.GmmConfig(n_components=4, cov_type="toeplitz", max_iter=4,
                       tol=0.0, chunk_size=1024)
    seg = em_driver.fit_segmented(
        lambda: tg.fit(torch.Generator().manual_seed(1), channels, cfg),
        lambda prev: tg.fit_resume(prev.params, channels, cfg),
        n_segments=3)
    cont = tg.fit(torch.Generator().manual_seed(1), channels,
                  cfg._replace(max_iter=12))
    assert seg.n_iter == 12 and len(seg.lb_history) == 12
    assert abs(float(seg.lower_bound) - float(cont.lower_bound)) < 0.3
    assert seg.lb_history[:4] == cont.lb_history[:4]


def test_resume_from_the_spectrum_tracks_the_whole_fit(channels):
    """`fit_resume(spectrum=prev.spectrum)` continues a Toeplitz fit
    exactly where it stopped (the spectrum and the covariances it
    defines): 3 + 5 iterations are the 8-iteration fit's, and 3 segments
    of 4 the 12-iteration fit's, lower bound for lower bound; the
    recovered spectrum (JAX's resume) is held to the 0.3 of
    `test_segmented_matches_continuous_toeplitz`."""
    cfg = tg.GmmConfig(n_components=4, cov_type="toeplitz", max_iter=3,
                       tol=0.0, chunk_size=1024)
    first = tg.fit(torch.Generator().manual_seed(1), channels, cfg)
    assert first.spectrum.shape == (4, 32) and first.spectrum.min() > 0
    resumed = tg.fit_resume(first.params, channels, cfg._replace(max_iter=5),
                            spectrum=first.spectrum)
    whole = tg.fit(torch.Generator().manual_seed(1), channels,
                   cfg._replace(max_iter=8))
    assert resumed.lb_history == whole.lb_history[3:]
    torch.testing.assert_close(resumed.params.covariances,
                               whole.params.covariances, rtol=0, atol=0)
    cfg = cfg._replace(max_iter=4)
    seg = em_driver.fit_segmented(
        lambda: tg.fit(torch.Generator().manual_seed(1), channels, cfg),
        lambda prev: tg.fit_resume(prev.params, channels, cfg,
                                   spectrum=prev.spectrum),
        n_segments=3)
    cont = tg.fit(torch.Generator().manual_seed(1), channels,
                  cfg._replace(max_iter=12))
    assert seg.lb_history == cont.lb_history
    assert tg.fit_resume(first.params, channels,
                         cfg._replace(cov_type="full")).spectrum is None


def test_segmented_stops_on_convergence(channels):
    calls = {"resume": 0}
    cfg = tg.GmmConfig(n_components=2, max_iter=50, tol=1.0,
                       chunk_size=1024)

    def resume(prev):
        calls["resume"] += 1
        return tg.fit_resume(prev.params, channels, cfg)

    res = em_driver.fit_segmented(
        lambda: tg.fit(torch.Generator().manual_seed(0), channels, cfg),
        resume, n_segments=5)
    assert res.converged and calls["resume"] == 0


def test_segmented_retries_only_declared_transient_errors(channels):
    """`max_retries` reruns a segment that raised `TransientSegmentError`;
    a CUDA-style RuntimeError and programming errors propagate at once."""
    cfg = tg.GmmConfig(n_components=2, max_iter=3, tol=0.0, chunk_size=1024)
    calls = {"start": 0, "resume": 0}

    def flaky_start():
        calls["start"] += 1
        if calls["start"] == 1:
            raise em_driver.TransientSegmentError("dropped")
        return tg.fit(torch.Generator().manual_seed(0), channels, cfg)

    def flaky_resume(prev):
        calls["resume"] += 1
        if calls["resume"] == 1:
            raise em_driver.TransientSegmentError("dropped")
        return tg.fit_resume(prev.params, channels, cfg)

    res = em_driver.fit_segmented(flaky_start, flaky_resume, n_segments=2,
                                  max_retries=1)
    assert calls == {"start": 2, "resume": 2} and res.n_iter == 6
    clean = em_driver.fit_segmented(
        lambda: tg.fit(torch.Generator().manual_seed(0), channels, cfg),
        lambda prev: tg.fit_resume(prev.params, channels, cfg), n_segments=2)
    torch.testing.assert_close(res.params.covariances,
                               clean.params.covariances)
    with pytest.raises(em_driver.TransientSegmentError):
        em_driver.fit_segmented(
            lambda: (_ for _ in ()).throw(
                em_driver.TransientSegmentError("down")),
            flaky_resume, n_segments=1, max_retries=1)
    for err in (RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"), ValueError("config error")):
        boom = {"n": 0}

        def bad_start(err=err):
            boom["n"] += 1
            raise err

        with pytest.raises(type(err)):
            em_driver.fit_segmented(bad_start, flaky_resume, n_segments=1,
                                    max_retries=3)
        assert boom["n"] == 1


def test_segmented_checkpoint_resume(channels, tmp_path):
    """Stop after 2 segments; a rerun restores segment 2's result and runs
    only the remaining one, landing where an uninterrupted run does."""
    cfg = tg.GmmConfig(n_components=2, max_iter=3, tol=0.0, chunk_size=1024)
    start = lambda: tg.fit(torch.Generator().manual_seed(3), channels, cfg)  # noqa: E731
    resume = lambda prev: tg.fit_resume(prev.params, channels, cfg)  # noqa: E731
    ck = _TorchSaveCheckpointer(str(tmp_path / "ck"))
    partial = em_driver.fit_segmented(start, resume, n_segments=2,
                                      checkpointer=ck)
    assert partial.n_iter == 6 and ck.latest_step() == 1
    calls = {"start": 0}

    def start_counting():
        calls["start"] += 1
        return start()

    with pytest.raises(ValueError, match="example_result"):
        em_driver.fit_segmented(start_counting, resume, n_segments=3,
                                checkpointer=ck)
    final = em_driver.fit_segmented(start_counting, resume, n_segments=3,
                                    checkpointer=ck, example_result=partial)
    assert calls["start"] == 0 and final.n_iter == 9
    assert len(final.lb_history) == 9
    uninterrupted = em_driver.fit_segmented(start, resume, n_segments=3)
    assert abs(float(final.lower_bound)
               - float(uninterrupted.lower_bound)) < 1e-4


def test_segmented_restore_of_converged_run_is_a_noop(channels, tmp_path):
    cfg = tg.GmmConfig(n_components=2, max_iter=50, tol=1.0, chunk_size=1024)
    start = lambda: tg.fit(torch.Generator().manual_seed(0), channels, cfg)  # noqa: E731
    resume = lambda prev: tg.fit_resume(prev.params, channels, cfg)  # noqa: E731
    ck = _TorchSaveCheckpointer(str(tmp_path / "ck"))
    done = em_driver.fit_segmented(start, resume, n_segments=3,
                                   checkpointer=ck)
    assert done.converged and ck.latest_step() == 0
    calls = {"n": 0}

    def never(*_):
        calls["n"] += 1
        raise AssertionError("a converged restore must not refit")

    again = em_driver.fit_segmented(never, never, n_segments=3,
                                    checkpointer=ck, example_result=done)
    assert calls["n"] == 0 and again.n_iter == done.n_iter
    assert float(again.lower_bound) == float(done.lower_bound)
    with pytest.raises(ValueError, match="n_segments"):
        em_driver.fit_segmented(start, resume, n_segments=0)
