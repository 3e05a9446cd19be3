"""Parity of the port's k-means and GMM EM (full, circulant,
block-circulant, diag and spherical covariances) with the JAX package
(the Toeplitz fits: tests/test_torch_toeplitz.py).

The JAX EM accumulates its statistics in float32 scan carries
(`gmm.py:167-171`, `:451`), so it cannot run on complex128 data; EM is
held at complex64 from the JAX k-means labels: lower bound after every
iteration to rtol 2e-5 and the fitted parameters to 1e-4 relative (f32
sums over 1200 samples in another order). The closed-form pieces
(log-densities, the M-step) are held at float64 to rtol 1e-10.
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
from quantized_channel_estimation_tpu.utils import io as jio
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import kmeans as tk
from quantized_channel_estimation_torch.utils import io as tio

torch.set_num_threads(2)

D, K, N = 6, 3, 1200


def _mixture_data(rng, dtype=np.complex64):
    """N samples from K well-separated zero-mean complex Gaussians."""
    covs = []
    for k in range(K):
        a = (rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D)))
        c = a @ a.conj().T / D + 0.05 * np.eye(D)
        covs.append(c * (0.3 + 2.0 * k))
    lab = rng.integers(0, K, N)
    x = np.empty((N, D), complex)
    for k in range(K):
        idx = lab == k
        w = (rng.standard_normal((idx.sum(), D))
             + 1j * rng.standard_normal((idx.sum(), D))) / np.sqrt(2)
        x[idx] = w @ np.linalg.cholesky(covs[k]).T
    return x.astype(dtype)


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_log_prob_and_predict_proba_match_jax(rng):
    x = _mixture_data(rng, np.complex128)[:50]
    covs = np.stack([np.cov(x[i::3].T) + 0.1 * np.eye(D) for i in range(K)])
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    means = x[:K] * 0.1
    got = tg.log_prob_full(torch.as_tensor(x), torch.as_tensor(means),
                           torch.as_tensor(prec))
    want = jg.log_prob_full(jnp.asarray(x), jnp.asarray(means),
                            jnp.asarray(prec))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10)
    w = np.array([0.2, 0.5, 0.3])
    pt = tg.predict_proba(tg.GmmParams(*(torch.as_tensor(a) for a in (
        w, means, covs, prec))), torch.as_tensor(x))
    pj = jg.predict_proba(jg.GmmParams(*(jnp.asarray(a) for a in (
        w, means, covs, prec))), jnp.asarray(x))
    np.testing.assert_allclose(_np(pt), np.asarray(pj), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("zero_mean", [True, False])
def test_m_step_matches_jax_f64(rng, zero_mean):
    x = _mixture_data(rng, np.complex128)[:200]
    resp = rng.dirichlet(np.ones(K), size=200)
    nk = resp.sum(0)
    sx = resp.T @ x
    sxx = np.einsum("nk,nd,ne->kde", resp, x, x.conj())
    cfg = jg.GmmConfig(n_components=K, zero_mean=zero_mean)
    tcfg = tg.GmmConfig(n_components=K, zero_mean=zero_mean)
    want = jg._m_step_full(jg._Stats(*(jnp.asarray(a) for a in (
        nk, sx, sxx, 0.0))), cfg)
    got = tg._m_step_full(tg._Stats(*(torch.as_tensor(a) for a in (
        nk, sx, sxx, np.float64(0.0)))), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-10,
                                   atol=1e-14)


def _jax_init(x, key, cfg):
    labels = jk.kmeans(key, jc.cplx2real(jnp.asarray(x), axis=-1)
                       .astype(jnp.float32), K,
                       max_iter=cfg.kmeans_iter).labels
    stats = jg._init_resp_stats(key, jnp.asarray(x), cfg, False,
                                cfg.chunk_size)
    return np.asarray(labels), stats


def test_em_from_jax_kmeans_labels_matches_per_iteration(rng):
    x = _mixture_data(rng)
    key = jax.random.PRNGKey(3)
    jcfg = jg.GmmConfig(n_components=K, chunk_size=512, tol=0.0)
    labels, jstats = _jax_init(x, key, jcfg)
    xt = torch.as_tensor(x)
    tstats = tg._stats_from_labels(xt, torch.as_tensor(labels), K, 512)
    for g, w in zip(tstats, jstats):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    n_it = 5
    tcfg = tg.GmmConfig(n_components=K, chunk_size=512, tol=0.0,
                        max_iter=n_it)
    state, lb, n_iter, _, hist = tg._em_loop(xt, tstats, tcfg)
    assert n_iter == n_it and len(hist) == n_it
    want = []
    for i in range(1, n_it + 1):
        jstate, _ = jg._em_loop(jnp.asarray(x), jstats,
                                jcfg._replace(max_iter=i), "full", None)
        want.append(float(jstate.lower_bound))
    np.testing.assert_allclose(hist, want, rtol=2e-5)
    assert all(b >= a - 1e-4 for a, b in zip(hist, hist[1:]))  # EM ascent
    np.testing.assert_allclose(_np(state.weights), np.asarray(jstate.weights),
                               rtol=1e-4)
    scale = np.abs(np.asarray(jstate.covs)).max()
    np.testing.assert_allclose(_np(state.covs), np.asarray(jstate.covs),
                               rtol=0, atol=1e-4 * scale)


def test_fit_converges_like_jax(rng):
    """Whole fits from each package's own k-means init reach the same
    converged lower bound on well-separated data (rtol 1e-3: the two
    inits may land on slightly different local optima)."""
    x = _mixture_data(rng)
    res = tg.fit(torch.Generator().manual_seed(0), torch.as_tensor(x),
                 tg.GmmConfig(n_components=K, chunk_size=512, n_init=2))
    jres = jg.fit(jax.random.PRNGKey(0), jnp.asarray(x),
                  jg.GmmConfig(n_components=K, chunk_size=512))
    assert res.converged and res.n_iter >= 2
    assert float(res.lower_bound) == pytest.approx(float(jres.lower_bound),
                                                   rel=1e-3)
    p = res.params
    assert torch.allclose(p.weights.sum(), torch.tensor(1.0))
    assert (p.covariances - p.covariances.mH).abs().max() < 1e-6
    eye = torch.eye(D, dtype=p.prec_chol.dtype)
    inv_check = p.covariances @ p.prec_chol @ p.prec_chol.mH
    assert (inv_check - eye).abs().max() < 1e-3
    assert torch.all(p.means == 0)


def _structured_mixture(rng, d, blocks=None, cov_type="circulant"):
    """N complex64 samples of K zero-mean Gaussians whose covariances are
    diagonal in the basis of `cov_type`: the (block-)DFT, or the identity
    for 'diag' / 'spherical'."""
    if "circulant" not in cov_type:
        f = np.eye(d)
    elif blocks is None:
        f = np.asarray(jl.unitary_dft(d, jnp.complex128))
    else:
        f = np.kron(np.asarray(jl.unitary_dft(blocks[0], jnp.complex128)),
                    np.asarray(jl.unitary_dft(blocks[1], jnp.complex128)))
    spec = rng.uniform(0.05, 2.0, (K, d)) * (0.3 + 2.0 * np.arange(K))[:, None]
    if cov_type == "spherical":
        spec = np.broadcast_to(spec[:, :1], (K, d))
    lab = rng.integers(0, K, N)
    w = (rng.standard_normal((N, d)) + 1j * rng.standard_normal((N, d))) \
        / np.sqrt(2)
    return ((np.sqrt(spec)[lab] * w) @ f.conj()).astype(np.complex64)


def test_log_prob_diag_and_m_step_diag_match_jax_f64(rng):
    x = _mixture_data(rng, np.complex128)[:200]
    var = rng.uniform(0.1, 2.0, (K, D))
    means = x[:K] * 0.1
    got = tg.log_prob_diag(torch.as_tensor(x), torch.as_tensor(means),
                           torch.as_tensor(var))
    want = jg.log_prob_diag(jnp.asarray(x), jnp.asarray(means),
                            jnp.asarray(var))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10)
    resp = rng.dirichlet(np.ones(K), size=200)
    stats = (resp.sum(0), resp.T @ x, resp.T @ (np.abs(x) ** 2))
    for zero_mean in (True, False):
        want = jg._m_step_diag(
            jg._Stats(*(jnp.asarray(a) for a in stats + (0.0,))),
            jg.GmmConfig(n_components=K, zero_mean=zero_mean))
        got = tg._m_step_diag(
            tg._Stats(*(torch.as_tensor(a) for a in stats
                        + (np.float64(0.0),))),
            tg.GmmConfig(n_components=K, zero_mean=zero_mean))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-10,
                                       atol=1e-14)


@pytest.mark.parametrize("cov_type,d,blocks", [
    ("circulant", 6, None), ("block-circulant", 32, (4, 8)),
    ("diag", 6, None), ("spherical", 6, None)])
def test_diagonal_em_from_jax_kmeans_labels_matches_per_iteration(
        rng, cov_type, d, blocks):
    """The diagonal EM of the structured covariance types, on the data the
    fit hands it (DFT-domain for the circulant types), from the JAX k-means
    labels: lower bound per iteration and the fitted spectra / variances,
    at the tolerances of the full-covariance EM above."""
    h = _structured_mixture(rng, d, blocks, cov_type)
    key = jax.random.PRNGKey(3)
    kw = dict(n_components=K, chunk_size=512, tol=0.0, cov_type=cov_type,
              blocks=blocks)
    jcfg = jg.GmmConfig(**kw)
    mode = "diag" if "circulant" in cov_type else cov_type
    if mode == "diag" and cov_type != "diag":
        fj = jg._dft_for(jcfg, d, jnp.complex64)
        ft = tg._dft_for(tg.GmmConfig(**kw), d, torch.complex64)
        np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=2e-5)
        xj = jnp.asarray(h) @ fj.T
        # one basis for both, so the data the two loops see are equal
        xt = torch.as_tensor(np.asarray(xj))
    else:
        xj, xt = jnp.asarray(h), torch.as_tensor(h)
    labels = np.asarray(jk.kmeans(
        key, jc.cplx2real(xj, axis=-1).astype(jnp.float32), K,
        max_iter=jcfg.kmeans_iter).labels)
    jstats = jg._init_resp_stats(key, xj, jcfg, True, 512)
    tstats = tg._stats_from_labels(xt, torch.as_tensor(labels), K, 512, True)
    assert tstats.sxx.shape == (K, d) and not tstats.sxx.is_complex()
    for g, w in zip(tstats, jstats):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    n_it = 5
    state, lb, n_iter, _, hist = tg._em_loop(
        xt, tstats, tg.GmmConfig(max_iter=n_it, **kw), mode)
    assert n_iter == n_it
    want = []
    for i in range(1, n_it + 1):
        jstate, _ = jg._em_loop(xj, jstats, jcfg._replace(max_iter=i), mode,
                                None)
        want.append(float(jstate.lower_bound))
    np.testing.assert_allclose(hist, want, rtol=2e-5)
    np.testing.assert_allclose(_np(state.weights), np.asarray(jstate.weights),
                               rtol=1e-4)
    scale = np.abs(np.asarray(jstate.covs)).max()
    assert state.covs.shape == (K, d)
    np.testing.assert_allclose(_np(state.covs), np.asarray(jstate.covs),
                               rtol=0, atol=1e-4 * scale)
    if cov_type == "spherical":
        assert torch.equal(state.covs, state.covs[:, :1].expand(K, d))


@pytest.mark.parametrize("cov_type,d,blocks", [
    ("circulant", 8, None), ("block-circulant", 8, (2, 4)),
    ("diag", 8, None), ("spherical", 8, None)])
def test_structured_fits_return_dense_params_like_jax(rng, cov_type, d,
                                                      blocks):
    """A whole fit of each structured type returns dense covariances of
    that structure with a valid precision factor, and its converged lower
    bound is JAX's (rtol 1e-3: each package's own k-means init)."""
    h = _structured_mixture(rng, d, blocks, cov_type)
    kw = dict(n_components=K, chunk_size=512, cov_type=cov_type,
              blocks=blocks)
    res = tg.fit(torch.Generator().manual_seed(0), torch.as_tensor(h),
                 tg.GmmConfig(**kw))
    jres = jg.fit(jax.random.PRNGKey(0), jnp.asarray(h), jg.GmmConfig(**kw))
    assert res.converged
    assert float(res.lower_bound) == pytest.approx(float(jres.lower_bound),
                                                   rel=1e-3)
    p = res.params
    assert p.covariances.shape == (K, d, d) and p.means.shape == (K, d)
    assert (p.covariances - p.covariances.mH).abs().max() < 1e-6
    eye = torch.eye(d, dtype=p.prec_chol.dtype)
    assert (p.covariances @ p.prec_chol @ p.prec_chol.mH
            - eye).abs().max() < 1e-3
    f = torch.eye(d, dtype=torch.complex64) if "circulant" not in cov_type \
        else tg._dft_for(tg.GmmConfig(**kw), d, torch.complex64)
    in_basis = f @ p.covariances @ f.mH          # diagonal in the basis
    off = in_basis - torch.diag_embed(torch.diagonal(in_basis, dim1=-2,
                                                     dim2=-1))
    assert off.abs().max() < 1e-5 * in_basis.abs().max()
    if cov_type == "spherical":
        diag = torch.diagonal(p.covariances, dim1=-2, dim2=-1).real
        assert (diag - diag[:, :1]).abs().max() < 1e-6 * diag.max()
    # sorted by size, the fitted weights are JAX's
    np.testing.assert_allclose(np.sort(_np(p.weights)),
                               np.sort(np.asarray(jres.params.weights)),
                               atol=2e-2)


def test_block_circulant_fit_checks_its_blocks():
    """Block structures check their blocks; the Toeplitz types (item 8,
    ported) fit: their covariances are Hermitian PSD with a valid
    precision factor, and 'block-toeplitz' checks its blocks too."""
    x = torch.as_tensor(_mixture_data(np.random.default_rng(1)))
    with pytest.raises(ValueError, match="incompatible"):
        tg.fit(torch.Generator(), x, tg.GmmConfig(
            K, cov_type="block-circulant", blocks=(2, 4)))
    with pytest.raises(NotImplementedError, match="not implemented"):
        tg.fit(torch.Generator(), x, tg.GmmConfig(K, cov_type="tied"))
    for cov_type in ("toeplitz", "block-toeplitz"):
        res = tg.fit(torch.Generator().manual_seed(0), x, tg.GmmConfig(
            K, cov_type=cov_type, blocks=(2, 3), max_iter=5))
        p = res.params
        assert res.n_iter == 5 and np.isfinite(float(res.lower_bound))
        assert (p.covariances - p.covariances.mH).abs().max() < 1e-6
        assert torch.linalg.eigvalsh(p.covariances).min() > 0
        eye = torch.eye(D, dtype=p.prec_chol.dtype)
        assert (p.covariances @ p.prec_chol @ p.prec_chol.mH
                - eye).abs().max() < 1e-3
    with pytest.raises(ValueError, match="incompatible"):
        tg.fit(torch.Generator(), x, tg.GmmConfig(
            K, cov_type="block-toeplitz", blocks=(2, 4)))


def test_random_init_and_unported_cov_types():
    """The random init, for the full fit and (item 8, ported) the Toeplitz
    one, whose covariances are Toeplitz (the JAX test's rule,
    `tests/test_gmm.py:88`)."""
    x = torch.as_tensor(_mixture_data(np.random.default_rng(1)))
    res = tg.fit(torch.Generator().manual_seed(0), x,
                 tg.GmmConfig(n_components=K, init="random", max_iter=5))
    assert np.isfinite(float(res.lower_bound)) and res.n_iter == 5
    res = tg.fit(torch.Generator().manual_seed(0), x,
                 tg.GmmConfig(1, cov_type="toeplitz", init="random",
                              max_iter=8))
    assert np.isfinite(float(res.lower_bound)) and res.n_iter == 8
    c = res.params.covariances[0]
    for off in range(1, 5):
        diag = torch.diagonal(c, offset=off)
        assert (diag - diag.mean()).abs().max() \
            < 5e-2 * torch.diagonal(c).abs().mean()


def test_params_roundtrip_through_both_packages_npz(tmp_path, rng):
    x = _mixture_data(rng)
    jres = jg.fit(jax.random.PRNGKey(0), jnp.asarray(x),
                  jg.GmmConfig(n_components=K, max_iter=3))
    path = os.path.join(tmp_path, "jax_gmm.npz")
    jio.save_pytree_npz(path, jres.params)
    p = tg.params_from_numpy(path)
    for g, w in zip(p, jres.params):
        assert np.array_equal(_np(g), np.asarray(w))
    p2 = tg.params_from_numpy(tuple(np.asarray(a) for a in jres.params))
    assert all(torch.equal(a, b) for a, b in zip(p, p2))
    path2 = os.path.join(tmp_path, "port_gmm.npz")
    tio.save_gmm_params(path2, p)
    back = jio.load_gmm_params(path2)
    for g, w in zip(back, jres.params):
        assert np.array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------------------------ k-means

def test_lloyd_step_from_shared_centres_matches_jax(rng):
    x = rng.standard_normal((300, 4))
    c = x[:5] + 0.01
    new, labels, counts = tk._lloyd_step(torch.as_tensor(x),
                                         torch.as_tensor(c))
    jlab = np.asarray(jnp.argmin(jk._sq_dists(jnp.asarray(x),
                                              jnp.asarray(c)), axis=-1))
    assert np.array_equal(labels.numpy(), jlab)
    onehot = np.eye(5)[jlab]
    want = onehot.T @ x / np.maximum(onehot.sum(0), 1.0)[:, None]
    np.testing.assert_allclose(new.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(counts.numpy(), onehot.sum(0))


def test_empty_cluster_relocates_to_farthest_point():
    x = torch.tensor([[0.0], [0.1], [5.0], [9.0]], dtype=torch.float64)
    centers = torch.tensor([[0.05], [100.0]], dtype=torch.float64)
    new, _, counts = tk._lloyd_step(x, centers)
    assert counts.tolist() == [4.0, 0.0]
    moved = tk._relocate_empty(x, new, counts)
    assert float(moved[1, 0]) == 9.0


def test_kmeanspp_seeding_distribution():
    """k-means++ picks the second centre with probability proportional to
    the squared distance to the first: the empirical marginal over 3000
    seedings matches the exact law to 0.03 (about 4 standard errors)."""
    x = torch.tensor([[0.0], [1.0], [2.0], [4.0], [8.0]], dtype=torch.float64)
    d2 = (x - x.T) ** 2
    expected = (d2 / d2.sum(1, keepdim=True)).mean(0).numpy()
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(5)
    for _ in range(3000):
        c = tk._kmeanspp_init(gen, x, 2)
        counts[[0, 1, 2, 4, 8].index(int(c[1, 0]))] += 1
    np.testing.assert_allclose(counts / 3000, expected, atol=0.03)


def test_kmeans_separates_clusters():
    rng = np.random.default_rng(2)
    centres = np.array([[0, 0], [10, 0], [0, 10]], dtype=np.float32)
    x = np.concatenate([c + rng.standard_normal((100, 2)) for c in centres])
    res = tk.kmeans(torch.Generator().manual_seed(1),
                    torch.as_tensor(x.astype(np.float32)), 3)
    labels = res.labels.numpy()
    for i in range(3):
        assert len(set(labels[100 * i:100 * (i + 1)])) == 1
    assert len(set(labels)) == 3
