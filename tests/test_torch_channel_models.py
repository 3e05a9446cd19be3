"""The other channel models of the port (urban-macro and Kronecker MIMO)
against the JAX package.

The random streams cannot match (threefry against Philox), so each
generator's deterministic transform is held on the JAX package's own
draws, rebuilt here with `jax.random` in the JAX generator's key order,
to 1e-5 of the scale; the port's samplers are held by their statistics,
as the JAX package's `tests/test_scm.py` holds its own.

The MIMO coloring factor is a Cholesky factor of a truncated Toeplitz
matrix, numerically rank-deficient at the default 2-degree base-station
spread. Two LAPACK builds factor such a matrix to the same L L^H but not
to the same L (the factorization is backward stable, not forward stable
there), and may pick another rung of the jitter ladder: the factor is
held as L L^H against the jittered covariance, and the channels bit for
bit at a spread whose matrices are well conditioned.

The harness rows of `run_gmm` on urban-macro channels and of
`run_gmm_quant` on MIMO channels are held on shared data with the helpers
of tests/test_torch_harness.py (whose pinned item-14 cases hold the
others).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import blmmse as jb
from quantized_channel_estimation_tpu.harness import stages as jst
from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as js
from quantized_channel_estimation_tpu.ops import scm_mimo as jm
from quantized_channel_estimation_torch.estimators import blmmse as tb
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.ops import scm as ts
from quantized_channel_estimation_torch.ops import scm_mimo as tm

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_harness as th  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5          # of the scale (max |want|)
LADDER = (0.0, 1e-6, 1e-4, 1e-2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _scale_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _owns_storage(x: torch.Tensor) -> bool:
    return x.untyped_storage().nbytes() == x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# linalg.robust_chol_lower
# ---------------------------------------------------------------------------

def _toeplitz_stack(sigma, n, b=64, seed=0):
    """(b, n, n) complex64 Toeplitz covariances of 2-path Laplace PSDs at
    the angular spread `sigma` (degrees)."""
    rng = np.random.default_rng(seed)
    gains = rng.uniform(size=(b, 2))
    gains /= gains.sum(-1, keepdims=True)
    fs = js.sample_psd(jnp.asarray((rng.uniform(size=(b, 2)) - 0.5) * 180),
                       jnp.asarray(gains), n, sigma)
    t = jnp.fft.fft(fs.astype(jnp.complex64), axis=-1)[..., :n] / fs.shape[-1]
    return np.asarray(jl.toeplitz_from_first_row(t).astype(jnp.complex64))


def _jitters(c):
    d = np.real(np.diagonal(c, axis1=-2, axis2=-1)).mean(-1)
    return [s * d[:, None, None] * np.eye(c.shape[-1]) for s in LADDER]


def _rungs(c, factor_fails):
    """The ladder rung each matrix is factored at: the first jitter at
    which `factor_fails` (a (B,) bool of the plain Cholesky) is False."""
    fails = np.stack([factor_fails(c + j) for j in _jitters(c)[:-1]]
                     + [np.zeros(len(c), bool)])
    return np.argmin(fails, axis=0)


def _jax_fails(c):
    return np.asarray(jnp.isnan(jnp.linalg.cholesky(jnp.asarray(c))).any(
        (-2, -1)))


def _torch_fails(c):
    return (torch.linalg.cholesky_ex(torch.as_tensor(c))[1] != 0).numpy()


@pytest.mark.parametrize("sigma", [35.0, 2.0])
def test_robust_chol_lower_matches_jax(sigma):
    """At 35 degrees every matrix factors at rung 0 in both packages and
    the factors agree to 1e-5 of scale; at 2 degrees (16 antennas, min
    eigenvalue ~1e-7 of the diagonal) the ladder engages: each package's
    factor, lower triangular, colors the covariance jittered at the rung
    it chose (L L^H to 1e-5 relative), and the packages choose the same
    rung for most matrices."""
    c = _toeplitz_stack(sigma, 16)
    l_t = tl.robust_chol_lower(torch.as_tensor(c)).numpy()
    l_j = np.asarray(jl.robust_chol_lower(jnp.asarray(c)))
    rung_t, rung_j = _rungs(c, _torch_fails), _rungs(c, _jax_fails)
    jit = _jitters(c)
    for l, rung in ((l_t, rung_t), (l_j, rung_j)):
        assert np.all(np.isfinite(l)) and np.all(np.triu(l, 1) == 0)
        c_jit = c + np.take_along_axis(np.stack(jit, 1),
                                       rung[:, None, None, None], 1)[:, 0]
        llh = l @ np.conj(np.swapaxes(l, -1, -2))
        rel = (np.linalg.norm(llh - c_jit, axis=(-2, -1))
               / np.linalg.norm(c_jit, axis=(-2, -1)))
        assert rel.max() < TOL, rel.max()
    if sigma > 10:
        assert not rung_t.any() and not rung_j.any()
        assert _scale_err(l_t, l_j) < TOL
        # the precision ladder shares the code
        p_j = jl.robust_precision_cholesky(jnp.asarray(c))
        assert _scale_err(tl.robust_precision_cholesky(torch.as_tensor(c)),
                          p_j) < TOL
    else:
        assert rung_t.any() and (rung_t <= 1).all()
        assert np.mean(rung_t == rung_j) >= 0.9


# ---------------------------------------------------------------------------
# the generators' transforms on JAX's draws
# ---------------------------------------------------------------------------

def _macro_draws(key, b, cfg):
    """The draws of `scm.generate_channels_urban_macro(key, b, cfg)`."""
    kt, kd, ke, kz, ka, ko, kx, kr = jax.random.split(key, 8)
    p = cfg.n_paths
    return ts.UrbanMacroDraws(*(_t(v) for v in (
        jax.random.uniform(kt, (b,)), jax.random.normal(kd, (b,)),
        jax.random.exponential(ke, (b, p)), jax.random.normal(kz, (b, p)),
        jax.random.normal(ka, (b,)), jax.random.normal(ko, (b, p)),
        jc.crandn(kx, (b, cfg.n_coherence, 100 * cfg.n_antennas),
                  jnp.complex64),
        jax.random.uniform(kr, (b,)))))


@pytest.mark.parametrize("n_coherence,n_paths", [(1, 6), (2, 3)])
def test_urban_macro_matches_jax_on_jax_draws(n_coherence, n_paths):
    """The sorted delays, magnitude-ordered AoDs, PSD synthesis and path
    loss of the port on JAX's draws give JAX's channels and genie rows to
    1e-5 of scale; the outputs own their storage (fault F3)."""
    key = jax.random.PRNGKey(7)
    jcfg = js.UrbanMacroConfig(n_antennas=8, n_paths=n_paths,
                               n_coherence=n_coherence)
    h_j, t_j = js.generate_channels_urban_macro(key, 64, jcfg)
    h_t, t_t = ts.generate_channels_urban_macro_from_draws(
        _macro_draws(key, 64, jcfg), ts.UrbanMacroConfig(**jcfg._asdict()))
    assert h_t.dtype == t_t.dtype == torch.complex64
    assert _scale_err(h_t, h_j) < TOL and _scale_err(t_t, t_j) < TOL
    assert _owns_storage(t_t) and _owns_storage(h_t)


def _mimo_draws(key, b, cfg):
    """The draws of `scm_mimo.generate_channels_mimo(key, b, cfg)`."""
    kg, kb, km, kx = jax.random.split(key, 4)
    shape = (b, cfg.n_path)
    return tm.MimoDraws(*(_t(v) for v in (
        jax.random.uniform(kg, shape), jax.random.uniform(kb, shape),
        jax.random.uniform(km, shape),
        jc.crandn(kx, (b, cfg.n_coherence, cfg.n_antennas_bs,
                       cfg.n_antennas_ms), jnp.complex64))))


@pytest.mark.parametrize("n_coherence", [1, 2])
def test_mimo_matches_jax_on_jax_draws(n_coherence):
    """`genie_toeplitz_rows` and `color_kron` of the port on JAX's draws,
    at a base-station spread whose matrices factor at rung 0 in both
    packages (35 degrees): JAX's rows and channels to 1e-5 of scale, the
    rows owning their storage; `color_kron` alone on JAX's noise too."""
    key = jax.random.PRNGKey(5)
    jcfg = jm.ScmMimoConfig(8, 4, n_path=2, path_sigma_bs=35.0,
                            n_coherence=n_coherence)
    h_j, tb_j, tm_j = jm.generate_channels_mimo(key, 64, jcfg)
    h_t, tb_t, tm_t = tm.generate_channels_mimo_from_draws(
        _mimo_draws(key, 64, jcfg), tm.ScmMimoConfig(**jcfg._asdict()))
    assert h_t.shape == ((64, 32) if n_coherence == 1 else (64, 2, 32))
    assert _scale_err(tb_t, tb_j) < TOL and _scale_err(tm_t, tm_j) < TOL
    assert _scale_err(h_t, h_j) < TOL
    assert _owns_storage(tb_t) and _owns_storage(tm_t)
    k2 = jax.random.PRNGKey(9)
    want = jm.color_kron(k2, tb_j, tm_j, 3)
    x = jc.crandn(k2, (64, 3, 8, 4), jnp.complex64)
    got = tm.color_kron_from_noise(tb_t, tm_t, _t(x))
    assert _scale_err(got, want) < TOL


def test_mimo_layout_is_the_dense_kron_at_the_default_spread():
    """At the default 2-degree spread (where the factors differ between
    LAPACK builds): each channel is kron(L_MS, L_BS) vec(X) of the port's
    own factors, the dense product in the reference's layout i_ms * N_BS +
    i_bs."""
    key = jax.random.PRNGKey(5)
    jcfg = jm.ScmMimoConfig(8, 4, n_path=2, n_coherence=2)
    d = _mimo_draws(key, 16, jcfg)
    h, t_bs, t_ms = tm.generate_channels_mimo_from_draws(
        d, tm.ScmMimoConfig(**jcfg._asdict()))
    l_bs, l_ms = (x.numpy() for x in tm.coloring_factors(t_bs, t_ms))
    x = d.x.numpy()
    for b in range(16):
        for c in range(2):
            want = np.kron(l_ms[b], l_bs[b]) @ x[b, c].T.reshape(-1)
            np.testing.assert_allclose(h[b, c].numpy(), want, rtol=0,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# the kron genie, repeat_blocks and chunked_genie_nmse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits", [1, 2])
def test_estimate_genie_kron_matches_jax(n_bits):
    """Per-sample kron(toeplitz(t_ms), toeplitz(t_bs)) genie BLMMSE: JAX's
    estimate to 1e-5 of scale, and the port's dense-covariance genie on
    np.kron of the same rows."""
    key = jax.random.PRNGKey(2)
    cfg = jm.ScmMimoConfig(4, 4, n_path=2)
    h, tb_j, tm_j = jm.generate_channels_mimo(key, 40, cfg)
    snr = 5.0
    a_j = jp.pilot_matrix(16, 1, n_bits, "angle_amp")
    q_j = jq.design_quantizer(snr, n_bits)
    r = np.asarray(jc.crandn(jax.random.PRNGKey(3), (40, 16), jnp.complex64))
    want = jb.estimate_genie_kron(jnp.asarray(r), tb_j, tm_j, snr, a_j,
                                  n_bits, q_j)
    a_t = tp.pilot_matrix(16, 1, n_bits, "angle_amp", device="cpu")
    q_t = tq.design_quantizer(snr, n_bits)
    got = tb.estimate_genie_kron(_t(r), _t(tb_j), _t(tm_j), snr, a_t,
                                 n_bits, q_t)
    assert got.dtype == torch.complex64
    assert _scale_err(got, want) < TOL
    c = np.stack([np.kron(np.asarray(jl.toeplitz_from_first_row(m)),
                          np.asarray(jl.toeplitz_from_first_row(s)))
                  for m, s in zip(np.asarray(tm_j), np.asarray(tb_j))])
    dense = tb.estimate_genie_cov(_t(r), torch.as_tensor(c), snr, a_t,
                                  n_bits, q_t)
    assert _scale_err(got, dense) < TOL


def test_repeat_blocks_matches_jax():
    rng = np.random.default_rng(4)
    t = (rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3))
         ).astype(np.complex64)
    want = jst.to_numpy(jst.repeat_blocks(jst.from_numpy(t), 3))
    got = tst.repeat_blocks(torch.as_tensor(t), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (15, 3)


def test_chunked_genie_nmse_is_the_unchunked_nmse():
    """Chunks of 3 rows (a 512-byte stack limit at D = 8): the weighted
    chunk NMSEs equal one genie NMSE over the set (rtol 1e-6) and JAX's
    chunked value (rtol 1e-4)."""
    key = jax.random.PRNGKey(1)
    h_j, t_j = js.generate_channels(key, 20, js.ScmConfig(8, 2))
    a_j = jp.pilot_matrix(8, 1, 2, "angle_amp")
    q_j = jq.design_quantizer(0.0, 2)
    r = np.asarray(jst.to_numpy(jst.observe(
        jax.random.PRNGKey(2), jst.from_numpy(np.asarray(h_j)), 0.0,
        jst.from_numpy(np.asarray(a_j)), 2, q_j)))
    h, t = _t(h_j), _t(t_j)
    a = tp.pilot_matrix(8, 1, 2, "angle_amp", device="cpu")
    q = tq.design_quantizer(0.0, 2)
    chunked = tst.chunked_genie_nmse(_t(r), t, h, 0.0, a, 2, q,
                                     max_bytes=8 * 8 * 8 * 3)
    whole = tst.nmse(tst.blmmse_genie(_t(r), t, 0.0, a, 2, q), h)
    np.testing.assert_allclose(chunked, whole, rtol=1e-6)
    want = jst.chunked_genie_nmse(
        jst.from_numpy(r), jst.from_numpy(np.asarray(t_j)),
        jst.from_numpy(np.asarray(h_j)), 0.0,
        jst.from_numpy(np.asarray(a_j)), 2, q_j, max_bytes=8 * 8 * 8 * 3)
    np.testing.assert_allclose(chunked, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# the samplers in law
# ---------------------------------------------------------------------------

def test_mimo_sampler_in_law():
    """The port's MIMO draws: unit power per entry and unit genie
    diagonals at both ends; coherence draws of one sample have the dense
    np.kron(C_MS, C_BS) as covariance (atol 0.12, as the JAX test); the
    chunked generator keeps the shapes."""
    gen = torch.Generator().manual_seed(0)
    h, t_bs, t_ms = tm.generate_channels_mimo(
        gen, 1500, tm.ScmMimoConfig(8, 4, n_path=2))
    assert h.shape == (1500, 32) and t_bs.shape == (1500, 8)
    np.testing.assert_allclose(t_bs[:, 0].real.numpy(), 1.0, atol=1e-3)
    np.testing.assert_allclose(t_ms[:, 0].real.numpy(), 1.0, atol=1e-3)
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.1
    h, t_bs, t_ms = tm.generate_channels_mimo(
        gen, 2, tm.ScmMimoConfig(4, 3, n_path=1, n_coherence=8000))
    for b in range(2):
        c_true = np.kron(tl.toeplitz_from_first_row(t_ms[b]).numpy(),
                         tl.toeplitz_from_first_row(t_bs[b]).numpy())
        emp = (h[b].T @ h[b].conj()).numpy() / h.shape[1]
        np.testing.assert_allclose(emp, c_true, atol=0.12)
    h, t_bs, t_ms = tm.generate_channels_mimo_chunked(
        gen, 700, tm.ScmMimoConfig(4, 2, n_path=2), chunk=256)
    assert h.shape == (700, 8) and t_bs.shape == (700, 4) \
        and t_ms.shape == (700, 2)


def test_urban_macro_sampler_in_law():
    """The port's urban-macro draws: the per-antenna power beta in the
    path-loss range [1, 1.5^3.5], the genie rows real at lag 0, per-sample
    power over coherence draws tracking the genie diagonal (rtol 0.08, as
    the JAX test), and the chunked generators' shapes."""
    gen = torch.Generator().manual_seed(1)
    cfg = ts.UrbanMacroConfig(n_antennas=8)
    h, t = ts.generate_channels_urban_macro(gen, 3000, cfg)
    assert h.shape == (3000, 8) and t.shape == (3000, 8)
    t0 = t[:, 0].numpy()
    np.testing.assert_allclose(t0.imag, 0.0, atol=1e-3)
    beta_max = (cfg.max_dist / cfg.min_dist) ** (cfg.eps_pl / 10.0)
    assert np.all(t0.real > 1.0 - 1e-3) and np.all(t0.real < beta_max + 1e-3)
    assert t0.real.max() > 0.8 * beta_max and t0.real.min() < 1.2
    h, t = ts.generate_channels_urban_macro(
        gen, 4, ts.UrbanMacroConfig(n_antennas=6, n_coherence=4000))
    np.testing.assert_allclose((h.abs() ** 2).mean((1, 2)).numpy(),
                               t[:, 0].real.numpy(), rtol=0.08)
    h, t = tst.generate_channels_macro(gen, 1000, cfg, chunk=256)
    assert h.shape == (1000, 8) and t.shape == (1000, 8)
    h, t = ts.generate_channels_chunked(gen, 1000, ts.ScmConfig(8, 2),
                                        chunk=256)
    assert h.shape == (1000, 8) and t.shape == (1000, 8)


# ---------------------------------------------------------------------------
# the harnesses on shared data
# ---------------------------------------------------------------------------

def test_run_gmm_urban_macro_matches_jax_on_shared_cache(tmp_path,
                                                         monkeypatch):
    """`run_gmm` on urban-macro channels, both harnesses on one cache and
    the JAX observations: the same CSV names and columns, every row to
    rtol 1e-4 (`test_torch_harness._channel_model_runs_match_jax`)."""
    th._channel_model_runs_match_jax(tmp_path, monkeypatch,
                                     channel_model="urban-macro")


def test_run_gmm_quant_mimo_matches_jax_on_shared_cache(tmp_path,
                                                        monkeypatch):
    """`run_gmm_quant` on Kronecker-MIMO channels (8 x 2 antennas), both
    harnesses on one cache with the JAX observations and fit carried
    across: rows to rtol 1e-4
    (`test_torch_harness._run_gmm_quant_matches_jax`)."""
    th._run_gmm_quant_matches_jax(tmp_path, monkeypatch, 1, "full",
                                  channel_model="mimo", n_antennas=8,
                                  n_antennas_ms=2, n_path=2)
