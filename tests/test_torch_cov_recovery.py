"""The port's covariance recovery (`ops.gauss_newton`, `ops.cov_recovery`)
and `linalg.psd_project_polar` against the JAX package.

Every function gets the same numpy inputs in both packages: float64 agrees
to 1e-9 and float32 to 1e-5 of the output scale. The Gauss-Newton restarts
draw from a `torch.Generator` where JAX folds its key, so parity holds
where no scale iterate leaves [0.1, 10]; the inputs here keep them inside,
which each test asserts by solving again with another generator (a restart
would move the result). The restart branch is held by its invariants: in
range and converged. Then the counterparts of `tests/test_cov_recovery.py`
(1-bit refusal, tiny-mass clip, scale recovery, batched solve, recovery
from 3-bit samples beating the quantized sample covariance) and of
`tests/test_linalg.py` for the Newton-Schulz projection.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from quantized_channel_estimation_tpu.ops import cov_recovery as jcr
from quantized_channel_estimation_tpu.ops import gauss_newton as jgn
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.ops import cov_recovery as tcr
from quantized_channel_estimation_torch.ops import gauss_newton as tgn
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

TOL = {np.float64: 1e-9, np.float32: 1e-5}
CDT = {np.float64: np.complex128, np.float32: np.complex64}


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _erf_problems(rng, dt, shape=(6, 16)):
    """Scale problems whose iterates stay in [0.1, 10]: true scales in
    [0.5, 2], the occupancies of 2 x 3 thresholds (re and im) with a
    little noise, warm starts within 20% of the truth."""
    s_true = rng.uniform(0.5, 2.0, shape)
    tau = np.array([0.4, 0.8, 1.3, 0.4, 0.8, 1.3])
    probs = erf(tau / (math.sqrt(2.0) * s_true[..., None]))
    probs = np.clip(probs + rng.normal(0, 0.01, probs.shape), 0.01, 0.99)
    x0 = s_true * rng.uniform(0.8, 1.2, shape)
    return tau.astype(dt), probs.astype(dt), x0.astype(dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_solve_erf_scale_matches_jax(rng, dt):
    tau, probs, x0 = _erf_problems(rng, dt)
    want = jgn.solve_erf_scale(jnp.asarray(tau), jnp.asarray(probs),
                               jnp.asarray(x0), jax.random.PRNGKey(0))
    args = [torch.as_tensor(a) for a in (tau, probs, x0)]
    got = tgn.solve_erf_scale(*args, _gen(0))
    assert got.dtype == torch.float64 if dt is np.float64 \
        else got.dtype == torch.float32
    _close(got, want, TOL[dt])
    # no restart was taken: another restart stream gives the same bits
    assert torch.equal(got, tgn.solve_erf_scale(*args, _gen(1)))


@pytest.mark.parametrize("check_every", [3, 8, 200])
def test_convergence_check_interval_does_not_change_the_result(
        rng, monkeypatch, check_every):
    """Reading convergence on the host every few iterations freezes the
    same problems at the same iterates: the result is bit for bit that of
    the per-iteration check, and `max_iter` still caps the count."""
    tau, probs, x0 = (torch.as_tensor(a)
                      for a in _erf_problems(rng, np.float32))

    def solve(every, **kw):
        monkeypatch.setattr(tgn, "CHECK_EVERY", every)
        return tgn.solve_erf_scale(tau, probs, x0, _gen(), **kw)

    want = solve(1)
    assert torch.equal(solve(check_every), want)
    capped = [solve(c, max_iter=2) for c in (1, check_every)]
    assert torch.equal(capped[0], capped[1])
    assert not torch.equal(capped[0], want)


def test_restarts_land_in_range_and_converge():
    """Warm starts outside [0.1, 10] take the restart branch (its noise
    from the generator, where JAX folds its key): the result is in range
    and fits exact occupancies, for any restart stream."""
    tau = torch.tensor([0.3, 0.9, 0.3, 0.9], dtype=torch.float64)
    s_true = torch.tensor([[0.5, 1.0, 2.0], [0.7, 1.5, 3.0]],
                          dtype=torch.float64)
    probs = torch.erf(tau / (math.sqrt(2.0) * s_true[..., None]))
    x0 = torch.tensor([[0.01, 50.0, -3.0], [1e-3, 200.0, 0.05]],
                      dtype=torch.float64)
    for seed in (0, 1, 2):
        s = tgn.solve_erf_scale(tau, probs, x0, _gen(seed), tol=1e-10,
                                max_iter=200)
        assert torch.all((s >= 0.1) & (s <= 10.0))
        torch.testing.assert_close(s, s_true, rtol=1e-8, atol=0)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_cov_recovery_functions_match_jax(rng, dt):
    k, d, n = 3, 6, 400
    jqz = jq.design_quantizer(5.0, 3)
    q = tq.ScalarQuantizer(*(torch.as_tensor(np.asarray(v, dt))
                             for v in jqz))
    jqz = jq.ScalarQuantizer(*(jnp.asarray(np.asarray(v, dt)) for v in jqz))
    _close(tcr.positive_thresholds(q), jcr.positive_thresholds(jqz), 0)
    pos_tau = np.array(jcr.positive_thresholds(jqz))
    assert pos_tau.shape == (3,) and np.all(pos_tau > 0)

    x = (rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))) \
        * rng.uniform(0.4, 1.2, d)
    x = np.array(jq.quantize(jnp.asarray(x.astype(CDT[dt])), 3, jqz))
    x[0, 0] = 0.0   # sign(0) = 0 in both
    resp = rng.dirichlet(np.ones(k), size=n).astype(dt)
    xt, rt, tt = (torch.as_tensor(a) for a in (x, resp, pos_tau))
    _close(tcr.one_bit_requantize(xt),
           jcr.one_bit_requantize(jnp.asarray(x)), 0)
    corr = (rng.uniform(-1, 1, (k, d, d))
            + 1j * rng.uniform(-1, 1, (k, d, d))).astype(CDT[dt])
    _close(tcr.arcsine_correlation(torch.as_tensor(corr)),
           jcr.arcsine_correlation(jnp.asarray(corr)), TOL[dt])

    want = jcr.accumulate_quant_stats(jnp.asarray(x), jnp.asarray(resp),
                                      jnp.asarray(pos_tau))
    got = tcr.accumulate_quant_stats(xt, rt, tt)
    for g, w in zip(got, want):
        assert _np(g).dtype == np.asarray(w).dtype
        _close(g, w, TOL[dt])
    # summed chunk by chunk, the statistics are the same
    halves = [tcr.accumulate_quant_stats(xt[s], rt[s], tt)
              for s in (slice(0, 150), slice(150, n))]
    for g, a, b in zip(got, *halves):
        _close(a + b, g, TOL[dt])

    x0 = rng.uniform(0.8, 1.5, (k, d)).astype(dt)
    want_v = jcr.recover_variances(want.nk, want.below, jnp.asarray(pos_tau),
                                   jnp.asarray(x0), jax.random.PRNGKey(1))
    got_v = tcr.recover_variances(got.nk, got.below, tt,
                                  torch.as_tensor(x0), _gen())
    _close(got_v, want_v, TOL[dt])
    assert torch.equal(got_v, tcr.recover_variances(
        got.nk, got.below, tt, torch.as_tensor(x0), _gen(1)))
    want_c = jcr.recover_covariance(want, jnp.asarray(pos_tau),
                                    jnp.asarray(x0), jax.random.PRNGKey(1))
    _close(tcr.recover_covariance(got, tt, torch.as_tensor(x0), _gen()),
           want_c, TOL[dt])


def test_weighted_gram_is_the_weighted_outer_product_sum(rng, monkeypatch):
    """The statistics' one real GEMM, in row slices smaller than the
    chunk, equals sum_n r_nk x_n x_n^H (float64, 1e-12)."""
    n, d, k = 257, 5, 4
    x = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    resp = rng.dirichlet(np.ones(k), size=n)
    want = np.einsum("nk,nd,ne->kde", resp, x, x.conj())
    monkeypatch.setattr(tcr, "_GRAM_SLICE_ELEMS", 3 * d * d)
    got = tcr.weighted_gram(torch.as_tensor(resp), torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_psd_project_polar_matches_jax(rng, dt):
    k, d = 4, 12
    a = (rng.standard_normal((k, d, d))
         + 1j * rng.standard_normal((k, d, d))).astype(CDT[dt])
    h = (a @ a.conj().transpose(0, 2, 1) / d - 0.3 * np.eye(d)).astype(
        CDT[dt])
    for floor in (0.0, 1e-5):
        _close(tl.psd_project_polar(torch.as_tensor(h), floor),
               jl.psd_project_polar(jnp.asarray(h), floor), TOL[dt])


def test_psd_project_polar_matches_eigh_and_keeps_its_floor(rng):
    """Against the eigh clip `psd_project` (relative Frobenius error
    < 1e-4, float32) and the floor on near-zero negative spectra (the
    slow-convergence regime of the sign iteration), as the JAX tests hold
    their projection."""
    k, d = 8, 32
    a = ((rng.standard_normal((k, d, d))
          + 1j * rng.standard_normal((k, d, d))) / math.sqrt(2))
    h = tl.hermitize(torch.as_tensor(
        (a @ a.conj().transpose(0, 2, 1) / d - 0.3 * np.eye(d)).astype(
            np.complex64)))
    for floor in (0.0, 1e-5):
        want = tl.psd_project(h, floor)
        got = tl.psd_project_polar(h, floor)
        rel = (torch.linalg.matrix_norm(got - want)
               / torch.linalg.matrix_norm(want)).max()
        assert float(rel) < 1e-4
        assert float(torch.linalg.eigvalsh(got).min()) >= floor - 1e-5
    d, floor = 64, 1e-5
    qmat, _ = np.linalg.qr(rng.standard_normal((d, d))
                           + 1j * rng.standard_normal((d, d)))
    for negscale in (1e-3, 1e-5, 1e-7):
        lam = np.ones(d)
        lam[:8] = -negscale * d
        h = ((qmat * lam[None, :]) @ qmat.conj().T).astype(np.complex64)
        got = tl.psd_project_polar(tl.hermitize(torch.as_tensor(h))[None],
                                   floor)
        assert float(torch.linalg.eigvalsh(got).min()) >= floor - 1e-7


def test_one_bit_recovery_raises(rng):
    """A 1-bit quantizer has no interior thresholds: the scale fit would
    return its warm start, so the standalone recovery refuses."""
    q = tq.design_quantizer(5.0, 1)
    r = torch.as_tensor((rng.standard_normal((64, 4))
                         + 1j * rng.standard_normal((64, 4))).astype(
                             np.complex64))
    with pytest.raises(ValueError, match="n_bits >= 2"):
        tcr.recover_covariance_from_samples(r, q, _gen())


def test_occupancy_clip_stays_ordered_for_tiny_mass():
    """For a component mass 1 < Nk < 2 the bounds [1/Nk, (Nk-1)/Nk]
    invert; the clip stays defined (finite output) and matches JAX's."""
    q = tq.design_quantizer(5.0, 2)
    pos_tau = tcr.positive_thresholds(q)
    r = torch.tensor([[0.1 + 0.1j, 1.0 + 1.0j]] * 3, dtype=torch.complex64)
    resp = torch.full((3, 1), 0.5)
    stats = tcr.accumulate_quant_stats(r, resp, pos_tau)
    x0 = torch.ones((1, 2))
    cov = tcr.recover_covariance(stats, pos_tau, x0, _gen())
    assert torch.isfinite(torch.view_as_real(cov)).all()
    jqz = jq.design_quantizer(5.0, 2)
    jpos = jcr.positive_thresholds(jqz)
    want = jcr.recover_covariance(
        jcr.accumulate_quant_stats(jnp.asarray(r.numpy()),
                                   jnp.asarray(resp.numpy()), jpos),
        jpos, jnp.ones((1, 2), jnp.float32), jax.random.PRNGKey(0))
    _close(cov, want, 1e-5)


def test_gauss_newton_recovers_scale():
    """Exact probabilities: the recovered scale is the true scale."""
    tau = torch.tensor([0.4, 0.8, 1.3])
    for s_true in (0.5, 1.0, 2.0):
        probs = torch.erf(tau / (math.sqrt(2) * s_true))
        s = tgn.solve_erf_scale(torch.cat([tau, tau]),
                                torch.cat([probs, probs])[None],
                                torch.tensor([1.0]), _gen())
        assert abs(float(s[0]) - s_true) < 1e-4


def test_gauss_newton_batched(rng):
    s_true = torch.as_tensor(rng.uniform(0.5, 2.0, (8, 16)),
                             dtype=torch.float32)
    tau = torch.tensor([0.3, 0.9])
    probs = torch.erf(tau / (math.sqrt(2) * s_true[..., None]))
    s = tgn.solve_erf_scale(tau, probs, torch.ones_like(s_true), _gen())
    torch.testing.assert_close(s, s_true, rtol=0, atol=1e-3)


def test_recover_covariance_from_samples(rng):
    """A known covariance recovered from 3-bit quantized samples (the Fig. 2
    scheme) beats the naive quantized sample covariance, as the JAX test
    asserts, and agrees with JAX's recovery of the same samples."""
    d, n = 16, 100_000
    a = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    cov = a @ a.conj().T / d + 1.5 * np.eye(d)
    scale = np.real(np.trace(cov)) / d
    snr_eq = 10 * np.log10(1 / (scale - 1)) if scale > 1 else 10.0
    w = math.sqrt(0.5) * (rng.standard_normal((n, d))
                          + 1j * rng.standard_normal((n, d)))
    x = (w @ np.linalg.cholesky(cov).T).astype(np.complex64)
    q = tq.design_uniform(snr_eq, 3)
    r = tq.quantize(torch.as_tensor(x), 3, q)
    c_rec = _np(tcr.recover_covariance_from_samples(r, q, _gen()))
    nmse_rec = np.sum(np.abs(c_rec - cov) ** 2) / np.sum(np.abs(cov) ** 2)
    r_np = _np(r)
    c_naive = r_np.T @ r_np.conj() / n
    nmse_naive = np.sum(np.abs(c_naive - cov) ** 2) / np.sum(
        np.abs(cov) ** 2)
    assert nmse_rec < nmse_naive and nmse_rec < 0.05
    jqz = jq.design_uniform(snr_eq, 3)
    want = jcr.recover_covariance_from_samples(
        jq.quantize(jnp.asarray(x), 3, jqz), jqz, jax.random.PRNGKey(0))
    _close(c_rec, want, 1e-5)
