"""Parity of the port's ops (cplx, linalg, quantizer, bussgang, pilots,
observation) with the JAX package, on the same numpy inputs.

Tolerances: float64 functions agree to rtol 1e-10 (the two frameworks sum
and evaluate transcendentals in different orders; 1e-10 leaves five orders
of magnitude above f64 rounding and far below any algorithmic change).
Quantizer labels are compared bit for bit. The Lloyd-Max design iterates
in float32 in both packages with different erf/linspace implementations
and stops once its edges move less than 1e-5, so the tables agree to that
stopping tolerance (atol 1e-4).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.ops import bussgang as jb
from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import observation as jo
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.ops import bussgang as tb
from quantized_channel_estimation_torch.ops import cplx as tc
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import observation as to
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

RTOL = 1e-10


def _crand(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        / np.sqrt(2)


def _psd(rng, k, d):
    a = _crand(rng, (k, d, d))
    return a @ np.conj(np.swapaxes(a, -1, -2)) / d + 0.1 * np.eye(d)


def _close(got, want, rtol=RTOL, atol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.resolve_conj().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                               atol=atol)


def _tq(q):
    """JAX ScalarQuantizer -> port ScalarQuantizer (same tables)."""
    return tq.ScalarQuantizer(*(torch.as_tensor(np.asarray(x)) for x in q))


# --------------------------------------------------------------------- cplx

def test_cplx_roundtrip_matches_jax(rng):
    x = _crand(rng, (5, 7))
    _close(tc.cplx2real(torch.as_tensor(x)), jc.cplx2real(jnp.asarray(x)))
    r = rng.standard_normal((5, 8))
    _close(tc.real2cplx(torch.as_tensor(r)), jc.real2cplx(jnp.asarray(r)))
    _close(tc.cplx2real(torch.as_tensor(x), dim=0),
           jc.cplx2real(jnp.asarray(x), axis=0))


def test_crandn_statistics():
    """Different streams from JAX: held by its moments (N = 40000, the
    tolerances are > 5 standard errors)."""
    gen = torch.Generator().manual_seed(0)
    x = tc.crandn(gen, (40000,), dtype=torch.complex128)
    assert x.dtype == torch.complex128
    assert abs(float((x.abs() ** 2).mean()) - 1.0) < 0.04
    assert abs(complex(x.mean())) < 0.03
    assert abs(float((x.real ** 2).mean()) - 0.5) < 0.03
    assert abs(complex((x * x).mean())) < 0.03   # circular symmetry


# ------------------------------------------------------------------- linalg

def test_toeplitz_and_dft_match_jax(rng):
    t = _crand(rng, (3, 6))
    _close(tl.toeplitz_from_first_row(torch.as_tensor(t)),
           jl.toeplitz_from_first_row(jnp.asarray(t)))
    _close(tl.unitary_dft(8, torch.complex128),
           jl.unitary_dft(8, jnp.complex128), atol=1e-14)


def test_cholesky_family_matches_jax(rng):
    c = _psd(rng, 4, 6)
    ct, cj = torch.as_tensor(c), jnp.asarray(c)
    _close(tl.add_jitter(ct, 1e-3), jl.add_jitter(cj, 1e-3))
    _close(tl.chol_lower(ct), jl.chol_lower(cj))
    lt = tl.chol_lower(ct)
    _close(tl.prec_from_chol(lt),
           jl.prec_from_chol(jnp.asarray(lt.resolve_conj().numpy())))
    _close(tl.robust_precision_cholesky(ct),
           jl.robust_precision_cholesky(cj))
    p = tl.robust_precision_cholesky(ct)
    _close(tl.logdet_from_prec_chol(p),
           jl.logdet_from_prec_chol(jnp.asarray(p.resolve_conj().numpy())))
    _close(tl.hermitize(ct + 0.1j), jl.hermitize(cj + 0.1j))


def test_robust_precision_cholesky_ladder_matches_jax(rng):
    """A rank-deficient matrix fails the plain factorization; both packages
    take the same rung of the jitter ladder."""
    v = _crand(rng, (2, 6, 2))
    c = v @ np.conj(np.swapaxes(v, -1, -2))       # rank 2
    c[1] = c[1] - 1e-3 * np.eye(6)                 # indefinite
    got = tl.robust_precision_cholesky(torch.as_tensor(c))
    assert torch.isfinite(got).all()
    _close(got, jl.robust_precision_cholesky(jnp.asarray(c)))


def test_solves_match_jax(rng):
    c = _psd(rng, 3, 5)
    b_vec = _crand(rng, (3, 5))
    b_mat = _crand(rng, (3, 5, 4))
    ct, cj = torch.as_tensor(c), jnp.asarray(c)
    _close(tl.cho_solve_hermitian(ct, torch.as_tensor(b_vec), 1e-6),
           jl.cho_solve_hermitian(cj, jnp.asarray(b_vec), 1e-6))
    _close(tl.cho_solve_hermitian(ct, torch.as_tensor(b_mat)),
           jl.cho_solve_hermitian(cj, jnp.asarray(b_mat)))
    _close(tl.hermitian_inv(ct), jl.hermitian_inv(cj))
    # one shared matrix against a batch of right-hand sides
    _close(tl.cho_solve_hermitian(ct[0], torch.as_tensor(b_mat[0])),
           jl.cho_solve_hermitian(cj[0], jnp.asarray(b_mat[0])))


def test_psd_pinv_matches_jax(rng):
    v = _crand(rng, (2, 6, 3))
    c = v @ np.conj(np.swapaxes(v, -1, -2))       # rank 3: pinv truncates
    _close(tl.psd_pinv(torch.as_tensor(c), 1e-8),
           jl.psd_pinv(jnp.asarray(c), 1e-8), atol=1e-10)


# ---------------------------------------------------------------- quantizer

@pytest.mark.parametrize("n_bits", [1, 2, 3, 4])
@pytest.mark.parametrize("snr", [-10.0, 0.0, 20.0])
def test_uniform_design_is_bit_exact(n_bits, snr):
    got = tq.design_uniform(snr, n_bits)
    want = jq.design_uniform(snr, n_bits)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert tq.uniform_step(snr, n_bits) == pytest.approx(
        float(jq.uniform_step(snr, n_bits)), rel=1e-15)
    assert tq.standard_quantization_step(n_bits) == \
        jq.standard_quantization_step(n_bits)


@pytest.mark.parametrize("n_bits", [2, 3, 4])
def test_lloyd_design_matches_jax(n_bits):
    got = tq.design_lloyd(5.0, n_bits)
    want = jq.design_lloyd(5.0, n_bits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_lloyd_mixture_distortion_is_weighted():
    """Deliberate deviation (ROADMAP Queue 3): for a mixture of variances
    the port weights each component's own distortion, while the JAX design
    multiplies every weight into the sum over all components."""
    var, w = [0.3, 2.0], [0.25, 0.75]
    edges, cents, rho = tq.lloyd_max_positive_half(2, var, w)
    a, b = edges[:-1], edges[1:]
    one = torch.ones(1)
    per = [tq._cell_distortion(a, b, cents, torch.tensor([v]).sqrt(), one)
           for v in var]
    assert float(rho) == pytest.approx(w[0] * float(per[0])
                                       + w[1] * float(per[1]), rel=1e-6)
    _, _, rho_j = jq.lloyd_max_positive_half(2, jnp.asarray(var),
                                             jnp.asarray(w, jnp.float32))
    assert float(rho_j) == pytest.approx(float(per[0]) + float(per[1]),
                                         rel=1e-4)


@pytest.mark.parametrize("n_bits", [1, 2, 3, 4])
@pytest.mark.parametrize("qtype", ["uniform", "lloyd"])
def test_quantize_labels_bit_exact(rng, n_bits, qtype):
    """Same input and same tables -> identical labels, including inputs
    exactly on a threshold (right-closed cells) and exact zeros."""
    qj = jq.design_quantizer(3.0, n_bits, qtype)
    qt = _tq(qj)
    x = 1.3 * _crand(rng, (64, 16))
    thr = np.asarray(qj.thresholds, dtype=np.float64)
    x[0, :len(thr)] = thr + 1j * thr[::-1]
    x[1, :3] = [0.0, 1j * 0.0, 0.5]
    got = tq.quantize(torch.as_tensor(x), n_bits, qt).numpy()
    want = np.asarray(jq.quantize(jnp.asarray(x), n_bits, qj))
    assert np.array_equal(got, want)
    x32 = x.astype(np.complex64)
    got32 = tq.quantize(torch.as_tensor(x32), n_bits, qt).numpy()
    assert np.array_equal(got32,
                          np.asarray(jq.quantize(jnp.asarray(x32), n_bits,
                                                 qj)))


def test_quantize_with_own_uniform_tables_is_bit_exact(rng):
    x = _crand(rng, (200, 4)).astype(np.complex64)
    for n_bits in (2, 3):
        got = tq.quantize(torch.as_tensor(x), n_bits,
                          tq.design_quantizer(0.0, n_bits))
        want = jq.quantize(jnp.asarray(x), n_bits,
                           jq.design_quantizer(0.0, n_bits))
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert tq.design_quantizer(0.0, math.inf) is None
    assert tq.quantize(torch.as_tensor(x), math.inf, None) is not None


# ----------------------------------------------------------------- bussgang

@pytest.mark.parametrize("n_bits", [1, 2, 3, math.inf])
def test_bussgang_gains_and_covs_match_jax(rng, n_bits):
    cy = _psd(rng, 3, 5) + 0.2 * np.eye(5)
    qj = jq.design_quantizer(0.0, n_bits)
    qt = None if qj is None else _tq(qj)
    ct, cj = torch.as_tensor(cy), jnp.asarray(cy)
    diag = np.real(np.diagonal(cy, axis1=-2, axis2=-1))
    _close(tb.bussgang_gain_diag(torch.as_tensor(diag), n_bits, qt),
           jb.bussgang_gain_diag(jnp.asarray(diag), n_bits, qj))
    _close(tb.bussgang_gain_matrix(ct, n_bits, qt),
           jb.bussgang_gain_matrix(cj, n_bits, qj))
    for beta in ("mean", "first"):
        _close(tb.quantized_cov(ct, n_bits, qt, beta),
               jb.quantized_cov(cj, n_bits, qj, beta))
        _close(tb.blmmse_quantized_cov(ct, n_bits, qt, beta),
               jb.blmmse_quantized_cov(cj, n_bits, qj, beta))
    for exact in (False, True):
        g_t, cr_t = tb.bank_gains_and_cov(ct, n_bits, qt, exact)
        g_j, cr_j = jb.bank_gains_and_cov(cj, n_bits, qj, exact)
        _close(g_t, g_j)
        _close(cr_t, cr_j)


def test_quantized_variance_and_arcsine_match_jax(rng):
    q = jq.design_quantizer(5.0, 3)
    s2 = rng.uniform(0.2, 3.0, (4, 6))
    _close(tb.quantized_variance(torch.as_tensor(s2), _tq(q)),
           jb.quantized_variance(jnp.asarray(s2), q))
    cy = _psd(rng, 2, 5)
    _close(tb.arcsine_cov(torch.as_tensor(cy)),
           jb.arcsine_cov(jnp.asarray(cy)))
    with pytest.raises(ValueError):
        tb.quantized_cov(torch.as_tensor(cy), 2, _tq(q), beta="bad")


# ------------------------------------------------------ pilots, observation

@pytest.mark.parametrize("n_pilots", [1, 3])
@pytest.mark.parametrize("ptype", ["angle", "angle_amp", "ones"])
def test_pilot_matrix_matches_jax(n_pilots, ptype):
    got = tp.pilot_matrix(4, n_pilots, 2, ptype, dtype=torch.complex128)
    want = jp.pilot_matrix(4, n_pilots, 2, ptype, dtype=jnp.complex128)
    _close(got, want, atol=1e-15)
    inf = tp.pilot_matrix(4, n_pilots, math.inf, ptype,
                          dtype=torch.complex128)
    _close(inf, jp.pilot_matrix(4, n_pilots, math.inf, ptype,
                                dtype=jnp.complex128))


def test_rand_pilots_are_power_normalized():
    gen = torch.Generator().manual_seed(3)
    x = tp.pilot_vector(gen, 4, 2, "rand", dtype=torch.complex128)
    assert float((x.abs() ** 2).sum()) == pytest.approx(4.0, rel=1e-12)
    with pytest.raises(ValueError):
        tp.pilot_vector(None, 4, 2, "rand")


@pytest.mark.parametrize("n_bits", [1, 2, 3])
@pytest.mark.parametrize("n_pilots", [1, 2])
def test_observe_with_shared_noise_is_identical(rng, n_bits, n_pilots):
    """quantize(apply_pilots(h) + shared noise): the JAX observation draws
    its noise from the key with crandn; the port gets the same draw."""
    d, snr = 6, 5.0
    h = _crand(rng, (50, d))
    key = jax.random.PRNGKey(7)
    a_j = jp.pilot_matrix(d, n_pilots, n_bits, dtype=jnp.complex128)
    q_j = jq.design_quantizer(snr, n_bits)
    want = np.asarray(jo.observe(key, jnp.asarray(h), snr, a_j, n_bits, q_j))
    w = np.asarray(jc.crandn(key, (50, d * n_pilots), jnp.complex128))
    got = to.observe_noise(torch.as_tensor(h), torch.as_tensor(w), snr,
                           torch.as_tensor(np.asarray(a_j)), n_bits,
                           _tq(q_j))
    assert np.array_equal(got.numpy(), want)
    _close(to.apply_pilots(torch.as_tensor(h), torch.as_tensor(
        np.asarray(a_j))), jo.apply_pilots(jnp.asarray(h), a_j))


def test_observe_draws_from_generator(rng):
    h = torch.as_tensor(_crand(rng, (10, 4)))
    q = tq.design_quantizer(0.0, 2, dtype=torch.float64)
    r1 = to.observe(torch.Generator().manual_seed(1), h, 0.0, None, 2, q)
    r2 = to.observe(torch.Generator().manual_seed(1), h, 0.0, None, 2, q)
    assert torch.equal(r1, r2) and r1.shape == h.shape
    assert set(np.unique(r1.real.numpy())) <= set(q.labels.numpy())
