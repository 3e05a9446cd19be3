"""Parity of the port's Bussgang BLMMSE and LS baselines and its metrics
with the JAX package, at float64 on the same numpy inputs.

Tolerance rtol 1e-9: batched Cholesky solves and eigendecompositions of
covariances with condition ~1e3, summed in another order.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import blmmse as jbl
from quantized_channel_estimation_tpu.estimators import ls as jls
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.utils import metrics as jm
from quantized_channel_estimation_torch.estimators import blmmse as tbl
from quantized_channel_estimation_torch.estimators import ls as tls
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.utils import metrics as tm

torch.set_num_threads(2)

D, B = 6, 40
RTOL = 1e-9


def _crand(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        / np.sqrt(2)


def _setup(rng, n_bits, n_pilots=1, snr=5.0):
    t = _crand(rng, (B, D)) * np.exp(-np.arange(D) / 2.0)
    t[:, 0] = 1.0                                   # unit-power Toeplitz rows
    c = _crand(rng, (D, D))
    cov = c @ c.conj().T / D + 0.3 * np.eye(D)
    a = np.asarray(jp.pilot_matrix(D, n_pilots, n_bits, dtype=jnp.complex128))
    r = _crand(rng, (B, D * n_pilots))
    qj = jq.design_quantizer(snr, n_bits)
    qt = None if qj is None else tq.ScalarQuantizer(
        *(torch.as_tensor(np.asarray(x)) for x in qj))
    return t, cov, a, r, qj, qt


def _close(got, want):
    np.testing.assert_allclose(got.resolve_conj().numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("n_bits,n_pilots", [(1, 1), (2, 1), (3, 2),
                                             (math.inf, 1)])
def test_blmmse_matches_jax(rng, n_bits, n_pilots):
    t, cov, a, r, qj, qt = _setup(rng, n_bits, n_pilots)
    T = torch.as_tensor
    _close(tbl.estimate_genie(T(r), T(t), 5.0, T(a), n_bits, qt),
           jbl.estimate_genie(jnp.asarray(r), jnp.asarray(t), 5.0,
                              jnp.asarray(a), n_bits, qj))
    _close(tbl.global_filter(T(cov), 5.0, T(a), n_bits, qt),
           jbl.global_filter(jnp.asarray(cov), 5.0, jnp.asarray(a), n_bits,
                             qj))
    _close(tbl.estimate_global(T(r), T(cov), 5.0, T(a), n_bits, qt),
           jbl.estimate_global(jnp.asarray(r), jnp.asarray(cov), 5.0,
                               jnp.asarray(a), n_bits, qj))


@pytest.mark.parametrize("n_bits,n_pilots", [(1, 1), (2, 1), (2, 2),
                                             (math.inf, 1)])
def test_ls_matches_jax(rng, n_bits, n_pilots):
    t, cov, a, r, qj, qt = _setup(rng, n_bits, n_pilots)
    T = torch.as_tensor
    _close(tls.estimate_genie(T(r), T(t), 5.0, T(a), n_bits, qt),
           jls.estimate_genie(jnp.asarray(r), jnp.asarray(t), 5.0,
                              jnp.asarray(a), n_bits, qj))
    _close(tls.estimate_global(T(r), T(cov), 5.0, T(a), n_bits, qt),
           jls.estimate_global(jnp.asarray(r), jnp.asarray(cov), 5.0,
                               jnp.asarray(a), n_bits, qj))


@pytest.mark.parametrize("n_bits", [1, 2, math.inf])
def test_metrics_match_jax(rng, n_bits):
    _, cov, _, _, qj, qt = _setup(rng, n_bits)
    h = _crand(rng, (B, D))
    h_est = h + 0.3 * _crand(rng, (B, D))
    T = torch.as_tensor
    _close(tm.nmse(T(h_est), T(h)),
           jm.nmse(jnp.asarray(h_est), jnp.asarray(h)))
    b_t, cq_t = tm.global_bussgang_stats(T(cov), 5.0, n_bits, qt)
    b_j, cq_j = jm.global_bussgang_stats(jnp.asarray(cov), 5.0, n_bits, qj)
    _close(b_t, b_j)
    _close(cq_t, cq_j)
    for clip in (None, 0.1, 50.0):
        _close(tm.rate_lower_bound(T(h_est), T(h), b_t, cq_t, clip),
               jm.rate_lower_bound(jnp.asarray(h_est), jnp.asarray(h), b_j,
                                   cq_j, clip))
    _close(tm.rate_mf_bound(T(h_est), T(h), b_t, cq_t),
           jm.rate_mf_bound(jnp.asarray(h_est), jnp.asarray(h), b_j, cq_j))


def test_ls_zeroes_nan_rows():
    h = torch.tensor([[1.0, float("nan")], [2.0, 3.0]], dtype=torch.float64)
    out = tls._zero_nan_rows(h)
    assert out[0].tolist() == [0.0, 0.0] and out[1].tolist() == [2.0, 3.0]
