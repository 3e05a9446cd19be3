"""Parity of the port's 3GPP channel model with the JAX package.

Given the same angles and gains the PSD and the Toeplitz rows are
deterministic, and given the same white noise so is the channel: these are
held at float64 to rtol 1e-10 (the frameworks' arcsin/exp and FFT
implementations differ in the last bits). The port's own random draws are
held by their statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import scm as js
from quantized_channel_estimation_torch.ops import linalg as tl
from quantized_channel_estimation_torch.ops import scm as ts

torch.set_num_threads(2)

RTOL = 1e-10


def _angles(rng, b, p):
    gains = rng.uniform(size=(b, p))
    gains /= gains.sum(-1, keepdims=True)
    return (rng.uniform(size=(b, p)) - 0.5) * 180.0, gains


@pytest.mark.parametrize("n_path,sigma", [(1, 2.0), (3, 5.0)])
def test_sample_psd_matches_jax(rng, n_path, sigma):
    angles, gains = _angles(rng, 4, n_path)
    got = ts.sample_psd(torch.as_tensor(angles), torch.as_tensor(gains), 8,
                        sigma)
    want = js.sample_psd(jnp.asarray(angles), jnp.asarray(gains), 8, sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-12)
    assert got.shape == (4, 800)


@pytest.mark.parametrize("n_antennas", [8, 10])
def test_channel_from_shared_noise_matches_jax(rng, n_antennas):
    """n_antennas=10 makes sqrt(F) inexact: the float32 cast of sqrt(F)
    (`scm.py:86`) must be reproduced even at float64."""
    angles, gains = _angles(rng, 3, 2)
    fs = np.asarray(js.sample_psd(jnp.asarray(angles), jnp.asarray(gains),
                                  n_antennas, 2.0))
    key = jax.random.PRNGKey(11)
    h_j, t_j = js.channel_from_psd(key, jnp.asarray(fs), n_antennas, 2,
                                   jnp.complex128)
    x = np.asarray(jc.crandn(key, fs.shape[:-1] + (2, fs.shape[-1]),
                             jnp.complex128))
    h_t, t_t = ts.channel_from_noise(torch.as_tensor(fs),
                                     torch.as_tensor(x), n_antennas)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(t_t[:, 0].real.numpy(), 1.0, rtol=1e-12)


def test_colored_channels_have_the_toeplitz_covariance(rng):
    """One PSD, many noise draws: the sample covariance of h approaches
    toeplitz(t) (N = 20000; relative Frobenius error ~ sqrt(D/N) ~ 0.02,
    bound 0.06)."""
    angles, gains = _angles(rng, 1, 2)
    fs = ts.sample_psd(torch.as_tensor(angles), torch.as_tensor(gains), 8,
                       2.0).expand(20000, -1)
    gen = torch.Generator().manual_seed(5)
    h, t = ts.channel_from_psd(gen, fs, 8, 1, torch.complex128)
    h = h[:, 0]
    cov = h.T @ h.conj() / h.shape[0]
    c_true = tl.toeplitz_from_first_row(t[0])
    err = torch.linalg.norm(cov - c_true) / torch.linalg.norm(c_true)
    assert float(err) < 0.06
    np.testing.assert_allclose(
        c_true.numpy(), np.asarray(jl.toeplitz_from_first_row(
            jnp.asarray(t[0].numpy()))), rtol=RTOL)


def test_generate_channels_statistics():
    """Random gains and angles: unit average power per antenna, genie rows
    with t_0 = 1, and the sample covariance close to the average genie
    covariance (N = 8000, bound 0.08)."""
    gen = torch.Generator().manual_seed(0)
    cfg = ts.ScmConfig(8, n_path=3, path_sigma=2.0)
    h, t = ts.generate_channels(gen, 8000, cfg, torch.complex128)
    assert h.shape == (8000, 8) and t.shape == (8000, 8)
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.05
    np.testing.assert_allclose(t[:, 0].real.numpy(), 1.0, rtol=1e-10)
    cov = h.T @ h.conj() / h.shape[0]
    mean_c = tl.toeplitz_from_first_row(t).mean(0)
    err = torch.linalg.norm(cov - mean_c) / torch.linalg.norm(mean_c)
    assert float(err) < 0.08
    h3, _ = ts.generate_channels(gen, 5, cfg._replace(n_coherence=3))
    assert h3.shape == (5, 3, 8) and h3.dtype == torch.complex64
