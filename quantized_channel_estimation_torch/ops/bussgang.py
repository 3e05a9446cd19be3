"""Bussgang decomposition statistics for coarsely quantized Gaussian signals.

Port of `quantized_channel_estimation_tpu/ops/bussgang.py` (all seven
functions). For r = Q(y), y ~ CN(0, Cy), with per-real-component scalar
quantization, r = B y + q with distortion q uncorrelated with y. Batched
over leading axes; `n_bits` is a Python number.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits)


def _diag(c: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(c, dim1=-2, dim2=-1)


def _eye_like(c: torch.Tensor) -> torch.Tensor:
    return torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)


def bussgang_gain_diag(diag_cy: torch.Tensor, n_bits,
                       q: Optional[ScalarQuantizer] = None) -> torch.Tensor:
    """Diagonal Bussgang gain for per-dim variances diag_cy:
    B_ii = sum_j (l_j - l_{j-1}) exp(-tau_j^2 / Cy_ii) / sqrt(pi Cy_ii);
    1-bit: sqrt(2/pi)/sqrt(Cy_ii); inf: 1. Returns (..., D) real."""
    diag_cy = diag_cy.real if diag_cy.is_complex() else diag_cy
    if is_inf_bits(n_bits):
        return torch.ones_like(diag_cy)
    if n_bits == 1:
        return math.sqrt(2.0 / math.pi) / torch.sqrt(diag_cy)
    # table arithmetic stays in the table's dtype before promotion, as in JAX
    label_steps = torch.diff(q.labels).to(diag_cy.dtype)
    thr2 = (q.thresholds ** 2).to(diag_cy.dtype)
    expo = torch.exp(-thr2 / diag_cy[..., None])
    b = (label_steps * expo).sum(-1)
    return b / (math.sqrt(math.pi) * torch.sqrt(diag_cy))


def bussgang_gain_matrix(cy: torch.Tensor, n_bits,
                         q: Optional[ScalarQuantizer] = None) -> torch.Tensor:
    """Full (diagonal) Bussgang gain matrix for covariance(s) cy."""
    if is_inf_bits(n_bits):
        return _eye_like(cy).expand_as(cy)
    b = bussgang_gain_diag(_diag(cy), n_bits, q)
    return torch.diag_embed(b).to(cy.dtype)


def quantized_variance(sigma2: torch.Tensor,
                       q: ScalarQuantizer) -> torch.Tensor:
    """Exact per-dim output power E[|Q(y)|^2] for complex variance sigma2
    (each real component N(0, sigma2/2); bin masses from the Gaussian CDF)."""
    sigma2 = sigma2.real if sigma2.is_complex() else sigma2
    s = torch.sqrt(sigma2 / 2.0)[..., None]
    thr = q.thresholds.to(s.dtype)
    cdf = 0.5 * (1.0 + torch.erf(thr / (s * math.sqrt(2.0))))
    zeros = torch.zeros_like(cdf[..., :1])
    masses = torch.diff(torch.cat([zeros, cdf, zeros + 1.0], dim=-1))
    return 2.0 * ((q.labels ** 2).to(s.dtype) * masses).sum(-1)


def arcsine_cov(cy: torch.Tensor) -> torch.Tensor:
    """1-bit arcsine law Cr = 2/pi (arcsin(Re K) + j arcsin(Im K)) with
    K = Psi^{-1/2} Cy Psi^{-1/2}, Psi = diag(Cy)."""
    inv_sqrt = 1.0 / torch.sqrt(_diag(cy).real)
    scale = inv_sqrt[..., :, None] * inv_sqrt[..., None, :]
    inner_re = torch.clamp(cy.real * scale, -1.0, 1.0)
    inner_im = torch.clamp(cy.imag * scale, -1.0, 1.0)
    return (2.0 / math.pi) * torch.complex(torch.arcsin(inner_re),
                                           torch.arcsin(inner_im))


def quantized_cov(cy: torch.Tensor, n_bits,
                  q: Optional[ScalarQuantizer] = None,
                  beta: str = "mean") -> torch.Tensor:
    """Covariance Cr of r = Q(y): arcsine law (1 bit), Cy (inf), or beta^2 Cy
    off the diagonal with the exact quantized variance on it (n bits), beta
    the 'mean' or 'first' diagonal gain. Per matrix, like the JAX fix of the
    reference's batch-mixing `get_Cr`."""
    if is_inf_bits(n_bits):
        return cy
    if n_bits == 1:
        return arcsine_cov(cy)
    diag = _diag(cy).real
    gains = bussgang_gain_diag(diag, n_bits, q)
    if beta == "mean":
        b = gains.mean(-1)
    elif beta == "first":
        b = gains[..., 0]
    else:
        raise ValueError(f"beta must be 'mean' or 'first', got {beta!r}")
    b2 = (b ** 2)[..., None, None].to(cy.dtype)
    eye = _eye_like(cy)
    cr = b2 * cy * (1 - eye)
    diag_cr = quantized_variance(diag, q).to(cy.dtype)
    return cr + diag_cr[..., None] * eye


def bank_gains_and_cov(cy: torch.Tensor, n_bits,
                       q: Optional[ScalarQuantizer] = None,
                       exact_diag: bool = False):
    """(diagonal Bussgang gains, Cr) of a (batched) observation covariance,
    the estimator-bank model: n-bit Cr = beta^2 Cy + (1-beta^2) diag(Cy),
    beta = clip(mean(gains), 0, 1) (exact quantized variance on the diagonal
    with exact_diag)."""
    diag_cy = _diag(cy).real
    if is_inf_bits(n_bits):
        return torch.ones_like(diag_cy), cy
    if n_bits == 1:
        return bussgang_gain_diag(diag_cy, 1), arcsine_cov(cy)
    gains = bussgang_gain_diag(diag_cy, n_bits, q)
    beta = torch.clamp(gains.mean(-1), 0.0, 1.0)
    b2 = (beta ** 2)[..., None, None].to(cy.dtype)
    eye = _eye_like(cy)
    if exact_diag:
        diag_cr = quantized_variance(diag_cy, q).to(cy.dtype)
        cr = b2 * cy * (1 - eye) + diag_cr[..., None] * eye
    else:
        cr = b2 * cy + (1 - b2) * (_diag(cy)[..., None] * eye)
    return gains, cr


def blmmse_quantized_cov(cy: torch.Tensor, n_bits,
                         q: Optional[ScalarQuantizer] = None,
                         beta: str = "first") -> torch.Tensor:
    """The n-bit Cr model of the BLMMSE/GMM estimators:
    Cr = beta^2 Cy + (1 - beta^2) diag(diag(Cy)); beta 'first' (classical
    BLMMSE) or 'mean' clipped to [0, 1] (GMM component banks)."""
    if is_inf_bits(n_bits):
        return cy
    if n_bits == 1:
        return arcsine_cov(cy)
    gains = bussgang_gain_diag(_diag(cy).real, n_bits, q)
    if beta == "mean":
        b = torch.clamp(gains.mean(-1), 0.0, 1.0)
    else:
        b = gains[..., 0]
    b2 = (b ** 2)[..., None, None].to(cy.dtype)
    return b2 * cy + (1 - b2) * (_diag(cy)[..., None] * _eye_like(cy))
