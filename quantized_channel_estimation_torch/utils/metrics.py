"""Evaluation metrics: normalized MSE and achievable-rate bounds.

Port of `quantized_channel_estimation_tpu/utils/metrics.py` (`nmse`,
`global_bussgang_stats`, `rate_lower_bound`, `rate_mf_bound`); the rate
bounds are evaluated against the global Bussgang statistics
Cq = Cr - B C B^H of the training sample covariance.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.bussgang import (
    bussgang_gain_matrix, quantized_cov)
from quantized_channel_estimation_torch.ops.quantizer import ScalarQuantizer


def nmse(h_est: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """sum(|h_est - h|^2) / h.numel()."""
    return ((h_est - h).abs() ** 2).sum() / h.numel()


def global_bussgang_stats(cov: torch.Tensor, snr_db, n_bits,
                          q: Optional[ScalarQuantizer] = None):
    """(B_glob, Cq_glob) from the global channel covariance: Cy = C +
    sigma^2 I, B = Bussgang gain of Cy, Cq = Cr(Cy) - B C B^H."""
    sigma2 = 10.0 ** (-float(snr_db) / 10.0)
    cy = cov + sigma2 * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                  device=cov.device)
    b = bussgang_gain_matrix(cy, n_bits, q)
    cr = quantized_cov(cy, n_bits, q, beta="mean")
    return b, cr - b @ cov @ b.conj().T


def rate_mf_bound(h_est: torch.Tensor, h: torch.Tensor, b_glob: torch.Tensor,
                  cq_glob: torch.Tensor, jitter: float = 1e-9) -> torch.Tensor:
    """Per-sample matched-filter rate bound, averaged:
    g = h_est^H B^H Cq^{-1}; log2(1 + |g B h_est|^2 /
    (g Cq g^H + |g B (h - h_est)|^2))."""
    cq_inv = linalg.psd_pinv(cq_glob + jitter * torch.eye(
        cq_glob.shape[-1], dtype=cq_glob.dtype, device=cq_glob.device))
    g = h_est.conj() @ b_glob.conj().T @ cq_inv         # (n, D)
    bh = h_est @ b_glob.T
    berr = (h - h_est) @ b_glob.T
    num = (g * bh).sum(-1).abs() ** 2
    den1 = ((g @ cq_glob) * g.conj()).sum(-1).real
    den2 = (g * berr).sum(-1).abs() ** 2
    return torch.log2(1.0 + num / (den1 + den2)).mean()


def rate_lower_bound(h_est: torch.Tensor, h: torch.Tensor,
                     b_glob: torch.Tensor, cq_glob: torch.Tensor,
                     norm_clip: Optional[float] = None) -> torch.Tensor:
    """Statistical achievable-rate lower bound log2(1 + num/(den1 + den2)),
    with the estimates normalized per sample by their power (clipped below
    at norm_clip, 0.1 for the GMM rows)."""
    norm = (h_est.abs() ** 2).sum(-1)
    if norm_clip is not None:
        norm = torch.clamp(norm, min=norm_clip)
    g = h_est / norm[:, None]
    inner = ((g.conj() @ b_glob) * h).sum(-1)
    num = inner.mean().abs() ** 2
    den1 = ((inner - inner.mean()).abs() ** 2).mean()
    den2 = ((g.conj() @ cq_glob) * g).sum(-1).real.mean()
    return torch.log2(1.0 + num / (den1 + den2))
