"""Bussgang least-squares estimator.

Port of `quantized_channel_estimation_tpu/estimators/ls.py`:
h = argmin |A_eff h - r|^2 with A_eff = B A, solved through the normal
equations and a Cholesky factorization; rows whose solve is NaN become 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.bussgang import bussgang_gain_diag
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits)


def _a_eff(cy: torch.Tensor, a: torch.Tensor, n_bits,
           q: Optional[ScalarQuantizer]) -> torch.Tensor:
    if is_inf_bits(n_bits):
        return a.expand(*cy.shape[:-2], *a.shape)
    gains = bussgang_gain_diag(torch.diagonal(cy, dim1=-2, dim2=-1), n_bits,
                               q).to(cy.dtype)
    return gains[..., :, None] * a


def _zero_nan_rows(h: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(h).any(-1, keepdim=True),
                       torch.zeros_like(h), h)


def _obs_cov(c: torch.Tensor, a: torch.Tensor, snr_db) -> torch.Tensor:
    s2 = torch.tensor(10.0 ** (-float(snr_db) / 10.0),
                      dtype=torch.float32).item()
    return a @ c @ a.conj().T + s2 * torch.eye(a.shape[0], dtype=c.dtype,
                                               device=c.device)


def estimate_genie(r: torch.Tensor, t: torch.Tensor, snr_db, a: torch.Tensor,
                   n_bits, q: Optional[ScalarQuantizer] = None,
                   jitter: float = 1e-8) -> torch.Tensor:
    """Per-sample Bussgang LS with genie covariances for the Bussgang gain;
    r (B, M), t (B, N)."""
    pin_fp32()
    c = linalg.toeplitz_from_first_row(t.to(r.dtype))
    a_eff = _a_eff(_obs_cov(c, a, snr_db), a, n_bits, q)
    gram = a_eff.mH @ a_eff
    rhs = (a_eff.mH @ r[..., None])[..., 0]
    return _zero_nan_rows(linalg.cho_solve_hermitian(gram, rhs,
                                                     jitter=jitter))


def estimate_global(r: torch.Tensor, cov: torch.Tensor, snr_db,
                    a: torch.Tensor, n_bits,
                    q: Optional[ScalarQuantizer] = None,
                    jitter: float = 1e-8) -> torch.Tensor:
    """Global Bussgang LS: the shared covariance sets the gain, one solve for
    the whole batch."""
    pin_fp32()
    a_eff = _a_eff(_obs_cov(cov, a, snr_db), a, n_bits, q)
    gram = a_eff.conj().T @ a_eff
    rhs = r @ a_eff.conj()                    # rows A_eff^H r_b
    h = linalg.cho_solve_hermitian(gram, rhs.T, jitter=jitter).T
    return _zero_nan_rows(h)
