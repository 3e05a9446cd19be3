"""Classical Bussgang-LMMSE estimators.

Port of `quantized_channel_estimation_tpu/estimators/blmmse.py`
(`estimate_genie`, `estimate_genie_kron`, `global_filter`,
`estimate_global`): genie BLMMSE with each sample's true Toeplitz (or, for
Kronecker MIMO channels, kron of two Toeplitz) covariance, batched over
samples, and global BLMMSE with one filter from the shared sample
covariance. Solves are
Cholesky-based with a small diagonal jitter.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.bussgang import (
    arcsine_cov, blmmse_quantized_cov, bussgang_gain_diag)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits)


def _observation_cov(c: torch.Tensor, a: torch.Tensor,
                     sigma2: float) -> torch.Tensor:
    """Cy = A C A^H + sigma^2 I for C (..., N, N), A (M, N); sigma^2 is
    rounded to float32 as in the JAX model."""
    cy = a @ c @ a.conj().T
    s2 = torch.tensor(sigma2, dtype=torch.float32).item()
    return cy + s2 * torch.eye(a.shape[0], dtype=c.dtype, device=c.device)


def _effective_matrix_and_cr(cy: torch.Tensor, a: torch.Tensor, n_bits,
                             q: Optional[ScalarQuantizer]):
    """(A_eff, Cr) = (B A, quantized-output covariance model)."""
    if is_inf_bits(n_bits):
        return a.expand(*cy.shape[:-2], *a.shape), cy
    gains = bussgang_gain_diag(torch.diagonal(cy, dim1=-2, dim2=-1), n_bits,
                               q).to(cy.dtype)
    a_eff = gains[..., :, None] * a
    if n_bits == 1:
        return a_eff, arcsine_cov(cy)
    return a_eff, blmmse_quantized_cov(cy, n_bits, q, beta="first")


def estimate_genie_cov(r: torch.Tensor, c: torch.Tensor, snr_db,
                       a: torch.Tensor, n_bits,
                       q: Optional[ScalarQuantizer] = None,
                       jitter: float = 1e-6) -> torch.Tensor:
    """Genie BLMMSE from per-sample covariances: h_b = C_b A_eff^H Cr_b^{-1}
    r_b; r (B, M), c (B, N, N)."""
    pin_fp32()
    cy = _observation_cov(c, a, 10.0 ** (-float(snr_db) / 10.0))
    a_eff, cr = _effective_matrix_and_cr(cy, a, n_bits, q)
    x = linalg.cho_solve_hermitian(cr, r, jitter=jitter)    # (B, M)
    cah = c @ a_eff.mH                                      # C A_eff^H
    return (cah @ x[..., None])[..., 0]


def estimate_genie(r: torch.Tensor, t: torch.Tensor, snr_db, a: torch.Tensor,
                   n_bits, q: Optional[ScalarQuantizer] = None,
                   jitter: float = 1e-6) -> torch.Tensor:
    """Genie BLMMSE with C_b = toeplitz(t_b); r (B, M), t (B, N)."""
    c = linalg.toeplitz_from_first_row(t.to(r.dtype))
    return estimate_genie_cov(r, c, snr_db, a, n_bits, q, jitter)


def estimate_genie_kron(r: torch.Tensor, t_bs: torch.Tensor,
                        t_ms: torch.Tensor, snr_db, a: torch.Tensor, n_bits,
                        q: Optional[ScalarQuantizer] = None,
                        jitter: float = 1e-6) -> torch.Tensor:
    """Genie BLMMSE for Kronecker MIMO channels (`ops.scm_mimo`): C_b =
    kron(toeplitz(t_ms_b), toeplitz(t_bs_b)), the covariance of the
    vectorized channel in layout i_ms * N_BS + i_bs; r (B, M), t_bs
    (B, N_BS), t_ms (B, N_MS)."""
    c_bs = linalg.toeplitz_from_first_row(t_bs.to(r.dtype))
    c_ms = linalg.toeplitz_from_first_row(t_ms.to(r.dtype))
    n = c_bs.shape[-1] * c_ms.shape[-1]
    c = (c_ms[..., :, None, :, None] * c_bs[..., None, :, None, :]).reshape(
        *c_ms.shape[:-2], n, n)
    return estimate_genie_cov(r, c, snr_db, a, n_bits, q, jitter)


def global_filter(cov: torch.Tensor, snr_db, a: torch.Tensor, n_bits,
                  q: Optional[ScalarQuantizer] = None,
                  jitter: float = 1e-6) -> torch.Tensor:
    """Global BLMMSE filter W = C A_eff^H Cr^{-1} (N, M)."""
    pin_fp32()
    cy = _observation_cov(cov, a, 10.0 ** (-float(snr_db) / 10.0))
    a_eff, cr = _effective_matrix_and_cr(cy, a, n_bits, q)
    cah = cov @ a_eff.conj().T
    w_h = linalg.cho_solve_hermitian(cr, cah.conj().T, jitter=jitter)
    return w_h.conj().T


def estimate_global(r: torch.Tensor, cov: torch.Tensor, snr_db,
                    a: torch.Tensor, n_bits,
                    q: Optional[ScalarQuantizer] = None,
                    jitter: float = 1e-6) -> torch.Tensor:
    """Global BLMMSE: one filter from the shared covariance for the batch."""
    return r @ global_filter(cov, snr_db, a, n_bits, q, jitter).T
