"""Batched Hermitian linear algebra (main-path subset).

Port of `quantized_channel_estimation_tpu/ops/linalg.py`: the Toeplitz and
DFT builders and the Cholesky-based solves the GMM fit, the bank
preparation and the BLMMSE/LS baselines use. Every function is batched over
leading axes and follows the dtype of its input.
"""
from __future__ import annotations

import math

import torch


def toeplitz_from_first_row(t: torch.Tensor) -> torch.Tensor:
    """Hermitian Toeplitz matrix whose first row is ``t``:
    C[i, j] = t[j - i] for j >= i and conj(t[i - j]) for j < i.
    Batched (..., D) -> (..., D, D)."""
    d = t.shape[-1]
    i = torch.arange(d, device=t.device)[:, None]
    j = torch.arange(d, device=t.device)[None, :]
    gathered = t[..., (j - i).abs()]
    return torch.where(j >= i, gathered, gathered.conj())


def unitary_dft(n: int, dtype=torch.complex64, device=None) -> torch.Tensor:
    """Unitary DFT matrix F with F F^H = I (fft(I)/sqrt(n))."""
    k = torch.arange(n, device=device).to(dtype)
    w = torch.exp(torch.tensor(-2j * math.pi / n, dtype=dtype, device=device)
                  * torch.outer(k, k))
    return w / math.sqrt(n)


def add_jitter(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Add eps to the diagonal of (..., D, D) matrices."""
    d = c.shape[-1]
    return c + eps * torch.eye(d, dtype=c.dtype, device=c.device)


def chol_lower(c: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of Hermitian PSD (..., D, D); NaN where the
    factorization fails (the JAX convention the robust ladder relies on)."""
    l, info = torch.linalg.cholesky_ex(c)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(l, float("nan")), l)


def prec_from_chol(l: torch.Tensor) -> torch.Tensor:
    """Upper-triangular P = (L^{-1})^H from a lower Cholesky factor L, so
    that C^{-1} = P P^H."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    linv = torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)
    return linv.mH.resolve_conj()


def robust_precision_cholesky(c: torch.Tensor,
                              base_jitter: float = 0.0) -> torch.Tensor:
    """Precision Cholesky with an escalating relative-jitter ladder: each
    matrix is factored at +0, +1e-4 d and +1e-2 d (d = its mean diagonal)
    and the first finite factor is kept, as in the JAX `_robust_chol`."""
    eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
    diag_mean = torch.diagonal(c, dim1=-2, dim2=-1).real.mean(-1)[..., None,
                                                                  None]
    ls = [chol_lower(c + (base_jitter + s * diag_mean) * eye)
          for s in (0.0, 1e-4, 1e-2)]
    l = ls[-1]
    for cand in reversed(ls[:-1]):
        bad = torch.isnan(cand).any(dim=-1, keepdim=True).any(dim=-2,
                                                              keepdim=True)
        l = torch.where(bad, l, cand)
    return prec_from_chol(l)


def logdet_from_prec_chol(p: torch.Tensor) -> torch.Tensor:
    """sum(log diag(P)) for precision-Cholesky P; equals -1/2 log det(C)."""
    return torch.log(torch.diagonal(p, dim1=-2, dim2=-1).real).sum(-1)


def cho_solve_hermitian(c: torch.Tensor, b: torch.Tensor,
                        jitter: float = 0.0) -> torch.Tensor:
    """Solve C x = b for Hermitian PSD C (..., D, D), b (..., D) or
    (..., D, M), through one Cholesky factorization (NaN where it fails)."""
    if jitter:
        c = add_jitter(c, jitter)
    l = chol_lower(c)
    vec = b.dim() == c.dim() - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(l, b, upper=False)
    x = torch.linalg.solve_triangular(l.mH, y, upper=True)
    return x[..., 0] if vec else x


def hermitian_inv(c: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Dense inverse of Hermitian PSD matrices via Cholesky."""
    eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
    return cho_solve_hermitian(c, eye.expand_as(c), jitter=jitter)


def psd_pinv(c: torch.Tensor, rcond: float = 1e-10) -> torch.Tensor:
    """Eigh-based pseudo-inverse for Hermitian matrices."""
    w, v = torch.linalg.eigh(c)
    tol = rcond * w.abs().amax(dim=-1, keepdim=True)
    w_inv = torch.where(w > tol, 1.0 / w, torch.zeros_like(w)).to(c.dtype)
    return (v * w_inv[..., None, :]) @ v.mH


def hermitize(c: torch.Tensor) -> torch.Tensor:
    """(C + C^H)/2."""
    return 0.5 * (c + c.mH)
