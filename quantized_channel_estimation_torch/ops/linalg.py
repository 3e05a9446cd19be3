"""Batched Hermitian linear algebra (main-path subset).

Port of `quantized_channel_estimation_tpu/ops/linalg.py`: the Toeplitz and
DFT matrices, the oversampled DFT frame of the inverse-EM Toeplitz fit and
its spectrum recovery, the Cholesky-based solves the GMM fit, the bank
preparation and the BLMMSE/LS baselines use, the jitter ladders
`robust_precision_cholesky` and `robust_chol_lower` (the MIMO coloring
factor), the eigenvalue pseudo-inverse
and PSD projection, the products-only PSD projection of the quantized EM
(`psd_project_polar`), and the (block-)circulant spectra helpers of the
structured banks. Every function is batched over leading axes and
follows the dtype of its input.
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


def oversampled_dft(n: int, dtype=torch.complex64, device=None) -> torch.Tensor:
    """F2 = fft(I_2n)[:, :n] / sqrt(2n): the (2n, n) oversampled DFT frame
    of the Barton-Fuhrmann Toeplitz EM. F2^H diag(s) F2 is a Toeplitz PSD
    matrix for s >= 0."""
    k2 = torch.arange(2 * n, device=device).to(dtype)
    kn = torch.arange(n, device=device).to(dtype)
    w = torch.exp(torch.tensor(-1j * math.pi / n, dtype=dtype, device=device)
                  * torch.outer(k2, kn))
    return w / math.sqrt(2 * n)


def spectrum_from_covariance(covs: torch.Tensor, f2: torch.Tensor,
                             floor: float, iters: int = 200) -> torch.Tensor:
    """The frame spectrum s with C = F2^H diag(s) F2, recovered from C.

    The frame's rows are not orthogonal, so the diagonal b_f = f_f^H C f_f
    is a smoothed spectrum (b = G s with the Gram G_fg = |f_f^H f_g|^2),
    not s. The Gram system is solved by Richardson-Lucy multiplicative
    updates (KL(b || G s) over s >= 0), which stay stable in float32 where
    a pseudo-inverse of the rank-deficient Gram does not. covs (K, D, D)
    Hermitian, f2 (F, D) -> (K, F) >= floor."""
    gram = (f2 @ f2.mH).abs() ** 2
    b = torch.einsum("fd,kde,fe->kf", f2, covs, f2.conj()).real.clamp(min=0.0)
    gsum = gram.sum(0)
    tiny = torch.finfo(b.dtype).tiny
    sigma = b.clamp(min=floor)
    for _ in range(iters):
        ratio = b / (sigma @ gram).clamp(min=tiny)
        sigma = sigma * (ratio @ gram) / gsum
    return sigma.clamp(min=floor)


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


def _robust_chol(c: torch.Tensor, base_jitter: float, scales) -> torch.Tensor:
    """Batched Cholesky with an escalating relative-jitter ladder, as the JAX
    `_robust_chol`: each matrix is factored at every rung (base_jitter +
    scale x its mean diagonal) and the first finite factor is kept. The
    choice is made on the device (no `info` is read on the host)."""
    eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
    diag_mean = torch.diagonal(c, dim1=-2, dim2=-1).real.mean(-1)[..., None,
                                                                  None]
    ls = [chol_lower(c + (base_jitter + s * diag_mean) * eye)
          for s in scales]
    l = ls[-1]
    for cand in reversed(ls[:-1]):
        bad = torch.isnan(cand).any(dim=-1, keepdim=True).any(dim=-2,
                                                              keepdim=True)
        l = torch.where(bad, l, cand)
    return l


def robust_precision_cholesky(c: torch.Tensor,
                              base_jitter: float = 0.0) -> torch.Tensor:
    """Precision Cholesky with the jitter ladder +0, +1e-4 d, +1e-2 d (d =
    each matrix's mean diagonal)."""
    return prec_from_chol(_robust_chol(c, base_jitter, (0.0, 1e-4, 1e-2)))


def robust_chol_lower(c: torch.Tensor,
                      base_jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor with the finer ladder +0, +1e-6 d, +1e-4 d,
    +1e-2 d: the coloring factor of a near-singular PSD matrix (truncated
    Toeplitz covariances of narrow angular spreads are numerically
    rank-deficient), which takes the smallest jitter that factors."""
    return _robust_chol(c, base_jitter, (0.0, 1e-6, 1e-4, 1e-2))


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


def psd_project(c: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """Project Hermitian matrices onto the PSD cone by clipping their
    eigenvalues at `floor`."""
    w, v = torch.linalg.eigh(c)
    return (v * w.clamp(min=floor).to(c.dtype)[..., None, :]) @ v.mH


def hermitize(c: torch.Tensor) -> torch.Tensor:
    """(C + C^H)/2."""
    return 0.5 * (c + c.mH)


def psd_project_polar(c: torch.Tensor, floor: float = 0.0,
                      iters: int = 40) -> torch.Tensor:
    """PSD projection through the matrix sign function (Newton-Schulz),
    products only: max(A, f) = f I + (B + sign(B) B)/2 with B = A - f I,
    and sign(B) from X <- X(3I - X^2)/2 on B scaled below unit spectral
    norm (its Frobenius norm). Eigenvalues under ~1.5^-iters of the norm do
    not saturate; at 40 steps that is ~1e-7 ||B||, below the norm-relative
    diagonal guard 2e-6 ||B|| added at the end, so the result keeps its
    floor even for near-zero negative spectra. The guard is above TF32's
    error, so the products need fp32 (`ops.precision.pin_fp32`)."""
    d = c.shape[-1]
    eye = torch.eye(d, dtype=c.dtype, device=c.device)
    b = hermitize(c) - floor * eye
    nrm = torch.sqrt((b.abs() ** 2).sum(dim=(-2, -1), keepdim=True))
    nrm = nrm.clamp(min=torch.finfo(torch.float32).tiny)
    x = b / nrm.to(b.dtype)
    for _ in range(iters):
        x = 0.5 * (x @ (3.0 * eye - x @ x))
    pos = 0.5 * (b + hermitize(x) @ b)
    guard = (2e-6 * nrm).to(c.dtype)
    return hermitize(pos) + (floor + guard) * eye


def _block_reshape(x: torch.Tensor, blocks) -> torch.Tensor:
    n1, n2 = blocks
    return x.reshape(x.shape[:-1] + (n1, n2))


def circulant_diag_spectra(covs: torch.Tensor, blocks=None) -> torch.Tensor:
    """Diagonal of F C F^H for the unitary (block-)DFT basis F: the exact
    eigenvalues when C is (block-)circulant in that basis, and otherwise
    the spectrum of its Frobenius-best circulant approximation. Computed
    without F: fft over the row index, ifft over the column index, then the
    diagonal. `blocks=(n1, n2)` selects the kron(F_n1, F_n2) basis of
    'block-circulant' fits. covs (..., D, D) Hermitian -> (..., D) real."""
    if blocks is None:
        g = torch.fft.ifft(torch.fft.fft(covs, dim=-2), dim=-1)
    else:
        n1, n2 = blocks
        d = covs.shape[-1]
        if n1 * n2 != d:
            raise ValueError(f"blocks {blocks} incompatible with dim {d}")
        c4 = covs.reshape(covs.shape[:-2] + (n1, n2, n1, n2))
        g = torch.fft.ifftn(torch.fft.fftn(c4, dim=(-4, -3)), dim=(-2, -1))
        g = g.reshape(covs.shape)
    return torch.diagonal(g, dim1=-2, dim2=-1).real


def circulant_first_rows(spectra: torch.Tensor, blocks=None) -> torch.Tensor:
    """First row C[0, :] of the (block-)circulant C = F^H diag(s) F
    (unitary basis): fft(s) / D (2-D fft for blocks). spectra (..., D) real
    -> (..., D) complex."""
    d = spectra.shape[-1]
    s = torch.complex(spectra, torch.zeros_like(spectra))
    if blocks is None:
        return torch.fft.fft(s, dim=-1) / d
    return torch.fft.fft2(_block_reshape(s, blocks)).reshape(s.shape) / d


def circulant_spectra_from_first_rows(rows: torch.Tensor,
                                      blocks=None) -> torch.Tensor:
    """Inverse of `circulant_first_rows`: s = D ifft(row0), real part (a
    Hermitian circulant has a conjugate-symmetric first row, so the
    imaginary residue is rounding). rows (..., D) -> (..., D) real."""
    d = rows.shape[-1]
    if blocks is None:
        return torch.fft.ifft(rows, dim=-1).real * d
    s = torch.fft.ifft2(_block_reshape(rows, blocks))
    return s.real.reshape(rows.shape) * d


def best_circulant_approximation(t: torch.Tensor) -> torch.Tensor:
    """Spectrum (real, (..., n)) of the Frobenius-best circulant
    approximation F^H diag(s) F of the Hermitian Toeplitz matrix with first
    row t: s = n ifft(w) of the triangular weights
    w_m = ((n - m) t_m + m conj(t_{n-m})) / n."""
    n = t.shape[-1]
    m = torch.arange(n, device=t.device)
    idx = torch.where(m == 0, 0, n - m)
    w = ((n - m) * t + m * t[..., idx].conj()) / n
    return torch.fft.ifft(w, dim=-1).real * n
