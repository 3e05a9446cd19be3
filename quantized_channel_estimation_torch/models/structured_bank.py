"""FFT-domain prepared banks: GMM-Bussgang estimation for (block-)circulant
component covariances, kept in the DFT eigendomain end to end.

Port of `quantized_channel_estimation_tpu/models/structured_bank.py`:
`CirculantBank`, `_pilot_scalar`, `_pilot_vector`, `spectra_from_params`,
`_prepare_circulant`, `prepare_bank_circulant`, `unitary_fft` /
`unitary_ifft`, `_dft_matrix`, `_fwd` / `_inv`, `_log_prob_diag_split`,
`estimate_circulant`, `estimate_circulant_coherent` and the two stats
forms; the multi-pilot half `CirculantBankMP`, `_prepare_circulant_mp`,
`_mp_consts`, `_mp_logits`, `_mp_combine`, `estimate_circulant_mp`,
`estimate_circulant_mp_coherent` and their two stats forms; plus
`bank_from_numpy`, which carries a JAX bank of either kind across.

Why the bank collapses to spectra for the standard single-pilot setup
(A = x0 I, so the observation dim M equals the channel dim D): a circulant
channel covariance C = F^H diag(s) F gives

  Cy = |x0|^2 C + sigma^2 I          circulant, spectrum sy = |x0|^2 s + sigma^2
  diag(Cy) = mean(sy) ones           so the Bussgang gain matrix is g I
  Cr = arcsine(Cy)        [1 bit]    elementwise in the matrix entries, which
                                     depend only on (i - j) mod D: circulant
       Cy                 [inf]
       b^2 Cy + (1-b^2) diag(Cy)     [n bit] spectrum b^2 sy + (1-b^2) c0
  W = C (g x0 I)^H Cr^{-1}           spectrum g conj(x0) s / sr

so a per-SNR bank is K spectra of length D (memory O(K D) against the dense
bank's O(K D^2)) and one estimate is a transform, O(K D) of elementwise and
GEMV work, and an inverse transform. The responsibilities come from the
diagonal complex-Gaussian density in the DFT domain: a unitary change of
basis leaves Gaussian likelihoods invariant, so the posteriors (and with
them every selection mode) equal the dense path's up to rounding. Fits that
are not circulant ride the same path through their Frobenius-best circulant
approximation (`linalg.circulant_diag_spectra`).

This module is the plain pipeline: `torch.fft` transforms (method 'fft'),
or the same pipeline with the transforms as GEMMs against the DFT matrix
(method 'dft'), which is also what serves the `blocks=(n1, n2)` kron basis
as a general matrix. The hand-written circulant kernels live a layer up in
`estimators.circ_kernels` and `estimators.mp_circ_kernels`, and the one
rule that sends an 'all'-mode request to them (the JAX function's methods
'auto' and 'kernel') is `harness.stages.estimate_circulant` /
`estimate_circulant_coherent`.

Multi-pilot observations (A = kron(x, I) with P > 1) keep the structure:
the kron pilot maps each DFT bin to a P-vector, so the bank is D
independent P x P problems per component (`CirculantBankMP`), and
`prepare_bank_circulant`, `estimate_circulant` and
`estimate_circulant_coherent` take either kind of bank.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from quantized_channel_estimation_torch.models.gmm import GmmParams
from quantized_channel_estimation_torch.models.gmm_estimator import (
    _selection_weights)
from quantized_channel_estimation_torch.ops import cplx, linalg
from quantized_channel_estimation_torch.ops.bussgang import bussgang_gain_diag
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits)


class CirculantBank(NamedTuple):
    """Per-SNR prepared bank with (block-)circulant component covariances,
    in the unitary-DFT eigendomain. K components, D dims. `spec_cr`
    replaces the (K, M, M) precision Cholesky factors of
    `gmm_estimator.PreparedBank`, `filt_f` its (K, D, M) filters."""
    log_weights: torch.Tensor   # (K,) real; dead components at -inf
    mean_rf: torch.Tensor       # (K, D) complex: F (B A mu)
    spec_cr: torch.Tensor       # (K, D) real: eigenvalues of Cr (jittered)
    filt_f: torch.Tensor        # (K, D) complex: eigenvalues of W
    bias_f: torch.Tensor        # (K, D) complex: F mu - filt_f * mean_rf


class CirculantBankMP(NamedTuple):
    """Per-SNR prepared bank for (block-)circulant component covariances
    under the multi-pilot observation A = kron(x, I_D), x a (P,) pilot
    vector. K components, D dims.

    With Ch = F^H diag(s) F, every PD x PD quantity (Cy, the Bussgang Cr
    under all three maps, W) has circulant D x D blocks, so (I_P (x) F)
    diagonalizes the blocks together and the estimator factorizes into D
    independent P x P problems:

      Cy_f = s_f x x^H + sigma^2 I_P
      Cr_f = Cy_f                                   [inf]
             beta^2 Cy_f + diag((1-beta^2) d_i)     [n bit]
             per-block-pair arcsine spectra          [1 bit]
             (the arcsine law is elementwise in the entries of each
              circulant block, so block (i, j) stays circulant with
              eigenvalues D ifft(arcsine(first row)), complex for i != j)
      W_f  = s_f (g (.) x)^H Cr_f^{-1}              (1 x P row)

    with d_i = |x_i|^2 mean(s) + sigma^2 the (block-constant) diag(Cy) and
    g_i the per-block Bussgang gains. Bank memory O(K D P^2) against the
    dense bank's O(K (PD)^2 + K D PD); the prepare is K D batched P x P
    Cholesky factorizations against K of size PD. Matches
    `gmm_estimator.prepare_bank` + `estimate` to float32 / FFT rounding."""
    log_weights: torch.Tensor   # (K,) real; dead components at -inf
    mean_rf: torch.Tensor       # (K, D, P) complex: per-bin DFT obs mean
    prec_f: torch.Tensor        # (K, D, P, P) complex: per-bin Cr_f^{-1}
    logdet: torch.Tensor        # (K,) real: sum_f log det Cr_f
    filt_f: torch.Tensor        # (K, D, P) complex: per-bin W row
    bias_f: torch.Tensor        # (K, D) complex


def bank_from_numpy(bank, device=None):
    """The JAX package's `CirculantBank` (any 5-sequence in field order) or
    `CirculantBankMP` (6) as numpy arrays -> the port's, on `device`."""
    fields = [torch.as_tensor(np.array(x), device=device) for x in bank]
    return (CirculantBank if len(fields) == 5 else CirculantBankMP)(*fields)


def _pilot_scalar(a, d: int) -> torch.Tensor:
    """x0 from a scalar or an (M, M) = x0 I pilot matrix. The structured
    path is exact only for A proportional to the identity; any other matrix
    is refused rather than answered approximately."""
    a = torch.as_tensor(a)
    if a.dim() == 0:
        return a.to(torch.complex64)
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape[0] != d:
        raise ValueError(
            f"structured banks need A = x0*I with M = D = {d}; got pilot "
            f"shape {tuple(a.shape)} (multi-pilot observations densify Cy; "
            "use gmm_estimator.prepare_bank)")
    x0 = a[0, 0]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    if not torch.allclose(a, x0 * eye, rtol=0.0,
                          atol=1e-6 * max(1.0, float(x0.abs()))):
        raise ValueError(
            "structured banks need A = x0*I (scaled identity); the given "
            "pilot matrix is not; use gmm_estimator.prepare_bank")
    return x0.to(torch.complex64)


def _pilot_vector(a, d: int) -> torch.Tensor:
    """The pilot vector x (P,) from a scalar, x0 I, or the reference's
    kron(x, I_d) multi-pilot matrix (`ops.pilots.pilot_matrix`); any other
    structure is refused."""
    a = torch.as_tensor(a)
    if a.dim() == 0:
        return a.reshape(1).to(torch.complex64)
    if a.dim() != 2 or a.shape[1] != d or a.shape[0] % d:
        raise ValueError(
            f"structured banks need A = kron(x, I_{d}); got pilot shape "
            f"{tuple(a.shape)}; use gmm_estimator.prepare_bank")
    x = a[::d, 0]
    want = torch.kron(x[:, None], torch.eye(d, dtype=a.dtype,
                                            device=a.device))
    if not torch.allclose(a, want, rtol=0.0,
                          atol=1e-6 * max(1.0, float(x.abs().max()))):
        raise ValueError(
            "structured banks need A = kron(x, I) (the reference pilot "
            "form); the given matrix is not; use gmm_estimator.prepare_bank")
    return x.to(torch.complex64)


def spectra_from_params(params: GmmParams, blocks=None) -> torch.Tensor:
    """Channel-covariance spectra (K, D) of fitted dense parameters: exact
    (to rounding) for 'circulant' / 'block-circulant' fits, whose
    covariances `gmm.fit` builds as F^H diag(s) F; for any other fit the
    spectrum of the Frobenius-best circulant approximation."""
    return torch.clamp(linalg.circulant_diag_spectra(params.covariances,
                                                     blocks), min=0.0)


def _prepare_circulant(spectra, means, weights, n_bits, x0, sigma2, blocks,
                       q, jitter, weight_floor_rel) -> CirculantBank:
    k = spectra.shape[0]
    cdt = means.dtype
    sy = float(abs(x0)) ** 2 * spectra + sigma2       # (K, D) Cy spectrum
    c0 = sy.mean(-1)                                  # (K,) diag(Cy) value
    if is_inf_bits(n_bits):
        gains = torch.ones_like(c0)
        spec_cr = sy
    elif n_bits == 1:
        gains = bussgang_gain_diag(c0, 1)
        # the arcsine law acts on the matrix entries, so apply it to the
        # first row of Cy / c0 in the lag domain and transform back
        # (`bussgang.arcsine_cov` on the dense matrix maps the same entries)
        row_y = linalg.circulant_first_rows(sy, blocks) / c0[:, None]
        row_r = (2.0 / math.pi) * torch.complex(
            torch.asin(torch.clamp(row_y.real, -1.0, 1.0)),
            torch.asin(torch.clamp(row_y.imag, -1.0, 1.0)))
        spec_cr = torch.clamp(
            linalg.circulant_spectra_from_first_rows(row_r, blocks), min=0.0)
    else:
        gains = bussgang_gain_diag(c0, n_bits, q)
        beta2 = torch.clamp(gains, 0.0, 1.0)[:, None] ** 2
        spec_cr = beta2 * sy + (1.0 - beta2) * c0[:, None]
    spec_cr = spec_cr + jitter                        # matches add_jitter
    ax = gains.to(cdt)[:, None] * x0.to(cdt)          # A_eff = g x0 I
    mu_f = unitary_fft(means, blocks)
    mean_rf = ax * mu_f                               # F (g x0 mu)
    # W = C A_eff^H Cr^{-1}: spectrum g conj(x0) s / s_r
    filt_f = ax.conj() * (spectra / spec_cr).to(cdt)
    bias_f = mu_f - filt_f * mean_rf
    floor = weight_floor_rel / k
    logw = torch.where(weights >= floor,
                       torch.log(torch.clamp(weights, min=floor)),
                       torch.full_like(weights, -math.inf))
    return CirculantBank(logw.to(torch.float32), mean_rf,
                         spec_cr.to(torch.float32), filt_f, bias_f)


def _prepare_circulant_mp(spectra, means, weights, n_bits, x, sigma2, blocks,
                          q, jitter, weight_floor_rel) -> CirculantBankMP:
    k, d = spectra.shape
    p = x.shape[0]
    cdt = means.dtype
    x = x.to(cdt)
    cbar = spectra.mean(-1)                               # (K,) diag(Ch)
    di = x.abs()[None, :] ** 2 * cbar[:, None] + sigma2   # (K, P) diag(Cy)
    xxh = x[:, None] * x.conj()[None, :]                  # (P, P)
    eye_p = torch.eye(p, dtype=cdt, device=means.device)
    s_c = spectra.to(cdt)
    if is_inf_bits(n_bits):
        gains = torch.ones_like(di)
        cr_f = s_c[:, :, None, None] * xxh + sigma2 * eye_p
    elif n_bits == 1:
        gains = bussgang_gain_diag(di, 1)
        # per-block-pair arcsine: the first row of block (i, j) of Cy is
        # x_i conj(x_j) c_row + sigma^2 delta_ij e0; normalize by
        # sqrt(d_i d_j), arcsine the entries, then the block's (complex)
        # eigenvalues are D ifft of the mapped row, all in the same DFT
        # basis (`bussgang.arcsine_cov` on the dense matrix maps the same
        # entries)
        c_row = linalg.circulant_first_rows(spectra, blocks)   # (K, D)
        e0 = torch.zeros(d, dtype=cdt, device=means.device)
        e0[0] = 1.0
        row_y = (xxh[None, :, :, None] * c_row[:, None, None, :]
                 + sigma2 * eye_p[None, :, :, None] * e0)
        row_n = row_y / torch.sqrt(di[:, :, None] * di[:, None, :])[..., None]
        row_r = (2.0 / math.pi) * torch.complex(
            torch.asin(torch.clamp(row_n.real, -1.0, 1.0)),
            torch.asin(torch.clamp(row_n.imag, -1.0, 1.0)))
        if blocks is None:
            lam = torch.fft.ifft(row_r, dim=-1) * d            # (K, P, P, D)
        else:
            lam = torch.fft.ifft2(linalg._block_reshape(row_r, blocks))
            lam = lam.reshape(k, p, p, d) * d
        cr_f = lam.movedim(-1, 1)                              # (K, D, P, P)
    else:
        gains = bussgang_gain_diag(di, n_bits, q)              # (K, P)
        beta = torch.clamp(gains.mean(-1), 0.0, 1.0)           # (K,)
        cy_f = s_c[:, :, None, None] * xxh + sigma2 * eye_p    # (K, D, P, P)
        diag_part = (1.0 - beta[:, None] ** 2) * di            # (K, P)
        cr_f = ((beta ** 2).to(cdt)[:, None, None, None] * cy_f
                + diag_part.to(cdt)[:, None, :, None] * eye_p)
    cr_f = linalg.hermitize(cr_f) + jitter * eye_p
    chol = torch.linalg.cholesky(cr_f)                         # (K, D, P, P)
    logdet = 2.0 * torch.log(torch.diagonal(
        chol, dim1=-2, dim2=-1).real).sum((-2, -1))
    # P x P inverse through the Cholesky factor (P is tiny)
    inv_l = torch.linalg.solve_triangular(chol, eye_p.expand_as(chol),
                                          upper=False)
    prec_f = linalg.hermitize(inv_l.mH @ inv_l)

    gx = gains.to(cdt) * x[None, :]                            # (K, P)
    mu_f = unitary_fft(means, blocks)                          # (K, D)
    mean_rf = gx[:, None, :] * mu_f[:, :, None]                # (K, D, P)
    # W row per bin: s_f conj(gx) @ prec_f
    filt_f = s_c[:, :, None] * torch.einsum("kp,kdpq->kdq", gx.conj(), prec_f)
    bias_f = mu_f * (1.0 - torch.einsum("kdp,kp->kd", filt_f, gx))
    floor = weight_floor_rel / k
    logw = torch.where(weights >= floor,
                       torch.log(torch.clamp(weights, min=floor)),
                       torch.full_like(weights, -math.inf))
    return CirculantBankMP(logw.to(torch.float32), mean_rf, prec_f,
                           logdet.to(torch.float32), filt_f, bias_f)


def prepare_bank_circulant(params: GmmParams, snr_db, a, n_bits,
                           q: Optional[ScalarQuantizer] = None,
                           jitter: float = 1e-6,
                           weight_floor_rel: float = 1e-2, blocks=None,
                           spectra: Optional[torch.Tensor] = None
                           ) -> Union[CirculantBank, CirculantBankMP]:
    """Structured analog of `gmm_estimator.prepare_bank` for
    (block-)circulant component covariances and a scaled-identity pilot:
    the same Bussgang observation model and dead-component weight floor.
    `spectra` skips the extraction when the caller kept the fit's DFT
    spectra (then `params.covariances` is not read). A multi-pilot
    A = kron(x, I) with P > 1 returns a `CirculantBankMP`, the per-bin
    P x P factorization, exact for every bit width; `estimate_circulant`
    dispatches on the bank type."""
    pin_fp32()
    d = params.means.shape[-1]
    x = _pilot_vector(a, d)
    if spectra is None:
        spectra = spectra_from_params(params, blocks)
    sigma2 = torch.tensor(10.0 ** (-float(snr_db) / 10.0),
                          dtype=torch.float32).item()
    if x.shape[0] > 1:
        return _prepare_circulant_mp(spectra, params.means, params.weights,
                                     n_bits, x.to(params.means.device),
                                     sigma2, blocks, q, jitter,
                                     weight_floor_rel)
    return _prepare_circulant(spectra, params.means, params.weights, n_bits,
                              x[0], sigma2, blocks, q, jitter,
                              weight_floor_rel)


# ---------------------------------------------------------------------------
# unitary (block-)DFT data transforms
# ---------------------------------------------------------------------------

def unitary_fft(x: torch.Tensor, blocks=None) -> torch.Tensor:
    """u = F x along the last axis for the unitary (block-)DFT F that
    diagonalizes 'circulant' (`linalg.unitary_dft`) / 'block-circulant'
    (kron of two) covariances: fft / sqrt(D), a 2-D fft for blocks."""
    d = x.shape[-1]
    if blocks is None:
        return torch.fft.fft(x, dim=-1) / math.sqrt(d)
    u = torch.fft.fft2(linalg._block_reshape(x, blocks))
    return u.reshape(x.shape) / math.sqrt(d)


def unitary_ifft(u: torch.Tensor, blocks=None) -> torch.Tensor:
    """x = F^H u (inverse of `unitary_fft`)."""
    d = u.shape[-1]
    if blocks is None:
        return torch.fft.ifft(u, dim=-1) * math.sqrt(d)
    x = torch.fft.ifft2(linalg._block_reshape(u, blocks))
    return x.reshape(u.shape) * math.sqrt(d)


def _dft_matrix(d: int, blocks, dtype=torch.complex64,
                device=None) -> torch.Tensor:
    if blocks is None:
        return linalg.unitary_dft(d, dtype, device)
    return torch.kron(linalg.unitary_dft(blocks[0], dtype, device),
                      linalg.unitary_dft(blocks[1], dtype, device))


def _fwd(x: torch.Tensor, blocks, method: str) -> torch.Tensor:
    if method == "fft":
        return unitary_fft(x, blocks)
    f = _dft_matrix(x.shape[-1], blocks, x.dtype, x.device)
    return cplx.cmatmul(x, f.T)           # row convention: (F x) = x @ F^T


def _inv(u: torch.Tensor, blocks, method: str) -> torch.Tensor:
    if method == "fft":
        return unitary_ifft(u, blocks)
    f = _dft_matrix(u.shape[-1], blocks, u.dtype, u.device)
    return cplx.cmatmul(u, f.conj())      # (F^H u) = u @ conj(F)


def _log_prob_diag_split(u: torch.Tensor, means: torch.Tensor,
                         variances: torch.Tensor) -> torch.Tensor:
    """`gmm.log_prob_diag` with explicitly real GEMMs: |u|^2 @ prec^T is
    real, and the cross term needs only Re(u @ (conj(mu) prec)^T)."""
    d = u.shape[-1]
    prec = 1.0 / variances                                    # (K, D)
    mu2 = (means.abs() ** 2 * prec).sum(-1)                   # (K,)
    cross = cplx.cmatmul_realout(u, (means.conj() * prec).T)
    x2 = (u.real ** 2 + u.imag ** 2) @ prec.T
    quad = mu2[None, :] - 2.0 * cross + x2
    logdet = -torch.log(variances).sum(-1)
    return -(d * math.log(math.pi) + quad) + logdet[None, :]


# ---------------------------------------------------------------------------
# estimation
# ---------------------------------------------------------------------------

def _cast(bank, r: torch.Tensor):
    """The bank (of either kind) and r in their common precision (a float64
    request against a float32 bank computes in float64, as JAX's promotion
    does)."""
    cdt = torch.promote_types(r.dtype, bank.mean_rf.dtype)
    rdt = cplx.real_dtype_of(cdt)
    return type(bank)(*(x.to(cdt if x.is_complex() else rdt)
                        for x in bank)), r.to(cdt)


def _check_method(method: str) -> str:
    if method not in ("fft", "dft"):
        raise ValueError(
            f"unknown method {method!r}: the pipeline takes 'fft' or 'dft' "
            "(`harness.stages.estimate_circulant` dispatches to the kernels)")
    return method


def _estimate_chunk_f(bank: CirculantBank, u: torch.Tensor,
                      mode) -> torch.Tensor:
    """One chunk in the DFT domain: u (n, D) -> H (n, D), still in the DFT
    domain. h_f = sum_k w_k (bias_f,k + filt_k * u)."""
    lp = _log_prob_diag_split(u, bank.mean_rf, bank.spec_cr)
    proba = torch.softmax(lp + bank.log_weights[None, :], dim=-1)
    w = _selection_weights(proba, mode)
    return cplx.rcmatmul(w, bank.bias_f) + cplx.rcmatmul(w, bank.filt_f) * u


def estimate_circulant(bank: Union[CirculantBank, CirculantBankMP],
                       r: torch.Tensor,
                       mode: Union[str, int, float] = "all",
                       chunk_size: int = 16384, blocks=None,
                       method: str = "fft") -> torch.Tensor:
    """Estimate channels from quantized observations r (N, M) -> (N, D)
    through the FFT-domain bank: the structured analog of
    `gmm_estimator.estimate`, with the same posterior semantics and
    selection modes, as a chunked pipeline with FFT ('fft') or DFT-matrix
    GEMM ('dft') transforms. The kernel K6 (past D = 128 its wide form,
    `csrc/circ_wide_estimate.cu`, up to D = 672) and the rule that chooses
    between it and this pipeline (the JAX function's 'kernel' and 'auto'
    methods) are `estimators.circ_kernels.estimate_fused_circulant` and
    `harness.stages.estimate_circulant`. A multi-pilot bank goes to
    `estimate_circulant_mp`."""
    if isinstance(bank, CirculantBankMP):
        return estimate_circulant_mp(bank, r, mode, min(chunk_size, 8192),
                                     blocks, method)
    pin_fp32()
    method = _check_method(method)
    d = bank.spec_cr.shape[1]
    bank_c, rc = _cast(bank, r)
    out = [_inv(_estimate_chunk_f(bank_c, _fwd(rc[i0:i0 + chunk_size],
                                               blocks, method), mode),
                blocks, method)
           for i0 in range(0, r.shape[0], chunk_size)]
    if not out:
        return r.new_zeros((0, d))
    return torch.cat(out).to(r.dtype)


def _estimate_coherent_chunk_f(bank: CirculantBank, u: torch.Tensor, mode,
                               alpha: float) -> torch.Tensor:
    """One chunk of DFT-domain coherence blocks u (B, T, D) -> (B, T, D):
    the block-pooled posterior and leave-one-out alpha blend of
    `gmm_estimator._estimate_coherent_chunk`, with the diagonal likelihood
    and combine."""
    b, t, d = u.shape
    lp3 = _log_prob_diag_split(u.reshape(b * t, d), bank.mean_rf,
                               bank.spec_cr).reshape(b, t, -1)
    lp_sum = lp3.sum(1)
    if alpha >= 1.0:
        proba = torch.softmax(lp_sum + bank.log_weights[None, :], dim=-1)
        w = _selection_weights(proba, mode)                      # (B, K)
        return cplx.rcmatmul(w, bank.bias_f)[:, None, :] \
            + cplx.rcmatmul(w, bank.filt_f)[:, None, :] * u
    lg = lp3 + alpha * (lp_sum[:, None, :] - lp3) \
        + bank.log_weights[None, None, :]
    w = _selection_weights(torch.softmax(lg, dim=-1), mode)      # (B, T, K)
    return cplx.rcmatmul(w, bank.bias_f) + cplx.rcmatmul(w, bank.filt_f) * u


def estimate_circulant_coherent(bank: Union[CirculantBank,
                                            CirculantBankMP],
                                r: torch.Tensor,
                                mode: Union[str, int, float] = "all",
                                chunk_size: int = 4096, alpha: float = 1.0,
                                blocks=None,
                                method: str = "fft") -> torch.Tensor:
    """Joint estimation of coherence blocks r (B, T, M) -> (B, T, D)
    through the FFT-domain bank: the structured analog of
    `gmm_estimator.estimate_coherent`, with the alpha evidence blend
    (alpha = 0 is the independent per-snapshot estimator). `method` as in
    `estimate_circulant`; the kernel K7 is reached through
    `harness.stages.estimate_circulant_coherent`. A multi-pilot bank goes
    to `estimate_circulant_mp_coherent`."""
    if r.dim() != 3:
        raise ValueError(f"estimate_circulant_coherent expects (B, T, M) "
                         f"blocks, got shape {tuple(r.shape)}")
    if isinstance(bank, CirculantBankMP):
        return estimate_circulant_mp_coherent(
            bank, r, mode, min(chunk_size, 2048), alpha, blocks, method)
    pin_fp32()
    method = _check_method(method)
    d = bank.spec_cr.shape[1]
    t = r.shape[1]
    bank_c, rc = _cast(bank, r)
    out = [_inv(_estimate_coherent_chunk_f(
        bank_c, _fwd(rc[i0:i0 + chunk_size], blocks, method), mode, alpha),
        blocks, method) for i0 in range(0, r.shape[0], chunk_size)]
    if not out:
        return r.new_zeros((0, t, d))
    return torch.cat(out).to(r.dtype)


def _stats_chunk_f(bank: CirculantBank, u: torch.Tensor):
    """Un-normalized online-softmax state over this bank's components for
    one DFT-domain chunk u (n, D): the structured analog of
    `gmm_estimator.estimate_stats`. The logits hold the component
    log-weight and log-determinant (both of the component, so consistent
    across shards); dead components clamp to -1e30."""
    lp = _log_prob_diag_split(u, bank.mean_rf, bank.spec_cr)
    logits = (lp + torch.clamp(bank.log_weights, min=-1e30)[None, :]).to(
        torch.float32)
    m = logits.max(-1).values
    p = torch.exp(logits - m[:, None]).to(bank.spec_cr.dtype)
    acc = cplx.rcmatmul(p, bank.bias_f) + cplx.rcmatmul(p, bank.filt_f) * u
    return m, p.sum(-1), acc


def estimate_circulant_stats(bank: CirculantBank, r: torch.Tensor,
                             chunk_size: int = 16384, blocks=None,
                             method: str = "fft"):
    """'all'-mode estimation state (m, den, acc) of a (component shard of
    a) circulant bank: merging shard states (`circ_kernels.merge_stats`)
    and taking acc / den reproduces `estimate_circulant(..., 'all')` in the
    DFT domain; apply `unitary_ifft` to the merged quotient (the inverse
    transform commutes with the per-row normalization, so it runs once
    after the merge). m (N,), den (N,), acc (N, D) complex (DFT domain)."""
    pin_fp32()
    method = _check_method(method)
    bank_c, rc = _cast(bank, r)
    parts = [_stats_chunk_f(bank_c, _fwd(rc[i0:i0 + chunk_size], blocks,
                                         method))
             for i0 in range(0, r.shape[0], chunk_size)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _coherent_stats_chunk_f(bank: CirculantBank, u: torch.Tensor,
                            alpha: float):
    """Block online-softmax state of DFT-domain coherence blocks
    u (B, T, D), with the state convention and merge semantics of
    `gmm_estimator._coherent_stats_chunk`."""
    b, t, d = u.shape
    lp3 = _log_prob_diag_split(u.reshape(b * t, d), bank.mean_rf,
                               bank.spec_cr).reshape(b, t, -1)
    lw = torch.clamp(bank.log_weights, min=-1e30)
    lp_sum = lp3.sum(1)
    rdt = bank.spec_cr.dtype
    if alpha >= 1.0:
        logits = (lw[None, :] + lp_sum).to(torch.float32)       # (B, K)
        m = logits.max(-1).values
        p = torch.exp(logits - m[:, None]).to(rdt)
        acc = cplx.rcmatmul(p, bank.bias_f)[:, None, :] \
            + cplx.rcmatmul(p, bank.filt_f)[:, None, :] * u
        return m, p.sum(-1), acc
    lg = (lw[None, None, :] + lp3
          + alpha * (lp_sum[:, None, :] - lp3)).to(torch.float32)
    m = lg.max(-1).values                                       # (B, T)
    p = torch.exp(lg - m[..., None]).to(rdt)
    acc = cplx.rcmatmul(p, bank.bias_f) + cplx.rcmatmul(p, bank.filt_f) * u
    return m, p.sum(-1), acc


def estimate_circulant_coherent_stats(bank: CirculantBank, r: torch.Tensor,
                                      chunk_size: int = 4096,
                                      alpha: float = 1.0, blocks=None,
                                      method: str = "fft"):
    """Block estimation state of a (shard of a) circulant bank over
    coherence blocks r (B, T, M): per-block (m, den) at alpha = 1,
    per-snapshot below, acc (B, T, D) complex in the DFT domain. Merge
    across component shards as the flat stats, then `unitary_ifft` the
    quotient once."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, M) blocks, got {tuple(r.shape)}")
    pin_fp32()
    method = _check_method(method)
    bank_c, rc = _cast(bank, r)
    parts = [_coherent_stats_chunk_f(
        bank_c, _fwd(rc[i0:i0 + chunk_size], blocks, method), alpha)
        for i0 in range(0, r.shape[0], chunk_size)]
    return tuple(torch.cat(x) for x in zip(*parts))


# ---------------------------------------------------------------------------
# multi-pilot (P > 1) structured banks: per-bin P x P LMMSE
# ---------------------------------------------------------------------------

class _MpConsts(NamedTuple):
    """Constants of the multi-pilot logit computation, prepared once
    outside the chunk loop: the expanded quadratic's GEMM coefficients."""
    prec_re: torch.Tensor    # (K, D, P, P) real
    prec_im: torch.Tensor    # (K, D, P, P) real
    pm_flat: torch.Tensor    # (K, P*D) complex: vec(prec @ mean) pilot-major
    const_k: torch.Tensor    # (K,) real: logw - logdet - m^H P m - PD log pi


def _mp_consts(bank: CirculantBankMP) -> _MpConsts:
    """The one computation of the expanded quadratic's constants, shared by
    the pipeline below and the kernel K10's bank layout
    (`estimators.mp_circ_kernels.mp_circ_kernel_bank`). Dead components
    clamp to a finite -1e30."""
    k, d, p = bank.mean_rf.shape
    pm = torch.einsum("kdpq,kdq->kdp", bank.prec_f, bank.mean_rf)
    mpm = torch.einsum("kdp,kdp->k", bank.mean_rf.conj(), pm).real
    lw = torch.clamp(bank.log_weights, min=-1e30)
    const = lw - bank.logdet - mpm - p * d * math.log(math.pi)
    pm_flat = pm.transpose(1, 2).reshape(k, p * d)          # pilot-major
    return _MpConsts(bank.prec_f.real, bank.prec_f.imag, pm_flat, const)


def _mp_logits(mc: _MpConsts, u: torch.Tensor) -> torch.Tensor:
    """Posterior logits (n, K) of DFT-domain observations u (n, P, D):
    const_k + 2 Re(u . conj(Pm)) - u^H Prec u, the quadratic expanded into
    P (P + 1) / 2 real (n, D) x (D, K) products (no (n, K, .) or
    (n, D, P, P) intermediate)."""
    n, p, d = u.shape
    term1 = u.real.new_zeros((n, mc.const_k.shape[0]))
    for pi in range(p):
        up = u[:, pi, :]
        term1 = term1 + (up.real ** 2 + up.imag ** 2) \
            @ mc.prec_re[:, :, pi, pi].T
        for qi in range(pi + 1, p):
            v = up.conj() * u[:, qi, :]                       # (n, D)
            term1 = term1 + 2.0 * (v.real @ mc.prec_re[:, :, pi, qi].T
                                   - v.imag @ mc.prec_im[:, :, pi, qi].T)
    cross = cplx.cmatmul_realout(u.reshape(n, p * d), mc.pm_flat.conj().T)
    return mc.const_k[None, :] + 2.0 * cross - term1


def _mp_combine(bank: CirculantBankMP, w: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """h_f = sum_k w_k (bias_f,k + sum_i filt_f,k,i * u_i): P + 1 real
    (n, K) x (K, D) products against complex operands, applied per bin."""
    h_f = cplx.rcmatmul(w, bank.bias_f)
    for pi in range(u.shape[1]):
        h_f = h_f + cplx.rcmatmul(w, bank.filt_f[:, :, pi]) * u[:, pi, :]
    return h_f


def _mp_split(bank: CirculantBankMP, r: torch.Tensor):
    """The bank and r in their common precision, r's last axis (P*D) split
    into (P, D): the kron(x, I) layout is pilot-major."""
    k, d, p = bank.mean_rf.shape
    if r.shape[-1] != p * d:
        raise ValueError(f"expected observations of dim P*D = {p * d}, "
                         f"got {tuple(r.shape)}")
    bank_c, rc = _cast(bank, r)
    return bank_c, rc.reshape(r.shape[:-1] + (p, d))


def estimate_circulant_mp(bank: CirculantBankMP, r: torch.Tensor,
                          mode: Union[str, int, float] = "all",
                          chunk_size: int = 8192, blocks=None,
                          method: str = "fft") -> torch.Tensor:
    """Estimate channels from multi-pilot quantized observations
    r (N, P*D) -> (N, D) through the per-bin P x P bank, with the posterior
    semantics and selection modes of `gmm_estimator.estimate`:
    O(N (K D P^2 + P D log D)) against the dense path's O(N K D^2 P).
    `method` as in `estimate_circulant`; the kernel K10 is
    `estimators.mp_circ_kernels.estimate_fused_circulant_mp`, reached
    through `harness.stages.estimate_circulant`."""
    pin_fp32()
    method = _check_method(method)
    bank_c, rc = _mp_split(bank, r)
    mc = _mp_consts(bank_c)
    out = []
    for i0 in range(0, r.shape[0], chunk_size):
        u = _fwd(rc[i0:i0 + chunk_size], blocks, method)   # per pilot segment
        proba = torch.softmax(_mp_logits(mc, u), dim=-1)
        w = _selection_weights(proba, mode)
        out.append(_inv(_mp_combine(bank_c, w, u), blocks, method))
    if not out:
        return r.new_zeros((0, bank.bias_f.shape[1]))
    return torch.cat(out).to(r.dtype)


def _mp_block_logits(bank: CirculantBankMP, mc: _MpConsts, u: torch.Tensor):
    """Per-snapshot logits lp3 (B, T, K) of blocks u (B, T, P, D) and their
    block sums (B, K). `_mp_logits` holds the log-weight through const_k;
    the block posterior counts it once, so the sum drops the T - 1 extras."""
    b, t, p, d = u.shape
    lp3 = _mp_logits(mc, u.reshape(b * t, p, d)).reshape(b, t, -1)
    lw = torch.clamp(bank.log_weights, min=-1e30)
    return lp3, lp3.sum(1) - (t - 1) * lw[None, :]


def estimate_circulant_mp_coherent(bank: CirculantBankMP, r: torch.Tensor,
                                   mode: Union[str, int, float] = "all",
                                   chunk_size: int = 2048,
                                   alpha: float = 1.0, blocks=None,
                                   method: str = "fft") -> torch.Tensor:
    """Joint estimation of coherence blocks r (B, T, P*D) -> (B, T, D)
    through the multi-pilot bank: the coherent analog of
    `estimate_circulant_mp`, with the block-pooled posterior and the
    leave-one-out alpha blend of `gmm_estimator.estimate_coherent`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, P*D) blocks, got "
                         f"{tuple(r.shape)}")
    pin_fp32()
    method = _check_method(method)
    bank_c, rc = _mp_split(bank, r)
    mc = _mp_consts(bank_c)
    t, d = r.shape[1], bank.bias_f.shape[1]
    out = []
    for i0 in range(0, r.shape[0], chunk_size):
        u = _fwd(rc[i0:i0 + chunk_size], blocks, method)      # (b, T, P, D)
        lp3, lp_sum = _mp_block_logits(bank_c, mc, u)
        if alpha >= 1.0:
            w = _selection_weights(torch.softmax(lp_sum, dim=-1), mode)
            w = w[:, None, :].expand(-1, t, -1)
        else:
            lg = lp3 + alpha * (lp_sum[:, None, :] - lp3)
            w = _selection_weights(torch.softmax(lg, dim=-1), mode)
        h_f = _mp_combine(bank_c, w.reshape(-1, w.shape[-1]),
                          u.reshape((-1,) + u.shape[2:]))
        out.append(_inv(h_f.reshape(-1, t, d), blocks, method))
    if not out:
        return r.new_zeros((0, t, d))
    return torch.cat(out).to(r.dtype)


def estimate_circulant_mp_stats(bank: CirculantBankMP, r: torch.Tensor,
                                chunk_size: int = 8192, blocks=None,
                                method: str = "fft"):
    """'all'-mode estimation state (m (N,), den (N,), acc (N, D) complex in
    the DFT domain) of a (component shard of a) multi-pilot bank: the
    analog of `estimate_circulant_stats`, with the same merge semantics
    (`circ_kernels.merge_stats`, then one `unitary_ifft` of the quotient).
    The row constant -PD log pi inside the logits is the same in every
    shard, so it cancels in any normalized merge."""
    pin_fp32()
    method = _check_method(method)
    bank_c, rc = _mp_split(bank, r)
    mc = _mp_consts(bank_c)
    parts = []
    for i0 in range(0, r.shape[0], chunk_size):
        u = _fwd(rc[i0:i0 + chunk_size], blocks, method)
        lp = _mp_logits(mc, u)
        m = lp.max(-1).values
        p_ = torch.exp(lp - m[:, None])
        parts.append((m, p_.sum(-1), _mp_combine(bank_c, p_, u)))
    return tuple(torch.cat(x) for x in zip(*parts))


def estimate_circulant_mp_coherent_stats(bank: CirculantBankMP,
                                         r: torch.Tensor,
                                         chunk_size: int = 2048,
                                         alpha: float = 1.0, blocks=None,
                                         method: str = "fft"):
    """Block estimation state of a (shard of a) multi-pilot bank over
    coherence blocks r (B, T, P*D): per-block (m, den) at alpha = 1,
    per-snapshot below, acc (B, T, D) complex in the DFT domain; the merge
    semantics of `estimate_circulant_coherent_stats`."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, P*D) blocks, got "
                         f"{tuple(r.shape)}")
    pin_fp32()
    method = _check_method(method)
    bank_c, rc = _mp_split(bank, r)
    mc = _mp_consts(bank_c)
    t, d = r.shape[1], bank.bias_f.shape[1]
    parts = []
    for i0 in range(0, r.shape[0], chunk_size):
        u = _fwd(rc[i0:i0 + chunk_size], blocks, method)
        lp3, lp_sum = _mp_block_logits(bank_c, mc, u)
        lg = lp_sum if alpha >= 1.0 \
            else lp3 + alpha * (lp_sum[:, None, :] - lp3)
        m = lg.max(-1).values                  # (b,) or (b, T)
        p_ = torch.exp(lg - m[..., None])
        pf = p_[:, None, :].expand(-1, t, -1) if alpha >= 1.0 else p_
        acc = _mp_combine(bank_c, pf.reshape(-1, pf.shape[-1]),
                          u.reshape((-1,) + u.shape[2:]))
        parts.append((m, p_.sum(-1), acc.reshape(-1, t, d)))
    return tuple(torch.cat(x) for x in zip(*parts))
