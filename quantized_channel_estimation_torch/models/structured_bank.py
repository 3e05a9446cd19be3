"""FFT-domain prepared banks: GMM-Bussgang estimation for (block-)circulant
component covariances, kept in the DFT eigendomain end to end.

Port of `quantized_channel_estimation_tpu/models/structured_bank.py`, the
single-pilot half: `CirculantBank`, `_pilot_scalar`, `_pilot_vector`,
`spectra_from_params`, `_prepare_circulant`, `prepare_bank_circulant`,
`unitary_fft` / `unitary_ifft`, `_dft_matrix`, `_fwd` / `_inv`,
`_log_prob_diag_split`, `estimate_circulant`,
`estimate_circulant_coherent` and the two stats forms; plus
`bank_from_numpy`, which carries a JAX `CirculantBank` across.

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
`estimators.circ_kernels`, and the one rule that sends an 'all'-mode
request to them (the JAX function's methods 'auto' and 'kernel') is
`harness.stages.estimate_circulant` / `estimate_circulant_coherent`.

Multi-pilot observations (A = kron(x, I) with P > 1, the JAX
`CirculantBankMP`) are not ported yet and raise NotImplementedError
(ROADMAP Queue 2, kernel K10).
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


def bank_from_numpy(bank, device=None) -> CirculantBank:
    """The JAX package's `CirculantBank` as numpy arrays (any 5-sequence in
    field order) -> the port's, on `device`."""
    return CirculantBank(*(torch.as_tensor(np.array(x), device=device)
                           for x in bank))


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


def prepare_bank_circulant(params: GmmParams, snr_db, a, n_bits,
                           q: Optional[ScalarQuantizer] = None,
                           jitter: float = 1e-6,
                           weight_floor_rel: float = 1e-2, blocks=None,
                           spectra: Optional[torch.Tensor] = None
                           ) -> CirculantBank:
    """Structured analog of `gmm_estimator.prepare_bank` for
    (block-)circulant component covariances and a scaled-identity pilot:
    the same Bussgang observation model and dead-component weight floor.
    `spectra` skips the extraction when the caller kept the fit's DFT
    spectra (then `params.covariances` is not read). A multi-pilot
    A = kron(x, I) with P > 1 raises NotImplementedError."""
    pin_fp32()
    d = params.means.shape[-1]
    x = _pilot_vector(a, d)
    if x.shape[0] > 1:
        raise NotImplementedError(
            "multi-pilot structured banks (CirculantBankMP, n_pilots > 1) "
            "are not ported yet (ROADMAP Queue 2, kernel K10)")
    if spectra is None:
        spectra = spectra_from_params(params, blocks)
    sigma2 = torch.tensor(10.0 ** (-float(snr_db) / 10.0),
                          dtype=torch.float32).item()
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

def _cast(bank: CirculantBank, r: torch.Tensor):
    """The bank and r in their common precision (a float64 request against
    a float32 bank computes in float64, as JAX's promotion does)."""
    cdt = torch.promote_types(r.dtype, bank.mean_rf.dtype)
    rdt = cplx.real_dtype_of(cdt)
    return CirculantBank(bank.log_weights.to(rdt), bank.mean_rf.to(cdt),
                         bank.spec_cr.to(rdt), bank.filt_f.to(cdt),
                         bank.bias_f.to(cdt)), r.to(cdt)


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


def estimate_circulant(bank: CirculantBank, r: torch.Tensor,
                       mode: Union[str, int, float] = "all",
                       chunk_size: int = 16384, blocks=None,
                       method: str = "fft") -> torch.Tensor:
    """Estimate channels from quantized observations r (N, M) -> (N, D)
    through the FFT-domain bank: the structured analog of
    `gmm_estimator.estimate`, with the same posterior semantics and
    selection modes, as a chunked pipeline with FFT ('fft') or DFT-matrix
    GEMM ('dft') transforms. The single-pass kernel K6 and the rule that
    chooses between it and this pipeline (the JAX function's 'kernel' and
    'auto' methods) are `estimators.circ_kernels.estimate_fused_circulant`
    and `harness.stages.estimate_circulant`."""
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


def estimate_circulant_coherent(bank: CirculantBank, r: torch.Tensor,
                                mode: Union[str, int, float] = "all",
                                chunk_size: int = 4096, alpha: float = 1.0,
                                blocks=None,
                                method: str = "fft") -> torch.Tensor:
    """Joint estimation of coherence blocks r (B, T, M) -> (B, T, D)
    through the FFT-domain bank: the structured analog of
    `gmm_estimator.estimate_coherent`, with the alpha evidence blend
    (alpha = 0 is the independent per-snapshot estimator). `method` as in
    `estimate_circulant`; the kernel K7 is reached through
    `harness.stages.estimate_circulant_coherent`."""
    if r.dim() != 3:
        raise ValueError(f"estimate_circulant_coherent expects (B, T, M) "
                         f"blocks, got shape {tuple(r.shape)}")
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
