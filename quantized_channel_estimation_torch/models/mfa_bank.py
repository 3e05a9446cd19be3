"""Factored (low-rank + diagonal) prepared banks: MFA-Bussgang estimation
that never densifies the factor model.

Port of `quantized_channel_estimation_tpu/models/mfa_bank.py`:
`FactoredBank`, `prepare_bank_factored` (inf and n-bit; 1-bit refused, or
the opt-in `one_bit='linear-arcsine'`), `_forward`, `_log_prob`,
`_combine`, `estimate_factored` (every selection mode),
`estimate_factored_coherent` (with the alpha blend),
`estimate_factored_stats`, `estimate_factored_coherent_stats`, plus
`bank_from_numpy`, which carries a JAX bank across.

For the single scaled-identity pilot A = x0 I and the MFA channel
covariance Ch = Lambda Lambda^H + diag(psi) (Lambda D x M, M << D):

  Cy = |x0|^2 Ch + sigma^2 I = U U^H + diag(d),  U = x0 Lambda,
                                                 d = |x0|^2 psi + sigma^2
  Cr = V V^H + diag(e):  V = U, e = d                         [inf bits]
                         V = b U, e = d + (1 - b^2) rowsum|U|^2  [n bit]

so Cr stays low-rank plus diagonal and every estimator quantity goes
through the Woodbury identity: Cr^{-1} = diag(1/e) - T^H T with
T = L^{-1} V^H diag(1/e), inner = I + V^H diag(1/e) V = L L^H. With
c = conj(x0) g the per-sample estimate is

  W r = Lambda gamma + (psi c / e) o r - R beta,
        beta = T r,  gamma = P2 r,
        P2 = Lambda^H diag(c / e) - (Lambda^H diag(c) T^H) T,
        R  = diag(psi c) T^H,

O(K D M) a sample against the dense bank's O(K D^2), and a bank of
O(K D M) memory. 1-bit quantization does not keep the low rank (the
arcsine law is elementwise in the matrix entries): it is refused unless
`one_bit='linear-arcsine'` asks for the first-order expansion
arcsin(x) ~ x, which stays in the class (V = g o U rowwise,
e = g^2 d + 1 - 2/pi).

This module is the plain `torch.matmul` pipeline. The hand-written kernels
K11-K13 live a layer up in `estimators.fact_kernels`, and the one rule that
sends an 'all'-mode request to them is `harness.stages.estimate_factored`
/ `estimate_factored_coherent`. The JAX pipeline casts the selection
weights to float32 (`mfa_bank.py:255, 312, 318`) and the bank's
`inv_e`, `logdet` and `log_weights` to float32; the port computes in the
promoted type of the bank and the request.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from quantized_channel_estimation_torch.models.gmm_estimator import (
    _selection_weights)
from quantized_channel_estimation_torch.models.mfa import MfaParams
from quantized_channel_estimation_torch.models.structured_bank import (
    _pilot_scalar)
from quantized_channel_estimation_torch.ops.bussgang import bussgang_gain_diag
from quantized_channel_estimation_torch.ops.cplx import (
    cmatmul_realout, rcmatmul, real_dtype_of)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits)


class FactoredBank(NamedTuple):
    """Per-SNR prepared bank for rank-M + diagonal component covariances.
    K components, D dims, M latent rank; every field is O(K D M)."""
    log_weights: torch.Tensor  # (K,) real; dead components at -inf
    means_r: torch.Tensor      # (K, D) complex: Bussgang-domain obs means
    inv_e: torch.Tensor        # (K, D) real: 1/e, Cr's diagonal inverted
    t_mat: torch.Tensor        # (K, M, D) complex: T = L^-1 V^H diag(1/e)
    t_mu: torch.Tensor         # (K, M) complex: T means_r
    logdet: torch.Tensor       # (K,) real: log det Cr
    lam_t: torch.Tensor        # (K, M, D) complex: Lambda^T
    p2_mat: torch.Tensor       # (K, M, D) complex: Lam^H diag(c/e) - Q T
    r_t: torch.Tensor          # (K, M, D) complex: rows (psi c) * conj(T)
    a1: torch.Tensor           # (K, D) complex: psi c / e
    bias: torch.Tensor         # (K, D) complex: mu - W mu_r


def bank_from_numpy(bank, device=None) -> FactoredBank:
    """The JAX package's `FactoredBank` (any 11-sequence in field order) as
    numpy arrays -> the port's, on `device`."""
    return FactoredBank(*(torch.as_tensor(np.array(x), device=device)
                          for x in bank))


def prepare_bank_factored(params: MfaParams, snr_db, a, n_bits,
                          q: Optional[ScalarQuantizer] = None,
                          jitter: float = 1e-6,
                          weight_floor_rel: float = 1e-2,
                          one_bit: str = "reject") -> FactoredBank:
    """Factored analog of `gmm_estimator.prepare_bank` for MFA parameters
    and a scaled-identity pilot (a scalar x0 or an x0 I matrix): the same
    Bussgang observation model (per-entry diagonal gains, scalar-beta n-bit
    Cr) and the same dead-component weight floor, in O(K D M^2) work."""
    if not is_inf_bits(n_bits) and n_bits == 1 \
            and one_bit != "linear-arcsine":
        raise ValueError(
            "factored MFA banks do not support exact 1-bit quantization: "
            "the arcsine law is elementwise in the matrix entries and "
            "destroys the low-rank structure. Densify with "
            "mfa.to_gmm_params + gmm_estimator.prepare_bank, or pass "
            "one_bit='linear-arcsine' for the O(rho^3) approximation that "
            "keeps the factored form.")
    pin_fp32()
    lam = params.lambdas
    k, d, m = lam.shape
    dtype, rdt = lam.dtype, real_dtype_of(lam.dtype)
    x0 = _pilot_scalar(a, d).to(lam.device, dtype)
    # sigma^2 as the JAX package computes it, in float32
    sigma2 = torch.tensor(10.0 ** (-float(snr_db) / 10.0),
                          dtype=torch.float32).item()
    psis = params.psis.to(rdt)
    u = x0 * lam                                            # (K, D, M)
    uu = (u.abs() ** 2).sum(-1)                             # (K, D) real
    dvec = x0.abs() ** 2 * psis + sigma2
    diag_cy = uu + dvec
    if is_inf_bits(n_bits):
        gains = torch.ones_like(diag_cy)
        v, e = u, dvec
    elif n_bits == 1:
        # linear-arcsine: V = g o U, e = g^2 d + 1 - 2/pi with the exact
        # per-entry 1-bit Bussgang gains
        gains = bussgang_gain_diag(diag_cy, 1)
        v = gains[..., None].to(dtype) * u
        e = gains ** 2 * dvec + (1.0 - 2.0 / math.pi)
    else:
        gains = bussgang_gain_diag(diag_cy, n_bits, q)
        beta = torch.clamp(gains.mean(-1), 0.0, 1.0)
        v = beta[:, None, None].to(dtype) * u
        e = dvec + (1.0 - beta[:, None] ** 2) * uu
    e = e + jitter
    inv_e = 1.0 / e

    # Woodbury pieces: inner = I + V^H E^-1 V has eigenvalues >= 1
    vh_e = v.mH * inv_e[:, None, :].to(dtype)              # (K, M, D)
    inner = torch.eye(m, dtype=dtype, device=lam.device) + vh_e @ v
    chol = torch.linalg.cholesky(0.5 * (inner + inner.mH))
    t_mat = torch.linalg.solve_triangular(chol, vh_e, upper=False)
    logdet = (torch.log(e).sum(-1)
              + 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                               dim2=-1).real).sum(-1))

    mu_r = gains.to(dtype) * (x0 * params.means.to(dtype))  # (K, D)
    t_mu = torch.einsum("kmd,kd->km", t_mat, mu_r)

    # W = Ch diag(c) Cr^-1 with c = conj(x0) g: gamma = P r - Q (T r) is
    # linear in r, so Q folds into the forward matrix once here
    c = x0.conj() * gains.to(dtype)                         # (K, D)
    lam_t = lam.transpose(-1, -2)                           # (K, M, D)
    p_mat = lam_t.conj() * (c * inv_e)[:, None, :]
    q_mat = torch.einsum("kmd,kpd->kmp", lam_t.conj() * c[:, None, :],
                         t_mat.conj())
    p2_mat = p_mat - q_mat @ t_mat
    r_t = (psis.to(dtype) * c)[:, None, :] * t_mat.conj()
    a1 = psis.to(dtype) * c * inv_e

    # bias = mu - W mu_r through the same factored apply
    g_mu = torch.einsum("kmd,kd->km", p2_mat, mu_r)
    w_mu = (torch.einsum("kmd,km->kd", lam_t, g_mu) + a1 * mu_r
            - torch.einsum("kmd,km->kd", r_t, t_mu))
    bias = params.means.to(dtype) - w_mu

    weights = params.weights.to(rdt)
    floor = weight_floor_rel / k
    logw = torch.where(weights >= floor,
                       torch.log(torch.clamp(weights, min=floor)),
                       torch.full_like(weights, -math.inf))
    return FactoredBank(logw, mu_r, inv_e, t_mat, t_mu, logdet,
                        lam_t.contiguous(), p2_mat, r_t, a1, bias)


def _cast(bank: FactoredBank, r: torch.Tensor):
    """Observations in the promoted complex type of the request and the
    bank."""
    return r.to(torch.promote_types(r.dtype, bank.t_mat.dtype))


def _forward(bank: FactoredBank, r: torch.Tensor):
    """The two forward GEMMs shared by responsibilities and combine:
    beta = T r (n, K, M) and gamma = P2 r (n, K, M)."""
    k, m, d = bank.t_mat.shape
    beta = (r @ bank.t_mat.reshape(k * m, d).T).reshape(-1, k, m)
    gamma = (r @ bank.p2_mat.reshape(k * m, d).T).reshape(-1, k, m)
    return beta, gamma


def _log_prob(bank: FactoredBank, r: torch.Tensor, beta: torch.Tensor,
              with_const: bool = True) -> torch.Tensor:
    """log CN(r; mu_r, Cr) (n, K) through the Woodbury quadratic form,
    reusing the forward beta GEMM: the diag(1/e) part expanded minus
    |T (r - mu)|^2."""
    d = r.shape[-1]
    inv_e = bank.inv_e.to(r.real.dtype)
    a_term = (r.real ** 2 + r.imag ** 2) @ inv_e.T
    cm = (bank.means_r.conj() * inv_e).T                    # (D, K)
    cross = cmatmul_realout(r, cm)                          # (n, K)
    mu2 = (bank.means_r.abs() ** 2 * inv_e).sum(-1)
    b_term = ((beta - bank.t_mu[None]).abs() ** 2).sum(-1)
    quad = a_term - 2.0 * cross + mu2[None, :] - b_term
    lp = -bank.logdet[None, :] - quad
    if with_const:
        lp = lp - d * math.log(math.pi)
    return lp


def _combine(bank: FactoredBank, r: torch.Tensor, w: torch.Tensor,
             beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """h = sum_k w_k (bias_k + W_k r): the two (n, K M) x (K M, D) combine
    GEMMs plus the (n, K) bias and diagonal combines. w may be a posterior,
    selection weights or un-normalised online-softmax weights."""
    n = r.shape[0]
    k, m, d = bank.lam_t.shape
    wr = w.to(r.real.dtype)
    wc = wr.to(gamma.dtype)
    h = rcmatmul(wr, bank.bias) + rcmatmul(wr, bank.a1) * r
    h = h + (wc[:, :, None] * gamma).reshape(n, k * m) \
        @ bank.lam_t.reshape(k * m, d)
    return h - (wc[:, :, None] * beta).reshape(n, k * m) \
        @ bank.r_t.reshape(k * m, d)


def _estimate_chunk(bank: FactoredBank, r: torch.Tensor, mode):
    beta, gamma = _forward(bank, r)
    lp = _log_prob(bank, r, beta)
    proba = torch.softmax(lp + bank.log_weights[None, :], dim=-1)
    return _combine(bank, r, _selection_weights(proba, mode), beta, gamma)


def estimate_factored(bank: FactoredBank, r: torch.Tensor,
                      mode: Union[str, int, float] = "all",
                      chunk_size: int = 4096) -> torch.Tensor:
    """Estimate channels from quantized observations r (N, D) -> (N, D)
    through the factored bank, chunked over samples: the structured analog
    of `gmm_estimator.estimate` (the same posterior semantics and selection
    modes; equal to the dense estimator to rounding, the Woodbury form
    being exact algebra)."""
    pin_fp32()
    rc = _cast(bank, r)
    out = [_estimate_chunk(bank, rc[i0:i0 + chunk_size], mode)
           for i0 in range(0, r.shape[0], chunk_size)]
    if not out:
        return r.new_zeros((0, bank.t_mat.shape[-1]))
    return torch.cat(out).to(r.dtype)


def _block_logits(bank: FactoredBank, rf: torch.Tensor, beta, b: int, t: int,
                  with_const: bool = True):
    lp3 = _log_prob(bank, rf, beta, with_const).reshape(b, t, -1)
    return lp3, lp3.sum(1)


def _estimate_coherent_chunk(bank: FactoredBank, r: torch.Tensor, mode,
                             alpha: float) -> torch.Tensor:
    """One chunk of coherence blocks r (B, T, D) -> (B, T, D): the
    block-pooled posterior and leave-one-out alpha blend of
    `gmm_estimator._estimate_coherent_chunk` (alpha = 0 is the independent
    per-snapshot estimator) with the factored likelihood and combine."""
    b, t, d = r.shape
    rf = r.reshape(b * t, d)
    beta, gamma = _forward(bank, rf)
    lp3, lp_sum = _block_logits(bank, rf, beta, b, t)
    if alpha >= 1.0:
        proba = torch.softmax(lp_sum + bank.log_weights[None, :], dim=-1)
        wf = _selection_weights(proba, mode).repeat_interleave(t, dim=0)
    else:
        lg = lp3 + alpha * (lp_sum[:, None, :] - lp3) \
            + bank.log_weights[None, None, :]
        wf = _selection_weights(torch.softmax(lg, dim=-1), mode).reshape(
            b * t, -1)
    return _combine(bank, rf, wf, beta, gamma).reshape(b, t, -1)


def estimate_factored_coherent(bank: FactoredBank, r: torch.Tensor,
                               mode: Union[str, int, float] = "all",
                               chunk_size: int = 1024,
                               alpha: float = 1.0) -> torch.Tensor:
    """Joint estimation of coherence blocks r (B, T, D) -> (B, T, D)
    through the factored bank, with the alpha evidence blend: the
    structured analog of `gmm_estimator.estimate_coherent`. Chunked over
    blocks."""
    if r.dim() != 3:
        raise ValueError(f"estimate_factored_coherent expects (B, T, D) "
                         f"blocks, got shape {tuple(r.shape)}")
    pin_fp32()
    rc = _cast(bank, r)
    out = [_estimate_coherent_chunk(bank, rc[i0:i0 + chunk_size], mode,
                                    alpha)
           for i0 in range(0, r.shape[0], chunk_size)]
    if not out:
        return r.new_zeros(r.shape[:2] + (bank.t_mat.shape[-1],))
    return torch.cat(out).to(r.dtype)


def _stats_chunk(bank: FactoredBank, r: torch.Tensor):
    """Un-normalised online-softmax estimation state over this bank's
    components for one chunk: the row-constant -D log pi is dropped (it
    cancels in any normalised merge) and dead components clamp to
    -1e30."""
    beta, gamma = _forward(bank, r)
    lp = _log_prob(bank, r, beta, with_const=False)
    logits = lp + torch.clamp(bank.log_weights, min=-1e30)[None, :]
    m = logits.max(-1).values
    p = torch.exp(logits - m[:, None])
    return m, p.sum(-1), _combine(bank, r, p, beta, gamma)


def estimate_factored_stats(bank: FactoredBank, r: torch.Tensor,
                            chunk_size: int = 4096):
    """'all'-mode estimation state (m (N,), den (N,), acc (N, D)) of a
    (component shard of a) factored bank: states of disjoint shards merge
    with `estimators.circ_kernels.merge_stats`, and acc / den is
    `estimate_factored(bank, r, 'all')`."""
    pin_fp32()
    rc = _cast(bank, r)
    parts = [_stats_chunk(bank, rc[i0:i0 + chunk_size])
             for i0 in range(0, r.shape[0], chunk_size)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _coherent_stats_chunk(bank: FactoredBank, r: torch.Tensor,
                          alpha: float):
    """Block online-softmax state for coherence blocks r (B, T, D), in
    `_stats_chunk`'s logit convention: per-block (m, den) at alpha >= 1,
    per-snapshot below; acc (B, T, D)."""
    b, t, d = r.shape
    rf = r.reshape(b * t, d)
    beta, gamma = _forward(bank, rf)
    lp3, lp_sum = _block_logits(bank, rf, beta, b, t, with_const=False)
    lw = torch.clamp(bank.log_weights, min=-1e30)
    if alpha >= 1.0:
        logits = lw[None, :] + lp_sum                          # (B, K)
        m = logits.max(-1).values
        p = torch.exp(logits - m[:, None])
        pf = p.repeat_interleave(t, dim=0)
    else:
        lg = lw[None, None, :] + lp3 + alpha * (lp_sum[:, None, :] - lp3)
        m = lg.max(-1).values                                  # (B, T)
        p = torch.exp(lg - m[..., None])
        pf = p.reshape(b * t, -1)
    acc = _combine(bank, rf, pf, beta, gamma).reshape(b, t, -1)
    return m, p.sum(-1), acc


def estimate_factored_coherent_stats(bank: FactoredBank, r: torch.Tensor,
                                     chunk_size: int = 1024,
                                     alpha: float = 1.0):
    """Block estimation state over coherence blocks r (B, T, D): m, den
    (B,) at alpha >= 1 and (B, T) below, acc (B, T, D); states of disjoint
    component shards merge as the flat ones do."""
    if r.dim() != 3:
        raise ValueError(f"expected (B, T, D) blocks, got {tuple(r.shape)}")
    pin_fp32()
    rc = _cast(bank, r)
    parts = [_coherent_stats_chunk(bank, rc[i0:i0 + chunk_size], alpha)
             for i0 in range(0, r.shape[0], chunk_size)]
    return tuple(torch.cat(x) for x in zip(*parts))
