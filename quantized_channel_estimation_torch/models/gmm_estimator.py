"""GMM-Bussgang channel estimation: per-component LMMSE with responsibility
weighting.

Port of `quantized_channel_estimation_tpu/models/gmm_estimator.py`
(`PreparedBank`, `prepare_bank`, `responsibilities`, `_selection_weights`,
`estimate` in 'all' / int / float modes, `estimate_stats`). `prepare_bank`
builds an immutable per-SNR bank of observation-domain filters; `estimate`
is the plain einsum estimator, and the reference the 'all'-mode kernel
(`estimators.kernels`) is held against.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from quantized_channel_estimation_torch.models.gmm import (
    GmmParams, log_prob_full)
from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.bussgang import bank_gains_and_cov
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import ScalarQuantizer


class PreparedBank(NamedTuple):
    """Per-SNR component bank: K components, M = observation dim
    (n_pilots * N), D = channel dim."""
    log_weights: torch.Tensor  # (K,)
    means_r: torch.Tensor      # (K, M)    Bussgang-domain observation means
    prec_chol_r: torch.Tensor  # (K, M, M) precision Cholesky of Cr
    filters: torch.Tensor      # (K, D, M) W_k = C_k A_eff_k^H Cr_k^{-1}
    bias: torch.Tensor         # (K, D)    mu_h,k - W_k means_r,k


def prepare_bank(params: GmmParams, snr_db, a: torch.Tensor, n_bits,
                 q: Optional[ScalarQuantizer] = None, jitter: float = 1e-6,
                 weight_floor_rel: float = 1e-2) -> PreparedBank:
    """Bussgang-linearized observation-domain bank:

      Cy_k  = A C_k A^H + sigma^2 I,   B_k = diagonal Bussgang gain of Cy_k
      mu_r  = B_k A mu_k,              Cr_k = Bussgang Cr model of Cy_k
      W_k   = C_k (B_k A)^H Cr_k^{-1}

    Components whose weight is below weight_floor_rel / K get log-weight
    -inf: a collapsed EM fit can leave near-empty components whose
    degenerate Cr models would otherwise win responsibilities at high SNR.
    """
    pin_fp32()
    sigma2 = 10.0 ** (-float(snr_db) / 10.0)
    covs = params.covariances
    dtype = covs.dtype
    m = a.shape[0]
    eye = torch.eye(m, dtype=dtype, device=covs.device)
    cy = a @ covs @ a.conj().T
    cy = cy + torch.tensor(sigma2, dtype=torch.float32).item() * eye
    a_mu = params.means @ a.T
    gains, cr = bank_gains_and_cov(cy, n_bits, q)
    means_r = gains.to(dtype) * a_mu
    a_eff = gains[..., :, None].to(dtype) * a             # (K, M, N)
    chol = linalg.chol_lower(linalg.add_jitter(cr, jitter))
    prec_chol = linalg.prec_from_chol(chol)
    # W_k = C_k A_eff^H Cr^{-1}: solve Cr X = A_eff C_k^H, W = X^H
    cah = covs @ a_eff.mH                                 # (K, N, M)
    y = torch.linalg.solve_triangular(chol, cah.mH, upper=False)
    x = torch.linalg.solve_triangular(chol.mH, y, upper=True)
    filters = x.mH                                        # (K, D, M)
    bias = params.means - (filters @ means_r[..., None])[..., 0]
    floor = weight_floor_rel / params.weights.shape[0]
    logw = torch.where(params.weights >= floor,
                       torch.log(torch.clamp(params.weights, min=floor)),
                       torch.full_like(params.weights, -math.inf))
    return PreparedBank(logw, means_r, prec_chol, filters, bias)


def responsibilities(bank: PreparedBank, r: torch.Tensor) -> torch.Tensor:
    """Posterior component probabilities of quantized observations (N, K)."""
    lp = log_prob_full(r, bank.means_r, bank.prec_chol_r) \
        + bank.log_weights[None, :]
    return torch.softmax(lp, dim=-1)


def _selection_weights(proba: torch.Tensor, mode) -> torch.Tensor:
    """Dense selection weights of the `n_summands_or_proba` modes:
    'all' the full posterior; int 1 the argmax one-hot; int k > 1 the top-k
    renormalized; float p the smallest prefix of the sorted posterior with
    cumulative probability >= p, renormalized."""
    k = proba.shape[-1]
    if mode == "all":
        return proba
    if isinstance(mode, int):
        if mode == 1:
            return torch.nn.functional.one_hot(
                proba.argmax(-1), k).to(proba.dtype)
        kth = torch.topk(proba, mode, dim=-1).values[..., -1:]
        sel = proba * (proba >= kth)
        return sel / sel.sum(-1, keepdim=True)
    order = torch.argsort(-proba, dim=-1, stable=True)
    sorted_p = torch.gather(proba, -1, order)
    csum = torch.cumsum(sorted_p, dim=-1)
    include_sorted = torch.cat(
        [torch.ones_like(csum[..., :1], dtype=torch.bool),
         csum[..., :-1] < mode], dim=-1)
    mask = torch.gather(include_sorted, -1, torch.argsort(order, dim=-1))
    sel = proba * mask
    return sel / sel.sum(-1, keepdim=True)


def _component_estimates(bank: PreparedBank, r: torch.Tensor) -> torch.Tensor:
    """Per-component estimates b_k + W_k r_n, one stacked GEMM -> (n, K, D)."""
    k, d, m = bank.filters.shape
    z = (r @ bank.filters.reshape(k * d, m).T).reshape(r.shape[0], k, d)
    return z + bank.bias[None, :, :]


def estimate(bank: PreparedBank, r: torch.Tensor,
             mode: Union[str, int, float] = "all",
             chunk_size: int = 2048) -> torch.Tensor:
    """h_n = sum_k w_k(r_n) (mu_k + W_k (r_n - mu_r,k)) for r (N, M) ->
    (N, D), chunked over samples to bound the (chunk, K, D) intermediate."""
    pin_fp32()
    out = []
    for i0 in range(0, r.shape[0], chunk_size):
        rc = r[i0:i0 + chunk_size]
        w = _selection_weights(responsibilities(bank, rc), mode).to(r.dtype)
        out.append(torch.einsum("nk,nkd->nd", w,
                                _component_estimates(bank, rc)))
    return torch.cat(out)


def estimate_stats(bank: PreparedBank, r: torch.Tensor,
                   chunk_size: int = 2048):
    """'all'-mode online-softmax state (m (N,), den (N,), acc (N, D)) of a
    (shard of a) bank, with the kernel's logit convention
    logw_k + 2 sum log diag(P_k) - |r conj(P_k) - mu~_k|^2 (the row constant
    -M log pi dropped) and dead components clamped to -1e30; acc / den is
    `estimate(bank, r, 'all')`."""
    pin_fp32()
    pc = bank.prec_chol_r.conj()
    mu = torch.matmul(bank.means_r[:, None, :], pc)[:, 0]          # (K, M)
    diag = torch.diagonal(bank.prec_chol_r, dim1=-2, dim2=-1).real
    logw = torch.clamp(bank.log_weights + 2.0 * torch.log(diag).sum(-1),
                       min=-1e30)
    ms, dens, accs = [], [], []
    for i0 in range(0, r.shape[0], chunk_size):
        rc = r[i0:i0 + chunk_size]
        y = torch.matmul(rc[None], pc)                               # (K,n,M)
        quad = ((y - mu[:, None, :]).abs() ** 2).sum(-1).T           # (n, K)
        logits = (logw[None, :] - quad).to(torch.float32)
        mx = logits.max(-1).values
        p = torch.exp(logits - mx[:, None])
        z = _component_estimates(bank, rc)
        ms.append(mx)
        dens.append(p.sum(-1))
        accs.append(torch.einsum("nk,nkd->nd", p.to(z.dtype), z))
    return torch.cat(ms), torch.cat(dens), torch.cat(accs)
