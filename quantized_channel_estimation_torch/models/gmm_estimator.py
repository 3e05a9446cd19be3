"""GMM-Bussgang channel estimation: per-component LMMSE with responsibility
weighting.

Port of `quantized_channel_estimation_tpu/models/gmm_estimator.py`
(`PreparedBank`, `prepare_bank`, `responsibilities`, `_selection_weights`,
`estimate` in 'all' / int / float modes, `estimate_stats`, and for
coherence blocks `estimate_coherent`, `select_coherence_alpha`,
`estimate_coherent_stats`). `prepare_bank` builds an immutable per-SNR bank
of observation-domain filters; `estimate` and `estimate_coherent` are the
plain einsum estimators, and the references the kernels
(`estimators.kernels`) are held against.
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
        quad = _kernel_quad(bank, rc, pc, mu)
        logits = (logw[None, :] - quad).to(torch.float32)
        mx = logits.max(-1).values
        p = torch.exp(logits - mx[:, None])
        z = _component_estimates(bank, rc)
        ms.append(mx)
        dens.append(p.sum(-1))
        accs.append(torch.einsum("nk,nkd->nd", p.to(z.dtype), z))
    return torch.cat(ms), torch.cat(dens), torch.cat(accs)


def _kernel_quad(bank: PreparedBank, r: torch.Tensor, pc: torch.Tensor,
                 mu: torch.Tensor) -> torch.Tensor:
    """|r conj(P_k) - mu~_k|^2 for r (n, M) -> (n, K), with pc = conj(P)
    and mu~ = means_r conj(P) (the kernel's quadratic term)."""
    y = torch.matmul(r[None], pc)                                    # (K,n,M)
    return ((y - mu[:, None, :]).abs() ** 2).sum(-1).T


# ---------------------------------------------------------------------------
# coherence blocks
# ---------------------------------------------------------------------------

def _estimate_coherent_chunk(bank: PreparedBank, r: torch.Tensor, mode,
                             alpha: float = 1.0) -> torch.Tensor:
    """One chunk of coherence blocks r (B, T, M) -> (B, T, D). Snapshots of
    a block are independent given the component, so the per-snapshot
    log-likelihoods sum over T (the log-weight enters once per block);
    alpha < 1 is the leave-one-out blend, each snapshot keeping its own
    likelihood plus alpha times the others' (alpha = 0 is the independent
    per-snapshot posterior)."""
    b, t, m = r.shape
    rf = r.reshape(b * t, m)
    lp3 = log_prob_full(rf, bank.means_r, bank.prec_chol_r).reshape(b, t, -1)
    lp_sum = lp3.sum(1)
    k, d, _ = bank.filters.shape
    z = _component_estimates(bank, rf).reshape(b, t, k, d)
    if alpha >= 1.0:
        proba = torch.softmax(lp_sum + bank.log_weights[None, :], dim=-1)
        w = _selection_weights(proba, mode).to(r.dtype)
        return torch.einsum("bk,btkd->btd", w, z)
    lg = lp3 + alpha * (lp_sum[:, None, :] - lp3) \
        + bank.log_weights[None, None, :]
    w = _selection_weights(torch.softmax(lg, dim=-1), mode).to(r.dtype)
    return torch.einsum("btk,btkd->btd", w, z)


def estimate_coherent(bank: PreparedBank, r: torch.Tensor,
                      mode: Union[str, int, float] = "all",
                      chunk_size: int = 512,
                      alpha: float = 1.0) -> torch.Tensor:
    """Joint estimation of coherence blocks r (B, T, M) -> (B, T, D): every
    snapshot of a block is combined with the block posterior (the
    per-snapshot log-likelihoods summed over T before the softmax), or with
    the alpha blend toward the per-snapshot posterior. Equals `estimate`
    at T = 1 or alpha = 0. Chunked over blocks."""
    if r.dim() != 3:
        raise ValueError(f"estimate_coherent expects (B, T, M) blocks, got "
                         f"shape {tuple(r.shape)}; use `estimate` for flat "
                         "samples")
    pin_fp32()
    out = [_estimate_coherent_chunk(bank, r[i0:i0 + chunk_size], mode, alpha)
           for i0 in range(0, r.shape[0], chunk_size)]
    if not out:
        return r.new_zeros(r.shape[:2] + (bank.filters.shape[1],))
    return torch.cat(out)


DEFAULT_ALPHA_GRID = (0.0, 0.1, 0.25, 0.5, 1.0)


def select_coherence_alpha(est_fn, r_val, h_val, grid=DEFAULT_ALPHA_GRID):
    """Pick the evidence-blend alpha by validation NMSE: est_fn(r_blocks,
    alpha) -> (B, T, D) estimates of the held-out observations r_val
    (B, T, M) whose true channels are h_val (B, T, D). Real held-out blocks
    are needed: under the fitted mixture itself alpha = 1 is optimal by
    construction, so model-drawn blocks cannot reveal mismatch. Returns
    (best_alpha, {alpha: nmse}), NMSE as sum |e|^2 / h.size."""
    scores = {}
    for alpha in grid:
        h_hat = est_fn(r_val, float(alpha))
        h_ref = torch.as_tensor(h_val).to(h_hat.device, h_hat.dtype)
        scores[float(alpha)] = float(
            ((h_hat - h_ref).abs() ** 2).sum()) / math.prod(h_ref.shape)
    best = min(scores, key=scores.get)
    return best, scores


def _coherent_stats_chunk(bank: PreparedBank, r: torch.Tensor,
                          alpha: float = 1.0):
    """Un-normalized block online-softmax state of one chunk of blocks
    r (B, T, M), in `estimate_stats`' logit convention: the log-det term
    counts once per snapshot, the mixture log-weight (dead ones clamped to
    -1e30) once per block. alpha >= 1 gives block states m, den (B,);
    alpha < 1 the per-snapshot states m, den (B, T) of the leave-one-out
    blend. acc (B, T, D); acc / den is `estimate_coherent(..., 'all')`."""
    b, t, m = r.shape
    rf = r.reshape(b * t, m)
    pc = bank.prec_chol_r.conj()
    mu = torch.matmul(bank.means_r[:, None, :], pc)[:, 0]
    quad3 = _kernel_quad(bank, rf, pc, mu).reshape(b, t, -1)
    diag = torch.diagonal(bank.prec_chol_r, dim1=-2, dim2=-1).real
    logdet = 2.0 * torch.log(diag).sum(-1)                           # (K,)
    k, d, _ = bank.filters.shape
    z = _component_estimates(bank, rf).reshape(b, t, k, d)
    lw = torch.clamp(bank.log_weights, min=-1e30)
    if alpha >= 1.0:
        logits = (lw[None, :] + t * logdet[None, :]
                  - quad3.sum(1)).to(torch.float32)
        mx = logits.max(-1).values                                   # (B,)
        p = torch.exp(logits - mx[:, None])
        acc = torch.einsum("bk,btkd->btd", p.to(z.dtype), z)
        return mx, p.sum(-1), acc
    lp3 = logdet[None, None, :] - quad3
    logits = (lw[None, None, :] + lp3
              + alpha * (lp3.sum(1)[:, None, :] - lp3)).to(torch.float32)
    mx = logits.max(-1).values                                       # (B, T)
    p = torch.exp(logits - mx[..., None])
    acc = torch.einsum("btk,btkd->btd", p.to(z.dtype), z)
    return mx, p.sum(-1), acc


def estimate_coherent_stats(bank: PreparedBank, r: torch.Tensor,
                            chunk_size: int = 512, alpha: float = 1.0):
    """'all'-mode block estimation state (m, den, acc) of a (shard of a)
    bank over coherence blocks r (B, T, M), chunked over blocks: m, den
    (B,) at alpha >= 1 and (B, T) below, acc (B, T, D). States of disjoint
    component shards merge exactly as `estimate_stats` states do."""
    if r.dim() != 3:
        raise ValueError(f"estimate_coherent_stats expects (B, T, M) blocks,"
                         f" got shape {tuple(r.shape)}")
    pin_fp32()
    parts = [_coherent_stats_chunk(bank, r[i0:i0 + chunk_size], alpha)
             for i0 in range(0, r.shape[0], chunk_size)]
    return tuple(torch.cat(x) for x in zip(*parts))
