"""Complex Gaussian mixture model fitted by EM (full covariance).

Port of `quantized_channel_estimation_tpu/models/gmm.py`, 'full' covariance
only: `GmmConfig`, `GmmParams`, `GmmFitResult`, `log_prob_full`,
`accumulate_stats`, `_m_step_full`, `_init_resp_stats`, `_em_loop`, `fit`
and `predict_proba`. E and M are fused into one chunked pass over the data
that accumulates the sufficient statistics (Nk, sum r.x, sum r.xx^H); the
EM loop is a Python loop with the JAX stopping rule (|change of the mean
log-likelihood| < tol, at least one iteration). The other covariance types
raise `NotImplementedError` (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from quantized_channel_estimation_torch.models.kmeans import kmeans
from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.cplx import (
    cplx2real, real_dtype_of)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

_F32_EPS = float(np.finfo(np.float32).eps)


class GmmConfig(NamedTuple):
    n_components: int
    cov_type: str = "full"
    blocks: Optional[Tuple[int, int]] = None
    zero_mean: bool = True
    max_iter: int = 100     # sklearn GaussianMixture defaults
    tol: float = 1e-3
    reg_covar: float = 1e-5  # the JAX float32 floor (see its GmmConfig)
    chunk_size: int = 4096  # E/M pass chunk (memory knob, no math effect)
    kmeans_iter: int = 50
    init: str = "kmeans"    # 'kmeans' | 'random'
    n_init: int = 1         # EM restarts, best lower bound kept


class GmmParams(NamedTuple):
    """Full-covariance complex GMM parameters."""
    weights: torch.Tensor      # (K,) real
    means: torch.Tensor        # (K, D) complex
    covariances: torch.Tensor  # (K, D, D) complex
    prec_chol: torch.Tensor    # (K, D, D) complex upper; C^{-1} = P P^H

    @property
    def n_components(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[-1]


class GmmFitResult(NamedTuple):
    params: GmmParams
    lower_bound: torch.Tensor  # mean per-sample log-likelihood at the end
    n_iter: int
    converged: bool
    lb_history: List[float]    # lower bound after each EM iteration


def params_from_numpy(params, device=None) -> GmmParams:
    """The JAX package's `GmmParams` as numpy arrays (any 4-sequence
    weights, means, covariances, prec_chol), or the path of the npz its
    `utils.io.save_pytree_npz` writes, -> port `GmmParams` on `device`."""
    if isinstance(params, (str, os.PathLike)):
        from quantized_channel_estimation_torch.utils.io import load_gmm_arrays
        params = load_gmm_arrays(params)
    return GmmParams(*(torch.as_tensor(np.asarray(p), device=device)
                       for p in params))


def log_prob_full(x: torch.Tensor, means: torch.Tensor,
                  prec_chol: torch.Tensor) -> torch.Tensor:
    """log CN(x; mu_k, C_k) for x (N, D) -> (N, K):
    -(D log pi + |(x - mu)^H P|^2) + 2 sum log diag(P)."""
    d = x.shape[-1]
    pc = prec_chol.conj()
    xp = torch.matmul(x[None], pc)                       # (K, N, D)
    mp = torch.matmul(means[:, None, :], pc)             # (K, 1, D)
    quad = ((xp - mp).abs() ** 2).sum(-1)                # (K, N)
    logdet = linalg.logdet_from_prec_chol(prec_chol)     # (K,)
    return (-(d * math.log(math.pi) + quad) + 2.0 * logdet[:, None]).T


class _Stats(NamedTuple):
    nk: torch.Tensor        # (K,)
    sx: torch.Tensor        # (K, D) complex: sum_n r_nk x_n
    sxx: torch.Tensor       # (K, D, D) complex: sum_n r_nk x_n x_n^H
    log_norm: torch.Tensor  # scalar: sum_n log p(x_n)


def _zero_stats(k: int, d: int, dtype, device) -> _Stats:
    rdt = real_dtype_of(dtype)
    return _Stats(torch.zeros(k, dtype=rdt, device=device),
                  torch.zeros((k, d), dtype=dtype, device=device),
                  torch.zeros((k, d, d), dtype=dtype, device=device),
                  torch.zeros((), dtype=rdt, device=device))


def _update_stats(stats: _Stats, resp: torch.Tensor, xc: torch.Tensor,
                  log_norm_inc=0.0) -> _Stats:
    """Add one chunk's responsibility-weighted moments."""
    respd = resp.to(xc.dtype)
    sxx = torch.einsum("nk,nd,ne->kde", respd, xc, xc.conj())
    return _Stats(stats.nk + resp.sum(0), stats.sx + respd.T @ xc,
                  stats.sxx + sxx, stats.log_norm + log_norm_inc)


def accumulate_stats(x: torch.Tensor, log_weights: torch.Tensor, log_prob_fn,
                     chunk: int) -> _Stats:
    """One pass over the data: responsibilities chunk by chunk, accumulated
    into (Nk, sum r.x, sum r.xx^H, sum log-norm)."""
    stats = _zero_stats(log_weights.shape[0], x.shape[-1], x.dtype, x.device)
    for i0 in range(0, x.shape[0], chunk):
        xc = x[i0:i0 + chunk]
        lp = log_prob_fn(xc) + log_weights[None, :]
        log_norm = torch.logsumexp(lp, dim=-1)
        resp = torch.exp(lp - log_norm[:, None])
        stats = _update_stats(stats, resp, xc, log_norm.sum())
    return stats


def _m_step_full(stats: _Stats, cfg: GmmConfig):
    nk = stats.nk + 10.0 * _F32_EPS
    means = stats.sx / nk[:, None].to(stats.sx.dtype)
    if cfg.zero_mean:
        means = torch.zeros_like(means)
    # sum r (x-mu)(x-mu)^H = sxx - nk mu mu^H when mu is the weighted mean
    covs = stats.sxx / nk[:, None, None].to(stats.sxx.dtype)
    if not cfg.zero_mean:
        covs = covs - means[:, :, None] * means[:, None, :].conj()
    return nk, means, linalg.add_jitter(covs, cfg.reg_covar)


def _stats_from_labels(x: torch.Tensor, labels: torch.Tensor, k: int,
                       chunk: int) -> _Stats:
    """Sufficient statistics of a hard assignment (one-hot
    responsibilities)."""
    stats = _zero_stats(k, x.shape[-1], x.dtype, x.device)
    rdt = stats.nk.dtype
    for i0 in range(0, x.shape[0], chunk):
        onehot = torch.nn.functional.one_hot(labels[i0:i0 + chunk], k)
        stats = _update_stats(stats, onehot.to(rdt), x[i0:i0 + chunk])
    return stats


def _init_resp_stats(gen: torch.Generator, x: torch.Tensor, cfg: GmmConfig,
                     chunk: int) -> _Stats:
    """Initial responsibilities folded into sufficient statistics:
    init='kmeans' is the hard assignment of k-means on [Re, Im]-stacked
    float32 data; init='random' draws rows of U(0,1) normalized to sum 1."""
    k = cfg.n_components
    if cfg.init == "random":
        stats = _zero_stats(k, x.shape[-1], x.dtype, x.device)
        for i0 in range(0, x.shape[0], chunk):
            xc = x[i0:i0 + chunk]
            resp = torch.rand((xc.shape[0], k), generator=gen,
                              dtype=stats.nk.dtype, device=gen.device)
            resp = (resp / resp.sum(-1, keepdim=True)).to(x.device)
            stats = _update_stats(stats, resp, xc)
        return stats
    labels = kmeans(gen, cplx2real(x, dim=-1).to(torch.float32), k,
                    max_iter=cfg.kmeans_iter).labels
    return _stats_from_labels(x, labels, k, chunk)


class _State(NamedTuple):
    weights: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor


def _params_from_stats(stats: _Stats, cfg: GmmConfig) -> _State:
    nk, means, covs = _m_step_full(stats, cfg)
    return _State(nk / nk.sum(), means, covs)


def _em_loop(x: torch.Tensor, init_stats: _Stats, cfg: GmmConfig):
    """Full-covariance EM from initial statistics. Returns (state,
    lower_bound, n_iter, converged, lb_history)."""
    n = x.shape[0]
    chunk = min(cfg.chunk_size, n)
    state = _params_from_stats(init_stats, cfg)
    rdt = init_stats.nk.dtype
    # lower bound -inf and previous +inf: the first check sees an infinite
    # change, so the loop always runs at least one iteration
    lb = torch.tensor(-math.inf, dtype=rdt, device=x.device)
    prev = torch.tensor(math.inf, dtype=rdt, device=x.device)
    n_iter, history = 0, []
    while n_iter < cfg.max_iter and bool((lb - prev).abs() >= cfg.tol):
        prec = linalg.robust_precision_cholesky(state.covs)
        means = state.means
        stats = accumulate_stats(
            x, torch.log(state.weights),
            lambda xc: log_prob_full(xc, means, prec), chunk)
        state = _params_from_stats(stats, cfg)
        prev, lb = lb, stats.log_norm / n
        n_iter += 1
        history.append(float(lb))
    converged = bool((lb - prev).abs() < cfg.tol)
    return state, lb, n_iter, converged, history


def _fit_once(gen: torch.Generator, h: torch.Tensor,
              cfg: GmmConfig) -> GmmFitResult:
    if cfg.cov_type != "full":
        raise NotImplementedError(
            f"cov_type={cfg.cov_type!r} is not ported yet; the port fits "
            "'full' covariances only (ROADMAP Queue 1 item 8)")
    init_stats = _init_resp_stats(gen, h, cfg, cfg.chunk_size)
    state, lb, n_iter, converged, history = _em_loop(h, init_stats, cfg)
    covs = linalg.add_jitter(linalg.hermitize(state.covs), cfg.reg_covar)
    prec = linalg.robust_precision_cholesky(covs)
    params = GmmParams(state.weights, state.means, covs, prec)
    return GmmFitResult(params, lb, n_iter, converged, history)


def fit(gen: torch.Generator, h: torch.Tensor,
        cfg: GmmConfig) -> GmmFitResult:
    """Fit the complex GMM with EM; runs cfg.n_init restarts (successive
    draws of `gen`) and keeps the best lower bound. Matrix products run in
    full fp32 (`ops.precision.pin_fp32`): reduced-precision multiplies NaN
    the factorizations at D=64."""
    pin_fp32()
    best = _fit_once(gen, h, cfg)
    for _ in range(1, cfg.n_init):
        cand = _fit_once(gen, h, cfg)
        if bool(cand.lower_bound > best.lower_bound):
            best = cand
    return best


def predict_proba(params: GmmParams, x: torch.Tensor) -> torch.Tensor:
    """Posterior component probabilities (N, K)."""
    lp = log_prob_full(x, params.means, params.prec_chol) \
        + torch.log(params.weights)[None, :]
    return torch.softmax(lp, dim=-1)
