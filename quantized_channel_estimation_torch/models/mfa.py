"""Complex Mixture of Factor Analyzers (MFA) fitted by EM.

Port of `quantized_channel_estimation_tpu/models/mfa.py` on one device:
`MfaConfig`, `MfaParams`, `MfaFitResult`, `covariances`,
`woodbury_inverse`, `_slogdet_from_woodbury`, `_weighted_cross`, `_run_em`,
`fit`, `fit_resume` and `to_gmm_params`, plus `params_from_numpy`, which
carries a JAX fit across as numpy arrays.

Per component k: C_k = Lambda_k Lambda_k^H + diag(psi_k), Lambda_k in
C^{D x M} with latent dimension M << D. Covariance inversions go through
the Woodbury identity, so only M x M systems are formed. Since the latent
posteriors are linear in x, every M-step quantity reduces to the GMM's
sufficient statistics (Nk, sum r.x, sum r.xx^H), accumulated in one chunked
pass by `gmm.accumulate_stats`:

    sum r z        = beta (Sx - Nk mu)
    sum r x z^H    = (Sxx - Sx mu^H) beta^H
    sum r z z^H    = beta Cov(mu, mu) beta^H
    psi            = diag(Cov(mu', mu') - Lambda beta Cov(mu, mu')) / Nk

The E-step's quadratic form is factored: with inner = I + Lambda^H
Psi^{-1} Lambda = L L^H and T = L^{-1} Lambda^H Psi^{-1},
C^{-1} = Psi^{-1} - T^H T, so no (K, D, D) inverse is ever built.

The EM loop is a Python loop with the JAX stopping rule: at least six
iterations (the relative change is not read while the count is <= 5), then
until |change of the summed log-likelihood| / |log-likelihood| < tol.
`axis_name` and `psum_segments` other than their single-device values raise
NotImplementedError (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from quantized_channel_estimation_torch.models import gmm as gmm_mod
from quantized_channel_estimation_torch.models.gmm import GmmParams
from quantized_channel_estimation_torch.models.kmeans import kmeans
from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.cplx import (
    cplx2real, real_dtype_of)
from quantized_channel_estimation_torch.ops.precision import pin_fp32

_F32_EPS = float(np.finfo(np.float32).eps)


class MfaConfig(NamedTuple):
    n_components: int
    latent_dim: int
    ppca: bool = False
    lock_psis: bool = False
    zero_mean: bool = False
    max_condition_number: float = 1e6
    # floor on a component's total responsibility mass; below it the
    # component gets responsibility rs_clip for every sample
    rs_clip: float = 0.0
    max_iter: int = 100
    tol: float = 1e-6
    psi_floor: float = 1e-6
    chunk_size: int = 4096
    kmeans_iter: int = 50
    axis_name: Optional[str] = None
    psum_segments: Union[int, str] = "auto"


class MfaParams(NamedTuple):
    weights: torch.Tensor   # (K,) real
    means: torch.Tensor     # (K, D) complex
    lambdas: torch.Tensor   # (K, D, M) complex factor loadings
    psis: torch.Tensor      # (K, D) real diagonal noise


class MfaFitResult(NamedTuple):
    params: MfaParams
    log_likelihood: torch.Tensor  # summed over the samples
    n_iter: int
    converged: bool


def params_from_numpy(params, device=None) -> MfaParams:
    """The JAX package's `MfaParams` as numpy arrays (any 4-sequence
    weights, means, lambdas, psis) -> port `MfaParams` on `device`."""
    return MfaParams(*(torch.as_tensor(np.asarray(p), device=device)
                       for p in params))


def covariances(params: MfaParams) -> torch.Tensor:
    """Dense C_k = Lambda Lambda^H + diag(psi), (K, D, D)."""
    c = params.lambdas @ params.lambdas.mH
    return c + torch.diag_embed(params.psis.to(c.dtype))


def _inner(lambdas: torch.Tensor, psis: torch.Tensor):
    """Psi^{-1} (K, D) in the loadings' dtype and
    inner = I + Lambda^H Psi^{-1} Lambda (K, M, M)."""
    m = lambdas.shape[-1]
    psi_inv = (1.0 / psis).to(lambdas.dtype)
    lp = lambdas.mH * psi_inv[:, None, :]
    eye = torch.eye(m, dtype=lambdas.dtype, device=lambdas.device)
    return psi_inv, eye + lp @ lambdas


def woodbury_inverse(lambdas: torch.Tensor,
                     psis: torch.Tensor) -> torch.Tensor:
    """(Lambda Lambda^H + diag(psi))^{-1} via the matrix inversion lemma,
    batched over components: only M x M inverses are formed."""
    psi_inv, inner = _inner(lambdas, psis)
    inner_inv = linalg.hermitian_inv(linalg.hermitize(inner))
    outer = lambdas @ inner_inv @ lambdas.mH
    return (torch.diag_embed(psi_inv)
            - psi_inv[:, :, None] * outer * psi_inv[:, None, :])


def _slogdet_from_woodbury(lambdas: torch.Tensor,
                           psis: torch.Tensor) -> torch.Tensor:
    """log det(C) = sum log psi + log det(I + Lambda^H Psi^{-1} Lambda)."""
    _, inner = _inner(lambdas, psis)
    _, ld = torch.linalg.slogdet(inner)
    return torch.log(psis).sum(-1) + ld.real


def _weighted_cross(stats, mu_a: torch.Tensor,
                    mu_b: torch.Tensor) -> torch.Tensor:
    """sum_n r (x - mu_a)(x - mu_b)^H from (Nk, Sx, Sxx)."""
    nk = stats.nk.to(stats.sxx.dtype)[:, None, None]
    return (stats.sxx
            - stats.sx[:, :, None] * mu_b.conj()[:, None, :]
            - mu_a[:, :, None] * stats.sx.conj()[:, None, :]
            + nk * mu_a[:, :, None] * mu_b.conj()[:, None, :])


def _check_supported(cfg: MfaConfig) -> None:
    if cfg.axis_name is not None or cfg.psum_segments not in ("auto", 1):
        raise NotImplementedError(
            "data-parallel MFA fits (axis_name, psum_segments) are not "
            "ported yet (ROADMAP Queue 1 item 15)")


def _e_step_terms(p: MfaParams):
    """The factored-Woodbury pieces of one E-step: the Cholesky factor of
    inner, T = L^{-1} Lambda^H Psi^{-1} and the log-density of a chunk."""
    d = p.psis.shape[-1]
    psi_inv_r = 1.0 / p.psis                                   # (K, D)
    psi_inv, inner = _inner(p.lambdas, p.psis)
    lp_mat = p.lambdas.mH * psi_inv[:, None, :]                # (K, M, D)
    chol = torch.linalg.cholesky(linalg.hermitize(inner))      # (K, M, M)
    t_mat = torch.linalg.solve_triangular(chol, lp_mat, upper=False)
    logdets = (torch.log(p.psis).sum(-1)
               + 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                                dim2=-1).real).sum(-1))
    mu = p.means
    mu2 = (mu.abs() ** 2 * psi_inv_r).sum(-1)                  # (K,)
    mu_w = (mu.conj() * psi_inv).T                             # (D, K)
    t_mu = torch.einsum("kmd,kd->km", t_mat, mu)               # (K, M)
    log_pi = d * math.log(math.pi)

    def log_prob_fn(xc):
        # the expanded quadratic (x-mu)^H C^{-1} (x-mu): no (K, n, D) diff
        a = (xc.abs() ** 2) @ psi_inv_r.T                      # (n, K)
        cross = (xc @ mu_w).real                               # (n, K)
        tx = torch.einsum("kmd,nd->knm", t_mat, xc)            # (K, n, M)
        b = ((tx - t_mu[:, None, :]).abs() ** 2).sum(-1)       # (K, n)
        quad = a - 2.0 * cross + mu2[None, :] - b.T
        return -log_pi - logdets[None, :] - quad

    return chol, t_mat, log_prob_fn


def _m_step(p: MfaParams, stats, chol, t_mat, n: int,
            cfg: MfaConfig) -> MfaParams:
    """New parameters from the sufficient statistics (the JAX M-step)."""
    m = cfg.latent_dim
    dtype = stats.sx.dtype
    if cfg.rs_clip > 0.0:
        # a component whose responsibility mass drops below rs_clip gets
        # responsibility rs_clip for EVERY sample: with streaming statistics
        # that is exact post hoc, the unweighted data sums being the
        # component sums of the statistics (sum_k resp = 1)
        low = stats.nk < cfg.rs_clip
        rc = cfg.rs_clip
        stats = stats._replace(
            nk=torch.where(low, torch.full_like(stats.nk, n * rc), stats.nk),
            sx=torch.where(low[:, None], rc * stats.sx.sum(0), stats.sx),
            sxx=torch.where(low[:, None, None], rc * stats.sxx.sum(0),
                            stats.sxx))
    nk = stats.nk + 10.0 * _F32_EPS
    nk_c = nk.to(dtype)

    # beta = Lambda^H C^{-1} = inner^{-1} Lambda^H Psi^{-1} = L^{-H} T
    beta = torch.linalg.solve_triangular(chol.mH, t_mat, upper=True)
    mu_old = p.means
    sz = torch.einsum("kme,ke->km", beta,
                      stats.sx - nk_c[:, None] * mu_old)       # sum r z
    if cfg.zero_mean:
        means = torch.zeros_like(mu_old)
    else:
        means = (stats.sx - torch.einsum("kdm,km->kd", p.lambdas, sz)) \
            / nk_c[:, None]

    stats_n = stats._replace(nk=nk)
    c_oo = _weighted_cross(stats_n, mu_old, mu_old)
    c_on = _weighted_cross(stats_n, mu_old, means)
    c_nn = _weighted_cross(stats_n, means, means)

    # loadings: Lambda = xz ezz^{-1}
    xz = c_on.mH @ beta.mH                                     # (K, D, M)
    zz = torch.einsum("kme,kef,kpf->kmp", beta, c_oo, beta.conj())
    bl = beta @ p.lambdas
    eye = torch.eye(m, dtype=dtype, device=beta.device)
    ezz = nk_c[:, None, None] * (eye - bl) + zz
    lambdas = torch.linalg.solve(ezz.mH, xz.mH).mH.resolve_conj()

    # psis with the PRE-update loadings, as the reference does
    lb = p.lambdas @ beta
    psis = torch.diagonal(c_nn - lb @ c_on, dim1=-2, dim2=-1).real \
        / nk[:, None]
    psis = torch.clamp(psis, min=cfg.psi_floor)
    if cfg.ppca:
        psis = psis.mean(-1, keepdim=True).expand_as(psis)
    if cfg.lock_psis:
        shared = (nk[:, None] * psis).sum(0) / nk.sum()
        psis = shared[None, :].expand_as(psis)
    return MfaParams(nk / n, means, lambdas, psis.contiguous())


def _run_em(params0: MfaParams, x: torch.Tensor,
            cfg: MfaConfig) -> MfaFitResult:
    """The EM loop from given starting parameters (shared by `fit` and
    `fit_resume`)."""
    _check_supported(cfg)
    n = x.shape[0]
    chunk = min(cfg.chunk_size, n)
    rdt = real_dtype_of(x.dtype)
    p = params0
    log_like = torch.tensor(-math.inf, dtype=rdt, device=x.device)
    prev_ll = torch.tensor(math.inf, dtype=rdt, device=x.device)
    n_iter = 0

    def rel_change():
        den = torch.where(log_like == 0, torch.ones_like(log_like), log_like)
        return ((log_like - prev_ll) / den).abs()

    while n_iter < cfg.max_iter and (n_iter <= 5
                                     or bool(rel_change() >= cfg.tol)):
        chol, t_mat, log_prob_fn = _e_step_terms(p)
        stats = gmm_mod.accumulate_stats(x, torch.log(p.weights),
                                         log_prob_fn, chunk)
        p = _m_step(p, stats, chol, t_mat, n, cfg)
        prev_ll, log_like = log_like, stats.log_norm
        n_iter += 1
    converged = bool(((log_like - prev_ll) / log_like).abs() < cfg.tol)
    return MfaFitResult(p, log_like, n_iter, converged)


def fit(gen: torch.Generator, x: torch.Tensor, cfg: MfaConfig) -> MfaFitResult:
    """EM fit from the reference's initialisation: k-means means (zero
    means for `zero_mean`), loadings of scale 1 / sqrt(2
    max_condition_number), every psi the per-dimension data variance,
    uniform random weights. Draws come from `gen` (k-means first, then the
    loadings' real and imaginary parts, then the weights). Matrix products
    run in full fp32 (`ops.precision.pin_fp32`)."""
    _check_supported(cfg)
    pin_fp32()
    n, d = x.shape
    m, k = cfg.latent_dim, cfg.n_components
    dtype, rdt = x.dtype, real_dtype_of(x.dtype)
    dev = gen.device
    if cfg.zero_mean:
        means0 = torch.zeros((k, d), dtype=dtype, device=x.device)
    else:
        km = kmeans(gen, cplx2real(x, dim=-1).to(torch.float32), k,
                    max_iter=cfg.kmeans_iter)
        means0 = torch.complex(km.centers[:, :d], km.centers[:, d:]).to(
            dtype)
    lam_scale = 1.0 / math.sqrt(2.0 * cfg.max_condition_number)
    lr = torch.randn((k, d, m), generator=gen, dtype=rdt, device=dev)
    li = torch.randn((k, d, m), generator=gen, dtype=rdt, device=dev)
    lambdas0 = (lam_scale * torch.complex(lr, li)).to(dtype).to(x.device)
    var = ((x - x.mean(0)).abs() ** 2).mean(0)
    psis0 = var[None, :].expand(k, d).contiguous()
    amps0 = torch.rand((k,), generator=gen, dtype=rdt, device=dev)
    amps0 = (amps0 / amps0.sum()).to(x.device)
    return _run_em(MfaParams(amps0, means0, lambdas0, psis0), x, cfg)


def fit_resume(params: MfaParams, x: torch.Tensor,
               cfg: MfaConfig) -> MfaFitResult:
    """Warm-start EM from existing parameters (checkpoint-based restart)."""
    pin_fp32()
    return _run_em(MfaParams(*params), x, cfg)


def to_gmm_params(params: MfaParams, reg: float = 0.0) -> GmmParams:
    """Densify to a full-covariance GMM for the dense Bussgang bank."""
    pin_fp32()
    covs = covariances(params)
    if reg:
        covs = linalg.add_jitter(covs, reg)
    prec = linalg.robust_precision_cholesky(covs)
    return GmmParams(params.weights, params.means, covs, prec)
