"""Complex GMM fitted by EM on quantized observations alone (CSI-free
training), recovering the channel covariances every M-step.

Port of `quantized_channel_estimation_tpu/models/gmm_quant.py`:
`QuantGmmFitResult`, the quantized-EM states and statistics, `_accumulate`,
`_accumulate_diag`, `_run_quant_em_diag`, `_recover_covs`, `_prep`, `fit`,
`_run_quant_em` and `fit_resume` (the dense EM), and the spectra-native
circulant EM: `_QStatsCirc`, `_QStateCirc`, `QuantCircFitResult`, `_ufft`,
`_accumulate_circ`, `_recover_circ`, `_run_quant_em_circ`,
`_INIT_ELEM_BUDGET`, `_streamed_init_stats`, `_circ_state0`,
`fit_circulant_spectra` and `fit_circulant_spectra_resume`.

Model state per component k: the channel covariance C_k (recovered, the
quantity of interest) and the quantized-observation covariance Cq_k (it
drives the E-step on the quantized data r). The M-step by bit width:
  1 bit:  Cq = weighted sample covariance of r; C = entrywise arcsine
          inversion, PSD-projected
  n bits: C = arcsine correlation x per-dimension Gauss-Newton scales
          (`ops.cov_recovery`), minus sigma^2 I, PSD-projected; Cq
          re-synthesized as B Cy B^H with the exact quantized variance on
          the diagonal
  inf:    C = sample covariance - sigma^2 I, PSD-projected; Cq = C + sigma^2 I
Covariance types: 'full'; 'toeplitz' / 'block-toeplitz' (the recovered
covariance moves the Barton-Fuhrmann spectrum on the oversampled frame,
as `gmm._m_step_toeplitz` does with a sample covariance); 'diag' /
'spherical' (per-dimension occupancy recovery only, n_bits >= 2; spherical
ties the variance across dimensions); 'circulant' (the dense recovery
projected onto the circulant cone through the DFT diagonal).

One pass over the data per iteration computes the E-step, the moments
(`gmm._update_stats`) and the recovery sums (1-bit correlation, bin
occupancy; `ops.cov_recovery`). The loop is a Python loop with the JAX
stopping rule, read on the host once an iteration. Products run in full fp32 (`ops.precision.pin_fp32`):
`psd_project_polar`'s guard lies below TF32's error. The carries are
complex64 as the JAX EM's float32 ones.

The spectra-native circulant EM (`fit_circulant_spectra`, the frontier-D
entry) never forms a (K, D, D) array: each chunk's unitary DFT feeds a
diagonal E-step (`gmm.log_prob_diag`, a GEMM) and the statistics are
(K, D) spectra sums, |F r|^2 of the rows and of their 1-bit
requantization, and (K, B, 2) bin occupancies pooled over dimensions;
the recovery (arcsine law, one 1-D Gauss-Newton a component) acts on the
first rows of the projected statistics, and the PSD projection is a clip
of the spectrum. O(N K D + N D log D) an iteration. Beyond
`_INIT_ELEM_BUDGET` rows x dimensions its k-means init clusters a row
prefix and assigns the rest chunk by chunk (`_streamed_init_stats`), so
no full-dataset DFT exists either.

Data parallelism (JAX `GmmConfig.axis_name` under `shard_map`): `fit`,
`fit_from_stats`, `fit_resume` and the spectra fits take `group=`, as
`gmm.fit` does: r is this rank's equal window of the global rows, every
statistic (moments, 1-bit correlation, occupancy counts, spectra sums) is
all-reduced over the group (`gmm.chunked_pass`, `cfg.psum_segments`), the
lower bound is over the global n and the init is the data-parallel one
(`gmm._init_resp_stats(..., group=)`; the streamed init is for one device
only, as in JAX). The Gauss-Newton restarts draw from `gen`, which must be
seeded alike on every rank, so the M-step stays replicated.

Deviations from the JAX package:
- the Gauss-Newton restarts draw from the fit's `torch.Generator`
  (`ops.gauss_newton`), so fits agree with JAX's exactly only where no
  scale iterate leaves [0.1, 10];
- a Toeplitz result carries its inverse-EM spectrum
  (`QuantGmmFitResult.spectrum`) and `fit_resume(..., spectrum=)`
  continues from it exactly; without it the spectrum is recovered from the
  saved covariances as JAX does (`linalg.spectrum_from_covariance`,
  inexact at D = 64).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from quantized_channel_estimation_torch.models import gmm
from quantized_channel_estimation_torch.models import kmeans as km
from quantized_channel_estimation_torch.models.gmm import (
    GmmConfig, GmmParams)
from quantized_channel_estimation_torch.ops import cov_recovery, linalg
from quantized_channel_estimation_torch.ops.cplx import cplx2real
from quantized_channel_estimation_torch.ops.bussgang import (
    bank_gains_and_cov, bussgang_gain_diag, quantized_variance)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits)
from quantized_channel_estimation_torch.parallel.comm import Comm

COV_TYPES = ("full", "toeplitz", "block-toeplitz", "diag", "spherical",
             "circulant")


class QuantGmmFitResult(NamedTuple):
    params: GmmParams             # recovered channel-domain parameters
    cov_quant: torch.Tensor       # (K, M, M) quantized-observation covs
    lower_bound: torch.Tensor
    n_iter: int
    converged: bool
    lb_history: List[float]       # lower bound after each EM iteration
    # the inverse-EM spectrum (K, F) of a Toeplitz fit, which `fit_resume`
    # continues from exactly; None for the other types
    spectrum: Optional[torch.Tensor] = None


class _QState(NamedTuple):
    weights: torch.Tensor
    means: torch.Tensor       # (K, M) quantized-domain means (0 zero_mean)
    covs: torch.Tensor        # (K, M, M) recovered channel covariances
    covs_quant: torch.Tensor  # (K, M, M)
    sigma_spec: torch.Tensor  # (K, F) inverse-EM spectrum, else unused


class _QStateDiag(NamedTuple):
    weights: torch.Tensor
    means: torch.Tensor       # (K, D) quantized-domain means (0 zero_mean)
    var: torch.Tensor         # (K, D) recovered channel variances
    var_quant: torch.Tensor   # (K, D) quantized-observation variances


class _QStats(NamedTuple):
    nk: torch.Tensor
    sx: torch.Tensor
    sxx: torch.Tensor         # (K, D, D), or (K, D) real for 'diag'
    corr_1bit: Optional[torch.Tensor]   # (K, D, D); n-bit full models only
    below: Optional[torch.Tensor]       # (K, D, B, 2); n-bit models only
    log_norm: torch.Tensor


def _accumulate(x: torch.Tensor, log_weights: torch.Tensor, log_prob_fn,
                chunk: int, pos_tau: Optional[torch.Tensor], diag: bool,
                group=None, psum_segments=1) -> _QStats:
    """The fused E-step and statistics pass over x chunk by chunk: the
    moments (sum r, sum r.x, sum r.xx^H or r.|x|^2, sum log p(x)) and,
    with n-bit thresholds `pos_tau`, the bin occupancy and (full models)
    the 1-bit correlation of the same responsibilities; all-reduced over
    `group`."""
    k = log_weights.shape[0]
    d = x.shape[-1]

    def zero() -> _QStats:
        base = gmm._zero_stats(k, d, x.dtype, x.device, diag)
        corr = below = None
        if pos_tau is not None:
            below = torch.zeros((k, d, pos_tau.shape[0], 2),
                                dtype=base.nk.dtype, device=x.device)
            if not diag:
                corr = torch.zeros((k, d, d), dtype=x.dtype, device=x.device)
        return _QStats(base.nk, base.sx, base.sxx, corr, below,
                       base.log_norm)

    def body(stats: _QStats, i0: int) -> _QStats:
        xc = x[i0:i0 + chunk]
        resp, log_norm = gmm.resp_chunk(xc, log_weights, log_prob_fn)
        base = gmm._update_stats(
            gmm._Stats(stats.nk, stats.sx, stats.sxx, stats.log_norm), resp,
            xc, log_norm)
        corr, below = stats.corr_1bit, stats.below
        if pos_tau is not None:
            below = below + cov_recovery.occupancy(xc, resp, pos_tau)
            if not diag:
                corr = corr + cov_recovery.weighted_gram(
                    resp, cov_recovery.one_bit_requantize(xc))
        return _QStats(base.nk, base.sx, base.sxx, corr, below,
                       base.log_norm)

    return gmm.chunked_pass(x.shape[0], chunk, zero, body, group,
                            psum_segments)


def _recover_covs(stats: _QStats, cfg: GmmConfig, n_bits, sigma2,
                  q: Optional[ScalarQuantizer], pos_tau, prev_covs_quant,
                  gen: torch.Generator, eye: torch.Tensor):
    """Channel-covariance recovery and quantized-covariance resynthesis."""
    reg = cfg.reg_covar
    samp = stats.sxx / stats.nk[:, None, None].to(stats.sxx.dtype)
    if n_bits == 1:
        covs_quant = samp + reg * eye
        covs = cov_recovery.arcsine_correlation(samp) + reg * eye
        covs = linalg.psd_project_polar(linalg.hermitize(covs), reg)
        covs = covs + reg * eye
    elif is_inf_bits(n_bits):
        covs = samp + reg * eye - sigma2 * eye + reg * eye
        covs = linalg.psd_project_polar(linalg.hermitize(covs), reg)
        covs = covs + reg * eye
        covs_quant = covs + sigma2 * eye
    else:
        x0 = torch.diagonal(prev_covs_quant, dim1=-2, dim2=-1).real
        qstats = cov_recovery.QuantStats(stats.nk, stats.corr_1bit,
                                         stats.below)
        covs = cov_recovery.recover_covariance(qstats, pos_tau, x0, gen)
        covs = covs - sigma2 * eye + reg * eye
        covs = linalg.psd_project_polar(linalg.hermitize(covs), reg)
        covs = covs + reg * eye
        # the quantized covariance implied by the recovered one
        cy = covs + sigma2 * eye
        diag_cy = torch.diagonal(cy, dim1=-2, dim2=-1).real
        gains = bussgang_gain_diag(diag_cy, n_bits, q).to(cy.dtype)
        bq = gains[..., :, None] * cy * gains.conj()[..., None, :]
        diag_cr = quantized_variance(diag_cy, q).to(cy.dtype)
        covs_quant = bq * (1 - eye) + diag_cr[..., None] * eye
    # Empty-component guard: k-means on coarsely quantized data (16
    # distinct values a dimension at 2 bits) leaves components with Nk ~ 0,
    # whose occupancy bounds [1/Nk, (Nk-1)/Nk] invert (for any Nk < 2) and
    # poison the recovery. Such components are parked at a unit-power
    # prior; their ~zero weights keep them out of estimation.
    valid = (stats.nk >= 2.0)[:, None, None]
    return (torch.where(valid, covs, eye),
            torch.where(valid, covs_quant, eye))


def _prep(r: torch.Tensor, cfg: GmmConfig, n_bits,
          q: Optional[ScalarQuantizer]):
    """The refusals of `fit` / `fit_resume`, the n-bit thresholds (None at
    1 and inf bits) and the frame of the structured types (the oversampled
    DFT of the inverse EM, the unitary DFT of 'circulant', else None)."""
    if cfg.cov_type not in COV_TYPES:
        raise NotImplementedError(
            f"Gmm_quant covariance_type={cfg.cov_type!r}: supported are "
            "'full', 'toeplitz', 'block-toeplitz', 'diag', 'spherical', "
            "'circulant'")
    if cfg.cov_type in ("diag", "spherical") and n_bits == 1:
        # |Q_1bit(y)|^2 == 1 for every sample: without the correlation a
        # 1-bit quantizer carries no per-dimension amplitude information
        raise NotImplementedError(
            f"cov_type={cfg.cov_type!r} quantized training is "
            "unidentifiable at n_bits=1 (bin occupancy carries no "
            "amplitude information)")
    n_bit = not is_inf_bits(n_bits) and n_bits != 1
    if n_bit and q is None:
        raise ValueError(f"{n_bits}-bit covariance recovery needs the "
                         "quantizer q")
    pos_tau = (cov_recovery.positive_thresholds(q).to(r.device) if n_bit
               else None)
    d = r.shape[-1]
    f2 = None
    if cfg.cov_type in ("toeplitz", "block-toeplitz"):
        f2 = gmm._oversampled_dft_for(cfg, d, r.dtype, r.device)
    elif cfg.cov_type == "circulant":
        f2 = linalg.unitary_dft(d, r.dtype, r.device)
    return pos_tau, f2


def _em(state, step, n: int, cfg: GmmConfig):
    """The EM loop with the JAX stopping rule: |change of the mean
    log-likelihood| < tol after at least one iteration, at most max_iter,
    a NaN lower bound stops it. `step(state)` returns the next state and
    the sum of the rows' log-normalizers; n is the global row count. The
    lower bound is read on the host once an iteration and the rule is
    evaluated there in float32, as on the device. Returns (state, lower
    bound, n_iter, converged, lower bound after each iteration)."""
    tol = np.float32(cfg.tol)
    lb_f, prev_f = np.float32(-np.inf), np.float32(np.inf)
    lb = None
    n_iter, history = 0, []
    while n_iter < cfg.max_iter and abs(lb_f - prev_f) >= tol:
        state, log_norm = step(state)
        lb = log_norm / n
        prev_f, lb_f = lb_f, np.float32(lb.item())
        n_iter += 1
        history.append(float(lb_f))
    if lb is None:
        lb = torch.tensor(-math.inf, dtype=state.weights.dtype,
                          device=state.weights.device)
    return state, lb, n_iter, bool(abs(lb_f - prev_f) < tol), history


def _run_quant_em_diag(x: torch.Tensor, state: _QStateDiag, cfg: GmmConfig,
                       n_bits, sigma2, q, pos_tau, gen: torch.Generator,
                       group=None) -> QuantGmmFitResult:
    """Diagonal quantized EM: per-dimension variances from bin occupancy
    (n bits) or the sample moment (inf), the exact quantized variance for
    the E-step. Returns the densified result, as the clean EM's diagonal
    types do."""
    chunk = min(cfg.chunk_size, x.shape[0])

    def step(state: _QStateDiag):
        means, var_quant = state.means, state.var_quant
        stats = _accumulate(
            x, torch.log(state.weights),
            lambda xc: gmm.log_prob_diag(xc, means, var_quant), chunk,
            pos_tau, True, group, cfg.psum_segments)
        nk = stats.nk + 10.0 * gmm._F32_EPS
        means = (torch.zeros_like(means) if cfg.zero_mean
                 else stats.sx / nk[:, None].to(means.dtype))
        if is_inf_bits(n_bits):
            y_var = stats.sxx / nk[:, None]
        else:
            y_var = cov_recovery.recover_variances(
                stats.nk, stats.below, pos_tau, var_quant, gen)
        var = torch.clamp(y_var - sigma2, min=cfg.reg_covar)
        if cfg.cov_type == "spherical":
            var = var.mean(-1, keepdim=True).expand_as(var)
        # the empty-component guard (see _recover_covs): unit power
        var = torch.where((stats.nk >= 2.0)[:, None], var,
                          torch.ones_like(var))
        var_quant = (var + sigma2 if is_inf_bits(n_bits)
                     else quantized_variance(var + sigma2, q))
        return (_QStateDiag(nk / nk.sum(), means, var, var_quant),
                stats.log_norm)

    state, lb, n_iter, converged, history = _em(
        state, step, Comm(group, x.shape[0], x.device).n_global, cfg)
    dtype = state.means.dtype
    covs = torch.diag_embed(state.var.to(dtype))
    prec = torch.diag_embed((1.0 / torch.sqrt(state.var)).to(dtype))
    return QuantGmmFitResult(
        GmmParams(state.weights, state.means, covs, prec),
        torch.diag_embed(state.var_quant.to(dtype)), lb, n_iter, converged,
        history)


def _run_quant_em(x: torch.Tensor, state: _QState, cfg: GmmConfig, n_bits,
                  sigma2, q, pos_tau, f2: Optional[torch.Tensor],
                  gen: torch.Generator, group=None) -> QuantGmmFitResult:
    """The quantized EM of the full-covariance types from a given state
    (`fit` and `fit_resume`)."""
    n, d = x.shape
    chunk = min(cfg.chunk_size, n)
    n = Comm(group, n, x.device).n_global
    inv_em = cfg.cov_type in ("toeplitz", "block-toeplitz")
    reg = cfg.reg_covar
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def step(state: _QState):
        prec_q = linalg.robust_precision_cholesky(state.covs_quant)
        means = state.means
        stats = _accumulate(
            x, torch.log(state.weights),
            lambda xc: gmm.log_prob_full(xc, means, prec_q), chunk, pos_tau,
            False, group, cfg.psum_segments)
        nk = stats.nk + 10.0 * gmm._F32_EPS
        means = (torch.zeros_like(means) if cfg.zero_mean
                 else stats.sx / nk[:, None].to(means.dtype))
        covs, covs_quant = _recover_covs(stats, cfg, n_bits, sigma2, q,
                                         pos_tau, state.covs_quant, gen, eye)
        sigma_spec = state.sigma_spec
        if inv_em:
            # the Barton-Fuhrmann step on the recovered covariance, with the
            # pseudo-inverse and trust region of gmm._m_step_toeplitz
            cinv = linalg.psd_pinv(state.covs, rcond=1e-7)
            m = cinv @ covs @ cinv - cinv
            theta = torch.einsum("fd,kde,fe->kf", f2, m, f2.conj()).real
            raw = sigma_spec + sigma_spec ** 2 * theta
            sigma_spec = torch.clamp(raw, 0.1 * sigma_spec,
                                     10.0 * sigma_spec).clamp(min=reg)
        elif cfg.cov_type == "circulant":
            # the Frobenius-nearest circulant: the DFT diagonal
            sigma_spec = torch.einsum("fd,kde,fe->kf", f2, covs,
                                      f2.conj()).real.clamp(min=reg)
        if f2 is not None:
            covs = gmm._frame_covs(f2, sigma_spec, reg)
            # the E-step covariance of the projected channel covariance
            if is_inf_bits(n_bits):
                covs_quant = covs + sigma2 * eye
            elif n_bits != 1:
                _, covs_quant = bank_gains_and_cov(covs + sigma2 * eye,
                                                   n_bits, q, exact_diag=True)
            elif not inv_em:
                # arcsine law of the projected Cy (shared Cr model)
                _, covs_quant = bank_gains_and_cov(covs + sigma2 * eye, 1, q)
        return (_QState(nk / nk.sum(), means, covs, covs_quant, sigma_spec),
                stats.log_norm)

    state, lb, n_iter, converged, history = _em(state, step, n, cfg)
    covs = linalg.add_jitter(linalg.hermitize(state.covs), reg)
    params = GmmParams(state.weights, state.means, covs,
                       linalg.robust_precision_cholesky(covs))
    return QuantGmmFitResult(params, state.covs_quant, lb, n_iter, converged,
                             history, state.sigma_spec if inv_em else None)


def _diag_state0(init: gmm._Stats, cfg: GmmConfig) -> _QStateDiag:
    nk0 = init.nk + 10.0 * gmm._F32_EPS
    means0 = (torch.zeros_like(init.sx) if cfg.zero_mean
              else init.sx / nk0[:, None].to(init.sx.dtype))
    var_quant0 = init.sxx / nk0[:, None] + cfg.reg_covar
    return _QStateDiag(nk0 / nk0.sum(), means0, var_quant0, var_quant0)


def _state0(init: gmm._Stats, cfg: GmmConfig,
            f2: Optional[torch.Tensor]) -> _QState:
    """The quantized covariances start at the plain weighted sample
    covariances of the quantized data, the channel covariances at the
    same; the inverse EM's spectrum at their frame diagonal."""
    k, d = init.sx.shape
    nk0 = init.nk + 10.0 * gmm._F32_EPS
    means0 = (torch.zeros_like(init.sx) if cfg.zero_mean
              else init.sx / nk0[:, None].to(init.sx.dtype))
    covs_quant0 = linalg.add_jitter(
        init.sxx / nk0[:, None, None].to(init.sxx.dtype), cfg.reg_covar)
    if cfg.cov_type in ("toeplitz", "block-toeplitz"):
        sigma0 = torch.einsum("fd,kde,fe->kf", f2, covs_quant0,
                              f2.conj()).real.clamp(min=cfg.reg_covar)
    else:
        sigma0 = torch.zeros((k, d if f2 is not None else 1),
                             dtype=nk0.dtype, device=nk0.device)
    return _QState(nk0 / nk0.sum(), means0, covs_quant0, covs_quant0, sigma0)


def fit_from_stats(gen: torch.Generator, r: torch.Tensor,
                   init_stats: gmm._Stats, cfg: GmmConfig, n_bits, sigma2,
                   q: Optional[ScalarQuantizer] = None,
                   group=None) -> QuantGmmFitResult:
    """`fit` from given initial statistics (those of a hard assignment:
    `gmm._stats_from_labels`, diagonal for 'diag' / 'spherical'; under a
    group, the global statistics)."""
    pin_fp32()
    pos_tau, f2 = _prep(r, cfg, n_bits, q)
    if cfg.cov_type in ("diag", "spherical"):
        return _run_quant_em_diag(r, _diag_state0(init_stats, cfg), cfg,
                                  n_bits, sigma2, q, pos_tau, gen, group)
    return _run_quant_em(r, _state0(init_stats, cfg, f2), cfg, n_bits,
                         sigma2, q, pos_tau, f2, gen, group)


def fit(gen: torch.Generator, r: torch.Tensor, cfg: GmmConfig, n_bits,
        sigma2, q: Optional[ScalarQuantizer] = None,
        group=None) -> QuantGmmFitResult:
    """Fit on quantized observations r (N, M) on r's device; sigma2 is the
    training SNR's noise variance and q the quantizer of r (on r's
    device; it encodes the design, so JAX's `quantizer_type` argument has
    no counterpart). `gen` draws the k-means (or random) init and the Gauss-Newton
    restarts. 'circulant' runs the dense recovery and then projects (a
    same-init A/B at D = 64, K = 8, 2 bits measured it 5-9% better in NMSE
    than recovering on the projected statistics). With `group`, r is
    this rank's window of the global rows and the EM runs data-parallel
    over the group (every rank returns the fit of the global rows up to
    float32 summation order; `gen` seeded alike on every rank)."""
    pin_fp32()
    _prep(r, cfg, n_bits, q)
    init_stats = gmm._init_resp_stats(gen, r, cfg, cfg.chunk_size,
                                      cfg.cov_type in ("diag", "spherical"),
                                      group)
    return fit_from_stats(gen, r, init_stats, cfg, n_bits, sigma2, q, group)


def fit_resume(gen: torch.Generator, prev, r: torch.Tensor, cfg: GmmConfig,
               n_bits, sigma2, q: Optional[ScalarQuantizer] = None,
               spectrum: Optional[torch.Tensor] = None,
               group=None) -> QuantGmmFitResult:
    """Continue the quantized EM from a previous result `prev` (anything
    with `params` and `cov_quant`; a checkpoint restart). `gen` draws the
    Gauss-Newton restarts only. 'toeplitz' / 'block-toeplitz': given
    `spectrum` (the previous result's), the loop continues exactly where
    that fit stopped; else, as JAX does, from the saved covariances and the
    spectrum recovered from them (`linalg.spectrum_from_covariance`), which
    is inexact at D = 64 and steps the lower bound back. `group` as in
    `fit`."""
    pin_fp32()
    pos_tau, f2 = _prep(r, cfg, n_bits, q)
    dev, dtype = r.device, r.dtype
    params = GmmParams(*(torch.as_tensor(p, device=dev)
                         for p in prev.params))
    cov_quant = torch.as_tensor(prev.cov_quant, device=dev).to(dtype)
    if cfg.cov_type in ("diag", "spherical"):
        state0 = _QStateDiag(
            params.weights, params.means,
            torch.diagonal(params.covariances, dim1=-2, dim2=-1).real,
            torch.diagonal(cov_quant, dim1=-2, dim2=-1).real)
        return _run_quant_em_diag(r, state0, cfg, n_bits, sigma2, q,
                                  pos_tau, gen, group)
    covs = params.covariances.to(dtype)
    k = params.weights.shape[0]
    if cfg.cov_type in ("toeplitz", "block-toeplitz"):
        if spectrum is None:
            sigma_spec = linalg.spectrum_from_covariance(covs, f2,
                                                         cfg.reg_covar)
        else:
            sigma_spec = torch.as_tensor(spectrum, device=dev)
            covs = gmm._frame_covs(f2, sigma_spec, cfg.reg_covar)
    else:
        # 'circulant' recomputes its spectrum every iteration
        sigma_spec = torch.zeros((k, r.shape[-1] if f2 is not None else 1),
                                 dtype=params.weights.dtype, device=dev)
    state0 = _QState(params.weights, params.means, covs, cov_quant,
                     sigma_spec)
    return _run_quant_em(r, state0, cfg, n_bits, sigma2, q, pos_tau, f2, gen,
                         group)


# ---------------------------------------------------------------------------
# the spectra-native circulant quantized EM (the frontier-D entry)
# ---------------------------------------------------------------------------

class _QStatsCirc(NamedTuple):
    nk: torch.Tensor                 # (K,)
    sx_f: torch.Tensor               # (K, D) complex: DFT-domain mean sums
    sxx_f: torch.Tensor              # (K, D) real: sum r |F x|^2, the
    #                                  spectrum of the circulant projection
    #                                  of the weighted sample covariance
    spec_q1: Optional[torch.Tensor]  # (K, D): the same of the 1-bit
    #                                  requantized rows (n bits only)
    below: Optional[torch.Tensor]    # (K, B, 2): bin occupancy pooled over
    #                                  dimensions (n bits only)
    log_norm: torch.Tensor


class _QStateCirc(NamedTuple):
    weights: torch.Tensor
    means_f: torch.Tensor     # (K, D) complex DFT-domain means (0 zero_mean)
    spec_chan: torch.Tensor   # (K, D) recovered channel spectra
    spec_quant: torch.Tensor  # (K, D) quantized-observation spectra (E-step)


class QuantCircFitResult(NamedTuple):
    """The spectra-native result: `structured_bank.prepare_bank_circulant(
    spectra=)` takes it as it is, with no dense (K, D, D) anywhere."""
    weights: torch.Tensor     # (K,)
    means: torch.Tensor       # (K, D) complex, data domain
    spectra: torch.Tensor     # (K, D) recovered channel spectra
    spec_quant: torch.Tensor  # (K, D)
    lower_bound: torch.Tensor
    n_iter: int
    converged: bool
    lb_history: List[float]   # lower bound after each EM iteration


def _ufft(x: torch.Tensor) -> torch.Tensor:
    """The unitary DFT along the last axis, fft / sqrt(D)."""
    return torch.fft.fft(x, dim=-1) / math.sqrt(x.shape[-1])


def _below_counts(xc: torch.Tensor, pos_tau: torch.Tensor) -> torch.Tensor:
    """(nc, B, 2): for each row, the dimensions whose |Re| / |Im| lie below
    each positive threshold (one (nc, D) comparison at a time)."""
    return torch.stack(
        [torch.stack([(part.abs() < t).sum(-1) for t in pos_tau], -1)
         for part in (xc.real, xc.imag)], -1)


def _accumulate_circ(x: torch.Tensor, log_weights: torch.Tensor,
                     means_f: torch.Tensor, spec_quant: torch.Tensor,
                     pos_tau: Optional[torch.Tensor], chunk: int, group=None,
                     psum_segments=1) -> _QStatsCirc:
    """The fused E-step and circulant recovery statistics: each chunk's
    unitary DFT feeds the diagonal DFT-domain E-step; with n-bit
    thresholds also the spectrum of the 1-bit requantized rows and the
    dimension-pooled bin occupancy. Every field is a data sum, all-reduced
    over `group`."""
    k = log_weights.shape[0]
    d = x.shape[-1]
    rdt = x.real.dtype

    def zero() -> _QStatsCirc:
        spec_q1 = below = None
        if pos_tau is not None:
            spec_q1 = torch.zeros((k, d), dtype=rdt, device=x.device)
            below = torch.zeros((k, pos_tau.shape[0], 2), dtype=rdt,
                                device=x.device)
        return _QStatsCirc(
            torch.zeros(k, dtype=rdt, device=x.device),
            torch.zeros((k, d), dtype=x.dtype, device=x.device),
            torch.zeros((k, d), dtype=rdt, device=x.device), spec_q1, below,
            torch.zeros((), dtype=rdt, device=x.device))

    def body(stats: _QStatsCirc, i0: int) -> _QStatsCirc:
        xc = x[i0:i0 + chunk]
        u = _ufft(xc)
        resp, log_norm = gmm.resp_chunk(
            u, log_weights,
            lambda uu: gmm.log_prob_diag(uu, means_f, spec_quant))
        spec_q1, below = stats.spec_q1, stats.below
        if pos_tau is not None:
            uq = _ufft(cov_recovery.one_bit_requantize(xc))
            spec_q1 = spec_q1 + resp.T @ (uq.real ** 2 + uq.imag ** 2)
            cnt = _below_counts(xc, pos_tau)
            below = below + (resp.T @ cnt.reshape(cnt.shape[0], -1).to(
                resp.dtype)).reshape(below.shape)
        return _QStatsCirc(stats.nk + resp.sum(0),
                           stats.sx_f + resp.to(u.dtype).T @ u,
                           stats.sxx_f + resp.T @ (u.real ** 2
                                                   + u.imag ** 2),
                           spec_q1, below, stats.log_norm + log_norm)

    return gmm.chunked_pass(x.shape[0], chunk, zero, body, group,
                            psum_segments)


def _recover_circ(stats: _QStatsCirc, cfg: GmmConfig, n_bits, sigma2, q,
                  pos_tau, prev_spec_quant: torch.Tensor,
                  gen: torch.Generator):
    """Channel-spectrum recovery and quantized-spectrum resynthesis, the
    spectrum-domain restatement of `_recover_covs`: the arcsine law and the
    occupancy scale act on the projected statistics' first rows, the PSD
    projection is a spectrum clip, and the resynthesis takes the
    constant-diagonal closed forms of the structured bank."""
    d = stats.sxx_f.shape[-1]
    nk, reg = stats.nk, cfg.reg_covar
    spec_samp = stats.sxx_f / nk[:, None]
    if n_bits == 1:
        spec_quant = spec_samp + reg
        # 1-bit data are their own requantization (|r_d| = 1)
        row = cov_recovery.arcsine_correlation(
            linalg.circulant_first_rows(spec_samp))
        spec_chan = linalg.circulant_spectra_from_first_rows(row).clamp(
            min=reg)
    elif is_inf_bits(n_bits):
        spec_chan = (spec_samp - sigma2).clamp(min=reg)
        spec_quant = spec_chan + sigma2
    else:
        row = cov_recovery.arcsine_correlation(
            linalg.circulant_first_rows(stats.spec_q1 / nk[:, None]))
        spec_corr = linalg.circulant_spectra_from_first_rows(row).clamp(
            min=0.0)
        # one scale a component from the dimension-pooled occupancy (a
        # circulant covariance has a constant diagonal): one 1-D
        # Gauss-Newton problem each
        x0 = prev_spec_quant.mean(-1)[:, None]
        s2 = cov_recovery.recover_variances(
            nk, stats.below[:, None] / d, pos_tau, x0, gen)[:, 0]
        spec_chan = (s2[:, None] * spec_corr - sigma2).clamp(min=reg)
        # resynthesis: scalar gain and variance a component
        sy = spec_chan + sigma2
        c0 = sy.mean(-1)
        beta2 = bussgang_gain_diag(c0, n_bits, q).clamp(0.0, 1.0) ** 2
        qvar = quantized_variance(c0, q)
        spec_quant = beta2[:, None] * sy + (qvar - beta2 * c0)[:, None]
    spec_quant = spec_quant.clamp(min=reg)
    # the empty-component guard (see _recover_covs): unit power
    valid = (nk >= 2.0)[:, None]
    ones = torch.ones_like(spec_chan)
    return (torch.where(valid, spec_chan, ones),
            torch.where(valid, spec_quant, ones))


def _run_quant_em_circ(x: torch.Tensor, state: _QStateCirc, cfg: GmmConfig,
                       n_bits, sigma2, q, pos_tau, gen: torch.Generator,
                       group=None) -> QuantCircFitResult:
    """The spectra-native EM from a given state (`fit_circulant_spectra`
    and its resume), on the `_em` loop."""
    chunk = min(cfg.chunk_size, x.shape[0])

    def step(state: _QStateCirc):
        stats = _accumulate_circ(x, torch.log(state.weights), state.means_f,
                                 state.spec_quant, pos_tau, chunk, group,
                                 cfg.psum_segments)
        nk = stats.nk + 10.0 * gmm._F32_EPS
        means_f = (torch.zeros_like(state.means_f) if cfg.zero_mean
                   else stats.sx_f / nk[:, None].to(stats.sx_f.dtype))
        spec_chan, spec_quant = _recover_circ(stats, cfg, n_bits, sigma2, q,
                                              pos_tau, state.spec_quant, gen)
        return (_QStateCirc(nk / nk.sum(), means_f, spec_chan, spec_quant),
                stats.log_norm)

    state, lb, n_iter, converged, history = _em(
        state, step, Comm(group, x.shape[0], x.device).n_global, cfg)
    means = torch.fft.ifft(state.means_f, dim=-1) * math.sqrt(
        state.means_f.shape[-1])
    return QuantCircFitResult(state.weights, means, state.spec_chan,
                              state.spec_quant, lb, n_iter, converged,
                              history)


# rows x dimensions above which the one-device k-means init streams: the
# dense init holds the full-dataset DFT and k-means' (N, 2D) copy beside
# the pilots (40k x 16384 rows: 6.55e8, over)
_INIT_ELEM_BUDGET = 600_000_000


def _streamed_init_stats(gen: torch.Generator, r: torch.Tensor,
                         cfg: GmmConfig) -> gmm._Stats:
    """The frontier-D init: k-means centres from a row prefix of
    min(N, max(4096, 50 K)) rows (the rows are i.i.d., so the prefix is an
    unbiased subsample), then one chunked DFT and hard-assignment pass
    folds every row's label into the init statistics. Neither the
    full-dataset DFT nor an (N, 2D) copy exists; the EM that follows is
    exact."""
    n, d = r.shape
    k = cfg.n_components
    n_sub = min(n, max(4096, 50 * k))
    centers = km.kmeans(gen, cplx2real(_ufft(r[:n_sub])).to(torch.float32), k,
                        max_iter=cfg.kmeans_iter).centers
    stats = gmm._zero_stats(k, d, r.dtype, r.device, diag=True)
    chunk = min(cfg.chunk_size, n)
    for i0 in range(0, n, chunk):
        uc = _ufft(r[i0:i0 + chunk])
        labels = torch.argmin(km._sq_dists(
            cplx2real(uc).to(torch.float32), centers), dim=-1)
        onehot = torch.nn.functional.one_hot(labels, k).to(stats.nk.dtype)
        stats = gmm._update_stats(stats, onehot, uc)
    return stats


def _circ_state0(gen: torch.Generator, r: torch.Tensor, cfg: GmmConfig,
                 group=None) -> _QStateCirc:
    """The init of k-means (or random) responsibilities on the DFT-domain
    data, the clean circulant fit's init domain; streamed past
    `_INIT_ELEM_BUDGET` on one device, the data-parallel dense init under
    a group."""
    if (group is None and cfg.init == "kmeans"
            and r.shape[0] * r.shape[-1] > _INIT_ELEM_BUDGET):
        init = _streamed_init_stats(gen, r, cfg)
    else:
        init = gmm._init_resp_stats(gen, _ufft(r), cfg, cfg.chunk_size,
                                    True, group)
    nk0 = init.nk + 10.0 * gmm._F32_EPS
    means_f0 = (torch.zeros_like(init.sx) if cfg.zero_mean
                else init.sx / nk0[:, None].to(init.sx.dtype))
    spec_quant0 = init.sxx / nk0[:, None] + cfg.reg_covar
    return _QStateCirc(nk0 / nk0.sum(), means_f0, spec_quant0, spec_quant0)


def _circ_prep(cfg: GmmConfig, n_bits, q: Optional[ScalarQuantizer],
               name: str, device) -> Optional[torch.Tensor]:
    """The refusals of the spectra fits; the n-bit thresholds (None at 1
    and inf bits)."""
    if cfg.cov_type != "circulant":
        raise ValueError(f"{name} requires cov_type='circulant' (got "
                         f"{cfg.cov_type!r})")
    if is_inf_bits(n_bits) or n_bits == 1:
        return None
    if q is None:
        raise ValueError("n-bit circulant recovery needs the quantizer")
    return cov_recovery.positive_thresholds(q).to(device)


def fit_circulant_spectra(gen: torch.Generator, r: torch.Tensor,
                          cfg: GmmConfig, n_bits, sigma2,
                          q: Optional[ScalarQuantizer] = None,
                          group=None) -> QuantCircFitResult:
    """CSI-free circulant training, spectra-native: the frontier-D entry,
    O(N K D + N D log D) an iteration with no (K, D, D) array, returning
    spectra that `structured_bank.prepare_bank_circulant(spectra=)` takes
    as they are. `gen` draws the init and the Gauss-Newton restarts;
    `group` as in `fit`. Recovering on the projected statistics costs NMSE
    against `fit(cov_type='circulant')`, whose dense recovery projects
    after (5-9% in the JAX package's same-init A/B at D = 64, K = 8, 2
    bits): use `fit` where its dense intermediates fit the device."""
    pin_fp32()
    pos_tau = _circ_prep(cfg, n_bits, q, "fit_circulant_spectra", r.device)
    state0 = _circ_state0(gen, r, cfg, group)
    return _run_quant_em_circ(r, state0, cfg, n_bits, sigma2, q, pos_tau,
                              gen, group)


def fit_circulant_spectra_resume(gen: torch.Generator, prev, r: torch.Tensor,
                                 cfg: GmmConfig, n_bits, sigma2,
                                 q: Optional[ScalarQuantizer] = None,
                                 group=None) -> QuantCircFitResult:
    """Continue the spectra-native EM from a previous result `prev`
    (anything with weights, means, spectra and spec_quant; a checkpoint
    restart or the next segment of `em_driver.fit_segmented`): the state
    is the O(K D) spectra themselves, so the restart is exact. `gen` draws
    the Gauss-Newton restarts only."""
    pin_fp32()
    pos_tau = _circ_prep(cfg, n_bits, q, "fit_circulant_spectra_resume",
                         r.device)
    w, mu, spec, spec_q = (torch.as_tensor(x, device=r.device) for x in (
        prev.weights, prev.means, prev.spectra, prev.spec_quant))
    state0 = _QStateCirc(w, _ufft(mu.to(r.dtype)), spec, spec_q)
    return _run_quant_em_circ(r, state0, cfg, n_bits, sigma2, q, pos_tau,
                              gen, group)
