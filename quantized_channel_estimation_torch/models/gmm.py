"""Complex Gaussian mixture model fitted by EM.

Port of `quantized_channel_estimation_tpu/models/gmm.py`: `GmmConfig`,
`GmmParams`, `GmmFitResult`, `log_prob_full`, `log_prob_diag`,
`accumulate_stats`, `_m_step_full`, `_m_step_diag`, `_m_step_toeplitz`,
`_init_resp_stats`, `_em_loop`, `_dft_for`, `_oversampled_dft_for`, `fit`,
`fit_resume` and `predict_proba`. E and M are fused into one chunked pass
over the data that accumulates the sufficient statistics (Nk, sum r.x, and
sum r.xx^H or, for the diagonal modes, sum r.|x|^2); the EM loop is a
Python loop with the JAX stopping rule (|change of the mean
log-likelihood| < tol, at least one iteration). The (block-)circulant types
run the diagonal EM on the unitary-DFT-domain data and return dense
covariances F^H diag(s) F, as every fit does. 'toeplitz' and
'block-toeplitz' run the Barton-Fuhrmann inverse EM: a full-covariance
E-step and an M-step that moves a nonnegative spectrum on the oversampled
DFT frame F2 (`ops.linalg.oversampled_dft`, kron of two for
'block-toeplitz'), C = F2^H diag(s) F2, by its trust-region-clipped
fixed-point step. `fit_resume` continues a 'full' or Toeplitz fit from its
parameters (the Toeplitz spectrum given, or recovered from the covariances
by `linalg.spectrum_from_covariance`), which `models.em_driver` uses to
split a fit into segments.

Data-parallel EM (JAX `GmmConfig.axis_name` under `shard_map`): `fit(...,
group=)` takes this rank's equal window of the global rows (in rank order)
and a `torch.distributed` process group over the data shards. After each
local pass the statistics (Nk, sum r.x, sum r.xx^H or sum r.|x|^2, sum
log-norm) are all-reduced, so every rank runs the same M-step; the init is
the data-parallel k-means or the global random stream's window, and the
lower bound is over the global n. `GmmConfig.psum_segments` S > 1 splits
the pass into S segments whose partial statistics are all-reduced
asynchronously while later chunks compute (JAX `segmented_psum_scan`;
`chunked_pass`, which the quantized EMs share); 'auto' is 1.
`params_from_numpy`, `quant_fit_from_numpy` and `quant_circ_fit_from_numpy`
carry JAX fits across.
"""
from __future__ import annotations

import math
import os
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from quantized_channel_estimation_torch.models.kmeans import kmeans
from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.cplx import (
    cplx2real, real_dtype_of)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.parallel.comm import Comm, pack, unpack

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
    # data-parallel fits: > 1 all-reduces the statistics of S segments of
    # the pass as each finishes, overlapping the collective with the later
    # chunks; 'auto' is 1 (JAX `_resolve_segments`). No effect on one device
    psum_segments: Union[int, str] = "auto"


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
    # the inverse-EM spectrum (K, F) of a Toeplitz fit, which `fit_resume`
    # continues from exactly; None for the other types
    spectrum: Optional[torch.Tensor] = None


def params_from_numpy(params, device=None) -> GmmParams:
    """The JAX package's `GmmParams` as numpy arrays (any 4-sequence
    weights, means, covariances, prec_chol), or the path of the npz its
    `utils.io.save_pytree_npz` writes, -> port `GmmParams` on `device`."""
    if isinstance(params, (str, os.PathLike)):
        from quantized_channel_estimation_torch.utils.io import load_gmm_arrays
        params = load_gmm_arrays(params)
    return GmmParams(*(torch.as_tensor(np.asarray(p), device=device)
                       for p in params))


def quant_fit_from_numpy(params, cov_quant, device=None,
                         lower_bound: float = math.nan, n_iter: int = 0,
                         converged: bool = False):
    """The JAX package's `gmm_quant.QuantGmmFitResult` as numpy arrays (its
    params, as `params_from_numpy` takes them, and cov_quant), with its
    telemetry, -> the port's `gmm_quant.QuantGmmFitResult` on `device`,
    which `gmm_quant.fit_resume` continues and the harnesses estimate
    from. The result carries no spectrum: a Toeplitz fit resumed from it
    recovers one from the covariances, as JAX does."""
    from quantized_channel_estimation_torch.models.gmm_quant import (
        QuantGmmFitResult)
    p = params_from_numpy(params, device)
    return QuantGmmFitResult(
        p, torch.as_tensor(np.asarray(cov_quant), device=device),
        torch.tensor(float(lower_bound), dtype=p.weights.dtype,
                     device=device), int(n_iter), bool(converged), [])


def quant_circ_fit_from_numpy(weights, means, spectra, spec_quant,
                              device=None, lower_bound: float = math.nan,
                              n_iter: int = 0, converged: bool = False):
    """The JAX package's `gmm_quant.QuantCircFitResult` as numpy arrays
    (weights (K,), data-domain means (K, D), channel spectra and
    quantized-observation spectra (K, D)), with its telemetry, -> the
    port's `gmm_quant.QuantCircFitResult` on `device`, which
    `gmm_quant.fit_circulant_spectra_resume` continues and the harnesses
    estimate from."""
    from quantized_channel_estimation_torch.models.gmm_quant import (
        QuantCircFitResult)
    w, mu, spec, spec_q = (torch.as_tensor(np.array(x), device=device)
                           for x in (weights, means, spectra, spec_quant))
    return QuantCircFitResult(
        w, mu, spec, spec_q,
        torch.tensor(float(lower_bound), dtype=w.dtype, device=device),
        int(n_iter), bool(converged), [])


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


def log_prob_diag(x: torch.Tensor, means: torch.Tensor,
                  variances: torch.Tensor) -> torch.Tensor:
    """Diagonal-covariance complex log-density, x (N, D) -> (N, K), with
    variances (K, D) real. The quadratic is expanded so that no (N, K, D)
    intermediate exists:
    sum_d |x_d - mu_d|^2 / c_d = sum |mu|^2 p - 2 Re(x . (mu* p)) + |x|^2 . p."""
    d = x.shape[-1]
    prec = 1.0 / variances                                    # (K, D)
    mu2 = (means.abs() ** 2 * prec).sum(-1)                   # (K,)
    cross = (x @ (means.conj() * prec).T).real                # (N, K)
    x2 = (x.abs() ** 2) @ prec.T                              # (N, K)
    quad = mu2[None, :] - 2.0 * cross + x2
    logdet = -torch.log(variances).sum(-1)                    # log det C^-1
    return -(d * math.log(math.pi) + quad) + logdet[None, :]


class _Stats(NamedTuple):
    nk: torch.Tensor        # (K,)
    sx: torch.Tensor        # (K, D) complex: sum_n r_nk x_n
    sxx: torch.Tensor       # (K, D, D) complex: sum_n r_nk x_n x_n^H, or
    #                         (K, D) real: sum_n r_nk |x_n|^2 (diag)
    log_norm: torch.Tensor  # scalar: sum_n log p(x_n)


def _zero_stats(k: int, d: int, dtype, device, diag: bool = False) -> _Stats:
    rdt = real_dtype_of(dtype)
    sxx0 = (torch.zeros((k, d), dtype=rdt, device=device) if diag
            else torch.zeros((k, d, d), dtype=dtype, device=device))
    return _Stats(torch.zeros(k, dtype=rdt, device=device),
                  torch.zeros((k, d), dtype=dtype, device=device), sxx0,
                  torch.zeros((), dtype=rdt, device=device))


def _update_stats(stats: _Stats, resp: torch.Tensor, xc: torch.Tensor,
                  log_norm_inc=0.0) -> _Stats:
    """Add one chunk's responsibility-weighted moments (the second moment
    in the form the statistics hold: full or diagonal)."""
    respd = resp.to(xc.dtype)
    if stats.sxx.dim() == 2:
        sxx = resp.T @ (xc.abs() ** 2)
    else:
        sxx = torch.einsum("nk,nd,ne->kde", respd, xc, xc.conj())
    return _Stats(stats.nk + resp.sum(0), stats.sx + respd.T @ xc,
                  stats.sxx + sxx, stats.log_norm + log_norm_inc)


def _resolve_segments(segments: Union[int, str]) -> int:
    """'auto' -> 1, as JAX `_resolve_segments` decides from its
    measurements (the collective is a small share of an EM pass)."""
    return 1 if segments == "auto" else int(segments)


def all_reduce_stats(stats: _Stats, group) -> _Stats:
    """The statistics summed over the ranks of `group` (one collective of
    O(K D^2) floats); unchanged without a group."""
    if group is None:
        return stats
    buf = pack(list(stats))
    dist.all_reduce(buf, group=group)
    return _Stats(*unpack(buf, list(stats)))


def resp_chunk(xc: torch.Tensor, log_weights: torch.Tensor, log_prob_fn):
    """The E-step of one chunk: responsibilities (nc, K) and the sum of the
    rows' log-normalizers log p(x_n)."""
    lp = log_prob_fn(xc) + log_weights[None, :]
    log_norm = torch.logsumexp(lp, dim=-1)
    return torch.exp(lp - log_norm[:, None]), log_norm.sum()


def chunked_pass(n_rows: int, chunk: int, zero: Callable[[], NamedTuple],
                 body: Callable, group=None,
                 psum_segments: Union[int, str] = 1):
    """One pass over rows [0, n_rows) in chunks: `body(stats, i0)` adds the
    chunk that starts at row i0 to the statistics `zero()` starts from (a
    NamedTuple of tensors, None fields allowed). With a process group the
    statistics are all-reduced over it; psum_segments S > 1 all-reduces S
    partial sums asynchronously as each segment of the pass finishes (equal
    to one all-reduce of the total up to float32 summation order)."""
    starts = list(range(0, n_rows, chunk))
    segs = (1 if group is None
            else max(1, min(_resolve_segments(psum_segments), len(starts))))
    bounds = [round(i * len(starts) / segs) for i in range(segs + 1)]
    pending = []
    for seg in range(segs):
        stats = zero()
        for i0 in starts[bounds[seg]:bounds[seg + 1]]:
            stats = body(stats, i0)
        if group is None:
            return stats
        fields = [t for t in stats if t is not None]
        buf = pack(fields)
        pending.append((buf, dist.all_reduce(buf, group=group,
                                             async_op=True)))
    total = None
    for buf, work in pending:
        work.wait()
        part = unpack(buf, fields)
        total = part if total is None else [a + b for a, b in zip(total,
                                                                  part)]
    summed = iter(total)
    return type(stats)(*(None if t is None else next(summed)
                         for t in stats))


def accumulate_stats(x: torch.Tensor, log_weights: torch.Tensor, log_prob_fn,
                     chunk: int, diag: bool = False, group=None,
                     psum_segments: Union[int, str] = 1) -> _Stats:
    """One pass over the data: responsibilities chunk by chunk, accumulated
    into (Nk, sum r.x, sum r.xx^H or sum r.|x|^2, sum log-norm), all-reduced
    over `group` as `chunked_pass` does."""
    def body(stats: _Stats, i0: int) -> _Stats:
        xc = x[i0:i0 + chunk]
        resp, log_norm = resp_chunk(xc, log_weights, log_prob_fn)
        return _update_stats(stats, resp, xc, log_norm)

    return chunked_pass(
        x.shape[0], chunk,
        lambda: _zero_stats(log_weights.shape[0], x.shape[-1], x.dtype,
                            x.device, diag),
        body, group, psum_segments)


def _means_from_stats(stats: _Stats, zero_mean: bool):
    nk = stats.nk + 10.0 * _F32_EPS
    means = stats.sx / nk[:, None].to(stats.sx.dtype)
    if zero_mean:
        means = torch.zeros_like(means)
    return nk, means


def _m_step_full(stats: _Stats, cfg: GmmConfig):
    nk, means = _means_from_stats(stats, cfg.zero_mean)
    # sum r (x-mu)(x-mu)^H = sxx - nk mu mu^H when mu is the weighted mean
    covs = stats.sxx / nk[:, None, None].to(stats.sxx.dtype)
    if not cfg.zero_mean:
        covs = covs - means[:, :, None] * means[:, None, :].conj()
    return nk, means, linalg.add_jitter(covs, cfg.reg_covar)


def _m_step_diag(stats: _Stats, cfg: GmmConfig):
    nk, means = _means_from_stats(stats, cfg.zero_mean)
    var = stats.sxx / nk[:, None]
    if not cfg.zero_mean:
        var = var - means.abs() ** 2
    return nk, means, var + cfg.reg_covar


def _m_step_toeplitz(stats: _Stats, cfg: GmmConfig, prev_covs: torch.Tensor,
                     sigma_spec: torch.Tensor, f2: torch.Tensor):
    """Barton-Fuhrmann inverse-EM spectrum update on the frame F2 (F, D):
    sigma_f += sigma_f^2 Re(f_f^H (C^-1 S C^-1 - C^-1) f_f) with C the
    previous covariance and S the weighted sample covariance, the step
    clipped to [0.1 sigma, 10 sigma] (the raw step overshoots in float32 on
    peaked spectra) and floored at reg_covar. C^-1 is the eigenvalue
    pseudo-inverse (rcond 1e-7): a jittered Cholesky inverse would blow up
    on near-singular covariances. Returns (nk, means, covs, sigma)."""
    nk, means = _means_from_stats(stats, cfg.zero_mean)
    s = stats.sxx / nk[:, None, None].to(stats.sxx.dtype)
    if not cfg.zero_mean:
        s = s - means[:, :, None] * means[:, None, :].conj()
    cinv = linalg.psd_pinv(prev_covs, rcond=1e-7)
    m = cinv @ s @ cinv - cinv
    theta = torch.einsum("fd,kde,fe->kf", f2, m, f2.conj()).real
    raw = sigma_spec + sigma_spec ** 2 * theta
    sigma_spec = torch.clamp(raw, 0.1 * sigma_spec, 10.0 * sigma_spec)
    sigma_spec = sigma_spec.clamp(min=cfg.reg_covar)
    return (nk, means, _frame_covs(f2, sigma_spec, cfg.reg_covar),
            sigma_spec)


def _frame_covs(f2: torch.Tensor, sigma: torch.Tensor,
                reg_covar: float) -> torch.Tensor:
    """The inverse EM's covariances F2^H diag(sigma_k) F2 + reg_covar I."""
    covs = torch.einsum("fd,kf,fe->kde", f2.conj(), sigma.to(f2.dtype), f2)
    return linalg.add_jitter(covs, reg_covar)


def _stats_from_labels(x: torch.Tensor, labels: torch.Tensor, k: int,
                       chunk: int, diag: bool = False) -> _Stats:
    """Sufficient statistics of a hard assignment (one-hot
    responsibilities)."""
    stats = _zero_stats(k, x.shape[-1], x.dtype, x.device, diag)
    rdt = stats.nk.dtype
    for i0 in range(0, x.shape[0], chunk):
        onehot = torch.nn.functional.one_hot(labels[i0:i0 + chunk], k)
        stats = _update_stats(stats, onehot.to(rdt), x[i0:i0 + chunk])
    return stats


def _init_resp_stats(gen: torch.Generator, x: torch.Tensor, cfg: GmmConfig,
                     chunk: int, diag: bool = False,
                     group=None) -> _Stats:
    """Initial responsibilities folded into sufficient statistics:
    init='kmeans' is the hard assignment of k-means on [Re, Im]-stacked
    float32 data; init='random' draws rows of U(0,1) normalized to sum 1.
    Under a group both are the single-device init of the global rows: the
    data-parallel k-means, or the global random stream drawn chunk by chunk
    on every rank with this rank's window kept; the statistics are
    all-reduced."""
    k = cfg.n_components
    comm = Comm(group, x.shape[0], x.device)
    if cfg.init == "random":
        stats = _zero_stats(k, x.shape[-1], x.dtype, x.device, diag)
        lo, hi = comm.lo, comm.lo + comm.n_local
        for i0 in range(0, comm.n_global, chunk):
            n_c = min(chunk, comm.n_global - i0)
            resp = torch.rand((n_c, k), generator=gen,
                              dtype=stats.nk.dtype, device=gen.device)
            a, b = max(i0, lo), min(i0 + n_c, hi)
            if a >= b:
                continue
            resp = resp[a - i0:b - i0]
            resp = (resp / resp.sum(-1, keepdim=True)).to(x.device)
            stats = _update_stats(stats, resp, x[a - lo:b - lo])
        return all_reduce_stats(stats, group)
    labels = kmeans(gen, cplx2real(x, dim=-1).to(torch.float32), k,
                    max_iter=cfg.kmeans_iter, group=group).labels
    return all_reduce_stats(_stats_from_labels(x, labels, k, chunk, diag),
                            group)


class _State(NamedTuple):
    weights: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor   # (K, D, D) complex (full) or (K, D) real (diag)
    sigma: Optional[torch.Tensor] = None   # (K, F) inverse-EM spectrum


def _params_from_stats(stats: _Stats, cfg: GmmConfig, mode: str = "full",
                       prev: Optional[_State] = None,
                       f2: Optional[torch.Tensor] = None) -> _State:
    """The M-step of `mode`. 'inv-em' starts (prev None) from the full
    M-step with the spectrum of its oversampled-DFT diagonal, and later
    moves the spectrum of `prev` (`_m_step_toeplitz`)."""
    sigma = None if prev is None else prev.sigma
    if mode == "full":
        nk, means, covs = _m_step_full(stats, cfg)
    elif mode == "inv-em" and prev is None:
        nk, means, covs = _m_step_full(stats, cfg)
        sigma = torch.einsum("fd,kde,fe->kf", f2, covs,
                             f2.conj()).real.clamp(min=cfg.reg_covar)
    elif mode == "inv-em":
        nk, means, covs, sigma = _m_step_toeplitz(stats, cfg, prev.covs,
                                                  prev.sigma, f2)
    else:
        nk, means, covs = _m_step_diag(stats, cfg)
        if mode == "spherical":
            # one variance per component: the diagonal averaged over dims
            covs = covs.mean(-1, keepdim=True).expand_as(covs)
    return _State(nk / nk.sum(), means, covs, sigma)


def _em_loop(x: torch.Tensor, init_stats: Optional[_Stats], cfg: GmmConfig,
             mode: str = "full", group=None, f2: Optional[torch.Tensor] = None,
             state0: Optional[_State] = None):
    """EM, mode in {'full', 'diag', 'spherical', 'inv-em'} ('inv-em' on the
    frame `f2`), from initial statistics (the first M-step builds the
    parameters from them) or, to resume, from the parameters `state0`
    (for 'inv-em' with its spectrum). Under a group x is this rank's
    window and the statistics of every pass are all-reduced. Returns
    (state, lower_bound, n_iter, converged, lb_history)."""
    n = Comm(group, x.shape[0], x.device).n_global
    chunk = min(cfg.chunk_size, x.shape[0])
    diag = mode in ("diag", "spherical")
    state = (_params_from_stats(init_stats, cfg, mode, None, f2)
             if state0 is None else state0)
    rdt = state.weights.dtype
    # lower bound -inf and previous +inf: the first check sees an infinite
    # change, so the loop always runs at least one iteration
    lb = torch.tensor(-math.inf, dtype=rdt, device=x.device)
    prev = torch.tensor(math.inf, dtype=rdt, device=x.device)
    n_iter, history = 0, []
    while n_iter < cfg.max_iter and bool((lb - prev).abs() >= cfg.tol):
        means, covs = state.means, state.covs
        if diag:
            log_prob_fn = lambda xc: log_prob_diag(xc, means, covs)  # noqa: E731
        else:
            prec = linalg.robust_precision_cholesky(covs)
            log_prob_fn = lambda xc: log_prob_full(xc, means, prec)  # noqa: E731
        stats = accumulate_stats(x, torch.log(state.weights), log_prob_fn,
                                 chunk, diag, group, cfg.psum_segments)
        state = _params_from_stats(stats, cfg, mode, state, f2)
        prev, lb = lb, stats.log_norm / n
        n_iter += 1
        history.append(float(lb))
    converged = bool((lb - prev).abs() < cfg.tol)
    return state, lb, n_iter, converged, history


def _dft_for(cfg: GmmConfig, d: int, dtype, device=None) -> torch.Tensor:
    """The unitary basis that diagonalizes the fit's covariances: the DFT
    for 'circulant', kron(F_n1, F_n2) for 'block-circulant'."""
    if cfg.cov_type == "circulant":
        return linalg.unitary_dft(d, dtype, device)
    n1, n2 = cfg.blocks
    if n1 * n2 != d:
        raise ValueError(f"blocks {cfg.blocks} incompatible with dim {d}")
    return torch.kron(linalg.unitary_dft(n1, dtype, device),
                      linalg.unitary_dft(n2, dtype, device))


def _oversampled_dft_for(cfg: GmmConfig, d: int, dtype,
                         device=None) -> torch.Tensor:
    """The inverse-EM frame: the oversampled DFT (2D, D) for 'toeplitz',
    kron(F2_n1, F2_n2) (4D, D) for 'block-toeplitz'."""
    if cfg.cov_type == "toeplitz":
        return linalg.oversampled_dft(d, dtype, device)
    n1, n2 = cfg.blocks
    if n1 * n2 != d:
        raise ValueError(f"blocks {cfg.blocks} incompatible with dim {d}")
    return torch.kron(linalg.oversampled_dft(n1, dtype, device),
                      linalg.oversampled_dft(n2, dtype, device))


def _fit_once(gen: torch.Generator, h: torch.Tensor, cfg: GmmConfig,
              group=None) -> GmmFitResult:
    d, dtype = h.shape[-1], h.dtype
    if cfg.cov_type in ("circulant", "block-circulant"):
        f = _dft_for(cfg, d, dtype, h.device)
        x = h @ f.T                        # unitary-DFT-domain data
        init_stats = _init_resp_stats(gen, x, cfg, cfg.chunk_size, True,
                                      group)
        state, lb, n_iter, converged, history = _em_loop(x, init_stats, cfg,
                                                         "diag", group)
        means = state.means @ f.conj()     # back-transform row vectors
        covs = torch.einsum("fd,kf,fe->kde", f.conj(), state.covs.to(dtype),
                            f)
        covs = linalg.hermitize(covs)
    elif cfg.cov_type == "full":
        init_stats = _init_resp_stats(gen, h, cfg, cfg.chunk_size,
                                      group=group)
        state, lb, n_iter, converged, history = _em_loop(h, init_stats, cfg,
                                                         "full", group)
        means, covs = state.means, linalg.hermitize(state.covs)
    elif cfg.cov_type in ("diag", "spherical"):
        init_stats = _init_resp_stats(gen, h, cfg, cfg.chunk_size, True,
                                      group)
        state, lb, n_iter, converged, history = _em_loop(h, init_stats, cfg,
                                                         cfg.cov_type, group)
        means = state.means
        covs = torch.diag_embed(state.covs.to(dtype))
    elif cfg.cov_type in ("toeplitz", "block-toeplitz"):
        f2 = _oversampled_dft_for(cfg, d, dtype, h.device)
        init_stats = _init_resp_stats(gen, h, cfg, cfg.chunk_size,
                                      group=group)
        state, lb, n_iter, converged, history = _em_loop(
            h, init_stats, cfg, "inv-em", group, f2)
        means, covs = state.means, linalg.hermitize(state.covs)
    else:
        raise NotImplementedError(
            f"covariance_type={cfg.cov_type!r} is not implemented")
    covs = linalg.add_jitter(covs, cfg.reg_covar)
    prec = linalg.robust_precision_cholesky(covs)
    params = GmmParams(state.weights, means, covs, prec)
    return GmmFitResult(params, lb, n_iter, converged, history, state.sigma)


def fit(gen: torch.Generator, h: torch.Tensor, cfg: GmmConfig,
        group: Optional[dist.ProcessGroup] = None) -> GmmFitResult:
    """Fit the complex GMM with EM; runs cfg.n_init restarts (successive
    draws of `gen`) and keeps the best lower bound. Matrix products run in
    full fp32 (`ops.precision.pin_fp32`): reduced-precision multiplies NaN
    the factorizations at D=64. With `group`, h is this rank's window of
    the global rows and the EM runs data-parallel over the group (every
    rank returns the same fit, that of the global rows up to float32
    summation order)."""
    pin_fp32()
    best = _fit_once(gen, h, cfg, group)
    for _ in range(1, cfg.n_init):
        cand = _fit_once(gen, h, cfg, group)
        if bool(cand.lower_bound > best.lower_bound):
            best = cand
    return best


def fit_resume(params: GmmParams, h: torch.Tensor, cfg: GmmConfig,
               group: Optional[dist.ProcessGroup] = None,
               spectrum: Optional[torch.Tensor] = None) -> GmmFitResult:
    """Continue EM from existing parameters (a checkpoint restart, or the
    next segment of `models.em_driver.fit_segmented`). 'full': one E-pass
    with the given parameters yields the statistics the loop continues
    from. 'toeplitz' / 'block-toeplitz': given `spectrum` (the previous
    result's), the loop continues exactly where that fit stopped, from the
    spectrum and the covariances it defines; else, as JAX does, from the
    covariances and the spectrum recovered from them by
    `linalg.spectrum_from_covariance`. That recovery is inexact at D = 64
    (200 Richardson-Lucy steps) and the saved covariances carry the jitter
    `fit` adds once more, so the lower bound steps back for several
    iterations; the frame diagonal would be worse still. Other types raise
    NotImplementedError. `group` as in `fit`."""
    if cfg.cov_type not in ("full", "toeplitz", "block-toeplitz"):
        raise NotImplementedError(
            "fit_resume supports 'full' and 'toeplitz'/'block-toeplitz' "
            f"state (got {cfg.cov_type!r})")
    pin_fp32()
    params = GmmParams(*(torch.as_tensor(p, device=h.device) for p in params))
    if cfg.cov_type == "full":
        stats = accumulate_stats(
            h, torch.log(params.weights),
            lambda xc: log_prob_full(xc, params.means, params.prec_chol),
            min(cfg.chunk_size, h.shape[0]), False, group, cfg.psum_segments)
        state, lb, n_iter, converged, history = _em_loop(h, stats, cfg,
                                                         "full", group)
    else:
        f2 = _oversampled_dft_for(cfg, h.shape[-1], h.dtype, h.device)
        if spectrum is None:
            covs = params.covariances.to(h.dtype)
            spectrum = linalg.spectrum_from_covariance(covs, f2,
                                                       cfg.reg_covar)
        else:
            spectrum = torch.as_tensor(spectrum, device=h.device)
            covs = _frame_covs(f2, spectrum, cfg.reg_covar)
        state0 = _State(params.weights, params.means, covs, spectrum)
        state, lb, n_iter, converged, history = _em_loop(
            h, None, cfg, "inv-em", group, f2, state0)
    covs = linalg.add_jitter(linalg.hermitize(state.covs), cfg.reg_covar)
    out = GmmParams(state.weights, state.means, covs,
                    linalg.robust_precision_cholesky(covs))
    return GmmFitResult(out, lb, n_iter, converged, history, state.sigma)


def predict_proba(params: GmmParams, x: torch.Tensor) -> torch.Tensor:
    """Posterior component probabilities (N, K)."""
    lp = log_prob_full(x, params.means, params.prec_chol) \
        + torch.log(params.weights)[None, :]
    return torch.softmax(lp, dim=-1)
