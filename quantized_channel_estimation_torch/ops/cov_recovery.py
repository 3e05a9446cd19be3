"""Covariance recovery from coarsely quantized observations.

Port of `quantized_channel_estimation_tpu/ops/cov_recovery.py`
(`positive_thresholds`, `one_bit_requantize`, `arcsine_correlation`,
`QuantStats`, `accumulate_quant_stats`, `recover_variances`,
`recover_covariance`, `recover_covariance_from_samples`). The scheme of the
paper's Fig. 2:

  correlation: re-quantize to 1 bit, form the (responsibility-weighted)
               sample correlation, invert the arcsine law entrywise:
               sin(pi/2 Re) + j sin(pi/2 Im)
  scale:       per dimension, fit the std s of each real component to the
               below-threshold bin-occupancy probabilities by nonlinear LS
               on erf(tau/(sqrt(2) s)) = p (Gauss-Newton); variance = 2 s^2
  combine:     C = diag(s) corr diag(s)

The statistics are EM-style sums batched over components, so the same
functions serve the quantized EM's M-step and the standalone benchmark.
`accumulate_quant_stats` forms both sums as real GEMMs of the
responsibilities: against the rows' 1-bit outer products (N, D^2) in row
slices, and against the (N, D, B, 2) occupancy indicators, where the JAX
package builds a (K, N, D) weighted copy of the rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from quantized_channel_estimation_torch.ops.gauss_newton import (
    solve_erf_scale)
from quantized_channel_estimation_torch.ops.quantizer import ScalarQuantizer

# elements of one row slice's outer products in `weighted_gram` (32 MiB of
# complex64)
_GRAM_SLICE_ELEMS = 1 << 22


def positive_thresholds(q: ScalarQuantizer) -> torch.Tensor:
    """The strictly positive thresholds tau_b, b = 1..2^(b-1)-1."""
    t = q.thresholds
    return t[(t.shape[0] - 1) // 2 + 1:]


def one_bit_requantize(r: torch.Tensor) -> torch.Tensor:
    """sign(Re)/sqrt(2) + j sign(Im)/sqrt(2)."""
    s = 1.0 / math.sqrt(2.0)
    return torch.complex(s * torch.sign(r.real), s * torch.sign(r.imag))


def arcsine_correlation(corr_1bit: torch.Tensor) -> torch.Tensor:
    """Invert the arcsine law entrywise: the 1-bit correlation K maps back
    to sin(pi/2 Re K) + j sin(pi/2 Im K)."""
    return torch.complex(torch.sin(math.pi / 2.0 * corr_1bit.real),
                         torch.sin(math.pi / 2.0 * corr_1bit.imag))


class QuantStats(NamedTuple):
    """Sufficient statistics for covariance recovery, batched over K.

    nk:        (K,)          responsibility masses
    corr_1bit: (K, D, D)     sum_n r_nk q1(x_n) q1(x_n)^H (un-normalized)
    below:     (K, D, B, 2)  sum_n r_nk 1(|Re/Im x_nd| < tau_b) for the
                             positive thresholds tau_1..tau_B (re, im
                             stacked)
    """
    nk: torch.Tensor
    corr_1bit: torch.Tensor
    below: torch.Tensor


def weighted_gram(resp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_n resp_nk x_n x_n^H (K, D, D) for real resp (N, K) and complex
    x (N, D): one real GEMM of resp^T against the rows' outer products
    (N, D^2, as re/im pairs) per slice of rows, no (K, N, D) product."""
    n, d = x.shape
    k = resp.shape[-1]
    rdt = x.real.dtype
    resp = resp.to(rdt)
    out = torch.zeros((k, 2 * d * d), dtype=rdt, device=x.device)
    step = max(1, _GRAM_SLICE_ELEMS // (d * d))
    for i0 in range(0, n, step):
        xs = x[i0:i0 + step]
        outer = (xs[:, :, None] * xs.conj()[:, None, :]).reshape(-1, d * d)
        out += resp[i0:i0 + step].T @ torch.view_as_real(outer).reshape(
            -1, 2 * d * d)
    return torch.view_as_complex(out.reshape(k, d, d, 2))


def occupancy(r: torch.Tensor, resp: torch.Tensor,
              pos_tau: torch.Tensor) -> torch.Tensor:
    """sum_n resp_nk 1(|Re / Im r_nd| < tau_b) (K, D, B, 2), one real GEMM
    of resp^T against the (N, D, B, 2) indicators."""
    n, d = r.shape
    ind = torch.stack([r.real.abs()[:, :, None] < pos_tau,
                       r.imag.abs()[:, :, None] < pos_tau], dim=-1)
    below = resp.T @ ind.reshape(n, -1).to(resp.dtype)
    return below.reshape(resp.shape[-1], d, pos_tau.shape[0], 2)


def accumulate_quant_stats(r: torch.Tensor, resp: torch.Tensor,
                           pos_tau: torch.Tensor) -> QuantStats:
    """One pass over a chunk of quantized data. r: (N, D), resp: (N, K),
    pos_tau: (B,). Additive across chunks."""
    return QuantStats(resp.sum(0), weighted_gram(resp, one_bit_requantize(r)),
                      occupancy(r, resp, pos_tau))


def recover_variances(nk: torch.Tensor, below: torch.Tensor,
                      pos_tau: torch.Tensor, x0: torch.Tensor,
                      gen: Optional[torch.Generator]) -> torch.Tensor:
    """Per-dimension unquantized variances (K, D) from bin-occupancy
    statistics: fit the real-component std s to erf(tau/(sqrt(2) s)) = p
    by Gauss-Newton (warm start x0, restarts from `gen`), variance
    = 2 s^2. Serves the full recovery's scale part and the diagonal
    quantized EM."""
    nk_d = nk[:, None, None, None]
    # the occupancy bounds [1/Nk, (Nk-1)/Nk] invert for Nk < 2; ordered so
    # the clip stays defined (the quantized EM masks such components out)
    lo, hi = 1.0 / nk_d, (nk_d - 1.0) / nk_d
    probs = torch.clamp(below / nk_d, torch.minimum(lo, hi),
                        torch.maximum(lo, hi))
    k, d, b, _ = probs.shape
    # (re, im) residuals of one (component, dim) stacked: 2B, same tau
    probs_flat = probs.movedim(-1, -2).reshape(k, d, 2 * b)
    tau_flat = torch.cat([pos_tau, pos_tau])
    x0 = x0.real if x0.is_complex() else x0
    s = solve_erf_scale(tau_flat, probs_flat, x0, gen)
    sigma2 = torch.clamp(2.0 * s ** 2, min=0.0)
    return torch.where(torch.isnan(sigma2), torch.ones_like(sigma2), sigma2)


def recover_covariance(stats: QuantStats, pos_tau: torch.Tensor,
                       x0: torch.Tensor,
                       gen: Optional[torch.Generator]) -> torch.Tensor:
    """Recover the unquantized covariance bank (K, D, D) from quantized-data
    statistics. x0: (K, D) Gauss-Newton warm starts (the quantized EM
    passes the current quantized variances)."""
    nk = stats.nk[:, None, None].to(stats.corr_1bit.dtype)
    corr = arcsine_correlation(stats.corr_1bit / nk)
    sigma2 = recover_variances(stats.nk, stats.below, pos_tau, x0, gen)
    scale = torch.sqrt(sigma2).to(corr.dtype)
    return scale[:, :, None] * corr * scale[:, None, :]


def recover_covariance_from_samples(r: torch.Tensor, q: ScalarQuantizer,
                                    gen: Optional[torch.Generator]
                                    ) -> torch.Tensor:
    """Unweighted single-covariance recovery from raw quantized samples
    r (N, D): the standalone Fig. 2 path."""
    pos_tau = positive_thresholds(q).to(r.device)
    if pos_tau.shape[0] == 0:
        # a 1-bit sign quantizer has no interior thresholds: bin occupancy
        # carries no amplitude information and the scale fit would return
        # its warm start
        raise ValueError("covariance recovery needs n_bits >= 2; a 1-bit "
                         "quantizer provides no amplitude information "
                         "(use the arcsine correlation alone)")
    resp = torch.ones((r.shape[0], 1), dtype=torch.float32, device=r.device)
    stats = accumulate_quant_stats(r, resp, pos_tau)
    x0 = torch.ones((1, r.shape[1]), dtype=torch.float32, device=r.device)
    return recover_covariance(stats, pos_tau, x0, gen)[0]
