"""Batched scalar Gauss-Newton solver for erf-model variance fitting.

Port of `quantized_channel_estimation_tpu/ops/gauss_newton.py`
(`solve_erf_scale`, `_residual`, `_jacobian`). Solves, independently per
problem, min_s sum_i (erf(tau_i / (sqrt(2) s)) - p_i)^2: the per-dimension
scale recovery of quantized covariance estimation. Every (component,
dimension) problem runs in one batched loop; a problem whose step has
fallen under `tol` is frozen (its iterate and last step kept).

The Jacobian is the corrected one of the JAX package:
d/ds erf(t/(sqrt(2) s)) = -sqrt(2/pi) t exp(-t^2/(2 s^2)) / s^2 (the
reference writes exp(-t^2/(2 s)), a typo).

Restarts: an active iterate outside [0.1, 10] is re-seeded near the initial
guess with 0.1 N(0, 1) noise. JAX draws that noise from `fold_in(key, i)`;
here it comes from a `torch.Generator`, one draw per iteration. Threefry
and Philox streams cannot match, so the two packages agree exactly only
where no iterate leaves [0.1, 10]; a solve that restarts is held by its
invariants (in range, converged).

Convergence is read on the host every `CHECK_EVERY` iterations, not every
one: frozen problems stay frozen, so the result is the same bit for bit
as a per-iteration check, `max_iter` still caps the count, and a solve of
I iterations costs ceil(I / CHECK_EVERY) host read-backs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# iterations between two host reads of the convergence flags
CHECK_EVERY = 8


def _residual(s: torch.Tensor, tau: torch.Tensor,
              probs: torch.Tensor) -> torch.Tensor:
    return torch.erf(tau / (math.sqrt(2.0) * s)) - probs


def _jacobian(s: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    return (-math.sqrt(2.0 / math.pi) * tau
            * torch.exp(-tau ** 2 / (2.0 * s ** 2)) / s ** 2)


def solve_erf_scale(tau: torch.Tensor, probs: torch.Tensor, x0: torch.Tensor,
                    gen: Optional[torch.Generator], tol: float = 1e-5,
                    max_iter: int = 100) -> torch.Tensor:
    """Fit the scale s of a zero-mean Gaussian to below-threshold
    probabilities.

    tau:   (..., R) positive thresholds (R residuals per problem)
    probs: (..., R) target probabilities P(|x| < tau)
    x0:    (...,) initial scales
    gen:   the restart noise's generator (on x0's device)
    Returns (...,) scales in tau's dtype. Batched over all leading axes."""
    x0 = x0.to(tau.dtype)
    x = x0
    dx = torch.full_like(x0, math.inf)
    i = 0
    while i < max_iter:
        for _ in range(min(CHECK_EVERY, max_iter - i)):
            active = dx.abs() > tol
            noise = 0.1 * torch.randn(x.shape, generator=gen,
                                      dtype=x.dtype, device=x.device)
            x = torch.where(active & (x.abs() < 0.1),
                            torch.clamp(x0 + noise, 0.1, 10.0), x)
            x = torch.where(active & (x.abs() > 10.0), 1.0 + noise, x)
            f = _residual(x[..., None], tau, probs)
            j = _jacobian(x[..., None], tau)
            # 1-D least squares step: dx = -<J, f> / <J, J>
            jj = (j * j).sum(-1)
            step = -(j * f).sum(-1) / jj.clamp(min=1e-30)
            # only problems that have not converged move
            step = torch.where(active, step, torch.zeros_like(step))
            x = x + step
            dx = torch.where(active, step, dx)
            i += 1
        if not bool((dx.abs() > tol).any()):
            break
    return x
