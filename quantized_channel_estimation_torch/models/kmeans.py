"""k-means (k-means++ seeding + Lloyd iterations), single device.

Port of `quantized_channel_estimation_tpu/models/kmeans.py` without the
data-parallel form. Complex data is stacked [Re; Im] by the caller and
clustered in R^{2D}. Deterministic given the `torch.Generator`; its stream
differs from JAX's, so the tests check seeding by its statistics and the
Lloyd step from shared centres.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (K, D)
    labels: torch.Tensor   # (N,)


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, K) squared Euclidean distances via |x|^2 - 2 x.c + |c|^2."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (centers * centers).sum(-1)
    return x2 - 2.0 * (x @ centers.T) + c2


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding: each next center is sampled with probability
    proportional to the squared distance to the nearest chosen center
    (realized as argmax(log d + gumbel), as in the JAX seeding)."""
    n = x.shape[0]
    first = torch.randint(n, (1,), generator=gen, device=gen.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first.to(x.device)][0]
    dmin = ((x - centers[0]) ** 2).sum(-1)
    for i in range(1, k):
        u = torch.rand(n, generator=gen, dtype=x.dtype, device=gen.device)
        gumbel = -torch.log(-torch.log(
            u.to(x.device).clamp(torch.finfo(x.dtype).tiny, 1.0)))
        idx = torch.argmax(torch.log(dmin.clamp(min=1e-30)) + gumbel)
        centers[i] = x[idx]
        dmin = torch.minimum(dmin, ((x - centers[i]) ** 2).sum(-1))
    return centers


def _relocate_empty(x: torch.Tensor, centers: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """Move each empty cluster's center to the point farthest from its
    assigned center (sklearn's strategy), distinct points for several."""
    empty = torch.nonzero(counts == 0).flatten().tolist()
    if not empty:
        return centers
    centers = centers.clone()
    dmin = _sq_dists(x, centers).min(1).values
    for j in empty:
        idx = torch.argmax(dmin)
        centers[j] = x[idx]
        dmin[idx] = -1.0
    return centers


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor):
    """One Lloyd update: assign to the nearest center, then move each
    center to its cluster mean (empty clusters keep their center).
    Returns (new_centers, labels, counts)."""
    k = centers.shape[0]
    labels = torch.argmin(_sq_dists(x, centers), dim=-1)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    sums = torch.zeros_like(centers).index_add_(0, labels, x)
    new = sums / counts.clamp(min=1.0)[:, None]
    new = torch.where(counts[:, None] > 0, new, centers)
    return new, labels, counts


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int, max_iter: int = 50,
           tol: float = 1e-4) -> KMeansResult:
    """Lloyd's algorithm with k-means++ seeding; x (N, D) real. Stops when
    the total squared center shift < tol * mean per-dim variance (sklearn's
    rule) or at max_iter."""
    centers = _kmeanspp_init(gen, x, k)
    tol_scaled = tol * x.var(dim=0, unbiased=False).mean()
    for _ in range(max_iter):
        new, _, counts = _lloyd_step(x, centers)
        new = _relocate_empty(x, new, counts)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if bool(shift < tol_scaled):
            break
    labels = torch.argmin(_sq_dists(x, centers), dim=-1)
    return KMeansResult(centers, labels)
