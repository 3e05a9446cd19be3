"""k-means (k-means++ seeding + Lloyd iterations), single device or data
parallel.

Port of `quantized_channel_estimation_tpu/models/kmeans.py`. Complex data is
stacked [Re; Im] by the caller and clustered in R^{2D}. Deterministic given
the `torch.Generator`; its stream differs from JAX's, so the tests check
seeding by its statistics and the Lloyd step from shared centres.

Data-parallel form (`group`, a `torch.distributed` process group; x is
this rank's equal window of the global rows, in rank order): the Lloyd
statistics (centre sums, counts) are all-reduced; k-means++ seeding
reproduces the single-device draws exactly, because every rank draws the
full global uniform stream from the replicated generator and keeps its
window, the global argmax of log d + gumbel is an all-reduce MAX (ties to
the lowest global index) and the chosen row an all-reduce SUM of its
owner's row; empty clusters relocate to the globally farthest points, and
the stopping tolerance uses the global variance. Returned labels cover
this rank's rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from quantized_channel_estimation_torch.parallel.comm import Comm


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (K, D)
    labels: torch.Tensor   # (N,): this rank's rows under a group


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, K) squared Euclidean distances via |x|^2 - 2 x.c + |c|^2."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (centers * centers).sum(-1)
    return x2 - 2.0 * (x @ centers.T) + c2


def _local(comm: Optional[Comm], x: torch.Tensor) -> Comm:
    return Comm(None, x.shape[0], x.device) if comm is None else comm


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor, k: int,
                   comm: Optional[Comm] = None) -> torch.Tensor:
    """k-means++ seeding: each next center is sampled with probability
    proportional to the squared distance to the nearest chosen center
    (realized as argmax(log d + gumbel), as in the JAX seeding)."""
    comm = _local(comm, x)
    n = comm.n_global
    first = torch.randint(n, (1,), generator=gen, device=gen.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = comm.select_row(x, first.to(x.device)[0])
    dmin = ((x - centers[0]) ** 2).sum(-1)
    for i in range(1, k):
        u = torch.rand(n, generator=gen, dtype=x.dtype, device=gen.device)
        gumbel = -torch.log(-torch.log(comm.window(
            u.to(x.device)).clamp(torch.finfo(x.dtype).tiny, 1.0)))
        idx = comm.global_argmax(torch.log(dmin.clamp(min=1e-30)) + gumbel)
        centers[i] = comm.select_row(x, idx)
        dmin = torch.minimum(dmin, ((x - centers[i]) ** 2).sum(-1))
    return centers


def _relocate_empty(x: torch.Tensor, centers: torch.Tensor,
                    counts: torch.Tensor,
                    comm: Optional[Comm] = None) -> torch.Tensor:
    """Move each empty cluster's center to the point farthest from its
    assigned center (sklearn's strategy), distinct points for several;
    `counts` are global."""
    comm = _local(comm, x)
    empty = torch.nonzero(counts == 0).flatten().tolist()
    if not empty:
        return centers
    centers = centers.clone()
    dmin = _sq_dists(x, centers).min(1).values
    for j in empty:
        idx = comm.global_argmax(dmin)
        centers[j] = comm.select_row(x, idx)
        if comm.group is None:
            dmin[idx] = -1.0
        elif comm.owns(idx):
            dmin[idx - comm.lo] = -1.0
    return centers


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor,
                comm: Optional[Comm] = None):
    """One Lloyd update: assign to the nearest center, then move each
    center to its (global) cluster mean (empty clusters keep their
    center). Returns (new_centers, labels, global counts)."""
    comm = _local(comm, x)
    k = centers.shape[0]
    labels = torch.argmin(_sq_dists(x, centers), dim=-1)
    counts = comm.gsum(torch.bincount(labels, minlength=k).to(x.dtype))
    # a one-hot product, not index_add_: its atomics sum in a different
    # order on every CUDA run, which moved fits of one seed apart
    onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
    sums = comm.gsum(onehot.T @ x)
    new = sums / counts.clamp(min=1.0)[:, None]
    new = torch.where(counts[:, None] > 0, new, centers)
    return new, labels, counts


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int, max_iter: int = 50,
           tol: float = 1e-4,
           group: Optional[dist.ProcessGroup] = None) -> KMeansResult:
    """Lloyd's algorithm with k-means++ seeding; x (N, D) real, or this
    rank's window of the global rows under `group`. Stops when the total
    squared center shift < tol * mean per-dim variance (sklearn's rule) or
    at max_iter."""
    comm = Comm(group, x.shape[0], x.device)
    centers = _kmeanspp_init(gen, x, k, comm)
    tol_scaled = tol * comm.global_var(x).mean()
    for _ in range(max_iter):
        new, _, counts = _lloyd_step(x, centers, comm)
        new = _relocate_empty(x, new, counts, comm)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if bool(shift < tol_scaled):
            break
    labels = torch.argmin(_sq_dists(x, centers), dim=-1)
    return KMeansResult(centers, labels)
