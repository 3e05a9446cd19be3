"""Collectives of the data-parallel fits over one process group.

The JAX fits run under `shard_map` and reduce with `psum` / `pmax` over a
mesh axis (`models/kmeans.py` `_Comm`, `models/gmm.py`
`segmented_psum_scan`). Here the axis is a `torch.distributed` process
group: every rank holds an equal window of the global rows, and `Comm`
turns each reduction into an all-reduce over the group. With no group every
operation is the identity, so one code path serves the single-device and
the data-parallel fit.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


class Comm:
    """This rank's window [lo, lo + n_local) of n_global rows spread in
    equal windows over `group` (None: one device, every op the identity)."""

    def __init__(self, group: Optional[dist.ProcessGroup], n_local: int,
                 device):
        self.group = group
        self.n_local = n_local
        self.device = torch.device(device)
        if group is None:
            self.n_global, self.lo = n_local, 0
            return
        size, idx = dist.get_world_size(group), dist.get_rank(group)
        sizes = torch.tensor([n_local, -n_local], device=self.device)
        dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
        if int(sizes[0]) != -int(sizes[1]):
            raise ValueError(f"data-parallel ranks hold {-int(sizes[1])} to "
                             f"{int(sizes[0])} rows: the windows must be "
                             "equal")
        self.n_global, self.lo = n_local * size, n_local * idx

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the n_global rows."""
        return x[self.lo:self.lo + self.n_local]

    def gsum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group (a new tensor; real or complex)."""
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def gmax(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def global_argmax(self, scores: torch.Tensor):
        """argmax over the global score vector (`scores`: this rank's
        window); ties go to the lowest global index, as one argmax over
        the concatenated vector. One device: a tensor index; else an int."""
        li = torch.argmax(scores)
        if self.group is None:
            return li
        v = scores[li]
        gv = self.gmax(v)
        cand = torch.where(v == gv, self.lo + li,
                           torch.full_like(li, self.n_global))
        dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=self.group)
        return int(cand)

    def owns(self, gidx) -> bool:
        return self.lo <= int(gidx) < self.lo + self.n_local

    def select_row(self, x: torch.Tensor, gidx) -> torch.Tensor:
        """Row `gidx` of the global rows (x: this rank's window), summed
        from its owner."""
        if self.group is None:
            return x[gidx]
        row = (x[int(gidx) - self.lo] if self.owns(gidx)
               else torch.zeros_like(x[0]))
        return self.gsum(row)

    def global_var(self, x: torch.Tensor) -> torch.Tensor:
        """Per-column variance E|x - E x|^2 over the global rows (one
        formula with or without a group, so a one-rank group reproduces the
        single-device value)."""
        mean = self.gsum(x.sum(0)) / self.n_global
        return self.gsum(((x - mean).abs() ** 2).sum(0)) / self.n_global


def pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Real and complex tensors of one real dtype -> one flat real buffer
    (one collective carries them all)."""
    return torch.cat([(torch.view_as_real(t.resolve_conj()) if t.is_complex()
                       else t)
                      .reshape(-1) for t in tensors])


def unpack(buf: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    """The inverse of `pack`, shaped and typed as `like`."""
    out, i = [], 0
    for t in like:
        n = t.numel() * (2 if t.is_complex() else 1)
        part = buf[i:i + n]
        i += n
        if t.is_complex():
            part = torch.view_as_complex(part.reshape(t.shape + (2,)))
        out.append(part.reshape(t.shape))
    return out
