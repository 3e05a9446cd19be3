"""What the example modules share: their random streams, their command line
and the process group of the multi-rank examples."""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from quantized_channel_estimation_torch.harness import stages


def generator(seed: int, device) -> torch.Generator:
    """The stream of the JAX scripts' `jax.random.PRNGKey(seed)`: a
    `torch.Generator` on `device` seeded from `SeedSequence(seed)`, as the
    harnesses seed theirs (`stages.seed_generator`). The draws differ from
    JAX's threefry draws, so the printed numbers match the JAX scripts in
    law, not bit for bit."""
    return stages.seed_generator(np.random.SeedSequence(seed),
                                 torch.device(device))


def cli(main, doc: str, argv=None, mesh: bool = False):
    """Parse `--device` (and `--mesh DxC` where `mesh`) and call
    `main(device=..., [mesh=(D, C)])`."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default=None,
                   help="'cpu', or a CUDA device (default: the current "
                   "card, cuda:LOCAL_RANK under torchrun; raises without "
                   "one)")
    if mesh:
        p.add_argument("--mesh", default="4x2",
                       help="n_data_shards x n_component_shards of the mesh "
                       "sweep (default 4x2; their product is the number of "
                       "ranks torchrun launches)")
    args = p.parse_args(argv)
    kw = {}
    if mesh:
        n_data, n_comp = (int(v) for v in args.mesh.lower().split("x"))
        kw["mesh"] = (n_data, n_comp)
    return main(device=args.device, **kw)


@contextlib.contextmanager
def process_group(device: torch.device):
    """The default process group for the duration of the block: the one
    already initialised (left as it is), else the `torchrun` group of the
    environment (WORLD_SIZE > 1), else a one-rank group over a file store.
    NCCL for a card, Gloo for the CPU. A group made here is destroyed at
    the end of the block, and only such a group."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            from quantized_channel_estimation_torch.parallel import (
                distributed)
            distributed.initialize(backend=backend)
        else:
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def say(msg: str) -> None:
    """Print on rank 0 of the default group, or without a group."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(msg)


def bank_elements(bank) -> int:
    """The elements of a bank's tensors, a complex element counted once
    (the JAX scripts count the real arrays of each packed field)."""
    return sum(x.numel() for x in bank if isinstance(x, torch.Tensor))


def claim(holds: bool, what: str) -> None:
    """Raise AssertionError naming `what` unless the example's claim
    holds (the `check` functions, which the tests and the card's smoke run
    call)."""
    if not holds:
        raise AssertionError(f"the example's claim fails: {what}")
