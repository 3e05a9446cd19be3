"""Process-group initialisation and the global mesh.

Port of `quantized_channel_estimation_tpu/parallel/distributed.py`. JAX
wires hosts together with `jax.distributed.initialize` and builds the
(data, component) mesh over every chip; here every rank is one process with
one device, joined by `torch.distributed`: NCCL between cards, Gloo on the
CPU. Under `torchrun` the rank, world size and rendezvous come from its
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), so
`initialize()` takes no arguments; a manual cluster passes all three.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from quantized_channel_estimation_torch.parallel.mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialise the default process group: NCCL when CUDA is available,
    else Gloo (or `backend`). With no arguments the `torchrun` environment
    supplies the rendezvous; a manual cluster passes the coordinator
    'host:port', the process count and this process's rank, all three.
    Under NCCL this rank's card is cuda:LOCAL_RANK."""
    args = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in args) and any(a is None for a in args):
        # a partial manual config would wait on a rendezvous of the wrong
        # shape
        raise ValueError(
            "manual cluster config needs ALL of coordinator_address, "
            f"num_processes, process_id (got {args}); pass none of them "
            "under torchrun")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def global_mesh(n_component_shards: int = 1):
    """The (data, component) mesh over every rank of the group: the data
    axis spans the rest of the ranks. Keep the component axis within a
    host, so that its collectives stay on NVLink."""
    world = dist.get_world_size()
    if world % n_component_shards:
        raise ValueError(f"{world} ranks not divisible by "
                         f"{n_component_shards} component shards")
    return make_mesh(world // n_component_shards, n_component_shards)


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global sample batch owned by this rank (uniform split
    by rank)."""
    per = global_batch // dist.get_world_size()
    start = dist.get_rank() * per
    return slice(start, start + per)
