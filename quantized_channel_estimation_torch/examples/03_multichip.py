"""Several devices: data-parallel EM and tensor-parallel estimation.

Port of the JAX repository's `examples/03_multichip.py`. The reference's
only parallelism is a multiprocessing pool over SNR points; here the
samples shard over the 'data' axis of a mesh (the EM's sufficient
statistics are all-reduced: the EM analog of a gradient all-reduce) and the
component bank over 'component' (each shard applies its own LMMSE filters;
the shards' online-softmax states merge exactly, with a max and two sums).

The data-parallel EM (`parallel.mesh.fit_gmm_shard_map`) runs over every
rank of the `torch.distributed` group: launched by `torchrun`, one card a
rank over NCCL, or with `--device cpu` one process a rank over Gloo; run
alone, over a one-rank group made here (NCCL on the card, Gloo on the
CPU). NCCL puts no two ranks on one card. The tensor-parallel estimation
runs on each rank over an in-process (data=2, component=4) mesh
(`parallel.mesh.make_local_mesh`): each component shard through the
split-K kernel K2 on its own CUDA stream on a card (its plain version on
the CPU), merged, and set against the one-device einsum estimate.

    python -m quantized_channel_estimation_torch.examples.03_multichip
    torchrun --nproc-per-node=2 -m quantized_channel_estimation_torch.examples.03_multichip --device cpu
"""
from __future__ import annotations

import torch.distributed as dist

from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator, process_group, say)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.parallel import mesh as pmesh

N_ANT, K, N_BITS, SNR = 16, 8, 2, 10.0
N_TRAIN, N_VAL, MAX_ITER = 16_000, 1_600, 30
TP_MESH = (2, 4)   # (data, component) of the tensor-parallel estimate
TOL = 1e-5         # the claim: sharded against single, of scale


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """(h_train, h_val), the same on every rank (drawn from the seeds)."""
    h_train, _ = scm.generate_channels(generator(0, device), n_train,
                                       scm.ScmConfig(n_ant, 1))
    h_val, _ = scm.generate_channels(generator(1, device), n_val,
                                     scm.ScmConfig(n_ant, 1))
    return h_train, h_val


def config(k=K, max_iter=MAX_ITER) -> gmm.GmmConfig:
    return gmm.GmmConfig(n_components=k, zero_mean=True, max_iter=max_iter,
                         init="random", chunk_size=1000)


def fit(h_train, cfg: gmm.GmmConfig) -> gmm.GmmFitResult:
    """The data-parallel EM over every rank of the default group (each
    rank fits its window of the rows; every rank returns the fit of all of
    them)."""
    mesh = pmesh.make_mesh(n_data=dist.get_world_size(), n_component=1)
    return pmesh.fit_gmm_shard_map(mesh, generator(2, h_train.device),
                                   h_train, cfg)


def observe(h_val, n_bits=N_BITS):
    """(a, q, r) at SNR."""
    dev = h_val.device
    a = pilots.pilot_matrix(h_val.shape[-1], 1, n_bits, device=dev)
    q = Q.design_quantizer(SNR, n_bits, device=dev)
    r = observation.observe(generator(3, dev), h_val, SNR, a, n_bits, q)
    return a, q, r


def evaluate(params, h_val, r, a, q, n_bits=N_BITS) -> dict:
    """The tensor-parallel estimate over an in-process (data, component)
    mesh against the one-device estimate: its NMSE, the largest difference
    and the one-device estimate's largest entry (the scale)."""
    bank = gmm_estimator.prepare_bank(params, SNR, a, n_bits, q)
    h_est = pmesh.estimate_sharded_kernel(pmesh.make_local_mesh(*TP_MESH),
                                          bank, r)
    h_ref = gmm_estimator.estimate(bank, r, "all")
    return {"nmse": stages.nmse(h_est, h_val),
            "max_abs_diff": float((h_est - h_ref).abs().max()),
            "scale": float(h_ref.abs().max())}


def main(device=None, n_ant=N_ANT, k=K, n_train=N_TRAIN, n_val=N_VAL,
         max_iter=MAX_ITER) -> dict:
    device = stages.rank_device(device)
    with process_group(device):
        world = dist.get_world_size()
        say(f"ranks: {world} ({dist.get_backend()})")
        h_train, h_val = data(device, n_ant, n_train, n_val)
        res = fit(h_train, config(k, max_iter))
        say(f"data-parallel EM: {int(res.n_iter)} iters, "
             f"lower bound {float(res.lower_bound):.3f}")
        a, q, r = observe(h_val)
        out = evaluate(res.params, h_val, r, a, q)
        say(f"tensor-parallel NMSE @ {SNR:.0f} dB: {out['nmse']:.4f}")
        say(f"max |sharded - single| = {out['max_abs_diff']:.3g} "
             f"(scale {out['scale']:.3g})")
    return {"ranks": world, "n_iter": int(res.n_iter),
            "lower_bound": float(res.lower_bound),
            "lb_history": [float(v) for v in res.lb_history], **out}


def check(out: dict) -> None:
    """The example's claim: the tensor-parallel estimate lies within TOL
    of scale of the one-device estimate."""
    claim(out["max_abs_diff"] <= TOL * out["scale"],
          f"sharded and single estimates {out['max_abs_diff']} apart at "
          f"scale {out['scale']}")


if __name__ == "__main__":
    cli(main, __doc__)
