"""Mesh-enabled harness sweep: the standard benchmark, data- and
tensor-parallel.

Port of the JAX repository's `examples/10_mesh_harness.py`. The benchmark
runner takes the parallelism directly: `n_data_shards` runs the GMM fit
data-parallel (the EM's sufficient statistics all-reduced over 'data', the
data-parallel k-means init the single-device one) and `n_component_shards`
shards the prepared bank for estimation (per-shard online-softmax states
merged with a max and two sums over 'component'; on the card through the
split-K kernel K2). The reference's only parallelism is a multiprocessing
pool over SNR points (`Bussgang_GMM.py:29-32`); here one knob spreads the
whole sweep over the ranks, with CSV rows that equal the single-device
run's to float32 summation order.

The mesh sweep needs exactly n_data x n_component ranks of a
`torch.distributed` group (`torchrun`: one card a rank over NCCL, or Gloo
with `--device cpu`); anything else raises with `stages.sharded_stages`'
message before any work. On one card it runs at `--mesh 1x1`. Each rank
also runs the single-device sweep, which it compares with.

    torchrun --nproc-per-node=8 -m quantized_channel_estimation_torch.examples.10_mesh_harness --device cpu
    torchrun --nproc-per-node=2 -m quantized_channel_estimation_torch.examples.10_mesh_harness --mesh 1x2 --device cpu
    python -m quantized_channel_estimation_torch.examples.10_mesh_harness --mesh 1x1
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

from quantized_channel_estimation_torch.examples._common import (
    claim, cli, process_group, say)
from quantized_channel_estimation_torch.harness import run_gmm, stages

MESH = (4, 2)
TOL = 1e-4   # the claim: mesh rows against single-device rows
SWEEP = dict(n_antennas=16, n_components=8, n_train=16_000, n_val=2_000,
             snrs=(-10, 0, 10), gmm_max_iter=20)


def sweeps(device, mesh, root, **sweep):
    """`run_gmm` on one device and over the (n_data, n_component) mesh,
    both without the genie, LS and rate columns, results under `root`
    (each rank its own directory). Returns both runs' MSE columns."""
    base = run_gmm.GmmBenchConfig(
        **{**SWEEP, **sweep}, eval_blmmse_genie=False, eval_ls_glob=False,
        eval_rate=False, use_cache=False,
        results_dir=os.path.join(root, "single"),
        cache_dir=os.path.join(root, "single"))
    say("single-device sweep...")
    mse_1, _, _ = run_gmm.run(base, verbose=False, device=device)
    n_data, n_comp = mesh
    cfg_m = dataclasses.replace(base, n_data_shards=n_data,
                                n_component_shards=n_comp,
                                results_dir=os.path.join(root, "mesh"),
                                cache_dir=os.path.join(root, "mesh"))
    say(f"{n_data}-way data x {n_comp}-way component mesh sweep...")
    mse_m, _, _ = run_gmm.run(cfg_m, verbose=False, device=device)
    return base.snrs, mse_1, mse_m


def main(device=None, mesh=MESH, **sweep) -> dict:
    device = stages.rank_device(device)
    n = mesh[0] * mesh[1]
    with process_group(device) if n > 1 else contextlib.nullcontext():
        if n > 1:
            # the group must hold exactly n ranks: refuse before any work
            stages.sharded_stages(*mesh)
        with tempfile.TemporaryDirectory() as td:
            snrs, mse_1, mse_m = sweeps(device, mesh, td, **sweep)
        label = f"mesh ({mesh[0]}x{mesh[1]})"
        say(f"\n{'SNR':>6} {'single-device':>15} {label:>12}")
        for i, snr in enumerate(snrs):
            say(f"{snr:>6} {mse_1['blmmse_gmm'][i]:>15.5f} "
                 f"{mse_m['blmmse_gmm'][i]:>12.5f}")
        rel = max(abs(a - b) / a for a, b in zip(mse_1["blmmse_gmm"],
                                                 mse_m["blmmse_gmm"]))
        say(f"\nmax relative CSV difference: {rel:.2e} "
             "(float32 summation order)")
    return {"mesh": list(mesh), "snrs": list(snrs),
            "single": {k: [float(v) for v in col]
                       for k, col in mse_1.items()},
            "mesh_rows": {k: [float(v) for v in col]
                          for k, col in mse_m.items()},
            "max_rel_diff": rel}


def check(out: dict) -> None:
    """The example's claim: every row of the mesh sweep equals the
    single-device sweep's to rtol TOL."""
    for col, rows in out["single"].items():
        for snr, one, mesh in zip(out["snrs"], rows, out["mesh_rows"][col]):
            claim(abs(mesh - one) <= TOL * abs(one),
                  f"{col} at {snr} dB: mesh {mesh} against single {one}")


if __name__ == "__main__":
    cli(main, __doc__, mesh=True)
