"""VAE benchmark: the port of `Bussgang_VAE.py`.

Port of `quantized_channel_estimation_tpu/harness/run_vae.py`:
`VaeBenchConfig` (the same fields and defaults, plus `plot`), `run` and
`run_search`. `run` trains the selected VAE mode (genie / noisy / real,
`models.vae.train`, checkpointed every 25 epochs under `cache_dir` with the
JAX harness's key), evaluates the Bussgang-LMMSE estimate over the SNR
sweep and writes the MSE + rate CSV, the params CSV and the loss CSV (and
PNG) with the JAX harness's names and columns. With `n_coherence` T > 1
the validation channels are T-snapshot blocks and the `vae_<mode>_coh`
columns pool the decoder's predicted spectra over each block.
`run_search` is the reference's random search over (lr, batch_size),
drawing exactly the JAX harness's trials from the seed (numpy), and
ranks them in a summary CSV.

The channel dataset is `run_gmm`'s (`run_gmm._get_data`, the same cache
files as both packages' `run_gmm`) for any `channel_model` ('3gpp',
'urban-macro', 'mimo'); the VAE's width is `run_gmm.channel_dim`
(N_BS * N_MS for 'mimo'). `use_structured_bank` 'auto' estimates
through the per-sample circulant algebra for one pilot (A = x0 I).
`n_data_shards` > 1 trains data-parallel over that many ranks of an
initialised `torch.distributed` group (`vae.train(mesh=)`; effective batch
batch_size x n_data_shards); every rank evaluates the whole sweep and rank
0 alone writes the files.

Deviations: `plot=False` skips the loss PNG, which needs matplotlib
(imported only when plotting; it is not installed everywhere the port
runs); the JAX harness always plots. Random draws come from
`torch.Generator`s seeded from `cfg.seed` through numpy's SeedSequence
(data, training, observations); the two packages agree on shared data and
parameters, not on fresh draws. A checkpoint of the JAX package (Orbax)
is not read: the port keeps its own files beside it under the same key.

    python -m quantized_channel_estimation_torch.harness.run_vae --vae 1

runs the noisy mode at the defaults on the card; `--device cpu` on the
CPU; `--trials N` the random search; under `torchrun --nproc-per-node=N`
data-parallel over N ranks.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Sequence

import numpy as np
import torch

from quantized_channel_estimation_torch.harness import run_gmm, stages
from quantized_channel_estimation_torch.models import vae
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import io as qio
from quantized_channel_estimation_torch.utils.misc import (
    dict_to_csv, rand_exp)


@dataclasses.dataclass(frozen=True)
class VaeBenchConfig:
    """Mirrors the JAX `VaeBenchConfig`, every field, plus `plot`."""
    vae_mode: str = "noisy"
    n_antennas: int = 64
    n_path: int = 3
    channel_model: str = "3gpp"
    n_antennas_ms: int = 1
    n_pilots: int = 1
    n_bits: int = 2
    pilot_type: str = "angle_amp"
    quantizer_type: str = "uniform"
    snrs: Sequence[float] = (-10, -5, 0, 5, 10, 15, 20)
    epochs: int = 500
    n_layers: int = 4
    latent_dim: int = 16
    zeromean: bool = True
    fft_pre: bool = True
    lr: float = 5e-4
    batch_size: int = 200
    n_train: int = 100_000
    n_val: int = 10_000
    path_sigma: float = 2.0
    seed: int = 0
    eval_rate: bool = True
    results_dir: str = "results"
    cache_dir: str = "results/saves"
    use_cache: bool = True
    # >1: run_search redraws lr / batch_size per trial
    n_trials: int = 1
    use_structured_bank: object = "auto"
    n_coherence: int = 1
    n_data_shards: int = 1
    # write the loss PNG (matplotlib)
    plot: bool = True


def checkpoint_dir(cfg: VaeBenchConfig) -> str:
    """The JAX harness's checkpoint key: lr and batch_size in it (search
    trials share the seed), the model tag for models other than '3gpp'
    (a '3gpp' key carries none), and a data-parallel run apart from a
    single-device one."""
    base = run_gmm.data_config(cfg)
    t_coh = base.n_coherence
    return os.path.join(
        cfg.cache_dir,
        f"vae_ckpt_{cfg.vae_mode}_ant={run_gmm.channel_dim(base)}"
        + ("" if cfg.channel_model == "3gpp"
           else f"_model={run_gmm._model_tag(base)}")
        + f"_bits={cfg.n_bits}"
        f"_train={cfg.n_train}_seed={cfg.seed}_lr={cfg.lr:g}"
        f"_bs={cfg.batch_size}" + (f"_coh{t_coh}" if t_coh > 1 else "")
        + (f"_dp{cfg.n_data_shards}" if cfg.n_data_shards > 1 else ""))


def run(cfg: VaeBenchConfig, verbose: bool = True, device=None):
    """Run the benchmark on `device` (the CUDA card by default,
    cuda:LOCAL_RANK on each rank of a data-parallel run; raises when there
    is none). Returns (mse_columns, rate_columns, timings)."""
    base = run_gmm.data_config(cfg)
    dim = run_gmm.channel_dim(base)
    sharded = stages.sharded_stages(cfg.n_data_shards, 1)
    if sharded is None:
        device = stages.resolve_device(device)
    else:
        device = stages.rank_device(device)
        verbose = verbose and sharded.writer
    pin_fp32()
    t_start = time.time()
    s_data, s_fit, s_obs = np.random.SeedSequence(cfg.seed).spawn(3)

    t_coh = max(1, cfg.n_coherence)
    if t_coh > 1 and (cfg.n_train % t_coh or cfg.n_val % t_coh):
        raise ValueError(
            f"n_train={cfg.n_train} and n_val={cfg.n_val} must be "
            f"multiples of n_coherence={t_coh} (they count snapshots)")
    channels, _ = run_gmm._get_data(base, run_gmm._generator(s_data, device),
                                    sharded)
    if t_coh > 1:
        nb_train, nb_val = cfg.n_train // t_coh, cfg.n_val // t_coh
        h_train = stages.flatten_coherence(channels[:nb_train])
        # block-major rows: T consecutive rows share one angular PSD, the
        # layout `vae.estimate(coherence=T)` pools over
        h_val = stages.flatten_coherence(channels[nb_train:nb_train + nb_val])
    else:
        h_train = channels[:cfg.n_train]
        h_val = channels[cfg.n_train:cfg.n_train + cfg.n_val]
    del channels

    a = stages.pilot_matrix(dim, cfg.n_pilots, cfg.n_bits, cfg.pilot_type,
                            device=device)
    quantizers = []
    for snr in cfg.snrs:
        q = Q.design_quantizer(snr, cfg.n_bits, cfg.quantizer_type)
        quantizers.append(None if q is None else q.to(device))
    cov = stages.sample_cov(h_train)

    vcfg = vae.VaeConfig(
        n_antennas=dim, n_pilots=cfg.n_pilots, latent_dim=cfg.latent_dim,
        n_layers=cfg.n_layers, vae_mode=cfg.vae_mode, zeromean=cfg.zeromean,
        fft_pre=cfg.fft_pre, n_pilot_convs=max(0, cfg.n_pilots // 2),
        n_bits=cfg.n_bits, quantizer_type=cfg.quantizer_type, lr=cfg.lr,
        batch_size=cfg.batch_size, epochs=cfg.epochs)
    t0 = time.time()
    model, state, losses = vae.train(
        s_fit, vcfg, h_train, a, cfg.snrs, quantizers, verbose=verbose,
        checkpoint_path=checkpoint_dir(cfg) if cfg.use_cache else None,
        checkpoint_every=25, mesh=None if sharded is None else sharded.mesh)
    train_time = time.time() - t0
    if verbose:
        print(f"VAE[{cfg.vae_mode}] trained {cfg.epochs} epochs "
              f"({train_time:.0f}s), final loss {losses[-1]:.2f}")

    name = f"vae_{cfg.vae_mode}"
    mse_cols = {name: []}
    rate_cols = {f"{name}_rstat": []}
    if t_coh > 1:
        mse_cols[f"{name}_coh"] = []
        rate_cols[f"{name}_coh_rstat"] = []
    structured = (cfg.use_structured_bank
                  if cfg.use_structured_bank != "auto"
                  else cfg.n_pilots == 1)
    # genie mode is genie-aided at evaluation: its encoder sees h_val
    for snr, q, seq in zip(cfg.snrs, quantizers,
                           s_obs.spawn(len(cfg.snrs))):
        r = stages.observe(run_gmm._generator(seq, device), h_val, snr, a,
                           cfg.n_bits, q)
        for coh, suffix in ((1, ""), (t_coh, "_coh"))[:1 + (t_coh > 1)]:
            h_est = vae.estimate(model, state.params, vcfg, r, float(snr), a,
                                 q, h_true=h_val, coherence=coh,
                                 structured=structured)
            mse_cols[name + suffix].append(stages.nmse(h_est, h_val))
            if cfg.eval_rate:
                rate_cols[f"{name}{suffix}_rstat"].append(
                    stages.rate(h_est, h_val, cov, snr, cfg.n_bits, q))
    if verbose:
        for col, vals in mse_cols.items():
            print(f"{col}: mse={vals}")

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir = os.path.join(cfg.results_dir, "vae")
    fname = (f"{stamp}_vae{cfg.vae_mode}_{run_gmm._model_tag(base)}"
             f"_path={cfg.n_path}_ant={dim}_bits={cfg.n_bits}"
             f"_train={cfg.n_train}_pilot={cfg.n_pilots}"
             f"_qtype={cfg.quantizer_type}")
    cols = dict(mse_cols)
    if cfg.eval_rate:
        cols.update(rate_cols)
    if sharded is None or sharded.writer:
        qio.write_result_csv(os.path.join(out_dir, fname + ".csv"), cfg.snrs,
                             cols)
        dict_to_csv(dataclasses.asdict(cfg),
                    os.path.join(out_dir, fname + "_params.csv"))
        qio.write_result_csv(os.path.join(out_dir, fname + "_loss.csv"),
                             list(range(1, len(losses) + 1)),
                             {"loss": losses})
        if cfg.plot:
            qio.save_loss_plot(os.path.join(out_dir, fname + "_loss.png"),
                               losses)
    return mse_cols, rate_cols, {"train": train_time,
                                 "total": time.time() - t_start}


def search_trial(seed: int, trial: int):
    """(lr, batch_size) of a search trial: lr log-uniform in [1e-5, 1e-3],
    batch_size uniform in {100, ..., 299}, from numpy's
    default_rng([seed, trial]) as the JAX harness draws them."""
    rng = np.random.default_rng([seed, trial])
    lr = float(rand_exp(1e-5, 1e-3, seed=rng)[0])
    return lr, int(rng.integers(100, 300))


def run_search(cfg: VaeBenchConfig, verbose: bool = True, device=None):
    """Hyperparameter random search: `n_trials` runs of `run`, each at its
    `search_trial` (lr, batch_size) and writing its own files, then a
    summary CSV ranking the trials by mean MSE over the sweep. The other
    searchable knobs of the reference stay at cfg's values. Returns
    (best_trial_dict, all_trials list)."""
    trials = []
    for trial in range(cfg.n_trials):
        lr, batch_size = search_trial(cfg.seed, trial)
        tcfg = dataclasses.replace(cfg, lr=lr, batch_size=batch_size)
        if verbose:
            print(f"trial {trial + 1}/{cfg.n_trials}: lr={lr:.3e} "
                  f"batch_size={batch_size}")
        mse_cols, rate_cols, times = run(tcfg, verbose=verbose,
                                         device=device)
        mses = mse_cols[f"vae_{cfg.vae_mode}"]
        trials.append({"trial": trial, "lr": lr, "batch_size": batch_size,
                       "mean_mse": float(np.mean(mses)), "mse": mses,
                       "rate": rate_cols.get(f"vae_{cfg.vae_mode}_rstat"),
                       "train_time": times["train"]})
    best = min(trials, key=lambda t: t["mean_mse"])
    if verbose:
        print(f"best trial {best['trial']}: lr={best['lr']:.3e} "
              f"batch_size={best['batch_size']} "
              f"mean_mse={best['mean_mse']:.5f}")
    if cfg.n_data_shards > 1 and torch.distributed.get_rank() != 0:
        return best, trials
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out = os.path.join(cfg.results_dir, "vae",
                       f"{stamp}_vae{cfg.vae_mode}_search_summary.csv")
    cols = {"lr": [t["lr"] for t in trials],
            "batch_size": [t["batch_size"] for t in trials],
            "mean_mse": [t["mean_mse"] for t in trials],
            "best": [int(t is best) for t in trials]}
    for i, snr in enumerate(cfg.snrs):
        cols[f"mse_snr={snr:g}"] = [t["mse"][i] for t in trials]
    qio.write_result_csv(out, [t["trial"] for t in trials], cols,
                         index_name="trial")
    return best, trials


def _main(argv=None):
    """The JAX harness's options (--vae, --epochs, --trials) and --device;
    under torchrun (WORLD_SIZE > 1) data-parallel over every rank."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--vae", "-v", type=int, default=0,
                   help="0=genie 1=noisy 2=real")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--trials", type=int, default=1,
                   help=">1 runs the lr / batch_size random search")
    p.add_argument("--device", default=None,
                   help="'cpu', or a card (default: cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    cfg = VaeBenchConfig(vae_mode=["genie", "noisy", "real"][args.vae],
                         epochs=args.epochs, n_trials=args.trials,
                         n_data_shards=world)
    fn = run_search if args.trials > 1 else run
    if world == 1:
        return fn(cfg, device=args.device)
    from quantized_channel_estimation_torch.parallel import distributed
    distributed.initialize(backend="gloo" if args.device == "cpu" else None)
    try:
        return fn(cfg, device=args.device)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main()
