"""CSI-free training benchmark: the port of `Bussgang_GMM_quant.py`.

Port of `quantized_channel_estimation_tpu/harness/run_gmm_quant.py`: a
GMM fitted by EM on quantized pilots alone at `snr_train`
(`models.gmm_quant`, no clean channels), evaluated at the configured
SNRs; the MSE and rate rows go to one CSV with the JAX harness's name and
columns (the reference crashes at CSV time on a never-set 'genie_gmm'
key; neither package writes that field).

The channel dataset is `run_gmm`'s (`run_gmm._get_data`, the same cache
files as both packages' `run_gmm`). The GMM column estimates through the
dense bank (K1 in 'all' mode, K4 in top-k modes), through the FFT-domain
bank for circulant fits (K6, and K7 for the coherent column; the
`torch.fft` pipeline past the kernels' widths), and with `n_coherence`
T > 1 the column `blmmse_gmm_quant_coh` estimates blocks of T snapshots
jointly (K3 on the dense bank) with a fixed evidence blend or one
selected per SNR ('auto') on training blocks held out of the fit.

The frontier options, whose 'auto' values engage where JAX's do:
- `stream_pilots` (flat '3gpp' runs from D = 8192): the training pilots
  are generated and observed slab by slab (`stages.stream_quantized_pilots`)
  and the clean training set never exists; only the validation channels
  are generated whole, from their own stream, and the dataset cache is
  not used. With `eval_rate` the training sample covariance is summed
  slab by slab (a dense D x D array).
- `use_spectra_fit` ('circulant' fits from D = 2048):
  `gmm_quant.fit_circulant_spectra`, whose spectra feed
  `stages.prepare_bank_circulant_spectra`; no dense covariance exists.
- `em_chunk_size`: 'auto' is 4096 rows up to D = 1024 and 1024 beyond.
- `n_data_shards` x `n_component_shards` > 1 runs the sweep over that many
  ranks of an initialised `torch.distributed` group, as `run_gmm` does:
  the fit data-parallel over 'data' (`stages.ShardedStages`), the GMM
  columns with the samples over 'data' and the bank over 'component'
  (K2, or K8 / K9 for structured banks), rank 0 alone writing the CSV.

`channel_model` is `run_gmm`'s ('3gpp', 'urban-macro', 'mimo'; the fit's
dimension `run_gmm.channel_dim`); `stream_pilots` streams '3gpp' only, and
'auto' never streams another model. The quantized EM fits in the
observation domain with A = I: `n_pilots > 1` raises ValueError (the JAX
harness fails there too, in its bank preparation).

Random draws come from `torch.Generator`s seeded from `cfg.seed` through
numpy's SeedSequence (data, fit, observations; the streamed slabs and the
validation set from children of the data stream, which cannot collide);
the two packages agree on shared data, not on fresh draws.

    python -m quantized_channel_estimation_torch.harness.run_gmm_quant

runs the defaults on the card; `--device cpu` on the CPU; under `torchrun
--nproc-per-node=N` over N ranks.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Sequence, Union

import numpy as np
import torch

from quantized_channel_estimation_torch.harness import run_gmm, stages
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import io as qio


@dataclasses.dataclass(frozen=True)
class QuantGmmBenchConfig:
    """Mirrors the JAX `QuantGmmBenchConfig`, every field."""
    n_antennas: int = 64
    n_components: int = 64
    n_summands_or_proba: Union[str, int, float] = "all"
    n_path: int = 1
    channel_model: str = "3gpp"
    n_antennas_ms: int = 1
    n_coherence: int = 1
    coherence_alpha: object = 1.0
    alpha_val_blocks: int = 1024
    n_pilots: int = 1
    n_bits: int = 2
    cov_type: str = "full"
    blocks: tuple = None
    pilot_type: str = "angle_amp"
    quantizer_type: str = "uniform"
    snrs: Sequence[float] = (5,)
    snr_train: float = 5.0
    max_iter: int = 100
    n_train: int = 100_000
    n_val: int = 10_000
    zero_mean_gmm: bool = True
    path_sigma: float = 2.0
    seed: int = 0
    eval_rate: bool = True
    results_dir: str = "results"
    cache_dir: str = "results/saves"
    use_cache: bool = True
    use_structured_bank: object = "auto"
    n_data_shards: int = 1
    n_component_shards: int = 1
    use_spectra_fit: object = "auto"
    stream_pilots: object = "auto"
    # EM chunk (memory knob, no math effect): 'auto' is 4096 rows up to
    # D = 1024 and 1024 beyond (JAX's divisor list of n_train is a TPU
    # padding rule; the port slices rows)
    em_chunk_size: object = "auto"


def _stream_pilots(cfg: QuantGmmBenchConfig) -> bool:
    """The JAX rule: 'auto' streams flat '3gpp' runs from D = 8192 on."""
    if cfg.stream_pilots != "auto":
        return bool(cfg.stream_pilots)
    return (cfg.n_antennas >= 8192 and cfg.channel_model == "3gpp"
            and cfg.n_coherence <= 1)


def _spectra_fit(cfg: QuantGmmBenchConfig) -> bool:
    """The JAX rule: 'auto' fits circulant spectra natively from D = 2048."""
    if cfg.use_spectra_fit != "auto":
        return bool(cfg.use_spectra_fit)
    return cfg.cov_type == "circulant" and cfg.n_antennas >= 2048


def _check_supported(cfg: QuantGmmBenchConfig) -> None:
    """The refusals, before any work: an unknown channel model, several
    pilots, and the JAX harness's three ValueErrors of the frontier
    options (JAX raises the last one after the fit)."""
    run_gmm.channel_dim(run_gmm.data_config(cfg))
    if cfg.n_pilots != 1:
        raise ValueError(
            f"n_pilots={cfg.n_pilots}: the quantized EM fits in the "
            "observation domain and recovers channel covariances for A = I "
            "(one pilot) only")
    if _stream_pilots(cfg) and (cfg.n_coherence > 1
                                or cfg.channel_model != "3gpp"):
        raise ValueError("stream_pilots supports flat (n_coherence=1) "
                         "'3gpp' runs only")
    if _spectra_fit(cfg) and cfg.cov_type != "circulant":
        raise ValueError("use_spectra_fit requires cov_type='circulant'")
    if _spectra_fit(cfg) and not run_gmm._structured(cfg):
        raise ValueError("use_spectra_fit produces no dense covariances: "
                         "use_structured_bank must stay on")


def _em_chunk(cfg: QuantGmmBenchConfig) -> int:
    if cfg.em_chunk_size != "auto":
        return int(cfg.em_chunk_size)
    dim = run_gmm.channel_dim(run_gmm.data_config(cfg))
    return 4096 if dim <= 1024 else 1024


def run(cfg: QuantGmmBenchConfig, verbose: bool = True, device=None):
    """Run the benchmark on `device` (the CUDA card by default,
    cuda:LOCAL_RANK on each rank of a sharded run; raises when there is
    none). Returns (mse_columns, rate_columns, timings)."""
    _check_supported(cfg)
    sharded = stages.sharded_stages(cfg.n_data_shards, cfg.n_component_shards)
    if sharded is None:
        device = stages.resolve_device(device)
    else:
        device = stages.rank_device(device)
        sharded.check_divisible(cfg.n_train, cfg.n_val, cfg.n_components)
        verbose = verbose and sharded.writer
    pin_fp32()
    t_start = time.time()
    s_data, s_fit, s_obs = np.random.SeedSequence(cfg.seed).spawn(3)

    t_coh = max(1, cfg.n_coherence)
    if t_coh > 1 and (cfg.n_train % t_coh or cfg.n_val % t_coh):
        raise ValueError(
            f"n_train={cfg.n_train} and n_val={cfg.n_val} must be "
            f"multiples of n_coherence={t_coh} (they count snapshots)")
    auto_alpha = cfg.coherence_alpha == "auto"
    if auto_alpha and t_coh <= 1:
        raise ValueError("coherence_alpha='auto' requires n_coherence > 1")
    base_cfg = run_gmm.data_config(cfg)
    dim = run_gmm.channel_dim(base_cfg)
    stream = _stream_pilots(cfg)
    structured = run_gmm._structured(cfg)
    # one pilot: A = x I; the structured banks and the observations take
    # the scalar x (no D x D matrix at frontier D), the dense bank A
    a = stages.pilot_matrix(1 if structured else dim, cfg.n_pilots,
                            cfg.n_bits, cfg.pilot_type, device=device)
    if structured:
        a = a[0, 0]
    quantizers = {}
    for snr in sorted(set(list(cfg.snrs) + [cfg.snr_train])):
        q = Q.design_quantizer(snr, cfg.n_bits, cfg.quantizer_type)
        quantizers[snr] = None if q is None else q.to(device)
    seq_train, *seq_snrs = s_obs.spawn(1 + len(cfg.snrs))
    sigma2_train = 10.0 ** (-cfg.snr_train / 10.0)

    alpha_val_h = None
    if stream:
        # the clean training channels never exist whole; the validation
        # set has a stream of its own
        seq_slabs, seq_val = s_data.spawn(2)
        scm_cfg = scm.ScmConfig(dim, cfg.n_path, cfg.path_sigma)
        h_val, _ = stages.generate_channels(
            stages.seed_generator(seq_val, device), cfg.n_val, scm_cfg,
            chunk=stages.auto_gen_chunk(dim))
        r_train, cov = stages.stream_quantized_pilots(
            seq_slabs, seq_train, cfg.n_train, scm_cfg, cfg.snr_train, a,
            cfg.n_bits, quantizers[cfg.snr_train], want_cov=cfg.eval_rate,
            device=device)
        if verbose:
            print(f"streamed pilot datagen: {cfg.n_train} rows at D={dim}")
    else:
        channels, _ = run_gmm._get_data(
            base_cfg, run_gmm._generator(s_data, device), sharded)
        if t_coh > 1:
            nb_train, nb_val = cfg.n_train // t_coh, cfg.n_val // t_coh
            nb_fit = nb_train
            if auto_alpha:   # training blocks held out of the fit
                nb_fit = nb_train - max(1, min(cfg.alpha_val_blocks,
                                               nb_train // 10))
                alpha_val_h = channels[nb_fit:nb_train]
            h_train = stages.flatten_coherence(channels[:nb_fit])
            h_val_blocks = channels[nb_train:nb_train + nb_val]
            h_val = stages.flatten_coherence(h_val_blocks)
        else:
            h_train = channels[:cfg.n_train]
            h_val = channels[cfg.n_train:cfg.n_train + cfg.n_val]
        del channels
        cov = stages.sample_cov(h_train)
        r_train = stages.observe(run_gmm._generator(seq_train, device),
                                 h_train, cfg.snr_train, a, cfg.n_bits,
                                 quantizers[cfg.snr_train])
        del h_train

    gcfg = gmm.GmmConfig(n_components=cfg.n_components,
                         cov_type=cfg.cov_type, blocks=cfg.blocks,
                         zero_mean=cfg.zero_mean_gmm, max_iter=cfg.max_iter,
                         chunk_size=_em_chunk(cfg))
    fit_args = (run_gmm._generator(s_fit, device), r_train, gcfg,
                cfg.n_bits, sigma2_train, quantizers[cfg.snr_train])
    t0 = time.time()
    spectra = None
    if _spectra_fit(cfg):
        sfit = (sharded.gmm_quant_fit_circulant_spectra if sharded
                else stages.gmm_quant_fit_circulant_spectra)(*fit_args)
        # no dense covariance exists: the banks come from the spectra
        spectra = sfit.spectra
        dummy = torch.zeros((cfg.n_components, 1, 1), dtype=torch.complex64,
                            device=device)
        params = gmm.GmmParams(sfit.weights, sfit.means, dummy, dummy)
        n_iter, lower_bound = sfit.n_iter, sfit.lower_bound
    else:
        fit = (sharded.gmm_quant_fit if sharded
               else stages.gmm_quant_fit)(*fit_args)
        params, n_iter, lower_bound = fit.params, fit.n_iter, fit.lower_bound
    del fit_args, r_train
    fit_time = time.time() - t0
    if verbose:
        print(f"quant-GMM fit: {int(n_iter)} iters "
              f"lb={float(lower_bound):.4f} ({fit_time:.1f}s)")

    mode = cfg.n_summands_or_proba
    mse_cols = {"blmmse_gmm_quant": []}
    rate_cols = {"blmmse_gmm_quant_rstat": []}
    alpha_by_snr = {}

    def flat_est(bank, r):
        if structured and sharded:
            return sharded.estimate_circulant(bank, r, mode, cfg.blocks)
        if structured:
            return stages.estimate_circulant(bank, r, mode, cfg.blocks)
        if sharded:
            return sharded.estimate(bank, r, mode)
        return stages.estimate_auto(bank, r, mode)

    def coh_est(bank, rb, alpha):
        if structured and sharded:
            return sharded.estimate_circulant(bank, rb, mode, cfg.blocks,
                                              float(alpha))
        if structured:
            return stages.estimate_circulant_coherent(bank, rb, mode,
                                                      float(alpha),
                                                      cfg.blocks)
        if sharded:
            return sharded.estimate_coherent(bank, rb, mode, float(alpha))
        return stages.estimate_coherent_auto(bank, rb, mode, alpha)

    def coherent_alpha(bank, snr):
        if not auto_alpha:
            return cfg.coherence_alpha
        if snr not in alpha_by_snr:
            r_a = stages.observe(run_gmm._generator(alpha_seqs[snr], device),
                                 alpha_val_h, snr, a, cfg.n_bits,
                                 quantizers[snr])
            alpha_by_snr[snr], _ = gmm_estimator.select_coherence_alpha(
                lambda rb, al: coh_est(bank, rb, al), r_a, alpha_val_h)
            if verbose:
                print(f"  alpha[{snr} dB] = {alpha_by_snr[snr]}")
        return alpha_by_snr[snr]

    if t_coh > 1:
        mse_cols["blmmse_gmm_quant_coh"] = []
        rate_cols["blmmse_gmm_quant_coh_rstat"] = []
        if auto_alpha:   # streams disjoint from the eval observations
            alpha_seqs = dict(zip(cfg.snrs, s_obs.spawn(len(cfg.snrs))))
    for snr, seq in zip(cfg.snrs, seq_snrs):
        gen = run_gmm._generator(seq, device)
        if spectra is not None:
            bank = stages.prepare_bank_circulant_spectra(
                params, spectra, snr, a, cfg.n_bits, quantizers[snr],
                cfg.blocks)
        elif structured:
            bank = stages.prepare_bank_circulant(params, snr, a, cfg.n_bits,
                                                 quantizers[snr], cfg.blocks)
        else:
            bank = stages.prepare_bank(params, snr, a, cfg.n_bits,
                                       quantizers[snr])
        if t_coh > 1:
            r_blocks = stages.observe(gen, h_val_blocks, snr, a, cfg.n_bits,
                                      quantizers[snr])
            r_val = stages.flatten_coherence(r_blocks)
            res_coh = stages.flatten_coherence(
                coh_est(bank, r_blocks, coherent_alpha(bank, snr)))
            mse_cols["blmmse_gmm_quant_coh"].append(
                stages.nmse(res_coh, h_val))
            if cfg.eval_rate:
                rate_cols["blmmse_gmm_quant_coh_rstat"].append(
                    stages.rate(res_coh, h_val, cov, snr, cfg.n_bits,
                                quantizers[snr], norm_clip=0.1))
        else:
            r_val = stages.observe(gen, h_val, snr, a, cfg.n_bits,
                                   quantizers[snr])
        res = flat_est(bank, r_val)
        mse_cols["blmmse_gmm_quant"].append(stages.nmse(res, h_val))
        if cfg.eval_rate:
            rate_cols["blmmse_gmm_quant_rstat"].append(
                stages.rate(res, h_val, cov, snr, cfg.n_bits,
                            quantizers[snr], norm_clip=0.1))
    if verbose:
        print(f"mse={mse_cols['blmmse_gmm_quant']}")
        if t_coh > 1:
            print(f"mse_coh={mse_cols['blmmse_gmm_quant_coh']}")

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    coh_tag = f"_coh={t_coh}" if t_coh > 1 else ""
    model_tag = ("" if cfg.channel_model == "3gpp"
                 else f"_model={run_gmm._model_tag(base_cfg)}")
    base = (f"{stamp}_ant={dim}{model_tag}_path={cfg.n_path}{coh_tag}"
            f"_ntr={cfg.n_train // 1000}k_comp={cfg.n_components}"
            f"_pilots={cfg.n_pilots}_bits={cfg.n_bits}"
            f"_0mean={cfg.zero_mean_gmm}_sums={cfg.n_summands_or_proba}"
            f"_ptype={cfg.pilot_type}_qtype={cfg.quantizer_type}"
            f"_{cfg.cov_type}_snrtr={cfg.snr_train}")
    cols = dict(mse_cols)
    if cfg.eval_rate:
        cols.update(rate_cols)
    if sharded is None or sharded.writer:
        qio.write_result_csv(os.path.join(cfg.results_dir, "3gpp",
                                          base + ".csv"), cfg.snrs, cols)
    timings = {"fit": fit_time, "total": time.time() - t_start}
    if auto_alpha:
        timings["coherence_alpha_by_snr"] = dict(alpha_by_snr)
    return mse_cols, rate_cols, timings


if __name__ == "__main__":
    run_gmm._main(QuantGmmBenchConfig, run)
