"""MFA-Bussgang benchmark: the port of `Bussgang_MFA.py`.

Port of `quantized_channel_estimation_tpu/harness/run_mfa.py` for the
'3gpp' channel model on one device: fit a complex mixture of factor
analyzers on clean channels (n_path=3, latent dim N/4, PPCA, zero mean),
then estimate over the SNR sweep and write the MSE and rate rows to one
CSV (the JAX harness's file name and columns: `blmmse_mfa`, `mfa_rstat`,
and with `n_coherence` T > 1 `blmmse_mfa_coh`, `mfa_coh_rstat`).

With `use_factored_bank` 'auto' (on for n_bits != 1 under one pilot) the
fit stays factored: per-SNR Woodbury banks (`stages.prepare_bank_factored`)
and estimation through the factored kernels, K11 for the flat column and
K12 for the coherent one ('all' mode within
`fact_kernels.fact_kernel_eligible`; else the `torch.matmul` pipeline).
False densifies the fit once (`mfa.to_gmm_params`) and estimates through
the dense bank, K1 and K3. The data set is `run_gmm`'s (the same cache
file). Random draws come from `torch.Generator`s seeded from `cfg.seed`
through numpy's SeedSequence (data, fit, one observation stream per SNR),
so the two packages agree on shared data, not on fresh draws.

`n_data_shards` x `n_component_shards` > 1 runs over that many ranks of an
initialised `torch.distributed` group, as `run_gmm` does: the MFA EM
data-parallel (`stages.ShardedStages.mfa_fit`), the factored or dense
estimates with the samples over 'data' and the bank over 'component';
rank 0 writes the CSV and the cache. Not ported yet, raising
NotImplementedError: `channel_model` other than '3gpp' (ROADMAP Queue 1
item 14).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Sequence, Union

import numpy as np

from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.harness.run_gmm import (
    GmmBenchConfig, _generator, _get_data, _main)
from quantized_channel_estimation_torch.models import gmm_estimator, mfa
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import io as qio


@dataclasses.dataclass(frozen=True)
class MfaBenchConfig:
    """Mirrors the JAX `MfaBenchConfig` (`Bussgang_MFA.py:27-42`)."""
    n_antennas: int = 64
    n_components: int = 64
    n_summands_or_proba: Union[str, int, float] = "all"
    n_path: int = 3
    channel_model: str = "3gpp"
    n_antennas_ms: int = 1
    n_coherence: int = 1
    coherence_alpha: Union[float, str] = 1.0
    alpha_val_blocks: int = 1024
    n_pilots: int = 1
    n_bits: int = 2
    pilot_type: str = "angle_amp"
    quantizer_type: str = "uniform"
    snrs: Sequence[float] = (-10, -5, 0, 5, 10, 15, 20)
    latent_dim: int = 16  # n_antennas // 4
    ppca: bool = True
    lock_psis: bool = False
    zero_mean: bool = True
    max_iter: int = 100
    n_train: int = 100_000
    n_val: int = 10_000
    path_sigma: float = 2.0
    seed: int = 0
    eval_rate: bool = True
    results_dir: str = "results"
    cache_dir: str = "results/saves"
    use_cache: bool = True
    use_factored_bank: Union[bool, str] = "auto"
    n_data_shards: int = 1
    n_component_shards: int = 1


def _check_supported(cfg: MfaBenchConfig) -> None:
    todo = []
    if cfg.channel_model != "3gpp":
        todo.append(f"channel_model={cfg.channel_model!r} (ROADMAP Queue 1 "
                    "item 14)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _factored(cfg: MfaBenchConfig) -> bool:
    """Does the sweep estimate through the factored bank? 'auto': where it
    is exact, n_bits != 1 under the one scaled-identity pilot."""
    factored = (cfg.use_factored_bank
                if isinstance(cfg.use_factored_bank, bool)
                else (cfg.n_bits != 1 and cfg.n_pilots == 1))
    if factored and cfg.n_pilots != 1:
        raise ValueError("use_factored_bank requires the P=1 "
                         "scaled-identity pilot")
    if factored and cfg.n_bits == 1:
        raise ValueError("use_factored_bank does not support 1-bit "
                         "(arcsine destroys low rank); set it False")
    return factored


def run(cfg: MfaBenchConfig, verbose: bool = True, device=None):
    """Run the benchmark on `device` (the CUDA card by default, cuda:LOCAL_RANK
    on each rank of a sharded run; raises when there is none). Returns
    (mse_columns, rate_columns, timings)."""
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
    factored = _factored(cfg)
    base = GmmBenchConfig(n_antennas=cfg.n_antennas, n_path=cfg.n_path,
                          n_train=cfg.n_train, n_val=cfg.n_val,
                          path_sigma=cfg.path_sigma, cache_dir=cfg.cache_dir,
                          use_cache=cfg.use_cache, n_coherence=t_coh)
    dim = cfg.n_antennas
    channels, _ = _get_data(base, _generator(s_data, device), sharded)
    if t_coh > 1:
        nb_train, nb_val = cfg.n_train // t_coh, cfg.n_val // t_coh
        nb_fit = nb_train
        if auto_alpha:   # training blocks held out of the fit for 'auto'
            nb_fit = nb_train - max(1, min(cfg.alpha_val_blocks,
                                           nb_train // 10))
            alpha_val_h = channels[nb_fit:nb_train]
        h_train = stages.flatten_coherence(channels[:nb_fit])
        h_val_blocks = channels[nb_train:nb_train + nb_val]
        h_val = stages.flatten_coherence(h_val_blocks)
    else:
        h_train = channels[:cfg.n_train]
        h_val = channels[cfg.n_train:cfg.n_train + cfg.n_val]

    a = stages.pilot_matrix(dim, cfg.n_pilots, cfg.n_bits, cfg.pilot_type,
                            device=device)
    quantizers = {}
    for snr in cfg.snrs:
        q = Q.design_quantizer(snr, cfg.n_bits, cfg.quantizer_type)
        quantizers[snr] = None if q is None else q.to(device)
    cov = stages.sample_cov(h_train)

    # zero-responsibility guard selection rule (`Bussgang_MFA.py:118-122`)
    rs_clip = 1e-3 if (not (cfg.lock_psis or cfg.ppca)) or cfg.zero_mean \
        else 0.0
    mcfg = mfa.MfaConfig(
        n_components=cfg.n_components, latent_dim=cfg.latent_dim,
        ppca=cfg.ppca, lock_psis=cfg.lock_psis, zero_mean=cfg.zero_mean,
        rs_clip=rs_clip, max_iter=cfg.max_iter)
    t0 = time.time()
    res_fit = (sharded.mfa_fit if sharded else stages.mfa_fit)(
        _generator(s_fit, device), h_train, mcfg)
    # only densify when the factored path is off: the factored bank keeps
    # the O(K D M) representation end to end
    params = None if factored else stages.mfa_to_gmm(res_fit.params, 1e-6)
    fit_time = time.time() - t0
    if verbose:
        print(f"MFA fit: {int(res_fit.n_iter)} iters "
              f"ll={float(res_fit.log_likelihood):.1f} ({fit_time:.1f}s)"
              + (" [factored bank]" if factored else ""))

    mse_cols = {"blmmse_mfa": []}
    rate_cols = {"mfa_rstat": []}
    alpha_by_snr = {}
    if t_coh > 1:
        mse_cols["blmmse_mfa_coh"] = []
        rate_cols["mfa_coh_rstat"] = []

    if factored and sharded:
        est_flat = sharded.estimate_factored
        est_coh = sharded.estimate_factored
    elif factored:
        est_flat = stages.estimate_factored
        est_coh = stages.estimate_factored_coherent
    elif sharded:
        est_flat = sharded.estimate
        est_coh = sharded.estimate_coherent
    else:
        est_flat = stages.estimate_auto
        est_coh = stages.estimate_coherent_auto

    obs_seqs = s_obs.spawn(len(cfg.snrs))
    if auto_alpha:   # streams disjoint from the eval observations
        alpha_seqs = s_obs.spawn(len(cfg.snrs))

    def coherent_alpha(bank, snr, i):
        """The fixed blend, or under 'auto' the grid value of least NMSE on
        the held-out training blocks observed at this SNR."""
        if not auto_alpha:
            return float(cfg.coherence_alpha)
        if snr not in alpha_by_snr:
            r_a = stages.observe(_generator(alpha_seqs[i], device),
                                 alpha_val_h, snr, a, cfg.n_bits,
                                 quantizers[snr])
            best, _ = gmm_estimator.select_coherence_alpha(
                lambda rb, al: est_coh(bank, rb, cfg.n_summands_or_proba,
                                       al), r_a, alpha_val_h)
            alpha_by_snr[snr] = best
            if verbose:
                print(f"  alpha[{snr} dB] = {best}")
        return alpha_by_snr[snr]

    for i, snr in enumerate(cfg.snrs):
        gen = _generator(obs_seqs[i], device)
        if factored:
            bank = stages.prepare_bank_factored(res_fit.params, snr, a,
                                                cfg.n_bits, quantizers[snr])
        else:
            bank = stages.prepare_bank(params, snr, a, cfg.n_bits,
                                       quantizers[snr])
        if t_coh > 1:
            r_blocks = stages.observe(gen, h_val_blocks, snr, a, cfg.n_bits,
                                      quantizers[snr])
            r_val = stages.flatten_coherence(r_blocks)
            res_coh = stages.flatten_coherence(est_coh(
                bank, r_blocks, cfg.n_summands_or_proba,
                coherent_alpha(bank, snr, i)))
            mse_cols["blmmse_mfa_coh"].append(stages.nmse(res_coh, h_val))
            if cfg.eval_rate:
                rate_cols["mfa_coh_rstat"].append(
                    stages.rate(res_coh, h_val, cov, snr, cfg.n_bits,
                                quantizers[snr]))
        else:
            r_val = stages.observe(gen, h_val, snr, a, cfg.n_bits,
                                   quantizers[snr])
        res = est_flat(bank, r_val, cfg.n_summands_or_proba)
        mse_cols["blmmse_mfa"].append(stages.nmse(res, h_val))
        if cfg.eval_rate:
            rate_cols["mfa_rstat"].append(
                stages.rate(res, h_val, cov, snr, cfg.n_bits,
                            quantizers[snr]))
    if verbose:
        print(f"blmmse_mfa: mse={mse_cols['blmmse_mfa']}")
        if t_coh > 1:
            print(f"blmmse_mfa_coh: mse={mse_cols['blmmse_mfa_coh']}")

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir = os.path.join(cfg.results_dir, "3gpp")
    coh_tag = f"_coh={t_coh}" if t_coh > 1 else ""
    # the JAX name's `_model=` tag is empty for the '3gpp' model
    name = (f"{stamp}_ant={dim}_path={cfg.n_path}{coh_tag}"
            f"_train={cfg.n_train}_comp={cfg.n_components}"
            f"_pil={cfg.n_pilots}_bits={cfg.n_bits}"
            f"_sums={cfg.n_summands_or_proba}_L={cfg.latent_dim}"
            f"_PPCA={cfg.ppca}_lockpsi={cfg.lock_psis}"
            f"_ptype={cfg.pilot_type}_qtype={cfg.quantizer_type}"
            f"_0mean={cfg.zero_mean}")
    cols = dict(mse_cols)
    if cfg.eval_rate:
        cols.update(rate_cols)
    if sharded is None or sharded.writer:
        qio.write_result_csv(os.path.join(out_dir, name + ".csv"), cfg.snrs,
                             cols)
    timings = {"fit": fit_time, "mfa_iters": int(res_fit.n_iter),
               "total": time.time() - t_start}
    if auto_alpha:
        timings["coherence_alpha_by_snr"] = dict(alpha_by_snr)
    return mse_cols, rate_cols, timings


if __name__ == "__main__":
    _main(MfaBenchConfig, run)
