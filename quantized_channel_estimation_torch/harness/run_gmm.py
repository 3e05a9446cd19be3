"""Main benchmark harness: the port of `Bussgang_GMM.py`.

Port of `quantized_channel_estimation_tpu/harness/run_gmm.py` for the
'3gpp' channel model on one device: global-Bussgang BLMMSE, Bussgang-LS,
genie-Bussgang BLMMSE, the perfect-CSI rate anchor and GMM-Bussgang over an
SNR sweep, written as the same transposed MSE/rate CSV tables (same file
names, same columns in the same order). The GMM estimate in 'all' mode runs
through the CUDA kernel K1 on a card.

Random draws come from `torch.Generator`s seeded from `cfg.seed` through
numpy's SeedSequence (data, GMM init, one observation stream per SNR); they
differ from the JAX package's threefry draws, so the two packages agree on
shared data (the caches both read and write), not on fresh draws.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import io as qio


@dataclasses.dataclass(frozen=True)
class GmmBenchConfig:
    """Mirrors the JAX `GmmBenchConfig` (and the reference's script
    constants). The port runs channel_model='3gpp', n_coherence=1, dense
    banks, gmm_fit_segments=1 and a 1 x 1 mesh; other values raise
    NotImplementedError naming the ROADMAP item that ports them."""
    n_antennas: int = 64
    n_components: int = 64
    n_summands_or_proba: Union[str, int, float] = "all"
    channel_model: str = "3gpp"
    n_antennas_ms: int = 1
    n_path: int = 1
    n_coherence: int = 1
    coherence_alpha: Union[float, str] = 1.0
    alpha_val_blocks: int = 1024
    n_pilots: int = 1
    n_bits: Union[int, float] = 2
    cov_type: str = "full"
    blocks: Optional[tuple] = None
    pilot_type: str = "angle_amp"
    quantizer_type: str = "uniform"
    snrs: Sequence[float] = (-10, -5, 0, 5, 10, 15, 20)
    n_train: int = 100_000
    n_val: int = 10_000
    zero_mean_gmm: bool = True
    path_sigma: float = 2.0
    seed: int = 0
    eval_blmmse_genie: bool = True
    eval_blmmse_glob: bool = True
    eval_blmmse_gmm: bool = True
    eval_ls_glob: bool = True
    eval_rate: bool = True
    results_dir: str = "results"
    cache_dir: str = "results/saves"
    use_cache: bool = True
    use_structured_bank: Union[bool, str] = "auto"
    gmm_max_iter: int = 100
    gmm_fit_segments: int = 1
    n_data_shards: int = 1
    n_component_shards: int = 1


def _check_supported(cfg: GmmBenchConfig) -> None:
    todo = []
    if cfg.channel_model != "3gpp":
        todo.append(f"channel_model={cfg.channel_model!r} (ROADMAP Queue 1 "
                    "item 14)")
    if cfg.n_coherence != 1 or cfg.coherence_alpha != 1.0:
        todo.append("coherence blocks (ROADMAP Queue 1 item 9)")
    if cfg.n_data_shards * cfg.n_component_shards != 1:
        todo.append("mesh parallelism (ROADMAP Queue 1 item 15)")
    if cfg.gmm_fit_segments != 1:
        todo.append("segmented fits, em_driver.fit_segmented (ROADMAP Queue "
                    "1 item 8)")
    if cfg.use_structured_bank is True or (
            cfg.use_structured_bank == "auto"
            and cfg.cov_type in ("circulant", "block-circulant")):
        todo.append("structured banks (ROADMAP Queue 1 item 11)")
    if cfg.cov_type != "full":
        todo.append(f"cov_type={cfg.cov_type!r} (ROADMAP Queue 1 item 8)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _generator(seq: np.random.SeedSequence,
               device: torch.device) -> torch.Generator:
    seed = int(seq.generate_state(1, dtype=np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def _get_data(cfg: GmmBenchConfig, gen: torch.Generator):
    """Load or generate the channel dataset on the generator's device:
    (h, Toeplitz first rows t)."""
    device = gen.device
    n_channels = cfg.n_train + cfg.n_val
    path = qio.dataset_cache_path(cfg.cache_dir, cfg.n_antennas, "3gpp",
                                  cfg.n_path, cfg.n_train, n_channels)
    if cfg.use_cache and os.path.exists(path):
        channels, toep = qio.load_channels(path)
        return (torch.as_tensor(channels, device=device),
                torch.as_tensor(toep, device=device))
    scm_cfg = scm.ScmConfig(cfg.n_antennas, cfg.n_path, cfg.path_sigma)
    h, t = stages.generate_channels(gen, n_channels, scm_cfg)
    if cfg.use_cache:
        qio.save_channels(path, h.cpu().numpy(), t.cpu().numpy())
    return h, t


def run(cfg: GmmBenchConfig, verbose: bool = True, device=None):
    """Run the benchmark on `device` (the CUDA card by default; raises when
    there is none). Returns (mse_columns, rate_columns, timings)."""
    _check_supported(cfg)
    device = stages.resolve_device(device)
    pin_fp32()
    t_start = time.time()
    s_data, s_gmm, s_obs = np.random.SeedSequence(cfg.seed).spawn(3)

    channels, toep = _get_data(cfg, _generator(s_data, device))
    h_train = channels[:cfg.n_train]
    h_val = channels[cfg.n_train:cfg.n_train + cfg.n_val]
    toep_val = toep[cfg.n_train:cfg.n_train + cfg.n_val]

    dim = cfg.n_antennas
    a = stages.pilot_matrix(dim, cfg.n_pilots, cfg.n_bits, cfg.pilot_type,
                            device=device)
    quantizers = {}
    for snr in cfg.snrs:
        q = Q.design_quantizer(snr, cfg.n_bits, cfg.quantizer_type)
        quantizers[snr] = None if q is None else q.to(device)

    cov = stages.sample_cov(h_train)
    mse_cols: dict = {}
    rate_cols: dict = {}
    timings: dict = {}

    obs_seqs = dict(zip(cfg.snrs, s_obs.spawn(len(cfg.snrs))))
    r_by_snr = {snr: stages.observe(_generator(obs_seqs[snr], device), h_val,
                                    snr, a, cfg.n_bits, quantizers[snr])
                for snr in cfg.snrs}

    def eval_algo(name, rate_name, est_fn, norm_clip=None):
        t0 = time.time()
        mses, rates = [], []
        for snr in cfg.snrs:
            res = est_fn(snr, r_by_snr[snr])
            mses.append(stages.nmse(res, h_val))
            if cfg.eval_rate:
                rates.append(stages.rate(res, h_val, cov, snr, cfg.n_bits,
                                         quantizers[snr], norm_clip))
        mse_cols[name] = mses
        if cfg.eval_rate:
            rate_cols[rate_name] = rates
        timings[name] = time.time() - t0
        if verbose:
            print(f"{name}: mse={[round(m, 5) for m in mses]} "
                  f"({timings[name]:.1f}s)")

    if cfg.eval_blmmse_glob:
        eval_algo("blmmse_glob", "blmmse_glob_rstat",
                  lambda snr, r: stages.blmmse_global(
                      r, cov, snr, a, cfg.n_bits, quantizers[snr]))

    if cfg.eval_ls_glob:
        # two LS rate rows: the matched-filter bound and the statistical one
        ls_results = {}

        def ls_est(snr, r):
            ls_results[snr] = stages.ls_global(r, cov, snr, a, cfg.n_bits,
                                               quantizers[snr])
            return ls_results[snr]

        eval_algo("LS_glob", "LS_glob_stat", ls_est)
        if cfg.eval_rate:
            rate_cols["LS_glob_rstat_mf"] = [
                stages.rate_mf(ls_results[snr], h_val, cov, snr, cfg.n_bits,
                               quantizers[snr]) for snr in cfg.snrs]

    if cfg.eval_blmmse_genie:
        eval_algo("blmmse_genie", "blmmse_genie_rstat",
                  lambda snr, r: stages.blmmse_genie(
                      r, toep_val, snr, a, cfg.n_bits, quantizers[snr]))

    if cfg.eval_rate:
        rate_cols["perfect_rstat"] = [
            stages.rate(h_val, h_val, cov, snr, cfg.n_bits, quantizers[snr])
            for snr in cfg.snrs]

    if cfg.eval_blmmse_gmm:
        gmm_path = qio.gmm_cache_path(cfg.cache_dir, dim, cfg.n_components,
                                      "3gpp", cfg.n_path, cfg.n_train,
                                      cfg.cov_type, cfg.zero_mean_gmm)
        t0 = time.time()
        if cfg.use_cache and os.path.exists(gmm_path):
            params = qio.load_gmm_params(gmm_path, device)
        else:
            gcfg = gmm.GmmConfig(n_components=cfg.n_components,
                                 cov_type=cfg.cov_type, blocks=cfg.blocks,
                                 zero_mean=cfg.zero_mean_gmm,
                                 max_iter=cfg.gmm_max_iter)
            fit = stages.gmm_fit(_generator(s_gmm, device), h_train, gcfg)
            params = fit.params
            if verbose:
                print(f"GMM fit: {fit.n_iter} iters, "
                      f"lb={float(fit.lower_bound):.4f}, "
                      f"converged={fit.converged}")
            if cfg.use_cache:
                qio.save_gmm_params(gmm_path, params)
        timings["gmm_fit"] = time.time() - t0

        def gmm_est(snr, r):
            bank = stages.prepare_bank(params, snr, a, cfg.n_bits,
                                       quantizers[snr])
            return stages.estimate_auto(bank, r, cfg.n_summands_or_proba)

        eval_algo("blmmse_gmm", "gmm_rstat", gmm_est, norm_clip=0.1)

    timings["total"] = time.time() - t_start

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    base = (f"{stamp}_ant={dim}_path={cfg.n_path}"
            f"_ntrain={cfg.n_train}_comp={cfg.n_components}"
            f"_pilots={cfg.n_pilots}_bits={cfg.n_bits}"
            f"_0mean={cfg.zero_mean_gmm}_sums={cfg.n_summands_or_proba}"
            f"_ptype={cfg.pilot_type}_qtype={cfg.quantizer_type}"
            f"_{cfg.cov_type}")
    out_dir = os.path.join(cfg.results_dir, "3gpp")
    qio.write_result_csv(os.path.join(out_dir, base + ".csv"),
                         cfg.snrs, mse_cols)
    if cfg.eval_rate:
        qio.write_result_csv(os.path.join(out_dir, base + "_rate.csv"),
                             cfg.snrs, rate_cols)
    return mse_cols, rate_cols, timings


if __name__ == "__main__":
    run(GmmBenchConfig())
