"""Main benchmark harness: the port of `Bussgang_GMM.py`.

Port of `quantized_channel_estimation_tpu/harness/run_gmm.py` for the
'3gpp' channel model on one device: global-Bussgang BLMMSE, Bussgang-LS,
genie-Bussgang BLMMSE, the perfect-CSI rate anchor and GMM-Bussgang over an
SNR sweep, written as the same transposed MSE/rate CSV tables (same file
names, same columns in the same order). The GMM estimate runs through the
CUDA kernel K1 on a card in 'all' mode and K4 in top-k modes; with a
structured bank (`cov_type` 'circulant' / 'block-circulant' under
`use_structured_bank='auto'`, or `use_structured_bank=True`) through the
FFT-domain bank and the circulant kernels K6 (flat) and K7 (coherent), or
with `n_pilots > 1` the multi-pilot kernel K10 in its two forms. With
`n_coherence` T > 1 the dataset holds coherence blocks of T snapshots: every
per-snapshot estimator sees the flattened snapshots, and the extra column
`blmmse_gmm_coh` estimates each block jointly (K3 in 'all' mode), with a
fixed evidence blend `coherence_alpha` or one selected per SNR ('auto') on
`alpha_val_blocks` training blocks held out of the fit.

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
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import io as qio


@dataclasses.dataclass(frozen=True)
class GmmBenchConfig:
    """Mirrors the JAX `GmmBenchConfig` (and the reference's script
    constants). The port runs channel_model='3gpp', dense and structured
    banks at any n_pilots, every cov_type but the Toeplitz ones,
    gmm_fit_segments=1 and a 1 x 1 mesh; other values raise
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
    if cfg.n_data_shards * cfg.n_component_shards != 1:
        todo.append("mesh parallelism (ROADMAP Queue 1 item 15)")
    if cfg.gmm_fit_segments != 1:
        todo.append("segmented fits, em_driver.fit_segmented (ROADMAP Queue "
                    "1 item 8)")
    if cfg.cov_type in ("toeplitz", "block-toeplitz"):
        todo.append(f"cov_type={cfg.cov_type!r} (ROADMAP Queue 1 item 8)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _structured(cfg: GmmBenchConfig) -> bool:
    """Does the GMM column estimate through the FFT-domain bank? 'auto':
    for the fits whose covariances are (block-)circulant."""
    if cfg.use_structured_bank != "auto":
        return bool(cfg.use_structured_bank)
    return cfg.cov_type in ("circulant", "block-circulant")


def _generator(seq: np.random.SeedSequence,
               device: torch.device) -> torch.Generator:
    seed = int(seq.generate_state(1, dtype=np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def _model_tag(cfg: GmmBenchConfig) -> str:
    """Cache and result key of the channel model; a block-shaped dataset
    (n_coherence > 1) has its own."""
    if cfg.n_coherence > 1:
        return f"3gpp-coh{cfg.n_coherence}"
    return "3gpp"


def _get_data(cfg: GmmBenchConfig, gen: torch.Generator):
    """Load or generate the channel dataset on the generator's device:
    (h, Toeplitz first rows t). With n_coherence T > 1, h holds
    (n_train + n_val) / T blocks (B, T, N) and t one row per block."""
    device = gen.device
    n_channels = cfg.n_train + cfg.n_val
    path = qio.dataset_cache_path(cfg.cache_dir, cfg.n_antennas,
                                  _model_tag(cfg), cfg.n_path, cfg.n_train,
                                  n_channels)
    if cfg.use_cache and os.path.exists(path):
        channels, toep = qio.load_channels(path)
        return (torch.as_tensor(channels, device=device),
                torch.as_tensor(toep, device=device))
    scm_cfg = scm.ScmConfig(cfg.n_antennas, cfg.n_path, cfg.path_sigma,
                            n_coherence=cfg.n_coherence)
    h, t = stages.generate_channels(gen,
                                    n_channels // max(1, cfg.n_coherence),
                                    scm_cfg)
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

    t_coh = max(1, cfg.n_coherence)
    if t_coh > 1 and (cfg.n_train % t_coh or cfg.n_val % t_coh):
        raise ValueError(
            f"n_train={cfg.n_train} and n_val={cfg.n_val} must be multiples "
            f"of n_coherence={t_coh} (they count snapshots)")
    auto_alpha = cfg.coherence_alpha == "auto"
    if auto_alpha and t_coh <= 1:
        raise ValueError("coherence_alpha='auto' requires n_coherence > 1 "
                         "(there is no coherent column to tune)")

    channels, toep = _get_data(cfg, _generator(s_data, device))
    if t_coh > 1:
        nb_train, nb_val = cfg.n_train // t_coh, cfg.n_val // t_coh
        nb_fit = nb_train
        if auto_alpha:   # training blocks held out of the fit for 'auto'
            nb_fit = nb_train - max(1, min(cfg.alpha_val_blocks,
                                           nb_train // 10))
            alpha_val_h = channels[nb_fit:nb_train]
        h_train = stages.flatten_coherence(channels[:nb_fit])
        h_val_blocks = channels[nb_train:nb_train + nb_val]
        h_val, toep_val = stages.flatten_coherence(
            h_val_blocks, toep[nb_train:nb_train + nb_val])
    else:
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
    if t_coh > 1:
        # observe block-shaped so the coherent column sees real blocks;
        # every per-snapshot estimator takes the flattened snapshots
        r_blocks_by_snr = {
            snr: stages.observe(_generator(obs_seqs[snr], device),
                                h_val_blocks, snr, a, cfg.n_bits,
                                quantizers[snr]) for snr in cfg.snrs}
        r_by_snr = {snr: stages.flatten_coherence(r)
                    for snr, r in r_blocks_by_snr.items()}
    else:
        r_by_snr = {snr: stages.observe(_generator(obs_seqs[snr], device),
                                        h_val, snr, a, cfg.n_bits,
                                        quantizers[snr])
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
        # under 'auto' the fit sees fewer snapshots (the alpha-validation
        # blocks are held out), so its cache key differs from the full fit's
        n_train_fit = nb_fit * t_coh if t_coh > 1 else cfg.n_train
        gmm_path = qio.gmm_cache_path(cfg.cache_dir, dim, cfg.n_components,
                                      _model_tag(cfg), cfg.n_path,
                                      n_train_fit, cfg.cov_type,
                                      cfg.zero_mean_gmm)
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

        structured = _structured(cfg)

        # per-SNR banks, shared by the blmmse_gmm and blmmse_gmm_coh columns
        banks = {}

        def get_bank(snr):
            if snr not in banks:
                if structured:
                    banks[snr] = stages.prepare_bank_circulant(
                        params, snr, a, cfg.n_bits, quantizers[snr],
                        cfg.blocks)
                else:
                    banks[snr] = stages.prepare_bank(params, snr, a,
                                                     cfg.n_bits,
                                                     quantizers[snr])
            return banks[snr]

        def gmm_est(snr, r):
            if structured:
                return stages.estimate_circulant(get_bank(snr), r,
                                                 cfg.n_summands_or_proba,
                                                 cfg.blocks)
            return stages.estimate_auto(get_bank(snr), r,
                                        cfg.n_summands_or_proba)

        def coh_est(bank, rb, mode, alpha):
            if structured:
                return stages.estimate_circulant_coherent(
                    bank, rb, mode, float(alpha), cfg.blocks)
            return stages.estimate_coherent_auto(bank, rb, mode, alpha)

        eval_algo("blmmse_gmm", "gmm_rstat", gmm_est, norm_clip=0.1)

        if t_coh > 1:
            alpha_by_snr = {}
            if auto_alpha:   # streams disjoint from the eval observations
                alpha_seqs = dict(zip(cfg.snrs, s_obs.spawn(len(cfg.snrs))))

            def coherent_alpha(snr):
                """The fixed blend, or under 'auto' the grid value of least
                NMSE on the held-out training blocks observed at this
                SNR."""
                if not auto_alpha:
                    return float(cfg.coherence_alpha)
                if snr not in alpha_by_snr:
                    r_a = stages.observe(_generator(alpha_seqs[snr], device),
                                         alpha_val_h, snr, a, cfg.n_bits,
                                         quantizers[snr])
                    best, scores = gmm_estimator.select_coherence_alpha(
                        lambda rb, al: coh_est(
                            get_bank(snr), rb, cfg.n_summands_or_proba, al),
                        r_a, alpha_val_h)
                    alpha_by_snr[snr] = best
                    if verbose:
                        print(f"  alpha[{snr} dB] = {best} "
                              f"({ {k: round(v, 5) for k, v in scores.items()} })")
                return alpha_by_snr[snr]

            # block-pooled joint estimation over each coherence block
            def gmm_coh_est(snr, r):
                del r  # uses the block-shaped observations
                return stages.flatten_coherence(coh_est(
                    get_bank(snr), r_blocks_by_snr[snr],
                    cfg.n_summands_or_proba, coherent_alpha(snr)))

            eval_algo("blmmse_gmm_coh", "gmm_coh_rstat", gmm_coh_est,
                      norm_clip=0.1)
            if auto_alpha:
                timings["coherence_alpha_by_snr"] = dict(alpha_by_snr)

    timings["total"] = time.time() - t_start

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    model_tag = ("" if _model_tag(cfg) == "3gpp"
                 else f"_model={_model_tag(cfg)}")
    base = (f"{stamp}_ant={dim}{model_tag}_path={cfg.n_path}"
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
