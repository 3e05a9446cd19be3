"""Covariance-recovery benchmark: the paper's Fig. 2 (reference
`Covariance_recovery.py`).

Port of `quantized_channel_estimation_tpu/harness/run_cov_recovery.py`
(`CovRecoveryConfig`, `run`). The NMSE of covariance estimation from n
quantized samples against n, for
(a) the proposed recovery (`ops.cov_recovery`: the 1-bit arcsine
    correlation times the erf-model per-dimension scales),
(b) the unquantized sample covariance,
(c) the naive quantized sample covariance,
written as the JAX harness's CSV (same name, columns and rows). For each n
the covariances of `mc_runs` Monte-Carlo runs are drawn from the 3GPP
model, each loaded with |N(0, 1)| on its diagonal (the equivalent SNR
10 log10(1 / (mean diagonal - 1)) designs the quantizer of its run).

Random draws come from `torch.Generator`s seeded from `cfg.seed` through
numpy's SeedSequence; `draw_covs` and `sample` are the two draws, so that
a test can hand both packages the same covariances and samples.

Deviation: `plot=False` skips the log-log PNG, which needs matplotlib
(imported only when plotting; it is not installed everywhere the port
runs). The JAX harness always plots.

    python -m quantized_channel_estimation_torch.harness.run_cov_recovery

runs the defaults on the card; `--device cpu` on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from quantized_channel_estimation_torch.harness import run_gmm, stages
from quantized_channel_estimation_torch.ops import cov_recovery, linalg, scm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import io as qio


@dataclasses.dataclass(frozen=True)
class CovRecoveryConfig:
    n_bits: int = 3
    quantizer_type: str = "uniform"
    n_dim: int = 64
    n_data_list: Sequence[int] = (10, 100, 1_000, 10_000, 100_000, 1_000_000)
    mc_runs: int = 10
    n_path: int = 1
    path_sigma: float = 2.0
    seed: int = 0
    results_dir: str = "results/cov_est_quant"
    plot: bool = True


def draw_covs(gen: torch.Generator, cfg: CovRecoveryConfig):
    """The `mc_runs` covariances (R, D, D) of one n, on the generator's
    device: 3GPP Toeplitz covariances plus |N(0, 1)| I. Returns (covs, the
    equivalent SNRs as numpy, the mean squared Frobenius norm)."""
    scm_cfg = scm.ScmConfig(cfg.n_dim, cfg.n_path, cfg.path_sigma)
    _, toep = scm.generate_channels(gen, cfg.mc_runs, scm_cfg)
    covs = linalg.toeplitz_from_first_row(toep)
    loads = torch.randn((cfg.mc_runs,), generator=gen,
                        device=gen.device).abs()
    covs = covs + loads[:, None, None].to(covs.dtype) * torch.eye(
        cfg.n_dim, dtype=covs.dtype, device=covs.device)
    sigma2_avg = torch.diagonal(covs, dim1=-2, dim2=-1).real.sum(-1) \
        / cfg.n_dim
    snr_eq = 10.0 * torch.log10(1.0 / (sigma2_avg - 1.0))
    norm = float((covs.abs() ** 2).sum(dim=(-2, -1)).mean())
    return covs, snr_eq.cpu().numpy(), norm


def sample(gen: torch.Generator, cov: torch.Tensor, n_data: int):
    """n_data draws (n, D) of CN(0, cov)."""
    l = torch.linalg.cholesky(cov)
    return crandn(gen, (n_data, cov.shape[-1]), dtype=cov.dtype) @ l.T


def run(cfg: CovRecoveryConfig, verbose: bool = True, device=None):
    """Run the benchmark on `device` (the CUDA card by default; raises when
    there is none). Returns {column: [NMSE per n]}."""
    device = stages.resolve_device(device)
    pin_fp32()
    seqs = np.random.SeedSequence(cfg.seed).spawn(len(cfg.n_data_list))
    results = {"sampcov_quant": [], "sampcov_unquant": [], "Cov_est": []}
    for n_data, seq in zip(cfg.n_data_list, seqs):
        s_cov, *s_runs = seq.spawn(1 + cfg.mc_runs)
        covs, snr_eq, norm = draw_covs(run_gmm._generator(s_cov, device),
                                       cfg)
        sse = np.zeros(3)
        for i, s_run in enumerate(s_runs):
            s_x, s_gn = s_run.spawn(2)
            cov = covs[i]
            q = Q.design_quantizer(float(snr_eq[i]), cfg.n_bits,
                                   cfg.quantizer_type).to(device)
            x = sample(run_gmm._generator(s_x, device), cov, n_data)
            r = Q.quantize(x, cfg.n_bits, q)
            c_rec = cov_recovery.recover_covariance_from_samples(
                r, q, run_gmm._generator(s_gn, device))
            c_unq = x.T @ x.conj() / n_data
            c_q = r.T @ r.conj() / n_data
            sse += [float(((cov - c).abs() ** 2).sum())
                    for c in (c_rec, c_unq, c_q)]
        mse_rec, mse_unq, mse_q = (float(v) for v in sse / cfg.mc_runs / norm)
        results["Cov_est"].append(mse_rec)
        results["sampcov_unquant"].append(mse_unq)
        results["sampcov_quant"].append(mse_q)
        if verbose:
            print(f"n_data={n_data}: recovered={mse_rec:.4g} "
                  f"unquant={mse_unq:.4g} quant={mse_q:.4g}")

    path = os.path.join(
        cfg.results_dir,
        f"3gpp_path={cfg.n_path}_dim={cfg.n_dim}_bits={cfg.n_bits}"
        f"_mcs={cfg.mc_runs}_{cfg.quantizer_type}.csv")
    qio.write_result_csv(path, list(cfg.n_data_list), results)
    if cfg.plot:
        qio.save_loglog_plot(
            path.replace(".csv", ".png"), list(cfg.n_data_list), results,
            title=f"NMSE of estimated {cfg.n_dim}x{cfg.n_dim} cov "
                  f"({cfg.n_bits}bit, {cfg.mc_runs}MC runs)",
            xlabel="data samples", ylabel="NMSE")
    return results


def _main(argv=None):
    """Run the defaults (`--device cpu` on the CPU)."""
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="'cpu', or a card (default: the current card)")
    return run(CovRecoveryConfig(), device=parser.parse_args(argv).device)


if __name__ == "__main__":
    _main()
