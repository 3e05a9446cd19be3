"""Pipeline stages shared by the harness runners (single device).

Port of `quantized_channel_estimation_tpu/harness/stages.py`, single-device
subset: `generate_channels`, `pilot_matrix`, `sample_cov`, `observe`,
`blmmse_global`, `blmmse_genie`, `ls_global`, `gmm_fit`, `prepare_bank`,
`nmse`, `rate`, `rate_mf`, `estimate_auto`. The JAX stages wrap every
function in `cjit` so that complex data crosses program boundaries as
packed (re, im) reals, because the TPU runtime has no complex buffers;
PyTorch on CUDA has complex64 tensors, so here the stages are the plain
functions and `ops/boundary.py` has no port.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantized_channel_estimation_torch.estimators import blmmse, kernels, ls
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.utils import metrics


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. Without a card and without an explicit device this
    raises: the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def generate_channels(gen: torch.Generator, n_batches: int,
                      cfg: scm.ScmConfig, chunk: int = 8192):
    """Chunked SCM channel generation (bounds the (chunk, 100 N) PSD
    intermediate): (h, t) on the generator's device."""
    hs, ts = [], []
    for i0 in range(0, n_batches, chunk):
        h, t = scm.generate_channels(gen, min(chunk, n_batches - i0), cfg)
        hs.append(h)
        ts.append(t)
    return torch.cat(hs), torch.cat(ts)


def pilot_matrix(n_antennas, n_pilots, n_bits, pilot_type="angle_amp",
                 gen: Optional[torch.Generator] = None, device=None):
    """Pilot matrix A = kron(x, I); pilot_type='rand' draws from `gen`
    (seeded 0 when absent, like the JAX stage's PRNGKey(0))."""
    device = resolve_device(device)
    if pilot_type == "rand" and gen is None:
        gen = torch.Generator(device).manual_seed(0)
    return pilots.pilot_matrix(n_antennas, n_pilots, n_bits, pilot_type, gen,
                               device=device)


def sample_cov(h: torch.Tensor) -> torch.Tensor:
    """Sample covariance sum_n h_n h_n^H / N."""
    return h.T @ h.conj() / h.shape[0]


observe = observation.observe
blmmse_global = blmmse.estimate_global
blmmse_genie = blmmse.estimate_genie
ls_global = ls.estimate_global
gmm_fit = gmm.fit
prepare_bank = gmm_estimator.prepare_bank


def estimate_auto(bank: gmm_estimator.PreparedBank, r: torch.Tensor, mode):
    """'all' mode -> the estimation kernel K1 (`kernels.estimate_fused`:
    the CUDA kernel for a CUDA tensor, its plain version for a CPU tensor);
    selection modes -> the einsum estimator. The top-k kernel K4 that the
    JAX package uses for int modes is not ported yet (ROADMAP Queue 2)."""
    if mode == "all":
        return kernels.estimate_fused(bank, r)
    return gmm_estimator.estimate(bank, r, mode)


def nmse(h_est: torch.Tensor, h: torch.Tensor) -> float:
    return float(metrics.nmse(h_est, h))


def rate(h_est, h, cov, snr_db, n_bits, q, norm_clip=None) -> float:
    """Statistical rate lower bound against the global Bussgang stats."""
    b, cq = metrics.global_bussgang_stats(cov, snr_db, n_bits, q)
    return float(metrics.rate_lower_bound(h_est, h, b, cq, norm_clip))


def rate_mf(h_est, h, cov, snr_db, n_bits, q) -> float:
    """Matched-filter rate bound."""
    b, cq = metrics.global_bussgang_stats(cov, snr_db, n_bits, q)
    return float(metrics.rate_mf_bound(h_est, h, b, cq))
