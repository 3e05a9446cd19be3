"""What the kernel-measurement tools share: the device, the random headline
bank of the JAX `tools/kernel_bench.py` / `tools/kernel_floor_probe.py`
(`make_params`), its quantized observations, and a timer that names its
clock."""
from __future__ import annotations

import argparse
import time

import torch

from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.ops import linalg, observation, pilots
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.utils import profiling

# the headline batch of the JAX tools
N_ANT, K_COMP, N_BITS, SNR_DB, BATCH, REPEATS = 64, 64, 2, 10.0, 131072, 10


def parser(doc: str) -> argparse.ArgumentParser:
    """The options every kernel tool takes: the device and the headline
    sizes (defaults: the JAX tools')."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA card; "
                   "'cpu' runs the plain versions)")
    p.add_argument("--n-ant", type=int, default=N_ANT)
    p.add_argument("--components", type=int, default=K_COMP)
    p.add_argument("--bits", type=int, default=N_BITS)
    p.add_argument("--repeats", type=int, default=REPEATS)
    return p


def device(name) -> torch.device:
    """The tools' device: `stages.resolve_device` (raises without a card
    unless a device is named). Pins float32 products."""
    dev = stages.resolve_device(name)
    pin_fp32()
    return dev


def device_label(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions; host clock)")


def headline_bank(dev, n_ant=N_ANT, k_comp=K_COMP, n_bits=N_BITS,
                  snr=SNR_DB, n_dead=0, n_pilots=1, seed=0):
    """The JAX tools' random bank: k_comp covariances A A^H / N + I scaled
    to trace N, uniform weights (the first n_dead pushed below the dead
    floor), zero means, under the n_pilots-pilot `angle_amp` matrix (one
    pilot in the tools). Returns (bank, quantizer)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = crandn(gen, (k_comp, n_ant, n_ant))
    covs = a @ a.mH / n_ant + torch.eye(n_ant, dtype=a.dtype, device=dev)
    tr = torch.diagonal(covs, dim1=-2, dim2=-1).real.sum(-1)
    covs = covs * (n_ant / tr)[:, None, None]
    w = torch.full((k_comp,), 1.0 / k_comp, device=dev)
    w[:n_dead] = 1e-9
    params = gmm.GmmParams(w / w.sum(),
                           torch.zeros(k_comp, n_ant, dtype=a.dtype,
                                       device=dev),
                           covs, linalg.robust_precision_cholesky(covs))
    q = Q.design_quantizer(snr, n_bits, device=dev)
    a_mat = pilots.pilot_matrix(n_ant, n_pilots, n_bits, device=dev)
    return gmm_estimator.prepare_bank(params, snr, a_mat, n_bits, q), q


def observations(dev, q, n, n_ant=N_ANT, n_bits=N_BITS, snr=SNR_DB,
                 seed=1) -> torch.Tensor:
    """n quantized observations (n, N) of unit-power channels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return observation.observe(gen, crandn(gen, (n, n_ant)), snr, None,
                               n_bits, q)


def time_ms(fn, dev, reps: int) -> float:
    """Median ms of one call: CUDA events on the card (after a warm-up),
    the host clock on the CPU."""
    if dev.type == "cuda":
        return profiling.device_ms(fn, reps)
    fn()
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]
