"""Large-antenna-array scale-up: the dense estimation path at D beyond 64.

Port of the JAX repository's `tools/scale_bench_large_d.py`: SCM channels
at dimension D (`stages.generate_channels`), a K-component GMM fitted to
them (`cov_type` 'full', 'toeplitz', ...; with `segments` > 1 the fit runs
as that many bounded executions through `models.em_driver.fit_segmented`,
the total staying `max_iter`), the dense bank at 10 dB / 2 bits under the
one-pilot matrix, and the GMM-Bussgang NMSE against the genie BLMMSE and
the global Bussgang LS estimate of the same validation observations. Then
the estimation rate at `batch` rows x `reps` through `stages.estimate_auto`
(past 2M, 2D <= 256 the wide form of K1, `csrc/grouped_wide_estimate.cu`)
against the einsum estimator (`gmm_estimator.estimate`, 4096-row chunks,
as the JAX tool times it), each the median of 5 timed rounds of `reps`
calls on row-rolled copies of one observation batch (host clock around a
synchronized round), and the largest difference of the two estimates on
that batch relative to the einsum estimate's scale. It prints, and `main`
returns, one JSON line:

  d, k, cov_type, segments, n_train, n_val, snr, n_bits, max_iter
                the configuration;
  device        the card's name (or 'cpu');
  datagen_s, fit_s, n_iter, lower_bound
                channel generation and the fit (host clock, synchronized);
  nmse_gmm, nmse_genie, nmse_ls, gmm_over_genie
                the validation NMSEs at the SNR;
  route         'wide' or 'stream': which form of K1 `estimate_auto` takes;
  rate_kernel, rate_einsum, kernel_ms, einsum_ms
                estimates per second, and ms per `batch`-row call;
  kernel_vs_einsum
                max |kernel - einsum| / max |einsum| on the timed batch;
  launches      the kernels' launches over the run (`kernels.launch_counts`).

    python -m quantized_channel_estimation_torch.tools.scale_bench_large_d \
        [D] [K] [cov_type] [segments] [--n-train 60000] [--n-val 2000] \
        [--batch 32768] [--reps 5] [--max-iter 30] [--device cpu]

The defaults are the JAX tool's: D = 256, K = 32, 'toeplitz', one segment,
60k / 2k rows, 30 iterations, 10 dB, 2 bits, 32768 rows x 5. On the card by
default; `--device cpu` with small sizes on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import (
    em_driver, gmm, gmm_estimator)
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm
from quantized_channel_estimation_torch.ops.cplx import crandn

D, K, COV, SEGMENTS = 256, 32, "toeplitz", 1
N_TRAIN, N_VAL, SNR_DB, N_BITS = 60_000, 2_000, 10.0, 2
BATCH, REPS, MAX_ITER = 32768, 5, 30


def _fit(gen, h_train, k, cov_type, segments, max_iter):
    """The GMM fit: one `gmm.fit`, or `segments` bounded segments of
    ceil(max_iter / segments) iterations through `em_driver.fit_segmented`
    (each resumed from the previous one's parameters and spectrum), the
    total staying max_iter."""
    per_seg = -(-max_iter // segments)
    cfg = gmm.GmmConfig(n_components=k, cov_type=cov_type, max_iter=per_seg,
                        chunk_size=4096)
    if segments == 1:
        return stages.gmm_fit(gen, h_train, cfg)
    return em_driver.fit_segmented(
        lambda: stages.gmm_fit(gen, h_train, cfg),
        lambda prev: stages.gmm_fit_resume(
            prev.params, h_train, cfg._replace(max_iter=min(
                per_seg, max_iter - int(prev.n_iter))),
            spectrum=prev.spectrum),
        n_segments=-(-max_iter // per_seg), max_retries=2)


def main(d: int = D, k: int = K, cov_type: str = COV,
         segments: int = SEGMENTS, n_train: int = N_TRAIN,
         n_val: int = N_VAL, batch: int = BATCH, reps: int = REPS,
         max_iter: int = MAX_ITER, device=None,
         keep: Optional[dict] = None) -> dict:
    """One run as the module docstring says; prints and returns its JSON
    record. `keep`, a dict, receives the run's fitted bank ("bank"), its
    validation observations and channels ("r", "h_val") and the timed
    batch ("batch"), for a caller that estimates on them further."""
    dev = stages.resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    kernels.reset_launch_counts()
    rec = {"d": d, "k": k, "cov_type": cov_type, "segments": segments,
           "n_train": n_train, "n_val": n_val, "snr": SNR_DB,
           "n_bits": N_BITS,
           "max_iter": max_iter,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}
    sync()
    t0 = time.time()
    # the generator's (chunk, 100 D) lattice kept about constant past D =
    # 256, as the JAX tool keeps it
    chunk = min(4096, max(512, (4096 * 256) // d))
    h, t = stages.generate_channels(gen(0), n_train + n_val,
                                    scm.ScmConfig(d, 1), chunk)
    h_train, h_val, t_val = h[:n_train], h[n_train:], t[n_train:]
    sync()
    rec["datagen_s"] = time.time() - t0

    t0 = time.time()
    fit = _fit(gen(1), h_train, k, cov_type, segments, max_iter)
    sync()
    rec.update(fit_s=time.time() - t0, n_iter=int(fit.n_iter),
               lower_bound=float(fit.lower_bound))

    a = stages.pilot_matrix(d, 1, N_BITS, device=dev)
    q = Q.design_quantizer(SNR_DB, N_BITS, device=dev)
    r = stages.observe(gen(2), h_val, SNR_DB, a, N_BITS, q)
    bank = stages.prepare_bank(fit.params, SNR_DB, a, N_BITS, q)
    rec["nmse_gmm"] = stages.nmse(stages.estimate_auto(bank, r, "all"), h_val)
    rec["nmse_genie"] = stages.chunked_genie_nmse(r, t_val, h_val, SNR_DB, a,
                                                  N_BITS, q)
    rec["nmse_ls"] = stages.nmse(stages.ls_global(
        r, stages.sample_cov(h_train), SNR_DB, a, N_BITS, q), h_val)
    rec["gmm_over_genie"] = rec["nmse_gmm"] / rec["nmse_genie"]
    rec["route"] = ("wide" if kernels.wide_form(2 * d, 2 * d)
                    else "stream")

    g3 = gen(3)
    rb = stages.observe(g3, crandn(g3, (batch, d)), SNR_DB, None, N_BITS, q)
    if keep is not None:
        keep.update(bank=bank, r=r, h_val=h_val, batch=rb)
    estimators = {
        "kernel": lambda x: stages.estimate_auto(bank, x, "all"),
        "einsum": lambda x: gmm_estimator.estimate(bank, x, "all", 4096)}
    outs = {name: fn(rb) for name, fn in estimators.items()}   # warm up
    sync()
    rec["kernel_vs_einsum"] = float((outs["kernel"] - outs["einsum"]).abs()
                                    .max() / outs["einsum"].abs().max())
    del outs
    rolled = [torch.roll(rb, i, 0) for i in range(reps)]
    for name, fn in estimators.items():
        times = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            for x in rolled:
                fn(x)
            sync()
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[2]
        rec[f"rate_{name}"] = batch * reps / dt
        rec[f"{name}_ms"] = 1e3 * dt / reps
    rec["launches"] = {n: c for n, c in kernels.launch_counts().items() if c}
    print(json.dumps(rec))
    return rec


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("d", type=int, nargs="?", default=D)
    p.add_argument("k", type=int, nargs="?", default=K)
    p.add_argument("cov_type", nargs="?", default=COV)
    p.add_argument("segments", type=int, nargs="?", default=SEGMENTS)
    p.add_argument("--n-train", type=int, default=N_TRAIN)
    p.add_argument("--n-val", type=int, default=N_VAL)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--max-iter", type=int, default=MAX_ITER)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA card)")
    a = p.parse_args(argv)
    return main(a.d, a.k, a.cov_type, a.segments, a.n_train, a.n_val,
                a.batch, a.reps, a.max_iter, device=a.device)


if __name__ == "__main__":
    cli()
