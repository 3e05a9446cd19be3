"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of every CUDA kernel of the port from `csrc/` with `nvcc`;
  2. every kernel against its plain PyTorch version on the card, at the
     widths of the main path (D = M = 64, K = 64): K1 at the headline batch
     N = 131072, at the main path's ragged N = 10000 and with dead
     components; K3 at B*T = 131072 rows for T in {2, 4, 16} and alpha in
     {1, 0.25}, and at a ragged block count with dead components; K4 for
     k in {1, 2, 4, 8} at N = 131072, and at a ragged N with dead
     components (rows whose k-th and (k+1)-th logits lie within 1e-3 are
     counted, not compared); the circulant kernels on a seeded circulant
     bank (2-bit, 10 dB): K6 at the same three sizes, K7 over the same
     (T, alpha) grid and ragged case, K8 and K9 as a two-shard split of
     the K = 64 bank merged with `merge_stats` and inverse-transformed
     once, against K6 / K7 and against the plain stats, one
     block-circulant case `blocks=(8, 8)` and two other template widths
     (D = 32 with K = 40, D = 128 with K = 128), and K8 / K9 on the two
     128-component shards of a K = 256 bank, as the K = 256 service runs
     them, at a 512-row microbatch and at N = 131072; the multi-pilot
     circulant kernel K10 on seeded banks under the kron(x, I) pilot of
     `pilots.pilot_matrix`: P in {2, 3, 4} pilots at D, K = (16, 8),
     (24, 40), (64, 64) with dead components and a ragged N, 1-bit and
     unquantized banks, `blocks=(8, 8)`, the widest instantiation (D = K =
     128, P = 4), and its coherent form over the same (T, alpha) grid at
     N = 131072, a ragged block count and the largest T of both tile
     sizes; the factored (MFA) kernels on seeded MFA priors (D = K = 64,
     M = 16, 2-bit, 10 dB, zero and non-zero means, dead components): K11
     and K13 at N = 131072, the main path's N and a ragged N, K12 for T = 4
     at alpha in {1, 0.25, 0}, T = 16 and a ragged block count, the edges
     M = 6 and D = 32, and K13 as a two-shard split merged with
     `merge_stats` against K11. Where float32 sums in
     another order push a circulant or factored kernel past TOL of its plain
     version (large T, or K10's one long logit product), both are held
     against the float64 evaluation of the same
     arithmetic, the kernel to within twice the plain version's own error;
  3. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after: `run_gmm.run` at the `GmmBenchConfig`
     defaults, and again with `n_coherence=4` (alpha 1), then both once
     more with `cov_type='circulant'` (the FFT-domain bank, K6 and K7),
     and those two with `n_pilots=2` (the multi-pilot bank, K10 and its
     coherent form), with the scientific invariants of their MSE tables and
     the multi-pilot estimate held against the dense bank's (K1 at M = 128)
     from the same fit; `run_mfa.run` at the `MfaBenchConfig` defaults
     (the factored bank, K11) and with `n_coherence=4` (K12), its MSE
     invariants checked and the factored estimate held against the dense
     bank's (K1) from the same fit at -10 and 10 dB; then the
     `EstimationService` at the headline widths (the synthetic bank of
     `tools/serving_bench.py`, 8 closed-loop clients of 64-snapshot
     requests at -5/5/15 dB, max_batch 1024) in ten modes: flat 'all',
     T=4 blocks, top-1 and top-4, each held against the plain einsum
     estimator on one request; `structured=True` flat and T=4 blocks (K6,
     K7) and `from_circulant_spectra` with K = 256 components flat and
     T=4 blocks (two shards through K8 / K9, merged), and
     `structured=True` with a P = 2 kron(x, I) matrix flat and T=4 blocks
     (K10 and its coherent form), each held against the `torch.fft`
     pipeline, and `from_mfa` with a seeded MFA prior (D = K = 64, M = 16)
     flat and T=4 blocks (K11, K12), held against the `torch.matmul`
     pipeline; with its throughput, latency and `metrics()`;
  4. CUDA-event times of each kernel, its plain version and a library
     yardstick at the headline shapes (K11-K13 at M = 16), beside the
     least time the card could take;
then one JSON line of kernels, one of the main paths' results, one of the
serving phase, the card line, and the final status line. It imports nothing
of JAX and uses one card.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 1e-4          # max |kernel - plain| / max |plain|, float32 sums
TIE_GAP = 1e-3      # top-k rows closer than this to a tie are not compared
N_BENCH, D, K, N_BITS, SNR = 131072, 64, 64, 2, 10.0
K_WIDE = 256        # components of the spectra-native serving prior
M_LAT = 16          # latent rank of the MFA priors (run_mfa's D / 4)
SERVE_SNRS = (-5.0, 5.0, 15.0)
SERVE_CLIENTS, SERVE_REQ, SERVE_MAX_BATCH, SERVE_SECONDS = 8, 64, 1024, 3.0


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_bank(dev, n_dead=0):
    """A random full-covariance zero-mean GMM bank as the headline
    benchmark builds it: K covariances A A^H / D + I scaled to trace D,
    uniform weights (n_dead of them pushed below the dead floor)."""
    from quantized_channel_estimation_torch.models import gmm, gmm_estimator
    from quantized_channel_estimation_torch.ops import linalg, pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.ops.cplx import crandn
    gen = torch.Generator(device=dev).manual_seed(0)
    a = crandn(gen, (K, D, D))
    covs = a @ a.mH / D + torch.eye(D, dtype=a.dtype, device=dev)
    tr = torch.diagonal(covs, dim1=-2, dim2=-1).real.sum(-1)
    covs = covs * (D / tr)[:, None, None]
    w = torch.full((K,), 1.0 / K, device=dev)
    w[:n_dead] = 1e-9
    params = gmm.GmmParams(w / w.sum(),
                           torch.zeros(K, D, dtype=a.dtype, device=dev),
                           covs, linalg.robust_precision_cholesky(covs))
    q = Q.design_quantizer(SNR, N_BITS).to(dev)
    a_mat = pilots.pilot_matrix(D, 1, N_BITS, device=dev)
    return gmm_estimator.prepare_bank(params, SNR, a_mat, N_BITS, q), q


def bench_obs(dev, q, n, d=D):
    """Quantized observations of unit-power channels at 10 dB, 2 bits."""
    from quantized_channel_estimation_torch.ops import observation
    from quantized_channel_estimation_torch.ops.cplx import crandn
    gen = torch.Generator(device=dev).manual_seed(1)
    h = crandn(gen, (n, d))
    return observation.observe(gen, h, SNR, None, N_BITS, q)


def circ_prior(dev, d=D, k=K, n_dead=0):
    """A seeded circulant prior: spectra uniform on [0.05, 2] (as the
    structured-bank tests draw them), small non-zero means, uniform weights
    (n_dead of them pushed below the dead floor). Returns (params with
    placeholder covariances, spectra)."""
    from quantized_channel_estimation_torch.models import gmm
    rng = np.random.default_rng(0)
    spectra = torch.as_tensor(
        rng.uniform(0.05, 2.0, (k, d)).astype(np.float32), device=dev)
    means = torch.as_tensor(
        (0.2 * (rng.standard_normal((k, d))
                + 1j * rng.standard_normal((k, d)))).astype(np.complex64),
        device=dev)
    w = torch.full((k,), 1.0 / k, device=dev)
    w[:n_dead] = 1e-9
    dummy = torch.zeros((k, 1, 1), dtype=torch.complex64, device=dev)
    return gmm.GmmParams(w / w.sum(), means, dummy, dummy), spectra


def circ_bank(dev, q, d=D, k=K, n_dead=0, blocks=None):
    """The bank of `circ_prior` at 2 bits, 10 dB, under the scalar pilot
    x0 = 1."""
    from quantized_channel_estimation_torch.models import structured_bank
    params, spectra = circ_prior(dev, d, k, n_dead)
    return structured_bank.prepare_bank_circulant(
        params, SNR, torch.tensor(1.0 + 0.0j), N_BITS, q, blocks=blocks,
        spectra=spectra)


def mp_bank(dev, p, d=D, k=K, n_bits=N_BITS, n_dead=0, blocks=None):
    """The multi-pilot bank of `circ_prior` at 10 dB under the P-pilot
    matrix A = kron(x, I) of `pilots.pilot_matrix`. Returns (bank, A,
    quantizer)."""
    from quantized_channel_estimation_torch.models import structured_bank
    from quantized_channel_estimation_torch.ops import pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    params, spectra = circ_prior(dev, d, k, n_dead)
    q = Q.design_quantizer(SNR, n_bits)
    q = None if q is None else q.to(dev)
    a = pilots.pilot_matrix(d, p, n_bits, device=dev)
    bank = structured_bank.prepare_bank_circulant(
        params, SNR, a, n_bits, q, blocks=blocks, spectra=spectra)
    return bank, a, q


def mp_obs(dev, a, q, n, n_bits=N_BITS):
    """Quantized multi-pilot observations (n, P D) of unit-power channels
    at 10 dB under the pilot matrix a (P D, D)."""
    from quantized_channel_estimation_torch.ops import observation
    from quantized_channel_estimation_torch.ops.cplx import crandn
    gen = torch.Generator(device=dev).manual_seed(1)
    h = crandn(gen, (n, a.shape[1]))
    return observation.observe(gen, h, SNR, a, n_bits, q)


def mfa_prior(dev, d=D, k=K, m=M_LAT, n_dead=0, zero_mean=True, seed=0):
    """Seeded MFA parameters: loadings of total power 0.8 a dimension, psi
    uniform on [0.05, 0.35], means zero or 0.3 CN(0, 1), weights uniform
    on [0.5, 1.5] (n_dead of them pushed below the dead floor)."""
    from quantized_channel_estimation_torch.models import mfa
    rng = np.random.default_rng(seed)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    w = rng.uniform(0.5, 1.5, k)
    w[:n_dead] = 1e-9
    params = (w / w.sum(), np.zeros((k, d)) if zero_mean else 0.3 * cr(k, d),
              np.sqrt(0.8 / m) * cr(k, d, m), rng.uniform(0.05, 0.35, (k, d)))
    return mfa.MfaParams(*(torch.as_tensor(
        x.astype(np.complex64 if np.iscomplexobj(x) else np.float32),
        device=dev) for x in params))


def mfa_bank_obs(dev, q, n, **prior):
    """The factored bank of `mfa_prior(**prior)` at 2 bits, 10 dB under
    x0 = 1, and n quantized observations of channels drawn from the
    mixture."""
    from quantized_channel_estimation_torch.models import mfa_bank
    from quantized_channel_estimation_torch.ops import observation
    from quantized_channel_estimation_torch.ops.cplx import crandn
    p = mfa_prior(dev, **prior)
    k, d, m = p.lambdas.shape
    gen = torch.Generator(device=dev).manual_seed(1)
    c = torch.randint(0, k, (n,), generator=gen, device=dev)
    h = (p.means[c] + (p.lambdas[c] @ crandn(gen, (n, m, 1)))[..., 0]
         + p.psis[c].sqrt() * crandn(gen, (n, d)))
    bank = mfa_bank.prepare_bank_factored(p, SNR, torch.tensor(1.0 + 0.0j),
                                          N_BITS, q)
    return bank, observation.observe(gen, h, SNR, None, N_BITS, q)


def serving_params():
    """The synthetic GMM of `tools/serving_bench.py` (`synthetic_params`):
    K random covariances A A^H / D + I, uniform weights, zero means, numpy
    seed 0; the precision Cholesky P = (L^-1)^H."""
    from quantized_channel_estimation_torch.models import gmm
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K, D, D)) + 1j * rng.standard_normal((K, D, D))
    covs = (a @ a.conj().transpose(0, 2, 1) / D
            + np.eye(D)[None]).astype(np.complex64)
    chol = np.linalg.cholesky(covs)
    linv = np.stack([np.linalg.solve(lk, np.eye(D)) for lk in chol])
    prec = np.ascontiguousarray(linv.conj().transpose(0, 2, 1)).astype(
        np.complex64)
    return gmm.GmmParams(np.full((K,), 1.0 / K, np.float32),
                         np.zeros((K, D), np.complex64), covs, prec)


def cuda_ms(fn, reps=5):
    """Median over `reps` of one call timed with CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def near_ties(r2, kb, k_sel):
    """Rows whose k-th and (k+1)-th largest logits lie within TIE_GAP: the
    kernel's and the plain version's float32 sums may order them
    differently."""
    from quantized_channel_estimation_torch.estimators import kernels
    lg = kernels.component_logits(r2, kb).sort(-1, descending=True).values
    return (lg[:, k_sel - 1] - lg[:, k_sel]) < TIE_GAP


def compare(name, label, got, want, skip=None):
    """Max |got - want| over the compared rows, checked against TOL of the
    output scale; returns the absolute error."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    n_skip = 0 if skip is None else int(skip.sum())
    if skip is not None:
        diff = diff[~skip]
    abs_err = float(diff.max())
    rel = abs_err / float(want.abs().max())
    log(f"{name} vs plain [{label}, N={got.shape[0]}]: max abs "
        f"{abs_err:.3e}, max rel {rel:.3e} (tol {TOL})"
        + (f", {n_skip} near-tie rows not compared" if skip is not None
           else ""))
    if not (rel <= TOL and torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label}): {rel:.3e}")
    return abs_err


def compare64(name, label, got, want, want64):
    """`compare` for the circulant kernels: within TOL of the plain
    version, or, where float32 sums in another order push the two apart
    (logits pooled over many rows), both held against `want64`, the plain
    version evaluated in float64: the kernel's error at most twice the
    plain version's own and at most 10 TOL of the output scale. Returns
    the absolute error against the plain version."""
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    abs_err = float((got - want).abs().max())
    ok = abs_err / scale <= TOL
    msg = (f"{name} vs plain [{label}, N={got.shape[0]}]: max abs "
           f"{abs_err:.3e}, max rel {abs_err / scale:.3e} (tol {TOL})")
    if not ok:
        e_k = float((got.double() - want64).abs().max())
        e_p = float((want.double() - want64).abs().max())
        ok = e_k <= 2.0 * e_p and e_k / scale <= 10.0 * TOL
        msg += (f"; past tol, against float64: kernel {e_k:.3e}, plain "
                f"{e_p:.3e} (kernel must be <= 2x plain and <= 10 tol)")
    log(msg)
    if not (ok and torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label})")
    return abs_err


def mfa_path_run(run_mfa, stages, kernels, dev, tmp, **change):
    """run_mfa at the defaults (plus `change`) on the card with the data
    set cached in `tmp`, its kernel launches counted alone. Returns the
    config, tables, timings, seconds, launches and the fit it made."""
    cfg = run_mfa.MfaBenchConfig(results_dir=tmp,
                                 cache_dir=os.path.join(tmp, "saves"),
                                 **change)
    fits, mfa_fit = [], stages.mfa_fit

    def keep_fit(*args):
        fits.append(mfa_fit(*args))
        return fits[-1]

    stages.mfa_fit = keep_fit
    try:
        kernels.reset_launch_counts()
        tm = time.time()
        mse, rate, timings = run_mfa.run(cfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.time() - tm
        launches = kernels.launch_counts()
    finally:
        stages.mfa_fit = mfa_fit
    log(f"run_mfa {change or 'defaults'} (D={cfg.n_antennas}, "
        f"K={cfg.n_components}, M={cfg.latent_dim}, n_train={cfg.n_train}, "
        f"n_val={cfg.n_val}, {len(cfg.snrs)} SNRs): {seconds:.1f}s, MFA fit "
        f"{timings['fit']:.1f}s ({timings['mfa_iters']} iterations); "
        f"launches {launches}")
    for name, vals in list(mse.items()) + list(rate.items()):
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite row {name}: {vals}")
    return cfg, mse, rate, timings, seconds, launches, fits[0].params


def main_path_run(run_gmm, kernels, dev, tmp, falling=True, use_cache=False,
                  **change):
    """run_gmm at the defaults (plus `change`) on the card, its kernel
    launches counted alone; checks every column finite and (`falling`)
    falling with SNR."""
    cfg = run_gmm.GmmBenchConfig(results_dir=tmp,
                                 cache_dir=os.path.join(tmp, "saves"),
                                 use_cache=use_cache, **change)
    kernels.reset_launch_counts()
    tm = time.time()
    mse, rate, timings = run_gmm.run(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - tm
    launches = kernels.launch_counts()
    log(f"run_gmm {change or 'defaults'} (D={cfg.n_antennas}, "
        f"K={cfg.n_components}, n_train={cfg.n_train}, n_val={cfg.n_val}, "
        f"{len(cfg.snrs)} SNRs): {seconds:.1f}s, GMM fit "
        f"{timings['gmm_fit']:.1f}s; launches {launches}")
    for name, vals in mse.items():
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite MSE in {name}: {vals}")
        if falling and not vals[0] > vals[-1]:
            raise AssertionError(f"MSE of {name} does not fall with SNR")
    if not all(math.isfinite(v) for v in sum(rate.values(), [])):
        raise AssertionError("non-finite rate row")
    return cfg, mse, rate, timings, seconds, launches


def serve_mode(svc, kernels, dev, label, t_coh, kernel_name, reference,
               near_tie=None):
    """Closed-loop load on one service mode: warm-up, then SERVE_CLIENTS
    clients for SERVE_SECONDS, the launch counts read around the window.
    `reference(r)` is the mode's plain estimator on the card, `near_tie(r)`
    the rows not compared. Returns the mode's record; raises on a failed
    request, a kernel that was not launched or an answer off the
    reference."""
    rng = np.random.default_rng(1)
    width = svc.a.shape[0]                   # P D observations a snapshot

    def request(size):
        x = (rng.standard_normal((size, width))
             + 1j * rng.standard_normal((size, width))).astype(np.complex64)
        return x.reshape(size // t_coh, t_coh, width) if t_coh > 1 else x

    # one request held against the plain estimator on the card
    r = request(SERVE_REQ)
    got = torch.as_tensor(svc.submit(r, SNR, timeout=120.0), device=dev)
    rt = torch.as_tensor(r, device=dev)
    skip = None if near_tie is None else near_tie(rt)
    err = compare("service", label, got.reshape(-1, D),
                  reference(rt).reshape(-1, D), skip)

    # warm-up: every padded microbatch size the load can form, per SNR
    cap = 1 << max(4, SERVE_MAX_BATCH.bit_length() - 1)
    size = 1 << max(4, (SERVE_REQ - 1).bit_length())
    while size <= min(cap, SERVE_CLIENTS * SERVE_REQ):
        for snr in SERVE_SNRS:
            svc.submit(request(size - size % t_coh), snr, timeout=120.0)
        size *= 2

    latencies, stop, lock = [], threading.Event(), threading.Lock()
    served = [0]

    def client(i):
        req, j = request(SERVE_REQ), 0
        while not stop.is_set():
            t0 = time.perf_counter()
            svc.submit(req, SERVE_SNRS[(i + j) % len(SERVE_SNRS)],
                       timeout=120.0)
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                served[0] += SERVE_REQ
            j += 1

    m0 = svc.metrics()
    kernels.reset_launch_counts()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(SERVE_CLIENTS)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(SERVE_SECONDS)
    stop.set()
    for th in threads:
        th.join(timeout=120.0)
        if th.is_alive():
            raise AssertionError(f"serving client hung ({label})")
    elapsed = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    m = svc.metrics()
    lat = np.sort(np.asarray(latencies)) * 1e3
    rec = {"mode": label, "requests": len(lat),
           "estimates_per_s": served[0] / elapsed,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "microbatches": m["microbatches"] - m0["microbatches"],
           "launches": launches, "max_abs_err": err, "metrics": m}
    log(f"serving [{label}]: {rec['estimates_per_s']:.0f} estimates/s, "
        f"p50 {rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms over "
        f"{len(lat)} requests in {rec['microbatches']} microbatches; "
        f"launches {launches}; metrics {m}")
    if m["requests_failed"] != 0:
        raise AssertionError(f"failed requests in {label}: {m}")
    if launches[kernel_name] < 1:
        raise AssertionError(f"{label} did not launch {kernel_name}")
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels, fact_kernels, kernels, mp_circ_kernels)
    from quantized_channel_estimation_torch.harness import (
        run_gmm, run_mfa, stages)
    from quantized_channel_estimation_torch.models import (
        gmm_estimator, mfa, mfa_bank, structured_bank)
    from quantized_channel_estimation_torch.ops import observation, pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.utils import io as qio
    from quantized_channel_estimation_torch.ops.precision import pin_fp32

    t0 = time.time()
    dev = torch.device("cuda", 0)
    pin_fp32()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build every kernel (one nvcc per source, all started together)
    tb = time.time()
    for name, out in kernels.build().items():
        log(f"nvcc {name}:\n{out.strip()}")
    log(f"build: {time.time() - tb:.1f}s")

    # 2. kernels against their plain versions
    bank, q = bench_bank(dev)
    dead_bank = bench_bank(dev, n_dead=5)[0]
    kb = kernels.kernel_bank_block(bank)
    r = bench_obs(dev, q, N_BENCH)
    r2 = torch.cat([r.real, r.imag], dim=-1).float().contiguous()
    errs = {name: [] for name in kernels.launch_counts()}
    n_val = run_gmm.GmmBenchConfig().n_val     # the main path's batch
    for label, bank_c, rows in (("full", bank, r2),
                                ("main path", bank, r2[:n_val]),
                                ("dead", dead_bank, r2[:8191])):
        kb_c = kernels.kernel_bank_block(bank_c)
        errs["grouped_estimate"].append(compare(
            "grouped_estimate", label, kernels.grouped_estimate(rows, kb_c),
            kernels.grouped_estimate_reference(rows, kb_c)))
    for label, bank_c, t, alpha, rows in (
            [(f"T={t}, alpha={a}", bank, t, a, r2)
             for t in (2, 4, 16) for a in (1.0, 0.25)]
            + [("dead, B=2501", dead_bank, 4, 0.25, r2[:2501 * 4])]):
        kb_c = kernels.kernel_bank_block(bank_c, t, alpha)
        errs["grouped_estimate_coherent"].append(compare(
            "grouped_estimate_coherent", label,
            kernels.grouped_estimate_coherent(rows, kb_c, t, alpha),
            kernels.grouped_estimate_coherent_reference(rows, kb_c, t,
                                                        alpha)))
    for label, bank_c, k_sel, rows in (
            [(f"k={k}", bank, k, r2) for k in (1, 2, 4, 8)]
            + [("dead, k=4", dead_bank, 4, r2[:10001])]):
        kb_c = kernels.kernel_bank_block(bank_c)
        errs["grouped_estimate_topk"].append(compare(
            "grouped_estimate_topk", label,
            kernels.grouped_estimate_topk(rows, kb_c, k_sel),
            kernels.grouped_estimate_topk_reference(rows, kb_c, k_sel),
            near_ties(rows, kb_c, k_sel)))

    # 2b. the circulant kernels K6-K9 against their plain versions
    ck = circ_kernels

    def f64(ckb):
        return type(ckb)(*(x.double() for x in ckb))

    def check_circ(label, bank_c, x2, blocks=None, t=1, alpha=1.0):
        """K6 (t = 1) or K7 on rows x2 against the plain version. Returns
        the kernel's output."""
        ckb = ck.circ_kernel_bank(bank_c, blocks, t, alpha)
        if t == 1:
            name, got = "circ_estimate", ck.circ_estimate(x2, ckb)
            want = ck.circ_estimate_reference(x2, ckb)
            want64 = ck.circ_estimate_reference(x2.double(), f64(ckb))
        else:
            name = "circ_estimate_coherent"
            got = ck.circ_estimate_coherent(x2, ckb, t, alpha)
            want = ck.circ_estimate_coherent_reference(x2, ckb, t, alpha)
            want64 = ck.circ_estimate_coherent_reference(
                x2.double(), f64(ckb), t, alpha)
        errs[name].append(compare64(name, label, got, want, want64))
        return got

    def merged(states):
        _, den, acc = ck.merge_stats(*zip(*states))
        return ck._x2(structured_bank.unitary_ifft(
            ck._hc(acc / den[:, None], torch.complex64)))

    def check_stats(label, bank_c, x2, whole=None, t=1, alpha=1.0):
        """K8 (t = 1) or K9 on the two component shards of bank_c: each
        shard's state against the plain stats, and the merged,
        inverse-transformed quotient against `whole`, K6's / K7's output
        over the whole bank (None, for a bank past one launch's 128
        components: the plain states merged likewise)."""
        name = "circ_estimate_stats" if t == 1 \
            else "circ_estimate_coherent_stats"
        half = bank_c.spec_cr.shape[0] // 2
        states, plain = [], []
        for lo, hi in ((0, half), (half, 2 * half)):
            shard = type(bank_c)(*(x[lo:hi] for x in bank_c))
            ckb = ck.circ_kernel_bank(shard, None, t, alpha)
            if t == 1:
                got = ck.circ_estimate_stats(x2, ckb)
                want = ck.circ_estimate_stats_reference(x2, ckb)
                want64 = ck.circ_estimate_stats_reference(x2.double(),
                                                          f64(ckb))
            else:
                got = ck.circ_estimate_coherent_stats(x2, ckb, t, alpha)
                want = ck.circ_estimate_coherent_stats_reference(
                    x2, ckb, t, alpha)
                want64 = ck.circ_estimate_coherent_stats_reference(
                    x2.double(), f64(ckb), t, alpha)
            for part, g, w, w64 in zip(("m", "den", "acc"), got, want,
                                       want64):
                errs[name].append(compare64(
                    name, f"{label}, shard {lo}:{hi}, {part}",
                    g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1),
                    w64.reshape(w64.shape[0], -1)))
            states.append(got)
            plain.append(want)
        compare(name, f"{label}, two shards merged vs the whole bank",
                merged(states), merged(plain) if whole is None else whole)

    cbank = circ_bank(dev, q)
    cdead = circ_bank(dev, q, n_dead=5)
    x2 = ck._x2(r)
    for label, bank_c, rows in (("full", cbank, x2),
                                ("main path", cbank, x2[:n_val]),
                                ("dead", cdead, x2[:8191])):
        whole = check_circ(label, bank_c, rows)
        if label != "main path":
            check_stats(label, bank_c, rows, whole)
    for label, bank_c, t, alpha, rows in (
            [(f"T={t}, alpha={a}", cbank, t, a, x2)
             for t in (2, 4, 16) for a in (1.0, 0.25)]
            + [("dead, B=2501", cdead, 4, 0.25, x2[:2501 * 4])]):
        whole = check_circ(label, bank_c, rows, None, t, alpha)
        if t == 4:
            check_stats(label, bank_c, rows, whole, t, alpha)
    bbank = circ_bank(dev, q, blocks=(8, 8))
    check_circ("blocks=(8, 8)", bbank, x2[:n_val], (8, 8))
    check_circ("blocks=(8, 8), T=4, alpha=0.25", bbank, x2[:n_val], (8, 8),
               4, 0.25)
    for d_w, k_w in ((32, 40), (128, 128)):
        wbank = circ_bank(dev, q, d_w, k_w, n_dead=3)
        xw = ck._x2(bench_obs(dev, q, 20001 * 4, d_w))
        whole = check_circ(f"D={d_w}, K={k_w}", wbank, xw[:20001])
        check_stats(f"D={d_w}, K={k_w}", wbank, xw[:20001], whole)
        check_circ(f"D={d_w}, K={k_w}, T=4, alpha=0.25", wbank, xw, None, 4,
                   0.25)

    # the shards the K = 256 service gives K8 / K9: 128 components at
    # D = 64 (the widest instantiation of the stats template), on a service
    # microbatch of 512 rows and on the headline batch
    kbank = circ_bank(dev, q, k=K_WIDE, n_dead=5)
    for t, alpha in ((1, 1.0), (4, 1.0), (4, 0.25)):
        for rows in (x2[:512], x2):
            check_stats(f"K={K_WIDE}, T={t}, alpha={alpha}", kbank, rows,
                        None, t, alpha)

    # 2c. the multi-pilot circulant kernel K10 against its plain version
    mk = mp_circ_kernels

    def check_mp(label, p, d=D, k=K, n=N_BENCH, t=1, alpha=1.0, n_bits=N_BITS,
                 n_dead=0, blocks=None):
        """K10 (t = 1) or its coherent form on n rows of a seeded P-pilot
        bank against the plain version."""
        bank_c, a_c, q_c = mp_bank(dev, p, d, k, n_bits, n_dead, blocks)
        xm = ck._x2(mp_obs(dev, a_c, q_c, n, n_bits))
        ckb = mk.mp_circ_kernel_bank(bank_c, blocks, t, alpha)
        label = (f"{label}, P={p}, D={d}, K={k}"
                 + (f", T={t}, alpha={alpha}" if t > 1 else ""))
        if t == 1:
            name, got = "mp_circ_estimate", mk.mp_circ_estimate(xm, ckb)
            want = mk.mp_circ_estimate_reference(xm, ckb)
            want64 = mk.mp_circ_estimate_reference(xm.double(), f64(ckb))
        else:
            name = "mp_circ_estimate_coherent"
            got = mk.mp_circ_estimate_coherent(xm, ckb, t, alpha)
            want = mk.mp_circ_estimate_coherent_reference(xm, ckb, t, alpha)
            want64 = mk.mp_circ_estimate_coherent_reference(
                xm.double(), f64(ckb), t, alpha)
        errs[name].append(compare64(name, label, got, want, want64))

    for p in (2, 3, 4):
        for d_w, k_w in ((16, 8), (24, 40), (D, K)):
            check_mp("dead, ragged", p, d_w, k_w, 10001, n_dead=2)
    check_mp("main path", 2, n=n_val)
    check_mp("1-bit", 2, n=n_val, n_bits=1)
    check_mp("unquantized", 3, n=n_val, n_bits="inf")
    check_mp("blocks=(8, 8)", 2, n=n_val, blocks=(8, 8))
    check_mp("blocks=(8, 8)", 2, n=n_val, t=4, alpha=0.25, blocks=(8, 8))
    check_mp("widest", 4, 128, 128, 20001, n_dead=3)
    check_mp("widest", 4, 128, 128, 32 * 601, 32, 0.25, n_dead=3)
    check_mp("full", 2)
    check_mp("full", 4)
    for t in (2, 4, 16):
        for alpha in (1.0, 0.25):
            check_mp("full", 2, t=t, alpha=alpha)
    check_mp("dead, B=2501", 3, 24, 40, 2501 * 4, 4, 0.25, n_dead=2)
    check_mp("largest T", 2, n=64 * 301, t=64)

    # 2d. the factored (MFA) kernels K11-K13 against their plain versions
    fk = fact_kernels

    def check_fact(label, bank_c, xf, t=1, alpha=1.0):
        """K11 (t = 1) or K12 on rows xf against the plain version.
        Returns the kernel's output."""
        fkb = fk.fact_kernel_bank(bank_c, t, alpha)
        if t == 1:
            name, got = "fact_estimate", fk.fact_estimate(xf, fkb)
            want = fk.fact_estimate_reference(xf, fkb)
            want64 = fk.fact_estimate_reference(xf.double(), f64(fkb))
        else:
            name = "fact_estimate_coherent"
            got = fk.fact_estimate_coherent(xf, fkb, t, alpha)
            want = fk.fact_estimate_coherent_reference(xf, fkb, t, alpha)
            want64 = fk.fact_estimate_coherent_reference(
                xf.double(), f64(fkb), t, alpha)
        errs[name].append(compare64(name, label, got, want, want64))
        return got

    def check_fact_stats(label, bank_c, xf, whole):
        """K13 on the two component shards of bank_c, each state against
        the plain stats, the merged quotient against `whole` (K11 over the
        whole bank)."""
        half = bank_c.t_mat.shape[0] // 2
        states = []
        for lo, hi in ((0, half), (half, 2 * half)):
            fkb = fk.fact_kernel_bank(type(bank_c)(*(x[lo:hi]
                                                     for x in bank_c)))
            got = fk.fact_estimate_stats(xf, fkb)
            want = fk.fact_estimate_stats_reference(xf, fkb)
            want64 = fk.fact_estimate_stats_reference(xf.double(), f64(fkb))
            for part, g, w, w64 in zip(("m", "den", "acc"), got, want,
                                       want64):
                errs["fact_estimate_stats"].append(compare64(
                    "fact_estimate_stats", f"{label}, shard {lo}:{hi}, {part}",
                    g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1),
                    w64.reshape(w64.shape[0], -1)))
            states.append(got)
        _, den, acc = ck.merge_stats(*zip(*states))
        compare("fact_estimate_stats", f"{label}, two shards merged vs K11",
                acc / den[:, None], whole)

    fbank, r_f = mfa_bank_obs(dev, q, N_BENCH)
    fdead, r_fd = mfa_bank_obs(dev, q, N_BENCH, n_dead=5, zero_mean=False)
    xf, xfd = ck._x2(r_f), ck._x2(r_fd)
    for label, bank_c, rows in (("zero means", fbank, xf),
                                ("main path", fbank, xf[:n_val]),
                                ("means, dead, ragged", fdead, xfd[:8191])):
        whole = check_fact(label, bank_c, rows)
        if label != "main path":
            check_fact_stats(label, bank_c, rows, whole)
    for label, bank_c, t, alpha, rows in (
            [(f"T=4, alpha={a}", fbank, 4, a, xf) for a in (1.0, 0.25, 0.0)]
            + [("T=16, alpha=1", fbank, 16, 1.0, xf),
               ("means, dead, B=2501", fdead, 4, 0.25, xfd[:2501 * 4]),
               ("largest T", fdead, 64, 1.0, xfd[:64 * 301])]):
        check_fact(label, bank_c, rows, t, alpha)
    for d_w, m_w, k_w in ((D, 6, K), (32, 8, 40)):
        wbank, rw = mfa_bank_obs(dev, q, 20001 * 4, d=d_w, m=m_w, k=k_w,
                                 n_dead=3, zero_mean=False)
        xw = ck._x2(rw)
        label = f"D={d_w}, M={m_w}, K={k_w}"
        whole = check_fact(label, wbank, xw[:20001])
        check_fact_stats(label, wbank, xw[:20001], whole)
        check_fact(label + ", T=4, alpha=0.25", wbank, xw, 4, 0.25)

    # 3. the main paths, each with its own launch counts
    total_launches = dict.fromkeys(errs, 0)

    def add(counts):
        for name, c in counts.items():
            total_launches[name] += c

    with tempfile.TemporaryDirectory() as tmp:
        cfg, mse, rate, timings, main_s, launches = main_path_run(
            run_gmm, kernels, dev, tmp)
        csvs = sorted(os.listdir(os.path.join(tmp, "3gpp")))
    add(launches)
    i10 = list(cfg.snrs).index(10)
    at10 = {k: v[i10] for k, v in mse.items()}
    if not (at10["blmmse_genie"] < at10["blmmse_gmm"] < at10["blmmse_glob"]
            < at10["LS_glob"]):
        raise AssertionError(f"MSE order at 10 dB broken: {at10}")
    if launches["grouped_estimate"] < len(cfg.snrs):
        raise AssertionError(f"main path launched K1 only "
                             f"{launches['grouped_estimate']} times")
    if len(csvs) != 2:
        raise AssertionError(f"CSV rows missing: {csvs}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg_c, mse_c, rate_c, timings_c, coh_s, launches_c = main_path_run(
            run_gmm, kernels, dev, tmp, n_coherence=4, coherence_alpha=1.0)
    add(launches_c)
    i_low = list(cfg_c.snrs).index(-10)
    if not mse_c["blmmse_gmm_coh"][i_low] < mse_c["blmmse_gmm"][i_low]:
        raise AssertionError(f"coherent column no better at -10 dB: "
                             f"{mse_c['blmmse_gmm_coh'][i_low]} vs "
                             f"{mse_c['blmmse_gmm'][i_low]}")
    if launches_c["grouped_estimate_coherent"] < len(cfg_c.snrs):
        raise AssertionError(f"coherent run launched K3 only "
                             f"{launches_c['grouped_estimate_coherent']} "
                             "times")
    log(f"coherent column vs per-snapshot GMM at -10 dB: "
        f"{mse_c['blmmse_gmm_coh'][i_low]:.5f} vs "
        f"{mse_c['blmmse_gmm'][i_low]:.5f}")

    # the same two runs with circulant covariances: the FFT-domain bank
    # through K6 and K7. The 3GPP covariances are Toeplitz, so the circulant
    # fit is an approximation; its NMSE cost is recorded, not asserted.
    with tempfile.TemporaryDirectory() as tmp:
        cfg_s, mse_s, rate_s, timings_s, circ_s, launches_s = main_path_run(
            run_gmm, kernels, dev, tmp, cov_type="circulant")
    add(launches_s)
    at10 = {k: v[i10] for k, v in mse_s.items()}
    if not (at10["blmmse_genie"] < at10["blmmse_gmm"] < at10["LS_glob"]):
        raise AssertionError(f"circulant MSE order at 10 dB broken: {at10}")
    if launches_s["circ_estimate"] < len(cfg_s.snrs):
        raise AssertionError(f"circulant run launched K6 only "
                             f"{launches_s['circ_estimate']} times")
    log(f"blmmse_gmm, circulant fit: {mse_s['blmmse_gmm']}")
    log(f"blmmse_gmm, full fit:      {mse['blmmse_gmm']}")
    with tempfile.TemporaryDirectory() as tmp:
        cfg_sc, mse_sc, rate_sc, timings_sc, circ_coh_s, launches_sc = \
            main_path_run(run_gmm, kernels, dev, tmp, cov_type="circulant",
                          n_coherence=4, coherence_alpha=1.0)
    add(launches_sc)
    if not mse_sc["blmmse_gmm_coh"][i_low] < mse_sc["blmmse_gmm"][i_low]:
        raise AssertionError(f"circulant coherent column no better at "
                             f"-10 dB: {mse_sc['blmmse_gmm_coh'][i_low]} vs "
                             f"{mse_sc['blmmse_gmm'][i_low]}")
    if launches_sc["circ_estimate_coherent"] < len(cfg_sc.snrs):
        raise AssertionError(f"circulant coherent run launched K7 only "
                             f"{launches_sc['circ_estimate_coherent']} "
                             "times")
    log(f"circulant coherent column vs per-snapshot at -10 dB: "
        f"{mse_sc['blmmse_gmm_coh'][i_low]:.5f} vs "
        f"{mse_sc['blmmse_gmm'][i_low]:.5f}")

    # the circulant runs under two pilots: the per-bin P x P bank through
    # K10 and its coherent form. Under several `angle_amp` pilots the
    # Bussgang gain of the weakest pilot exceeds 1 from 5 dB on, and every
    # Bussgang estimator of the harness (genie, global, GMM, dense or
    # structured) then loses to LS, so the invariants are held where the
    # model is sound (-10 and -5 dB) and the tables are recorded.
    low = [list(cfg.snrs).index(snr) for snr in (-10, -5)]

    def mp_invariants(label, mse_m, launches_m, kernel_name):
        for i in low:
            at = {k: v[i] for k, v in mse_m.items()}
            if not (at["blmmse_genie"] < at["blmmse_gmm"] < at["LS_glob"]):
                raise AssertionError(f"{label}: MSE order at "
                                     f"{cfg.snrs[i]} dB broken: {at}")
            if not at["blmmse_gmm"] < mse_s["blmmse_gmm"][i]:
                raise AssertionError(
                    f"{label}: a second pilot does not help at "
                    f"{cfg.snrs[i]} dB: {at['blmmse_gmm']} vs "
                    f"{mse_s['blmmse_gmm'][i]}")
        if launches_m[kernel_name] != len(cfg.snrs):
            raise AssertionError(f"{label} launched {kernel_name} "
                                 f"{launches_m[kernel_name]} times")
        log(f"blmmse_gmm, {label}: {mse_m['blmmse_gmm']}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg_m, mse_m, rate_m, timings_m, mp_s, launches_m = main_path_run(
            run_gmm, kernels, dev, tmp, falling=False, use_cache=True,
            cov_type="circulant", n_pilots=2)
        # the same fit and validation channels through the dense bank (K1
        # at M = 128) and through the multi-pilot bank (K10), at -10 and
        # 10 dB
        saves = os.path.join(tmp, "saves")
        fit_file, = [f for f in os.listdir(saves) if f.startswith("trained")]
        data_file, = [f for f in os.listdir(saves) if f.startswith("saved")]
        fit_params = qio.load_gmm_params(os.path.join(saves, fit_file), dev)
        h_val = torch.as_tensor(qio.load_channels(
            os.path.join(saves, data_file))[0][cfg_m.n_train:], device=dev)
    add(launches_m)
    mp_invariants("circulant, 2 pilots", mse_m, launches_m,
                  "mp_circ_estimate")
    a_mp = pilots.pilot_matrix(D, 2, N_BITS, device=dev)
    mp_vs_dense = {}
    for snr in (-10.0, 10.0):
        q_snr = Q.design_quantizer(snr, N_BITS).to(dev)
        r_val = observation.observe(torch.Generator(dev).manual_seed(3),
                                    h_val, snr, a_mp, N_BITS, q_snr)
        via_k10 = stages.estimate_circulant(
            stages.prepare_bank_circulant(fit_params, snr, a_mp, N_BITS,
                                          q_snr), r_val)
        via_k1 = stages.estimate_auto(
            stages.prepare_bank(fit_params, snr, a_mp, N_BITS, q_snr), r_val,
            "all")
        torch.cuda.synchronize()
        mp_vs_dense[snr] = float((via_k10 - via_k1).abs().max()
                                 / via_k1.abs().max())
        log(f"multi-pilot bank (K10) vs dense bank (K1, M=128) at {snr} dB, "
            f"N={r_val.shape[0]}: max rel {mp_vs_dense[snr]:.3e} (tol {TOL} "
            "at -10 dB)")
    if not mp_vs_dense[-10.0] <= TOL:
        raise AssertionError(f"multi-pilot bank off the dense bank: "
                             f"{mp_vs_dense}")
    with tempfile.TemporaryDirectory() as tmp:
        cfg_mc, mse_mc, rate_mc, timings_mc, mp_coh_s, launches_mc = \
            main_path_run(run_gmm, kernels, dev, tmp, falling=False,
                          cov_type="circulant", n_pilots=2, n_coherence=4,
                          coherence_alpha=1.0)
    add(launches_mc)
    mp_invariants("circulant, 2 pilots, n_coherence=4", mse_mc, launches_mc,
                  "mp_circ_estimate_coherent")
    if launches_mc["mp_circ_estimate"] != len(cfg_mc.snrs):
        raise AssertionError(f"the coherent 2-pilot run launched K10 "
                             f"{launches_mc['mp_circ_estimate']} times")
    if not mse_mc["blmmse_gmm_coh"][i_low] < mse_mc["blmmse_gmm"][i_low]:
        raise AssertionError(f"2-pilot coherent column no better at -10 dB: "
                             f"{mse_mc['blmmse_gmm_coh'][i_low]} vs "
                             f"{mse_mc['blmmse_gmm'][i_low]}")
    log(f"2-pilot coherent column vs per-snapshot at -10 dB: "
        f"{mse_mc['blmmse_gmm_coh'][i_low]:.5f} vs "
        f"{mse_mc['blmmse_gmm'][i_low]:.5f}")

    # run_mfa at the defaults: the factored bank through K11, and with
    # n_coherence=4 the coherent column through K12; the invariants of the
    # JAX harness tests (`tests/test_harness.py`), and the factored estimate
    # held against the dense bank (K1) of the same fit
    with tempfile.TemporaryDirectory() as tmp:
        (cfg_f, mse_f, rate_f, timings_f, mfa_s, launches_f,
         fit_f) = mfa_path_run(run_mfa, stages, kernels, dev, tmp)
        data_file, = os.listdir(os.path.join(tmp, "saves"))
        h_val_f = torch.as_tensor(qio.load_channels(os.path.join(
            tmp, "saves", data_file))[0][cfg_f.n_train:], device=dev)
    add(launches_f)
    i0, i10, i_low = (list(cfg_f.snrs).index(snr) for snr in (0, 10, -10))
    if not (mse_f["blmmse_mfa"][i0] > mse_f["blmmse_mfa"][i10]
            and mse_f["blmmse_mfa"][i10] < 1.0):
        raise AssertionError(f"blmmse_mfa does not fall from 0 to 10 dB: "
                             f"{mse_f['blmmse_mfa']}")
    if launches_f["fact_estimate"] != len(cfg_f.snrs):
        raise AssertionError(f"run_mfa launched K11 "
                             f"{launches_f['fact_estimate']} times")
    log(f"blmmse_mfa: {mse_f['blmmse_mfa']}; mfa_rstat: "
        f"{rate_f['mfa_rstat']}")
    a_f = pilots.pilot_matrix(D, 1, N_BITS, device=dev)
    dense_params = mfa.to_gmm_params(fit_f, 1e-6)
    mfa_vs_dense = {}
    for snr in (-10.0, 10.0):
        q_snr = Q.design_quantizer(snr, N_BITS).to(dev)
        r_val = observation.observe(torch.Generator(dev).manual_seed(3),
                                    h_val_f, snr, a_f, N_BITS, q_snr)
        via_k11 = stages.estimate_factored(
            stages.prepare_bank_factored(fit_f, snr, a_f, N_BITS, q_snr),
            r_val)
        via_k1 = stages.estimate_auto(
            stages.prepare_bank(dense_params, snr, a_f, N_BITS, q_snr), r_val,
            "all")
        torch.cuda.synchronize()
        mfa_vs_dense[snr] = float((via_k11 - via_k1).abs().max()
                                  / via_k1.abs().max())
        log(f"factored bank (K11) vs dense bank (K1) of the same MFA fit at "
            f"{snr} dB, N={r_val.shape[0]}: max rel {mfa_vs_dense[snr]:.3e} "
            f"(tol {TOL})")
    if not max(mfa_vs_dense.values()) <= TOL:
        raise AssertionError(f"factored bank off the dense bank: "
                             f"{mfa_vs_dense}")
    with tempfile.TemporaryDirectory() as tmp:
        (cfg_fc, mse_fc, rate_fc, timings_fc, mfa_coh_s, launches_fc,
         _) = mfa_path_run(run_mfa, stages, kernels, dev, tmp, n_coherence=4)
    add(launches_fc)
    if not (mse_fc["blmmse_mfa_coh"][i_low]
            <= 1.02 * mse_fc["blmmse_mfa"][i_low]):
        raise AssertionError(f"MFA coherent column above 1.02x the "
                             f"per-snapshot one at -10 dB: {mse_fc}")
    if (launches_fc["fact_estimate_coherent"] != len(cfg_fc.snrs)
            or launches_fc["fact_estimate"] != len(cfg_fc.snrs)):
        raise AssertionError(f"the coherent run_mfa launched K12 / K11 "
                             f"{launches_fc}")
    log(f"MSE table, run_mfa (SNRs {list(cfg_f.snrs)}):")
    for label, table in (("flat", mse_f), ("n_coherence=4", mse_fc)):
        for name, vals in table.items():
            log(f"  {label:14s} {name:15s} "
                + " ".join(f"{v:.5f}" for v in vals))

    params = serving_params()
    a_eye = np.eye(D, dtype=np.complex64)     # the tool's pilot matrix
    params_dev = type(params)(*(torch.as_tensor(x, device=dev)
                                for x in params))
    q_serve = Q.design_quantizer(SNR, N_BITS).to(dev)
    serve_bank = gmm_estimator.prepare_bank(
        params_dev, SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve)
    # the structured service serves the same prior through its
    # Frobenius-best circulant approximation
    serve_cbank = structured_bank.prepare_bank_circulant(
        params_dev, SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve)

    def dense_reference(mode):
        return lambda rt: (
            gmm_estimator.estimate_coherent(serve_bank, rt, mode)
            if rt.dim() == 3 else gmm_estimator.estimate(serve_bank, rt,
                                                         mode))

    def dense_near_tie(mode):
        return lambda rt: near_ties(
            torch.cat([rt.real, rt.imag], -1).float(),
            kernels.kernel_bank_block(serve_bank), mode)

    def fft_reference(rt):
        if rt.dim() == 3:
            return structured_bank.estimate_circulant_coherent(
                serve_cbank, rt, "all", 4096, 1.0, None, "fft")
        return structured_bank.estimate_circulant(serve_cbank, rt, "all",
                                                  16384, None, "fft")

    # the same prior under the two-pilot matrix: the multi-pilot bank
    a_mp_np = a_mp.cpu().numpy()
    serve_mpbank = structured_bank.prepare_bank_circulant(
        params_dev, SNR, a_mp, N_BITS, q_serve)

    def mp_reference(rt):
        if rt.dim() == 3:
            return structured_bank.estimate_circulant_coherent(
                serve_mpbank, rt, "all", 4096, 1.0, None, "fft")
        return structured_bank.estimate_circulant(serve_mpbank, rt, "all",
                                                  16384, None, "fft")

    # a spectra-native prior of K = 256 components: two shards of 128
    # through the stats kernels K8 / K9, merged
    wide_spectra = np.random.default_rng(2).uniform(
        0.05, 2.0, (K_WIDE, D)).astype(np.float32)
    dummy = torch.zeros((K_WIDE, 1, 1), dtype=torch.complex64, device=dev)
    wide_bank = structured_bank.prepare_bank_circulant(
        type(params)(torch.full((K_WIDE,), 1.0 / K_WIDE, device=dev),
                     torch.zeros((K_WIDE, D), dtype=torch.complex64,
                                 device=dev), dummy, dummy),
        SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve,
        spectra=torch.as_tensor(wide_spectra, device=dev))

    def wide_reference(rt):
        if rt.dim() == 3:
            return structured_bank.estimate_circulant_coherent(
                wide_bank, rt, "all", 4096, 1.0, None, "fft")
        return structured_bank.estimate_circulant(wide_bank, rt, "all",
                                                  16384, None, "fft")

    # an MFA prior at the headline widths through the factored bank
    mfa_serve = mfa_prior(dev, n_dead=0, zero_mean=True, seed=2)
    serve_fbank = mfa_bank.prepare_bank_factored(
        mfa_serve, SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve)

    def fact_reference(rt):
        if rt.dim() == 3:
            return mfa_bank.estimate_factored_coherent(serve_fbank, rt)
        return mfa_bank.estimate_factored(serve_fbank, rt)

    serve = []
    for kwargs, modes in (
            (dict(mode="all"),
             (("flat all", 1, "grouped_estimate", dense_reference("all"),
               None),
              ("T=4 blocks, alpha=1", 4, "grouped_estimate_coherent",
               dense_reference("all"), None))),
            (dict(mode=1), (("top-1", 1, "grouped_estimate_topk",
                             dense_reference(1), dense_near_tie(1)),)),
            (dict(mode=4), (("top-4", 1, "grouped_estimate_topk",
                             dense_reference(4), dense_near_tie(4)),)),
            (dict(mode="all", structured=True),
             (("structured flat all", 1, "circ_estimate", fft_reference,
               None),
              ("structured T=4 blocks, alpha=1", 4, "circ_estimate_coherent",
               fft_reference, None))),
            (dict(mode="all", spectra=wide_spectra),
             (("structured K=256 flat all", 1, "circ_estimate_stats",
               wide_reference, None),
              ("structured K=256 T=4 blocks, alpha=1", 4,
               "circ_estimate_coherent_stats", wide_reference, None))),
            (dict(mode="all", structured=True, a=a_mp_np),
             (("structured 2 pilots flat all", 1, "mp_circ_estimate",
               mp_reference, None),
              ("structured 2 pilots T=4 blocks, alpha=1", 4,
               "mp_circ_estimate_coherent", mp_reference, None))),
            (dict(mode="all", mfa=True),
             (("factored flat all", 1, "fact_estimate", fact_reference,
               None),
              ("factored T=4 blocks, alpha=1", 4, "fact_estimate_coherent",
               fact_reference, None)))):
        spectra = kwargs.pop("spectra", None)
        a_serve = kwargs.pop("a", a_eye)
        if kwargs.pop("mfa", False):
            svc = serving.EstimationService.from_mfa(
                mfa_serve, a_eye, N_BITS, max_batch=SERVE_MAX_BATCH,
                device=dev, **kwargs)
            if not svc.factored:
                raise AssertionError("from_mfa did not take the factored bank")
        elif spectra is not None:
            svc = serving.EstimationService.from_circulant_spectra(
                np.full((K_WIDE,), 1.0 / K_WIDE, np.float32),
                np.zeros((K_WIDE, D), np.complex64), spectra, a_eye, N_BITS,
                max_batch=SERVE_MAX_BATCH, device=dev, **kwargs)
        else:
            svc = serving.EstimationService(params, a_serve, N_BITS,
                                            max_batch=SERVE_MAX_BATCH,
                                            device=dev, **kwargs)
        try:
            for label, t_coh, kernel_name, reference, near_tie in modes:
                serve.append(serve_mode(svc, kernels, dev, label, t_coh,
                                        kernel_name, reference, near_tie))
                add(serve[-1]["launches"])
        finally:
            svc.close(timeout=120.0)

    # 4. times at the headline benchmark's shapes
    n, two_m = r2.shape
    _, _, s_cols = kb.pw.shape
    two_d = s_cols - two_m
    gemm_flops = 2.0 * n * two_m * s_cols * K
    nbytes = 4.0 * (n * two_m + n * two_d + kb.pw.numel() + kb.mu.numel()
                    + kb.b.numel() + kb.logw.numel())

    def bound(flops, nbytes=nbytes):
        ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        by = ("operations" if flops / PEAK_FP32_FLOPS
              >= nbytes / PEAK_HBM_BYTES else "bytes")
        return ms, by

    def timed(label, kern, plain, library, flops, nbytes=nbytes,
              library_chunked=None, two_m=two_m):
        plain_ms = cuda_ms(plain)
        ms = cuda_ms(kern)
        ms2 = cuda_ms(kern)
        plain_ms2 = cuda_ms(plain)
        library_ms = cuda_ms(library)
        bound_ms, bound_by = bound(flops, nbytes)
        rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        note = ""
        if library_chunked is not None:
            rec["library_chunked_ms"] = cuda_ms(library_chunked)
            note = (f" (at the pipeline's default chunks "
                    f"{rec['library_chunked_ms']:.3f} ms)")
        log(f"{label} at N={n}, 2M={two_m}, 2D={two_d}, K={K}: kernel "
            f"{ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} / "
            f"{plain_ms2:.3f} ms, library {library_ms:.3f} ms{note}, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {n / (ms * 1e-3):.4g} "
            "estimates/s")
        return rec

    flat = kb.pw.permute(1, 0, 2).reshape(two_m, K * s_cols).contiguous()
    flat_p = kb.pw[:, :, :two_m].permute(1, 0, 2).reshape(
        two_m, K * two_m).contiguous()
    gemm = lambda: r2 @ flat  # noqa: E731
    logit_gemm = lambda: r2 @ flat_p  # noqa: E731
    t1 = timed("K1", lambda: kernels.grouped_estimate(r2, kb),
               lambda: kernels.grouped_estimate_reference(r2, kb), gemm,
               gemm_flops)
    kb3 = kernels.kernel_bank_block(bank, 4, 1.0)
    t3 = timed("K3 (T=4, alpha=1)",
               lambda: kernels.grouped_estimate_coherent(r2, kb3, 4, 1.0),
               lambda: kernels.grouped_estimate_coherent_reference(
                   r2, kb3, 4, 1.0), gemm, gemm_flops + 3.0 * n * K)
    kb16 = kernels.kernel_bank_block(bank, 16, 1.0)
    t3_16 = timed("K3 (T=16, alpha=1)",
                  lambda: kernels.grouped_estimate_coherent(r2, kb16, 16,
                                                            1.0),
                  lambda: kernels.grouped_estimate_coherent_reference(
                      r2, kb16, 16, 1.0), gemm, gemm_flops + 3.0 * n * K)
    t4 = {k_sel: timed(
        f"K4 (k={k_sel})",
        lambda: kernels.grouped_estimate_topk(r2, kb, k_sel),
        lambda: kernels.grouped_estimate_topk_reference(r2, kb, k_sel),
        logit_gemm,
        2.0 * n * two_m * two_m * K + k_sel * 2.0 * n * two_m * two_d)
        for k_sel in (1, 4)}

    # the circulant kernels: 2 N (2D 2D + 3D K + K 4D + 2D 2D) operations
    # (K8/K9 less the inverse transform); bytes: the rows read and written
    # once, the operands once, m and den for the stats forms. Library
    # yardstick: the torch.fft pipeline of the same entry, which the port
    # never calls where the kernel is eligible, over the batch as one chunk
    # (the best the library calls do); at the pipeline's default chunks of
    # 16384 rows / 4096 blocks it is bound by host launches and is kept as
    # `library_chunked_ms` only.
    ckb = ck.circ_kernel_bank(cbank)
    ckb4 = ck.circ_kernel_bank(cbank, None, 4, 1.0)
    circ_flops = 2.0 * n * (2 * two_d * two_d + 3 * D * K + 4 * K * D)
    circ_bytes = 4.0 * (2 * n * two_d + sum(x.numel() for x in ckb))
    r_blocks = r.reshape(-1, 4, D)
    t6 = timed("K6", lambda: ck.circ_estimate(x2, ckb),
               lambda: ck.circ_estimate_reference(x2, ckb),
               lambda: structured_bank.estimate_circulant(
                   cbank, r, "all", n, None, "fft"),
               circ_flops, circ_bytes,
               lambda: structured_bank.estimate_circulant(
                   cbank, r, "all", 16384, None, "fft"))
    t7 = timed("K7 (T=4, alpha=1)",
               lambda: ck.circ_estimate_coherent(x2, ckb4, 4, 1.0),
               lambda: ck.circ_estimate_coherent_reference(x2, ckb4, 4, 1.0),
               lambda: structured_bank.estimate_circulant_coherent(
                   cbank, r_blocks, "all", n // 4, 1.0, None, "fft"),
               circ_flops + 3.0 * n * K, circ_bytes,
               lambda: structured_bank.estimate_circulant_coherent(
                   cbank, r_blocks, "all", 4096, 1.0, None, "fft"))
    stats_flops = circ_flops - 2.0 * n * two_d * two_d
    stats_bytes = circ_bytes + 8.0 * n - 4.0 * ckb.binv.numel()
    t8 = timed("K8", lambda: ck.circ_estimate_stats(x2, ckb),
               lambda: ck.circ_estimate_stats_reference(x2, ckb),
               lambda: structured_bank.estimate_circulant_stats(
                   cbank, r, n, None, "fft"), stats_flops, stats_bytes,
               lambda: structured_bank.estimate_circulant_stats(
                   cbank, r, 16384, None, "fft"))
    t9 = timed("K9 (T=4, alpha=1)",
               lambda: ck.circ_estimate_coherent_stats(x2, ckb4, 4, 1.0),
               lambda: ck.circ_estimate_coherent_stats_reference(
                   x2, ckb4, 4, 1.0),
               lambda: structured_bank.estimate_circulant_coherent_stats(
                   cbank, r_blocks, n // 4, 1.0, None, "fft"),
               stats_flops + 3.0 * n * K, stats_bytes,
               lambda: structured_bank.estimate_circulant_coherent_stats(
                   cbank, r_blocks, 4096, 1.0, None, "fft"))

    # K10: 2 N (P 2D 2D + F K + (P+1) K 2D + 2D 2D) operations with
    # F = D (3P + P (P-1)) features, the useful work only (the TPU kernel's
    # forward operands are mostly zero blocks); bytes: the (N, 2PD) rows
    # read and the (N, 2D) rows written once, the operands once. Library
    # yardstick as for K6: the torch.fft pipeline over the batch as one
    # chunk; its default chunks are 8192 rows / 2048 blocks.
    def timed_mp(p, t=1):
        bank_p, a_p, q_p = mp_bank(dev, p)
        rp = mp_obs(dev, a_p, q_p, n)
        xp = ck._x2(rp)
        ckb_p = mk.mp_circ_kernel_bank(bank_p, None, t, 1.0)
        feat = D * (3 * p + p * (p - 1))
        flops = 2.0 * n * (p * two_d * two_d + feat * K
                           + (p + 1) * K * two_d + two_d * two_d)
        nbytes_p = 4.0 * (n * (p * two_d + two_d)
                          + sum(x.numel() for x in ckb_p))
        if t == 1:
            return timed(
                f"K10 (P={p})", lambda: mk.mp_circ_estimate(xp, ckb_p),
                lambda: mk.mp_circ_estimate_reference(xp, ckb_p),
                lambda: structured_bank.estimate_circulant_mp(
                    bank_p, rp, "all", n, None, "fft"), flops, nbytes_p,
                lambda: structured_bank.estimate_circulant_mp(
                    bank_p, rp, "all", 8192, None, "fft"), p * two_d)
        rp_blocks = rp.reshape(-1, t, rp.shape[-1])
        return timed(
            f"K10 coherent (P={p}, T={t}, alpha=1)",
            lambda: mk.mp_circ_estimate_coherent(xp, ckb_p, t, 1.0),
            lambda: mk.mp_circ_estimate_coherent_reference(xp, ckb_p, t, 1.0),
            lambda: structured_bank.estimate_circulant_mp_coherent(
                bank_p, rp_blocks, "all", n // t, 1.0, None, "fft"),
            flops + 3.0 * n * K, nbytes_p,
            lambda: structured_bank.estimate_circulant_mp_coherent(
                bank_p, rp_blocks, "all", 2048, 1.0, None, "fft"), p * two_d)

    t10, t10_p4, t10_coh = timed_mp(2), timed_mp(4), timed_mp(2, 4)

    # K11-K13: 2 N K (2D 4M + 4M 2D + 3D + 2M + 6D) operations (forward and
    # combine products, the logit's diagonal and latent terms, the bias and
    # diagonal combine), K12 plus 3 N K for the pool; bytes: the rows read
    # and written once, the bank once, m and den for K13. Library yardstick:
    # the `torch.matmul` pipeline of `models.mfa_bank` over the batch as one
    # chunk (`library_chunked_ms`: at its default chunks).
    fkb = fk.fact_kernel_bank(fbank)
    fkb4 = fk.fact_kernel_bank(fbank, 4, 1.0)
    fact_flops = 2.0 * n * K * (2 * two_d * 4 * M_LAT + 3 * D + 2 * M_LAT
                                + 6 * D)
    fact_bytes = 4.0 * (2 * n * two_d + sum(x.numel() for x in fkb))
    rf_blocks = r_f.reshape(-1, 4, D)
    t11 = timed("K11", lambda: fk.fact_estimate(xf, fkb),
                lambda: fk.fact_estimate_reference(xf, fkb),
                lambda: mfa_bank.estimate_factored(fbank, r_f, "all", n),
                fact_flops, fact_bytes,
                lambda: mfa_bank.estimate_factored(fbank, r_f))
    t12 = timed("K12 (T=4, alpha=1)",
                lambda: fk.fact_estimate_coherent(xf, fkb4, 4, 1.0),
                lambda: fk.fact_estimate_coherent_reference(xf, fkb4, 4, 1.0),
                lambda: mfa_bank.estimate_factored_coherent(
                    fbank, rf_blocks, "all", n // 4, 1.0),
                fact_flops + 3.0 * n * K, fact_bytes,
                lambda: mfa_bank.estimate_factored_coherent(fbank, rf_blocks))
    t13 = timed("K13", lambda: fk.fact_estimate_stats(xf, fkb),
                lambda: fk.fact_estimate_stats_reference(xf, fkb),
                lambda: mfa_bank.estimate_factored_stats(fbank, r_f, n),
                fact_flops, fact_bytes + 8.0 * n,
                lambda: mfa_bank.estimate_factored_stats(fbank, r_f))

    src = "quantized_channel_estimation_torch/csrc/"
    tpu = "quantized_channel_estimation_tpu/estimators/pallas_kernels.py"
    print(json.dumps({"kernels": [
        {"name": "grouped_estimate", "id": "K1", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:327",
         "launches": total_launches["grouped_estimate"],
         "max_abs_err": max(errs["grouped_estimate"]), **t1},
        {"name": "grouped_estimate_coherent", "id": "K3", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:1151",
         "launches": total_launches["grouped_estimate_coherent"],
         "max_abs_err": max(errs["grouped_estimate_coherent"]),
         "t_coh": 4, "coh_alpha": 1.0, **t3, "at_t16": t3_16},
        {"name": "grouped_estimate_topk", "id": "K4", "route": "cuda",
         "source": src + "grouped_topk.cu", "replaces": f"{tpu}:568",
         "launches": total_launches["grouped_estimate_topk"],
         "max_abs_err": max(errs["grouped_estimate_topk"]),
         "k_sel": 1, **t4[1], "at_k4": t4[4]},
        {"name": "circ_estimate", "id": "K6", "route": "cuda",
         "source": src + "circ_estimate.cu", "replaces": f"{tpu}:1309",
         "launches": total_launches["circ_estimate"],
         "max_abs_err": max(errs["circ_estimate"]), **t6},
        {"name": "circ_estimate_coherent", "id": "K7", "route": "cuda",
         "source": src + "circ_estimate.cu", "replaces": f"{tpu}:1647",
         "launches": total_launches["circ_estimate_coherent"],
         "max_abs_err": max(errs["circ_estimate_coherent"]),
         "t_coh": 4, "coh_alpha": 1.0, **t7},
        {"name": "circ_estimate_stats", "id": "K8", "route": "cuda",
         "source": src + "circ_estimate.cu", "replaces": f"{tpu}:1749",
         "launches": total_launches["circ_estimate_stats"],
         "max_abs_err": max(errs["circ_estimate_stats"]), **t8},
        {"name": "circ_estimate_coherent_stats", "id": "K9", "route": "cuda",
         "source": src + "circ_estimate.cu", "replaces": f"{tpu}:1822",
         "launches": total_launches["circ_estimate_coherent_stats"],
         "max_abs_err": max(errs["circ_estimate_coherent_stats"]),
         "t_coh": 4, "coh_alpha": 1.0, **t9},
        {"name": "mp_circ_estimate", "id": "K10", "route": "cuda",
         "source": src + "mp_circ_estimate.cu", "replaces": f"{tpu}:1505",
         "launches": total_launches["mp_circ_estimate"],
         "max_abs_err": max(errs["mp_circ_estimate"]),
         "n_pilots": 2, **t10, "at_p4": t10_p4},
        {"name": "mp_circ_estimate_coherent", "id": "K10_coh", "route": "cuda",
         "source": src + "mp_circ_estimate.cu", "replaces": f"{tpu}:1505",
         "launches": total_launches["mp_circ_estimate_coherent"],
         "max_abs_err": max(errs["mp_circ_estimate_coherent"]),
         "n_pilots": 2, "t_coh": 4, "coh_alpha": 1.0, **t10_coh},
        {"name": "fact_estimate", "id": "K11", "route": "cuda",
         "source": src + "fact_estimate.cu", "replaces": f"{tpu}:2048",
         "launches": total_launches["fact_estimate"],
         "max_abs_err": max(errs["fact_estimate"]), "latent_dim": M_LAT,
         **t11},
        {"name": "fact_estimate_coherent", "id": "K12", "route": "cuda",
         "source": src + "fact_estimate.cu", "replaces": f"{tpu}:2126",
         "launches": total_launches["fact_estimate_coherent"],
         "max_abs_err": max(errs["fact_estimate_coherent"]),
         "latent_dim": M_LAT, "t_coh": 4, "coh_alpha": 1.0, **t12},
        {"name": "fact_estimate_stats", "id": "K13", "route": "cuda",
         "source": src + "fact_estimate.cu", "replaces": f"{tpu}:2231",
         "launches": total_launches["fact_estimate_stats"],
         "max_abs_err": max(errs["fact_estimate_stats"]),
         "latent_dim": M_LAT, **t13},
    ]}))
    print(json.dumps({"main_path": {
        "defaults": {"mse": mse, "rate": rate, "seconds": main_s,
                     "timings": timings, "launches": launches},
        "n_coherence_4": {"mse": mse_c, "rate": rate_c, "seconds": coh_s,
                          "timings": timings_c, "launches": launches_c},
        "circulant": {"mse": mse_s, "rate": rate_s, "seconds": circ_s,
                      "timings": timings_s, "launches": launches_s},
        "circulant_n_coherence_4": {
            "mse": mse_sc, "rate": rate_sc, "seconds": circ_coh_s,
            "timings": timings_sc, "launches": launches_sc},
        "circulant_n_pilots_2": {
            "mse": mse_m, "rate": rate_m, "seconds": mp_s,
            "timings": timings_m, "launches": launches_m,
            "rel_to_dense_bank": {str(k): v for k, v in mp_vs_dense.items()}},
        "circulant_n_pilots_2_n_coherence_4": {
            "mse": mse_mc, "rate": rate_mc, "seconds": mp_coh_s,
            "timings": timings_mc, "launches": launches_mc},
        "run_mfa": {
            "mse": mse_f, "rate": rate_f, "seconds": mfa_s,
            "timings": timings_f, "launches": launches_f,
            "rel_to_dense_bank": {str(k): v for k, v in mfa_vs_dense.items()}},
        "run_mfa_n_coherence_4": {
            "mse": mse_fc, "rate": rate_fc, "seconds": mfa_coh_s,
            "timings": timings_fc, "launches": launches_fc},
        "total_seconds": time.time() - t0}}))
    print(json.dumps({"serving": serve}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
