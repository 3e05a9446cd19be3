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
     counted, not compared);
  3. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after: `run_gmm.run` at the `GmmBenchConfig`
     defaults, and again with `n_coherence=4` (alpha 1), with the
     scientific invariants of their MSE tables; then the
     `EstimationService` at the headline widths (the synthetic bank of
     `tools/serving_bench.py`, 8 closed-loop clients of 64-snapshot
     requests at -5/5/15 dB, max_batch 1024) in four modes: flat 'all',
     T=4 blocks, top-1 and top-4, each held against the plain einsum
     estimator on one request, with its throughput, latency and
     `metrics()`;
  4. CUDA-event times of each kernel, its plain version and a library
     yardstick at the headline shapes, beside the least time the card
     could take;
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


def bench_obs(dev, q, n):
    """Quantized observations of unit-power channels at 10 dB, 2 bits."""
    from quantized_channel_estimation_torch.ops import observation
    from quantized_channel_estimation_torch.ops.cplx import crandn
    gen = torch.Generator(device=dev).manual_seed(1)
    h = crandn(gen, (n, D))
    return observation.observe(gen, h, SNR, None, N_BITS, q)


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


def main_path_run(run_gmm, kernels, dev, tmp, **change):
    """run_gmm at the defaults (plus `change`) on the card, its kernel
    launches counted alone; checks every column finite and falling with
    SNR."""
    cfg = run_gmm.GmmBenchConfig(results_dir=tmp,
                                 cache_dir=os.path.join(tmp, "saves"),
                                 use_cache=False, **change)
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
        if not vals[0] > vals[-1]:
            raise AssertionError(f"MSE of {name} does not fall with SNR")
    if not all(math.isfinite(v) for v in sum(rate.values(), [])):
        raise AssertionError("non-finite rate row")
    return cfg, mse, rate, timings, seconds, launches


def serve_mode(svc, kernels, bank, label, t_coh, kernel_name):
    """Closed-loop load on one service mode: warm-up, then SERVE_CLIENTS
    clients for SERVE_SECONDS, the launch counts read around the window.
    Returns the mode's record; raises on a failed request, a kernel that
    was not launched or an answer off the plain einsum estimator."""
    from quantized_channel_estimation_torch.models import gmm_estimator
    rng = np.random.default_rng(1)

    def request(size):
        x = (rng.standard_normal((size, D))
             + 1j * rng.standard_normal((size, D))).astype(np.complex64)
        return x.reshape(size // t_coh, t_coh, D) if t_coh > 1 else x

    # one request held against the plain einsum estimator on the card
    r = request(SERVE_REQ)
    dev = bank.filters.device
    got = torch.as_tensor(svc.submit(r, SNR, timeout=120.0), device=dev)
    rt = torch.as_tensor(r, device=dev)
    mode = svc.mode
    if t_coh > 1:
        want = gmm_estimator.estimate_coherent(bank, rt, mode)
    else:
        want = gmm_estimator.estimate(bank, rt, mode)
    skip = None
    if mode != "all":
        r2 = torch.cat([rt.real, rt.imag], -1).float()
        skip = near_ties(r2, kernels.kernel_bank_block(bank), mode)
    err = compare("service", label, got.reshape(-1, D), want.reshape(-1, D),
                  skip)

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
    from quantized_channel_estimation_torch.estimators import kernels
    from quantized_channel_estimation_torch.harness import run_gmm
    from quantized_channel_estimation_torch.models import gmm_estimator
    from quantized_channel_estimation_torch.ops import quantizer as Q
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
    errs = {"grouped_estimate": [], "grouped_estimate_coherent": [],
            "grouped_estimate_topk": []}
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

    params = serving_params()
    a_eye = np.eye(D, dtype=np.complex64)     # the tool's pilot matrix
    serve_bank = gmm_estimator.prepare_bank(
        type(params)(*(torch.as_tensor(x, device=dev) for x in params)), SNR,
        torch.as_tensor(a_eye, device=dev), N_BITS,
        Q.design_quantizer(SNR, N_BITS).to(dev))
    serve = []
    for mode, modes in (("all", (("flat all", 1, "grouped_estimate"),
                                 ("T=4 blocks, alpha=1", 4,
                                  "grouped_estimate_coherent"))),
                        (1, (("top-1", 1, "grouped_estimate_topk"),)),
                        (4, (("top-4", 1, "grouped_estimate_topk"),))):
        svc = serving.EstimationService(params, a_eye, N_BITS, mode=mode,
                                        max_batch=SERVE_MAX_BATCH,
                                        device=dev)
        try:
            for label, t_coh, kernel_name in modes:
                serve.append(serve_mode(svc, kernels, serve_bank, label,
                                        t_coh, kernel_name))
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

    def bound(flops):
        ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        by = ("operations" if flops / PEAK_FP32_FLOPS
              >= nbytes / PEAK_HBM_BYTES else "bytes")
        return ms, by

    def timed(label, kern, plain, library, flops):
        plain_ms = cuda_ms(plain)
        ms = cuda_ms(kern)
        ms2 = cuda_ms(kern)
        plain_ms2 = cuda_ms(plain)
        library_ms = cuda_ms(library)
        bound_ms, bound_by = bound(flops)
        log(f"{label} at N={n}, 2M={two_m}, 2D={two_d}, K={K}: kernel "
            f"{ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} / "
            f"{plain_ms2:.3f} ms, library {library_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {n / (ms * 1e-3):.4g} "
            "estimates/s")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

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
    t4 = {k_sel: timed(
        f"K4 (k={k_sel})",
        lambda: kernels.grouped_estimate_topk(r2, kb, k_sel),
        lambda: kernels.grouped_estimate_topk_reference(r2, kb, k_sel),
        logit_gemm,
        2.0 * n * two_m * two_m * K + k_sel * 2.0 * n * two_m * two_d)
        for k_sel in (1, 4)}

    src = "quantized_channel_estimation_torch/csrc/"
    tpu = "quantized_channel_estimation_tpu/estimators/pallas_kernels.py"
    print(json.dumps({"kernels": [
        {"name": "grouped_estimate", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:327",
         "launches": total_launches["grouped_estimate"],
         "max_abs_err": max(errs["grouped_estimate"]), **t1},
        {"name": "grouped_estimate_coherent", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:1151",
         "launches": total_launches["grouped_estimate_coherent"],
         "max_abs_err": max(errs["grouped_estimate_coherent"]),
         "t_coh": 4, "coh_alpha": 1.0, **t3},
        {"name": "grouped_estimate_topk", "route": "cuda",
         "source": src + "grouped_topk.cu", "replaces": f"{tpu}:568",
         "launches": total_launches["grouped_estimate_topk"],
         "max_abs_err": max(errs["grouped_estimate_topk"]),
         "k_sel": 1, **t4[1], "at_k4": t4[4]},
    ]}))
    print(json.dumps({"main_path": {
        "defaults": {"mse": mse, "rate": rate, "seconds": main_s,
                     "timings": timings, "launches": launches},
        "n_coherence_4": {"mse": mse_c, "rate": rate_c, "seconds": coh_s,
                          "timings": timings_c, "launches": launches_c},
        "total_seconds": time.time() - t0}}))
    print(json.dumps({"serving": serve}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
