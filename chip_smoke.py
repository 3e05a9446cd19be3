"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of every CUDA kernel of the port from `csrc/` with `nvcc`;
  2. every kernel against its plain PyTorch version on the card, at the
     widths of the main path (D = M = 64, K = 64), at the headline batch
     N = 131072, at the main path's ragged N = 10000 and with dead
     components;
  3. the main path, `run_gmm.run` at the `GmmBenchConfig` defaults on the
     card, with the kernels' launch counts set to 0 just before and read
     just after, and the scientific invariants of its MSE table;
  4. CUDA-event times of each kernel, its plain version and a library
     yardstick at the headline benchmark's shapes, beside the least time
     the card could take;
then one JSON line of kernels, one of the main path's results, the card
line, and the final status line. It imports nothing of JAX and uses one
card.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 1e-4          # max |kernel - plain| / max |plain|, float32 sums
N_BENCH, D, K, N_BITS, SNR = 131072, 64, 64, 2, 10.0


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from quantized_channel_estimation_torch.estimators import kernels
    from quantized_channel_estimation_torch.harness import run_gmm
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
    kb = kernels.kernel_bank_block(bank)
    r = bench_obs(dev, q, N_BENCH)
    r2 = torch.cat([r.real, r.imag], dim=-1).float().contiguous()
    checks = {}
    n_val = run_gmm.GmmBenchConfig().n_val     # the main path's batch
    for label, bank_c, rows in (("full", bank, r2),
                                ("main path", bank, r2[:n_val]),
                                ("dead", bench_bank(dev, n_dead=5)[0],
                                 r2[:8191])):
        kb_c = kernels.kernel_bank_block(bank_c)
        got = kernels.grouped_estimate(rows, kb_c)
        torch.cuda.synchronize()
        want = kernels.grouped_estimate_reference(rows, kb_c)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        log(f"grouped_estimate vs plain [{label}, N={rows.shape[0]}]: "
            f"max abs {abs_err:.3e}, max rel {rel:.3e} (tol {TOL})")
        if not (rel <= TOL and torch.isfinite(got).all()):
            raise AssertionError(f"grouped_estimate disagrees ({label})")
        checks[label] = abs_err

    # 3. the main path: run_gmm at its defaults on the card
    with tempfile.TemporaryDirectory() as tmp:
        cfg = run_gmm.GmmBenchConfig(results_dir=tmp,
                                     cache_dir=os.path.join(tmp, "saves"),
                                     use_cache=False)
        kernels.reset_launch_counts()
        tm = time.time()
        mse, rate, timings = run_gmm.run(cfg, device=dev)
        torch.cuda.synchronize()
        main_s = time.time() - tm
        launches = kernels.launch_counts()
        csvs = sorted(os.listdir(os.path.join(tmp, "3gpp")))
    log(f"run_gmm (D={cfg.n_antennas}, K={cfg.n_components}, "
        f"n_train={cfg.n_train}, n_val={cfg.n_val}, {len(cfg.snrs)} SNRs): "
        f"{main_s:.1f}s, GMM fit {timings['gmm_fit']:.1f}s; "
        f"launches {launches}; csv {csvs}")
    for name, vals in mse.items():
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite MSE in {name}: {vals}")
        if not vals[0] > vals[-1]:
            raise AssertionError(f"MSE of {name} does not fall with SNR")
    i10 = list(cfg.snrs).index(10)
    at10 = {k: v[i10] for k, v in mse.items()}
    if not (at10["blmmse_genie"] < at10["blmmse_gmm"] < at10["blmmse_glob"]
            < at10["LS_glob"]):
        raise AssertionError(f"MSE order at 10 dB broken: {at10}")
    if launches["grouped_estimate"] < len(cfg.snrs):
        raise AssertionError(f"main path launched K1 only "
                             f"{launches['grouped_estimate']} times")
    if len(csvs) != 2 or not all(math.isfinite(v) for v in
                                 sum(rate.values(), [])):
        raise AssertionError(f"CSV or rate rows missing: {csvs}")

    # 4. times at the headline benchmark's shapes
    n, two_m = r2.shape
    _, _, s_cols = kb.pw.shape
    two_d = s_cols - two_m
    flops = 2.0 * n * two_m * s_cols * K
    nbytes = 4.0 * (n * two_m + n * two_d + kb.pw.numel() + kb.mu.numel()
                    + kb.b.numel() + kb.logw.numel())
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    flat = kb.pw.permute(1, 0, 2).reshape(two_m, K * s_cols).contiguous()
    plain = lambda: kernels.grouped_estimate_reference(r2, kb)  # noqa: E731
    kern = lambda: kernels.grouped_estimate(r2, kb)  # noqa: E731
    gemm = lambda: r2 @ flat  # noqa: E731
    plain_ms = cuda_ms(plain)
    ms = cuda_ms(kern)
    ms2 = cuda_ms(kern)
    plain_ms2 = cuda_ms(plain)
    library_ms = cuda_ms(gemm)
    log(f"K1 at N={n}, 2M={two_m}, 2D={two_d}, K={K}: kernel {ms:.3f} / "
        f"{ms2:.3f} ms, plain {plain_ms:.3f} / {plain_ms2:.3f} ms, "
        f"GEMM-only floor (torch.matmul fp32) {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms (fp32 FMA), {n / (ms * 1e-3):.4g} estimates/s")

    print(json.dumps({"kernels": [{
        "name": "grouped_estimate",
        "route": "cuda",
        "source": "quantized_channel_estimation_torch/csrc/"
                  "grouped_estimate.cu",
        "replaces": "quantized_channel_estimation_tpu/estimators/"
                    "pallas_kernels.py:327",
        "launches": launches["grouped_estimate"],
        "max_abs_err": checks["full"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS
                    >= nbytes / PEAK_HBM_BYTES else "bytes",
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"main_path": {"mse": mse, "rate": rate,
                                    "seconds": main_s, "timings": timings,
                                    "total_seconds": time.time() - t0}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
