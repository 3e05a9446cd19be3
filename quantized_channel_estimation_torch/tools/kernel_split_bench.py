"""Measure K1's GEMM-precision modes on the card: speed and estimation MSE.

Port of the JAX repository's `tools/kernel_split_bench.py`, with
`tools/kernel_precision_experiment.py` folded in. A GMM is fitted to SCM
channels (one path, D = 64, K = 64, 50000 training channels, 40 EM
iterations), and its banks at 10 and 20 dB (2 bits, one `angle_amp`
pilot; high SNR is the precision-critical regime) estimate 131072
validation channels through

  kernel_f32     K1 (float32 FMAs, the default);
  kernel_bf16    K14b, one bf16 tensor-core pass (the JAX experiment's
                 `kernel_bf16x1`, Precision.DEFAULT);
  kernel_split3  K14b, r_hi pw_hi + r_hi pw_lo + r_lo pw_hi;
  kernel_split2  K14b, r_hi pw_hi + r_hi pw_lo;

each line with its channel MSE, its rate (median of `--repeats` calls,
CUDA events), its relative distance from kernel_f32, and the einsum
estimator's MSE and rate (`einsum_f32`, the yardstick).

    python -m quantized_channel_estimation_torch.tools.kernel_split_bench \
        [--n-train N] [--n-val N] [--max-iter I] [--device cpu]
"""
from __future__ import annotations

import time

import torch

from quantized_channel_estimation_torch.estimators import variant_kernels
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.tools import common

N_TRAIN, N_VAL, MAX_ITER, SNRS = 50_000, 131_072, 40, (10.0, 20.0)
MODES = ("f32", "bf16", "split3", "split2")


def main(argv=None) -> dict:
    p = common.parser(__doc__)
    p.add_argument("--n-train", type=int, default=N_TRAIN)
    p.add_argument("--n-val", type=int, default=N_VAL)
    p.add_argument("--max-iter", type=int, default=MAX_ITER)
    args = p.parse_args(argv)
    dev = common.device(args.device)
    d, k_comp, n_bits, n_val = (args.n_ant, args.components, args.bits,
                                args.n_val)
    gen = torch.Generator(device=dev).manual_seed(7)
    h = stages.generate_channels(gen, args.n_train + n_val,
                                 scm.ScmConfig(d, 1), chunk=32768)[0]
    h_train, h_val = h[:args.n_train], h[args.n_train:]
    cfg = gmm.GmmConfig(n_components=k_comp, max_iter=args.max_iter,
                        chunk_size=16384)
    t0 = time.time()
    params = gmm.fit(torch.Generator(device=dev).manual_seed(1), h_train,
                     cfg).params
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.time() - t0
    print(f"# kernel_split_bench on {common.device_label(dev)}: fit done in "
          f"{fit_s:.1f}s (D={d}, K={k_comp}, n_train={args.n_train}, "
          f"n_val={n_val})", flush=True)
    a = pilots.pilot_matrix(d, 1, n_bits, device=dev)

    def mse(est):
        return float((h_val - est).abs().square().sum()) / (n_val * d)

    rows = {}
    for snr in SNRS:
        q = Q.design_quantizer(snr, n_bits, device=dev)
        bank = gmm_estimator.prepare_bank(params, snr, a, n_bits, q)
        r = observation.observe(torch.Generator(device=dev).manual_seed(2),
                                h_val, snr, a, n_bits, q)
        cache = {}

        def run(mode):
            if mode == "einsum":
                return gmm_estimator.estimate(bank, r, "all", 16384)
            return variant_kernels.estimate_block_grouped(bank, r, mode,
                                                          cache)

        yard = {"mse": mse(run("einsum")),
                "ms": common.time_ms(lambda: run("einsum"), dev,
                                     args.repeats)}
        row, ref = {"einsum_f32": yard}, None
        for mode in MODES:
            est = run(mode)
            ref = est if ref is None else ref
            rec = {"mse": mse(est),
                   "ms": common.time_ms(lambda: run(mode), dev, args.repeats),
                   "rel_to_f32": float(torch.linalg.vector_norm(est - ref)
                                       / torch.linalg.vector_norm(ref))}
            row[f"kernel_{mode}"] = rec
            print(f"snr={snr:4.0f}  kernel_{mode:7s} mse={rec['mse']:.6f} "
                  f"rel_f32={rec['rel_to_f32']:.2e} "
                  f"rate={n_val / rec['ms'] / 1e3:8.2f} M/s  (einsum_f32 "
                  f"mse={yard['mse']:.6f} rate="
                  f"{n_val / yard['ms'] / 1e3:.2f} M/s)", flush=True)
        rows[snr] = row
    return {"device": common.device_label(dev), "fit_s": fit_s,
            "n_val": n_val, "rows": rows}


if __name__ == "__main__":
    main()
