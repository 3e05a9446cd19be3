"""Compare the dense estimation kernels on the card.

Port of the JAX repository's `tools/kernel_bench.py`, on the same random
bank and batch (131072 rows, K = D = 64, 2 bits, 10 dB). It times

  karatsuba  K14a (`variant_kernels.estimate`, three real products per
             complex product, each six bf16 products on the tensor cores);
  block      K1 (`kernels.estimate_fused`, the real 2x2 block embedding,
             four real products' work per complex product, six bf16
             products each on the tensor cores; JAX's `block_t*`,
             `blockg*` and `t*` variants are tile and group sizes of the
             TPU kernel and collapse to it here);
  einsum     the einsum estimator (`gmm_estimator.estimate`, 'all', 16384
             rows a chunk), the library yardstick;

each as the median of `--repeats` calls timed with CUDA events (the banks'
kernel layouts made once, in a cache beside the bank), and prints
estimates/s and ms, then the Karatsuba/block time ratio: the JAX tool's
question, which layout wins, with both on the tensor cores (the Karatsuba
layout does 3/4 of the block embedding's products). A variant that fails
stops the run.

    python -m quantized_channel_estimation_torch.tools.kernel_bench \
        [--batch N] [--repeats R] [--device cpu]
"""
from __future__ import annotations

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import variant_kernels
from quantized_channel_estimation_torch.models import gmm_estimator
from quantized_channel_estimation_torch.tools import common


def main(argv=None) -> dict:
    p = common.parser(__doc__)
    p.add_argument("--batch", type=int, default=common.BATCH)
    args = p.parse_args(argv)
    dev = common.device(args.device)
    bank, q = common.headline_bank(dev, args.n_ant, args.components,
                                   args.bits)
    r = common.observations(dev, q, args.batch, args.n_ant, args.bits)
    cache, k_cache = {}, {}
    variants = {
        "karatsuba": lambda: variant_kernels.estimate(bank, r, k_cache),
        "block": lambda: kernels.estimate_fused(bank, r, cache),
        "einsum": lambda: gmm_estimator.estimate(bank, r, "all", 16384),
    }
    print(f"# kernel_bench on {common.device_label(dev)}: N={args.batch}, "
          f"D={args.n_ant}, K={args.components}", flush=True)
    ms = {}
    for name, fn in variants.items():
        total = float(fn().abs().sum())
        if not (total > 0 and torch.isfinite(torch.tensor(total))):
            raise AssertionError(f"{name}: output sum {total}")
        ms[name] = common.time_ms(fn, dev, args.repeats)
        print(f"{name:20s} {args.batch / ms[name] / 1e3:8.2f} M est/s  "
              f"({ms[name]:8.3f} ms)", flush=True)
    best = min(ms, key=ms.get)
    ratio = ms["karatsuba"] / ms["block"]
    print(f"best: {best} at {args.batch / ms[best] / 1e3:.2f} M est/s; "
          f"karatsuba / block {ratio:.3f}", flush=True)
    return {"device": common.device_label(dev), "n": args.batch, "ms": ms,
            "karatsuba_over_block": ratio}


if __name__ == "__main__":
    main()
