"""The factorised circulant kernel (`csrc/circ_fact_estimate.cu`) timed
beside what it replaced and beside the `torch.fft` pipeline.

Legs, on the synthetic bank of `tools.circ_kernel_bench` (the JAX tool's
bank, from a seed) and standard normal complex observations:

  d512    D = 512, K = 16, 32768 rows (the JAX tool's d512 leg): K6 and K7
          (T = 4, alpha 1) through the public wrappers
          (`circ_kernels.circ_estimate[_coherent]` with the bank's operands
          from `lowered_tc`, which pick the kernel by `circ_route`), the
          dense wide form (`circ_estimate[_coherent]_wide`) on the same
          inputs, and the pipeline over the batch as one chunk;
  d672    the same at D = 672 (the rule's edge, 24 x 28);
  narrow  D = 64 = 8 x 8, K = 64, 131072 rows (the narrow headline): the
          factorised kernel (`circ_estimate_fact`) beside the narrow K6
          template (`circ_estimate`), one dispatch rule unchanged.

Each route is timed with CUDA events (`utils.profiling.device_ms`: one
warm-up call, the median of 5) and compared with the pipeline (largest
difference as a fraction of its scale); its launches by kernel, and for the
kernels `circ_kernels.circ_bound` and the share reached. The last line is
one JSON object with the card's name and power limit.

    python quantized_channel_estimation_torch/tools/circ_fact_bench.py \
        [d512|d672|narrow ...] [--root DIR]

`--root` imports the package from another checkout (a parent commit
unpacked with `git archive`): the routes that checkout lacks are left
out, so parent / change / change / parent runs of the d512 leg time the
public wrappers of both in one call. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _card(torch) -> dict:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": line.strip().splitlines()[0] if line else None}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("legs", nargs="*", default=None)
    p.add_argument("--root", default=None,
                   help="import the package from this checkout")
    args = p.parse_args(argv)
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    import torch
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck, kernels)
    from quantized_channel_estimation_torch.models import (
        structured_bank as sb)
    from quantized_channel_estimation_torch.ops.precision import pin_fp32
    from quantized_channel_estimation_torch.tools import circ_kernel_bench
    from quantized_channel_estimation_torch.utils import profiling
    if not torch.cuda.is_available():
        raise SystemExit("circ_fact_bench needs a card")
    pin_fp32()
    dev = torch.device("cuda", 0)
    legs = args.legs or ["d512", "d672", "narrow"]
    rec = {"root": args.root or ".", **_card(torch), "legs": {}}

    def route(label, fn, want, bound=None):
        kernels.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        ms = profiling.device_ms(fn)
        out = {"ms": ms, "launches": launches,
               "rel_to_fft": float((got.reshape(want.shape) - want).abs().max()
                                   / want.abs().max())}
        if bound is not None:
            out.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                       share_of_bound=bound["bound_ms"] / ms)
        print(f"  {label:44s} {ms:8.3f} ms  vs fft {out['rel_to_fft']:.2e}  "
              f"{launches}", flush=True)
        return out

    for leg in legs:
        d, k, n = {"d512": (512, 16, 32768), "d672": (672, 16, 32768),
                   "narrow": (64, 64, 131072)}[leg]
        print(f"== {leg}: D={d}, K={k}, {n} rows ==", flush=True)
        bank = circ_kernel_bench.synthetic_bank(d, k, device=dev)
        r = circ_kernel_bench.complex_randn((n, d), device=dev)
        x2 = ck._x2(r)
        want = ck._x2(sb.estimate_circulant(bank, r, "all", n, None, "fft"))
        out = {}
        cache = {}
        ckb = ck.lowered(bank, cache)[0]
        bound = ck.circ_bound(n, d, k)
        if leg == "narrow":
            if hasattr(ck, "circ_estimate_fact"):
                ops = ck.circ_fact_operands(ckb)
                out["fact K6"] = route(
                    "factorised K6", lambda: ck.circ_estimate_fact(x2, ckb,
                                                                   ops),
                    want, bound)
            ops_t = ck.lowered_tc(bank, cache)[0]
            out["template K6"] = route(
                "narrow K6 template", lambda: ck.circ_estimate(x2, ckb, ops_t),
                want, bound)
        else:
            ops = ck.lowered_tc(bank, cache)[0]
            wide_ops = ck.circ_wide_operands(ckb)
            rb = r.reshape(-1, 4, d)
            want4 = ck._x2(sb.estimate_circulant_coherent(
                bank, rb, "all", n // 4, 1.0, None, "fft"))
            ckb4 = ck.lowered(bank, cache, None, 4, 1.0)[0]
            bound4 = ck.circ_bound(n, d, k, 4)
            out["K6 entry"] = route(
                "K6, public wrapper", lambda: ck.circ_estimate(x2, ckb, ops),
                want, bound)
            out["K7 entry"] = route(
                "K7 (T=4), public wrapper",
                lambda: ck.circ_estimate_coherent(x2, ckb4, 4, 1.0, ops),
                want4, bound4)
            out["K6 dense wide"] = route(
                "K6, dense wide form",
                lambda: ck.circ_estimate_wide(x2, ckb, wide_ops), want, bound)
            out["K7 dense wide"] = route(
                "K7 (T=4), dense wide form",
                lambda: ck.circ_estimate_coherent_wide(x2, ckb4, 4, 1.0,
                                                       wide_ops),
                want4, bound4)
            out["fft one chunk"] = route(
                "torch.fft pipeline, one chunk",
                lambda: ck._x2(sb.estimate_circulant(bank, r, "all", n, None,
                                                     "fft")), want)
            out["fft one chunk T=4"] = route(
                "torch.fft coherent pipeline, one chunk",
                lambda: ck._x2(sb.estimate_circulant_coherent(
                    bank, rb, "all", n // 4, 1.0, None, "fft")), want4)
        rec["legs"][leg] = out
        del bank, r, x2, want, cache
    print(rec["nvidia_smi"])
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
