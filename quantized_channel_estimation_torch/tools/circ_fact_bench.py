"""The factorised circulant kernels (`csrc/circ_fact_estimate.cu`, K6 /
K7 and its STATS form K8 / K9; `csrc/mp_circ_fact_estimate.cu`, K10)
timed beside what they replaced and beside the `torch.fft` pipeline.

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
          template (`circ_estimate`), one dispatch rule unchanged;
  mp      the multi-pilot K10 on the JAX `tools/mp_kernel_bench.py`'s bank
          (`tools.mp_kernel_bench.make_prior`, its P-pilot bank at 2 bits,
          10 dB, and its quantized observations) at D = 256, K = 32, P = 2,
          65536 rows: flat and T = 4 (alpha 1) through the entries
          (`mp_circ_kernels.estimate_fused_circulant_mp[_coherent]` with a
          cache, which pick the kernel by `mp_circ_route`), the dense wide
          form (`mp_circ_estimate[_coherent]_wide`) on the same rows, and
          the pipeline over the batch as one chunk; `mp336` the same at D =
          336, K = 64; `mp357` at D = 357 (17 x 21), K = 32, P = 3, the most
          pilots the factorised kernel takes there;
  reach   the factorised K10 against the dense wide form in turns
          (kernel, wide, wide, kernel) at each of `REACH_SHAPES` (P, D, K,
          T, basis), 32768 rows, on random DFT-domain multi-pilot banks
          (`tools.tc_repeat_check.random_dft_mp_bank`), with the route
          `mp_circ_route` gives each: the measurements behind the route's
          reach (`mp_circ_kernels.mp_circ_fact_eligible`);
  stats   K8 and K9 (T = 4, alpha 1) on the d512 leg's inputs through the
          public wrappers (`circ_kernels.circ_estimate[_coherent]_stats`
          with the bank's operands from `lowered_tc`, which pick the
          kernel by `circ_route`: the factorised kernel's STATS form at D =
          512), the dense wide form (`circ_estimate[_coherent]_stats_wide`)
          and the one-chunk `torch.fft` stats pipeline in turns (entry,
          wide, pipeline, pipeline, wide, entry), their quotients acc /
          den compared with the pipeline's; under `--root` the checkout's
          own route (the parent: the dense wide form);
  stats_reach  the factorised K8 / K9 against the dense wide form in turns
          (kernel, wide, wide, kernel) at each of `STATS_REACH_SHAPES` (D,
          K, T, basis), 32768 rows, on random DFT-domain banks
          (`tools.tc_repeat_check.random_dft_bank`), with the route
          `circ_route` gives each: the measurements behind the stats
          forms' route.

Each route is timed with CUDA events (`utils.profiling.device_ms`: one
warm-up call, the median of 5) and compared with the pipeline (largest
difference as a fraction of its scale); its launches by kernel, and for the
kernels `circ_kernels.circ_bound` and the share reached. The last line is
one JSON object with the card's name and power limit.

    python quantized_channel_estimation_torch/tools/circ_fact_bench.py \
        [d512|d672|narrow|mp|mp336|mp357|reach|stats|stats_reach ...] \
        [--root DIR]

`--root` imports the package from another checkout (a parent commit
unpacked with `git archive`): the routes that checkout lacks are left
out, so parent / change / change / parent runs of the d512, mp and stats
legs time the public wrappers and entries of both in one call. Needs a
card.
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
        if leg.startswith("mp"):
            rec["legs"][leg] = _mp_leg(leg, route, dev, torch)
            continue
        if leg == "stats":
            rec["legs"][leg] = _stats_leg(dev, torch, profiling)
            continue
        if leg == "stats_reach":
            rec["legs"][leg] = _stats_reach_leg(dev, torch, profiling)
            continue
        if leg == "reach":
            rec["legs"][leg] = _reach_leg(dev, torch, profiling)
            continue
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


MP_LEGS = {"mp": (256, 32, 2), "mp336": (336, 64, 2), "mp357": (357, 32, 3)}


# (P, D, K, T, blocks) of the `reach` leg: the served width and its pool,
# K against D, dense odd-prime levels (129 = 3 x 43, ..., 357 = 17 x 21),
# two sweeps (T past a tile's rows) with and without odd-prime levels, the
# kron basis, many pilots, the widest D
REACH_SHAPES = (
    (2, 256, 32, 1, None), (2, 256, 32, 4, None), (2, 256, 16, 16, (16, 16)),
    (2, 256, 64, 1, None), (2, 256, 96, 1, None), (2, 256, 128, 1, None),
    (2, 144, 8, 1, None), (2, 144, 32, 1, None), (2, 144, 64, 1, None),
    (3, 144, 16, 4, None), (4, 144, 32, 1, None), (2, 160, 32, 1, None),
    (2, 160, 64, 1, None), (2, 192, 32, 1, None), (2, 192, 64, 1, None),
    (2, 336, 64, 1, None), (2, 336, 128, 1, None), (2, 512, 32, 1, None),
    (2, 512, 128, 1, None), (2, 129, 8, 1, None), (2, 130, 8, 1, None),
    (2, 133, 8, 1, None), (2, 155, 8, 1, None), (2, 185, 8, 1, None),
    (2, 296, 8, 1, None), (2, 344, 8, 1, None), (2, 357, 32, 1, None),
    (3, 357, 8, 1, None), (2, 357, 128, 1, None), (4, 189, 8, 1, None),
    (2, 168, 16, 1, None), (2, 400, 16, 1, None), (3, 200, 32, 1, None),
    (2, 200, 8, 16, None), (2, 200, 8, 64, None), (2, 256, 8, 64, None),
    (4, 256, 8, 1, None), (12, 64, 16, 1, None))


def _reach_leg(dev, torch, profiling) -> dict:
    """Leg `reach`: the factorised K10 against the dense wide form at
    `REACH_SHAPES`, 32768 rows, in turns."""
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck, mp_circ_kernels as mk)
    from quantized_channel_estimation_torch.tools import (
        tc_repeat_check as trc)
    n = 32768
    print(f"== reach: factorised K10 against the dense wide form, {n} rows ==",
          flush=True)
    out = {}
    for p, d, k, t, blocks in REACH_SHAPES:
        ckb = mk.mp_circ_kernel_bank(
            trc.random_dft_mp_bank(p, d, k, dev, 1), blocks, t, 1.0)
        fops = mk.mp_circ_fact_operands(ckb, blocks)
        wops = mk.mp_circ_wide_operands(ckb)
        x2 = trc.random_rows(n // t * t, 2 * p * d, dev)
        if t == 1:
            runs = (lambda: mk.mp_circ_estimate_fact(x2, ckb, fops),
                    lambda: mk.mp_circ_estimate_wide(x2, ckb, wops))
        else:
            runs = (lambda: mk.mp_circ_estimate_coherent_fact(
                        x2, ckb, t, 1.0, fops),
                    lambda: mk.mp_circ_estimate_coherent_wide(
                        x2, ckb, t, 1.0, wops))
        ms = [profiling.device_ms(runs[i]) for i in (0, 1, 1, 0)]
        rec = {"route": mk.mp_circ_route(d, k, p, t, blocks),
               "rows_a_tile": 16 * mk.mp_circ_fact_plan(
                   *ck.circ_fact_blocks(d, blocks), p, k, t)[0],
               "fact_ms": [ms[0], ms[3]], "wide_ms": [ms[1], ms[2]],
               "speedup": (ms[1] + ms[2]) / (ms[0] + ms[3])}
        label = f"P={p} D={d} K={k} T={t}" + (f" blocks={blocks}" if blocks
                                               else "")
        out[label] = rec
        print(f"  {label:28s} route {rec['route']:5s} factorised {ms[0]:.3f}"
              f" / {ms[3]:.3f} ms, dense wide {ms[1]:.3f} / {ms[2]:.3f} ms, "
              f"{rec['speedup']:.2f}x", flush=True)
    return out


def _stats_leg(dev, torch, profiling) -> dict:
    """Leg `stats`: K8 / K9 at D = 512, K = 16, 32768 rows through the
    public wrappers and the dense wide form beside their one-chunk
    `torch.fft` stats pipelines, in turns."""
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck, kernels)
    from quantized_channel_estimation_torch.models import (
        structured_bank as sb)
    from quantized_channel_estimation_torch.tools import circ_kernel_bench
    d, k, n, t = 512, 16, 32768, 4
    print(f"== stats: D={d}, K={k}, {n} rows ==", flush=True)
    bank = circ_kernel_bench.synthetic_bank(d, k, device=dev)
    r = circ_kernel_bench.complex_randn((n, d), device=dev)
    rb = r.reshape(-1, t, d)
    x2 = ck._x2(r)
    cache = {}
    ckb, ckb4 = ck.lowered(bank, cache)[0], ck.lowered(bank, cache, None, t,
                                                       1.0)[0]
    ops = ck.lowered_tc(bank, cache, None, True)[0]
    wide_ops = ck.circ_wide_operands(ckb, True)
    out = {"route": ck.circ_route(d, None, True)}
    for label, entry, wide, pipe in (
            ("K8", lambda: ck.circ_estimate_stats(x2, ckb, ops),
             lambda: ck.circ_estimate_stats_wide(x2, ckb, wide_ops),
             lambda: sb.estimate_circulant_stats(bank, r, n, None, "fft")),
            ("K9 T=4", lambda: ck.circ_estimate_coherent_stats(
                x2, ckb4, t, 1.0, ops),
             lambda: ck.circ_estimate_coherent_stats_wide(x2, ckb4, t, 1.0,
                                                          wide_ops),
             lambda: sb.estimate_circulant_coherent_stats(
                 bank, rb, n // t, 1.0, None, "fft"))):
        want = pipe()
        den = want[1].reshape(want[1].shape + (1,) * (want[2].dim()
                                                    - want[1].dim()))
        ref = ck._x2((want[2] / den).reshape(n, d))
        rec = {}
        for name, fn in (("entry", entry), ("wide", wide)):
            kernels.reset_launch_counts()
            got = fn()
            torch.cuda.synchronize()
            rec[f"{name}_launches"] = {
                kk: v for kk, v in kernels.launch_counts().items() if v}
            rec[f"{name}_quotient_rel_to_fft"] = float(
                (got[2] / got[1][:, None] - ref).abs().max()
                / ref.abs().max())
        ms = [profiling.device_ms(f)
              for f in (entry, wide, pipe, pipe, wide, entry)]
        rec.update(entry_ms=[ms[0], ms[5]], wide_ms=[ms[1], ms[4]],
                   pipeline_ms=[ms[2], ms[3]],
                   **ck.circ_bound(n, d, k, t if label != "K8" else 1, True))
        out[label] = rec
        print(f"  {label:8s} entry {ms[0]:.3f} / {ms[5]:.3f} ms "
              f"{rec['entry_launches']}, dense wide {ms[1]:.3f} / "
              f"{ms[4]:.3f} ms, one-chunk pipeline {ms[2]:.3f} / {ms[3]:.3f}"
              f" ms, bound {rec['bound_ms']:.3f} ms, acc / den vs fft "
              f"{rec['entry_quotient_rel_to_fft']:.2e} (wide "
              f"{rec['wide_quotient_rel_to_fft']:.2e})", flush=True)
    return out


# (D, K, T, blocks) of the `stats_reach` leg: K = 64 / 128 at D = 144,
# 336, 512 and 672; the served width and its pool; dense odd-prime levels
# (129 = 3 x 43, 133 = 7 x 19, 185 = 5 x 37, 357 = 17 x 21); two sweeps
# (T = 64) with and without odd primes; the kron basis
STATS_REACH_SHAPES = (
    (144, 64, 1, None), (144, 128, 1, None), (336, 64, 1, None),
    (336, 128, 1, None), (512, 64, 1, None), (512, 128, 1, None),
    (672, 64, 1, None), (672, 128, 1, None), (512, 16, 1, None),
    (512, 16, 4, None), (512, 16, 64, None), (640, 16, 4, None),
    (129, 16, 1, None), (133, 16, 1, None), (185, 16, 1, None),
    (357, 32, 1, None), (357, 128, 4, None), (200, 16, 64, None),
    (160, 8, 16, None), (256, 16, 4, (16, 16)), (256, 64, 1, (8, 32)))


def _stats_reach_leg(dev, torch, profiling) -> dict:
    """Leg `stats_reach`: the factorised K8 / K9 against the dense wide
    form at `STATS_REACH_SHAPES`, 32768 rows, in turns."""
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck)
    from quantized_channel_estimation_torch.tools import (
        tc_repeat_check as trc)
    n = 32768
    print(f"== stats_reach: the factorised K8 / K9 against the dense wide "
          f"form, {n} rows ==", flush=True)
    out = {}
    for d, k, t, blocks in STATS_REACH_SHAPES:
        ckb = ck.circ_kernel_bank(trc.random_dft_bank(d, k, dev, 1), blocks,
                                  t, 1.0)
        fops = ck.circ_fact_operands(ckb, blocks)
        wops = ck.circ_wide_operands(ckb, True)
        x2 = trc.random_rows(n // t * t, 2 * d, dev)
        if t == 1:
            runs = (lambda: ck.circ_estimate_stats_fact(x2, ckb, fops),
                    lambda: ck.circ_estimate_stats_wide(x2, ckb, wops))
        else:
            runs = (lambda: ck.circ_estimate_coherent_stats_fact(
                        x2, ckb, t, 1.0, fops),
                    lambda: ck.circ_estimate_coherent_stats_wide(
                        x2, ckb, t, 1.0, wops))
        ms = [profiling.device_ms(runs[i]) for i in (0, 1, 1, 0)]
        rec = {"route": ck.circ_route(d, blocks, True),
               "fact_ms": [ms[0], ms[3]], "wide_ms": [ms[1], ms[2]],
               "speedup": (ms[1] + ms[2]) / (ms[0] + ms[3])}
        label = f"D={d} K={k} T={t}" + (f" blocks={blocks}" if blocks
                                        else "")
        out[label] = rec
        print(f"  {label:28s} route {rec['route']:5s} factorised {ms[0]:.3f}"
              f" / {ms[3]:.3f} ms, dense wide {ms[1]:.3f} / {ms[2]:.3f} ms, "
              f"{rec['speedup']:.2f}x", flush=True)
        del ckb, fops, wops, x2
    return out


def _mp_leg(leg, route, dev, torch) -> dict:
    """Leg `mp*`: K10 at (D, K, P) of `MP_LEGS`, 65536 rows, flat and T = 4,
    through the entries, the dense wide form and the one-chunk pipeline."""
    from quantized_channel_estimation_torch.estimators import (
        mp_circ_kernels as mk)
    from quantized_channel_estimation_torch.models import (
        structured_bank as sb)
    from quantized_channel_estimation_torch.ops import observation, pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.ops.cplx import crandn
    from quantized_channel_estimation_torch.tools import mp_kernel_bench as mb
    d, k, p = MP_LEGS[leg]
    n, t = 65536, 4
    print(f"== {leg}: D={d}, K={k}, P={p}, {n} rows ==", flush=True)
    params, spectra = mb.make_prior(d, k, device=dev)
    a = pilots.pilot_matrix(d, p, mb.N_BITS, device=dev)
    q = Q.design_quantizer(mb.SNR, mb.N_BITS, device=dev)
    bank = sb.prepare_bank_circulant(params, mb.SNR, a, mb.N_BITS, q,
                                     spectra=spectra)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = observation.observe(gen, crandn(gen, (n, d)), mb.SNR, a, mb.N_BITS, q)
    rb = r.reshape(n // t, t, -1)
    x2 = mk._x2(r)
    cache = {}
    want = mk._x2(sb.estimate_circulant(bank, r, "all", n, None, "fft"))
    want4 = mk._x2(sb.estimate_circulant_coherent(bank, rb, "all", n // t,
                                                  1.0, None, "fft"))
    ckb, ckb4 = mk.lowered(bank, cache), mk.lowered(bank, cache, None, t, 1.0)
    wide_ops = mk.mp_circ_wide_operands(ckb)
    bound, bound4 = mk.mp_circ_bound(n, d, k, p), mk.mp_circ_bound(n, d, k,
                                                                   p, t)
    out = {"route": (mk.mp_circ_route(d, k, p), mk.mp_circ_route(d, k, p, t))
           if hasattr(mk, "mp_circ_route") else ("wide", "wide")}
    out["K10 entry"] = route(
        "K10, entry", lambda: mk._x2(mk.estimate_fused_circulant_mp(
            bank, r, None, cache)), want, bound)
    out["K10 T=4 entry"] = route(
        "K10 (T=4), entry", lambda: mk._x2(
            mk.estimate_fused_circulant_mp_coherent(bank, rb, 1.0, None,
                                                    cache)), want4, bound4)
    out["K10 dense wide"] = route(
        "K10, dense wide form",
        lambda: mk.mp_circ_estimate_wide(x2, ckb, wide_ops), want, bound)
    out["K10 T=4 dense wide"] = route(
        "K10 (T=4), dense wide form",
        lambda: mk.mp_circ_estimate_coherent_wide(x2, ckb4, t, 1.0, wide_ops),
        want4, bound4)
    out["fft one chunk"] = route(
        "torch.fft pipeline, one chunk",
        lambda: mk._x2(sb.estimate_circulant(bank, r, "all", n, None, "fft")),
        want)
    out["fft one chunk T=4"] = route(
        "torch.fft coherent pipeline, one chunk",
        lambda: mk._x2(sb.estimate_circulant_coherent(
            bank, rb, "all", n // t, 1.0, None, "fft")), want4)
    return out


if __name__ == "__main__":
    main()
