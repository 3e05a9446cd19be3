"""The wide factored K11 / K12 (`csrc/fact_wide_estimate.cu`) split by
pass, on the card.

Builds `csrc/fact_wide_estimate.cu` with `-DQCE_PASS_EVENTS` (a CUDA event
before the launch's first pass and after each of its nine: the row split,
the forward product, the quadratic terms, the feature split, the logit
product, the softmax, the weighted-rows split, the combine product, the
fold) into `build/fact_pass_split/`, puts it in the place of the wrappers'
library for the run, and launches `fact_kernels.fact_estimate_wide` (K11)
and `fact_estimate_coherent_wide` (K12, T = 4, alpha 1) at D = 256, K =
32, M = 16, 32768 rows on a seeded bank (`tools.tc_repeat_check
.random_fact_bank`): one warm-up launch, then the median of 5 of each
pass's time and of the launch's whole time (first to last event), beside
the whole launch of the library built without the marks (CUDA events,
`utils.profiling.device_ms`). Prints a line a pass and, last, one JSON
object with the card's name and power limit.

    python -m quantized_channel_estimation_torch.tools.fact_pass_split \
        [--n 32768] [--d 256] [--k 32] [--m 16]

Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from quantized_channel_estimation_torch.estimators import fact_kernels as fk
from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from quantized_channel_estimation_torch.utils import profiling

PASSES = ("row split", "forward product", "quadratic terms",
          "feature split", "logit product", "softmax",
          "weighted-rows split", "combine product", "fold")
BUILD = kernels.BUILD_DIR.parent / "fact_pass_split"


def build_marked() -> ctypes.CDLL:
    """The wide form built with the pass marks, loaded and declared as the
    wrappers' library plus `fact_wide_pass_ms`."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD / "libfact_wide_estimate_passes.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DQCE_PASS_EVENTS", "-o",
         str(lib_path), str(kernels.CSRC / "fact_wide_estimate.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    kernels._declare("fact_wide_estimate", lib)
    lib.fact_wide_pass_ms.argtypes = [ctypes.c_void_p]
    lib.fact_wide_pass_ms.restype = ctypes.c_int
    return lib


def split(run, lib, reps: int = 5) -> dict:
    """Median pass times (ms) of `reps` launches of run after a warm-up."""
    ms = (ctypes.c_float * len(PASSES))()
    run()
    rows = []
    for _ in range(reps):
        run()
        err = lib.fact_wide_pass_ms(ms)
        if err != 0:
            raise RuntimeError(f"fact_wide_pass_ms: cudaError {err}")
        rows.append(list(ms))
    med = [statistics.median(r[i] for r in rows) for i in range(len(PASSES))]
    whole = statistics.median(sum(r) for r in rows)
    return {"passes_ms": dict(zip(PASSES, med)), "marked_ms": whole}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=32768)
    p.add_argument("--d", type=int, default=256)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--m", type=int, default=16)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fact_pass_split needs a card")
    dev = torch.device("cuda", 0)
    n, d, k, m = args.n, args.d, args.k, args.m
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    rec = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": line[0] if line else None,
           "n": n, "d": d, "k": k, "m": m, "forms": {}}
    fkb = trc.random_fact_bank(d, m, k, dev, n_dead=2)
    fkb4 = trc.random_fact_bank(d, m, k, dev, n_dead=2, t_coh=4)
    x2 = trc.random_rows(n, 2 * d, dev)
    ops = fk.fact_wide_operands(fkb)
    runs = {"K11": lambda: fk.fact_estimate_wide(x2, fkb, ops),
            "K12 T=4": lambda: fk.fact_estimate_coherent_wide(
                x2, fkb4, 4, 1.0, ops)}
    plain_ms = {name: profiling.device_ms(run) for name, run in runs.items()}
    saved = kernels._libs.get("fact_wide_estimate")
    lib = build_marked()
    kernels._libs["fact_wide_estimate"] = lib
    try:
        for name, run in runs.items():
            got = split(run, lib)
            got["unmarked_ms"] = plain_ms[name]
            got["bound_ms"] = fk.fact_bound(
                n, d, k, m, 4 if "T=4" in name else 1)["bound_ms"]
            rec["forms"][name] = got
            print(f"== {name}: D={d}, K={k}, M={m}, N={n}: marked "
                  f"{got['marked_ms']:.3f} ms, unmarked {plain_ms[name]:.3f}"
                  f" ms, bound {got['bound_ms']:.3f} ms", flush=True)
            for pass_name, v in got["passes_ms"].items():
                print(f"  {pass_name:22s} {v:8.3f} ms "
                      f"{v / got['marked_ms']:6.1%}", flush=True)
    finally:
        if saved is None:
            kernels._libs.pop("fact_wide_estimate", None)
        else:
            kernels._libs["fact_wide_estimate"] = saved
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
