"""The circulant (FFT-domain) kernels against the `torch.fft` structured
pipeline: flat, coherent, the tensor-parallel stats route and the wide
form at D = 512.

Port of the JAX repository's `tools/circ_kernel_bench.py`, its four legs
at that tool's sizes, on a synthetic circulant bank made from a seed (the
JAX tool's `synthetic_bank`: Dirichlet weights, zero means, spectra
uniform in [0.5, 2], filters of scale 0.1, zero bias) and standard normal
complex observations:

  flat      D = K = 64, 131072 rows: K6 (`circ_kernels.
            estimate_fused_circulant`) against `structured_bank.
            estimate_circulant(..., method='fft')`;
  coherent  D = K = 64, 32768 blocks of T = 4 at alpha 1.0 and 0.25: K7
            against `estimate_circulant_coherent(..., method='fft')`;
  tp        D = K = 64, 131072 rows over a 1 x 1 in-process mesh
            (`parallel.mesh.estimate_sharded_circulant`): K8 and the merge,
            against the same route through the pipeline's stats form;
  d512      D = 512, K = 16, 32768 rows: K6 past the template, on the
            factorised kernel (`csrc/circ_fact_estimate.cu`; 512 = 16 x
            32), against the pipeline.

Each route is timed with CUDA events (`utils.profiling.device_ms`: one
warm-up call, the median of 5), the bank's kernel layouts made once
before the clock starts (a cache beside the bank, as the service keeps
one). It prints a line a route and, at the end, one JSON object, which
`main` returns: per leg and route the ms a call, estimates per second, the
launches of one call by kernel, the kernel's largest difference from the
pipeline as a fraction of the pipeline's scale, and for a kernel route its
bound (`circ_kernels.circ_bound`: the function's least time on an H100,
its transforms counted as FFTs; and `bound_dft_ms`, the same with the
kernels' dense transforms) and the share of each reached; with the card's
name.

    python -m quantized_channel_estimation_torch.tools.circ_kernel_bench \
        [flat|coherent|tp|d512 ...] [--rows-scale 1.0] [--device cpu]

On the card by default; `--device cpu` runs the plain versions on the CPU
(with a small `--rows-scale`), and then the times are host times of the
plain versions, not of any kernel.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from quantized_channel_estimation_torch.estimators import circ_kernels, kernels
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBank)
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.parallel import mesh as pmesh
from quantized_channel_estimation_torch.utils import profiling

D, K = 64, 64
LEGS = ("flat", "coherent", "tp", "d512")


def synthetic_bank(d=D, k=K, seed=0, device=None) -> CirculantBank:
    """The JAX tool's synthetic bank, from the same numpy draws."""
    rng = np.random.default_rng(seed)
    lw = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    spec = rng.uniform(0.5, 2.0, (k, d)).astype(np.float32)
    filt = ((rng.standard_normal((k, d)) + 1j * rng.standard_normal((k, d)))
            * 0.1).astype(np.complex64)
    zeros = np.zeros((k, d), np.complex64)
    return CirculantBank(*(torch.as_tensor(x, device=device)
                           for x in (lw, zeros, spec, filt, zeros)))


def complex_randn(shape, seed=0, device=None) -> torch.Tensor:
    """Standard normal complex observations from numpy's draws (the JAX
    tool's `packed_randn`)."""
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return torch.complex(torch.as_tensor(re), torch.as_tensor(im)).to(device)


def _time(fn, dev) -> float:
    """ms of one call: CUDA events on a card, else the host clock."""
    if dev.type == "cuda":
        return profiling.device_ms(fn)
    fn()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _route(label, fn, n_est, dev, want=None, bound=None) -> dict:
    """Time fn, count one call's launches and compare it with `want` (the
    pipeline's answer); print one line."""
    kernels.reset_launch_counts()
    got = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    ms = _time(fn, dev)
    rec = {"ms": ms, "estimates_per_s": n_est / (ms * 1e-3),
           "launches": launches}
    if want is not None:
        rec["rel_to_fft"] = float((got - want).abs().max()
                                  / want.abs().max())
    if bound is not None:
        for key in ("bound_ms", "bound_by", "bound_dft_ms"):
            rec[key] = bound[key]
        rec["share_of_bound"] = bound["bound_ms"] / ms
        rec["share_of_bound_dft"] = bound["bound_dft_ms"] / ms
    print(f"  {label:40s} {ms:9.3f} ms  {rec['estimates_per_s'] / 1e6:8.3f} "
          f"M est/s" + (f"  vs fft {rec['rel_to_fft']:.2e}"
                        if want is not None else "")
          + (f"  bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
             f"{rec['share_of_bound']:.1%}), dense-DFT bound "
             f"{bound['bound_dft_ms']:.3f} ms "
             f"({rec['share_of_bound_dft']:.1%})" if bound is not None
             else "")
          + (f"  launches {launches}" if launches else ""), flush=True)
    return rec


def leg_flat(dev, scale=1.0, d=D, k=K, n=131072) -> dict:
    n = max(1, int(n * scale))
    bank, r = synthetic_bank(d, k, device=dev), complex_randn((n, d),
                                                              device=dev)
    cache = {}
    kern = lambda: circ_kernels.estimate_fused_circulant(  # noqa: E731
        bank, r, cache=cache)
    fft = lambda: sb.estimate_circulant(bank, r, "all", 16384,  # noqa: E731
                                        None, "fft")
    want = fft()
    return {"fused circ kernel": _route("fused circ kernel", kern, n, dev,
                                        want,
                                        circ_kernels.circ_bound(n, d, k)),
            "torch.fft structured": _route("torch.fft structured", fft, n,
                                           dev)}


def leg_coherent(dev, scale=1.0, t=4, blocks=32768) -> dict:
    b = max(1, int(blocks * scale))
    bank = synthetic_bank(device=dev)
    r = complex_randn((b, t, D), device=dev)
    out, cache = {}, {}
    for alpha in (1.0, 0.25):
        want = sb.estimate_circulant_coherent(bank, r, "all", 4096, alpha,
                                              None, "fft")
        out[f"fused coherent kernel alpha={alpha}"] = _route(
            f"fused coherent kernel alpha={alpha}",
            lambda a=alpha: circ_kernels.estimate_fused_circulant_coherent(
                bank, r, a, cache=cache), b * t, dev, want,
            circ_kernels.circ_bound(b * t, D, K, t))
        out[f"torch.fft coherent alpha={alpha}"] = _route(
            f"torch.fft coherent alpha={alpha}",
            lambda a=alpha: sb.estimate_circulant_coherent(
                bank, r, "all", 4096, a, None, "fft"), b * t, dev)
    return out


def leg_tp(dev, scale=1.0, n=131072) -> dict:
    n = max(1, int(n * scale))
    bank, r = synthetic_bank(device=dev), complex_randn((n, D), device=dev)
    mesh = pmesh.make_local_mesh(1, 1, dev)
    caches = ({},)
    want = pmesh.estimate_sharded_circulant(mesh, bank, r, use_kernel=False)
    return {"TP kernel-stats + merge": _route(
                "TP kernel-stats + merge",
                lambda: pmesh.estimate_sharded_circulant(
                    mesh, bank, r, use_kernel=True, caches=caches), n, dev,
                want, circ_kernels.circ_bound(n, D, K, stats=True)),
            "TP torch.fft stats + merge": _route(
                "TP torch.fft stats + merge",
                lambda: pmesh.estimate_sharded_circulant(
                    mesh, bank, r, use_kernel=False), n, dev)}


def leg_d512(dev, scale=1.0) -> dict:
    """D = 512, K = 16: K6 on the factorised kernel."""
    return leg_flat(dev, scale, 512, 16, 32768)


def dft_construction_error(d: int, k: int = 16, n: int = 4096,
                           device=None) -> dict:
    """How far the kernels' layout of the synthetic bank at D bins lies
    from the function, by the construction of its DFT matrix: the plain
    version evaluated in float64 on the float32 layout (the layout's own
    rounding and nothing else) against the `torch.fft` pipeline in
    float64, on n standard normal rows, as fractions of the estimate's
    scale. "complex64": the transform built in complex64 (the JAX
    package's `unitary_dft`; `circ_kernel_bank`'s up to D = 128);
    "complex128_rounded": built in complex128 and rounded to float32 once
    (`circ_kernel_bank`'s past D = 128)."""
    dev = torch.device(device) if device is not None else None
    bank = synthetic_bank(d, k, device=dev)
    r = complex_randn((n, d), device=dev)
    c128 = CirculantBank(*(x.to(torch.complex128) if x.is_complex()
                           else x.double() for x in bank))
    exact = torch.view_as_real(sb.estimate_circulant(
        c128, r.to(torch.complex128), "all", n, None, "fft")).reshape(n, -1)
    ckb = circ_kernels.circ_kernel_bank(bank)
    x2 = circ_kernels._x2(r).double()
    out = {}
    for label, dtype in (("complex64", torch.complex64),
                         ("complex128_rounded", torch.complex128)):
        f = sb._dft_matrix(d, None, dtype, dev)
        lay = ckb._replace(
            bfwd=mk._cplx_interleaved(f.T).to(torch.float32),
            binv=mk._cplx_interleaved(f.conj()).to(torch.float32))
        got = circ_kernels.circ_estimate_reference(
            x2, circ_kernels.CircKernelBank(*(x.double() for x in lay)))
        out[label] = float((got - exact).abs().max() / exact.abs().max())
    return out


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("legs", nargs="*", help=f"any of {', '.join(LEGS)} "
                   "(default: all four)")
    p.add_argument("--rows-scale", type=float, default=1.0,
                   help="scale the legs' row counts (small on the CPU)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = stages.resolve_device(args.device if device is None else device)
    pin_fp32()
    legs = args.legs or LEGS
    if set(legs) - set(LEGS):
        p.error(f"legs are {', '.join(LEGS)}; got {args.legs}")
    rec = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu (plain versions; host clock)"),
           "legs": {}}
    for leg in legs:
        print(f"== {leg} ==", flush=True)
        rec["legs"][leg] = {"flat": leg_flat, "coherent": leg_coherent,
                            "tp": leg_tp, "d512": leg_d512}[leg](
            dev, args.rows_scale)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
