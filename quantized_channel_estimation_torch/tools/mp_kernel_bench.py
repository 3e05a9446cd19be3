"""The multi-pilot structured path: K10 (flat and coherent) against the
per-bin P x P `torch.fft` pipeline and the dense bank on the same
observations.

Port of the JAX repository's `tools/mp_kernel_bench.py` at that tool's
sizes (D = K = 64, P = 2 pilots, T = 4, 65536 rows, 2 bits, 10 dB): a
circulant prior made from a seed (spectra uniform in [0.05, 2] scaled to
sum D, uniform weights, zero means, the dense covariances F^H diag(s) F),
its multi-pilot bank under the P-pilot `angle_amp` matrix A = kron(x, I),
and quantized observations of standard normal channels. Where the JAX tool
reads `MP_D`, `MP_K`, `MP_P`, `MP_T` and `MP_BATCH` from the environment,
this one takes options. Two legs:

  flat      the kernel route (`stages.estimate_circulant`, 'auto': K10, or
            its wide form past the template's rule) against the dense
            bank's estimate (`gmm_estimator.estimate`, 'all'), and the
            estimates per second of the kernel route, the `torch.fft`
            pipeline (`structured_bank.estimate_circulant`, method 'fft')
            and the dense estimator;
  coherent  blocks of T rows at alpha 1.0 and 0.25: the coherent kernel
            route (`stages.estimate_circulant_coherent`) against the
            `torch.fft` coherent pipeline, and both routes' rates at alpha
            1.0.

Each route is timed with CUDA events (`utils.profiling.device_ms`: one
warm-up call, the median of 5), the bank's kernel layouts made once
before the clock starts (a cache beside the bank, as the service keeps
one). The JAX tool's relative error is its own: sum |a - b|^2 / sum
|b|^2; the largest difference as a fraction of the reference's scale is
printed beside it. A kernel route carries its bound
(`mp_circ_kernels.mp_circ_bound`: the function's least time on an H100,
its transforms counted as FFTs; and `bound_dft_ms`, with the kernels'
dense transforms) and the share of each reached. It prints a line a route
and, at the end, one JSON object, which `main` returns, with the card's
name.

    python -m quantized_channel_estimation_torch.tools.mp_kernel_bench \
        [flat|coherent ...] [--d 64] [--k 64] [--p 2] [--t 4] \
        [--batch 65536] [--device cpu]

On the card by default; `--device cpu` runs the plain versions on the CPU
(at small sizes), and then the times are host times of the plain
versions, not of any kernel.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm, gmm_estimator
from quantized_channel_estimation_torch.models import structured_bank as sb
from quantized_channel_estimation_torch.ops import linalg, observation, pilots
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.tools import common

D, K, P, T, BATCH = 64, 64, 2, 4, 65536
N_BITS, SNR = 2, 10.0
MODES = ("flat", "coherent")


def make_prior(d=D, k=K, seed=0, device=None):
    """The JAX tool's prior: spectra uniform in [0.05, 2] scaled to sum D,
    the covariances F^H diag(s) F (+ 1e-6 I), uniform weights, zero means.
    Returns (params, spectra)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.05, 2.0, (k, d)).astype(np.float32)
    s = torch.as_tensor(s * (d / s.sum(-1, keepdims=True)), device=device)
    f = linalg.unitary_dft(d, device=device)
    covs = torch.einsum("fd,kf,fe->kde", f.conj(), s.to(torch.complex64), f)
    covs = linalg.hermitize(covs) + 1e-6 * torch.eye(
        d, dtype=torch.complex64, device=device)
    params = gmm.GmmParams(
        torch.full((k,), 1.0 / k, device=device),
        torch.zeros((k, d), dtype=torch.complex64, device=device), covs,
        linalg.robust_precision_cholesky(covs))
    return params, s


def _rel(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The JAX tool's relative error sum |a - b|^2 / sum |b|^2, and the
    largest |a - b| as a fraction of max |b|."""
    diff = (a - b).abs()
    return {"rel_sq": float((diff ** 2).sum() / (b.abs() ** 2).sum()),
            "max_rel": float(diff.max() / b.abs().max())}


def _route(label, fn, n_est, dev, bound=None) -> dict:
    """Count one call's launches, then time fn; print one line."""
    kernels.reset_launch_counts()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    ms = common.time_ms(fn, dev, 5)
    rec = {"ms": ms, "estimates_per_s": n_est / (ms * 1e-3),
           "launches": launches}
    if bound is not None:
        for key in ("bound_ms", "bound_by", "bound_dft_ms"):
            rec[key] = bound[key]
        rec["share_of_bound"] = bound["bound_ms"] / ms
        rec["share_of_bound_dft"] = bound["bound_dft_ms"] / ms
    print(f"  {label:28s} {ms:9.3f} ms  {rec['estimates_per_s'] / 1e6:8.3f} "
          f"M est/s"
          + (f"  bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
             f"{rec['share_of_bound']:.1%}), dense-DFT bound "
             f"{bound['bound_dft_ms']:.3f} ms "
             f"({rec['share_of_bound_dft']:.1%})" if bound is not None
             else "")
          + (f"  launches {launches}" if launches else ""), flush=True)
    return rec


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("modes", nargs="*", help="flat and / or coherent "
                   "(default: both)")
    p.add_argument("--d", type=int, default=D, help="bins (JAX: MP_D)")
    p.add_argument("--k", type=int, default=K, help="components (MP_K)")
    p.add_argument("--p", type=int, default=P, help="pilots (MP_P)")
    p.add_argument("--t", type=int, default=T,
                   help="rows of a coherence block (MP_T)")
    p.add_argument("--batch", type=int, default=BATCH,
                   help="observations (MP_BATCH)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    modes = args.modes or MODES
    if set(modes) - set(MODES):
        p.error(f"modes are {', '.join(MODES)}; got {args.modes}")
    dev = common.device(args.device if device is None else device)
    d, k, n_p, t, n = args.d, args.k, args.p, args.t, args.batch
    params, spectra = make_prior(d, k, device=dev)
    a = pilots.pilot_matrix(d, n_p, N_BITS, device=dev)
    q = Q.design_quantizer(SNR, N_BITS, device=dev)
    bank = sb.prepare_bank_circulant(params, SNR, a, N_BITS, q,
                                     spectra=spectra)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = observation.observe(gen, crandn(gen, (n, d)), SNR, a, N_BITS, q)
    rec = {"device": common.device_label(dev), "d": d, "k": k, "p": n_p,
           "t": t, "batch": n, "kernel_eligible": {
               "flat": mk.mp_circ_kernel_eligible(d, k, n_p),
               "coherent": mk.mp_circ_kernel_eligible(d, k, n_p, t)},
           "wide_form": {"flat": not mk.mp_circ_narrow(d, k, n_p),
                         "coherent": not mk.mp_circ_narrow(d, k, n_p, t)},
           "legs": {}}
    cache = {}
    if "flat" in modes:
        print("== flat ==", flush=True)
        dense = gmm_estimator.prepare_bank(params, SNR, a, N_BITS, q)
        kern = lambda: stages.estimate_circulant(  # noqa: E731
            bank, r, cache=cache)
        fft = lambda: sb.estimate_circulant(bank, r, "all", 4096,  # noqa
                                            None, "fft")
        dd = lambda: gmm_estimator.estimate(dense, r, "all",  # noqa: E731
                                            4096)
        leg = {"kernel_vs_dense": _rel(kern(), dd())}
        print(f"  flat cross kernel-vs-dense: "
              f"{leg['kernel_vs_dense']['rel_sq']:.2e} (max "
              f"{leg['kernel_vs_dense']['max_rel']:.2e} of scale)",
              flush=True)
        leg["mp kernel"] = _route("MP kernel", kern, n, dev,
                                  mk.mp_circ_bound(n, d, k, n_p))
        leg["torch.fft pipeline"] = _route("MP torch.fft pipeline", fft, n,
                                           dev)
        leg["dense einsum"] = _route("dense einsum", dd, n, dev)
        rec["legs"]["flat"] = leg
        del dense
    if "coherent" in modes:
        print("== coherent ==", flush=True)
        rb = r[:n // t * t].reshape(n // t, t, -1)
        leg = {}
        for alpha in (1.0, 0.25):
            got = stages.estimate_circulant_coherent(bank, rb, alpha=alpha,
                                                     cache=cache)
            want = sb.estimate_circulant_coherent(bank, rb, "all", 512,
                                                  alpha, None, "fft")
            leg[f"kernel_vs_fft alpha={alpha}"] = _rel(got, want)
            print(f"  coh alpha={alpha} cross kernel-vs-fft: "
                  f"{leg[f'kernel_vs_fft alpha={alpha}']['rel_sq']:.2e} (max "
                  f"{leg[f'kernel_vs_fft alpha={alpha}']['max_rel']:.2e} of "
                  "scale)", flush=True)
        leg["mp coh kernel"] = _route(
            "MP coh kernel", lambda: stages.estimate_circulant_coherent(
                bank, rb, cache=cache), rb.shape[0] * t, dev,
            mk.mp_circ_bound(rb.shape[0] * t, d, k, n_p, t))
        leg["mp coh torch.fft"] = _route(
            "MP coh torch.fft", lambda: sb.estimate_circulant_coherent(
                bank, rb, "all", 512, 1.0, None, "fft"), rb.shape[0] * t,
            dev)
        rec["legs"]["coherent"] = leg
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
