"""Factored (low-rank plus diagonal) MFA banks against the dense estimator.

Port of the JAX repository's `tools/mfa_bank_bench.py`: an MFA fitted to
SCM channels (`stages.mfa_fit`, zero means, two paths) at D dims, K
components and rank M; its factored (Woodbury) bank at 10 dB / 2 bits under
the one-pilot matrix (`stages.prepare_bank_factored`) and the dense bank
of the densified fit (`stages.mfa_to_gmm` + `stages.prepare_bank`); the
NMSE of each route on the validation observations, the prepare times (host
clock, synchronized) and bank bytes; then each route timed on one batch of quantized observations of standard
normal channels. Four legs, the JAX tool's sizes:

  d64    D = 64, K = 64, M = 16, 100k / 10k rows, 131072 a batch: the
         factored kernels' template;
  d512   D = 512, K = 16, M = 32, 60k / 2k rows, 32768 a batch: the wide
         form (`csrc/fact_wide_estimate.cu`);
  d2048  D = 2048, K = 8, M = 32, 40k / 2k rows, 8192 a batch, 40
         iterations;
  d4096  D = 4096, K = 4, M = 32, 40k / 2k rows, 4096 a batch, 30
         iterations; the frontier: the dense bank is attempted and its
         failure, if any, reported beside the factored routes. In every
         other leg a failure of the dense bank fails the run.

Two legs more time the kernels alone on seeded banks, on the card:

  fused        D = 256, K = 32, M = 16 (the JAX docstring's, run_mfa's
               wide shape), 32768 rows of quantized observations of
               channels drawn from a seeded MFA prior: K11 and K12 (T = 4,
               alpha 1) on the fused kernel's wrappers
               (`fact_estimate[_coherent]_fused`, where the package has
               them), through the entries
               (`fact_kernels.estimate_fused_factored[_coherent]` with a
               cache, which keep the wide form there), on the
               wide form (`fact_estimate[_coherent]_wide`) and on the
               `torch.matmul` pipeline over the batch as one chunk, the
               same rows in turns (each in order, then back); with
               `--root` another checkout's package (the parent: no fused
               kernel), for parent / change / change / parent runs in one
               call;
  fused_reach  the fused K11 / K12 against the wide form in turns (fused,
               wide, wide, fused) at each of `FUSED_REACH_SHAPES` (D, K,
               M, T), 32768 rows, on random banks
               (`tools.tc_repeat_check.random_fact_bank`): the
               measurements that keep the entries on the wide form
               (`fact_kernels.fact_fused_fits`).

The routes: the kernel route (`stages.estimate_factored`, 'auto': K11, or
its wide form past the template's rule; the bank's kernel layouts made
once in a cache before the clock starts, as the service keeps them), the
`torch.matmul` pipeline (`mfa_bank.estimate_factored`, 4096-row chunks),
the dense einsum estimator (`gmm_estimator.estimate`) and, at d64, the
dense kernel (`stages.estimate_auto`). Where the JAX tool runs its kernel
route only where the bank's bytes fit its 13 MiB budget, this one runs it
where `fact_kernels.fact_kernel_eligible` admits the bank. Each route is
timed with CUDA events (`utils.profiling.device_ms`: one warm-up call, the
median of 5); the kernel route carries its bound (`fact_kernels.fact_bound`)
and the share of it reached, and every route its launches. It prints a
line a route and, at the end, one JSON object, which `main` returns, with
the card's name.

    python -m quantized_channel_estimation_torch.tools.mfa_bank_bench \
        [d64|d512|d2048|d4096|fused|fused_reach ...] [--d D --k K --m M] \
        [--n-train N] [--n-val N] [--batch N] [--max-iter N] \
        [--device cpu] [--root DIR]

Default legs: d64 d512 (the JAX tool's). `--d`, `--k`, `--m` and the row
options replace every chosen fitted leg's own. On the card by default; `--device
cpu` runs the plain versions at small sizes, and then the times are host
times of the plain versions, not of any kernel.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time

import torch

from quantized_channel_estimation_torch.estimators import fact_kernels as fk
from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import (
    gmm_estimator, mfa, mfa_bank)
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm
from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.tools import common

SNR, N_BITS, N_PATH = 10.0, 2, 2
# leg: (D, K, M, n_train, n_val, batch, max_iter, dense kernel, frontier)
LEGS = {"d64": (64, 64, 16, 100_000, 10_000, 131_072, 60, True, False),
        "d512": (512, 16, 32, 60_000, 2_000, 32_768, 60, False, False),
        "d2048": (2048, 8, 32, 40_000, 2_000, 8_192, 40, False, False),
        "d4096": (4096, 4, 32, 40_000, 2_000, 4_096, 30, False, True)}
DEFAULT_LEGS = ("d64", "d512")
KERNEL_LEGS = ("fused", "fused_reach")
FUSED_DKM, FUSED_N = (256, 32, 16), 32768
# (D, K, M, T) of the `fused_reach` leg: the served shape and its pool; K
# from 1 to 128; M = 1, 4, 8; D one past the template's, 144, 192, 200
# (halves of 4 / 3 chunks), 255; one component at T = 3 to 64
FUSED_REACH_SHAPES = (
    (256, 32, 16, 1), (256, 32, 16, 4), (256, 32, 16, 16), (256, 32, 16, 64),
    (256, 1, 16, 1), (256, 4, 16, 1), (256, 39, 16, 1), (256, 128, 16, 1),
    (256, 32, 8, 1), (256, 32, 4, 1), (256, 32, 1, 1), (129, 32, 16, 1),
    (129, 1, 1, 1), (144, 8, 8, 1), (144, 8, 8, 4), (192, 32, 16, 1),
    (200, 16, 3, 3), (255, 32, 16, 1), (160, 64, 16, 1), (256, 1, 16, 4),
    (256, 1, 16, 64), (256, 2, 16, 1), (200, 1, 3, 3), (144, 1, 8, 16))
PKG = "quantized_channel_estimation_torch"


def _bytes(bank) -> int:
    return sum(x.numel() * x.element_size() for x in bank)


def _rel(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Estimate against estimate: the largest |a - b| as a fraction of
    max |b|."""
    return {"max_rel": float((a - b).abs().max() / b.abs().max())}


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
        rec.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   share_of_bound=bound["bound_ms"] / ms)
    print(f"  {label:26s} {ms:9.3f} ms  {rec['estimates_per_s'] / 1e6:8.3f} "
          f"M est/s"
          + (f"  bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
             f"{rec['share_of_bound']:.1%})" if bound is not None else "")
          + (f"  launches {launches}" if launches else ""), flush=True)
    return rec


def run_leg(label, d, k, m, n_train, n_val, batch, max_iter, dense_kernel,
            frontier, dev) -> dict:
    """One leg as the module docstring says; returns its record. Only a
    frontier leg reports a failure of the dense bank (`dense_error`) and
    goes on with the factored routes; any other leg raises it."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    print(f"== {label}: D={d}, K={k}, M={m} MFA fit ==", flush=True)
    rec = {"d": d, "k": k, "m": m, "n_train": n_train, "n_val": n_val,
           "batch": batch, "max_iter": max_iter,
           "kernel_eligible": fk.fact_kernel_eligible(d, k, m),
           "wide_form": not fk.fact_narrow(d, k, m)}
    # the generator's chunk shrinks with D, as the JAX tool's does
    h, _ = stages.generate_channels(gen(0), n_train + n_val,
                                    scm.ScmConfig(d, N_PATH),
                                    max(128, (4096 * 256) // d))
    h_train, h_val = h[:n_train], h[n_train:]
    cfg = mfa.MfaConfig(n_components=k, latent_dim=m, zero_mean=True,
                        max_iter=max_iter, chunk_size=4096)
    sync()
    t0 = time.time()
    fit = stages.mfa_fit(gen(1), h_train, cfg)
    sync()
    rec.update(fit_s=time.time() - t0, n_iter=int(fit.n_iter),
               log_likelihood=float(fit.log_likelihood))
    print(f"  mfa fit {rec['fit_s']:.1f}s ({rec['n_iter']} iterations, ll "
          f"{rec['log_likelihood']:.1f})", flush=True)
    a = stages.pilot_matrix(d, 1, N_BITS, device=dev)
    q = Q.design_quantizer(SNR, N_BITS, device=dev)
    r = stages.observe(gen(2), h_val, SNR, a, N_BITS, q)

    t0 = time.time()
    bank_f = stages.prepare_bank_factored(fit.params, SNR, a, N_BITS, q)
    sync()
    rec["prepare_factored_s"] = time.time() - t0
    rec["bank_bytes_factored"] = _bytes(bank_f)
    cache = {}
    mse = {"factored pipeline": stages.nmse(mfa_bank.estimate_factored(
        bank_f, r, "all", 4096), h_val)}
    if rec["kernel_eligible"]:
        mse["factored kernel"] = stages.nmse(stages.estimate_factored(
            bank_f, r, cache=cache), h_val)
    bank_d = None
    try:
        t0 = time.time()
        gp = stages.mfa_to_gmm(fit.params, 1e-6)
        bank_d = stages.prepare_bank(gp, SNR, a, N_BITS, q)
        sync()
        rec["prepare_dense_s"] = time.time() - t0
        rec["bank_bytes_dense"] = _bytes(bank_d)
        mse["dense"] = stages.nmse(gmm_estimator.estimate(
            bank_d, r, "all", min(2048, 16384 * 64 // d)), h_val)
        del gp
    except RuntimeError as err:   # the frontier's dense wall, as JAX reports
        if not frontier:
            raise
        rec["dense_error"] = f"{type(err).__name__}: {str(err)[:300]}"
        print(f"  dense leg failed: {rec['dense_error']}", flush=True)
        bank_d = None
    rec["nmse"] = mse
    ref = mse.get("dense", mse["factored pipeline"])
    rec["nmse_rel_delta"] = {key: abs(v - ref) / ref
                             for key, v in mse.items()}
    print("  NMSE " + ", ".join(f"{key} {v:.5f}" for key, v in mse.items())
          + "; prepare factored "
          f"{rec['prepare_factored_s']:.2f}s"
          + (f", dense {rec['prepare_dense_s']:.2f}s" if bank_d is not None
             else ""), flush=True)

    g3 = gen(3)
    rb = stages.observe(g3, crandn(g3, (batch, d)), SNR, None, N_BITS, q)
    routes = {"factored pipeline": (
        lambda: mfa_bank.estimate_factored(bank_f, rb, "all", 4096), None)}
    if rec["kernel_eligible"]:
        routes["factored kernel"] = (
            lambda: stages.estimate_factored(bank_f, rb, cache=cache),
            fk.fact_bound(batch, d, k, m))
        rec["kernel_vs_pipeline"] = _rel(routes["factored kernel"][0](),
                                         routes["factored pipeline"][0]())
    if bank_d is not None:
        routes["dense einsum"] = (lambda: gmm_estimator.estimate(
            bank_d, rb, "all", min(2048, 16384 * 64 // d)), None)
        if dense_kernel:
            routes["dense kernel"] = (
                lambda: stages.estimate_auto(bank_d, rb, "all"), None)
    rec["routes"] = {name: _route(name, fn, batch, dev, bound)
                     for name, (fn, bound) in routes.items()}
    return rec


def _package(root):
    """The package's modules the kernel legs use, imported from `root` (a
    checkout) when given, else this one."""
    if root:
        for name in [n for n in sys.modules
                     if n == PKG or n.startswith(PKG + ".")]:
            del sys.modules[name]
        sys.path.insert(0, root)
    mods = ("estimators.fact_kernels", "estimators.kernels",
            "models.mfa", "models.mfa_bank", "ops.observation",
            "ops.quantizer", "ops.cplx", "tools.tc_repeat_check",
            "utils.profiling")
    return {m.split(".")[-1]: importlib.import_module(f"{PKG}.{m}")
            for m in mods}


def _prior_bank(pk, dev, d, k, m, n, n_dead=2, seed=0):
    """A seeded MFA prior's factored bank at 10 dB, 2 bits under x0 = 1
    (loadings of total power 0.8 a dimension, psi on [0.05, 0.35], zero
    means, n_dead dead components) and n quantized observations of
    channels drawn from the mixture."""
    g = torch.Generator().manual_seed(seed)
    cr = (lambda *shape: torch.complex(torch.randn(*shape, generator=g),
                                       torch.randn(*shape, generator=g))
          / 2 ** 0.5)
    w = 0.5 + torch.rand(k, generator=g)
    w[:n_dead] = 1e-9
    p = pk["mfa"].MfaParams(
        (w / w.sum()).to(dev), torch.zeros(k, d, dtype=torch.complex64,
                                           device=dev),
        ((0.8 / m) ** 0.5 * cr(k, d, m)).to(dev),
        (0.05 + 0.3 * torch.rand(k, d, generator=g)).to(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    c = torch.randint(0, k, (n,), generator=gen, device=dev)
    crandn = pk["cplx"].crandn
    h = ((p.lambdas[c] @ crandn(gen, (n, m, 1)))[..., 0]
         + p.psis[c].sqrt() * crandn(gen, (n, d)))
    q = pk["quantizer"].design_quantizer(SNR, N_BITS, device=dev)
    bank = pk["mfa_bank"].prepare_bank_factored(
        p, SNR, torch.tensor(1.0 + 0.0j), N_BITS, q)
    return bank, pk["observation"].observe(gen, h, SNR, None, N_BITS, q)


def _turns(pk, runs, order) -> list:
    """CUDA-event times (`profiling.device_ms`) of runs[i] for i in order."""
    return [pk["profiling"].device_ms(runs[i]) for i in order]


def fused_leg(pk, dev) -> dict:
    """Leg `fused` (see the module docstring): {"K11", "K12 T=4"}: the
    fused kernel's (where the package has it), the entry's, the wide
    form's and the pipeline's times in turns, the entry's launches, its
    distance from the pipeline, the bound."""
    fk, mb = pk["fact_kernels"], pk["mfa_bank"]
    (d, k, m), n = FUSED_DKM, FUSED_N
    print(f"== fused: D={d}, K={k}, M={m}, {n} rows ==", flush=True)
    bank, r = _prior_bank(pk, dev, d, k, m, n)
    rb = r.reshape(-1, 4, d)
    x2 = torch.view_as_real(r).reshape(n, 2 * d).contiguous()
    fkb, fkb4 = fk.fact_kernel_bank(bank), fk.fact_kernel_bank(bank, 4, 1.0)
    wops = fk.fact_wide_operands(fkb)
    fused = hasattr(fk, "fact_estimate_fused")
    fops = fk.fact_fused_operands(fkb) if fused else None
    cache = {}
    forms = {
        "K11": (lambda: fk.fact_estimate_fused(x2, fkb, fops),
                lambda: fk.estimate_fused_factored(bank, r, cache),
                lambda: fk.fact_estimate_wide(x2, fkb, wops),
                lambda: mb.estimate_factored(bank, r, "all", n), 1),
        "K12 T=4": (lambda: fk.fact_estimate_coherent_fused(
                        x2, fkb4, 4, 1.0, fops),
                    lambda: fk.estimate_fused_factored_coherent(
                        bank, rb, 1.0, cache),
                    lambda: fk.fact_estimate_coherent_wide(x2, fkb4, 4, 1.0,
                                                           wops),
                    lambda: mb.estimate_factored_coherent(bank, rb, "all",
                                                          n // 4, 1.0), 4)}
    out = {}
    for name, (kern, entry, wide, pipe, t) in forms.items():
        before = pk["kernels"].launch_counts()
        got = entry()
        torch.cuda.synchronize()
        launches = {a: b - before[a] for a, b in
                    pk["kernels"].launch_counts().items() if b != before[a]}
        want = pipe()
        runs = ((kern,) if fused else ()) + (entry, wide, pipe)
        order = tuple(range(len(runs)))
        ms = _turns(pk, runs, order + order[::-1])
        pair = {key: [ms[i], ms[-1 - i]] for i, key in enumerate(
            (("fused_ms",) if fused else ()) + ("entry_ms", "wide_ms",
                                                "pipeline_ms"))}
        b = fk.fact_bound(n, d, k, m, t)
        rec = {**pair, "entry_launches": launches,
               "entry_rel_to_pipeline": float(
                   (got.reshape(want.shape) - want).abs().max()
                   / want.abs().max()),
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        out[name] = rec
        print(f"  {name}: " + ("fused {:.3f} / {:.3f} ms, ".format(
            *pair["fused_ms"]) if fused else "") +
            f"entry {pair['entry_ms'][0]:.3f} / {pair['entry_ms'][1]:.3f} "
            f"ms {launches}, wide form {pair['wide_ms'][0]:.3f} / "
            f"{pair['wide_ms'][1]:.3f} ms, one-chunk pipeline "
            f"{pair['pipeline_ms'][0]:.3f} / {pair['pipeline_ms'][1]:.3f} "
            f"ms, bound {b['bound_ms']:.3f} ms, entry vs pipeline "
            f"{rec['entry_rel_to_pipeline']:.2e}", flush=True)
    return out


def fused_reach_leg(pk, dev) -> dict:
    """Leg `fused_reach` (see the module docstring): {label: the fused and
    wide times in turns, the speed-up}."""
    fk, trc = pk["fact_kernels"], pk["tc_repeat_check"]
    n = FUSED_N
    print(f"== fused_reach: the fused K11 / K12 against the wide form, {n} "
          f"rows ==", flush=True)
    out = {}
    for d, k, m, t in FUSED_REACH_SHAPES:
        fkb = trc.random_fact_bank(d, m, k, dev, n_dead=1, t_coh=t)
        fops, wops = fk.fact_fused_operands(fkb), fk.fact_wide_operands(fkb)
        x2 = trc.random_rows(n // t * t, 2 * d, dev)
        if t == 1:
            runs = (lambda: fk.fact_estimate_fused(x2, fkb, fops),
                    lambda: fk.fact_estimate_wide(x2, fkb, wops))
        else:
            runs = (lambda: fk.fact_estimate_coherent_fused(x2, fkb, t, 1.0,
                                                            fops),
                    lambda: fk.fact_estimate_coherent_wide(x2, fkb, t, 1.0,
                                                           wops))
        ms = _turns(pk, runs, (0, 1, 1, 0))
        rec = {"fused_ms": [ms[0], ms[3]], "wide_ms": [ms[1], ms[2]],
               "speedup": (ms[1] + ms[2]) / (ms[0] + ms[3])}
        label = f"D={d} K={k} M={m} T={t}"
        out[label] = rec
        print(f"  {label:24s} fused {ms[0]:.3f} / "
              f"{ms[3]:.3f} ms, wide {ms[1]:.3f} / {ms[2]:.3f} ms, "
              f"{rec['speedup']:.2f}x", flush=True)
        del fkb, fops, wops, x2
    return out


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("legs", nargs="*", help="d64, d512, d2048, d4096, fused "
                   "and / or fused_reach (default: d64 d512)")
    p.add_argument("--d", type=int, help="dims of every chosen leg")
    p.add_argument("--k", type=int, help="components of every chosen leg")
    p.add_argument("--m", type=int, help="latent rank of every chosen leg")
    p.add_argument("--n-train", type=int)
    p.add_argument("--n-val", type=int)
    p.add_argument("--batch", type=int)
    p.add_argument("--max-iter", type=int)
    p.add_argument("--device", default=None)
    p.add_argument("--root", default=None, help="the kernel legs: import "
                   "the package from this checkout")
    args = p.parse_args(argv)
    legs = args.legs or DEFAULT_LEGS
    if set(legs) - set(LEGS) - set(KERNEL_LEGS):
        p.error(f"legs are {', '.join((*LEGS, *KERNEL_LEGS))}; got "
                f"{args.legs}")
    dev = common.device(args.device if device is None else device)
    rec = {"device": common.device_label(dev), "snr": SNR, "n_bits": N_BITS,
           "root": args.root or ".", "legs": {}}
    if set(legs) & set(KERNEL_LEGS):
        if dev.type != "cuda":
            p.error("the fused and fused_reach legs time kernels: a card")
        pk = _package(args.root)
    for label in legs:
        if label in KERNEL_LEGS:
            rec["legs"][label] = (fused_leg if label == "fused"
                                  else fused_reach_leg)(pk, dev)
            continue
        (d, k, m, n_train, n_val, batch, max_iter, dense_kernel,
         frontier) = LEGS[label]
        rec["legs"][label] = run_leg(
            label, args.d or d, args.k or k, args.m or m,
            args.n_train or n_train, args.n_val or n_val,
            args.batch or batch, args.max_iter or max_iter, dense_kernel,
            frontier, dev)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
