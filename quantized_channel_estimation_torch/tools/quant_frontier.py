"""CSI-free circulant training at frontier D, measured through the harness.

Port of the JAX repository's `tools/quant_frontier.py` as a measurement of
`harness.run_gmm_quant` itself: one run at D antennas, K components,
2-bit pilots trained and evaluated at one SNR, `cov_type='circulant'`,
every frontier option at 'auto' (from D = 2048 the spectra-native fit,
from D = 8192 the streamed pilots, past `gmm_quant._INIT_ELEM_BUDGET`
rows x dimensions the streamed k-means init). It reports, as one JSON
line:

  datagen_s     seconds in channel generation and observation of the
                training and validation sets (host clock, synchronized);
  fit_s, n_iter, ms_per_iteration, host_syncs   the EM (its k-means init
                included), host synchronizations counted by
                `torch.cuda.set_sync_debug_mode('warn')`;
  peak_gib      `torch.cuda.max_memory_allocated()` over the whole run
                (allocated_before_gib: what the process held before it);
  nmse, ls_nmse the GMM column at the SNR and the Bussgang LS estimate of
                the same validation observations (`ls_scalar_pilot`: the
                global gain of the validation channels' per-dimension
                power, which is all `stages.ls_global` reads under
                A = x0 I);
  rate          the rate column with `--eval-rate` (the training sample
                covariance summed slab by slab, a dense D x D array);
  engaged       which of streaming, the spectra fit and the streamed init
                ran.

    python -m quantized_channel_estimation_torch.tools.quant_frontier \
        [--n-ant 16384] [--components 16] [--n-train 40000] [--n-val 2000] \
        [--snr 10] [--max-iter 30] [--eval-rate] [--device cpu]

The defaults are the JAX tool's D = 16384 row (40k training rows, K = 16,
30 iterations, 10 dB). On the card by default; `--device cpu` with small
sizes on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
import warnings

import torch

from quantized_channel_estimation_torch.harness import run_gmm_quant, stages
from quantized_channel_estimation_torch.models import gmm_quant
from quantized_channel_estimation_torch.ops.bussgang import bussgang_gain_diag

N_ANT, K_COMP, N_TRAIN, N_VAL, SNR_DB, MAX_ITER = (16384, 16, 40_000, 2_000,
                                                  10.0, 30)


def ls_scalar_pilot(r: torch.Tensor, var: torch.Tensor, snr_db, x0, n_bits,
                    q) -> torch.Tensor:
    """`estimators.ls.estimate_global` under A = x0 I without its (D, D)
    arrays: with a diagonal effective pilot B x0 the normal equations
    decouple, h = r / (x0 b), b the Bussgang gain of diag(Cy) = |x0|^2 var
    + sigma^2; var (D,) is the covariance's diagonal."""
    sigma2 = torch.tensor(10.0 ** (-float(snr_db) / 10.0),
                          dtype=torch.float32).item()
    x0 = torch.as_tensor(x0, device=r.device)
    gains = bussgang_gain_diag(x0.abs() ** 2 * var + sigma2, n_bits, q)
    return r / (x0 * gains.to(r.dtype))


def measure(n_antennas: int = N_ANT, n_components: int = K_COMP,
            n_train: int = N_TRAIN, n_val: int = N_VAL,
            snr: float = SNR_DB, max_iter: int = MAX_ITER,
            eval_rate: bool = False, device=None, **change) -> dict:
    """One `run_gmm_quant.run` (config changes in `change`), measured as
    the module docstring says."""
    device = stages.resolve_device(device)
    on_card = device.type == "cuda"
    cfg = run_gmm_quant.QuantGmmBenchConfig(
        n_antennas=n_antennas, n_components=n_components, n_train=n_train,
        n_val=n_val, snrs=(snr,), snr_train=snr, cov_type="circulant",
        max_iter=max_iter, eval_rate=eval_rate, use_cache=False, **change)
    rec = {"n_antennas": n_antennas, "n_components": n_components,
           "n_train": n_train, "n_val": n_val, "snr": snr,
           "eval_rate": eval_rate, "datagen_s": 0.0,
           "engaged": {"stream_pilots": False, "spectra_fit": False,
                       "dense_fit": False, "streamed_init": False}}
    kept, depth = {}, [0]

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def timed(fn, key=None):
        """fn with its seconds added to datagen_s (the outermost call
        only: the streamed stage generates and observes inside)."""
        def run(*args, **kw):
            if key:
                rec["engaged"][key] = True
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            sync()
            t = time.time()
            try:
                out = fn(*args, **kw)
                sync()
            finally:
                depth[0] -= 1
            rec["datagen_s"] += time.time() - t
            return out
        return run

    def counted_fit(fn, key):
        def run(*args, **kw):
            rec["engaged"][key] = True
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if on_card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    kept["fit"] = fn(*args, **kw)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(0)
            rec["host_syncs"] = (sum("synchroniz" in str(w.message)
                                     for w in caught) if on_card else None)
            return kept["fit"]
        return run

    def streamed_init(*args, **kw):
        rec["engaged"]["streamed_init"] = True
        return saved_init(*args, **kw)

    def keep_nmse(h_est, h):
        kept["truth"] = h
        return saved["nmse"](h_est, h)

    def keep_observe(gen, h, snr_db, a, n_bits, q):
        r = saved["observe"](gen, h, snr_db, a, n_bits, q)
        kept["r_val"], kept["a"], kept["q"] = r, a, q
        return r

    names = ("generate_channels", "stream_quantized_pilots", "observe",
             "gmm_quant_fit", "gmm_quant_fit_circulant_spectra", "nmse")
    saved = {name: getattr(stages, name) for name in names}
    saved_init = gmm_quant._streamed_init_stats
    stages.generate_channels = timed(saved["generate_channels"])
    stages.stream_quantized_pilots = timed(saved["stream_quantized_pilots"],
                                           "stream_pilots")
    # the training observation of a dense run is timed as datagen; the
    # last observation is the validation set's
    stages.observe = timed(keep_observe)
    stages.gmm_quant_fit = counted_fit(saved["gmm_quant_fit"], "dense_fit")
    stages.gmm_quant_fit_circulant_spectra = counted_fit(
        saved["gmm_quant_fit_circulant_spectra"], "spectra_fit")
    stages.nmse = keep_nmse
    gmm_quant._streamed_init_stats = streamed_init
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        rec["allocated_before_gib"] = (torch.cuda.memory_allocated(device)
                                       / 2 ** 30)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = dataclasses.replace(cfg, results_dir=tmp, cache_dir=tmp)
            t = time.time()
            mse, rate, timings = run_gmm_quant.run(cfg, verbose=False,
                                                   device=device)
            sync()
            rec["total_s"] = time.time() - t
    finally:
        for name, fn in saved.items():
            setattr(stages, name, fn)
        gmm_quant._streamed_init_stats = saved_init
    fit = kept.pop("fit")
    rec["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                       if on_card else None)
    rec.update(fit_s=timings["fit"], n_iter=int(fit.n_iter),
               ms_per_iteration=1e3 * timings["fit"] / max(1, fit.n_iter),
               lower_bound=float(fit.lower_bound),
               converged=bool(fit.converged),
               nmse=mse["blmmse_gmm_quant"][0],
               rate=rate["blmmse_gmm_quant_rstat"][0] if eval_rate else None)
    h_val = kept["truth"]
    a = kept["a"]
    x0 = a if a.dim() == 0 else a[0, 0]
    ls = ls_scalar_pilot(kept["r_val"], (h_val.abs() ** 2).mean(0), snr, x0,
                         cfg.n_bits, kept["q"])
    rec["ls_nmse"] = stages.nmse(ls, h_val)
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-ant", type=int, default=N_ANT)
    p.add_argument("--components", type=int, default=K_COMP)
    p.add_argument("--n-train", type=int, default=N_TRAIN)
    p.add_argument("--n-val", type=int, default=N_VAL)
    p.add_argument("--snr", type=float, default=SNR_DB)
    p.add_argument("--max-iter", type=int, default=MAX_ITER)
    p.add_argument("--eval-rate", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA card)")
    args = p.parse_args(argv)
    rec = measure(args.n_ant, args.components, args.n_train, args.n_val,
                  args.snr, args.max_iter, args.eval_rate, args.device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
