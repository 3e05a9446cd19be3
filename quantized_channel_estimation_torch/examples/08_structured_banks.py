"""FFT-domain structured banks and automatic coherence-blend selection.

Port of the JAX repository's `examples/08_structured_banks.py`:

1. For a circulant covariance fit with the standard single-pilot
   observation (A = x0 I), the whole Bussgang estimation chain stays in the
   DFT eigendomain: the per-SNR bank is K length-D spectra instead of K
   dense matrices (O(K D) memory), and an estimate costs O(K D + D log D)
   instead of O(K D^2), with the same results (the posteriors are a
   unitary change of basis apart). The reference densifies every structure
   before inference (`gmm_cplx_bussgang.py:317` raises for non-'full').
   Here the dense bank estimates through the plain einsum estimator
   (`stages.estimate`) and the FFT-domain bank through
   `stages.estimate_circulant`: the circulant kernel K6 on a card, its
   plain version on the CPU.

2. `coherence_alpha='auto'`: the best leave-one-out evidence blend depends
   on the SNR (pool hard at low SNR, hedge toward per-snapshot estimates
   under model mismatch at high SNR); `run_gmm` selects it per SNR on
   held-out blocks, estimating through K6 (flat) and K7 (blocks).

    python -m quantized_channel_estimation_torch.examples.08_structured_banks
    python -m quantized_channel_estimation_torch.examples.08_structured_banks --device cpu
"""
from __future__ import annotations

import os
import tempfile

from quantized_channel_estimation_torch.examples._common import (
    bank_elements, claim, cli, generator)
from quantized_channel_estimation_torch.harness import run_gmm, stages
from quantized_channel_estimation_torch.models import gmm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm

N_ANT, K, N_BITS = 32, 16, 2
N_TRAIN, N_VAL = 20_000, 2_000
SNRS = (0.0, 10.0)
TOL = 1e-4   # the claim: structured against dense, of scale
# the harness sweep of part 2
SWEEP = dict(n_train=16_000, n_val=1_600, alpha_val_blocks=400,
             snrs=(-10, 0, 10), gmm_max_iter=30)


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """One draw of channels split into (h_train, h_val)."""
    h, _ = stages.generate_channels(generator(0, device), n_train + n_val,
                                    scm.ScmConfig(n_ant, 1))
    return h[:n_train], h[n_train:]


def fit(h_train, k=K) -> gmm.GmmFitResult:
    """A circulant-covariance GMM."""
    return stages.gmm_fit(generator(1, h_train.device), h_train,
                          gmm.GmmConfig(n_components=k, cov_type="circulant"))


def observe(h_val, snr_db, n_bits=N_BITS):
    """(a, q, r) at one SNR; a is the P = 1 'angle_amp' pilot, 1 I."""
    dev = h_val.device
    a = stages.pilot_matrix(h_val.shape[-1], 1, n_bits, device=dev)
    q = Q.design_quantizer(snr_db, n_bits, device=dev)
    r = stages.observe(generator(2, dev), h_val, snr_db, a, n_bits, q)
    return a, q, r


def evaluate(params, h_val, r, snr_db, a, q, n_bits=N_BITS) -> dict:
    """The dense bank (K Cholesky factors and K dense filters) against the
    FFT-domain bank (K spectra) at one SNR: both NMSEs, the largest
    difference of the two estimates relative to the dense estimate's
    largest entry, and both banks' element counts."""
    bank_d = stages.prepare_bank(params, snr_db, a, n_bits, q)
    h_dense = stages.estimate(bank_d, r, "all", 2048)
    bank_s = stages.prepare_bank_circulant(params, snr_db, a, n_bits, q,
                                           None)
    h_struct = stages.estimate_circulant(bank_s, r, "all", None)
    return {"dense": stages.nmse(h_dense, h_val),
            "structured": stages.nmse(h_struct, h_val),
            "max_rel_diff": float((h_struct - h_dense).abs().max()
                                  / h_dense.abs().max()),
            "bank_elements": [bank_elements(bank_d), bank_elements(bank_s)]}


def auto_alpha_sweep(device, n_ant=N_ANT, k=K, **sweep) -> dict:
    """`run_gmm` with coherence blocks of 4, `coherence_alpha='auto'` and a
    circulant fit (served by the structured path), its results and cache
    under a temporary directory."""
    with tempfile.TemporaryDirectory() as root:
        cfg = run_gmm.GmmBenchConfig(
            n_antennas=n_ant, n_components=k, n_coherence=4,
            coherence_alpha="auto", cov_type="circulant", use_cache=False,
            eval_blmmse_genie=False, eval_ls_glob=False, results_dir=root,
            cache_dir=os.path.join(root, "saves"), **{**SWEEP, **sweep})
        mse, _, tim = run_gmm.run(cfg, verbose=False, device=device)
    return {"alphas": {float(s): float(v) for s, v
                       in tim["coherence_alpha_by_snr"].items()},
            "blmmse_gmm": [float(m) for m in mse["blmmse_gmm"]],
            "blmmse_gmm_coh": [float(m) for m in mse["blmmse_gmm_coh"]]}


def main(device=None, n_ant=N_ANT, k=K, n_train=N_TRAIN, n_val=N_VAL,
         sweep=None) -> dict:
    """`sweep` overrides SWEEP, the sizes of part 2's `run_gmm`."""
    device = stages.resolve_device(device)
    h_train, h_val = data(device, n_ant, n_train, n_val)
    res = fit(h_train, k)
    print(f"circulant GMM fit: {int(res.n_iter)} iters")
    nmse = {}
    for snr in SNRS:
        a, q, r = observe(h_val, snr)
        m = nmse[snr] = evaluate(res.params, h_val, r, snr, a, q)
        n_dense, n_struct = m["bank_elements"]
        print(f"SNR {snr:>5}: NMSE dense={m['dense']:.5f} "
              f"structured={m['structured']:.5f}  (bank elements "
              f"{n_dense} -> {n_struct}, {n_dense / n_struct:.0f}x smaller)")
    print("\ncoherence_alpha='auto' (per-SNR selection on held-out blocks):")
    auto = auto_alpha_sweep(device, n_ant, k, **(sweep or {}))
    print(f"  chosen alphas: {auto['alphas']}")
    print(f"  per-snapshot column: "
          f"{[round(m, 4) for m in auto['blmmse_gmm']]}")
    print(f"  coherent (auto)    : "
          f"{[round(m, 4) for m in auto['blmmse_gmm_coh']]}")
    return {"n_iter": int(res.n_iter), "nmse": nmse, "auto_alpha": auto}


def check(out: dict) -> None:
    """The example's claim: at every SNR the FFT-domain bank's estimate
    lies within TOL of scale of the dense bank's, and so does its NMSE."""
    for snr, m in out["nmse"].items():
        claim(m["max_rel_diff"] <= TOL
              and abs(m["structured"] - m["dense"]) <= TOL * m["dense"],
              f"at {snr} dB structured {m['structured']} against dense "
              f"{m['dense']}, estimates {m['max_rel_diff']} of scale apart")


if __name__ == "__main__":
    cli(main, __doc__)
