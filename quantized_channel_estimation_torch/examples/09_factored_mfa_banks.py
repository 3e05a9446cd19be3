"""Factored MFA estimation: the low-rank prior never densifies.

Port of the JAX repository's `examples/09_factored_mfa_banks.py`. The
reference's Mofa fits Lambda Lambda^H + diag(psi) with a Woodbury E-step,
then densifies at prediction (`mofa_cplx_bussgang.py:117-216`): K dense
D^3 Cholesky factorizations per SNR, an O(K D^2) bank, O(K D^2) per
estimate. Here the factored form goes end to end: for the standard P = 1
pilot with n-bit or unquantized observations the Bussgang covariance stays
exactly low-rank plus diagonal, so the per-SNR prepare runs only M x M
factorizations and an estimate costs O(K D M) (`models.mfa_bank`).

As in the JAX script the bank is driven through `models.mfa_bank`'s
`torch.matmul` pipeline, flat and in coherence blocks; the service
(`EstimationService.from_mfa`) serves the same bank through the factored
kernel K11 on a card. At 1 bit the service takes the densified bank (the
arcsine map destroys low rank; forcing the factored bank raises).

    python -m quantized_channel_estimation_torch.examples.09_factored_mfa_banks
    python -m quantized_channel_estimation_torch.examples.09_factored_mfa_banks --device cpu
"""
from __future__ import annotations

import torch

from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.examples._common import (
    bank_elements, claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import (
    gmm_estimator, mfa, mfa_bank)
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm

N_ANT, N_BITS, SNR = 32, 2, 10.0
K, LATENT = 16, 8
N_TRAIN, N_VAL, MAX_ITER = 24_000, 2_000, 50
N_SERVED, T_COH, ALPHA = 256, 4, 0.25
TOL = 1e-4   # the claim: factored against dense, of scale


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """Two-path channels: (h_train, h_val)."""
    h, _ = stages.generate_channels(generator(0, device), n_train,
                                    scm.ScmConfig(n_ant, 2))
    h_val, _ = stages.generate_channels(generator(2, device), n_val,
                                        scm.ScmConfig(n_ant, 2))
    return h, h_val


def fit(h_train, k=K, latent=LATENT, max_iter=MAX_ITER) -> mfa.MfaFitResult:
    """The MFA prior fitted on clean channels."""
    return stages.mfa_fit(generator(1, h_train.device), h_train,
                          mfa.MfaConfig(n_components=k, latent_dim=latent,
                                        zero_mean=True, max_iter=max_iter))


def observe(h_val, snr_db=SNR, n_bits=N_BITS):
    """(a, q, r): a = I (the P = 1 pilot, x0 = 1)."""
    dev = h_val.device
    a = torch.eye(h_val.shape[-1], dtype=torch.complex64, device=dev)
    q = Q.design_quantizer(snr_db, n_bits, device=dev)
    r = stages.observe(generator(3, dev), h_val, snr_db, a, n_bits, q)
    return a, q, r


def evaluate(params, h_val, r, a, q, snr_db=SNR, n_bits=N_BITS) -> dict:
    """The factored bank against the densified path at one SNR: both
    NMSEs, the largest difference of the two estimates relative to the
    dense estimate's largest entry, both banks' element counts, and the
    NMSE of coherence blocks of T_COH snapshots with the alpha = ALPHA
    blend through the same factored bank."""
    bank_f = mfa_bank.prepare_bank_factored(params, snr_db, 1.0 + 0.0j,
                                            n_bits, q)
    bank_d = gmm_estimator.prepare_bank(mfa.to_gmm_params(params), snr_db,
                                        a, n_bits, q)
    h_f = mfa_bank.estimate_factored(bank_f, r)
    h_d = gmm_estimator.estimate(bank_d, r, "all")
    n_blocks = r.shape[0] // T_COH
    rb = r[:n_blocks * T_COH].reshape(n_blocks, T_COH, -1)
    h_coh = mfa_bank.estimate_factored_coherent(bank_f, rb, "all", 256,
                                                ALPHA)
    return {"factored": stages.nmse(h_f, h_val),
            "dense": stages.nmse(h_d, h_val),
            "max_rel_diff": float((h_f - h_d).abs().max()
                                  / h_d.abs().max()),
            "bank_elements": [bank_elements(bank_d), bank_elements(bank_f)],
            "coherent": stages.nmse(h_coh.reshape(-1, r.shape[-1]),
                                    h_val[:n_blocks * T_COH])}


def serve(params, h_val, r, snr_db=SNR, n_bits=N_BITS) -> dict:
    """`EstimationService.from_mfa`, factored by default, on the first
    N_SERVED observations, and the 1-bit service, which takes the dense
    bank."""
    dev = r.device
    svc = serving.EstimationService.from_mfa(params, 1.0 + 0.0j, n_bits,
                                             max_delay_ms=2.0, device=dev)
    try:
        print(f"serving factored={svc.factored}")
        got = svc.submit(r[:N_SERVED].cpu(), snr_db)
        nmse = stages.nmse(torch.as_tensor(got, device=dev),
                           h_val[:N_SERVED])
        print(f"served {N_SERVED} estimates, NMSE={nmse:.5f}")
        m = svc.metrics()
        print(f"service metrics: served={m['estimates_served']} "
              f"microbatches={m['microbatches']}")
        factored = svc.factored
    finally:
        svc.close()
    svc1 = serving.EstimationService.from_mfa(params, 1.0 + 0.0j, 1,
                                              max_delay_ms=2.0,
                                              use_kernels=False, device=dev)
    try:
        print(f"1-bit service factored={svc1.factored} (dense bank)")
        factored_1bit = svc1.factored
    finally:
        svc1.close()
    return {"factored": factored, "served_nmse": nmse,
            "estimates_served": m["estimates_served"],
            "microbatches": m["microbatches"],
            "one_bit_factored": factored_1bit}


def main(device=None, n_ant=N_ANT, k=K, latent=LATENT, n_train=N_TRAIN,
         n_val=N_VAL, max_iter=MAX_ITER) -> dict:
    device = stages.resolve_device(device)
    h_train, h_val = data(device, n_ant, n_train, n_val)
    res = fit(h_train, k, latent, max_iter)
    print(f"MFA fit: {int(res.n_iter)} iters, "
          f"ll={float(res.log_likelihood):.1f}")
    a, q, r = observe(h_val)
    nmse = evaluate(res.params, h_val, r, a, q)
    n_dense, n_fact = nmse["bank_elements"]
    print(f"NMSE factored={nmse['factored']:.5f} dense={nmse['dense']:.5f}"
          f"  (bank elements {n_dense} -> {n_fact}, "
          f"{n_dense / n_fact:.1f}x smaller)")
    print(f"coherent T={T_COH} alpha={ALPHA}: NMSE={nmse['coherent']:.5f}")
    served = serve(res.params, h_val, r)
    return {"n_iter": int(res.n_iter), "nmse": nmse, "service": served}


def check(out: dict) -> None:
    """The example's claim: the factored bank's estimate lies within TOL
    of scale of the densified path's, and so does its NMSE; the 2-bit
    service is factored and the 1-bit service dense."""
    m = out["nmse"]
    claim(m["max_rel_diff"] <= TOL
          and abs(m["factored"] - m["dense"]) <= TOL * m["dense"],
          f"factored {m['factored']} against dense {m['dense']}, estimates "
          f"{m['max_rel_diff']} of scale apart")
    svc = out["service"]
    claim(svc["factored"] and not svc["one_bit_factored"],
          f"service banks: {svc}")


if __name__ == "__main__":
    cli(main, __doc__)
