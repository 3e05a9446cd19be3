"""Serving: continuous-batching estimation over GMM, MFA and VAE priors.

Port of the JAX repository's `examples/07_serving.py`. The reference is a
batch research codebase; the serving layer (`serving.py`) is for the
deployment shape the estimators target: many concurrent clients submitting
small requests at arbitrary SNRs. Requests coalesce into padded
power-of-two microbatches per (SNR, block length); per-SNR prepared banks
are LRU-cached; overload sheds explicitly.

Shown here: (1) flat requests against a GMM bank from 4 client threads at
mixed SNRs (the estimation kernel K1 on a card), (2) coherence-block
requests (n, T, M) served through block-pooled joint estimation (K3),
the service's `metrics()`, and `close()`, which drains, (3) an MFA prior
through the same service (`from_mfa`: the factored kernel K11), and (4)
the CSI-free VAE service (`VaeEstimationService`, no kernel). Every served
answer is set against the plain estimator's answer to the same request
(`gmm_estimator.estimate` / `estimate_coherent`, `mfa_bank`'s pipeline,
`vae.estimate`); on the CPU the service runs the kernels' plain versions.

    python -m quantized_channel_estimation_torch.examples.07_serving
    python -m quantized_channel_estimation_torch.examples.07_serving --device cpu
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import (
    gmm, gmm_estimator, mfa, mfa_bank, vae)
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm

N_ANT, K, N_BITS = 16, 8, 2
N_TRAIN, MAX_ITER = 20_000, 40
CLIENT_SNRS = (0.0, 0.0, 10.0, 10.0)
MFA_SNR = VAE_SNR = 5.0
TOL = 1e-4   # the claim: served against plain, of scale


def data(device, n_ant=N_ANT, n_train=N_TRAIN):
    """Training channels."""
    return stages.generate_channels(generator(0, device), n_train,
                                    scm.ScmConfig(n_ant, 1))[0]


def fit(h_train, k=K, max_iter=MAX_ITER) -> gmm.GmmFitResult:
    return stages.gmm_fit(generator(1, h_train.device), h_train,
                          gmm.GmmConfig(n_components=k, zero_mean=True,
                                        max_iter=max_iter))


def requests(n_ant=N_ANT):
    """The example's request: 32 observations (numpy, as clients send
    them), and the same rows as 8 coherence blocks of 4."""
    rng = np.random.default_rng(0)
    req = (rng.standard_normal((32, n_ant))
           + 1j * rng.standard_normal((32, n_ant))).astype(np.complex64)
    return req, req.reshape(8, 4, n_ant)


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    want = want.cpu()
    return float((torch.as_tensor(got) - want).abs().max()
                 / want.abs().max())


def _quantizer(snr, dev):
    return Q.design_quantizer(snr, N_BITS, device=dev)


def serve_gmm(params, a, req, blocks) -> dict:
    """(1) and (2): four concurrent clients at mixed SNRs, then one block
    request; each answer against the plain einsum estimators on the
    service's device."""
    dev = a.device
    svc = serving.EstimationService(params, a, N_BITS, max_delay_ms=2.0,
                                    device=dev)
    results = {}

    def client(i, snr):
        results[i] = svc.submit(req, snr)

    try:
        threads = [threading.Thread(target=client, args=(i, snr))
                   for i, snr in enumerate(CLIENT_SNRS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"GMM service: {len(threads)} concurrent clients served, "
              f"result shape {results[0].shape}")
        out = svc.submit(blocks, 0.0)
        print(f"coherent request: {blocks.shape} -> {out.shape} "
              "(T snapshots share one component posterior)")
        m = svc.metrics()
        print(f"metrics: {m['requests_completed']} requests, "
              f"{m['estimates_served']} estimates, p50 "
              f"{m['latency_p50_s'] * 1e3:.0f} ms, banks cached "
              f"{m['banks_cached']}")
    finally:
        svc.close()   # drains; close(drain=False) fails queued requests fast
    r = torch.as_tensor(req, device=dev)
    rel = []
    for i, snr in enumerate(CLIENT_SNRS):
        bank = gmm_estimator.prepare_bank(params, snr, a, N_BITS,
                                          _quantizer(snr, dev))
        rel.append(_rel(results[i], gmm_estimator.estimate(bank, r, "all")))
    bank0 = gmm_estimator.prepare_bank(params, 0.0, a, N_BITS,
                                       _quantizer(0.0, dev))
    rel.append(_rel(out, gmm_estimator.estimate_coherent(
        bank0, torch.as_tensor(blocks, device=dev), "all")))
    return {"flat_shape": list(results[0].shape),
            "blocks_shape": list(out.shape),
            "requests_completed": m["requests_completed"],
            "estimates_served": m["estimates_served"],
            "latency_p50_s": m["latency_p50_s"],
            "banks_cached": m["banks_cached"], "max_rel_diff": max(rel)}


def serve_mfa(h_train, a, req) -> dict:
    """(3): an MFA prior (4 components, rank 4) through `from_mfa`, which
    keeps it factored for a 2-bit A = I service; the answer against the
    `torch.matmul` pipeline."""
    mfit = stages.mfa_fit(generator(2, h_train.device), h_train[:8000],
                          mfa.MfaConfig(n_components=4, latent_dim=4,
                                        zero_mean=True, max_iter=15))
    svc = serving.EstimationService.from_mfa(mfit.params, a, N_BITS,
                                             max_delay_ms=2.0,
                                             device=a.device)
    try:
        out = svc.submit(req, MFA_SNR)
        factored = svc.factored
    finally:
        svc.close()
    print(f"MFA-backed service: {out.shape} (factored={factored})")
    bank = mfa_bank.prepare_bank_factored(mfit.params, MFA_SNR, a, N_BITS,
                                          _quantizer(MFA_SNR, a.device))
    want = mfa_bank.estimate_factored(bank, torch.as_tensor(req,
                                                            device=a.device))
    return {"shape": list(out.shape), "factored": factored,
            "max_rel_diff": _rel(out, want)}


def serve_vae(h_train, a, req, blocks) -> dict:
    """(4): a VAE trained two epochs in noisy mode (genie mode is refused
    by construction), served flat and in blocks; each answer against
    `vae.estimate`."""
    dev = a.device
    vcfg = vae.VaeConfig(n_antennas=h_train.shape[-1], latent_dim=4,
                         n_layers=2, vae_mode="noisy", batch_size=200,
                         epochs=2)
    model, state, _ = vae.train(3, vcfg, h_train[:8000], a, [0.0, 10.0],
                                [_quantizer(s, dev) for s in (0.0, 10.0)],
                                verbose=False)
    svc = serving.VaeEstimationService(model, state.params, vcfg, a,
                                       max_delay_ms=2.0, device=dev)
    try:
        out_flat = svc.submit(req, VAE_SNR)
        out_blocks = svc.submit(blocks, VAE_SNR)
    finally:
        svc.close()
    print(f"VAE service: flat {out_flat.shape}, blocks {out_blocks.shape} "
          "(spectra pooled per block)")
    q = _quantizer(VAE_SNR, dev)
    r = torch.as_tensor(req, device=dev)
    want_flat = vae.estimate(model, state.params, vcfg, r, VAE_SNR, a, q,
                             structured=True)
    want_blocks = vae.estimate(model, state.params, vcfg, r, VAE_SNR, a, q,
                               coherence=blocks.shape[1], structured=True)
    return {"flat_shape": list(out_flat.shape),
            "blocks_shape": list(out_blocks.shape),
            "max_rel_diff": max(
                _rel(out_flat, want_flat),
                _rel(out_blocks, want_blocks.reshape(blocks.shape)))}


def main(device=None, n_ant=N_ANT, k=K, n_train=N_TRAIN,
         max_iter=MAX_ITER) -> dict:
    device = stages.resolve_device(device)
    h_train = data(device, n_ant, n_train)
    res = fit(h_train, k, max_iter)
    a = torch.eye(n_ant, dtype=torch.complex64, device=device)  # 1 pilot
    req, blocks = requests(n_ant)
    out = {"gmm": serve_gmm(res.params, a, req, blocks),
           "mfa": serve_mfa(h_train, a, req),
           "vae": serve_vae(h_train, a, req, blocks)}
    print("done")
    return out


def check(out: dict) -> None:
    """The example's claim: every served answer lies within TOL of scale
    of the plain estimator's answer to the same request (GMM flat and
    blocks, MFA factored, VAE flat and blocks)."""
    claim(out["mfa"]["factored"], "the 2-bit MFA service is not factored")
    for prior in ("gmm", "mfa", "vae"):
        rel = out[prior]["max_rel_diff"]
        claim(rel <= TOL, f"the {prior} service is {rel} of scale off the "
              "plain estimator")


if __name__ == "__main__":
    cli(main, __doc__)
