"""Quickstart: fit a GMM prior on channels, estimate from 2-bit observations.

Port of the JAX repository's `examples/01_quickstart_estimation.py`. The
minimum end-to-end slice (reference workflow: `Bussgang_GMM.py`): 3GPP-SCM
channels -> pilot -> quantize -> GMM fit -> Bussgang-LMMSE bank ->
estimates and NMSE against the genie bound. The 'all'-mode estimate goes
through `stages.estimate_auto`: the estimation kernel K1 on a card, its
plain version on the CPU.

    python -m quantized_channel_estimation_torch.examples.01_quickstart_estimation
    python -m quantized_channel_estimation_torch.examples.01_quickstart_estimation --device cpu
"""
from __future__ import annotations

from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm

N_ANT, K, N_BITS, SNR_DB = 32, 16, 2, 10.0
N_TRAIN, N_VAL, MAX_ITER = 20_000, 2_000, 100


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """Training channels, validation channels and their genie Toeplitz
    rows: (h_train, h_val, t_val)."""
    h_train, _ = stages.generate_channels(generator(0, device), n_train,
                                          scm.ScmConfig(n_ant, 1))
    h_val, t_val = stages.generate_channels(generator(1, device), n_val,
                                            scm.ScmConfig(n_ant, 1))
    return h_train, h_val, t_val


def observe(h_val, snr_db=SNR_DB, n_bits=N_BITS):
    """The pilot matrix, the quantizer design and the quantized
    observations of the validation channels: (a, q, r)."""
    dev = h_val.device
    a = stages.pilot_matrix(h_val.shape[-1], 1, n_bits, device=dev)
    q = Q.design_quantizer(snr_db, n_bits, device=dev)
    r = stages.observe(generator(2, dev), h_val, snr_db, a, n_bits, q)
    return a, q, r


def fit(h_train, k=K, max_iter=MAX_ITER) -> gmm.GmmFitResult:
    """The GMM prior fitted on clean training channels."""
    cfg = gmm.GmmConfig(n_components=k, zero_mean=True, max_iter=max_iter)
    return stages.gmm_fit(generator(3, h_train.device), h_train, cfg)


def evaluate(params, h_val, t_val, r, a, q, snr_db=SNR_DB,
             n_bits=N_BITS) -> dict:
    """NMSE of the GMM-Bussgang estimate (the per-SNR bank, a pure value
    that can be cached or sharded, through `stages.estimate_auto`) and of
    the genie bound (the true per-sample covariance)."""
    bank = stages.prepare_bank(params, snr_db, a, n_bits, q)
    h_est = stages.estimate_auto(bank, r, "all")
    h_genie = stages.blmmse_genie(r, t_val, snr_db, a, n_bits, q)
    return {"gmm": stages.nmse(h_est, h_val),
            "genie": stages.nmse(h_genie, h_val)}


def main(device=None, n_ant=N_ANT, k=K, n_train=N_TRAIN, n_val=N_VAL,
         max_iter=MAX_ITER) -> dict:
    device = stages.resolve_device(device)
    h_train, h_val, t_val = data(device, n_ant, n_train, n_val)
    a, q, r = observe(h_val)
    res = fit(h_train, k, max_iter)
    print(f"EM converged: {bool(res.converged)} after {int(res.n_iter)} "
          "iters")
    nmse = evaluate(res.params, h_val, t_val, r, a, q)
    print(f"GMM-Bussgang NMSE @ {SNR_DB:.0f} dB: {nmse['gmm']:.4f}")
    print(f"genie bound        @ {SNR_DB:.0f} dB: {nmse['genie']:.4f}")
    return {"converged": bool(res.converged), "n_iter": int(res.n_iter),
            "nmse": nmse}


def check(out: dict) -> None:
    """The example's claim: the genie bound lies below the GMM estimate's
    NMSE."""
    claim(out["nmse"]["genie"] < out["nmse"]["gmm"],
          f"genie {out['nmse']['genie']} not below GMM {out['nmse']['gmm']}")


if __name__ == "__main__":
    cli(main, __doc__)
