"""Train the GMM directly on quantized pilots: no ground-truth CSI.

Port of the JAX repository's `examples/02_train_without_csi.py` (reference
workflow: `Bussgang_GMM_quant.py`). The EM runs on quantized observations
r = Q(A h + n); each M-step recovers the underlying channel covariances
through the arcsine law (1 bit) or per-dimension Gauss-Newton scale solves
from the quantization-bin occupancy (n bits), so the prior is learned
without ever seeing a clean channel. It is evaluated with the same
Bussgang-LMMSE bank as the CSI-trained GMM (the plain einsum estimator,
as in the JAX script), beside the genie bound and the global Bussgang LS
estimate.

The structured CSI-free variants crash in the reference
(`gmm_cplx_quant.py:763-767`); here they work: 'diag' recovers
per-dimension variances from the bin occupancy (O(N K D) statistics,
n_bits >= 2), 'circulant' projects the full recovery onto the circulant
cone through the DFT diagonal (the Frobenius-nearest circulant).

    python -m quantized_channel_estimation_torch.examples.02_train_without_csi
    python -m quantized_channel_estimation_torch.examples.02_train_without_csi --device cpu
"""
from __future__ import annotations

from quantized_channel_estimation_torch.estimators import blmmse, ls
from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import (
    gmm, gmm_estimator, gmm_quant)
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.ops import quantizer as Q

N_ANT, K, N_BITS = 16, 8, 2
SNR_TRAIN = 5.0   # the pilots the base station actually records
SNR_EVAL = 5.0
N_TRAIN, N_VAL, MAX_ITER = 20_000, 2_000, 40
COV_TYPES = ("full", "diag", "circulant")


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """(h_train, h_val, t_val); h_train is only ever observed through the
    quantizer."""
    h_train, _ = scm.generate_channels(generator(0, device), n_train,
                                       scm.ScmConfig(n_ant, 1))
    h_val, t_val = scm.generate_channels(generator(1, device), n_val,
                                         scm.ScmConfig(n_ant, 1))
    return h_train, h_val, t_val


def pilots_and_quantizers(device, n_ant=N_ANT, n_bits=N_BITS):
    """(a, q_train, q_eval)."""
    a = pilots.pilot_matrix(n_ant, 1, n_bits, device=device)
    return (a, Q.design_quantizer(SNR_TRAIN, n_bits, device=device),
            Q.design_quantizer(SNR_EVAL, n_bits, device=device))


def observe(h_train, h_val, a, q_train, q_eval, n_bits=N_BITS):
    """The training data, quantized pilots at SNR_TRAIN (not channels),
    and the validation observations at SNR_EVAL: (r_train, r_val)."""
    dev = h_train.device
    r_train = observation.observe(generator(2, dev), h_train, SNR_TRAIN, a,
                                  n_bits, q_train)
    r_val = observation.observe(generator(4, dev), h_val, SNR_EVAL, a,
                                n_bits, q_eval)
    return r_train, r_val


def fit(r_train, q_train, cov_type="full", k=K, max_iter=MAX_ITER,
        n_bits=N_BITS):
    """The quantized EM on the pilots alone; the structured types draw
    their init from stream 5, the full one from stream 3 (as the JAX
    script keys them)."""
    cfg = gmm.GmmConfig(n_components=k, cov_type=cov_type, zero_mean=True,
                        max_iter=max_iter)
    seed = 3 if cov_type == "full" else 5
    return gmm_quant.fit(generator(seed, r_train.device), r_train, cfg,
                         n_bits, 10.0 ** (-SNR_TRAIN / 10.0), q_train)


def evaluate(params, h_val, r_val, a, q_eval, n_bits=N_BITS) -> float:
    """NMSE of the CSI-free GMM's Bussgang-LMMSE estimate."""
    bank = gmm_estimator.prepare_bank(params, SNR_EVAL, a, n_bits, q_eval)
    return stages.nmse(gmm_estimator.estimate(bank, r_val, "all"), h_val)


def baselines(h_train, h_val, t_val, r_val, a, q_eval,
              n_bits=N_BITS) -> dict:
    """NMSE of the genie bound (the true per-sample covariance) and of the
    global Bussgang LS estimate (its gain from the training channels'
    sample covariance, as the harnesses set it)."""
    genie = blmmse.estimate_genie(r_val, t_val, SNR_EVAL, a, n_bits, q_eval)
    h_ls = ls.estimate_global(r_val, stages.sample_cov(h_train), SNR_EVAL, a,
                              n_bits, q_eval)
    return {"genie": stages.nmse(genie, h_val),
            "ls": stages.nmse(h_ls, h_val)}


def main(device=None, n_ant=N_ANT, k=K, n_train=N_TRAIN, n_val=N_VAL,
         max_iter=MAX_ITER) -> dict:
    device = stages.resolve_device(device)
    h_train, h_val, t_val = data(device, n_ant, n_train, n_val)
    a, q_train, q_eval = pilots_and_quantizers(device, n_ant)
    r_train, r_val = observe(h_train, h_val, a, q_train, q_eval)
    nmse, n_iter = {}, {}
    for cov_type in COV_TYPES:
        res = fit(r_train, q_train, cov_type, k, max_iter)
        n_iter[cov_type] = int(res.n_iter)
        nmse[cov_type] = evaluate(res.params, h_val, r_val, a, q_eval)
        if cov_type == "full":
            print(f"quantized-EM done after {int(res.n_iter)} iters")
            print(f"CSI-free GMM NMSE @ {SNR_EVAL:.0f} dB: "
                  f"{nmse[cov_type]:.4f}")
            base = baselines(h_train, h_val, t_val, r_val, a, q_eval)
            print(f"genie bound       @ {SNR_EVAL:.0f} dB: "
                  f"{base['genie']:.4f}")
            print(f"global LS         @ {SNR_EVAL:.0f} dB: "
                  f"{base['ls']:.4f}")
        else:
            print(f"CSI-free {cov_type:9s} NMSE @ {SNR_EVAL:.0f} dB: "
                  f"{nmse[cov_type]:.4f}")
    return {"n_iter": n_iter, "nmse": nmse, **base}


def check(out: dict) -> None:
    """The example's claim: every CSI-free fit estimates below the global
    LS estimate's NMSE."""
    for cov_type, nmse in out["nmse"].items():
        claim(nmse < out["ls"], f"CSI-free {cov_type} NMSE {nmse} not below "
              f"LS {out['ls']}")


if __name__ == "__main__":
    cli(main, __doc__)
