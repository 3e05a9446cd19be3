"""VAE channel estimator: train on noisy quantized pilots, then estimate.

Port of the JAX repository's `examples/04_vae_estimator.py` (reference
workflow: `Bussgang_VAE.py --vae noisy`). The VAE learns a conditionally
Gaussian prior: its decoder emits per-sample FFT-domain variances, so each
observation gets its own LMMSE filter (against the GMM's fixed bank).
Training regenerates the quantized observations every epoch with
per-sample random SNRs (SNR-robust training, kept from the reference),
entirely on the device. It launches no kernel of the port.

Modes: 'genie' (clean-channel input), 'noisy' (quantized input, clean
target), 'real' (quantized input only: no CSI at all, like example 02).

    python -m quantized_channel_estimation_torch.examples.04_vae_estimator
    python -m quantized_channel_estimation_torch.examples.04_vae_estimator --device cpu
"""
from __future__ import annotations

from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import vae
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.ops import quantizer as Q

N_ANT, N_BITS = 16, 2
SNRS = (0.0, 5.0, 10.0, 15.0)   # training draws per-sample SNRs from these
SNR_EVAL = 10.0
N_TRAIN, N_VAL, EPOCHS = 8_000, 1_000, 30


def config(n_ant=N_ANT, epochs=EPOCHS, **change) -> vae.VaeConfig:
    return vae.VaeConfig(n_antennas=n_ant, latent_dim=n_ant // 4,
                         n_layers=3, vae_mode="noisy", n_bits=N_BITS,
                         lr=1e-3, batch_size=128, epochs=epochs, **change)


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """(h_train, h_val)."""
    h_train, _ = scm.generate_channels(generator(0, device), n_train,
                                       scm.ScmConfig(n_ant, 1))
    h_val, _ = scm.generate_channels(generator(1, device), n_val,
                                     scm.ScmConfig(n_ant, 1))
    return h_train, h_val


def train(h_train, cfg: vae.VaeConfig):
    """(model, state, per-epoch losses), seeded 2; the pilot matrix and
    the training quantizers are made here."""
    dev = h_train.device
    a = pilots.pilot_matrix(cfg.n_antennas, 1, N_BITS, device=dev)
    quantizers = [Q.design_quantizer(s, N_BITS, device=dev) for s in SNRS]
    return vae.train(2, cfg, h_train, a, SNRS, quantizers, verbose=False)


def observe(h_val, n_bits=N_BITS):
    """(a, q_eval, r_val) at SNR_EVAL."""
    dev = h_val.device
    a = pilots.pilot_matrix(h_val.shape[-1], 1, n_bits, device=dev)
    q = Q.design_quantizer(SNR_EVAL, n_bits, device=dev)
    r = observation.observe(generator(3, dev), h_val, SNR_EVAL, a, n_bits,
                            q)
    return a, q, r


def evaluate(model, params, cfg, h_val, r_val, a, q) -> float:
    """NMSE of the VAE's per-sample Bussgang-LMMSE estimate."""
    h_est = vae.estimate(model, params, cfg, r_val, SNR_EVAL, a, q)
    return stages.nmse(h_est, h_val)


def main(device=None, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL,
         epochs=EPOCHS) -> dict:
    device = stages.resolve_device(device)
    h_train, h_val = data(device, n_ant, n_train, n_val)
    cfg = config(n_ant, epochs)
    model, state, losses = train(h_train, cfg)
    print(f"trained {cfg.epochs} epochs; loss {losses[0]:.1f} -> "
          f"{losses[-1]:.1f}")
    a, q, r_val = observe(h_val)
    nmse = evaluate(model, state.params, cfg, h_val, r_val, a, q)
    print(f"VAE-noisy NMSE @ {SNR_EVAL:.0f} dB: {nmse:.4f}")
    return {"losses": [float(v) for v in losses], "nmse": nmse}


def check(out: dict) -> None:
    """The example's claim: training lowers the loss."""
    losses = out["losses"]
    claim(losses[-1] < losses[0], f"loss {losses[0]} -> {losses[-1]}")


if __name__ == "__main__":
    cli(main, __doc__)
