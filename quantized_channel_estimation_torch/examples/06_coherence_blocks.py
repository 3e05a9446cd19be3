"""Coherence blocks: joint component selection over snapshots sharing a PSD.

Port of the JAX repository's `examples/06_coherence_blocks.py`. The
reference's channel model can emit multi-snapshot coherence blocks
(`SCMMulti.py:30`: n_coherence independent draws sharing one angular PSD)
but every downstream estimator there is single-snapshot.
`stages.estimate_coherent` computes the GMM component posterior from the
BLOCK likelihood (per-snapshot log-likelihoods summed over the coherence
axis before the softmax) and combines every snapshot with the shared
weights. Component identification sharpens about T-fold in log-space,
which lowers the MSE where it is hardest: low SNR.

Like the JAX script it calls the plain estimators (`stages.estimate`,
`stages.estimate_coherent`), so it launches no kernel; the harness knob
`GmmBenchConfig(n_coherence=T)` runs the same estimate through K3.

    python -m quantized_channel_estimation_torch.examples.06_coherence_blocks
    python -m quantized_channel_estimation_torch.examples.06_coherence_blocks --device cpu
"""
from __future__ import annotations

from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import gmm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.ops import scm

N_ANT, K, N_BITS, N_COH = 16, 8, 2, 8
N_TRAIN, N_VAL_BLOCKS, MAX_ITER = 20_000, 2_000, 50
SNRS = (-10.0, 0.0, 10.0)


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val_blocks=N_VAL_BLOCKS,
         n_coh=N_COH):
    """Single-snapshot training channels (the prior is per snapshot;
    coherence only enters at estimation time) and validation coherence
    blocks (B, T, N), T snapshots per angular PSD: (h_train, h_val)."""
    h_train, _ = stages.generate_channels(generator(0, device), n_train,
                                          scm.ScmConfig(n_ant, 1))
    h_val, _ = stages.generate_channels(
        generator(2, device), n_val_blocks,
        scm.ScmConfig(n_ant, 1, n_coherence=n_coh))
    return h_train, h_val


def fit(h_train, k=K, max_iter=MAX_ITER) -> gmm.GmmFitResult:
    return stages.gmm_fit(generator(1, h_train.device), h_train,
                          gmm.GmmConfig(n_components=k, zero_mean=True,
                                        max_iter=max_iter))


def observe(h_val, snr_db, n_bits=N_BITS):
    """(a, q, r) at one SNR: r the quantized observation blocks (B, T, M);
    every SNR draws its noise from the same stream, as in the JAX
    script."""
    dev = h_val.device
    a = stages.pilot_matrix(h_val.shape[-1], 1, n_bits, device=dev)
    q = Q.design_quantizer(snr_db, n_bits, device=dev)
    r = stages.observe(generator(3, dev), h_val, snr_db, a, n_bits, q)
    return a, q, r


def evaluate(params, h_val, r, snr_db, a, q, n_bits=N_BITS) -> dict:
    """NMSE at one SNR of the independent per-snapshot estimate (what
    flattening gives), the joint estimate over each block and the
    leave-one-out evidence blend at alpha = 0.5 (0 is independent, 1
    joint: the hedge for model-mismatched regimes)."""
    bank = stages.prepare_bank(params, snr_db, a, n_bits, q)
    r_flat = stages.flatten_coherence(r)
    h_flat = stages.flatten_coherence(h_val)
    indep = stages.nmse(stages.estimate(bank, r_flat, "all"), h_flat)
    joint = stages.nmse(stages.flatten_coherence(
        stages.estimate_coherent(bank, r, "all")), h_flat)
    blend = stages.nmse(stages.flatten_coherence(
        stages.estimate_coherent(bank, r, "all", 512, 0.5)), h_flat)
    return {"independent": indep, "joint": joint, "blend": blend}


def main(device=None, n_ant=N_ANT, k=K, n_train=N_TRAIN,
         n_val_blocks=N_VAL_BLOCKS, n_coh=N_COH, max_iter=MAX_ITER) -> dict:
    device = stages.resolve_device(device)
    h_train, h_val = data(device, n_ant, n_train, n_val_blocks, n_coh)
    res = fit(h_train, k, max_iter)
    print(f"EM converged: {bool(res.converged)} after {int(res.n_iter)} "
          "iters")
    nmse = {}
    for snr_db in SNRS:
        a, q, r = observe(h_val, snr_db)
        m = nmse[snr_db] = evaluate(res.params, h_val, r, snr_db, a, q)
        change = 100 * (m["joint"] - m["independent"]) / m["independent"]
        print(f"SNR {snr_db:+5.1f} dB: independent {m['independent']:.4f}  "
              f"joint {m['joint']:.4f} ({change:+.1f}%)  "
              f"blend(a=0.5) {m['blend']:.4f}")
    return {"converged": bool(res.converged), "n_iter": int(res.n_iter),
            "nmse": nmse}


def check(out: dict) -> None:
    """The example's claim: at -10 dB the joint estimate beats the
    independent one."""
    m = out["nmse"][-10.0]
    claim(m["joint"] < m["independent"], f"at -10 dB joint {m['joint']} not "
          f"below independent {m['independent']}")


if __name__ == "__main__":
    cli(main, __doc__)
