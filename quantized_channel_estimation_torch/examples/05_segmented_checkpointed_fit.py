"""Crash-safe long fits: segmented EM with per-segment checkpoints.

Port of the JAX repository's `examples/05_segmented_checkpointed_fit.py`. On
preemptible or wall-time-bounded machines a long structured fit runs as
several bounded segments, checkpointed after each
(`models.em_driver.fit_segmented`). If the process dies, running the
example again with the same checkpoint directory resumes after the last
finished segment instead of refitting; delete the directory to start over.

A Toeplitz segment resumes exactly: the checkpoint keeps the fit's
inverse-EM spectrum (`GmmFitResult.spectrum`), and `gmm.fit_resume`
continues from it, so a run cut after any segment and resumed ends bit for
bit where the uninterrupted run ends. The checkpoints are
`utils.checkpoint.TrainCheckpointer` steps (atomic, step-numbered), the
lower-bound history of each beside it as JSON.

No reference analog: the reference's host-side Python EM loop is
interruptible for free but never checkpoints mid-fit (its sklearn
`warm_start` plumbing is unused, `gmm_cplx_bussgang.py:491`).

    python -m quantized_channel_estimation_torch.examples.05_segmented_checkpointed_fit   # run, ctrl-C, rerun
    python -m quantized_channel_estimation_torch.examples.05_segmented_checkpointed_fit --device cpu
"""
from __future__ import annotations

import json
import os
import tempfile

import torch

from quantized_channel_estimation_torch.examples._common import (
    claim, cli, generator)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import (
    em_driver, gmm, gmm_estimator)
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.utils.checkpoint import (
    TrainCheckpointer)

N_ANT, K, N_BITS, SNR = 32, 16, 2, 10.0
N_TRAIN, N_VAL = 20_000, 2_000
SEGMENTS, ITERS_PER_SEGMENT = 5, 8
CKPT_DIR = os.path.join(tempfile.gettempdir(), "qce_torch_segmented_ckpt")


class SegmentCheckpointer:
    """The checkpointer `fit_segmented` takes, over a `TrainCheckpointer`:
    each segment's `GmmFitResult` as one step of tensors (parameters,
    lower bound, spectrum, iteration count, convergence), its lower-bound
    history in `lb_history_<step>.json` beside it."""

    def __init__(self, directory: str):
        self.ck = TrainCheckpointer(directory, max_to_keep=None)
        self.directory = self.ck.directory

    @staticmethod
    def _tensors(res: gmm.GmmFitResult) -> dict:
        return {"params": tuple(res.params), "lower_bound": res.lower_bound,
                "spectrum": res.spectrum,
                "n_iter": torch.tensor(int(res.n_iter)),
                "converged": torch.tensor(bool(res.converged))}

    def _history(self, step: int) -> str:
        return os.path.join(self.directory, f"lb_history_{int(step)}.json")

    def latest_step(self):
        return self.ck.latest_step()

    def save(self, step: int, res: gmm.GmmFitResult) -> None:
        with open(self._history(step), "w") as f:
            json.dump([float(v) for v in res.lb_history], f)
        self.ck.save(step, self._tensors(res), force=True)

    def restore(self, step: int, example: gmm.GmmFitResult):
        saved = self.ck.restore(step, self._tensors(example))
        with open(self._history(step)) as f:
            history = json.load(f)
        return gmm.GmmFitResult(
            gmm.GmmParams(*saved["params"]), saved["lower_bound"],
            int(saved["n_iter"]), bool(saved["converged"]), history,
            saved["spectrum"])


def data(device, n_ant=N_ANT, n_train=N_TRAIN, n_val=N_VAL):
    """(h_train, h_val)."""
    h_train, _ = scm.generate_channels(generator(0, device), n_train,
                                       scm.ScmConfig(n_ant, 1))
    h_val, _ = scm.generate_channels(generator(1, device), n_val,
                                     scm.ScmConfig(n_ant, 1))
    return h_train, h_val


def fit(h_train, ckpt_dir=CKPT_DIR, k=K, segments=SEGMENTS,
        iters=ITERS_PER_SEGMENT):
    """The Toeplitz fit as `segments` segments of `iters` EM iterations
    (tol 0: every segment runs its budget), checkpointed after each under
    `ckpt_dir`, resumed after the last checkpointed segment there.
    Returns (fit, the segment it resumed after or None)."""
    cfg = gmm.GmmConfig(n_components=k, cov_type="toeplitz", zero_mean=True,
                        max_iter=iters, tol=0.0)

    def start():
        return stages.gmm_fit(generator(2, h_train.device), h_train, cfg)

    def resume(prev):
        return stages.gmm_fit_resume(prev.params, h_train, cfg,
                                     spectrum=prev.spectrum)

    ck = SegmentCheckpointer(ckpt_dir)
    done = ck.latest_step()
    example = None
    if done is not None:
        print(f"resuming after checkpointed segment {done}")
        # a result of the checkpoint's structure, shapes and device: one
        # EM iteration on a small slice (fit_segmented reads only its
        # structure)
        example = stages.gmm_fit(
            generator(2, h_train.device), h_train[:max(64, 4 * k)],
            cfg._replace(max_iter=1))
    res = em_driver.fit_segmented(start, resume, segments, checkpointer=ck,
                                  example_result=example)
    return res, done


def evaluate(params, h_val, n_bits=N_BITS) -> float:
    """NMSE of the fitted bank at SNR on fresh observations."""
    dev = h_val.device
    a = pilots.pilot_matrix(h_val.shape[-1], 1, n_bits, device=dev)
    q = Q.design_quantizer(SNR, n_bits, device=dev)
    r_val = observation.observe(generator(3, dev), h_val, SNR, a, n_bits, q)
    bank = gmm_estimator.prepare_bank(params, SNR, a, n_bits, q)
    return stages.nmse(gmm_estimator.estimate(bank, r_val, "all"), h_val)


def main(device=None, ckpt_dir=CKPT_DIR, n_ant=N_ANT, k=K, n_train=N_TRAIN,
         n_val=N_VAL, segments=SEGMENTS, iters=ITERS_PER_SEGMENT) -> dict:
    device = stages.resolve_device(device)
    h_train, h_val = data(device, n_ant, n_train, n_val)
    res, resumed = fit(h_train, ckpt_dir, k, segments, iters)
    print(f"fit complete: {int(res.n_iter)} total EM iterations, "
          f"lower bound {float(res.lower_bound):.3f}")
    nmse = evaluate(res.params, h_val)
    print(f"toeplitz-GMM NMSE @ {SNR:.0f} dB, {N_BITS} bits: {nmse:.4f}")
    return {"resumed_after": resumed, "n_iter": int(res.n_iter),
            "lower_bound": float(res.lower_bound),
            "lb_history": [float(v) for v in res.lb_history],
            "params": res.params, "nmse": nmse}


def cut_and_resume(device=None, root=None, cut_after=2, **sizes) -> dict:
    """The claim's three runs under `root` (by default a temporary
    directory): one cut after `cut_after` segments, the same directory run
    again to the full `segments`, and an uninterrupted run in a directory
    of its own. Returns their `main` results."""
    with tempfile.TemporaryDirectory() as tmp:
        root = root or tmp
        cut = main(device, os.path.join(root, "cut"),
                   **{**sizes, "segments": cut_after})
        resumed = main(device, os.path.join(root, "cut"), **sizes)
        whole = main(device, os.path.join(root, "whole"), **sizes)
    return {"cut_after": cut_after, "cut": cut, "resumed": resumed,
            "whole": whole}


def check(runs: dict) -> None:
    """The example's claim on `cut_and_resume`'s runs: the second run
    resumed after the cut run's last segment, and it ends bit for bit where
    the uninterrupted run ends (iterations, lower bound and its history,
    every parameter)."""
    resumed, whole = runs["resumed"], runs["whole"]
    claim(resumed["resumed_after"] == runs["cut_after"] - 1
          and whole["resumed_after"] is None,
          f"resumed after {resumed['resumed_after']}")
    claim(resumed["n_iter"] == whole["n_iter"]
          and resumed["lower_bound"] == whole["lower_bound"]
          and resumed["lb_history"] == whole["lb_history"],
          f"lower bound {resumed['lower_bound']} after {resumed['n_iter']} "
          f"iterations, uninterrupted {whole['lower_bound']} after "
          f"{whole['n_iter']}")
    claim(all(torch.equal(x, y) for x, y in zip(resumed["params"],
                                                 whole["params"])),
          "the resumed parameters differ from the uninterrupted run's")


if __name__ == "__main__":
    cli(main, __doc__)
