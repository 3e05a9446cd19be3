"""Segmented EM: a long fit run as several bounded segments.

Port of `quantized_channel_estimation_tpu/models/em_driver.py`:
`fit_segmented` and `_as_scalar`. A fit is cut at segment boundaries,
where the state between segments is the model's own parameters, so a run
can be checkpointed after every segment and resumed in another process.
`gmm.fit_resume` makes the restart exact, for Toeplitz fits too when it is
given the previous result's inverse-EM spectrum (as `harness.run_gmm`
does; without it the spectrum is recovered from the saved covariances, as
JAX does, and the lower bound steps back for a few iterations).

    cfg_seg = cfg._replace(max_iter=25)          # the per-segment budget
    res = fit_segmented(
        lambda: gmm.fit(gen, h, cfg_seg),
        lambda prev: gmm.fit_resume(prev.params, h, cfg_seg,
                                    spectrum=prev.spectrum),
        n_segments=8)

Retries: JAX's `fit_segmented` retries `jax.errors.JaxRuntimeError`, which
a remote TPU runtime raises when it drops a compile. Nothing in this package
fails that way, and a failed CUDA launch must stop the run, so
`max_retries` retries only `TransientSegmentError`, which a caller's own
segment function raises to declare a failure safe to repeat; no CUDA,
kernel or programming error is ever caught.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

__all__ = ["TransientSegmentError", "fit_segmented"]


class TransientSegmentError(RuntimeError):
    """A segment failure that its segment function declares transient: the
    only error `fit_segmented` retries. Nothing in this package raises it."""


def fit_segmented(start_fn: Callable[[], Any],
                  resume_fn: Callable[[Any], Any],
                  n_segments: int,
                  checkpointer: Optional[Any] = None,
                  example_result: Optional[Any] = None,
                  max_retries: int = 0):
    """Run EM as up to `n_segments` bounded segments; stop on convergence.

    start_fn() runs the first segment, resume_fn(prev_result) each later
    one. A result is a fit-result NamedTuple with `converged` and `n_iter`
    fields (`gmm.GmmFitResult`); the per-segment iteration budget is the
    closed-over cfg's max_iter.

    With a `checkpointer` (any object with `latest_step()`, `save(step,
    result)` and `restore(step, example_result)`), every segment's result
    is saved at step = segment index, and a rerun against the same store
    resumes after the latest saved segment instead of refitting; a restore
    needs `example_result` (a result of the same structure) and raises
    without one rather than refit from scratch. A restored result that has
    converged is returned as it is.

    `max_retries` > 0 reruns a segment that raised `TransientSegmentError`
    (segments are pure functions of the previous result, so a rerun is
    exact); every other error propagates at once.

    Returns the last result with `n_iter` the total over every segment run
    here and restored, and `lb_history`, where the result has one, the
    lower bounds of all those segments in order."""
    seg0 = 0
    result = None
    total_iter = 0
    if checkpointer is not None:
        last = checkpointer.latest_step()
        if last is not None:
            if example_result is None:
                raise ValueError(
                    "checkpointer has saved segments but no example_result "
                    "was given to restore them; refusing to refit from "
                    "scratch")
            result = checkpointer.restore(last, example_result)
            seg0 = last + 1
            total_iter = int(result.n_iter)
            if bool(result.converged):
                # a converged run is done: more segments would only burn
                # iterations on it
                return result

    for seg in range(seg0, n_segments):
        for attempt in range(max_retries + 1):
            try:
                step = start_fn() if result is None else resume_fn(result)
                step_iters = int(step.n_iter)
                break
            except TransientSegmentError:
                if attempt == max_retries:
                    raise
        if result is not None and hasattr(step, "lb_history"):
            step = step._replace(
                lb_history=list(result.lb_history) + list(step.lb_history))
        total_iter += step_iters
        result = step._replace(n_iter=_as_scalar(step, total_iter))
        if checkpointer is not None:
            checkpointer.save(seg, result)
        if bool(result.converged):
            break
    if result is None:
        raise ValueError("n_segments must be >= 1")
    return result


def _as_scalar(result, value: int):
    """An n_iter of the result's own type: a tensor of its dtype and device,
    or a Python int."""
    n_iter = result.n_iter
    if isinstance(n_iter, torch.Tensor):
        return torch.tensor(value, dtype=n_iter.dtype, device=n_iter.device)
    return int(value)
