"""Training checkpoints: step-numbered, atomic, retention-managed, resumable.

Port of `quantized_channel_estimation_tpu/utils/checkpoint.py`. The JAX
package builds this on Orbax; here each checkpoint is one `torch.save` file
`torch_step_<step>.pt` in the directory, written under a temporary name and
committed with `os.replace`, so a reader sees a whole checkpoint or none.
Orbax's other guarantees are kept: `max_to_keep` retention (the oldest
steps are deleted after each commit), `latest_step()`, `restore(step,
example)` onto the example's devices, `wait`, `close` and use as a context
manager. Saves are synchronous, so `wait` has nothing to wait for.

A state is any tree of tensors (dicts, lists, tuples and NamedTuples of
them, the VAE's `VaeTrainState` or a GMM's parameters). The file holds the
tree's leaves in order, so `torch.load(weights_only=True)` reads it, and
`restore` rebuilds the example's structure from them, checking every
leaf's shape and dtype.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^torch_step_(\d+)\.pt$")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"a checkpoint state holds tensors, dicts, lists and "
                    f"tuples; got {type(tree).__name__}")


def _rebuild(example, leaves):
    if isinstance(example, torch.Tensor):
        return next(leaves)
    if isinstance(example, dict):
        out = {k: _rebuild(example[k], leaves) for k in sorted(example)}
        return type(example)((k, out[k]) for k in example)
    items = [_rebuild(v, leaves) for v in example]
    if hasattr(example, "_fields"):   # NamedTuple
        return type(example)(*items)
    return type(example)(items)


class TrainCheckpointer:
    """Step-numbered checkpoints with retention, atomic commits, resume.

    save(epoch, state) records the state AFTER that epoch, so a resume
    continues at latest_step() + 1:
        ckpt = TrainCheckpointer(dir, max_to_keep=3)
        last = ckpt.latest_step()            # None if fresh
        state = ckpt.restore(last, state)    # no-op if last is None
        start = 0 if last is None else last + 1
        for epoch in range(start, epochs):
            ...
            ckpt.save(epoch, state)
        ckpt.close()
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"torch_step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Commit `state` at `step`. Returns whether a checkpoint was
        written: without `force` a step off the save interval, or one
        already committed, is skipped."""
        step = int(step)
        if not force and (step % self.save_interval_steps
                          or step in self.all_steps()):
            return False
        leaves = [x.detach().cpu() for x in _leaves(state)]
        tmp = os.path.join(self.directory,
                           f".torch_step_{step}.pt.tmp-{os.getpid()}")
        torch.save({"step": step, "leaves": leaves}, tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return True

    def restore(self, step: Optional[int], example: Any) -> Any:
        """The state saved at `step` (or `example` unchanged if step is
        None), shaped as `example`, each leaf on the example leaf's device,
        not the device it was saved from (a card's checkpoint restores on
        the CPU and the reverse)."""
        if step is None:
            return example
        saved = torch.load(self.path(step), map_location="cpu",
                           weights_only=True)["leaves"]
        want = _leaves(example)
        if len(saved) != len(want):
            raise ValueError(f"checkpoint step {step} holds {len(saved)} "
                             f"tensors; the example has {len(want)}")
        moved = []
        for got, ref in zip(saved, want):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint step {step}: a {got.dtype} {tuple(got.shape)}"
                    f" tensor where the example has {ref.dtype} "
                    f"{tuple(ref.shape)}")
            moved.append(got.to(ref.device))
        return _rebuild(example, iter(moved))

    def wait(self) -> None:
        """Saves commit before `save` returns: nothing in flight."""

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
