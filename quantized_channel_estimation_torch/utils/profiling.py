"""Tracing, timing and throughput counters (port of
`quantized_channel_estimation_tpu/utils/profiling.py`).

- `trace(dir)`: a `torch.profiler` trace of the enclosed block, written to
  `dir/trace.json` (Chrome trace format); the profiler is yielded so the
  caller can read `key_averages()`.
- `Timer` / `throughput`: wall-clock counters with real completion
  barriers (`force_completion`: `torch.cuda.synchronize()` on the card,
  then a read-back of every tensor).
- `device_ms`: CUDA-event time of one call on the card.
- `bound_ms`: the least time an H100 could take for given operations and
  bytes, from the card's published peaks.
- `no_implicit_transfers()`: `torch.cuda.set_sync_debug_mode("error")` in
  the enclosed block, so any operation that synchronises the host with the
  card (a read-back such as `.item()`, `.cpu()` or `float(t)`, a
  data-dependent shape) raises. It is the nearest analog of JAX's transfer
  guard, and stricter: explicit read-backs, which the guard allows, raise
  too. Without a card there is nothing to transfer and it guards nothing.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch


# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12     # tensor cores
PEAK_HBM_BYTES = 3.35e12


def bound_ms(fp32_flops: float, tc_flops: float, nbytes: float):
    """(ms, 'operations' or 'bytes'): the larger of the operations' time
    (fp32 operations at the fp32 peak plus bf16 tensor-core operations at
    theirs) and the bytes' time at the memory rate."""
    ops_s = fp32_flops / PEAK_FP32_FLOPS + tc_flops / PEAK_BF16_FLOPS
    bytes_s = nbytes / PEAK_HBM_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA where there is a card) and
    write the Chrome trace to `log_dir/trace.json` on exit; yields the
    `torch.profiler.profile`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def no_implicit_transfers():
    """Raise on any host-device synchronisation in the enclosed block (see
    the module docstring); the previous mode is restored on exit."""
    if not torch.cuda.is_available():
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def force_completion(tree) -> float:
    """Completion barrier: synchronise the card when a tensor of `tree` (a
    tensor, or nested lists, tuples and dicts of them) lies on one, then
    read every tensor back as the sum of its absolute values; returns the
    total."""
    leaves = list(_leaves(tree))
    if any(x.is_cuda for x in leaves):
        torch.cuda.synchronize()
    return sum(float(x.abs().sum()) for x in leaves)


def device_ms(fn, reps: int = 5) -> float:
    """Median over `reps` of one call of fn timed with CUDA events, after
    one warm-up call. Needs a card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


@dataclass
class Timer:
    """Named wall-clock sections with per-section totals."""
    sections: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, barrier_tree=None):
        """Time the block; with `barrier_tree` the section ends only once
        its tensors are complete (`force_completion`)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if barrier_tree is not None:
                force_completion(barrier_tree)
            dt = time.perf_counter() - t0
            self.sections[name] = self.sections.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s ({self.counts[k]}x)"
                 for k, v in sorted(self.sections.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)


def throughput(fn, inputs: List, unit_count: int, warmup: int = 1) -> float:
    """Units a second of fn over a list of inputs, each call completed
    (`force_completion`) before the next."""
    for _ in range(warmup):
        force_completion(fn(inputs[0]))
    t0 = time.perf_counter()
    for x in inputs:
        force_completion(fn(x))
    dt = time.perf_counter() - t0
    return unit_count * len(inputs) / dt
