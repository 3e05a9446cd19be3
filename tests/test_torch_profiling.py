"""The port's `utils/profiling` on the CPU: `Timer` sections and their
completion barrier, `force_completion` against JAX's, `throughput`,
`trace` (a Chrome trace on disk and the profiler's table), and
`no_implicit_transfers` (the sync-debug mode set in the block and restored
after it; without a card nothing to guard)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.utils import profiling as jprof
from quantized_channel_estimation_torch.utils import profiling as tprof

torch.set_num_threads(2)


def test_timer_sections_accumulate_and_report():
    timer = tprof.Timer()
    x = torch.ones(4, 4)
    for _ in range(2):
        with timer.section("mm", barrier_tree=[x @ x]):
            pass
    with timer.section("idle"):
        pass
    assert timer.counts == {"mm": 2, "idle": 1}
    assert all(v >= 0.0 for v in timer.sections.values())
    lines = timer.report().splitlines()
    assert len(lines) == 2 and "(2x)" in "".join(lines)


def test_timer_section_records_a_failing_block():
    timer = tprof.Timer()
    with pytest.raises(KeyError):
        with timer.section("boom"):
            raise KeyError("x")
    assert timer.counts == {"boom": 1}


def test_force_completion_matches_jax():
    """The sum of |leaf| over a nested tree, as JAX's readback barrier
    returns it (complex leaves by modulus)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    c = (rng.standard_normal(4) + 1j * rng.standard_normal(4)).astype(
        np.complex64)
    want = jprof.force_completion({"a": jnp.asarray(a),
                                   "b": [jnp.asarray(c)]})
    got = tprof.force_completion({"a": torch.as_tensor(a),
                                  "b": [torch.as_tensor(c)], "n": None})
    assert got == pytest.approx(want, rel=1e-6)
    assert tprof.force_completion([]) == 0.0


def test_throughput_counts_units_per_second():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.ones(8) * x

    rate = tprof.throughput(fn, [1.0, 2.0, 3.0], unit_count=100)
    assert rate > 0 and len(calls) == 4      # one warm-up, then each input


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "t")) as prof:
        y = x @ x
    assert y.shape == (64, 64)
    keys = [e.key for e in prof.key_averages()]
    assert any("mm" in k for k in keys), keys
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert events["traceEvents"]


def test_no_implicit_transfers_without_a_card_guards_nothing():
    with tprof.no_implicit_transfers():
        assert float(torch.ones(3).sum()) == 3.0


def test_no_implicit_transfers_sets_and_restores_sync_debug_mode(
        monkeypatch):
    """With a card, the block runs in sync-debug mode "error" and the
    previous mode comes back afterwards, also when the block raises."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with tprof.no_implicit_transfers():
        assert modes[-1] == "error"
    assert modes[-1] == 0
    with pytest.raises(RuntimeError):
        with tprof.no_implicit_transfers():
            raise RuntimeError("synchronised")
    assert modes == [0, "error", 0, "error", 0]
