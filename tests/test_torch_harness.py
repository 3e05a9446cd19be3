"""The port's `run_gmm` against the JAX harness on shared data, and the
port's boundaries: no JAX imports, no silent CPU fallback.

Both harnesses read one cache: the JAX run writes the channel dataset and
the fitted GMM with its own `utils.io`, and the port reads them; the port's
observation stage is replaced by the JAX observations made with the JAX
run's own keys. Both then write the same CSV columns, and every MSE and
rate row agrees to rtol 1e-4 (complex64 data, float32 sums in another
order; the 'all'-mode GMM estimate goes through the plain K1 here and the
einsum estimator in JAX).
"""
import ast
import csv
import dataclasses
import glob
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.harness import run_gmm as jrun
from quantized_channel_estimation_tpu.harness import stages as jst
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.harness import run_gmm as trun
from quantized_channel_estimation_torch.harness import stages as tst

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _read_csv(results_dir, rate):
    paths = glob.glob(os.path.join(results_dir, "3gpp", "*.csv"))
    path = [p for p in paths if p.endswith("_rate.csv") == rate]
    assert len(path) == 1, paths
    with open(path[0]) as f:
        rows = list(csv.reader(f))
    return os.path.basename(path[0]), rows


def test_run_gmm_matches_jax_on_shared_cache(tmp_path, monkeypatch):
    cache = str(tmp_path / "saves")
    jcfg = jrun.GmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        snrs=(-5, 5, 15), results_dir=str(tmp_path / "jax"),
        cache_dir=cache, gmm_max_iter=15)
    jmse, jrate, _ = jrun.run(jcfg, verbose=False)
    assert len(os.listdir(cache)) == 2          # dataset + GMM written

    # the JAX observations, made with run()'s own keys
    data = np.load(glob.glob(os.path.join(cache, "saved_data*"))[0])
    h_val = jst.from_numpy(data["channels"][jcfg.n_train:])
    a = jst.pilot_matrix(16, 1, 2, "angle_amp")
    k_obs = jax.random.split(jax.random.PRNGKey(jcfg.seed), 3)[2]
    r_jax = {snr: jst.to_numpy(jst.observe(
        jax.random.fold_in(k_obs, i), h_val, snr, a, 2,
        jq.design_quantizer(snr, 2))) for i, snr in enumerate(jcfg.snrs)}

    def shared_observe(gen, h, snr, a, n_bits, q):
        return torch.as_tensor(r_jax[snr], device=h.device)

    monkeypatch.setattr(tst, "observe", shared_observe)
    tcfg = trun.GmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(trun.GmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    tmse, trate, _ = trun.run(tcfg, verbose=False, device="cpu")

    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    for rate in (False, True):
        jname, jrows = _read_csv(jcfg.results_dir, rate)
        tname, trows = _read_csv(tcfg.results_dir, rate)
        assert tname[19:] == jname[19:]          # same name after the stamp
        assert trows[0] == jrows[0]              # same header (columns)
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                                   np.asarray(jrows[1:])[:, 1:].astype(float),
                                   rtol=1e-4)
    # the scientific invariants at the top SNR
    assert tmse["blmmse_genie"][-1] < tmse["blmmse_gmm"][-1] \
        < tmse["blmmse_glob"][-1] < tmse["LS_glob"][-1]


def test_run_gmm_fits_and_caches_on_its_own(tmp_path):
    cfg = trun.GmmBenchConfig(
        n_antennas=8, n_components=4, n_train=2000, n_val=300,
        snrs=(-10, 10), results_dir=str(tmp_path), cache_dir=str(tmp_path /
                                                                 "c"),
        gmm_max_iter=10, eval_rate=False)
    mse, rate, timings = trun.run(cfg, verbose=False, device="cpu")
    assert rate == {} and "gmm_fit" in timings
    for vals in mse.values():
        assert np.all(np.isfinite(vals)) and vals[0] > vals[-1]
    assert len(os.listdir(tmp_path / "c")) == 2
    again, _, _ = trun.run(cfg, verbose=False, device="cpu")   # from cache
    np.testing.assert_allclose(again["blmmse_genie"], mse["blmmse_genie"])


@pytest.mark.parametrize("change,item", [
    (dict(channel_model="mimo"), "item 14"),
    (dict(n_coherence=4), "item 9"),
    (dict(n_data_shards=2), "item 15"),
    (dict(gmm_fit_segments=2), "item 8"),
    (dict(cov_type="circulant"), "item 11"),
])
def test_unported_options_raise(change, item):
    cfg = dataclasses.replace(trun.GmmBenchConfig(), **change)
    with pytest.raises(NotImplementedError, match=item):
        trun.run(cfg, device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run(trun.GmmBenchConfig(n_antennas=4, n_components=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.resolve_device()
    assert tst.resolve_device("cpu") == torch.device("cpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "quantized_channel_estimation_torch").rglob(
        "*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "quantized_channel_estimation_tpu"), \
                (path, name)
