"""The port's `run_gmm` against the JAX harness on shared data, and the
port's boundaries: no JAX imports, no silent CPU fallback.

Both harnesses read one cache: the JAX run writes the channel dataset and
the fitted GMM with its own `utils.io`, and the port reads them; the port's
observation stage is replaced by the JAX observations made with the JAX
run's own keys. Both then write the same CSV columns, and every MSE and
rate row agrees to rtol 1e-4 (complex64 data, float32 sums in another
order; the 'all'-mode GMM estimate goes through the plain K1 here and the
einsum estimator in JAX).

The mesh options (`n_data_shards`, `n_component_shards`) run in one
2-rank Gloo group spawned for this file (tests/_torch_parallel_worker.py);
their rows equal the single-device run's to rtol 1e-4.
"""
import ast
import csv
import dataclasses
import glob
import os
import sys
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
sys.path.insert(0, str(REPO / "tests"))
import _torch_parallel_worker as worker  # noqa: E402


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


def _structured_runs_match_jax(tmp_path, monkeypatch, t_coh, n_pilots=1,
                               **change):
    """Both harnesses on one cache and the JAX observations, the GMM
    columns through their FFT-domain banks: the same CSV names and columns,
    rows to rtol 1e-4 as in the dense test above. Returns the port's MSE
    table."""
    cache = str(tmp_path / "saves")
    coh = dict(n_coherence=2, coherence_alpha=0.5) if t_coh > 1 else {}
    jcfg = jrun.GmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        snrs=(-10, 0, 10), results_dir=str(tmp_path / "jax"),
        cache_dir=cache, gmm_max_iter=15, n_pilots=n_pilots, **change, **coh)
    jmse, jrate, _ = jrun.run(jcfg, verbose=False)
    assert any(jcfg.cov_type in f for f in os.listdir(cache))

    data = np.load(glob.glob(os.path.join(cache, "saved_data*"))[0])
    h_val = jst.from_numpy(data["channels"][jcfg.n_train // t_coh:])
    a = jst.pilot_matrix(16, n_pilots, 2, "angle_amp")
    k_obs = jax.random.split(jax.random.PRNGKey(jcfg.seed), 3)[2]
    r_jax = {snr: jst.to_numpy(jst.observe(
        jax.random.fold_in(k_obs, i), h_val, snr, a, 2,
        jq.design_quantizer(snr, 2))) for i, snr in enumerate(jcfg.snrs)}

    def shared_observe(gen, h, snr, a, n_bits, q):
        assert tuple(h.shape[:-1]) == r_jax[snr].shape[:-1]
        assert r_jax[snr].shape[-1] == n_pilots * h.shape[-1]
        return torch.as_tensor(r_jax[snr], device=h.device)

    monkeypatch.setattr(tst, "observe", shared_observe)
    tcfg = trun.GmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(trun.GmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    calls = []
    for name in ("estimate_circulant", "estimate_circulant_coherent"):
        def counted(*args, _fn=getattr(tst, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(tst, name, counted)
    tmse, trate, _ = trun.run(tcfg, verbose=False, device="cpu")
    assert calls.count("estimate_circulant") == 3
    assert calls.count("estimate_circulant_coherent") == 3 * (t_coh > 1)

    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    assert ("blmmse_gmm_coh" in tmse) == (t_coh > 1)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    for rate in (False, True):
        jname, jrows = _read_csv(jcfg.results_dir, rate)
        tname, trows = _read_csv(tcfg.results_dir, rate)
        assert tname[19:] == jname[19:]
        assert f"_pilots={n_pilots}_" in tname
        assert f"_{jcfg.cov_type}" in tname
        assert trows[0] == jrows[0]
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                                   np.asarray(jrows[1:])[:, 1:].astype(float),
                                   rtol=1e-4)
    return tmse


@pytest.mark.parametrize("t_coh", [1, 2])
def test_run_gmm_circulant_matches_jax_on_shared_cache(tmp_path, monkeypatch,
                                                       t_coh):
    """`cov_type='circulant'`: both harnesses route the GMM columns through
    their FFT-domain bank (`use_structured_bank='auto'`), JAX through its
    `torch.fft`-like pipeline and the port through the plain K6 (and, with
    coherence blocks of T = 2 at alpha 0.5, the plain K7)."""
    tmse = _structured_runs_match_jax(tmp_path, monkeypatch, t_coh,
                                      cov_type="circulant")
    assert tmse["blmmse_genie"][-1] < tmse["blmmse_gmm"][-1] \
        < tmse["LS_glob"][-1]


@pytest.mark.parametrize("t_coh,n_pilots,change", [
    (1, 2, dict(cov_type="circulant")),
    (2, 2, dict(cov_type="circulant")),
    (1, 4, dict(use_structured_bank=True)),
])
def test_run_gmm_multipilot_structured_matches_jax_on_shared_cache(
        tmp_path, monkeypatch, t_coh, n_pilots, change):
    """`n_pilots > 1` with a structured bank: both harnesses prepare the
    per-bin P x P bank (`CirculantBankMP`), JAX estimating through its
    pipeline and the port through the plain K10 (with coherence blocks of
    T = 2 at alpha 0.5 its coherent form); `use_structured_bank=True` does
    so for a full-covariance fit through its circulant approximation."""
    banks = []

    def counted(*args, _fn=tst.prepare_bank_circulant, **kw):
        banks.append(_fn(*args, **kw))
        return banks[-1]

    monkeypatch.setattr(tst, "prepare_bank_circulant", counted)
    tmse = _structured_runs_match_jax(tmp_path, monkeypatch, t_coh, n_pilots,
                                      **change)
    assert len(banks) == 3
    for bank in banks:
        assert bank.mean_rf.shape == (8, 16, n_pilots)
    # the invariants at 0 dB: at 10 dB the Bussgang baselines of both
    # packages lose their order under several pilots (the rows above agree)
    assert tmse["blmmse_genie"][1] < tmse["blmmse_gmm"][1] \
        < tmse["LS_glob"][1]


@pytest.mark.parametrize("change,structured", [
    (dict(cov_type="full", use_structured_bank=True), True),
    (dict(cov_type="circulant", use_structured_bank=False), False),
    (dict(cov_type="block-circulant", blocks=(2, 4)), True),
    (dict(cov_type="diag"), False),
    (dict(cov_type="circulant", n_summands_or_proba=2), True),
    (dict(cov_type="circulant", n_coherence=4, coherence_alpha="auto",
          alpha_val_blocks=50), True),
])
def test_run_gmm_structured_bank_options(tmp_path, monkeypatch, change,
                                         structured):
    """`use_structured_bank` 'auto' / True / False over the fits: which
    bank the GMM columns estimate through, and a finite, falling table."""
    banks = []
    for name in ("prepare_bank", "prepare_bank_circulant"):
        def counted(*args, _fn=getattr(tst, name), _name=name, **kw):
            banks.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(tst, name, counted)
    cfg = trun.GmmBenchConfig(
        n_antennas=8, n_components=4, n_train=2000, n_val=400,
        snrs=(-10, 10), results_dir=str(tmp_path),
        cache_dir=str(tmp_path / "c"), gmm_max_iter=10, eval_rate=False,
        **change)
    assert trun._structured(cfg) == structured
    mse, _, timings = trun.run(cfg, verbose=False, device="cpu")
    assert set(banks) == {"prepare_bank_circulant" if structured
                          else "prepare_bank"} and len(banks) == 2
    for vals in mse.values():
        assert np.all(np.isfinite(vals)) and vals[0] > vals[-1]
    assert any(cfg.cov_type in f for f in os.listdir(tmp_path / "c"))
    if cfg.coherence_alpha == "auto":
        assert set(timings["coherence_alpha_by_snr"]) == {-10, 10}
        assert mse["blmmse_gmm_coh"][0] < mse["blmmse_gmm"][0]


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


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The sharded `run_gmm` / `run_mfa` runs of `worker.HARNESS` in one
    2-rank Gloo group (tests/_torch_parallel_worker.py), with rank 0's
    single-device run of each; a hang fails at the timeout."""
    root = tmp_path_factory.mktemp("gloo2_harness")
    try:
        return worker.spawn_group(root, "harness", 300), root
    except RuntimeError as err:
        pytest.fail(str(err))


def _sharded_rows_match(sharded_runs, name):
    """Both ranks' MSE and rate rows of the sharded run `name` equal the
    single-device run's to rtol 1e-4 (float32 sums in another order);
    rank 0 alone wrote the tables."""
    res, root = sharded_runs
    mse1, rate1 = res[0][f"harness1/{name}"]
    for rank in range(2):
        mse, rate = res[rank][f"harness/{name}"]
        assert mse.keys() == mse1.keys() and rate.keys() == rate1.keys()
        for col in mse1:
            np.testing.assert_allclose(mse[col], mse1[col], rtol=1e-4,
                                       err_msg=col)
        for col in rate1:
            np.testing.assert_allclose(rate[col], rate1[col], rtol=1e-4,
                                       err_msg=col)
    assert len(os.listdir(root / name / "rank0" / "3gpp")) >= 1
    assert not (root / name / "rank1" / "3gpp").exists()


@pytest.mark.parametrize("name", sorted(worker.HARNESS))
def test_sharded_harness_rows_match_the_single_device_run(sharded_runs,
                                                          name):
    _sharded_rows_match(sharded_runs, name)


@pytest.mark.parametrize("change,item", [
    (dict(channel_model="mimo"), "item 14"),
    (dict(cov_type="toeplitz"), "Queue 1 item 8"),
    (dict(n_data_shards=2), "item 15"),
    (dict(gmm_fit_segments=2), "item 8"),
    (dict(cov_type="block-toeplitz", blocks=(8, 8)), "Queue 1 item 8"),
])
def test_unported_options_raise(change, item, request):
    """Options of later slices raise naming their ROADMAP item. Item 15
    (mesh parallelism) is ported: its case holds the 2-rank run's rows
    against the single-device run's instead."""
    if item == "item 15":
        _sharded_rows_match(request.getfixturevalue("sharded_runs"),
                            "gmm_data2")
        return
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
        "*.py")) + [REPO / "chip_smoke.py",
                    REPO / "tests" / "test_torch_cuda.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "quantized_channel_estimation_tpu"), \
                (path, name)


# ---------------------------------------------------------------------------
# run_mfa
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coh", [{}, dict(n_coherence=4,
                                          coherence_alpha=0.25)])
def test_run_mfa_matches_jax_on_shared_cache(tmp_path, monkeypatch, coh):
    """Both MFA harnesses on one cache (the JAX run writes the data set),
    the JAX fit carried across (`mfa.params_from_numpy` in place of the
    port's `stages.mfa_fit`) and the JAX observations in place of the
    port's `stages.observe`: the same CSV name and columns, every MSE and
    rate row to rtol 1e-4, the factored bank estimating through the plain
    K11 (and K12 for the coherent column)."""
    from quantized_channel_estimation_tpu.harness import run_mfa as jrun_mfa
    from quantized_channel_estimation_torch.harness import run_mfa as trun_mfa
    from quantized_channel_estimation_torch.models import mfa as tmfa

    fits, observed = [], {}

    def jax_fit(*args, _fn=jst.mfa_fit):
        fits.append(_fn(*args))
        return fits[-1]

    def jax_observe(key, h, snr, *args, _fn=jst.observe):
        r = _fn(key, h, snr, *args)
        observed[(snr, tuple(h.shape))] = np.asarray(jst.to_numpy(r))
        return r

    monkeypatch.setattr(jst, "mfa_fit", jax_fit)
    monkeypatch.setattr(jst, "observe", jax_observe)
    jcfg = jrun_mfa.MfaBenchConfig(
        n_antennas=16, n_components=8, latent_dim=4, n_train=4000,
        n_val=600, max_iter=10, snrs=(-10, 0, 10),
        results_dir=str(tmp_path / "jax"), cache_dir=str(tmp_path / "saves"),
        **coh)
    jmse, jrate, _ = jrun_mfa.run(jcfg, verbose=False)
    assert len(fits) == 1 and len(observed) == 3

    jfit = fits[0]

    def shared_fit(gen, h, cfg):
        assert tuple(h.shape) == (jcfg.n_train, 16)
        return tmfa.MfaFitResult(
            tmfa.params_from_numpy([np.asarray(jst.to_numpy(x))
                                    for x in jfit.params], h.device),
            torch.tensor(float(jfit.log_likelihood)), int(jfit.n_iter),
            bool(jfit.converged))

    def shared_observe(gen, h, snr, a, n_bits, q):
        return torch.as_tensor(observed[(snr, tuple(h.shape))],
                               device=h.device)

    calls = []
    for name in ("estimate_factored", "estimate_factored_coherent"):
        def counted(*args, _fn=getattr(tst, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(tst, name, counted)
    monkeypatch.setattr(tst, "mfa_fit", shared_fit)
    monkeypatch.setattr(tst, "observe", shared_observe)
    tcfg = trun_mfa.MfaBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(trun_mfa.MfaBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    tmse, trate, _ = trun_mfa.run(tcfg, verbose=False, device="cpu")
    assert calls.count("estimate_factored") == 3
    assert calls.count("estimate_factored_coherent") == (3 if coh else 0)

    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    jname, jrows = _read_csv(jcfg.results_dir, False)
    tname, trows = _read_csv(tcfg.results_dir, False)
    assert tname[19:] == jname[19:]
    assert trows[0] == jrows[0]
    np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                               np.asarray(jrows[1:])[:, 1:].astype(float),
                               rtol=1e-4)
    assert tmse["blmmse_mfa"][0] > tmse["blmmse_mfa"][-1]


def test_run_mfa_factored_matches_densified(tmp_path):
    """`use_factored_bank` 'auto' (the factored bank, plain K11 / K12) and
    False (the densified fit through the dense bank, plain K1 / K3) give
    the same MSE columns to 1e-3, from the same fit; 'auto' alpha selection
    runs on held-out blocks; True with 1 bit is refused."""
    from quantized_channel_estimation_torch.harness import run_mfa as trun_mfa

    cfg = trun_mfa.MfaBenchConfig(
        n_antennas=16, n_components=8, latent_dim=4, n_train=4000,
        n_val=600, max_iter=10, snrs=(-10, 0, 10), n_coherence=4,
        coherence_alpha=0.25, results_dir=str(tmp_path),
        cache_dir=str(tmp_path / "c"))
    assert trun_mfa._factored(cfg)
    mse_f, _, t_f = trun_mfa.run(cfg, verbose=False, device="cpu")
    dense = dataclasses.replace(cfg, use_factored_bank=False)
    assert not trun_mfa._factored(dense)
    mse_d, _, t_d = trun_mfa.run(dense, verbose=False, device="cpu")
    assert t_f["mfa_iters"] == t_d["mfa_iters"]
    for col in ("blmmse_mfa", "blmmse_mfa_coh"):
        for vf, vd in zip(mse_f[col], mse_d[col]):
            assert abs(vf - vd) / vd < 1e-3, (col, mse_f[col], mse_d[col])
    assert mse_f["blmmse_mfa"][0] > mse_f["blmmse_mfa"][-1]
    auto, _, timings = trun_mfa.run(
        dataclasses.replace(cfg, coherence_alpha="auto", alpha_val_blocks=50,
                            eval_rate=False), verbose=False, device="cpu")
    assert set(timings["coherence_alpha_by_snr"]) == {-10, 0, 10}
    assert all(np.isfinite(v).all() for v in auto.values())
    with pytest.raises(ValueError, match="1-bit"):
        trun_mfa.run(dataclasses.replace(cfg, use_factored_bank=True,
                                         n_bits=1), device="cpu")
    with pytest.raises(ValueError, match="multiples of n_coherence"):
        trun_mfa.run(dataclasses.replace(cfg, n_coherence=3), device="cpu")


@pytest.mark.parametrize("change,item", [
    (dict(channel_model="mimo"), "item 14"),
    (dict(n_data_shards=2), "item 15"),
    (dict(n_component_shards=2), "item 15"),
])
def test_run_mfa_unported_options_raise(change, item, request):
    """As `test_unported_options_raise`: the mesh options' cases hold the
    2-rank runs' rows against the single-device run's."""
    if item == "item 15":
        name = ("mfa_data2" if change.get("n_data_shards", 1) > 1
                else "mfa_comp2")
        _sharded_rows_match(request.getfixturevalue("sharded_runs"), name)
        return
    from quantized_channel_estimation_torch.harness import run_mfa as trun_mfa
    cfg = dataclasses.replace(trun_mfa.MfaBenchConfig(), **change)
    with pytest.raises(NotImplementedError, match=item):
        trun_mfa.run(cfg, device="cpu")


@pytest.mark.parametrize("runner,change", [
    ("gmm", dict(n_data_shards=2)),
    ("gmm", dict(n_component_shards=2)),
    ("mfa", dict(n_data_shards=2)),
    ("mfa", dict(n_component_shards=4)),
])
def test_sharded_options_need_a_group_of_that_size(runner, change):
    """The mesh options run over the ranks of an initialised
    torch.distributed group (their rows against the single-device run:
    tests/test_torch_parallel.py); outside one they refuse before any
    work, naming torchrun."""
    from quantized_channel_estimation_torch.harness import run_mfa as trun_mfa
    mod = trun if runner == "gmm" else trun_mfa
    config = trun.GmmBenchConfig if runner == "gmm" \
        else trun_mfa.MfaBenchConfig
    with pytest.raises(ValueError, match="torchrun"):
        mod.run(dataclasses.replace(config(), **change), device="cpu")


def test_run_mfa_raises_without_cuda(monkeypatch):
    from quantized_channel_estimation_torch.harness import run_mfa as trun_mfa
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun_mfa.run(trun_mfa.MfaBenchConfig(n_antennas=4, n_components=2))
