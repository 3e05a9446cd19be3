"""The port's harnesses against the JAX harnesses on shared data, and the
port's boundaries: no JAX imports, no silent CPU fallback.

Both harnesses read one cache: the JAX run writes the channel dataset and
the fitted GMM with its own `utils.io`, and the port reads them; the port's
observation stage is replaced by the JAX observations made with the JAX
run's own keys. Both then write the same CSV columns, and every MSE and
rate row agrees to rtol 1e-4 (complex64 data, float32 sums in another
order; the 'all'-mode GMM estimate goes through the plain K1 here and the
einsum estimator in JAX).

The CSI-free harnesses `run_gmm_quant` and `run_cov_recovery` are held
the same way: on the JAX data set, observations and fit (carried across
by `gmm.quant_fit_from_numpy`), and on the JAX covariance draws and
samples. The options of later slices were pinned here as refusals naming
their ROADMAP item; each pin now holds the ported option (the other
channel models of item 14: `_channel_model_runs_match_jax`).

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


def _item8_runs_match_jax(tmp_path, monkeypatch, change):
    """A Toeplitz or segmented `run_gmm` (item 8) of both harnesses on one
    cache and the JAX observations: the same CSV names, columns and rows
    (rtol 1e-4) as `test_run_gmm_matches_jax_on_shared_cache`, the port
    estimating the JAX fit through the dense bank. Then the port fits the
    same config itself: each segment's budget (ceil(15 / S), the last
    capped at what is left), finite rows with genie < gmm < LS at the top
    SNR, and Toeplitz covariances for cov_type='toeplitz'."""
    cache = str(tmp_path / "saves")
    jcfg = jrun.GmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        snrs=(-5, 5, 15), results_dir=str(tmp_path / "jax"),
        cache_dir=cache, gmm_max_iter=15, **change)
    jmse, jrate, _ = jrun.run(jcfg, verbose=False)
    data = np.load(glob.glob(os.path.join(cache, "saved_data*"))[0])
    h_val = jst.from_numpy(data["channels"][jcfg.n_train:])
    a = jst.pilot_matrix(16, 1, 2, "angle_amp")
    k_obs = jax.random.split(jax.random.PRNGKey(jcfg.seed), 3)[2]
    r_jax = {snr: jst.to_numpy(jst.observe(
        jax.random.fold_in(k_obs, i), h_val, snr, a, 2,
        jq.design_quantizer(snr, 2))) for i, snr in enumerate(jcfg.snrs)}
    monkeypatch.setattr(tst, "observe", lambda gen, h, snr, a, n_bits, q:
                        torch.as_tensor(r_jax[snr], device=h.device))
    banks = []
    prepare = tst.prepare_bank
    monkeypatch.setattr(tst, "prepare_bank", lambda *args: banks.append(
        args) or prepare(*args))
    tcfg = trun.GmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(trun.GmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    assert not trun._structured(tcfg)
    tmse, trate, _ = trun.run(tcfg, verbose=False, device="cpu")
    assert len(banks) == 3
    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    for rate in (False, True):
        jname, jrows = _read_csv(jcfg.results_dir, rate)
        tname, trows = _read_csv(tcfg.results_dir, rate)
        assert tname[19:] == jname[19:] and f"_{jcfg.cov_type}" in tname
        assert trows[0] == jrows[0]
        np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                                   np.asarray(jrows[1:])[:, 1:].astype(float),
                                   rtol=1e-4)

    # the port's own fit of the same config
    gmm_path = glob.glob(os.path.join(cache, "*gmm*"))
    assert len(gmm_path) == 1
    os.remove(gmm_path[0])
    fits = []
    for name in ("gmm_fit", "gmm_fit_resume"):
        def counted(*args, _fn=getattr(tst, name), _name=name, **kw):
            fits.append((_name, args[2].max_iter, _fn(*args, **kw)))
            return fits[-1][2]
        monkeypatch.setattr(tst, name, counted)
    own, _, _ = trun.run(dataclasses.replace(
        tcfg, results_dir=str(tmp_path / "own"), eval_rate=False),
        verbose=False, device="cpu")
    segs = jcfg.gmm_fit_segments
    budgets = [15] if segs == 1 else [8, 7]
    assert [f[0] for f in fits] == ["gmm_fit"] + ["gmm_fit_resume"] * (
        len(fits) - 1)
    assert [f[1] for f in fits] == budgets[:len(fits)]
    assert len(fits) == len(budgets) or fits[-1][2].converged
    assert sum(f[2].n_iter for f in fits) <= 15
    for vals in own.values():
        assert np.all(np.isfinite(vals))
    assert own["blmmse_genie"][-1] < own["blmmse_gmm"][-1] \
        < own["LS_glob"][-1]
    if jcfg.cov_type == "toeplitz":
        covs = fits[-1][2].params.covariances
        for off in range(1, 5):
            diag = torch.diagonal(covs, offset=off, dim1=-2, dim2=-1)
            spread = (diag - diag.mean(-1, keepdim=True)).abs().amax(-1)
            assert torch.all(spread < 5e-2 * torch.diagonal(
                covs, dim1=-2, dim2=-1).abs().mean(-1))


def _channel_model_runs_match_jax(tmp_path, monkeypatch, **change):
    """`run_gmm` with another `channel_model` (item 14) in both harnesses
    on one cache (the JAX run writes the data set, for 'mimo' its npz of
    `channels`, `toep_bs`, `toep_ms`, and the fit) and the JAX
    observations: the same CSV names (with `_model=<tag>`) and columns,
    every MSE and rate row to rtol 1e-4, the 'mimo' genie column through
    `stages.blmmse_genie_kron`. 'mimo' runs 8 x 2 antennas (channel
    dimension 16), 'urban-macro' 16. Returns the port's MSE table."""
    model = change["channel_model"]
    mimo = model == "mimo"
    dims = dict(n_antennas=8, n_antennas_ms=2) if mimo else dict(
        n_antennas=16)
    observed = {}

    def jax_observe(key, h, snr, *args, _fn=jst.observe):
        r = _fn(key, h, snr, *args)
        observed[(snr, tuple(h.shape))] = np.asarray(jst.to_numpy(r))
        return r

    monkeypatch.setattr(jst, "observe", jax_observe)
    jcfg = jrun.GmmBenchConfig(
        n_components=8, n_path=2, n_train=4000, n_val=600, snrs=(-5, 5, 15),
        results_dir=str(tmp_path / "jax"), cache_dir=str(tmp_path / "saves"),
        gmm_max_iter=15, **dims, **change)
    jmse, jrate, _ = jrun.run(jcfg, verbose=False)
    data_file = glob.glob(os.path.join(jcfg.cache_dir, "saved_data*"))
    assert len(data_file) == 1 and f"_model={jrun._model_tag(jcfg)}_" \
        in data_file[0]
    if mimo:
        assert set(np.load(data_file[0]).files) == {"channels", "toep_bs",
                                                     "toep_ms"}

    monkeypatch.setattr(tst, "observe", lambda gen, h, snr, a, n_bits, q:
                        torch.as_tensor(observed[(snr, tuple(h.shape))]))
    genie = _spy(monkeypatch, tst, ["blmmse_genie", "blmmse_genie_kron"])
    tcfg = trun.GmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(trun.GmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    assert trun.channel_dim(tcfg) == jrun.channel_dim(jcfg) == 16
    assert trun._model_tag(tcfg) == jrun._model_tag(jcfg)
    tmse, trate, _ = trun.run(tcfg, verbose=False, device="cpu")
    assert genie == {"blmmse_genie": 0 if mimo else 3,
                     "blmmse_genie_kron": 3 if mimo else 0}
    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    for rate in (False, True):
        jname, jrows = _read_csv(jcfg.results_dir, rate)
        tname, trows = _read_csv(tcfg.results_dir, rate)
        assert tname[19:] == jname[19:]
        assert f"_ant=16_model={jrun._model_tag(jcfg)}_" in tname
        assert trows[0] == jrows[0]
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                                   np.asarray(jrows[1:])[:, 1:].astype(float),
                                   rtol=1e-4)
    assert tmse["blmmse_genie"][-1] < tmse["blmmse_gmm"][-1] \
        < tmse["LS_glob"][-1]
    return tmse


@pytest.mark.parametrize("change,item", [
    (dict(channel_model="mimo"), "item 14"),
    (dict(cov_type="toeplitz"), "Queue 1 item 8"),
    (dict(n_data_shards=2), "item 15"),
    (dict(gmm_fit_segments=2), "item 8"),
    (dict(cov_type="block-toeplitz", blocks=(4, 4)), "Queue 1 item 8"),
])
def test_unported_options_raise(change, item, request):
    """The options of later slices, each now ported and held: item 15
    (mesh parallelism) by the 2-rank run's rows against the single-device
    run's; item 8 (the Toeplitz fits and segmented fits) by the port's
    rows against the JAX harness's (`_item8_runs_match_jax`); item 14 (the
    other channel models) by the Kronecker-MIMO run with coherence blocks
    of T = 2 against the JAX harness's (`_channel_model_runs_match_jax`)."""
    if item == "item 15":
        _sharded_rows_match(request.getfixturevalue("sharded_runs"),
                            "gmm_data2")
        return
    tmp_path = request.getfixturevalue("tmp_path")
    monkeypatch = request.getfixturevalue("monkeypatch")
    if "item 8" in item:
        _item8_runs_match_jax(tmp_path, monkeypatch, change)
        return
    assert item == "item 14"
    _channel_model_runs_match_jax(tmp_path, monkeypatch, n_coherence=2,
                                  coherence_alpha=0.5, **change)


@pytest.mark.parametrize("change,error", [
    (dict(gmm_fit_segments=2, cov_type="circulant"),
     (NotImplementedError, "resumable cov_type")),
    (dict(gmm_fit_segments=2, cov_type="diag"),
     (NotImplementedError, "resumable cov_type")),
    (dict(gmm_fit_segments=2, gmm_max_iter=0),
     (ValueError, "gmm_max_iter >= 1")),
    (dict(gmm_fit_segments=2, n_data_shards=2),
     (NotImplementedError, "single-device-only")),
])
def test_segmented_run_gmm_refusals(tmp_path, change, error):
    """The JAX harness's segment rules: a cov_type `fit_resume` cannot
    continue, no iteration budget, or a sharded run are refused before the
    fit (the data set is made first)."""
    cfg = trun.GmmBenchConfig(
        n_antennas=8, n_components=4, n_train=400, n_val=100, snrs=(0,),
        results_dir=str(tmp_path), cache_dir=str(tmp_path / "c"),
        eval_rate=False, **change)
    with pytest.raises(error[0], match=error[1]):
        trun.run(cfg, verbose=False, device="cpu")


def test_stages_estimate_matches_jax():
    """`stages.estimate` is the plain einsum estimator, as JAX binds it
    (`harness/stages.py`: `gmm_estimator.estimate` under `cjit`): on one
    seeded GMM, its bank and observations carried across, the port's
    estimate equals JAX's `stages.estimate` to 1e-4 of scale."""
    from quantized_channel_estimation_tpu.models import gmm as jgmm
    from quantized_channel_estimation_torch.ops import quantizer as tq
    assert tst.estimate is tst.gmm_estimator.estimate
    params = worker.gmm_params(seed=5)
    a_t = tst.pilot_matrix(worker.D, 1, 2, device="cpu")
    q_t = tq.design_quantizer(0.0, 2)
    bank = tst.prepare_bank(params, 0.0, a_t, 2, q_t)
    h = torch.as_tensor(worker._cr(np.random.default_rng(8), 300,
                                   worker.D).astype(np.complex64))
    r = worker.observe(h, a_t, q_t)
    got = tst.estimate(bank, r, "all", 128)
    jparams = jgmm.GmmParams(*jst.from_numpy(tuple(p.numpy()
                                                   for p in params)))
    jbank = jst.prepare_bank(jparams, 0.0, jst.pilot_matrix(
        worker.D, 1, 2, "angle_amp"), 2, jq.design_quantizer(0.0, 2))
    want = jst.to_numpy(jst.estimate(jbank, jst.from_numpy(r.numpy()),
                                     "all", 128))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


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
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
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
    _run_mfa_matches_jax(tmp_path, monkeypatch, coh)


def _run_mfa_matches_jax(tmp_path, monkeypatch, coh, **change):
    """The body of `test_run_mfa_matches_jax_on_shared_cache`; `change`
    picks another channel model (the 'mimo' case: 8 x 2 antennas, a
    16-dimensional channel)."""
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
    jcfg = jrun_mfa.MfaBenchConfig(**{
        **dict(n_antennas=16, n_components=8, latent_dim=4, n_train=4000,
               n_val=600, max_iter=10, snrs=(-10, 0, 10),
               results_dir=str(tmp_path / "jax"),
               cache_dir=str(tmp_path / "saves")), **coh, **change})
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
    assert ("_model=" in tname) == (jcfg.channel_model != "3gpp")
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
    2-rank runs' rows against the single-device run's, and the 'mimo' case
    (item 14) the port's rows against the JAX harness's on shared data
    (8 x 2 antennas, the factored bank through the plain K11)."""
    if item == "item 15":
        name = ("mfa_data2" if change.get("n_data_shards", 1) > 1
                else "mfa_comp2")
        _sharded_rows_match(request.getfixturevalue("sharded_runs"), name)
        return
    assert item == "item 14"
    _run_mfa_matches_jax(request.getfixturevalue("tmp_path"),
                         request.getfixturevalue("monkeypatch"), {},
                         n_antennas=8, n_antennas_ms=2, n_path=2, **change)


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


# ---------------------------------------------------------------------------
# run_gmm_quant and run_cov_recovery (CSI-free training)
# ---------------------------------------------------------------------------

def _quant_csv(results_dir):
    paths = glob.glob(os.path.join(results_dir, "3gpp", "*.csv"))
    assert len(paths) == 1, paths
    with open(paths[0]) as f:
        return os.path.basename(paths[0]), list(csv.reader(f))


@pytest.mark.parametrize("t_coh,cov_type", [(1, "full"), (2, "full"),
                                            (1, "circulant"),
                                            (2, "circulant")])
def test_run_gmm_quant_matches_jax_on_shared_cache(tmp_path, monkeypatch,
                                                   t_coh, cov_type):
    """Both CSI-free harnesses on one cache (the JAX run writes the data
    set) with the JAX observations (training pilots and validation) in
    place of the port's `stages.observe` and the JAX fit carried across
    (`gmm.quant_fit_from_numpy` in place of the port's
    `stages.gmm_quant_fit`: the two k-means inits differ, so two fits of
    the harness's own would not agree row for row; the EMs themselves are
    held per iteration in tests/test_torch_gmm_quant.py). The same CSV name
    and columns, every MSE and rate row to rtol 1e-4, the GMM column
    through the plain K1 (dense; K3 for the coherent column) or K6 / K7
    (circulant)."""
    _run_gmm_quant_matches_jax(tmp_path, monkeypatch, t_coh, cov_type)


def _run_gmm_quant_matches_jax(tmp_path, monkeypatch, t_coh, cov_type,
                               **change):
    """The body of `test_run_gmm_quant_matches_jax_on_shared_cache`;
    `change` picks another channel model (at a channel dimension of 16)."""
    from quantized_channel_estimation_tpu.harness import (
        run_gmm_quant as jrun_q)
    from quantized_channel_estimation_torch.harness import (
        run_gmm_quant as trun_q)
    from quantized_channel_estimation_torch.models import gmm as tg

    fits, observed = [], {}

    def jax_fit(*args, _fn=jst.gmm_quant_fit):
        fits.append(_fn(*args))
        return fits[-1]

    def jax_observe(key, h, snr, *args, _fn=jst.observe):
        r = _fn(key, h, snr, *args)
        observed[(snr, tuple(h.shape))] = np.asarray(jst.to_numpy(r))
        return r

    monkeypatch.setattr(jst, "gmm_quant_fit", jax_fit)
    monkeypatch.setattr(jst, "observe", jax_observe)
    coh = dict(n_coherence=2, coherence_alpha=0.5) if t_coh > 1 else {}
    jcfg = jrun_q.QuantGmmBenchConfig(**{
        **dict(n_antennas=16, n_components=8, n_train=4000, n_val=600,
               max_iter=10, snrs=(-5, 5, 15), cov_type=cov_type,
               results_dir=str(tmp_path / "jax"),
               cache_dir=str(tmp_path / "saves")), **coh, **change})
    jmse, jrate, jtimes = jrun_q.run(jcfg, verbose=False)
    assert len(fits) == 1 and len(observed) == 4
    jfit = fits[0]

    def shared_fit(gen, r, cfg, n_bits, sigma2, q):
        np.testing.assert_array_equal(
            r.numpy(), observed[(jcfg.snr_train, (jcfg.n_train, 16))])
        assert (cfg.cov_type, cfg.max_iter, n_bits) == (cov_type, 10, 2)
        return tg.quant_fit_from_numpy(
            [np.asarray(jst.to_numpy(x)) for x in jfit.params],
            np.asarray(jst.to_numpy(jfit.cov_quant)), r.device,
            float(jfit.lower_bound), int(jfit.n_iter), bool(jfit.converged))

    def shared_observe(gen, h, snr, a, n_bits, q):
        return torch.as_tensor(observed[(snr, tuple(h.shape))],
                               device=h.device)

    calls = []
    for name in ("estimate_auto", "estimate_coherent_auto",
                 "estimate_circulant", "estimate_circulant_coherent"):
        def counted(*args, _fn=getattr(tst, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(tst, name, counted)
    monkeypatch.setattr(tst, "gmm_quant_fit", shared_fit)
    monkeypatch.setattr(tst, "observe", shared_observe)
    tcfg = trun_q.QuantGmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(jrun_q.QuantGmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    tmse, trate, ttimes = trun_q.run(tcfg, verbose=False, device="cpu")
    flat, coherent = (("estimate_circulant", "estimate_circulant_coherent")
                      if cov_type == "circulant"
                      else ("estimate_auto", "estimate_coherent_auto"))
    assert calls == ([coherent, flat] if t_coh > 1 else [flat]) * 3

    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    assert ("blmmse_gmm_quant_coh" in tmse) == (t_coh > 1)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    assert set(ttimes) == set(jtimes) == {"fit", "total"}
    jname, jrows = _quant_csv(jcfg.results_dir)
    tname, trows = _quant_csv(tcfg.results_dir)
    assert tname[19:] == jname[19:] and f"_{cov_type}_snrtr=5.0" in tname
    assert ("_model=" in tname) == (jcfg.channel_model != "3gpp")
    assert trows[0] == jrows[0]
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                               np.asarray(jrows[1:])[:, 1:].astype(float),
                               rtol=1e-4)
    assert tmse["blmmse_gmm_quant"][0] > tmse["blmmse_gmm_quant"][-1]


def test_run_gmm_quant_fits_on_its_own(tmp_path):
    """The port's own CSI-free fit through its harness: 'auto' coherence
    blends selected on held-out blocks (the timings record them), every
    row finite, the MSE falling with SNR; a top-2 diagonal run estimates
    through the plain K4; n_coherence must divide the sets."""
    from quantized_channel_estimation_torch.harness import (
        run_gmm_quant as trun_q)
    cfg = trun_q.QuantGmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        max_iter=10, snrs=(-5, 15), n_coherence=2, coherence_alpha="auto",
        alpha_val_blocks=50, results_dir=str(tmp_path),
        cache_dir=str(tmp_path / "c"))
    mse, rate, timings = trun_q.run(cfg, verbose=False, device="cpu")
    assert set(timings["coherence_alpha_by_snr"]) == {-5, 15}
    for vals in list(mse.values()) + list(rate.values()):
        assert np.all(np.isfinite(vals))
    assert mse["blmmse_gmm_quant"][0] > mse["blmmse_gmm_quant"][1]
    assert mse["blmmse_gmm_quant_coh"][0] < 1.0
    mse_d, _, _ = trun_q.run(dataclasses.replace(
        cfg, cov_type="diag", n_summands_or_proba=2, n_coherence=1,
        coherence_alpha=1.0, eval_rate=False), verbose=False, device="cpu")
    assert 0 < mse_d["blmmse_gmm_quant"][1] < mse_d["blmmse_gmm_quant"][0]
    with pytest.raises(ValueError, match="multiples of n_coherence"):
        trun_q.run(dataclasses.replace(cfg, n_coherence=3), device="cpu")


def _quant_cfg(tmp_path, **change):
    from quantized_channel_estimation_torch.harness import (
        run_gmm_quant as trun_q)
    kw = dict(n_antennas=16, n_components=8, n_train=6000, n_val=600,
              max_iter=15, snrs=(-5, 5, 15), results_dir=str(tmp_path),
              cache_dir=str(tmp_path / "saves"), use_cache=False)
    return trun_q, trun_q.QuantGmmBenchConfig(**{**kw, **change})


def _spy(monkeypatch, module, names):
    """Count the calls of `module`'s functions `names`."""
    calls = {name: 0 for name in names}
    for name in names:
        def counted(*args, _fn=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


def _streamed_run_tracks_dense(tmp_path, monkeypatch):
    """`stream_pilots=True` at D = 16: the pilots come from
    `stages.stream_quantized_pilots` with the training covariance summed
    slab by slab, no dense data set is made (`run_gmm._get_data` not
    called), and the MSE at each SNR is within 35% of the dense run's (the
    draws differ); the rate column is there and finite."""
    trun_q, cfg = _quant_cfg(tmp_path / "dense")
    dense, dense_rate, _ = trun_q.run(cfg, verbose=False, device="cpu")
    calls = _spy(monkeypatch, tst, ["stream_quantized_pilots", "sample_cov"])
    get_data = _spy(monkeypatch, trun, ["_get_data"])
    mse, rate, _ = trun_q.run(dataclasses.replace(
        cfg, stream_pilots=True, results_dir=str(tmp_path / "stream")),
        verbose=False, device="cpu")
    assert calls == {"stream_quantized_pilots": 1, "sample_cov": 0}
    assert get_data == {"_get_data": 0}
    np.testing.assert_allclose(mse["blmmse_gmm_quant"],
                               dense["blmmse_gmm_quant"], rtol=0.35)
    assert list(rate) == list(dense_rate) == ["blmmse_gmm_quant_rstat"]
    assert np.all(np.isfinite(rate["blmmse_gmm_quant_rstat"]))
    name, rows = _quant_csv(str(tmp_path / "stream"))
    assert rows[0][1:] == ["blmmse_gmm_quant", "blmmse_gmm_quant_rstat"]


def _auto_frontier_run(tmp_path, monkeypatch, dim):
    """'auto' engages what JAX's does: from D = 2048 a circulant fit is
    spectra-native (`stages.gmm_quant_fit_circulant_spectra`, no dense
    fit), from D = 8192 flat '3gpp' pilots stream as well; a tiny run at
    that D (K = 2, 2 EM iterations) makes finite rows through the
    spectra-fed bank."""
    trun_q, cfg = _quant_cfg(tmp_path, n_antennas=dim, cov_type="circulant",
                             n_components=2, n_train=32, n_val=8,
                             max_iter=2, snrs=(5,), eval_rate=False)
    def rules(**change):
        other = dataclasses.replace(cfg, **change)
        return trun_q._stream_pilots(other), trun_q._spectra_fit(other)

    assert rules() == (dim >= 8192, True)
    assert rules(n_antennas=dim // 2) == (False, dim >= 4096)
    assert rules(cov_type="full") == (dim >= 8192, False)
    assert rules(n_coherence=2) == (False, True)
    calls = _spy(monkeypatch, tst, [
        "stream_quantized_pilots", "gmm_quant_fit",
        "gmm_quant_fit_circulant_spectra", "prepare_bank_circulant_spectra",
        "estimate_circulant"])
    mse, _, _ = trun_q.run(cfg, verbose=False, device="cpu")
    assert calls == {"stream_quantized_pilots": int(dim >= 8192),
                     "gmm_quant_fit": 0,
                     "gmm_quant_fit_circulant_spectra": 1,
                     "prepare_bank_circulant_spectra": 1,
                     "estimate_circulant": 1}
    assert 0 < mse["blmmse_gmm_quant"][0] < 1.5


def _spectra_rows_match_jax(tmp_path, monkeypatch):
    """`use_spectra_fit=True` in both harnesses on one cache, the JAX
    observations and the JAX spectra fit carried across
    (`gmm.quant_circ_fit_from_numpy` in place of the port's
    `stages.gmm_quant_fit_circulant_spectra`): the same CSV name and
    columns, every MSE and rate row to rtol 1e-4, the banks from the
    spectra (`stages.prepare_bank_circulant_spectra`) through the plain
    K6."""
    from quantized_channel_estimation_tpu.harness import (
        run_gmm_quant as jrun_q)
    from quantized_channel_estimation_tpu.models import gmm_quant as jgq
    from quantized_channel_estimation_tpu.ops import boundary as jb
    from quantized_channel_estimation_torch.harness import (
        run_gmm_quant as trun_q)
    from quantized_channel_estimation_torch.models import gmm as tg

    sfits, observed = [], {}
    orig_cjit = jb.cjit

    def recording_cjit(fn, *args, **kw):
        compiled = orig_cjit(fn, *args, **kw)
        if fn is not jgq.fit_circulant_spectra:
            return compiled

        def run(*a):
            sfits.append(compiled(*a))
            return sfits[-1]
        return run

    def jax_observe(key, h, snr, *args, _fn=jst.observe):
        r = _fn(key, h, snr, *args)
        observed[(snr, tuple(h.shape))] = np.asarray(jst.to_numpy(r))
        return r

    monkeypatch.setattr(jb, "cjit", recording_cjit)
    monkeypatch.setattr(jst, "observe", jax_observe)
    jcfg = jrun_q.QuantGmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        max_iter=10, snrs=(-5, 5, 15), cov_type="circulant",
        use_spectra_fit=True, results_dir=str(tmp_path / "jax"),
        cache_dir=str(tmp_path / "saves"))
    jmse, jrate, _ = jrun_q.run(jcfg, verbose=False)
    assert len(sfits) == 1 and len(observed) == 4
    jfit = jst.to_numpy(sfits[0])

    def shared_fit(gen, r, cfg, n_bits, sigma2, q):
        np.testing.assert_array_equal(
            r.numpy(), observed[(jcfg.snr_train, (jcfg.n_train, 16))])
        assert (cfg.cov_type, cfg.max_iter, n_bits) == ("circulant", 10, 2)
        return tg.quant_circ_fit_from_numpy(
            jfit.weights, jfit.means, jfit.spectra, jfit.spec_quant,
            r.device, float(jfit.lower_bound), int(jfit.n_iter),
            bool(jfit.converged))

    monkeypatch.setattr(tst, "gmm_quant_fit_circulant_spectra", shared_fit)
    monkeypatch.setattr(tst, "observe", lambda gen, h, snr, a, n_bits, q:
                        torch.as_tensor(observed[(snr, tuple(h.shape))]))
    calls = _spy(monkeypatch, tst, ["prepare_bank_circulant_spectra",
                                    "prepare_bank_circulant",
                                    "estimate_circulant"])
    tcfg = trun_q.QuantGmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(jrun_q.QuantGmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    tmse, trate, _ = trun_q.run(tcfg, verbose=False, device="cpu")
    assert calls == {"prepare_bank_circulant_spectra": 3,
                     "prepare_bank_circulant": 0, "estimate_circulant": 3}
    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    jname, jrows = _quant_csv(jcfg.results_dir)
    tname, trows = _quant_csv(tcfg.results_dir)
    assert tname[19:] == jname[19:] and trows[0] == jrows[0]
    np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                               np.asarray(jrows[1:])[:, 1:].astype(float),
                               rtol=1e-4)


@pytest.mark.parametrize("change,error", [
    (dict(stream_pilots=True), "item 10"),
    (dict(n_antennas=8192), "item 10"),
    (dict(use_spectra_fit=True, cov_type="circulant"), "item 10"),
    (dict(n_antennas=2048, cov_type="circulant"), "item 10"),
    (dict(n_data_shards=2), "item 10"),
    (dict(n_component_shards=2), "item 10"),
    (dict(channel_model="urban-macro"), "item 14"),
    (dict(n_pilots=2), "A = I"),
])
def test_run_gmm_quant_unported_options_raise(change, error, request):
    """Several pilots raise ValueError, before any work (the quantized EM
    recovers channel covariances for A = I only; JAX fails in its bank
    preparation). Item 14 is ported: its case holds the urban-macro rows
    against the JAX harness's on shared data, and `stream_pilots=True` on
    a model other than '3gpp' raises JAX's ValueError. Item 10 (10b) is
    ported, and its cases run:
    the streamed pilots against the dense run (`_streamed_run_tracks_dense`),
    'auto' at D = 8192 and 2048 (`_auto_frontier_run`), the spectra-native
    fit against the JAX harness (`_spectra_rows_match_jax`), and the mesh
    options' 2-rank rows against the one-rank run's."""
    tmp_path = request.getfixturevalue("tmp_path")
    monkeypatch = request.getfixturevalue("monkeypatch")
    if error == "item 10":
        if "n_data_shards" in change or "n_component_shards" in change:
            _sharded_rows_match(request.getfixturevalue("sharded_runs"),
                                "quant_data2" if "n_data_shards" in change
                                else "quant_comp2")
        elif change == dict(stream_pilots=True):
            _streamed_run_tracks_dense(tmp_path, monkeypatch)
        elif "use_spectra_fit" in change:
            _spectra_rows_match_jax(tmp_path, monkeypatch)
        else:
            _auto_frontier_run(tmp_path, monkeypatch, change["n_antennas"])
        return
    from quantized_channel_estimation_torch.harness import (
        run_gmm_quant as trun_q)
    if error == "item 14":
        _run_gmm_quant_matches_jax(tmp_path, monkeypatch, 1, "full",
                                   n_path=2, **change)
        for model in ("urban-macro", "mimo"):
            with pytest.raises(ValueError, match="'3gpp' runs only"):
                trun_q.run(trun_q.QuantGmmBenchConfig(
                    channel_model=model, stream_pilots=True), device="cpu")
            assert not trun_q._stream_pilots(trun_q.QuantGmmBenchConfig(
                channel_model=model, n_antennas=8192))
        return
    cfg = dataclasses.replace(trun_q.QuantGmmBenchConfig(), **change)
    with pytest.raises(ValueError, match=error):
        trun_q.run(cfg, device="cpu")


@pytest.mark.parametrize("change,match", [
    (dict(stream_pilots=True, n_coherence=2), "stream_pilots supports"),
    (dict(use_spectra_fit=True), "requires cov_type='circulant'"),
    (dict(use_spectra_fit=True, cov_type="circulant",
          use_structured_bank=False), "use_structured_bank"),
])
def test_run_gmm_quant_frontier_refusals(tmp_path, change, match):
    """The JAX harness's three ValueErrors of the frontier options, raised
    before any work (JAX raises the last after its fit): nothing is
    written."""
    trun_q, cfg = _quant_cfg(tmp_path, **change)
    with pytest.raises(ValueError, match=match):
        trun_q.run(cfg, verbose=False, device="cpu")
    assert not os.path.exists(tmp_path / "3gpp")


def test_stream_quantized_pilots_is_per_slab_generate_and_observe():
    """`stages.stream_quantized_pilots` (three slabs, the last ragged):
    slab i is `generate_channels` from the i-th child of the data
    SeedSequence observed with the i-th child of the observation one, bit
    for bit, and the covariance summed slab by slab equals `sample_cov` of
    the same channels (1e-6 of scale). n_batches <= 0 raises ValueError
    (JAX raises IndexError). The generation chunk by width is JAX's."""
    from quantized_channel_estimation_torch.ops import quantizer as tq
    from quantized_channel_estimation_torch.ops import scm as tscm
    cpu = torch.device("cpu")
    scm_cfg = tscm.ScmConfig(16, 1)
    a = tst.pilot_matrix(16, 1, 2, device=cpu)
    q = tq.design_quantizer(5.0, 2)
    r, cov = tst.stream_quantized_pilots(
        np.random.SeedSequence(1), np.random.SeedSequence(2), 1100, scm_cfg,
        5.0, a, 2, q, slab=400, gen_chunk=128, want_cov=True, device=cpu)
    hs, rs = [], []
    for i, (s_d, s_o) in enumerate(zip(np.random.SeedSequence(1).spawn(3),
                                       np.random.SeedSequence(2).spawn(3))):
        h, _ = tst.generate_channels(tst.seed_generator(s_d, cpu),
                                     min(400, 1100 - 400 * i), scm_cfg, 128)
        hs.append(h)
        rs.append(tst.observe(tst.seed_generator(s_o, cpu), h, 5.0, a, 2, q))
    assert r.shape == (1100, 16) and torch.equal(r, torch.cat(rs))
    assert not torch.equal(rs[0][:300], rs[1][:300])
    want = tst.sample_cov(torch.cat(hs))
    np.testing.assert_allclose(cov.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    r2, none = tst.stream_quantized_pilots(
        np.random.SeedSequence(1), np.random.SeedSequence(2), 1100, scm_cfg,
        5.0, a, 2, q, slab=400, gen_chunk=128, device=cpu)
    assert none is None and torch.equal(r2, r)
    for n in (0, -3):
        with pytest.raises(ValueError, match="n_batches"):
            tst.stream_quantized_pilots(
                np.random.SeedSequence(1), np.random.SeedSequence(2), n,
                scm_cfg, 5.0, a, 2, q, device=cpu)
    from quantized_channel_estimation_tpu.ops import scm as jscm
    with pytest.raises(IndexError):
        jst.stream_quantized_pilots(jax.random.PRNGKey(0),
                                    jax.random.PRNGKey(1), 0,
                                    jscm.ScmConfig(16, 1), 5.0, None, 2,
                                    jq.design_quantizer(5.0, 2))
    widths = (16, 64, 2048, 16384, 65536)
    assert [tst.auto_gen_chunk(d) for d in widths] == [
        jst.auto_gen_chunk(d) for d in widths] == [8192, 8192, 1024, 128, 64]


def test_streamed_slabs_and_validation_draw_from_disjoint_streams(
        tmp_path, monkeypatch):
    """Deviation from JAX, whose slab i draws from fold_in(k_data, i) and
    whose validation set from fold_in(k_data, 10_000), the same key at
    10,000 slabs: here the slabs are the children of one SeedSequence and
    the validation set another's, siblings under the data stream, so no
    slab index reaches the validation stream. Every generator a streamed
    run (four slabs) seeds is recorded by its spawn key: the validation
    key is no slab's and no prefix of one, the slab keys are distinct, and
    the observation keys lie under another stream."""
    keys = []
    seed_generator = tst.seed_generator

    def recording(seq, device):
        keys.append(seq.spawn_key)
        return seed_generator(seq, device)

    stream = tst.stream_quantized_pilots
    monkeypatch.setattr(tst, "seed_generator", recording)
    monkeypatch.setattr(tst, "stream_quantized_pilots",
                        lambda *a, **kw: stream(*a, slab=500, **kw))
    trun_q, cfg = _quant_cfg(tmp_path, n_train=2000, n_val=200,
                             stream_pilots=True, max_iter=2, snrs=(5,),
                             eval_rate=False)
    trun_q.run(cfg, verbose=False, device="cpu")
    data = [k for k in keys if k[:1] == (0,)]
    val, slabs = data[0], data[1:5]
    assert len(slabs) == 4 and len(set(slabs)) == 4
    assert len({k[:-1] for k in slabs}) == 1
    assert all(val != s[:len(val)] and s != val[:len(s)] for s in slabs)
    obs = [k for k in keys if k[:1] == (2,)]
    assert len(obs) == 4 and not set(obs) & set(data)


def test_quant_frontier_tool_on_the_cpu(monkeypatch):
    """`tools.quant_frontier.measure` at D = 32 with every frontier option
    forced (the streamed init through a zero budget): each engaged, the
    datagen and fit timed, the NMSE below LS; its `ls_scalar_pilot` is
    `stages.ls_global` under A = x0 I given the covariance's diagonal
    (1e-5 of scale), for a complex pilot too."""
    from quantized_channel_estimation_torch.models import gmm_quant as tgq
    from quantized_channel_estimation_torch.ops import quantizer as tq
    from quantized_channel_estimation_torch.tools import quant_frontier
    monkeypatch.setattr(tgq, "_INIT_ELEM_BUDGET", 0)
    rec = quant_frontier.measure(32, 4, 3000, 400, 10.0, 5, device="cpu",
                                 stream_pilots=True, use_spectra_fit=True)
    assert rec["engaged"] == {"stream_pilots": True, "spectra_fit": True,
                              "dense_fit": False, "streamed_init": True}
    assert rec["n_iter"] == 5 and rec["datagen_s"] > 0 and rec["fit_s"] > 0
    assert rec["peak_gib"] is None and rec["rate"] is None
    assert 0 < rec["nmse"] < rec["ls_nmse"] < 1
    gen = torch.Generator().manual_seed(0)
    h = torch.complex(torch.randn(500, 16, generator=gen),
                      torch.randn(500, 16, generator=gen)) * 0.7
    cov = tst.sample_cov(h)
    q = tq.design_quantizer(5.0, 2)
    for x0 in (1.0 + 0.0j, 0.6 - 0.8j):
        a = x0 * torch.eye(16, dtype=torch.complex64)
        r = tst.observe(gen, h, 5.0, a, 2, q)
        want = tst.ls_global(r, cov, 5.0, a, 2, q)
        got = quant_frontier.ls_scalar_pilot(
            r, torch.diagonal(cov).real, 5.0, torch.tensor(x0), 2, q)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def _jax_cov_draws(cfg):
    """The covariances and samples the JAX `run_cov_recovery` draws from
    its keys (the same jitted programs), in its order."""
    from quantized_channel_estimation_tpu.ops import cplx as jcplx
    from quantized_channel_estimation_tpu.ops import linalg as jl
    from quantized_channel_estimation_tpu.ops import scm as jscm
    scm_cfg = jscm.ScmConfig(cfg.n_dim, cfg.n_path, cfg.path_sigma)

    @jax.jit
    def draw(k_t, k_g):
        _, toep = jscm.generate_channels(k_t, cfg.mc_runs, scm_cfg,
                                         dtype=jax.numpy.complex64)
        covs = jl.toeplitz_from_first_row(toep)
        loads = jax.numpy.abs(jax.random.normal(k_g, (cfg.mc_runs,)))
        covs = covs + loads[:, None, None].astype(covs.dtype) * \
            jax.numpy.eye(cfg.n_dim, dtype=covs.dtype)
        avg = jax.numpy.real(jax.numpy.trace(covs, axis1=-2, axis2=-1)) \
            / cfg.n_dim
        return (covs, 10.0 * jax.numpy.log10(1.0 / (avg - 1.0)),
                jax.numpy.mean(jax.numpy.sum(jax.numpy.abs(covs) ** 2,
                                             axis=(-2, -1))))

    def sample(kr, cov, n):
        w = jcplx.crandn(kr, (n, cfg.n_dim), dtype=cov.dtype)
        return w @ jax.numpy.linalg.cholesky(cov).T

    sample = jax.jit(sample, static_argnums=(2,))
    key = jax.random.PRNGKey(cfg.seed)
    covs_out, samples = [], []
    for n_data in cfg.n_data_list:
        key, k_t, k_g = jax.random.split(key, 3)
        covs, snr_eq, norm = draw(k_t, k_g)
        covs_out.append((np.asarray(covs), np.asarray(snr_eq), float(norm)))
        for i in range(cfg.mc_runs):
            key, kr, _ = jax.random.split(key, 3)
            samples.append(np.asarray(sample(kr, covs[i], n_data)))
    return covs_out, samples


def test_run_cov_recovery_matches_jax(tmp_path, monkeypatch):
    """The Fig. 2 benchmark of both packages on the JAX draws (covariances
    and samples, in place of the port's `draw_covs` and `sample`): the same
    CSV name, columns and rows (rtol 1e-4); the recovery beats the
    quantized sample covariance from n = 1000 on and falls with n. The
    port's `plot` switch: the PNG with matplotlib, none with
    plot=False."""
    from quantized_channel_estimation_tpu.harness import (
        run_cov_recovery as jrun_c)
    from quantized_channel_estimation_torch.harness import (
        run_cov_recovery as trun_c)
    jcfg = jrun_c.CovRecoveryConfig(n_dim=16, mc_runs=3,
                                    n_data_list=(10, 100, 1000, 10000),
                                    results_dir=str(tmp_path / "jax"))
    want = jrun_c.run(jcfg, verbose=False)
    covs, samples = _jax_cov_draws(jcfg)
    monkeypatch.setattr(trun_c, "draw_covs", lambda gen, cfg: (
        lambda c: (torch.as_tensor(c[0], device=gen.device), c[1], c[2]))(
            covs.pop(0)))
    monkeypatch.setattr(trun_c, "sample", lambda gen, cov, n: torch.as_tensor(
        samples.pop(0), device=cov.device))
    tcfg = trun_c.CovRecoveryConfig(**{
        **dataclasses.asdict(jcfg), "results_dir": str(tmp_path / "port")})
    got = trun_c.run(tcfg, verbose=False, device="cpu")
    assert not covs and not samples
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   err_msg=name)
    names = [sorted(os.listdir(c.results_dir)) for c in (jcfg, tcfg)]
    assert names[0] == names[1] and len(names[1]) == 2   # CSV and PNG
    rows = []
    for c in (jcfg, tcfg):
        with open(os.path.join(c.results_dir, names[1][0])) as f:
            rows.append(list(csv.reader(f)))
    assert rows[0][0] == rows[1][0] and rows[1][0][1:] == list(want)
    np.testing.assert_allclose(np.asarray(rows[1][1:], float),
                               np.asarray(rows[0][1:], float), rtol=1e-4)
    rec, quant = got["Cov_est"], got["sampcov_quant"]
    assert all(a > b for a, b in zip(rec, rec[1:]))
    assert all(r < q for r, q in zip(rec[2:], quant[2:]))
    monkeypatch.undo()
    own = dataclasses.replace(tcfg, n_data_list=(100, 1000), plot=False,
                              results_dir=str(tmp_path / "own"))
    trun_c.run(own, verbose=False, device="cpu")
    assert [f.endswith(".csv") for f in os.listdir(own.results_dir)] == [True]
