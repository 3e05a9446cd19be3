"""The port's VAE harness (`harness.run_vae`) against the JAX harness.

Both harnesses read one cache: the JAX run writes the channel dataset, its
trained state is carried across (`vae.state_from_flax` in place of the
port's `vae.train`, whose losses it also returns) and its observations
replace the port's `stages.observe`, as
`test_run_gmm_matches_jax_on_shared_cache` does for `run_gmm`. Both then
write the same CSV names and columns (results, params, loss), and every MSE
and rate row agrees to rtol 1e-4: noisy and real through the per-sample
circulant estimate ('auto' at one pilot), genie (its encoder fed the
validation channels), and noisy with coherence blocks of T = 2 through the
dense estimate (`use_structured_bank=False`, the `_coh` columns). The
random search draws JAX's trials exactly (numpy), and the options of later
slices raise naming their ROADMAP item.
"""
import csv
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.harness import run_vae as jrun
from quantized_channel_estimation_tpu.harness import stages as jst
from quantized_channel_estimation_tpu.models import vae as jv
from quantized_channel_estimation_torch.harness import run_vae as trun
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import vae as tv

torch.set_num_threads(2)

SMALL = dict(n_antennas=16, latent_dim=4, n_layers=2, epochs=2,
             n_train=1000, n_val=200, batch_size=100, snrs=(-5, 5, 15))


def _csvs(results_dir):
    """{name after the time stamp: rows} of a run's CSVs."""
    out = {}
    for path in glob.glob(os.path.join(results_dir, "vae", "*.csv")):
        with open(path) as f:
            out[os.path.basename(path)[19:]] = list(csv.reader(f))
    return out


@pytest.mark.parametrize("change", [
    dict(vae_mode="noisy"), dict(vae_mode="real"), dict(vae_mode="genie"),
    dict(vae_mode="noisy", n_coherence=2, use_structured_bank=False)])
def test_run_vae_matches_jax_on_shared_cache(tmp_path, monkeypatch, change):
    _run_vae_matches_jax(tmp_path, monkeypatch, change)


def _run_vae_matches_jax(tmp_path, monkeypatch, change):
    """The body of `test_run_vae_matches_jax_on_shared_cache`: the JAX run
    at SMALL plus `change`, the port on its data set, trained state and
    observations."""
    cache = str(tmp_path / "saves")
    jcfg = jrun.VaeBenchConfig(**{**SMALL, **change},
                               results_dir=str(tmp_path / "jax"),
                               cache_dir=cache)
    trained, observed = [], {}

    def jax_train(*args, _fn=jv.train, **kw):
        trained.append(_fn(*args, **kw))
        return trained[-1]

    def jax_observe(key, h, snr, *args, _fn=jst.observe):
        r = _fn(key, h, snr, *args)
        observed[snr] = np.asarray(jst.to_numpy(r))
        return r

    monkeypatch.setattr(jv, "train", jax_train)
    monkeypatch.setattr(jst, "observe", jax_observe)
    jmse, jrate, _ = jrun.run(jcfg, verbose=False)
    _, jstate, jlosses = trained[0]

    def port_train(seed, cfg, h_train, a, snrs, quantizers, **kw):
        model = tv.DnnVae(cfg)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        return model, tv.state_from_flax(model, to_np(jstate.params),
                                         to_np(jstate.opt_state),
                                         int(jstate.step)), list(jlosses)

    def shared_observe(gen, h, snr, a, n_bits, q):
        return torch.as_tensor(observed[snr], device=h.device)

    monkeypatch.setattr(tv, "train", port_train)
    monkeypatch.setattr(tst, "observe", shared_observe)
    tcfg = trun.VaeBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(jrun.VaeBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    tmse, trate, _ = trun.run(tcfg, verbose=False, device="cpu")

    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    jcsv, tcsv = _csvs(jcfg.results_dir), _csvs(tcfg.results_dir)
    assert sorted(tcsv) == sorted(jcsv) and len(jcsv) == 3
    for name, jrows in jcsv.items():
        trows = tcsv[name]
        if name.endswith("_params.csv"):
            # the port's config has one field more (plot); the runs'
            # result directories differ
            assert [r for r in trows if r[0] not in ("plot", "results_dir")
                    ] == [r for r in jrows if r[0] != "results_dir"]
        else:
            assert trows[0] == jrows[0]          # the same columns
            assert [r[0] for r in trows] == [r[0] for r in jrows]
            np.testing.assert_allclose(
                np.asarray(trows[1:])[:, 1:].astype(float),
                np.asarray(jrows[1:])[:, 1:].astype(float), rtol=1e-4)
    assert len(glob.glob(os.path.join(tcfg.results_dir, "vae",
                                      "*_loss.png"))) == 1


def test_run_vae_trains_on_its_own(tmp_path):
    """The port's run end to end (noisy, T = 2 blocks, no plot): finite
    rows, the estimate better than the zero estimate and better at 15 dB
    than at -5 dB, the same rows on a rerun; its checkpoint key is the JAX
    harness's."""
    cfg = trun.VaeBenchConfig(
        **{**SMALL, "n_train": 4000, "epochs": 3}, n_coherence=2,
        plot=False, results_dir=str(tmp_path), cache_dir=str(tmp_path / "c"))
    mse, rate, times = trun.run(cfg, verbose=False, device="cpu")
    assert set(mse) == {"vae_noisy", "vae_noisy_coh"}
    for col in (*mse.values(), *rate.values()):
        assert np.all(np.isfinite(col))
    assert 0 < mse["vae_noisy"][2] < mse["vae_noisy"][0] < 1.0
    assert not glob.glob(os.path.join(tmp_path, "vae", "*.png"))
    assert times["train"] <= times["total"]
    assert os.path.basename(trun.checkpoint_dir(cfg)) == (
        "vae_ckpt_noisy_ant=16_bits=2_train=4000_seed=0_lr=0.0005_bs=100"
        "_coh2")
    # the run is a function of its seed (no checkpoint is written before
    # epoch 25, so the rerun trains again)
    mse2, _, _ = trun.run(cfg, verbose=False, device="cpu")
    assert mse2 == mse


def test_run_search_draws_the_jax_trials(tmp_path, monkeypatch):
    """Both searches on stubbed runs: the same (lr, batch_size) a trial,
    exactly, and the same summary CSV."""
    calls = {"jax": [], "port": []}

    def fake(which):
        def run(cfg, verbose=True, **kw):
            calls[which].append((cfg.lr, cfg.batch_size))
            mse = [cfg.lr * 1e3 + i / cfg.batch_size for i in range(3)]
            return {f"vae_{cfg.vae_mode}": mse}, {}, {"train": 1.0}
        return run

    monkeypatch.setattr(jrun, "run", fake("jax"))
    monkeypatch.setattr(trun, "run", fake("port"))
    kw = dict(SMALL, n_trials=5, seed=3)
    jbest, jtrials = jrun.run_search(jrun.VaeBenchConfig(
        **kw, results_dir=str(tmp_path / "jax")), verbose=False)
    tbest, ttrials = trun.run_search(trun.VaeBenchConfig(
        **kw, results_dir=str(tmp_path / "port")), verbose=False,
        device="cpu")
    assert calls["port"] == calls["jax"] and len(set(calls["jax"])) == 5
    assert [trun.search_trial(3, t) for t in range(5)] == calls["jax"]
    assert tbest["trial"] == jbest["trial"]
    assert _csvs(str(tmp_path / "port")) == _csvs(str(tmp_path / "jax"))


@pytest.mark.parametrize("change", [dict(channel_model="mimo"),
                                    dict(channel_model="urban-macro")])
def test_run_vae_unported_options_raise(tmp_path, monkeypatch, change):
    """The other channel models (item 14, pinned here as refusals until
    they were ported): the noisy VAE on the JAX data set of the model
    ('mimo' 8 x 2 antennas, its 16-dimensional channel the VAE's width)
    against the JAX harness, rows to rtol 1e-4, the CSV names and the
    checkpoint key tagged with the model as JAX's are."""
    dims = dict(n_antennas=8, n_antennas_ms=2) if change[
        "channel_model"] == "mimo" else {}
    _run_vae_matches_jax(tmp_path, monkeypatch,
                         dict(vae_mode="noisy", n_path=2, **dims, **change))
    tag = "mimo8x2" if dims else "urban-macro"
    csvs = glob.glob(os.path.join(tmp_path, "port", "vae", "*.csv"))
    assert len(csvs) == 3 and all(f"_{tag}_path=2_ant=16_" in p
                                  for p in csvs)
    cfg = trun.VaeBenchConfig(**{**SMALL, **dims, **change})
    assert os.path.basename(trun.checkpoint_dir(cfg)) == (
        f"vae_ckpt_noisy_ant=16_model={tag}_bits=2_train=1000_seed=0"
        "_lr=0.0005_bs=100")


def test_run_vae_refusals(tmp_path, monkeypatch):
    """A data-parallel run outside a group of its size, snapshot counts
    that are not whole blocks, 'real' with several pilots, and no card
    without an explicit device."""
    with pytest.raises(ValueError, match="torchrun"):
        trun.run(trun.VaeBenchConfig(n_data_shards=2), device="cpu")
    small = dict(SMALL, results_dir=str(tmp_path), use_cache=False)
    with pytest.raises(ValueError, match="multiples of n_coherence"):
        trun.run(trun.VaeBenchConfig(**small, n_coherence=3), device="cpu")
    with pytest.raises(NotImplementedError, match="n_pilots=1 only"):
        trun.run(trun.VaeBenchConfig(**small, vae_mode="real", n_pilots=2),
                 device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run(trun.VaeBenchConfig(**small))


def test_misc_helpers_match_jax(tmp_path, capsys):
    """`utils.misc`, the port's own copy: the same draws from a seed or a
    Generator, the same strings, files and refusals."""
    from quantized_channel_estimation_tpu.utils import misc as jmisc
    from quantized_channel_estimation_torch.utils import misc as tmisc
    for fn in ("rand_exp", "rand_geom"):
        np.testing.assert_array_equal(
            getattr(tmisc, fn)(1.0, 100.0, (3, 2), seed=4),
            getattr(jmisc, fn)(1.0, 100.0, (3, 2), seed=4))
        np.testing.assert_array_equal(
            getattr(tmisc, fn)(1.0, 100.0, seed=np.random.default_rng(5)),
            getattr(jmisc, fn)(1.0, 100.0, seed=np.random.default_rng(5)))
    for bad in ((0.0, 1.0), (2.0, 1.0)):
        with pytest.raises(ValueError):
            tmisc.rand_exp(*bad)
    assert tmisc.sec2hours(3725.0) == jmisc.sec2hours(3725.0) == "1:02:05"
    d = {"a": 1, "b": "x", "c": 2.5}
    tmisc.print_dict(d, 2)
    port = capsys.readouterr().out
    jmisc.print_dict(d, 2)
    assert port == capsys.readouterr().out
    with pytest.raises(ValueError):
        tmisc.print_dict(d, 0)
    tmisc.dict_to_csv(d, str(tmp_path / "t.csv"))
    jmisc.dict_to_csv(d, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
