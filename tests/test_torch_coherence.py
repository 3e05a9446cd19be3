"""Parity of the port's coherence-block path with the JAX package:
`flatten_coherence`, the coherent einsum estimator and its stats, the
evidence-blend selection, the plain version of kernel K3, and `run_gmm`
with `n_coherence > 1`.

Tolerances: `flatten_coherence` exact; the coherent estimator at float64
to rtol 1e-9 (Cholesky-level arithmetic in another order); its stats to
rtol 1e-5, because both packages round the logits to float32 before the
exp; alpha selection scores to rtol 1e-6; the plain K3 against JAX's
interpret-mode Pallas kernel on identical float32 inputs to 1e-5 of the
output scale (float32 sums in another order); `run_gmm` rows to rtol 1e-4
(complex64 data, the plain K3 here and the einsum estimator in JAX).
"""
import csv
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as jpk
from quantized_channel_estimation_tpu.harness import run_gmm as jrun
from quantized_channel_estimation_tpu.harness import stages as jst
from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_estimator as jge
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as jscm
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import run_gmm as trun
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.ops import scm as tscm

torch.set_num_threads(2)

D, K = 8, 4


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _banks(rng, dead=True, snr=0.0):
    """The same float64 GMM (one component below the dead floor when
    `dead`) prepared by both packages at 2 bits, one pilot."""
    a = rng.standard_normal((K, D, D)) + 1j * rng.standard_normal((K, D, D))
    covs = a @ np.conj(np.swapaxes(a, -1, -2)) / D + 0.2 * np.eye(D)
    covs = covs * D / np.real(np.trace(covs, axis1=-2, axis2=-1))[:, None,
                                                                   None]
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    w = np.array([0.4, 0.3, 0.3 - 1e-5, 1e-5]) if dead else np.full(K, 1 / K)
    means = 0.3 * (rng.standard_normal((K, D))
                   + 1j * rng.standard_normal((K, D)))
    a_mat = np.asarray(jp.pilot_matrix(D, 1, 2, dtype=jnp.complex128))
    qj = jq.design_quantizer(snr, 2)
    qt = tq.ScalarQuantizer(*(torch.as_tensor(np.array(x)) for x in qj))
    bj = jge.prepare_bank(jg.GmmParams(*(jnp.asarray(x) for x in (
        w, means, covs, prec))), snr, jnp.asarray(a_mat), 2, qj)
    bt = tge.prepare_bank(tg.GmmParams(*(torch.as_tensor(x) for x in (
        w, means, covs, prec))), snr, torch.as_tensor(a_mat), 2, qt)
    return bj, bt


def _blocks(rng, b, t, m=D, dtype=np.complex128):
    """Quantization-like observations: (B, T, M) of +-1/1.4 per part."""
    r = rng.standard_normal((b, t, m)) + 1j * rng.standard_normal((b, t, m))
    return (np.sign(r.real) + 1j * np.sign(r.imag)).astype(dtype) / 1.4


def test_flatten_coherence_is_exact(rng):
    h = (rng.standard_normal((5, 3, 4))
         + 1j * rng.standard_normal((5, 3, 4))).astype(np.complex64)
    t = (rng.standard_normal((5, 4))
         + 1j * rng.standard_normal((5, 4))).astype(np.complex64)
    hj, tj = jscm.flatten_coherence(jnp.asarray(h), jnp.asarray(t))
    ht, tt = tscm.flatten_coherence(torch.as_tensor(h), torch.as_tensor(t))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(ht.numpy()[3], h[1, 0])   # block-major
    np.testing.assert_array_equal(
        tst.flatten_coherence(torch.as_tensor(h)).numpy(), ht.numpy())
    flat = torch.as_tensor(h[:, 0])
    assert tscm.flatten_coherence(flat) is flat


@pytest.mark.parametrize("alpha", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("mode", ["all", 1, 2, 0.9])
def test_estimate_coherent_matches_jax(rng, mode, alpha):
    bj, bt = _banks(rng)
    r = _blocks(rng, 37, 3)
    got = tge.estimate_coherent(bt, torch.as_tensor(r), mode, 16, alpha)
    want = jge.estimate_coherent(bj, jnp.asarray(r), mode, 16, alpha)
    assert got.shape == (37, 3, D)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


def test_estimate_coherent_reduces_to_flat(rng):
    """T = 1, or alpha = 0 at any T, is the per-snapshot estimator."""
    _, bt = _banks(rng)
    r = torch.as_tensor(_blocks(rng, 20, 4))
    flat = tge.estimate(bt, r.reshape(-1, D), "all").reshape(20, 4, D)
    np.testing.assert_allclose(
        _np(tge.estimate_coherent(bt, r, "all", alpha=0.0)), _np(flat),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        _np(tge.estimate_coherent(bt, r[:, :1], "all")), _np(flat[:, :1]),
        rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="blocks"):
        tge.estimate_coherent(bt, r[:, 0])


@pytest.mark.parametrize("alpha", [1.0, 0.5, 0.0])
def test_estimate_coherent_stats_match_jax(rng, alpha):
    bj, bt = _banks(rng)
    r = _blocks(rng, 30, 4)
    got = tge.estimate_coherent_stats(bt, torch.as_tensor(r), 8, alpha)
    want = jge.estimate_coherent_stats(bj, jnp.asarray(r), 8, alpha)
    lead = (30,) if alpha >= 1.0 else (30, 4)
    assert got[0].shape == got[1].shape == lead
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-8)
    m, den, acc = got
    den_b = den[:, None, None] if alpha >= 1.0 else den[..., None]
    np.testing.assert_allclose(
        _np(acc / den_b),
        _np(tge.estimate_coherent(bt, torch.as_tensor(r), "all", 8, alpha)),
        rtol=1e-5, atol=1e-8)


def test_select_coherence_alpha_matches_jax(rng):
    bj, bt = _banks(rng, snr=-5.0)
    r_val = _blocks(rng, 40, 4)
    h_val = (rng.standard_normal((40, 4, D))
             + 1j * rng.standard_normal((40, 4, D))) / np.sqrt(2)
    best_j, scores_j = jge.select_coherence_alpha(
        lambda rb, al: jge.estimate_coherent(bj, rb, "all", 512, al),
        jnp.asarray(r_val), jnp.asarray(h_val))
    best_t, scores_t = tge.select_coherence_alpha(
        lambda rb, al: tge.estimate_coherent(bt, rb, "all", 512, al),
        torch.as_tensor(r_val), h_val)
    assert best_t == best_j
    assert list(scores_t) == list(scores_j) == list(tge.DEFAULT_ALPHA_GRID)
    np.testing.assert_allclose(list(scores_t.values()),
                               list(scores_j.values()), rtol=1e-6)


def _kb_from_jax(kj):
    return tkn.KernelBankBlock(
        torch.as_tensor(np.asarray(kj.pw)),
        torch.as_tensor(np.asarray(kj.mu)[:, 0]),
        torch.as_tensor(np.asarray(kj.b)[:, 0]),
        torch.as_tensor(np.asarray(kj.logw)))


@pytest.mark.parametrize("t,alpha", [(2, 1.0), (3, 1.0), (4, 1.0),
                                     (2, 0.25), (3, 0.25), (4, 0.25)])
def test_kernel_bank_block_coherent_matches_jax(rng, t, alpha):
    bj, bt = _banks(rng)
    kj = jpk.kernel_bank_block(bj, t_coh=t, coh_alpha=alpha)
    kt = tkn.kernel_bank_block(bt, t, alpha)
    for g, w in zip(kt, _kb_from_jax(kj)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert kt.logw[-1].item() == float(np.float32(-1e30))   # dead floor


@pytest.mark.parametrize("t,alpha,n_blocks,dead", [
    (2, 1.0, 40, False), (3, 1.0, 37, True), (4, 1.0, 29, True),
    (2, 0.25, 51, True), (3, 0.25, 20, False), (4, 0.25, 33, True)])
def test_plain_k3_matches_jax_interpret_kernel(rng, t, alpha, n_blocks,
                                               dead):
    """The same float32 bank layout and rows through JAX's coherent Pallas
    kernel (interpret mode, T-major tiles) and the port's plain K3 on
    block-major rows; ragged block counts, with and without a dead
    component."""
    bj, _ = _banks(rng, dead=dead)
    r = _blocks(rng, n_blocks, t, dtype=np.complex64)
    want = np.asarray(jpk.estimate_fused_coherent(bj, jnp.asarray(r),
                                                  interpret=True,
                                                  alpha=alpha))
    kb = _kb_from_jax(jpk.kernel_bank_block(bj, t_coh=t, coh_alpha=alpha))
    r2 = torch.as_tensor(np.concatenate([r.real, r.imag], axis=-1)
                         .reshape(-1, 2 * D).astype(np.float32))
    h2 = tkn.grouped_estimate_coherent_reference(r2, kb, t, alpha, chunk=50)
    got = (h2[:, :D] + 1j * h2[:, D:]).numpy().reshape(n_blocks, t, D)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-5, err
    # the CPU wrapper is the plain version, and launches nothing
    before = tkn.grouped_estimate_coherent.launches
    assert torch.equal(tkn.grouped_estimate_coherent(r2, kb, t, alpha),
                       tkn.grouped_estimate_coherent_reference(r2, kb, t,
                                                               alpha))
    assert tkn.grouped_estimate_coherent.launches == before


def test_estimate_fused_coherent_dispatch(rng):
    """K3 for 1 < T <= the tile's rows, K1 at T = 1, the einsum estimator
    above the range; each agrees with the einsum estimator."""
    _, bt = _banks(rng)
    bt32 = tge.PreparedBank(*(x.to(torch.complex64) if x.is_complex()
                              else x.to(torch.float32) for x in bt))
    assert tkn.coherent_kernel_eligible(bt32, 64)
    assert not tkn.coherent_kernel_eligible(bt32, 65)
    assert not tkn.coherent_kernel_eligible(bt32, 1)
    cache = {}
    for t, alpha in ((1, 1.0), (4, 1.0), (4, 0.5), (65, 1.0)):
        r = torch.as_tensor(_blocks(rng, 6, t, dtype=np.complex64))
        got = tkn.estimate_fused_coherent(bt32, r, alpha, cache)
        want = tge.estimate_coherent(bt32, r, "all", 512, alpha)
        assert got.shape == (6, t, D) and got.dtype == torch.complex64
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) < 1e-4, (t, alpha)
        auto = tst.estimate_coherent_auto(bt32, r, "all", alpha)
        assert float((auto - want).abs().max() / want.abs().max()) < 1e-4
    # lowered once per (T, alpha); T beyond the kernel lowers nothing
    assert set(cache) == {(1, 1.0), (4, 1.0), (4, 0.5)}
    r = torch.as_tensor(_blocks(rng, 6, 4, dtype=np.complex64))
    np.testing.assert_allclose(
        _np(tst.estimate_coherent_auto(bt32, r, 2, 0.5)),
        _np(tge.estimate_coherent(bt32, r, 2, 512, 0.5)))


def _read_csv(results_dir, rate):
    paths = glob.glob(os.path.join(results_dir, "3gpp", "*.csv"))
    path = [p for p in paths if p.endswith("_rate.csv") == rate]
    assert len(path) == 1, paths
    with open(path[0]) as f:
        rows = list(csv.reader(f))
    return os.path.basename(path[0]), rows


def test_run_gmm_coherent_matches_jax_on_shared_cache(tmp_path, monkeypatch):
    cache = str(tmp_path / "saves")
    jcfg = jrun.GmmBenchConfig(
        n_antennas=16, n_components=8, n_train=4000, n_val=600,
        snrs=(-10, 0, 10), results_dir=str(tmp_path / "jax"),
        cache_dir=cache, gmm_max_iter=15, n_coherence=2,
        coherence_alpha=0.5)
    jmse, jrate, _ = jrun.run(jcfg, verbose=False)
    assert len(os.listdir(cache)) == 2          # dataset + GMM written

    # the JAX block observations, made with run()'s own keys
    data = np.load(glob.glob(os.path.join(cache, "saved_data*"))[0])
    assert data["channels"].shape == (2300, 2, 16)
    h_val_blocks = jst.from_numpy(data["channels"][2000:])
    a = jst.pilot_matrix(16, 1, 2, "angle_amp")
    k_obs = jax.random.split(jax.random.PRNGKey(jcfg.seed), 3)[2]
    r_jax = {snr: jst.to_numpy(jst.observe(
        jax.random.fold_in(k_obs, i), h_val_blocks, snr, a, 2,
        jq.design_quantizer(snr, 2))) for i, snr in enumerate(jcfg.snrs)}

    def shared_observe(gen, h, snr, a, n_bits, q):
        assert tuple(h.shape) == r_jax[snr].shape
        return torch.as_tensor(r_jax[snr], device=h.device)

    monkeypatch.setattr(tst, "observe", shared_observe)
    tcfg = trun.GmmBenchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(trun.GmmBenchConfig)})
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp_path / "port"))
    tmse, trate, _ = trun.run(tcfg, verbose=False, device="cpu")

    assert list(tmse) == list(jmse) and list(trate) == list(jrate)
    assert "blmmse_gmm_coh" in tmse and "gmm_coh_rstat" in trate
    for got, want in ((tmse, jmse), (trate, jrate)):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       err_msg=name)
    for rate in (False, True):
        jname, jrows = _read_csv(jcfg.results_dir, rate)
        tname, trows = _read_csv(tcfg.results_dir, rate)
        assert tname[19:] == jname[19:] and "_model=3gpp-coh2" in tname
        assert trows[0] == jrows[0]
        np.testing.assert_allclose(np.asarray(trows[1:])[:, 1:].astype(float),
                                   np.asarray(jrows[1:])[:, 1:].astype(float),
                                   rtol=1e-4)
    # joint estimation of the blocks beats per-snapshot at low SNR
    assert tmse["blmmse_gmm_coh"][0] < tmse["blmmse_gmm"][0]


def test_run_gmm_auto_alpha_and_checks(tmp_path):
    cfg = trun.GmmBenchConfig(
        n_antennas=8, n_components=4, n_train=2000, n_val=400,
        snrs=(-10, 10), results_dir=str(tmp_path), cache_dir=str(tmp_path /
                                                                 "c"),
        gmm_max_iter=10, eval_rate=False, n_coherence=4,
        coherence_alpha="auto", alpha_val_blocks=50)
    mse, _, timings = trun.run(cfg, verbose=False, device="cpu")
    chosen = timings["coherence_alpha_by_snr"]
    assert set(chosen) == {-10, 10}
    assert set(chosen.values()) <= set(tge.DEFAULT_ALPHA_GRID)
    assert np.all(np.isfinite(mse["blmmse_gmm_coh"]))
    # the held-out blocks shorten the fit's training set: its own cache key
    assert any("ntrain=1800" in f for f in os.listdir(tmp_path / "c"))
    with pytest.raises(ValueError, match="multiples"):
        trun.run(dataclasses.replace(cfg, n_val=402), device="cpu")
    with pytest.raises(ValueError, match="n_coherence > 1"):
        trun.run(dataclasses.replace(cfg, n_coherence=1), device="cpu")
