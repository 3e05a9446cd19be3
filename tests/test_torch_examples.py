"""The port's user examples (`quantized_channel_estimation_torch/examples/`)
on the CPU.

- Each example's own claim (its `check`), its `main(device="cpu", ...)` at a
  small size: D = 16, K <= 8, a few thousand rows.
- The evaluation stage of 01, 02, 04, 06, 08 and 09 on the JAX package's
  data and fit: JAX's numpy channels and observations, JAX's fit carried
  across (`gmm.params_from_numpy`, `mfa.params_from_numpy`,
  `vae.params_from_flax`); every NMSE equals the JAX package's own calls on
  the same data to rtol 1e-4. The JAX calls are written out here; the
  JAX repository's `examples/` scripts run full-size fits at import and
  are never imported or run.
- One example launched as `python -m ... --device cpu`, and the same
  module raising without a card and without `--device`.
- The examples import no JAX, nothing of the JAX package and nothing of
  the JAX repository's `examples/`.

03's data-parallel fit over two ranks and 10's mesh sweep over a 1 x 2 mesh
are in tests/test_torch_examples_mesh.py.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import blmmse as jblmmse
from quantized_channel_estimation_tpu.estimators import ls as jls
from quantized_channel_estimation_tpu.models import gmm as jgmm
from quantized_channel_estimation_tpu.models import gmm_estimator as jge
from quantized_channel_estimation_tpu.models import gmm_quant as jgq
from quantized_channel_estimation_tpu.models import mfa as jmfa
from quantized_channel_estimation_tpu.models import mfa_bank as jmb
from quantized_channel_estimation_tpu.models import structured_bank as jsb
from quantized_channel_estimation_tpu.models import vae as jvae
from quantized_channel_estimation_tpu.ops import observation as jobs
from quantized_channel_estimation_tpu.ops import pilots as jpilots
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as jscm
from quantized_channel_estimation_tpu.utils import metrics as jmetrics
from quantized_channel_estimation_torch import examples
from quantized_channel_estimation_torch.models import gmm as tgmm
from quantized_channel_estimation_torch.models import mfa as tmfa
from quantized_channel_estimation_torch.models import vae as tvae
from quantized_channel_estimation_torch.ops import pilots as tpilots
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
D, K, N_TRAIN, N_VAL, BITS = 16, 4, 2000, 512, 2

# each example's small sizes (its `main` keywords)
SMALL = {
    "01": dict(n_ant=D, k=K, n_train=3000, n_val=N_VAL, max_iter=20),
    "02": dict(n_ant=D, k=K, n_train=3000, n_val=N_VAL, max_iter=10),
    "03": dict(n_ant=D, k=8, n_train=2000, n_val=400, max_iter=10),
    "04": dict(n_ant=D, n_train=1000, n_val=200, epochs=4),
    "06": dict(n_ant=D, k=K, n_train=3000, n_val_blocks=300, max_iter=20),
    "07": dict(n_ant=D, k=K, n_train=2000, max_iter=10),
    "08": dict(n_ant=D, k=K, n_train=3000, n_val=N_VAL,
               sweep=dict(n_train=2000, n_val=400, alpha_val_blocks=50,
                          gmm_max_iter=10)),
    "09": dict(n_ant=D, k=K, latent=4, n_train=3000, n_val=N_VAL,
               max_iter=15),
    "10": dict(mesh=(1, 1), n_antennas=D, n_components=K, n_train=2000,
               n_val=400, gmm_max_iter=10),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_claim_holds_on_the_cpu(name):
    ex = examples.load(name)
    ex.check(ex.main(device="cpu", **SMALL[name]))


def test_segmented_fit_resumes_bit_for_bit(tmp_path):
    """05: a run cut after segment 2 and run again on its checkpoint
    directory ends where the uninterrupted 5-segment run ends, bit for
    bit (lower bound, its history, every parameter)."""
    ex = examples.load("05")
    runs = ex.cut_and_resume("cpu", str(tmp_path), cut_after=2, n_ant=D, k=K,
                             n_train=2000, n_val=N_VAL, iters=3)
    ex.check(runs)
    assert runs["cut"]["n_iter"] == 6 and runs["whole"]["n_iter"] == 15
    assert sorted(os.listdir(tmp_path / "cut")) == sorted(
        [f"torch_step_{s}.pt" for s in range(5)]
        + [f"lb_history_{s}.json" for s in range(5)])


# ---------------------------------------------------------------------------
# the evaluation stages on the JAX package's data and fit
# ---------------------------------------------------------------------------

# the JAX package's functions, jitted (eager JAX compiles each operation
# on its own: several times slower at these sizes)
J_GEN = jax.jit(jscm.generate_channels, static_argnums=(1, 2))
J_OBS = jax.jit(jobs.observe, static_argnums=(4,))
J_BANK = jax.jit(jge.prepare_bank, static_argnums=(3,))
J_EST = jax.jit(jge.estimate, static_argnums=(2, 3))
J_COH = jax.jit(jge.estimate_coherent, static_argnums=(2, 3, 4))
J_GENIE = jax.jit(jblmmse.estimate_genie, static_argnums=(4,))
J_NMSE = jax.jit(jmetrics.nmse)


def _np(x, dtype=np.complex64):
    return np.asarray(x).astype(dtype)


def _t(x, dtype=np.complex64):
    return torch.as_tensor(_np(x, dtype))


def _jnmse(h_est, h):
    return float(J_NMSE(h_est, h))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.fixture(scope="module")
def jdata():
    """JAX's channels (h_train, h_val, t_val) and its full GMM fit."""
    h_train, _ = J_GEN(jax.random.PRNGKey(0), N_TRAIN, jscm.ScmConfig(D, 1))
    h_val, t_val = J_GEN(jax.random.PRNGKey(1), N_VAL, jscm.ScmConfig(D, 1))
    fit = jgmm.fit(jax.random.PRNGKey(3), h_train,
                   jgmm.GmmConfig(n_components=K, zero_mean=True,
                                  max_iter=10))
    return h_train, h_val, t_val, fit


def _jax_observe(h, snr, n_bits=BITS, seed=2):
    a = jpilots.pilot_matrix(D, 1, n_bits)
    q = jq.design_quantizer(snr, n_bits)
    return a, q, J_OBS(jax.random.PRNGKey(seed), h, snr, a, n_bits, q)


def _port_pilot(snr, n_bits=BITS):
    return (tpilots.pilot_matrix(D, 1, n_bits, device="cpu"),
            tq.design_quantizer(snr, n_bits))


def test_quickstart_evaluation_matches_jax(jdata):
    _, h_val, t_val, fit = jdata
    snr = 10.0
    a, q, r = _jax_observe(h_val, snr)
    bank = J_BANK(fit.params, snr, a, BITS, q)
    want = {"gmm": _jnmse(J_EST(bank, r, "all"), h_val),
            "genie": _jnmse(J_GENIE(r, t_val, snr, a, BITS, q),
                            h_val)}
    ta, tq_ = _port_pilot(snr)
    got = examples.load("01").evaluate(
        tgmm.params_from_numpy(fit.params), _t(h_val), _t(t_val), _t(r), ta,
        tq_, snr)
    for key in want:
        _close(got[key], want[key])


def test_coherence_blocks_evaluation_matches_jax(jdata):
    fit = jdata[3]
    ex = examples.load("06")
    h_val, _ = J_GEN(jax.random.PRNGKey(2), 200,
                     jscm.ScmConfig(D, 1, n_coherence=8))
    params = tgmm.params_from_numpy(fit.params)
    for snr in (-10.0, 10.0):
        a, q, r = _jax_observe(h_val, snr, seed=3)
        bank = J_BANK(fit.params, snr, a, BITS, q)
        h_flat = jscm.flatten_coherence(h_val)
        want = {
            "independent": _jnmse(J_EST(
                bank, jscm.flatten_coherence(r), "all"), h_flat),
            "joint": _jnmse(jscm.flatten_coherence(
                J_COH(bank, r, "all")), h_flat),
            "blend": _jnmse(jscm.flatten_coherence(
                J_COH(bank, r, "all", 512, 0.5)), h_flat)}
        ta, tq_ = _port_pilot(snr)
        got = ex.evaluate(params, _t(h_val), _t(r), snr, ta, tq_)
        for key in want:
            _close(got[key], want[key])


def test_train_without_csi_evaluation_matches_jax(jdata):
    """02's evaluation of JAX's quantized-EM fit ('full') and its
    baselines (genie, global LS) on JAX's observations."""
    h_train, h_val, t_val, _ = jdata
    ex = examples.load("02")
    snr = ex.SNR_EVAL
    a, q, r_train = _jax_observe(h_train, ex.SNR_TRAIN)
    _, _, r_val = _jax_observe(h_val, snr, seed=4)
    fit = jgq.fit(jax.random.PRNGKey(3), r_train,
                  jgmm.GmmConfig(n_components=K, zero_mean=True, max_iter=5),
                  BITS, 10.0 ** (-ex.SNR_TRAIN / 10.0), q)
    bank = J_BANK(fit.params, snr, a, BITS, q)
    cov = jnp.einsum("nd,ne->de", h_train, jnp.conj(h_train)) / N_TRAIN
    want_gmm = _jnmse(J_EST(bank, r_val, "all"), h_val)
    want_genie = _jnmse(J_GENIE(r_val, t_val, snr, a, BITS, q), h_val)
    want_ls = _jnmse(jax.jit(jls.estimate_global, static_argnums=(4,))(
        r_val, cov, snr, a, BITS, q), h_val)
    ta, tq_ = _port_pilot(snr)
    _close(ex.evaluate(tgmm.params_from_numpy(fit.params), _t(h_val),
                       _t(r_val), ta, tq_), want_gmm)
    base = ex.baselines(_t(h_train), _t(h_val), _t(t_val), _t(r_val), ta, tq_)
    _close(base["genie"], want_genie)
    _close(base["ls"], want_ls)


def test_vae_evaluation_matches_jax(jdata):
    """04's evaluation of a JAX-trained VAE (two short epochs) carried
    across by `vae.params_from_flax`."""
    h_train, h_val, _, _ = jdata
    ex = examples.load("04")
    snrs = (0.0, 10.0)
    tcfg = ex.config(D, epochs=2, steps_per_epoch=3)
    jcfg = jvae.VaeConfig(**tcfg._asdict())
    _, jstate, _ = jvae.train(
        jax.random.PRNGKey(2), jcfg, h_train, jpilots.pilot_matrix(D, 1, BITS),
        jnp.asarray(snrs, jnp.float32),
        [jq.design_quantizer(s, BITS) for s in snrs], verbose=False)
    jmodel = jvae.DnnVae(jcfg)
    a, q, r = _jax_observe(h_val, ex.SNR_EVAL, seed=3)
    want = _jnmse(jax.jit(jvae.estimate, static_argnums=(0, 2))(
        jmodel, jstate.params, jcfg, r, ex.SNR_EVAL, a, q), h_val)
    params = tvae.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tcfg)
    ta, tq_ = _port_pilot(ex.SNR_EVAL)
    got = ex.evaluate(tvae.DnnVae(tcfg), params, tcfg, _t(h_val), _t(r), ta,
                      tq_)
    _close(got, want)


def test_structured_banks_evaluation_matches_jax(jdata):
    """08's dense and FFT-domain banks of JAX's circulant fit."""
    h_train, h_val, _, _ = jdata
    ex = examples.load("08")
    fit = jgmm.fit(jax.random.PRNGKey(1), h_train,
                   jgmm.GmmConfig(n_components=K, cov_type="circulant",
                                  max_iter=10))
    params = tgmm.params_from_numpy(fit.params)
    for snr in ex.SNRS:
        a, q, r = _jax_observe(h_val, snr)
        bank_d = J_BANK(fit.params, snr, a, BITS, q)
        bank_s = jax.jit(jsb.prepare_bank_circulant, static_argnums=(3,))(
            fit.params, snr, a, BITS, q)
        want = {"dense": _jnmse(J_EST(bank_d, r, "all", 2048), h_val),
                "structured": _jnmse(jax.jit(
                    jsb.estimate_circulant, static_argnums=(2, 3, 4))(
                    bank_s, r, "all", 16384, None), h_val)}
        ta, tq_ = _port_pilot(snr)
        got = ex.evaluate(params, _t(h_val), _t(r), snr, ta, tq_)
        for key in want:
            _close(got[key], want[key])
        assert got["bank_elements"] == [
            sum(int(np.prod(x.shape)) for x in bank)
            for bank in (bank_d, bank_s)]


def test_factored_mfa_evaluation_matches_jax(jdata):
    """09's factored bank, densified path and coherent blocks of JAX's
    MFA fit."""
    h_train, h_val, _, _ = jdata
    ex = examples.load("09")
    fit = jmfa.fit(jax.random.PRNGKey(1), h_train,
                   jmfa.MfaConfig(n_components=K, latent_dim=4,
                                  zero_mean=True, max_iter=5))
    snr = ex.SNR
    q = jq.design_quantizer(snr, BITS)
    a = jnp.eye(D, dtype=jnp.complex64)
    r = J_OBS(jax.random.PRNGKey(3), h_val, snr, a, BITS, q)
    bank_f = jax.jit(jmb.prepare_bank_factored, static_argnums=(3,))(
        fit.params, snr, 1.0 + 0.0j, BITS, q)
    bank_d = J_BANK(jax.jit(jmfa.to_gmm_params)(fit.params), snr, a, BITS,
                    q)
    n_b = N_VAL // ex.T_COH
    want = {"factored": _jnmse(jax.jit(jmb.estimate_factored)(bank_f, r),
                               h_val),
            "dense": _jnmse(J_EST(bank_d, r, "all"), h_val),
            "coherent": _jnmse(jax.jit(jmb.estimate_factored_coherent,
                                       static_argnums=(2, 3, 4))(
                bank_f, r.reshape(n_b, ex.T_COH, D), "all", 256,
                ex.ALPHA).reshape(-1, D), h_val)}
    got = ex.evaluate(
        tmfa.params_from_numpy(fit.params), _t(h_val), _t(r),
        torch.eye(D, dtype=torch.complex64), tq.design_quantizer(snr, BITS))
    for key in want:
        _close(got[key], want[key])


# ---------------------------------------------------------------------------
# launch, device and imports
# ---------------------------------------------------------------------------

def test_example_runs_as_a_module_and_raises_without_a_card():
    """`python -m ...06_coherence_blocks --device cpu` runs the JAX
    script's sizes and prints its lines; without `--device` on a machine
    without a card the same module raises before any work."""
    mod = "quantized_channel_estimation_torch.examples.06_coherence_blocks"
    env = {**os.environ, "OMP_NUM_THREADS": "2", "CUDA_VISIBLE_DEVICES": ""}
    run, bare = (subprocess.Popen([sys.executable, "-m", mod, *args],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for args in (["--device", "cpu"], []))
    out, err = run.communicate(timeout=300)
    assert run.returncode == 0, err[-2000:]
    lines = out.splitlines()
    assert lines[0].startswith("EM converged: ")
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "SNR -10.0 dB", "SNR  +0.0 dB", "SNR +10.0 dB"]
    out, err = bare.communicate(timeout=300)
    assert bare.returncode != 0 and out == ""
    assert "no CUDA device is available" in err


@pytest.mark.parametrize("name", examples.NAMES)
def test_examples_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples.load(name).main()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_examples_import_no_jax():
    files = sorted((REPO / "quantized_channel_estimation_torch"
                    / "examples").glob("*.py"))
    assert {p.stem for p in files} >= set(examples.NAMES)
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "quantized_channel_estimation_tpu",
                                "examples"), (path, name)
