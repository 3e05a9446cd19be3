"""The port's MFA fit (`models/mfa.py`) and factored bank
(`models/mfa_bank.py`) against the JAX package on shared numpy inputs.

- Woodbury inverse and log-determinant: complex128, against JAX and the
  dense numpy algebra to 1e-9.
- EM: `fit_resume` from the same numpy parameters for 1, 2 and 5
  iterations, parameters and summed log-likelihood held together. The JAX
  EM keeps its statistics and log-likelihood in float32 loop carries (as
  its GMM does, ROADMAP Queue 3), so it refuses complex128 data: the
  comparison runs at complex64, to rtol 2e-4 on the parameters and 2e-5 on
  the log-likelihood (float32 sums in another order, compounded over five
  iterations).
- Banks and estimates at complex64: bank fields to 1e-5 of each field's
  scale (the 1-bit linear-arcsine bank 5e-5), estimates in every selection
  mode, the coherent form and both stats forms to 1e-5 (the JAX tests'
  own), and the factored estimate against the port's dense bank to 2e-4
  (`tests/test_mfa_bank.py`), and to 1e-9 in complex128, where the port
  computes in the promoted type; the coherent stats to 4e-5 (a pooled
  logit sums T float32 logits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import mfa as jmfa
from quantized_channel_estimation_tpu.models import mfa_bank as jmb
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.estimators import circ_kernels as tck
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.models import mfa as tmfa
from quantized_channel_estimation_torch.models import mfa_bank as tmb
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

D, M, K = 32, 6, 8
X0 = 0.7 - 0.2j


def _cr(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _rel(got, want):
    got = got.resolve_conj().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def prior():
    """Seeded MFA parameters (non-zero means) as numpy arrays and 512
    observations drawn from the mixture, 2-bit at 10 dB under x0 I."""
    rng = np.random.default_rng(0)
    lam = (0.5 * _cr(rng, K, D, M)).astype(np.complex64)
    psis = (0.1 + rng.uniform(size=(K, D))).astype(np.float32)
    means = (0.3 * _cr(rng, K, D)).astype(np.complex64)
    w = (rng.uniform(size=K) + 0.1).astype(np.float32)
    params = (w / w.sum(), means, lam, psis)
    n = 512
    comp = rng.integers(0, K, n)
    h = (means[comp] + np.einsum("ndm,nm->nd", lam[comp], _cr(rng, n, M))
         + np.sqrt(psis[comp]) * _cr(rng, n, D))
    y = X0 * h + np.sqrt(0.1) * _cr(rng, n, D)
    q = jq.design_quantizer(10.0, 2)
    r = np.array(jq.quantize(jnp.asarray(y.astype(np.complex64)), 2, q))
    return params, r


def _banks(params, n_bits, dtype=np.complex64, **kw):
    q = None if n_bits == "inf" else jq.design_quantizer(10.0, n_bits)
    jp = jmfa.MfaParams(*(jnp.asarray(x) for x in params))
    jbank = jmb.prepare_bank_factored(jp, 10.0, X0, n_bits, q, **kw)
    tp = tmfa.params_from_numpy([x.astype(dtype) if np.iscomplexobj(x)
                                 else x.astype(np.float64 if dtype ==
                                               np.complex128 else np.float32)
                                 for x in params])
    tq_ = None if n_bits == "inf" else tq.design_quantizer(10.0, n_bits)
    tbank = tmb.prepare_bank_factored(tp, 10.0, torch.tensor(X0), n_bits,
                                      tq_, **kw)
    return jbank, tbank, tp


# ---------------------------------------------------------------------------
# Woodbury algebra and the EM
# ---------------------------------------------------------------------------

def test_woodbury_inverse_and_slogdet_match_jax_and_dense():
    rng = np.random.default_rng(3)
    lam = _cr(rng, 3, 8, 2)
    psi = rng.uniform(0.5, 2.0, (3, 8))
    got = tmfa.woodbury_inverse(torch.as_tensor(lam), torch.as_tensor(psi))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmfa.woodbury_inverse(jnp.asarray(lam),
                                                      jnp.asarray(psi))),
        atol=1e-9)
    ld = tmfa._slogdet_from_woodbury(torch.as_tensor(lam),
                                     torch.as_tensor(psi)).numpy()
    for i in range(3):
        dense = lam[i] @ lam[i].conj().T + np.diag(psi[i])
        np.testing.assert_allclose(got[i].numpy() @ dense, np.eye(8),
                                   atol=1e-9)
        np.testing.assert_allclose(ld[i], np.linalg.slogdet(dense)[1],
                                   rtol=1e-9)
    np.testing.assert_allclose(
        ld, np.asarray(jmfa._slogdet_from_woodbury(jnp.asarray(lam),
                                                   jnp.asarray(psi))),
        rtol=1e-9)
    c = tmfa.covariances(tmfa.MfaParams(None, None, torch.as_tensor(lam),
                                        torch.as_tensor(psi)))
    np.testing.assert_allclose(
        c.numpy(), np.asarray(jmfa.covariances(jmfa.MfaParams(
            None, None, jnp.asarray(lam), jnp.asarray(psi)))), atol=1e-12)


def _em_data(zero_mean):
    """1500 samples of a 3-component, rank-2 mixture in 8 dims, the third
    component holding ~2% of them, and the starting parameters of the
    EM."""
    rng = np.random.default_rng(5)
    d, m, k, n = 8, 2, 3, 1500
    lam = 0.7 * _cr(rng, k, d, m)
    mu = np.zeros((k, d)) if zero_mean else _cr(rng, k, d)
    comp = rng.choice(k, n, p=[0.6, 0.38, 0.02])
    x = (mu[comp] + np.einsum("ndm,nm->nd", lam[comp], _cr(rng, n, m))
         + 0.3 * _cr(rng, n, d)).astype(np.complex64)
    w = np.array([0.6, 0.38, 0.02], np.float32)
    params0 = (w, (mu + 0.2 * _cr(rng, k, d)).astype(np.complex64)
               if not zero_mean else np.zeros((k, d), np.complex64),
               (lam + 0.3 * _cr(rng, k, d, m)).astype(np.complex64),
               np.full((k, d), 0.5, np.float32))
    return x, params0


@pytest.mark.parametrize("n_iter", [1, 2, 5])
@pytest.mark.parametrize("case", [
    dict(ppca=True, zero_mean=True, rs_clip=1e-3),      # run_mfa's defaults
    dict(lock_psis=True, zero_mean=False),
    dict(zero_mean=False),
    dict(ppca=True, zero_mean=False, rs_clip=50.0),     # the clip fires
])
def test_fit_resume_matches_jax(case, n_iter):
    x, params0 = _em_data(case["zero_mean"])
    cfg = dict(n_components=3, latent_dim=2, max_iter=n_iter, tol=0.0,
               chunk_size=512, **case)
    want = jmfa.fit_resume(jmfa.MfaParams(*(jnp.asarray(p) for p in params0)),
                           jnp.asarray(x), jmfa.MfaConfig(**cfg))
    got = tmfa.fit_resume(tmfa.params_from_numpy(params0), torch.as_tensor(x),
                          tmfa.MfaConfig(**cfg))
    assert got.n_iter == int(want.n_iter) == n_iter
    for name, g, w in zip(tmfa.MfaParams._fields, got.params, want.params):
        assert _rel(g, w) < 2e-4, name
    np.testing.assert_allclose(float(got.log_likelihood),
                               float(want.log_likelihood), rtol=2e-5)
    if case.get("rs_clip") == 50.0 and n_iter == 1:
        # the ~30-sample component is reset: its weight is rs_clip exactly
        # (the reference's amps = sumrs / N; weights no longer sum to 1)
        assert float(got.params.weights[2]) == pytest.approx(50.0, rel=1e-6)
        assert float(got.params.weights[:2].sum()) < 1.0


def test_fit_runs_the_jax_stopping_rule_and_init():
    x, _ = _em_data(False)
    xt = torch.as_tensor(x)
    gen = torch.Generator().manual_seed(0)
    cfg = tmfa.MfaConfig(n_components=3, latent_dim=2, max_iter=60,
                         tol=1e-3, kmeans_iter=10)
    res = tmfa.fit(gen, xt, cfg)
    assert 6 <= res.n_iter < 60 and res.converged
    assert np.isfinite(float(res.log_likelihood))
    more = tmfa.fit_resume(res.params, xt, cfg._replace(max_iter=3))
    assert float(more.log_likelihood) >= float(res.log_likelihood) - 1e-3
    # psum_segments only splits a process group's all-reduce: one device
    # fits alike (the 2-rank forms are in tests/test_torch_parallel.py)
    seg = tmfa.fit(torch.Generator().manual_seed(0), xt,
                   cfg._replace(psum_segments=2))
    assert seg.n_iter == res.n_iter
    assert float(seg.log_likelihood) == float(res.log_likelihood)
    seg_more = tmfa.fit_resume(res.params, xt,
                               cfg._replace(max_iter=3, psum_segments=2))
    assert float(seg_more.log_likelihood) == float(more.log_likelihood)


def test_to_gmm_params_matches_jax(prior):
    params, _ = prior
    got = tmfa.to_gmm_params(tmfa.params_from_numpy(params), 1e-6)
    want = jmfa.to_gmm_params(jmfa.MfaParams(*(jnp.asarray(p)
                                               for p in params)), 1e-6)
    for name, g, w in zip(("weights", "means", "covariances", "prec_chol"),
                          got, want):
        assert _rel(g, w) < 1e-5, name


# ---------------------------------------------------------------------------
# the factored bank and its pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits,kw,tol", [
    (2, {}, 1e-5), (3, {}, 1e-5), ("inf", {}, 1e-5),
    (1, dict(one_bit="linear-arcsine"), 5e-5)])
def test_prepare_bank_factored_matches_jax(prior, n_bits, kw, tol):
    params, _ = prior
    jbank, tbank, _ = _banks(params, n_bits, **kw)
    for name, g, w in zip(tmb.FactoredBank._fields, tbank, jbank):
        w = np.asarray(w)
        if name == "log_weights":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
            continue
        assert g.dtype == (torch.complex64 if np.iscomplexobj(w)
                           else torch.float32), name
        assert _rel(g, w) < tol, name
    for field in tbank:                       # nothing quadratic in D
        assert field.numel() <= K * D * M


def test_one_bit_refused_and_pilot_checked(prior):
    params, _ = prior
    tp = tmfa.params_from_numpy(params)
    with pytest.raises(ValueError, match="1-bit"):
        tmb.prepare_bank_factored(tp, 10.0, torch.tensor(X0), 1)
    with pytest.raises(ValueError, match="x0"):
        tmb.prepare_bank_factored(tp, 10.0, torch.ones(D, D), 2,
                                  tq.design_quantizer(10.0, 2))
    a_mat = torch.tensor(X0, dtype=torch.complex64) * torch.eye(
        D, dtype=torch.complex64)
    q = tq.design_quantizer(10.0, 2)
    b1 = tmb.prepare_bank_factored(tp, 10.0, torch.tensor(X0), 2, q)
    b2 = tmb.prepare_bank_factored(tp, 10.0, a_mat, 2, q)
    torch.testing.assert_close(b1.bias, b2.bias)


@pytest.mark.parametrize("mode", ["all", 1, 2, 0.9])
@pytest.mark.parametrize("n_bits", [2, "inf"])
def test_estimate_factored_matches_jax(prior, mode, n_bits):
    params, r = prior
    jbank, tbank, _ = _banks(params, n_bits)
    got = tmb.estimate_factored(tbank, torch.as_tensor(r), mode, 200)
    want = jmb.estimate_factored(jbank, jnp.asarray(r), mode, 4096, "xla")
    assert got.dtype == torch.complex64
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("alpha", [1.0, 0.25, 0.0])
def test_estimate_factored_coherent_matches_jax(prior, alpha):
    params, r = prior
    jbank, tbank, _ = _banks(params, 2)
    rb = r.reshape(-1, 4, D)
    got = tmb.estimate_factored_coherent(tbank, torch.as_tensor(rb), "all",
                                         50, alpha)
    want = jmb.estimate_factored_coherent(jbank, jnp.asarray(rb), "all", 64,
                                          alpha, "xla")
    assert _rel(got, want) < 1e-5
    if alpha == 0.0:     # alpha = 0 is the independent per-snapshot estimate
        flat = tmb.estimate_factored(tbank, torch.as_tensor(r))
        assert _rel(got.reshape(-1, D), flat.numpy()) < 1e-6
    with pytest.raises(ValueError, match="blocks"):
        tmb.estimate_factored_coherent(tbank, torch.as_tensor(r))


@pytest.mark.parametrize("t,alpha", [(1, 1.0), (4, 1.0), (4, 0.25)])
def test_stats_forms_match_jax_and_merge(prior, t, alpha):
    """Both stats forms against JAX, and the two-shard merge
    (`circ_kernels.merge_stats`) against the whole-bank estimate."""
    params, r = prior
    jbank, tbank, _ = _banks(params, 2)
    rt = torch.as_tensor(r)
    if t == 1:
        got = tmb.estimate_factored_stats(tbank, rt, 100)
        want = jmb.estimate_factored_stats(jbank, jnp.asarray(r))
    else:
        rb = r.reshape(-1, t, D)
        got = tmb.estimate_factored_coherent_stats(
            tbank, torch.as_tensor(rb), 40, alpha)
        want = jmb.estimate_factored_coherent_stats(jbank, jnp.asarray(rb),
                                                    64, alpha)
    for g, w in zip(got, want):   # a pooled logit sums T float32 logits
        assert _rel(g, w) < (1e-5 if t == 1 else 4e-5)
    states = []
    for lo, hi in ((0, K // 2), (K // 2, K)):
        shard = tmb.FactoredBank(*(x[lo:hi] for x in tbank))
        states.append(tmb.estimate_factored_stats(shard, rt) if t == 1 else
                      tmb.estimate_factored_coherent_stats(
                          shard, rt.reshape(-1, t, D), 1024, alpha))
    _, den, acc = tck.merge_stats(*zip(*states))
    if t == 1:
        whole = tmb.estimate_factored(tbank, rt)
        merged = acc / den[:, None]
    else:
        whole = tmb.estimate_factored_coherent(tbank, rt.reshape(-1, t, D),
                                               alpha=alpha)
        merged = acc / (den[:, None, None] if alpha >= 1.0
                        else den[..., None])
    assert _rel(merged, whole.numpy()) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(np.complex64, 2e-4),
                                       (np.complex128, 1e-9)])
@pytest.mark.parametrize("mode,dead", [("all", False), (1, False),
                                       (0.9, False), ("all", True)])
def test_factored_matches_the_ports_dense_bank(prior, dtype, tol, mode,
                                               dead):
    """The Woodbury form is exact algebra: the factored estimate equals the
    dense bank's of the densified fit (`mfa.to_gmm_params` +
    `gmm_estimator.prepare_bank`), with a dead component masked alike."""
    params, r = prior
    if dead:
        w = params[0].copy()
        w[0] = 1e-9
        params = (w / w.sum(),) + params[1:]
    _, tbank, tp = _banks(params, 2, dtype)
    if dead:
        assert torch.isinf(tbank.log_weights[0])
    # the factored prepare takes x0 in complex64, as the JAX one does
    a_mat = torch.tensor(X0, dtype=torch.complex64).to(
        tp.lambdas.dtype) * torch.eye(D, dtype=tp.lambdas.dtype)
    dense = tge.prepare_bank(tmfa.to_gmm_params(tp), 10.0, a_mat, 2,
                             tq.design_quantizer(10.0, 2))
    rt = torch.as_tensor(r.astype(dtype))
    got = tmb.estimate_factored(tbank, rt, mode)
    want = tge.estimate(dense, rt, mode)
    assert float((got - want).norm() / want.norm()) < tol
    rb = rt[:256].reshape(-1, 4, D)
    got = tmb.estimate_factored_coherent(tbank, rb, mode, alpha=0.25)
    want = tge.estimate_coherent(dense, rb, mode, alpha=0.25)
    assert float((got - want).norm() / want.norm()) < tol


def test_bank_from_numpy_carries_the_jax_bank(prior):
    params, r = prior
    jbank, tbank, _ = _banks(params, 2)
    carried = tmb.bank_from_numpy(jbank)
    assert _rel(tmb.estimate_factored(carried, torch.as_tensor(r)),
                tmb.estimate_factored(tbank, torch.as_tensor(r)).numpy()) \
        < 1e-5
