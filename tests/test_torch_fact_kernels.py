"""The plain versions of the port's factored kernels (K11-K13) against the
JAX package's Pallas kernels in interpret mode, and the one dispatch rule
of `harness.stages` for factored banks.

On the CPU a wrapper of `estimators.fact_kernels` computes its kernel's
plain PyTorch version, the arithmetic the CUDA kernel repeats on the card
(`tests/test_torch_cuda.py` holds the two together there). Here that
arithmetic is held against the JAX package's `estimate_fused_factored`,
`estimate_fused_factored_coherent` and `estimate_fused_factored_stats`
with `interpret=True`, as the JAX tests run them on the CPU, on one bank
made by the JAX package and carried over with `mfa_bank.bank_from_numpy`.

Tolerance: 1e-5 of the output scale, the JAX kernel tests' own
(`tests/test_mfa_bank.py`): both sides are float32 and expand the
quadratic logit, with the products summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_tpu.models import mfa as jmfa
from quantized_channel_estimation_tpu.models import mfa_bank as jmb
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.estimators import circ_kernels as tck
from quantized_channel_estimation_torch.estimators import fact_kernels as tfk
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import mfa_bank as tmb

torch.set_num_threads(2)

D, M, K = 32, 6, 8
X0 = 0.7 - 0.2j
TOL = 1e-5


def _banks(n_bits=2, n_dead=0, zero_mean=False, seed=0):
    """A factored bank prepared by the JAX package from seeded MFA
    parameters at 10 dB, and its port copy."""
    rng = np.random.default_rng(seed)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    lam = (0.5 * cr(K, D, M)).astype(np.complex64)
    psis = (0.1 + rng.uniform(size=(K, D))).astype(np.float32)
    means = (np.zeros((K, D)) if zero_mean else 0.3 * cr(K, D)).astype(
        np.complex64)
    w = (rng.uniform(size=K) + 0.1).astype(np.float32)
    w[:n_dead] = 1e-9
    params = jmfa.MfaParams(jnp.asarray(w / w.sum()), jnp.asarray(means),
                            jnp.asarray(lam), jnp.asarray(psis))
    q = None if n_bits == "inf" else jq.design_quantizer(10.0, n_bits)
    jbank = jmb.prepare_bank_factored(params, 10.0, X0, n_bits, q)
    assert int(np.isinf(np.asarray(jbank.log_weights)).sum()) == n_dead
    return jbank, tmb.bank_from_numpy(jbank)


def _obs(n, seed=1):
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.5, 0.5, 1.5]) * 0.6
    return (rng.choice(levels, (n, D))
            + 1j * rng.choice(levels, (n, D))).astype(np.complex64)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


@pytest.mark.parametrize("n,n_bits,n_dead,zero_mean", [
    (512, 2, 0, True), (333, "inf", 2, False)])
def test_plain_k11_matches_jax_interpret_kernel(n, n_bits, n_dead,
                                                zero_mean):
    jbank, tbank = _banks(n_bits, n_dead, zero_mean)
    r = _obs(n)
    before = tkn.launch_counts()
    got = tfk.estimate_fused_factored(tbank, torch.as_tensor(r))
    assert tkn.launch_counts() == before            # the CPU launches nothing
    assert got.dtype == torch.complex64
    want = pk.estimate_fused_factored(jbank, jnp.asarray(r), tile_n=64,
                                      interpret=True)
    _close(got, want)
    # and the torch.matmul pipeline of either package
    _close(got, jmb.estimate_factored(jbank, jnp.asarray(r), "all", 4096,
                                      "xla"))


@pytest.mark.parametrize("t,alpha,n_blocks", [
    (4, 1.0, 64), (4, 0.25, 37), (4, 0.0, 64), (2, 0.5, 100)])
def test_plain_k12_matches_jax_interpret_kernel(t, alpha, n_blocks):
    jbank, tbank = _banks(n_dead=1)
    r = _obs(n_blocks * t).reshape(n_blocks, t, D)
    got = tfk.estimate_fused_factored_coherent(tbank, torch.as_tensor(r),
                                               alpha)
    want = pk.estimate_fused_factored_coherent(jbank, jnp.asarray(r),
                                               alpha=alpha, interpret=True)
    _close(got, want)


def test_plain_k13_matches_jax_and_merges_with_pipeline_states():
    """One shard through the plain K13, the other through the JAX
    interpret-mode stats kernel and the port's pipeline stats: every
    state agrees with JAX's, and the merge (`circ_kernels.merge_stats`)
    of a kernel state with a pipeline state reproduces K11 over the whole
    bank."""
    jbank, tbank = _banks(n_dead=1)
    r = _obs(256)
    rt = torch.as_tensor(r)
    s1 = tmb.FactoredBank(*(x[:K // 2] for x in tbank))
    s2 = tmb.FactoredBank(*(x[K // 2:] for x in tbank))
    got = tfk.estimate_fused_factored_stats(s1, rt)
    want = pk.estimate_fused_factored_stats(
        jmb.FactoredBank(*(x[:K // 2] for x in jbank)), jnp.asarray(r),
        interpret=True)
    assert got[0].shape == got[1].shape == (256,)
    assert got[2].shape == (256, D)
    for g, w in zip(got, want):
        _close(g, w)
    _, den, acc = tck.merge_stats(*zip(got, tmb.estimate_factored_stats(
        s2, rt)))
    _close(acc / den[:, None], tfk.estimate_fused_factored(tbank, rt).numpy())


def test_fact_kernel_bank_holds_the_jax_operands():
    """The port's operands are JAX's numbers, re-laid per component as
    interleaved [re, im] pairs; `const` for T > 1 is JAX's
    `const - lw + lw / lw_div`."""
    jbank, tbank = _banks(n_dead=1)
    j = pk.fact_kernel_bank(jbank)
    t = tfk.fact_kernel_bank(tbank)
    assert t.fwd.shape == (K, 2 * D, 4 * M) and t.comb.shape == (K, 4 * M,
                                                                2 * D)
    fwd_t = np.asarray(j.fwd_t)                     # (2D, 2KM) split layout
    km = K * M
    for k in (0, K - 1):
        beta_re = fwd_t[:D, k * M:(k + 1) * M]      # Re rows -> Re beta
        np.testing.assert_allclose(t.fwd[k, 0::2, 0:2 * M:2].numpy(),
                                   beta_re, atol=1e-6)
        beta_im = fwd_t[:D, km + k * M:km + (k + 1) * M]
        np.testing.assert_allclose(t.fwd[k, 0::2, 1:2 * M:2].numpy(),
                                   beta_im, atol=1e-6)
    np.testing.assert_allclose(t.const.numpy(), np.asarray(j.const)[0],
                               rtol=1e-5)
    tmu2 = np.asarray(j.tmu2)[0]
    np.testing.assert_allclose(t.tmu[:, 0::2].reshape(-1).numpy(),
                               tmu2[:km], atol=1e-6)
    np.testing.assert_allclose(t.lcoef.numpy(), np.asarray(j.lcoef).T,
                               rtol=1e-5)
    assert t.const[0] == -1e30                       # the dead component
    lw = np.maximum(np.asarray(jbank.log_weights), -1e30)
    t4 = tfk.fact_kernel_bank(tbank, 4, 0.25)
    want = np.asarray(j.const)[0] - lw + lw / (1 - 0.25 + 0.25 * 4)
    np.testing.assert_allclose(t4.const.numpy(), want, rtol=1e-5)
    cache = {}
    assert tfk.lowered(tbank, cache, 4, 0.25) is tfk.lowered(tbank, cache, 4,
                                                             0.25)
    assert set(cache) == {(4, 0.25)}


def test_eligibility_rule_reads_shapes_only():
    assert tfk.fact_kernel_eligible(64, 64, 16)
    assert tfk.fact_kernel_eligible(64, 64, 16, 64)
    assert tfk.fact_kernel_eligible(128, 1000, 64, 32)   # any K, one launch
    assert tfk.fact_kernel_eligible(1, 1, 1)
    assert not tfk.fact_kernel_eligible(129, 8, 4)
    assert not tfk.fact_kernel_eligible(64, 8, 65)
    assert not tfk.fact_kernel_eligible(64, 8, 33, 64)  # past the 32-row tile
    assert not tfk.fact_kernel_eligible(65, 8, 16, 33)
    assert tfk.fact_tile_rows(64, 32) == 64
    assert tfk.fact_tile_rows(65, 16) == tfk.fact_tile_rows(64, 33) == 32


def test_stages_rule_and_refusals(monkeypatch):
    """'auto' sends 'all'-mode requests within `fact_kernel_eligible` to
    the kernel entries and the rest to the pipeline; 'kernel' raises
    outside the range; the wrappers refuse what the kernels do not take."""
    _, tbank = _banks()
    rt = torch.as_tensor(_obs(64))
    calls = []
    for name in ("estimate_fused_factored",
                 "estimate_fused_factored_coherent"):
        def counted(*args, _fn=getattr(tfk, name), _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(tfk, name, counted)
    flat = stages.estimate_factored(tbank, rt)
    coh = stages.estimate_factored_coherent(tbank, rt.reshape(16, 4, D),
                                            alpha=0.5)
    assert calls == ["estimate_fused_factored",
                     "estimate_fused_factored_coherent"]
    _close(flat, tmb.estimate_factored(tbank, rt).numpy())
    _close(coh, tmb.estimate_factored_coherent(
        tbank, rt.reshape(16, 4, D), alpha=0.5).numpy())
    top1 = stages.estimate_factored(tbank, rt, 1)
    long_block = rt.repeat(2, 1).reshape(1, 128, D)  # past the 64-row tile
    wide = stages.estimate_factored_coherent(tbank, long_block)
    assert len(calls) == 2                           # pipeline: no kernel
    _close(top1, tmb.estimate_factored(tbank, rt, 1).numpy())
    _close(wide, tmb.estimate_factored_coherent(tbank, long_block).numpy())
    with pytest.raises(ValueError, match="fact_kernel_eligible"):
        stages.estimate_factored(tbank, rt, 1, method="kernel")
    wide_m = tbank._replace(**{   # M = 66, past the kernels' range
        f: torch.cat([getattr(tbank, f)] * 11, dim=1)
        for f in ("t_mat", "t_mu", "lam_t", "p2_mat", "r_t")})
    with pytest.raises(ValueError, match="fact_kernel_eligible"):
        stages.estimate_factored(wide_m, rt, method="kernel")
    _close(stages.estimate_factored(wide_m, rt),
           tmb.estimate_factored(wide_m, rt).numpy())
    with pytest.raises(ValueError, match="method"):
        stages.estimate_factored(tbank, rt, method="xla")
    with pytest.raises(ValueError, match="blocks"):
        stages.estimate_factored_coherent(tbank, rt)
    with pytest.raises(ValueError, match="T <= 64"):
        tfk.estimate_fused_factored_coherent(tbank, long_block)
    fkb = tfk.fact_kernel_bank(tbank)
    x2 = tck._x2(rt)
    with pytest.raises(ValueError, match="T >= 2"):
        tfk.fact_estimate_coherent(x2, fkb, 1)
    with pytest.raises(ValueError, match="whole number"):
        tfk.fact_estimate_coherent(x2[:10], fkb, 3)
    assert tfk.fact_estimate(x2[:0], fkb).shape == (0, 2 * D)
    m, den, acc = tfk.fact_estimate_stats(x2[:0], fkb)
    assert m.shape == den.shape == (0,) and acc.shape == (0, 2 * D)
    assert {"fact_estimate", "fact_estimate_coherent",
            "fact_estimate_stats"} <= set(tkn.launch_counts())
