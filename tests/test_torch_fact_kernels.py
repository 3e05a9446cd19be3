"""The plain versions of the port's factored kernels (K11-K13) against the
JAX package's Pallas kernels in interpret mode, the kernel's tensor-core
layout of the bank and the plain version of its six-product arithmetic,
the repeated-launch check of `tools.tc_repeat_check` (mode 'fact') on the
plain versions, and the one dispatch rule of `harness.stages` for factored
banks.

On the CPU a wrapper of `estimators.fact_kernels` computes its kernel's
plain PyTorch version, the arithmetic the CUDA kernel repeats on the card
(`tests/test_torch_cuda.py` holds the two together there). Here that
arithmetic is held against the JAX package's `estimate_fused_factored`,
`estimate_fused_factored_coherent` and `estimate_fused_factored_stats`
with `interpret=True`, as the JAX tests run them on the CPU, on one bank
made by the JAX package and carried over with `mfa_bank.bank_from_numpy`.

Tolerance: 1e-5 of the output scale, the JAX kernel tests' own
(`tests/test_mfa_bank.py`): both sides are float32 and expand the
quadratic logit, with the products summed in another order. The plain
six-product version (`fact_tc_reference`) is held to the same 1e-5 of the
scale against the float32 plain version and to the float64 rule the card
holds the kernel to: its max error against the plain version in float64
at most twice the float32 plain version's own. (The six bf16 products drop
only terms of order 2^-24 of each product, but on these banks the float32
plain version is itself 2-6e-6 of the scale off float64, the logits
cancelling, so two float32 orders differ by up to ~4e-6.) The layout is
read back bit for bit.
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
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc

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
    """The template's rule (`fact_narrow`): D <= 128, M <= 64, any K, T <=
    64 at every width (one consumer warpgroup's 64-row tile); one past its
    D or M the wide form admits the shape; one past T every form
    refuses."""
    assert tfk.fact_kernel_eligible(64, 64, 16)
    assert tfk.fact_kernel_eligible(64, 64, 16, 64)
    assert tfk.fact_kernel_eligible(128, 1000, 64, 64)   # any K, one launch
    assert tfk.fact_kernel_eligible(1, 1, 1)
    assert tfk.fact_kernel_eligible(64, 8, 33, 64)
    assert tfk.fact_kernel_eligible(65, 8, 16, 33)
    assert not tfk.fact_narrow(129, 8, 4)
    assert tfk.fact_kernel_eligible(129, 8, 4)           # the wide form
    assert not tfk.fact_narrow(64, 8, 65)
    assert tfk.fact_kernel_eligible(64, 8, 65)
    assert not tfk.fact_kernel_eligible(64, 8, 16, 65)   # past the tile
    assert not tfk.fact_kernel_eligible(128, 8, 64, 65)
    assert tfk.fact_tile_rows(64, 32) == tfk.fact_tile_rows(128, 64) == 64


def test_stages_rule_and_refusals(monkeypatch):
    """'auto' sends 'all'-mode requests within `fact_kernel_eligible` to
    the kernel entries and the rest to the pipeline; 'kernel' raises
    outside the range (a block past the 64-row tile); an M = 66 bank, past
    the template, goes through the wide entries; the wrappers refuse what
    the kernels do not take."""
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
    wide_m = tbank._replace(**{   # M = 66, past the template's range
        f: torch.cat([getattr(tbank, f)] * 11, dim=1)
        for f in ("t_mat", "t_mu", "lam_t", "p2_mat", "r_t")})
    with pytest.raises(ValueError, match="fact_kernel_eligible"):
        stages.estimate_factored_coherent(tbank, long_block, method="kernel")
    got = stages.estimate_factored(wide_m, rt, method="kernel")
    assert len(calls) == 3                           # the wide entry
    assert torch.equal(got, tfk.estimate_fused_factored(wide_m, rt))
    _close(got, tmb.estimate_factored(wide_m, rt).numpy())
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


# ---------------------------------------------------------------------------
# the tensor-core layout and the plain six-product version
# ---------------------------------------------------------------------------

def _random_fkb(d, m, k=3, seed=0):
    return trc.random_fact_bank(d, m, k, torch.device("cpu"), 1, seed=seed)


def _unswizzle_units(plane, pw):
    """A plane of units (K, U, pw, 64), swizzled -> the same unswizzled
    (the 128-byte swizzle is its own inverse)."""
    return tkn._sw128(plane)


@pytest.mark.parametrize("d,m", [(32, 6), (8, 3), (100, 24), (128, 64)])
def test_fact_tc_operands_unpermute_bit_for_bit(d, m):
    """The kernel's units read back to `split_planes3` of fwd and comb bit
    for bit, padding zero, at padded widths (4M = 24 of a 64-column piece at
    M = 6, D = 32) and at the 32- and 16-column pieces; the record holds
    T mu and the per-bin lcoef, bias and a1."""
    fkb = _random_fkb(d, m)
    k = fkb.fwd.shape[0]
    ops = tfk.fact_tc_operands(fkb)
    pw, ncx, ncu = tfk.fact_tc_shape(d, m)
    assert pw == (16 if (ncx, ncu) == (4, 4) else
                  32 if 4 in (ncx, ncu) else 64)
    fp, cp = -(-4 * m // pw), -(-2 * d // pw)
    tfk.check_fact_tc_operands("k", ops, fkb, torch.device("cpu"))
    for plane, want_f, want_c in zip(
            (ops.hi, ops.lo, ops.lo2), tkn.split_planes3(fkb.fwd),
            tkn.split_planes3(fkb.comb)):
        units = _unswizzle_units(plane, pw)            # (K, U, pw, 64)
        fwd_u = units[:, :fp * ncx].reshape(k, fp, ncx, pw, 64)
        fwd = fwd_u.permute(0, 2, 4, 1, 3).reshape(k, ncx * 64, fp * pw)
        comb_u = units[:, fp * ncx:].reshape(k, cp, ncu, pw, 64)
        comb = comb_u.permute(0, 2, 4, 1, 3).reshape(k, ncu * 64, cp * pw)
        assert torch.equal(fwd[:, :2 * d, :4 * m], want_f)
        assert torch.equal(comb[:, :4 * m, :2 * d], want_c)
        assert not fwd[:, 2 * d:].any() and not fwd[:, :, 4 * m:].any()
        assert not comb[:, 4 * m:].any() and not comb[:, :, 2 * d:].any()
    two_mp = -(-2 * m // 4) * 4
    assert torch.equal(ops.rec[:, :2 * m], fkb.tmu)
    assert not ops.rec[:, 2 * m:two_mp].any()
    bins = ops.rec[:, two_mp:].reshape(k, d, 8)
    assert torch.equal(bins[..., :3].transpose(1, 2).reshape(k, 3 * d),
                       fkb.lcoef)
    assert not bins[..., 3].any()
    assert torch.equal(bins[..., 4:6].reshape(k, 2 * d), fkb.bias)
    assert torch.equal(bins[..., 6:].reshape(k, 2 * d), fkb.a1)


def test_fact_tc_operands_are_cached_and_checked():
    """`lowered_tc` lays the bank out once per cache; the check refuses a
    missing plane, a wrong type, shape or layout of another width."""
    _, tbank = _banks(n_dead=1)
    cache = {}
    ops = tfk.lowered_tc(tbank, cache)
    assert tfk.lowered_tc(tbank, cache) is ops
    assert set(cache) == {(1, 1.0), "fact_tc_operands"}
    fkb = tfk.fact_kernel_bank(tbank)
    want = tfk.fact_tc_operands(fkb)
    assert all(torch.equal(a, b) for a, b in zip(ops, want))
    cpu = torch.device("cpu")
    tfk.check_fact_tc_operands("k", ops, fkb, cpu)
    for bad in (ops._replace(lo2=None), ops._replace(hi=ops.hi.float()),
                ops._replace(rec=ops.rec[:, :-1].contiguous()),
                tfk.fact_tc_operands(_random_fkb(D, 2 * M, K))):
        with pytest.raises(ValueError, match="fact_tc_operands"):
            tfk.check_fact_tc_operands("k", bad, fkb, cpu)


@pytest.mark.parametrize("kernel,t,alpha", [
    ("K11", 1, 1.0), ("K12", 4, 0.25), ("K12", 4, 1.0), ("K13", 1, 1.0)])
def test_fact_tc_reference_matches_plain_and_jax(kernel, t, alpha):
    """The plain six-product version against the float32 plain version
    (1e-6 of the scale) and the JAX interpret-mode kernels (1e-5), for K11,
    K12 (T = 4) and K13 on one component shard."""
    jbank, tbank = _banks(n_dead=1)
    r = _obs(256)
    x2 = tck._x2(torch.as_tensor(r))
    if kernel == "K13":
        shard = tmb.FactoredBank(*(x[:K // 2] for x in tbank))
        fkb = tfk.fact_kernel_bank(shard)
        got = tfk.fact_tc_reference(x2, fkb, stats=True)
        plain = tfk.fact_estimate_stats_reference(x2, fkb)
        want = pk.estimate_fused_factored_stats(
            jmb.FactoredBank(*(x[:K // 2] for x in jbank)), jnp.asarray(r),
            interpret=True)
        exact = tfk.fact_estimate_stats_reference(
            x2.double(), type(fkb)(*(x.double() for x in fkb)))
        for g, p, e, w in zip(got, plain, exact, want):
            _close(g, p.numpy())
            _held64(g, p, e)
            _close(tck._hc(g, torch.complex64) if g.dim() == 2 else g, w)
        return
    fkb = tfk.fact_kernel_bank(tbank, t, alpha)
    f64 = type(fkb)(*(x.double() for x in fkb))
    got = tfk.fact_tc_reference(x2, fkb, t, alpha)
    if t == 1:
        plain = tfk.fact_estimate_reference(x2, fkb)
        exact = tfk.fact_estimate_reference(x2.double(), f64)
        want = pk.estimate_fused_factored(jbank, jnp.asarray(r), tile_n=64,
                                          interpret=True)
    else:
        plain = tfk.fact_estimate_coherent_reference(x2, fkb, t, alpha)
        exact = tfk.fact_estimate_coherent_reference(x2.double(), f64, t,
                                                     alpha)
        want = pk.estimate_fused_factored_coherent(
            jbank, jnp.asarray(r).reshape(-1, t, D), alpha=alpha,
            interpret=True).reshape(-1, D)
    _close(got, plain.numpy())
    _held64(got, plain, exact)
    _close(tck._hc(got, torch.complex64), want)


def _held64(got, plain, exact):
    """The float64 rule: got's max |error| against `exact` at most twice
    the float32 plain version's."""
    def err(x):
        return float((x.double() - exact).abs().max())
    assert err(got) <= 2 * err(plain), (err(got), err(plain))


def test_new_tile_rule_admits_every_old_shape():
    """The tensor-core template's rule admits every (D, M, T) the float32
    template's did (T up to 64 while D <= 64 and M <= 32, else 32), and
    T up to 64 at every width."""
    for d in range(1, tfk.FACT_MAX_D + 1):
        for m in range(1, tfk.FACT_MAX_M + 1):
            old = 64 if d <= 64 and m <= 32 else 32
            assert tfk.fact_kernel_eligible(d, 5, m, old)
            assert tfk.fact_kernel_eligible(d, 5, m, 64)
            assert not tfk.fact_kernel_eligible(d, 5, m, 65)


def test_tc_repeat_check_fact_mode_on_cpu():
    """Mode 'fact' of `tc_repeat_check` (K11, K12, K13) through the plain
    versions: every launch held, none off; its card shapes cover the
    combine's A in registers with one and two warpgroups, A in shared memory
    with 64-, 32- and 16-column pieces, each pooling route and K13."""
    shapes = ((8, 3, 3, 70, 1, 1, 1.0, "K11"), (12, 20, 2, 4 * 9, 0, 4, 0.5,
                                                  "K12"),
              (8, 3, 2, 3 * 11, 0, 3, 1.0, "K12"), (10, 5, 4, 33, 1, 1, 1.0,
                                                    "K13"))
    got = trc.repeat_check(torch.device("cpu"), repeats=2, poison=False,
                           modes=("fact",), fact_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for rec in got["kernel"].values():
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    forms = {(tfk.fact_tc_shape(d, m), n >= 2 * 132 * 64 // t, t, name)
             for d, m, _, n, _, t, _, name in trc.FACT_SHAPES}
    pws = {f[0][0] for f in forms}
    assert pws == {16, 32, 64}
    ars = {f[1] for f in forms if f[0][1] <= 2 and f[0][2] == 1}
    assert ars == {True, False}            # one and two warpgroups
    assert {1, 3, 4, 16, 64} <= {f[2] for f in forms}
    assert {"K11", "K12", "K13"} == {f[3] for f in forms}
