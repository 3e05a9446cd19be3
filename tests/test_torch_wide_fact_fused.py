"""The fused K11 / K12 (`csrc/fact_fused_estimate.cu`, 129 <= D <= 256, M
<= 16) on the CPU: the split `fact_kernels.fact_fused_plan` and the bank
layout `fact_fused_operands` read back bit for bit, its plain version
`fact_fused_reference` (which the fused wrappers compute here) against
JAX's interpret-mode K11 and K12 at D = 144 and against the function in
float64, the entries keeping the wide form at every shape the `fused_reach`
leg measured, K13 shards of the wide form merged against the fused K11,
the wrappers' CPU route and the fused mode of `tools.tc_repeat_check`.

The fused kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`test_fact_fused_*`).

Tolerances, with their reasons:
- 2e-4 of the output scale against JAX's interpret-mode kernels and the
  wide form's plain version: all are float32 and expand the quadratic
  logit, whose diagonal and low-rank terms cancel at 10 dB, with the
  products summed in other orders (as in `test_torch_wide_fact.py`);
- 1e-5 of the scale against the function in float64 on the same layout:
  six bf16 products of three-plane splits keep float32's accuracy (the
  float32 plain version is within 1e-6 there);
- 1e-12 for the float64 walk of the plain version against the float64
  function: the same sums in another order;
- 1e-4 of the scale for K13 shards merged against the fused K11: two
  float32 routes of one function;
- bit for bit for the layout: hi + lo + lo2 of a float32 value is the
  value exactly, and the swizzle is a permutation.
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
from quantized_channel_estimation_torch.models import mfa_bank as tmb
from quantized_channel_estimation_torch.tools import mfa_bank_bench
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc

torch.set_num_threads(2)

X0 = 0.7 - 0.2j
TOL = 2e-4
CPU = torch.device("cpu")


def _banks(d, m, k, n_dead=1, seed=0):
    """The factored bank of seeded MFA parameters (loadings 0.5 CN(0, 1),
    psis in [0.1, 1.1), means 0.3 CN(0, 1), the first n_dead weights at
    1e-9) at 10 dB, 2 bits, pilot x0 I, prepared by the JAX package, and
    its port copy."""
    rng = np.random.default_rng(seed)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    lam = (0.5 * cr(k, d, m)).astype(np.complex64)
    psis = (0.1 + rng.uniform(size=(k, d))).astype(np.float32)
    means = (0.3 * cr(k, d)).astype(np.complex64)
    w = (rng.uniform(size=k) + 0.1).astype(np.float32)
    w[:n_dead] = 1e-9
    params = jmfa.MfaParams(*(jnp.asarray(x)
                              for x in (w / w.sum(), means, lam, psis)))
    jbank = jmb.prepare_bank_factored(params, 10.0, X0, 2,
                                      jq.design_quantizer(10.0, 2))
    return jbank, tmb.bank_from_numpy(jbank)


def _obs(n, d, seed=1):
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.5, 0.5, 1.5]) * 0.6
    return (rng.choice(levels, (n, d))
            + 1j * rng.choice(levels, (n, d))).astype(np.complex64)


def _rel(got, want) -> float:
    """max |got - want| / max |want|, both finite and of one shape."""
    got, want = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in (got, want))
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d,m,k", [(129, 16, 2), (144, 8, 5), (200, 3, 3),
                                   (255, 7, 2), (256, 16, 3)])
def test_plan_and_layout_read_back_bit_for_bit(d, m, k):
    """The split (2D's 64-column chunks in halves, the first rounded up,
    each half in two warpgroups' parts, the first rounded up; 64-column
    output pieces below 2D; the record's floats) and the units: each
    unit's planes summed and unswizzled give fwd_k's and comb_k's blocks,
    padding zero; each record T mu and its warpgroup's bins' (lcoef, 0,
    bias, a1), bins past D zero."""
    fkb = trc.random_fact_bank(d, m, k, CPU, n_dead=1)
    pl = tfk.fact_fused_plan(d, m)
    nc = -(-2 * d // 64)
    assert pl.nc == nc and pl.nu == -(-4 * m // 32)
    assert sum(map(sum, pl.ncw)) == nc
    assert all(0 <= a - b <= 1 for a, b in pl.ncw)
    assert 0 <= sum(pl.ncw[0]) - sum(pl.ncw[1]) <= 1
    ops = tfk.fact_fused_operands(fkb)
    assert ops.hi.shape == (k, pl.units, 64, 64)
    assert all(x.dtype == torch.bfloat16 and x.is_contiguous()
               for x in ops[:3])
    units = sum(tkn._sw128(p).float() for p in ops[:3])
    assert torch.equal(units, tfk.fact_fused_units(fkb))
    fwd = torch.zeros(k, 64 * nc, 64)
    comb = torch.zeros(k, 64, 64 * nc)
    at, tp = 0, -(-2 * m // 4) * 4
    for c in range(2):
        for w in range(2):
            cb, ncw, pcs = pl.cb[c][w], pl.ncw[c][w], pl.pcs[c][w]
            off = pl.off[c][w]
            assert cb == 64 * at and off == sum(
                map(sum, pl.u[:c])) + (pl.u[c][0] if w else 0)
            assert pl.u[c][w] == ncw + pcs
            assert pcs == -(-min(64 * ncw, 2 * d - cb) // 64)
            at += ncw
            for j in range(ncw):
                fwd[:, cb + 64 * j:cb + 64 * j + 64] = units[:, off + j].mT
            for p in range(pcs):
                comb[:, :, cb + 64 * p:cb + 64 * p + 64] = units[
                    :, off + ncw + p].mT
            rec = ops.rec[:, 2 * c + w]
            assert torch.equal(rec[:, :2 * m], fkb.tmu)
            bins = rec[:, tp:].reshape(k, 64, 8)
            nb = max(0, min(64, d - cb // 2))
            lc = fkb.lcoef.reshape(k, 3, d).mT[:, cb // 2:cb // 2 + nb]
            assert torch.equal(bins[:, :nb, :3], lc)
            assert torch.equal(bins[:, :nb, 4:6], fkb.bias.reshape(
                k, d, 2)[:, cb // 2:cb // 2 + nb])
            assert torch.equal(bins[:, :nb, 6:], fkb.a1.reshape(
                k, d, 2)[:, cb // 2:cb // 2 + nb])
            assert not bins[:, :, 3].any() and not bins[:, nb:].any()
    assert at == nc and pl.units == sum(map(sum, pl.u))
    assert ops.rec.shape == (k, 4, pl.rec_floats)
    assert torch.equal(fwd[:, :2 * d, :4 * m], fkb.fwd)
    assert not fwd[:, 2 * d:].any() and not fwd[:, :, 4 * m:].any()
    assert torch.equal(comb[:, :4 * m, :2 * d], fkb.comb)
    assert not comb[:, 4 * m:].any()


def test_plain_fused_k11_k12_match_jax_interpret_kernels():
    """At D = 144, M = 8, K = 6: the fused wrappers (their plain version on
    the CPU, nothing launched) against JAX's interpret-mode
    `estimate_fused_factored` and, at T = 4 with alpha 1 and 0.25,
    `estimate_fused_factored_coherent`; the wide form's plain version
    beside them; at K = 1 the fused wrapper and the entry (the wide form)
    likewise."""
    d, m, k = 144, 8, 6
    jbank, tbank = _banks(d, m, k)
    assert pk._fact_kernel_eligible(d, k, m, 4)
    r = _obs(256, d)
    rt = torch.as_tensor(r)
    x2 = tck._x2(rt)
    fkb = tfk.fact_kernel_bank(tbank)
    before = tkn.launch_counts()
    got = tck._hc(tfk.fact_estimate_fused(x2, fkb), torch.complex64)
    assert tkn.launch_counts() == before
    assert torch.equal(got, tck._hc(tfk.fact_fused_reference(x2, fkb),
                                    torch.complex64))
    want = pk.estimate_fused_factored(jbank, jnp.asarray(r), tile_n=64,
                                      interpret=True)
    assert _rel(got, want) < TOL
    assert _rel(tck._hc(tfk.fact_wide_reference(tck._x2(rt), fkb),
                        torch.complex64), got) < TOL
    rb = r.reshape(64, 4, d)
    for alpha in (1.0, 0.25):
        got = tck._hc(tfk.fact_estimate_coherent_fused(
            x2, tfk.fact_kernel_bank(tbank, 4, alpha), 4, alpha),
            torch.complex64).reshape(64, 4, d)
        assert _rel(got, pk.estimate_fused_factored_coherent(
            jbank, jnp.asarray(rb), alpha=alpha, interpret=True)) < TOL
    jbank, tbank = _banks(d, m, 1)
    got = tck._hc(tfk.fact_estimate_fused(x2, tfk.fact_kernel_bank(tbank)),
                  torch.complex64)
    want = pk.estimate_fused_factored(jbank, jnp.asarray(r), tile_n=64,
                                      interpret=True)
    assert _rel(got, want) < TOL
    entry = tfk.estimate_fused_factored(tbank, rt)
    assert torch.equal(entry, tck._hc(tfk.fact_wide_reference(
        x2, tfk.fact_kernel_bank(tbank)), torch.complex64))
    assert _rel(entry, want) < TOL


@pytest.mark.parametrize("d,m,k,t,alpha", [
    (144, 8, 5, 1, 1.0), (256, 16, 4, 4, 0.25), (200, 3, 3, 16, 1.0),
    (129, 16, 2, 3, 0.5), (255, 7, 40, 1, 1.0)])
def test_plain_fused_version_keeps_fp32_accuracy(d, m, k, t, alpha):
    """`fact_fused_reference` within 1e-5 of the scale of the function in
    float64 on the same layout (`_fact_reference` on float64 rows), and its
    own float64 walk (plain products) within 1e-12 of it."""
    fkb = trc.random_fact_bank(d, m, k, CPU, n_dead=1, t_coh=t)
    x2 = trc.random_rows(24 * t, 2 * d, CPU)
    exact = tfk._fact_reference(x2.double(), tfk.FactKernelBank(
        *(v.double() for v in fkb)), t, alpha, False, 8192)
    assert _rel(tfk.fact_fused_reference(x2, fkb, t, alpha), exact) < 1e-5
    assert _rel(tfk.fact_fused_reference(x2.double(), fkb, t, alpha),
                exact) < 1e-12


# (D, K, M, T) of `tools/mfa_bank_bench.py fused_reach`, measured on the
# H100 (PERF.md §6): the fused kernel slower than the wide form from K = 4
# (0.27-0.93x), faster only at one or two components, widths no workload of
# the repo runs; so the entries keep the wide form at every one
@pytest.mark.parametrize("shape", mfa_bank_bench.FUSED_REACH_SHAPES)
def test_entries_keep_the_wide_form_at_the_fused_reach_shapes(shape):
    """Each shape of the `fused_reach` leg fits the fused kernel's tile and
    lies past the template's rule, where the entries take the wide form."""
    d, k, m, t = shape
    assert tfk.fact_fused_fits(d, m, t)
    assert not tfk.fact_narrow(d, k, m, t)
    assert tfk.fact_wide_eligible(d, k, m, t)
    assert tfk.fact_kernel_eligible(d, k, m, t)


def test_entries_launch_the_wide_wrappers_not_the_fused(monkeypatch):
    """At a shape inside the fused kernel's tile (D = 144, K = 1, M = 8)
    the entries call the wide wrappers of K11, K12 and K13 and never a
    fused one; `lowered_tc` lays out the wide form's operands."""
    calls = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for name in ("fact_estimate_wide", "fact_estimate_coherent_wide",
                 "fact_estimate_stats_wide", "fact_estimate_fused",
                 "fact_estimate_coherent_fused"):
        monkeypatch.setattr(tfk, name, recorded(name, getattr(tfk, name)))
    d, m = 144, 8
    _, tbank = _banks(d, m, 1)
    rt = torch.as_tensor(_obs(32, d))
    tfk.estimate_fused_factored(tbank, rt)
    tfk.estimate_fused_factored_coherent(tbank, rt.reshape(8, 4, d))
    tfk.estimate_fused_factored_stats(tbank, rt)
    assert calls == ["fact_estimate_wide", "fact_estimate_coherent_wide",
                     "fact_estimate_stats_wide"]
    cache = {}
    assert tfk.lowered_tc(tbank, cache) is cache["fact_wide_operands"]


def test_k13_shards_of_the_wide_form_merge_with_the_fused_k11():
    """Two component shards through the entry of K13 (the wide form's
    plain version: K13 has no fused form), merged (`merge_stats`), within
    1e-4 of the scale of the fused K11's wrapper (its plain version here)
    over the whole bank, flat rows at D = 144, M = 8."""
    d, m, k = 144, 8, 4
    _, tbank = _banks(d, m, k, seed=2)
    rt = torch.as_tensor(_obs(96, d, seed=3))
    states = [tfk.estimate_fused_factored_stats(
        tmb.FactoredBank(*(x[j * k // 2:(j + 1) * k // 2] for x in tbank)),
        rt) for j in range(2)]
    _, den, acc = tck.merge_stats(*zip(*states))
    whole = tck._hc(tfk.fact_estimate_fused(
        tck._x2(rt), tfk.fact_kernel_bank(tbank)), torch.complex64)
    assert torch.equal(whole, tck._hc(tfk.fact_fused_reference(
        tck._x2(rt), tfk.fact_kernel_bank(tbank)), torch.complex64))
    assert _rel(acc / den[:, None], whole) < 1e-4


def test_fused_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the fused wrappers return their plain version, launch
    nothing and lay nothing out; K12's wrapper refuses T < 2."""
    d, m, k = 200, 8, 3
    fkb = trc.random_fact_bank(d, m, k, CPU, n_dead=1)
    fkb4 = trc.random_fact_bank(d, m, k, CPU, n_dead=1, t_coh=4)
    x2 = trc.random_rows(32, 2 * d, CPU)
    before = tkn.launch_counts()
    assert torch.equal(tfk.fact_estimate_fused(x2, fkb),
                       tfk.fact_fused_reference(x2, fkb))
    assert torch.equal(tfk.fact_estimate_coherent_fused(x2, fkb4, 4, 0.5),
                       tfk.fact_fused_reference(x2, fkb4, 4, 0.5))
    assert tkn.launch_counts() == before
    assert {"fact_estimate_fused", "fact_estimate_coherent_fused"} <= set(
        before)
    with pytest.raises(ValueError, match="T >= 2"):
        tfk.fact_estimate_coherent_fused(x2, fkb, 1)


def test_tc_repeat_check_fused_fact_mode_on_cpu():
    """Mode 'fused_fact' of `tc_repeat_check` through the plain versions:
    every launch held, none off; its card shapes all fit the fused
    kernel's tile: D one past the template's, a ragged half, the served
    shape, M = 3 and 8, the pool at T = 3, 4, 16 and 64, K11 and K12."""
    shapes = ((130, 3, 2, 40, 1, 1, 1.0, "K11"),
              (144, 9, 3, 4 * 9, 0, 4, 0.5, "K12"))
    got = trc.repeat_check(CPU, repeats=2, poison=False,
                           modes=("fused_fact",), fused_fact_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for label, rec in got["kernel"].items():
        assert label.endswith(" fused")
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    shapes = trc.FUSED_FACT_SHAPES
    assert all(tfk.fact_fused_fits(d, m, t)
               for d, m, k, _, _, t, _, _ in shapes)
    assert {3, 4, 16, 64} <= {s[5] for s in shapes}
    assert {"K11", "K12"} == {s[7] for s in shapes}
    assert any(s[0] == 129 for s in shapes) and any(
        s[0] % 32 for s in shapes)


def test_mfa_bank_bench_kernel_legs_need_a_card():
    """The `fused` and `fused_reach` legs time kernels: on the CPU they
    refuse, before any work."""
    for leg in ("fused", "fused_reach"):
        with pytest.raises(SystemExit):
            mfa_bank_bench.main([leg], device="cpu")
