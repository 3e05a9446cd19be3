"""The factorised circulant kernel's route on the CPU
(`csrc/circ_fact_estimate.cu`: K6 and K7, and with its STATS form K8 and
K9, past D = 128 wherever the transform splits into two levels of at most
64 points): the split rule, the plain factorised transform against
`torch.fft`, the permuted and padded layouts, the route each entry takes,
the plain K6-K9 of the route against JAX's interpret-mode kernels at D =
144, and the stats forms' states merged over shards.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`test_circ_fact_*`); here every wrapper computes its plain version
`circ_fact_reference` (with `stats=True` for K8 / K9: m, den and the
accumulator taken back to natural bin order).

Tolerances, with their reasons:
- 1e-12 of the scale for the factorised transform in float64 against
  `torch.fft` in float64: the same sums in another order;
- 1e-6 of the scale in complex64: the tables rounded once to float32 and
  float32 sums over at most 64 points a level;
- 1e-5 of the scale between the factorised route and the plain wide
  version (`circ_estimate_reference`; the stats forms' `_circ_reference`,
  for each of m, den and acc), both in float64 on one float32 layout: what
  parts them is the layout's DFT matrix rounded to float32 (about 4e-7 at
  these inputs), which the factorised route does not read; and between a
  K = 200 bank's two shards merged and one plain factorised K6 in float32
  (the two round the softmax over other sets of components, about 4e-7);
- bit for bit for the operands: hi + lo + lo2 of a float32 value is the
  value exactly, and the permutation and the padding move values only;
- 2e-4 of the output scale against JAX's interpret-mode kernels, the
  circulant tests' own (`tests/test_torch_circ_kernels.py`): both sides
  are float32 and expand the quadratic logit, which cancels.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import tc_units as tu
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from test_torch_circ_kernels import _banks, _close, _obs

torch.set_num_threads(2)


@pytest.mark.parametrize("d,want", [
    (512, (16, 32)), (672, (24, 28)), (357, (17, 21)), (144, (12, 12)),
    (129, (3, 43)), (600, (24, 25)), (640, (20, 32)), (256, (16, 16)),
    (652, None), (131, None), (134, None), (641, None)])
def test_split_is_the_most_balanced_pair_within_64(d, want):
    """`circ_fact_split`: D = d1 d2 with 2 <= d1 <= d2 <= 64, d1 the
    largest divisor of D at most sqrt(D); None where D has a prime factor
    past 64 (652 = 4 x 163, 134 = 2 x 67) or is prime."""
    assert ck.circ_fact_split(d) == want


def test_split_admits_314_of_the_wide_widths():
    """Every admitted width 129-672 splits into two levels of at most 64
    points, and no divisor lies nearer sqrt(D); 314 of the 544 widths
    are admitted, the rest keep the dense wide form."""
    admitted = [d for d in range(129, 673) if ck.circ_fact_split(d)]
    assert len(admitted) == 314
    for d in admitted:
        d1, d2 = ck.circ_fact_split(d)
        assert d1 * d2 == d and 2 <= d1 <= d2 <= 64
        assert not any(d % e == 0 and d // e <= 64
                       for e in range(d1 + 1, math.isqrt(d) + 1))
    assert sum(ck.circ_route(d) == "wide" for d in range(129, 673)) == 230


def test_kron_basis_levels_are_its_blocks():
    """`circ_fact_blocks` of a kron(F_n1, F_n2) basis is (n1, n2) itself
    where both are 2-64 (unit twiddles between the levels), else None."""
    assert ck.circ_fact_blocks(256, (16, 16)) == (16, 16)
    assert ck.circ_fact_blocks(256, (4, 64)) == (4, 64)
    assert ck.circ_fact_blocks(512, (8, 64)) == (8, 64)
    assert ck.circ_fact_blocks(256, (2, 128)) is None
    assert ck.circ_fact_blocks(256, (1, 256)) is None
    assert ck.circ_route(256, (2, 128)) == "wide"
    assert ck.circ_route(256, (16, 16)) == "fact"
    perm = ck.circ_fact_perm(256, (16, 16))
    assert torch.equal(perm, torch.arange(256))


@pytest.mark.parametrize("d,blocks", [
    (144, None), (160, None), (357, None), (512, None), (672, None),
    (512, (16, 32))])
def test_factorised_transform_matches_fft_in_float64(d, blocks):
    """The plain factorised transform, forward and inverse, against
    `torch.fft` in float64 (bins at `circ_fact_perm`'s positions) within
    1e-12 of the scale, and in complex64 within 1e-6."""
    d1, d2 = ck.circ_fact_blocks(d, blocks)
    kron = blocks is not None
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.standard_normal((6, d))
                        + 1j * rng.standard_normal((6, d)))
    want = tsb.unitary_fft(x, blocks)[:, ck.circ_fact_perm(d, blocks)]
    got = ck.circ_fact_transform(x, d1, d2, kron)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12
    back = ck.circ_fact_transform(got, d1, d2, kron, inverse=True)
    assert float((back - x).abs().max() / x.abs().max()) < 1e-12
    got32 = ck.circ_fact_transform(x.to(torch.complex64), d1, d2, kron)
    assert float((got32 - want).abs().max() / want.abs().max()) < 1e-6


@pytest.mark.parametrize("d,blocks,t,alpha", [
    (144, None, 1, 1.0), (512, None, 4, 0.5), (256, (16, 16), 1, 1.0),
    (357, None, 3, 1.0)])
def test_permuted_route_equals_the_plain_wide_version(d, blocks, t, alpha):
    """The factorised route's plain version (bins permuted, the layout's
    lcoef rows and comb columns permuted to match) equals the plain wide
    version `circ_estimate_reference` on the same float32 layout, both
    evaluated in float64, within 1e-5 of the scale."""
    _, tb = _banks(n_dead=2, d=d, blocks=blocks, k=8)
    ckb = ck.circ_kernel_bank(tb, blocks, t, alpha)
    f64 = ck.CircKernelBank(*(x.double() for x in ckb))
    x2 = ck._x2(torch.as_tensor(_obs(96 // t * t, d=d))).double()
    want = ck._circ_reference(x2, f64, t, alpha, False, 16384)
    got = ck.circ_fact_reference(x2, f64, t, alpha, blocks)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_plain_fact_k6_k7_match_jax_interpret_kernels_at_d144():
    """The new route's plain K6 (two dead components) and K7 (T = 4, alpha
    0.25), through the route's wrappers on CPU tensors, against JAX's
    interpret-mode `estimate_circ_packed` and `_circ_kernel_coh`: two
    interpret calls of 256 rows."""
    jbank, tbank = _banks(n_dead=2, d=144)
    r = _obs(256, d=144)
    ckb = ck.circ_kernel_bank(tbank)
    got = ck._hc(ck.circ_estimate_fact(ck._x2(torch.as_tensor(r)), ckb),
                 torch.complex64)
    _close(got, pk.estimate_fused_circulant(jbank, jnp.asarray(r),
                                            interpret=True))
    ckb4 = ck.circ_kernel_bank(tbank, None, 4, 0.25)
    got = ck.circ_estimate_coherent_fact(ck._x2(torch.as_tensor(r)), ckb4, 4,
                                         0.25)
    want = pk.estimate_fused_circulant_coherent(
        jbank, jnp.asarray(r.reshape(64, 4, 144)), alpha=0.25,
        interpret=True)
    _close(ck._hc(got, torch.complex64).reshape(64, 4, 144), want)


def test_plain_fact_k8_k9_match_jax_interpret_kernels_at_d144():
    """The route's plain K8 and K9 (T = 4, alpha 0.25), two dead
    components, through the new wrappers on CPU tensors: (m, den, acc)
    against JAX's interpret-mode `estimate_fused_circulant_stats` and
    `estimate_fused_circulant_coherent_stats` (per-snapshot m and den
    below alpha 1): two interpret calls of 256 rows."""
    jbank, tbank = _banks(n_dead=2, d=144)
    r = _obs(256, d=144)
    x2 = ck._x2(torch.as_tensor(r))
    m, den, acc = ck.circ_estimate_stats_fact(x2, ck.circ_kernel_bank(tbank))
    want = pk.estimate_fused_circulant_stats(jbank, jnp.asarray(r),
                                             interpret=True)
    for g, w in zip((m, den, ck._hc(acc, torch.complex64)), want):
        _close(g, w)
    ckb4 = ck.circ_kernel_bank(tbank, None, 4, 0.25)
    m, den, acc = ck.circ_estimate_coherent_stats_fact(x2, ckb4, 4, 0.25)
    want = pk.estimate_fused_circulant_coherent_stats(
        jbank, jnp.asarray(r.reshape(64, 4, 144)), alpha=0.25,
        interpret=True)
    got = (m.reshape(64, 4), den.reshape(64, 4),
           ck._hc(acc, torch.complex64).reshape(64, 4, 144))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("d,blocks,t,alpha", [
    (144, None, 1, 1.0), (512, None, 4, 0.5), (256, (16, 16), 1, 1.0),
    (357, None, 3, 1.0)])
def test_fact_stats_plain_equals_the_dense_plain_in_float64(d, blocks, t,
                                                            alpha):
    """The factorised stats plain version (m, den and the accumulator
    taken back to natural bin order) equals the dense plain stats
    `_circ_reference(..., stats=True)` on the same float32 layout, both
    in float64, within 1e-5 of the scale of each."""
    _, tb = _banks(n_dead=2, d=d, blocks=blocks, k=8)
    ckb = ck.circ_kernel_bank(tb, blocks, t, alpha)
    f64 = ck.CircKernelBank(*(x.double() for x in ckb))
    x2 = ck._x2(torch.as_tensor(_obs(96 // t * t, d=d))).double()
    want = ck._circ_reference(x2, f64, t, alpha, True, 16384)
    got = ck.circ_fact_reference(x2, f64, t, alpha, blocks, stats=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5


def test_k200_shards_merge_to_the_factorised_k6_at_d512():
    """A K = 200 bank at D = 512 through `estimate_fused_circulant`: its
    two shards' stats (128 and 72 components, both on the factorised K8's
    route, so its plain version), merged and inverse-transformed once,
    equal the factorised K6's plain version over the whole bank within
    1e-5 of the scale. (At D = 256 the route sends the 128-component shard
    to the dense wide form, 3 K > D.)"""
    _, tb = _banks(n_dead=3, d=512, k=200)
    r = torch.as_tensor(_obs(64, d=512))
    assert [ck.circ_route(512, None, True, c.const.shape[0])
            for c in ck.lowered(tb)] == ["fact", "fact"]
    assert ck.circ_route(256, None, True, 128) == "wide"
    got = ck._x2(ck.estimate_fused_circulant(tb, r))
    want = ck.circ_fact_reference(ck._x2(r), ck.circ_kernel_bank(tb))
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("d,k,t,blocks,want", [
    (512, 16, 1, None, "fact"), (512, 16, 64, None, "fact"),
    (512, 128, 4, None, "fact"), (672, 128, 1, None, "fact"),
    (336, 64, 1, None, "fact"), (357, 32, 1, None, "fact"),
    (160, 8, 16, None, "fact"), (256, 16, 4, (16, 16), "fact"),
    (256, 64, 1, (8, 32), "fact"), (144, 64, 1, None, "wide"),
    (336, 128, 1, None, "wide"), (357, 128, 4, None, "wide"),
    (129, 16, 1, None, "wide"), (133, 16, 1, None, "wide"),
    (185, 16, 1, None, "wide"), (200, 16, 64, None, "wide"),
    (652, 1, 1, None, "wide"), (256, 16, 1, (2, 128), "wide")])
def test_stats_route_takes_the_factorised_kernel_where_it_was_faster(
        d, k, t, blocks, want):
    """`circ_route(..., stats=True)` at the shapes of the `stats_reach`
    leg (PERF.md §6): the factorised STATS form where it was measured
    faster than the dense wide form, the dense wide form where it lost (3
    K > D; dense odd-prime stages past D / 10 points; two sweeps with odd
    primes) or cannot take the transform; K6 / K7 keep the factorised
    kernel wherever D splits."""
    assert ck.circ_route(d, blocks, True, k, t) == want
    assert ck.circ_stats_fact_eligible(d, k, t, blocks) == (want == "fact")
    split = ck.circ_fact_blocks(d, blocks) is not None
    assert ck.circ_route(d, blocks, False, k, t) == ("fact" if split
                                                    else "wide")


def test_stats_fact_wrappers_on_cpu_take_the_plain_route():
    """On CPU tensors the factorised stats wrappers return their plain
    version in the layout's own basis (the operands' basis where given),
    the public stats wrappers the same where the route is 'fact', nothing
    launches, K9 refuses T < 2; both are counted kernels."""
    _, tb = _banks(n_dead=1, d=256, blocks=(16, 16), k=4)
    ckb = ck.circ_kernel_bank(tb, (16, 16))
    x2 = ck._x2(torch.as_tensor(_obs(20, d=256)))
    before = tkn.launch_counts()
    got = ck.circ_estimate_stats_fact(x2, ckb)
    want = ck.circ_fact_reference(x2, ckb, 1, 1.0, (16, 16), stats=True)
    ops = ck.circ_fact_operands(ckb, (16, 16))
    for g, g2, g3, w in zip(got, ck.circ_estimate_stats_fact(x2, ckb, ops),
                            ck.circ_estimate_stats(x2, ckb), want):
        assert torch.equal(g, w) and torch.equal(g2, w) and torch.equal(g3, w)
    assert tkn.launch_counts() == before
    with pytest.raises(ValueError, match="T >= 2"):
        ck.circ_estimate_coherent_stats_fact(x2, ckb, 1)
    assert {"circ_estimate_stats_fact",
            "circ_estimate_coherent_stats_fact"} <= set(tkn.launch_counts())


def _decode(frags, depth, cols, k_major):
    """The float64 operand behind B fragments: hi + lo + lo2 of each
    lane's four values back at (k16 step, n8 tile) row 16 s + 2q + p + 8h,
    column 8 t + g (lane 4 g + q, value 2h + p)."""
    a, b = -(-depth // 16), -(-cols // 8)
    f = frags.reshape(*((a, b) if k_major else (b, a)), 8, 4, 2, 2)
    if not k_major:
        f = f.transpose(0, 1)
    return f.permute(0, 4, 3, 5, 1, 2).reshape(16 * a, 8 * b)[:depth, :cols]


@pytest.mark.parametrize("d,k,blocks", [(144, 8, None), (357, 13, None),
                                        (256, 5, (16, 16))])
def test_fact_operands_read_back_bit_for_bit(d, k, blocks):
    """`circ_fact_operands`: the planes' fragments decode to the permuted
    lcoef and comb (`circ_fact_bank`) on the kernel's padded slots
    (`circ_fact_slots`, lines of d2 | 1), zero at the pads, bit for bit;
    the tables are the float64 ones rounded once; `circ_fact_units`
    counts the lanes."""
    _, tb = _banks(n_dead=1, d=d, blocks=blocks, k=k)
    ckb = ck.circ_kernel_bank(tb, blocks)
    ops = ck.circ_fact_operands(ckb, blocks)
    d1, d2 = ops.d1, ops.d2
    dp = d1 * (d2 | 1)
    assert (d1, d2) == ck.circ_fact_blocks(d, blocks)
    assert ops.kron == (blocks is not None)
    units = ck.circ_fact_units(d1, d2, k)
    assert all(pl.shape == (units, 4) and pl.dtype == torch.bfloat16
               for pl in ops[:3])
    frags = sum(pl.double() for pl in ops[:3])
    n_logit = 32 * -(-3 * dp // 16) * -(-k // 8)
    lcoef = _decode(frags[:n_logit], 3 * dp, k, True)
    comb = _decode(frags[n_logit:], k, 4 * dp, False)
    fb = ck.circ_fact_bank(ckb, blocks)
    slot = ck.circ_fact_slots(d1, d2)
    pads = torch.ones(dp, dtype=torch.bool)
    pads[slot] = False
    assert torch.equal(lcoef[2 * slot].float(), fb.lcoef[0:2 * d:2])
    assert torch.equal(lcoef[2 * slot + 1].float(), fb.lcoef[1:2 * d:2])
    assert torch.equal(lcoef[2 * dp + slot].float(), fb.lcoef[2 * d:])
    comb3 = comb.reshape(k, dp, 4)
    assert torch.equal(comb3[:, slot].float(), fb.comb.reshape(k, d, 4))
    assert not comb3[:, pads].any() and not lcoef[2 * dp:][pads].any()
    t1, t2, cross = ck._fact_tables(d1, d2, blocks is not None)
    tw = torch.view_as_complex(ops.tw.reshape(-1, 2))
    assert tw.shape == (d1 + d2 + dp,)
    want = torch.cat([t1, t2]).to(torch.complex64)
    assert torch.equal(tw[:d1 + d2], want)
    assert torch.equal(tw[d1 + d2:][slot], cross.to(torch.complex64))
    assert not tw[d1 + d2:][pads].any()


def test_basis_is_read_from_the_layout():
    """`circ_basis_blocks`: None for the DFT layout, (n1, n2) for a kron
    layout, a refusal for any other transform (the random transforms of
    `tc_repeat_check`'s mode 'wide_circ')."""
    for d, blocks in ((144, None), (512, None), (256, (16, 16)),
                      (256, (8, 32)), (200, (10, 20))):
        _, tb = _banks(d=d, blocks=blocks, k=2)
        assert ck.circ_basis_blocks(ck.circ_kernel_bank(tb, blocks)) == blocks
    with pytest.raises(ValueError, match="neither the DFT nor a kron"):
        ck.circ_basis_blocks(trc.random_circ_bank(144, 2,
                                                  torch.device("cpu")))


def test_entry_route_at_d512_and_d652():
    """One shape rule picks the kernel: K6 / K7 and the stats forms K8 /
    K9 at D = 512 on the factorised kernel (its operands cached under
    'circ_fact_operands'), at D = 652 = 4 x 163 on the dense wide form,
    the template up to D = 128; a layout's basis decides where D splits
    but a kron block does not."""
    assert ck.circ_route(512) == "fact" and ck.circ_route(652) == "wide"
    assert ck.circ_route(512, stats=True) == ck.circ_route(512) == "fact"
    assert ck.circ_route(652, stats=True) == "wide"
    assert ck.circ_route(128) == ck.circ_route(64) == "template"
    for d, want, kind in ((512, "fact", ck.CircFactOperands),
                          (652, "wide", tu.UnitOperands)):
        _, tb = _banks(d=d, k=2)
        cache = {}
        ops = ck.lowered_tc(tb, cache)
        assert len(ops) == 1 and isinstance(ops[0], kind)
        assert (f"circ_{want}_operands", None, False) in cache
        ckb = ck.lowered(tb, cache)[0]
        assert ck._route(d, ckb, None, False, 1) == want
        assert ck._route(d, ckb, ops[0], False, 1) == want
        assert ck._route(d, ckb, None, True, 1) == want
    _, tb = _banks(d=256, blocks=(2, 128), k=2)
    ckb = ck.circ_kernel_bank(tb, (2, 128))
    assert ck._route(256, ckb, None, False, 1) == "wide"
    assert isinstance(ck.lowered_tc(tb, {}, (2, 128))[0], tu.UnitOperands)


def test_fact_wrappers_on_cpu_take_the_plain_route():
    """On CPU tensors the factorised wrappers return their plain version
    in the layout's own basis, launch nothing, and refuse T < 2 for K7;
    both are counted kernels."""
    _, tb = _banks(n_dead=1, d=256, blocks=(16, 16), k=4)
    ckb = ck.circ_kernel_bank(tb, (16, 16))
    x2 = ck._x2(torch.as_tensor(_obs(20, d=256)))
    before = tkn.launch_counts()
    got = ck.circ_estimate_fact(x2, ckb)
    assert torch.equal(got, ck.circ_fact_reference(x2, ckb, 1, 1.0,
                                                   (16, 16)))
    ops = ck.circ_fact_operands(ckb, (16, 16))
    assert torch.equal(ck.circ_estimate_fact(x2, ckb, ops), got)
    assert tkn.launch_counts() == before
    with pytest.raises(ValueError, match="T >= 2"):
        ck.circ_estimate_coherent_fact(x2, ckb, 1)
    assert {"circ_estimate_fact", "circ_estimate_coherent_fact"} <= set(
        tkn.launch_counts())


def test_tc_repeat_check_fact_circ_shapes():
    """Mode 'fact_circ''s card shapes: each on the factorised route, whole
    T-row blocks, one past the template's D, the rule's edge at K = 128,
    two waves at D = 512, T = 3, 4 and 64 (two sweeps), the kron basis;
    the stats forms K8 / K9 at two waves, the edge, two sweeps, T = 3 and
    the kron basis."""
    shapes = trc.FACT_CIRC_SHAPES
    for d, k, n, _, t, _, blocks, stats in shapes:
        assert ck.circ_route(d, blocks, stats, k, t) == "fact"
        assert n % t == 0 and 1 <= k <= ck.CIRC_MAX_K
    for stats in (False, True):
        form = [s for s in shapes if s[7] == stats]
        assert {512, 672} <= {s[0] for s in form}
        assert {1, 3, 4, 64} <= {s[4] for s in form}
        assert any(s[6] is not None for s in form)
        assert any(s[0] == 672 and s[1] == 128 for s in form)
        assert any(s[0] == 512 and s[2] > 132 * 16 for s in form)
    assert 129 in {s[0] for s in shapes}


def test_circ_fact_bench_needs_a_card():
    """`tools/circ_fact_bench.py` measures on the card only."""
    from quantized_channel_estimation_torch.tools import circ_fact_bench
    with pytest.raises(SystemExit, match="needs a card"):
        circ_fact_bench.main(["d512"])
