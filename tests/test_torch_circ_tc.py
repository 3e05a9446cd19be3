"""K6-K9 on the tensor cores, on the CPU: the circulant bank laid out as
the multi-pilot template's units at one pilot
(`circ_kernels.circ_tc_operands`) read back bit for bit, the plain
six-product version of the kernels' arithmetic (`circ_tc_reference`, the
flat and stats forms of `mp_circ_kernels.mp_circ_tc_reference` at P = 1)
against the float32 plain versions and against the JAX package's
interpret-mode kernels, two shards' emulated states merged against the
emulated whole bank, and the eligibility rule, read from shapes only.

Banks are the seeded circulant banks of `tests/test_torch_circ_kernels.py`
(prepared by the JAX package and carried over), at D <= 32 and K <= 8.

Tolerances, with their reasons:
- bit for bit for the units: hi + lo + lo2 of a float32 value is the value
  exactly (8 + 8 + 8 significand bits), and the swizzle is a permutation;
- 1e-5 of each output's scale between the six-product version and the
  float32 plain version, beyond the plain version's own error against its
  float64 evaluation (both are float32; the six exact bf16 products drop
  terms of order 2^-24 and sum in another order), and the six-product
  version within twice the float32 plain version's error against float64
  (the float64 rule the card holds the kernels to), for the estimate and
  for each of m, den and the accumulator of the stats forms;
- 2e-4 of the output scale against JAX's interpret-mode kernels, the
  tolerance of the plain K6-K9 against them (`test_torch_circ_kernels.py`);
- 1e-5 of the scale between two shards' emulated states merged and the
  emulated whole bank: the merge is exact, and the two sides differ by
  float32 roundings of the softmax over another set of components.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.estimators import tc_units as tu
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from test_torch_circ_kernels import _banks, _close, _obs

torch.set_num_threads(2)


def _units_back(ops):
    """The float32 units behind the kernel's operands: unswizzled, hi + lo
    + lo2."""
    hi, lo, lo2 = (tkn._sw128(x).to(torch.float32) for x in ops)
    return (hi + lo) + lo2


def _walk(units, d, k, stats):
    """The circulant bank's operands rebuilt from the units in the order
    the template consumes them at one pilot, walked by hand: the forward
    operand's (chunk, piece) units; for each 64-column piece of K the u
    group's chunks, then the |u|^2 group's; for each piece of 2D the bias
    and filter slabs over the chunks of K; the inverse (flat forms only)."""
    npd = 1 if 2 * d <= 64 else 2 if 2 * d <= 128 else 4
    kp = 1 if k <= 64 else 2
    ncd = (npd + 1) // 2
    w2, wk = 64 * npd, 64 * kp
    it = iter(units)

    def take(out, r0, c0):
        out[r0:r0 + 64, c0:c0 + 64] = next(it).T

    fwd = torch.zeros(w2, w2)
    for c in range(npd):
        for j in range(npd):
            take(fwd, 64 * c, 64 * j)
    u_g, sq_g = torch.zeros(w2, wk), torch.zeros(64 * ncd, wk)
    for kc in range(kp):
        for g in (u_g, sq_g):
            for c in range(g.shape[0] // 64):
                take(g, 64 * c, 64 * kc)
    comb = torch.zeros(2, wk, w2)
    for j in range(npd):
        for s in range(2):
            for kc in range(kp):
                take(comb[s], 64 * kc, 64 * j)
    binv = torch.zeros(w2, w2)
    if not stats:
        for jo in range(npd):
            for j in range(npd):
                take(binv, 64 * j, 64 * jo)
    assert next(it, None) is None
    # the |u|^2 rows: row 64 c + 16 s + 8 e + 2 q + h holds bin
    # 64 c + 32 (i // 8) + 4 (i % 8) + q, i = 4 s + 2 e + h
    sq = torch.zeros(d, wk)
    for c in range(ncd):
        for s in range(4):
            for e in range(2):
                for q in range(4):
                    for h in range(2):
                        i = 4 * s + 2 * e + h
                        b = 64 * c + 32 * (i // 8) + 4 * (i % 8) + q
                        row = 64 * c + 16 * s + 8 * e + 2 * q + h
                        if b < d:
                            sq[b] = sq_g[row]
                        else:
                            assert not sq_g[row].any()
    return fwd, u_g, sq, comb, binv


@pytest.mark.parametrize("d,k,blocks,stats", [
    (32, 8, None, False), (32, 8, None, True), (16, 6, (4, 4), False),
    (16, 6, (4, 4), True), (40, 70, None, False), (100, 8, None, True)])
def test_circ_tc_operands_read_back_bit_for_bit(d, k, blocks, stats):
    """The units hold K6's operands: bfwd, lcoef's [u | |u|^2] rows (the
    |u|^2 rows in the threads' bin order), the combine's [br, bi, fr, fi]
    as the bias and filter slabs, binv (none for the stats forms)."""
    _, tb = _banks(n_dead=1, blocks=blocks, k=k, d=d)
    ckb = ck.circ_kernel_bank(tb, blocks)
    ops = ck.circ_tc_operands(ckb, stats)
    assert ops.hi.shape == (mk.mp_circ_units(d, k, 1, stats), 64, 64)
    units = _units_back(ops)
    assert torch.equal(units, mk.mp_circ_tc_units(ck.circ_mp_bank(ckb),
                                                  stats))
    fwd, u_g, sq, comb, binv = _walk(units, d, k, stats)
    two_d = 2 * d
    assert torch.equal(fwd[:two_d, :two_d], ckb.bfwd)
    assert not fwd[two_d:].any() and not fwd[:, two_d:].any()
    assert torch.equal(u_g[:two_d, :k], ckb.lcoef[:two_d])
    assert torch.equal(sq[:, :k], ckb.lcoef[two_d:])
    assert not u_g[two_d:].any() and not u_g[:, k:].any()
    c4 = ckb.comb.reshape(k, d, 4)
    assert torch.equal(comb[0, :k, :two_d].reshape(k, d, 2), c4[..., :2])
    assert torch.equal(comb[1, :k, :two_d].reshape(k, d, 2), c4[..., 2:])
    assert not comb[:, k:].any() and not comb[:, :, two_d:].any()
    if stats:
        assert not binv.any()
    else:
        assert torch.equal(binv[:two_d, :two_d], ckb.binv)


def test_circ_tc_operands_are_cached_per_shard_and_checked():
    _, tb = _banks(n_dead=3, k=260, d=8)
    cache = {}
    ops = ck.lowered_tc(tb, cache, None, True)
    assert len(ops) == 3 and ck.lowered_tc(tb, cache, None, True) is ops
    assert set(cache) == {(None, 1, 1.0), ("circ_tc_operands", None, True)}
    flat = ck.lowered_tc(tb, cache)
    assert [o.hi.shape[0] for o in flat] == [mk.mp_circ_units(8, 128, 1)] \
        * 2 + [mk.mp_circ_units(8, 4, 1)]
    for o, c in zip(ops, ck.lowered(tb, cache)):
        want = ck.circ_tc_operands(c, True)
        assert all(torch.equal(a, b) for a, b in zip(o, want))
    cpu = torch.device("cpu")
    ckb = ck.lowered(tb, cache)[0]
    for bad, stats in ((flat[0], True), (ops[0], False),
                       (ops[0]._replace(lo=ops[0].lo.float()), True)):
        with pytest.raises(ValueError, match="circ_tc_operands"):
            tu.check_units("k", bad, ck._units(ckb, stats), cpu,
                           "circ_tc_operands")
    # the wrappers on the CPU take the plain versions, operands or none
    x2 = ck._x2(torch.as_tensor(_obs(20, d=8)))
    assert torch.equal(ck.circ_estimate(x2, ckb, flat[0]),
                       ck.circ_estimate_reference(x2, ckb))
    for g, w in zip(ck.circ_estimate_stats(x2, ckb, ops[0]),
                    ck.circ_estimate_stats_reference(x2, ckb)):
        assert torch.equal(g, w)


def _held_six(x2, ckb, t, alpha, stats):
    """Each output of the six-product version within 1e-5 of its scale of
    the float32 plain version beyond that one's own error against float64,
    and against float64 within twice its error."""
    got = ck.circ_tc_reference(x2, ckb, t, alpha, stats)
    want = ck._circ_reference(x2, ckb, t, alpha, stats, 16384)
    want64 = ck._circ_reference(x2.double(), type(ckb)(
        *(x.double() for x in ckb)), t, alpha, stats, 16384)
    outs = zip(got, want, want64) if stats else ((got, want, want64),)
    for g, w, w64 in outs:
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = float(w.abs().max())
        err_six = float((g.double() - w64).abs().max())
        err_plain = float((w.double() - w64).abs().max())
        gap = float((g - w).abs().max())
        assert gap <= 1e-5 * scale + err_plain, (gap / scale, err_plain)
        assert err_six <= 2 * err_plain, (err_six, err_plain)
    return got


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("n,t,alpha,n_dead,blocks,k", [
    (301, 1, 1.0, 0, None, 8),
    (130, 1, 1.0, 2, (4, 8), 6),
    (4 * 37, 4, 1.0, 1, None, 8),
    (3 * 41, 3, 0.25, 2, (4, 8), 6),
    (4 * 29, 4, 0.5, 0, None, 8)])
def test_circ_tc_reference_matches_plain(stats, n, t, alpha, n_dead, blocks,
                                         k):
    """K6 / K7 (stats=False) and K8 / K9 as the tensor cores compute them
    against the float32 plain versions, under the float64 rule."""
    _, tb = _banks(n_dead=n_dead, blocks=blocks, k=k)
    ckb = ck.circ_kernel_bank(tb, blocks, t, alpha)
    x2 = ck._x2(torch.as_tensor(_obs(n)))
    got = _held_six(x2, ckb, t, alpha, stats)
    if stats:
        assert got[0].shape == got[1].shape == (n,)
        assert got[2].shape == (n, 64)
    else:
        assert got.shape == (n, 64)


@pytest.mark.parametrize("form", ["K6", "K7", "K8", "K9"])
def test_circ_tc_reference_matches_jax_interpret_kernel(form):
    """Each form against its JAX kernel in interpret mode (K7 / K9 at
    T = 4, alpha 0.25), dead components, the kron basis for K7 and K9."""
    blocks = (4, 8) if form in ("K7", "K9") else None
    jbank, tbank = _banks(n_dead=1, blocks=blocks)
    t, alpha, n_blocks = (4, 0.25, 29) if form in ("K7", "K9") \
        else (1, 1.0, 77)
    r = _obs(n_blocks * t)
    ckb = ck.circ_kernel_bank(tbank, blocks, t, alpha)
    got = ck.circ_tc_reference(ck._x2(torch.as_tensor(r)), ckb, t, alpha,
                               form in ("K8", "K9"))
    if form == "K6":
        want = pk.estimate_fused_circulant(jbank, jnp.asarray(r),
                                           interpret=True)
        _close(ck._hc(got, torch.complex64), want)
        return
    if form == "K7":
        want = pk.estimate_fused_circulant_coherent(
            jbank, jnp.asarray(r.reshape(n_blocks, t, -1)), alpha=alpha,
            interpret=True, blocks=blocks)
        _close(ck._hc(got, torch.complex64).reshape(n_blocks, t, -1), want)
        return
    if form == "K8":
        want = pk.estimate_fused_circulant_stats(jbank, jnp.asarray(r),
                                                 interpret=True)
    else:
        want = pk.estimate_fused_circulant_coherent_stats(
            jbank, jnp.asarray(r.reshape(n_blocks, t, -1)), alpha=alpha,
            interpret=True, blocks=blocks)
    m, den, acc = got
    _close(m.reshape(np.shape(want[0])), want[0])
    _close(den.reshape(np.shape(want[1])), want[1])
    _close(ck._hc(acc, torch.complex64).reshape(np.shape(want[2])), want[2])


@pytest.mark.parametrize("t,alpha", [(1, 1.0), (4, 1.0), (4, 0.25)])
def test_two_emulated_shards_merge_to_the_emulated_whole(t, alpha):
    """K8 + K8 (K9 + K9) over the two halves of the bank, as the tensor
    cores compute them, merged with `merge_stats` and inverse-transformed
    once, equal K6 (K7) over the whole bank as they compute it."""
    _, tbank = _banks(n_dead=1)
    x2 = ck._x2(torch.as_tensor(_obs(64 * t)))
    states = []
    for lo, hi in ((0, 4), (4, 8)):
        shard = tsb.CirculantBank(*(x[lo:hi] for x in tbank))
        states.append(ck.circ_tc_reference(
            x2, ck.circ_kernel_bank(shard, None, t, alpha), t, alpha, True))
    _, den, acc = ck.merge_stats(*zip(*states))
    got = tsb.unitary_ifft(ck._hc(acc / den[:, None], torch.complex64))
    whole = ck.circ_tc_reference(
        x2, ck.circ_kernel_bank(tbank, None, t, alpha), t, alpha)
    _close(ck._x2(got), whole.numpy(), 1e-5)


def _old_rule(d, k, t=1):
    """The range of the fp32 loop K6-K9 replaced: D <= 128, any K, T up to
    a tile of 64 rows (32 past D = 64)."""
    return 1 <= d <= 128 and k >= 1 and 1 <= t <= (64 if d <= 64 else 32)


def test_circ_rule_keeps_every_old_shape_and_pins_the_new_edges():
    """Every (D, K, T) the fp32 loop took, the tensor-core template takes
    at one pilot; the edge it moved (T <= 64 at every D) and the units of
    the widths the port runs."""
    for d in range(1, 129):
        for k in (1, 7, 64, 65, 128, 129, 1000):
            for t in (1, 2, 32, 33, 64, 65):
                if _old_rule(d, k, t):
                    assert ck.circ_kernel_eligible(d, k, t), (d, k, t)
                # the template's own rule at one pilot, per launch
                assert ck.circ_kernel_eligible(d, k, t) == \
                    mk.mp_circ_narrow(d, min(k, 128), 1, t)
        assert ck.circ_tile_rows(d) == 64
        assert not ck.circ_kernel_eligible(d, 8, 65)
    assert ck.circ_kernel_eligible(128, 128, 64)       # was T <= 32
    assert ck.circ_kernel_eligible(65, 8, 33)
    assert not ck.circ_kernel_eligible(ck.CIRC_WIDE_MAX_D + 1, 8)
    # 15 units at D = K = 64 (11 without the inverse), 22 for the
    # 128-component shards of a K = 256 bank, 60 at D = K = 128
    assert [mk.mp_circ_units(64, 64, 1, s) for s in (False, True)] == [15, 11]
    assert mk.mp_circ_units(64, 128, 1) == 22
    assert mk.mp_circ_units(128, 128, 1) == 60
    assert mk.mp_circ_units(128, 128, 1, True) == 44


def test_tc_repeat_check_circ_mode_on_cpu():
    """Mode 'circ' of `tc_repeat_check` (K6-K9) through the plain versions:
    every launch held, none off; its card shapes cover each kernel, one and
    two warpgroups a block, one, two and four pieces of 2D, a 128-component
    shard and the pool at T = 3, 4 and 64."""
    shapes = ((8, 3, 70, 1, 1, 1.0, False), (12, 5, 4 * 9, 0, 4, 0.5, True),
              (8, 2, 3 * 11, 0, 3, 1.0, False), (8, 4, 40, 1, 1, 1.0, True))
    got = trc.repeat_check(torch.device("cpu"), repeats=2, poison=False,
                           modes=("circ",), circ_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    assert {label.split()[-1] for label in got["kernel"]} == {"K6", "K7",
                                                               "K8", "K9"}
    for rec in got["kernel"].values():
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    shapes = trc.CIRC_SHAPES
    assert {1, 2, 4} <= {mk._pieces(2 * d) for d, *_ in shapes}
    assert any(k == 128 and stats for _, k, *_, stats in shapes)
    assert {(t > 1, stats) for *_, t, _, stats in shapes} == {
        (False, False), (False, True), (True, False), (True, True)}
    two = [n // (64 // t * t) >= 2 * 132 for d, k, n, _, t, _, _ in shapes
           if d <= 64 and k <= 64]
    assert True in two and False in two   # one and two warpgroups a block
    assert {3, 4, 64} <= {s[4] for s in shapes}
