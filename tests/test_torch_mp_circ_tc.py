"""K10 on the tensor cores, on the CPU: the bank's units
(`mp_circ_kernels.mp_circ_tc_operands`) read back bit for bit, the plain
six-product version of the kernel's arithmetic (`mp_circ_tc_reference`)
against the float32 plain version and against the JAX package's
interpret-mode kernel, and the eligibility rule of the tensor-core
kernel, read from shapes only.

Banks are the seeded multi-pilot banks of `tests/test_torch_multipilot.py`
(prepared by the JAX package and carried over), at D <= 32, K <= 8 and
P in {2, 3} for the arithmetic; the layout is also read back at the wider
forms (two and four 64-column pieces of 2D, two of K).

Tolerances, with their reasons:
- bit for bit for the units: hi + lo + lo2 of a float32 value is the value
  exactly (8 + 8 + 8 significand bits), and the swizzle is a permutation;
- 1e-5 of the output scale between the six-product version and the
  float32 plain version, beyond the plain version's own error against its
  float64 evaluation: both are float32, the six exact bf16 products drop
  terms of order 2^-24, and the sums run in another order (chunks of 64,
  the logit's groups in a compensated sum); the plain version's one long
  logit product is itself up to 1.4e-5 of the scale off float64 at D = 32
  (measured), where the six-product version is 4.7e-6 off. The
  six-product version is also held within twice the float32 plain
  version's error against float64 (the float64 rule the card holds the
  kernel to);
- 2e-4 of the output scale against JAX's interpret-mode kernel, the
  tolerance of the plain K10 against it (`test_torch_multipilot.py`).
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
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from test_torch_multipilot import _banks, _close, _obs

torch.set_num_threads(2)


def _planes_back(ops):
    """The float32 units behind the kernel's operands: unswizzled, hi + lo
    + lo2."""
    hi, lo, lo2 = (tkn._sw128(x).to(torch.float32) for x in ops)
    return (hi + lo) + lo2


def _operands_back(units, d, k, p):
    """The bank's four float32 operands rebuilt from the units in the
    documented order (`mp_circ_tc_units`), walked by hand."""
    npd = 1 if 2 * d <= 64 else 2 if 2 * d <= 128 else 4
    kp = 1 if k <= 64 else 2
    ncd = (npd + 1) // 2
    w2, wk = 64 * npd, 64 * kp
    it = iter(units)

    def take(out, r0, c0):
        out[r0:r0 + 64, c0:c0 + 64] = next(it).T

    fwds = []
    for _ in range(p):
        fwd = torch.zeros(w2, w2)
        for c in range(npd):
            for j in range(npd):
                take(fwd, 64 * c, 64 * j)
        fwds.append(fwd)
    u_g = [torch.zeros(w2, wk) for _ in range(p)]
    sq_g = [torch.zeros(64 * ncd, wk) for _ in range(p)]
    v_g = [torch.zeros(w2, wk) for _ in range(p * (p - 1) // 2)]
    for kc in range(kp):
        for g in u_g + sq_g + v_g:
            for c in range(g.shape[0] // 64):
                take(g, 64 * c, 64 * kc)
    comb = torch.zeros(p + 1, wk, w2)
    for j in range(npd):
        for s in range(p + 1):
            for kc in range(kp):
                take(comb[s], 64 * kc, 64 * j)
    binv = torch.zeros(w2, w2)
    for jo in range(npd):
        for j in range(npd):
            take(binv, 64 * j, 64 * jo)
    assert next(it, None) is None
    # the |u_p|^2 rows: row 64 c + 16 s + 8 e + 2 q + h of a group holds
    # bin 64 c + 32 (i // 8) + 4 (i % 8) + q, i = 4 s + 2 e + h
    sq = torch.zeros(p, d, wk)
    for c in range(ncd):
        for s in range(4):
            for e in range(2):
                for q in range(4):
                    for h in range(2):
                        i = 4 * s + 2 * e + h
                        b = 64 * c + 32 * (i // 8) + 4 * (i % 8) + q
                        row = 64 * c + 16 * s + 8 * e + 2 * q + h
                        for pi in range(p):
                            if b < d:
                                sq[pi, b] = sq_g[pi][row]
                            else:
                                assert not sq_g[pi][row].any()
    two_d = 2 * d
    lcoef = torch.cat([g[:two_d] for g in u_g] + [sq[pi] for pi in range(p)]
                      + [g[:two_d] for g in v_g])[:, :k]
    for g in u_g + v_g:
        assert not g[two_d:].any() and not g[:, k:].any()
    return fwds, lcoef, comb[:, :k, :two_d], binv


@pytest.mark.parametrize("p,d,k,blocks", [
    (2, 16, 6, None), (3, 16, 6, (4, 4)), (2, 40, 70, None),
    (4, 100, 8, None), (2, 8, 3, None)])
def test_mp_circ_tc_operands_read_back_bit_for_bit(p, d, k, blocks):
    _, tb = _banks(p, blocks=blocks, n_dead=1, k=k, d=d)
    ckb = mk.mp_circ_kernel_bank(tb, blocks)
    ops = mk.mp_circ_tc_operands(ckb)
    assert ops.hi.shape == (mk.mp_circ_units(d, k, p), 64, 64)
    mk.check_mp_circ_tc_operands("k", ops, ckb, torch.device("cpu"))
    units = _planes_back(ops)
    assert torch.equal(units, mk.mp_circ_tc_units(ckb))
    fwds, lcoef, comb, binv = _operands_back(units, d, k, p)
    two_d = 2 * d
    for fwd in fwds:              # the forward operand, once a pilot
        assert torch.equal(fwd[:two_d, :two_d], ckb.bfwd)
        assert not fwd[two_d:].any() and not fwd[:, two_d:].any()
    assert torch.equal(lcoef, ckb.lcoef)
    assert torch.equal(comb, ckb.comb)
    assert torch.equal(binv[:two_d, :two_d], ckb.binv)


def test_mp_circ_tc_operands_are_cached_and_checked():
    _, tb = _banks(2)
    cache = {}
    ops = mk.lowered_tc(tb, cache)
    assert mk.lowered_tc(tb, cache) is ops
    assert set(cache) == {(None, 1, 1.0), ("mp_circ_tc_operands", None)}
    mk.lowered_tc(tb, cache, (4, 4))
    assert ("mp_circ_tc_operands", (4, 4)) in cache
    ckb = mk.lowered(tb, cache)
    want = mk.mp_circ_tc_operands(ckb)
    assert all(torch.equal(a, b) for a, b in zip(ops, want))
    cpu = torch.device("cpu")
    _, wide = _banks(3)
    for bad in (ops._replace(lo=ops.lo.float()),
                ops._replace(hi=ops.hi[:-1]),
                mk.mp_circ_tc_operands(mk.mp_circ_kernel_bank(wide))):
        with pytest.raises(ValueError, match="mp_circ_tc_operands"):
            mk.check_mp_circ_tc_operands("k", bad, ckb, cpu)
    # the wrappers on the CPU take the plain version, operands or none
    x2 = ck._x2(torch.as_tensor(_obs(20, 2 * 16)))
    assert torch.equal(mk.mp_circ_estimate(x2, ckb, ops),
                       mk.mp_circ_estimate_reference(x2, ckb))


def _held_six(x2, ckb, t, alpha):
    """The six-product version within 1e-5 of the scale of the float32
    plain version beyond that one's own error against float64, and against
    float64 within twice its error."""
    got = mk.mp_circ_tc_reference(x2, ckb, t, alpha)
    want = mk._mp_reference(x2, ckb, t, alpha, 8192)
    want64 = mk._mp_reference(x2.double(), type(ckb)(
        *(x.double() for x in ckb)), t, alpha, 8192)
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = float(want.abs().max())
    err_six = float((got.double() - want64).abs().max())
    err_plain = float((want.double() - want64).abs().max())
    gap = float((got - want).abs().max())
    assert gap <= 1e-5 * scale + err_plain, (gap / scale, err_plain / scale)
    assert err_six <= 2 * err_plain, (err_six, err_plain)
    return got


@pytest.mark.parametrize("p,d,k,n,t,alpha,n_dead,blocks", [
    (2, 16, 6, 301, 1, 1.0, 0, None),
    (3, 16, 6, 130, 1, 1.0, 2, (4, 4)),
    (2, 32, 8, 77, 1, 1.0, 1, None),
    (2, 16, 6, 4 * 37, 4, 1.0, 1, None),
    (3, 16, 6, 4 * 37, 4, 0.25, 2, (4, 4)),
    (2, 16, 8, 4 * 29, 4, 0.25, 0, None)])
def test_mp_circ_tc_reference_matches_plain(p, d, k, n, t, alpha, n_dead,
                                            blocks):
    _, tb = _banks(p, blocks=blocks, n_dead=n_dead, k=k, d=d)
    ckb = mk.mp_circ_kernel_bank(tb, blocks, t, alpha)
    x2 = ck._x2(torch.as_tensor(_obs(n, p * d)))
    assert _held_six(x2, ckb, t, alpha).shape == (n, 2 * d)


@pytest.mark.parametrize("p,t,alpha,blocks", [
    (2, 1, 1.0, None), (3, 1, 1.0, (4, 4)), (2, 4, 1.0, None),
    (3, 4, 0.25, (4, 4))])
def test_mp_circ_tc_reference_matches_jax_interpret_kernel(p, t, alpha,
                                                           blocks):
    jb, tb = _banks(p, blocks=blocks, n_dead=1)
    n_blocks, d = 29, 16
    r = _obs(n_blocks * t, p * d)
    ckb = mk.mp_circ_kernel_bank(tb, blocks, t, alpha)
    got = mk.mp_circ_tc_reference(ck._x2(torch.as_tensor(r)), ckb, t, alpha)
    got = torch.view_as_complex(got.reshape(-1, d, 2).contiguous())
    if t == 1:
        want = pk.estimate_fused_circulant_mp(jb, jnp.asarray(r),
                                              interpret=True, blocks=blocks)
    else:
        want = pk.estimate_fused_circulant_mp_coherent(
            jb, jnp.asarray(r.reshape(n_blocks, t, p * d)), alpha=alpha,
            interpret=True, blocks=blocks).reshape(-1, d)
    _close(got, want, 2e-4)


def _old_rule(d, k, p, t=1):
    """The range of the fp32 loop K10 replaced: a tile of 64 rows (32 past D =
    64) of [u | one group | w] floats and a 32 KB ring within a block."""
    rows = 64 if d <= 64 else 32
    stride = (2 * p * d + 2 * d + k + 3) & ~3
    return (1 <= d <= 128 and 1 <= k <= 128 and p >= 1 and 1 <= t <= rows
            and 4 * (rows * stride + 8192) <= mk.SMEM_BLOCK_BYTES)


def test_mp_circ_rule_keeps_every_shape_up_to_four_pilots():
    """Every (D, K, P <= 4, T) the fp32 loop took, the tensor-core kernel
    takes (D, K over 1..128, T at the tile edges)."""
    for d in range(1, 129):
        for k in (1, 7, 64, 65, 128):
            for p in range(1, 5):
                for t in (1, 2, 32, 33, 64):
                    if _old_rule(d, k, p, t):
                        assert mk.mp_circ_kernel_eligible(d, k, p, t), \
                            (d, k, p, t)


def test_mp_circ_rule_new_edges():
    """The template's rule from shapes only: a warpgroup of 64 live rows
    where its u fits beside a ring of two units, else 32; the edges it
    moved. Past them the wide form takes the bank
    (`tests/test_torch_wide_mp_circ.py`)."""
    assert mk.mp_circ_tile_rows(64, 64, 2) == 64
    assert mk.mp_circ_tile_rows(64, 64, 11) == 32          # P past 64 rows
    assert mk.mp_circ_tile_rows(64, 64, 12) == 0
    assert mk.mp_circ_tile_rows(128, 128, 2) == 64
    assert mk.mp_circ_tile_rows(128, 128, 3) == 32
    assert mk.mp_circ_tile_rows(128, 128, 5) == 32
    assert mk.mp_circ_tile_rows(128, 128, 6) == 0
    # P = 5 .. 11 at D = K = 64 and P = 5 at D = K = 128: the fp32 loop
    # took neither; T at 32 live rows
    assert mk.mp_circ_narrow(64, 64, 11)
    assert mk.mp_circ_narrow(64, 64, 10, 32)      # + the pool rows
    assert not mk.mp_circ_narrow(64, 64, 10, 33)
    assert not mk.mp_circ_narrow(64, 64, 11, 2)
    assert mk.mp_circ_narrow(128, 128, 5, 32)
    assert mk.mp_circ_narrow(128, 64, 2, 64)      # was T <= 32
    # what the fp32 loop took and the template does not, which the wide
    # form takes: P >= 6 at D = 65 .. 111 (2D padded to four 64-column
    # pieces), T past 32 at a P that leaves a warpgroup 32 rows (P = 5 at
    # D = 40), P in the hundreds at D <= 2
    for shape in ((100, 64, 6, 1), (65, 8, 6, 1), (40, 8, 5, 64),
                  (2, 8, 178, 1)):
        assert _old_rule(*shape) and not mk.mp_circ_narrow(*shape)
        assert mk.mp_circ_kernel_eligible(*shape)
    assert mk.mp_circ_narrow(40, 8, 5, 32)
    assert mk.mp_circ_narrow(2, 8, 177, 1)
    # shared memory of the launch: u, the ring, the pool rows
    assert mk.mp_circ_smem_bytes(64, 64, 2) == 1024 + 2 * (24576 + 16) \
        + 2 * 2 * 8 * 128 * 16
    assert mk.mp_circ_smem_bytes(64, 64, 2, 4) == \
        mk.mp_circ_smem_bytes(64, 64, 2) + 64 * 72 * 4
    assert mk.mp_circ_smem_bytes(16, 8, 3, half=True) == \
        1024 + 2 * (24576 + 16) + 3 * 1 * 4 * 64 * 16
    assert mk.mp_circ_units(64, 64, 2) == 26
    assert mk.mp_circ_units(128, 128, 4) == 216


def test_tc_repeat_check_mpcirc_mode_on_cpu():
    """Mode 'mpcirc' of `tc_repeat_check` (K10 flat and coherent) through
    the plain versions: every launch held, none off; its card shapes cover
    one and two warpgroups a block, 32 live rows, one, two and four pieces
    of 2D, two of K and the pool at T = 3, 4, 32 and 64."""
    shapes = ((2, 8, 3, 70, 1, 1, 1.0), (3, 12, 5, 4 * 9, 0, 4, 0.5),
              (2, 8, 2, 3 * 11, 0, 3, 1.0))
    got = trc.repeat_check(torch.device("cpu"), repeats=2, poison=False,
                           modes=("mpcirc",), mpcirc_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for rec in got["kernel"].values():
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    pieces = {(mk._pieces(2 * d), mk._pieces(k))
              for _, d, k, *_ in trc.MPCIRC_SHAPES}
    assert {1, 2, 4} <= {a for a, _ in pieces} and (4, 2) in pieces
    rows = {mk.mp_circ_tile_rows(d, k, p, t)
            for p, d, k, _, _, t, _ in trc.MPCIRC_SHAPES}
    assert rows == {32, 64}
    two = [n // (64 // t * t) >= 2 * 132 for p, d, k, n, _, t, _ in
           trc.MPCIRC_SHAPES if d <= 64 and k <= 64]
    assert True in two and False in two   # one and two warpgroups a block
    assert {1, 3, 4, 32, 64} <= {s[5] for s in trc.MPCIRC_SHAPES}
