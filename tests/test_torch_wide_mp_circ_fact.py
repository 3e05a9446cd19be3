"""The factorised multi-pilot circulant kernel's route on the CPU
(`csrc/mp_circ_fact_estimate.cu`: K10 past the template's rule wherever the
transform splits into two levels of at most 64 points, the tile's buffers
fit and the kernel was measured faster than the dense wide form): the
plain factorised K10 against JAX's
interpret-mode K10 at D = 144 and against the plain wide version at small
split widths, the kernel's layout read back bit for bit and evaluated as
the kernel reads it, the three routes partitioning the rule, the entries
at D = 256, the repeated-launch mode of `tools.tc_repeat_check` and the
`mp` leg of `tools/circ_fact_bench.py`.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`test_mp_circ_fact_*`); here every wrapper computes its plain version
`mp_circ_fact_reference`.

Tolerances, with their reasons:
- 2e-4 of the output scale against JAX's interpret-mode kernel, the
  multi-pilot tests' own (`tests/test_torch_multipilot.py`): JAX's kernel
  is float32 and expands the quadratic, whose P^2 terms cancel, so it lies
  further from the function in float64 than the plain version, which the
  test holds within 1e-5 of it;
- 1e-5 of the scale for the plain version against the function in
  float64 on the same layout: six bf16 products of three-plane splits a
  step in compensated sums keep float32's accuracy (measured 1e-6 to
  5e-6);
- 1e-10 of the scale between the factorised route and the plain wide
  version both in float64 with exact transforms: the same sums in another
  order;
- 5e-5 of the scale between the two float32 plain versions: each within
  ~5e-6 of float64, the wide one on a layout whose DFT matrices are built
  in complex64 up to D = 128 (~8e-6 apart from the exact tables);
- bit for bit for the operands: hi + lo + lo2 of a float32 value is the
  value exactly, and the permutation and the padding move values only;
- 1e-12 of the scale for the kernel's arithmetic emulated in float64 on
  the decoded operands against the plain version in float64.
"""
import itertools

import jax.numpy as jnp
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from test_torch_multipilot import _banks, _close, _obs
from test_torch_wide_circ_fact import _decode

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _f64(ckb):
    return mk.MpCircKernelBank(*(x.double() for x in ckb))


def test_plain_fact_k10_matches_jax_interpret_kernel_at_d144():
    """At D = 144 = 12 x 12, K = 8, P = 2 (one dead component) the entries
    take the factorised route; their plain version, flat and at T = 4
    (alpha 1 and 0.25), against JAX's interpret-mode
    `estimate_fused_circulant_mp[_coherent]` (three interpret calls of 64
    rows), and within 1e-5 of the function in float64 on its layout."""
    p, d, k = 2, 144, 8
    jb, tb = _banks(p, d=d, k=k, n_dead=1)
    assert mk.mp_circ_route(d, k, p) == mk.mp_circ_route(d, k, p, 4) == "fact"
    r = _obs(64, p * d)
    x2 = mk._x2(torch.as_tensor(r))
    before = tkn.launch_counts()
    got = mk.estimate_fused_circulant_mp(tb, torch.as_tensor(r))
    assert tkn.launch_counts() == before            # the CPU launches nothing
    ckb = mk.mp_circ_kernel_bank(tb)
    assert torch.equal(got, mk._hc(mk.mp_circ_fact_reference(x2, ckb),
                                   torch.complex64))
    _close(got, pk.estimate_fused_circulant_mp(jb, jnp.asarray(r),
                                               interpret=True), 2e-4)
    rb = r.reshape(16, 4, p * d)
    for alpha in (1.0, 0.25):
        got = mk.estimate_fused_circulant_mp_coherent(tb, torch.as_tensor(rb),
                                                      alpha)
        assert got.shape == (16, 4, d)
        _close(got, pk.estimate_fused_circulant_mp_coherent(
            jb, jnp.asarray(rb), alpha=alpha, interpret=True), 2e-4)
        ckb = mk.mp_circ_kernel_bank(tb, None, 4, alpha)
        exact = mk.mp_circ_fact_reference(x2.double(), _f64(ckb), 4, alpha)
        assert _rel(torch.view_as_real(got.reshape(64, d)).reshape(64, -1)
                    .double(), exact) < 1e-5


def _exact_transforms(ckb, blocks):
    """The float64 layout with its DFT matrices built in complex128 (the
    float32 layout's own are rounded, and complex64-built up to D =
    128)."""
    d = ckb.bfwd.shape[0] // 2
    f = tsb._dft_matrix(d, blocks, torch.complex128, torch.device("cpu"))
    return _f64(ckb)._replace(bfwd=mk._cplx_interleaved(f.T),
                              binv=mk._cplx_interleaved(f.conj()))


@pytest.mark.parametrize("p,d,k,t,alpha,n_dead,blocks", [
    (2, 24, 5, 1, 1.0, 1, None),
    (3, 24, 9, 4, 0.5, 2, None),
    (2, 32, 6, 3, 1.0, 1, (4, 8)),
    (3, 32, 4, 1, 1.0, 1, (4, 8)),
])
def test_plain_fact_matches_the_plain_wide_version(p, d, k, t, alpha, n_dead,
                                                   blocks):
    """The plain factorised K10 (bins permuted, the layout's rows and
    columns permuted to match) against the plain wide version on the same
    layout at small split widths (24 = 4 x 6; the kron(F_4, F_8) basis),
    with dead components: in float32 within 5e-5 of the scale, and in
    float64 with exact transforms within 1e-10."""
    bank = trc.random_dft_mp_bank(p, d, k, CPU, n_dead)
    ckb = mk.mp_circ_kernel_bank(bank, blocks, t, alpha)
    x2 = trc.random_rows(12 * t, 2 * p * d, CPU)
    got = mk.mp_circ_fact_reference(x2, ckb, t, alpha, blocks)
    assert _rel(got, mk.mp_circ_wide_reference(x2, ckb, t, alpha)) < 5e-5
    exact = _exact_transforms(ckb, blocks)
    assert _rel(mk.mp_circ_fact_reference(x2.double(), exact, t, alpha,
                                          blocks),
                mk._mp_reference(x2.double(), exact, t, alpha, 8192)) < 1e-10


def _logit_want(fb, d, p, steps, slot_pos):
    """The operand the kernel's logit reads, built from the layout's
    definition: row 16 (j S + s) + c of 8-slot block j, step s; u_a and
    v_ab at slot 8j + (c % 8) // 2 + 4 (c // 8), part c % 2; |u|^2 of
    pilot a (c < 8) or b at slot 8j + (c % 8) // 2 + 4 (c % 2)."""
    k = fb.const.shape[0]
    nsb = -(-slot_pos.shape[0] // 8)
    pairs = [(a, b) for a in range(p) for b in range(a + 1, p)]
    want = torch.zeros(16 * nsb * len(steps), k)
    for j in range(nsb):
        for s, (kind, a, b) in enumerate(steps):
            for c in range(16):
                half = (c % 8) // 2
                slot = 8 * j + half + 4 * (c % 2 if kind == "sq" else c // 8)
                pos = int(slot_pos[slot]) if slot < slot_pos.shape[0] else -1
                pil = a if c < 8 else b
                if pos < 0 or (kind == "sq" and pil >= p):
                    continue
                if kind == "u":
                    row = 2 * (a * d + pos) + c % 2
                elif kind == "v":
                    row = 3 * p * d + 2 * pairs.index((a, b)) * d + 2 * pos \
                        + c % 2
                else:
                    row = 2 * p * d + pil * d + pos
                want[16 * (j * len(steps) + s) + c] = fb.lcoef[row]
    return want


def _emulated(x2, ckb, ops, t, alpha):
    """The kernel's arithmetic in float64 on the decoded operands: the
    factorised transforms into the padded slots, the features of each
    step as the kernel forms them, the logit, offset and pooled softmax,
    the combine's P + 1 slabs a 4-slot group and h = c_bias + sum_p
    c_filt_p u_p a slot, the inverse."""
    two_d = ckb.bfwd.shape[0]
    d, p, k = two_d // 2, ckb.comb.shape[0] - 1, ckb.const.shape[0]
    d1, d2 = ops.d1, ops.d2
    dp = d1 * (d2 | 1)
    nsb, ng = -(-dp // 8), -(-dp // 4)
    steps = mk.mp_circ_fact_steps(p)
    frags = sum(pl.double() for pl in ops[:3])
    n_logit = 32 * nsb * len(steps) * -(-k // 8)
    lcoef = _decode(frags[:n_logit], 16 * nsb * len(steps), k, True)
    comb = _decode(frags[n_logit:], k, 8 * ng * (p + 1), False)
    n = x2.shape[0]
    xc = torch.view_as_complex(x2.double().reshape(n, p, d, 2).contiguous())
    slot = ck.circ_fact_slots(d1, d2)
    u = torch.zeros(n, p, 8 * nsb, dtype=torch.complex128)
    for pi in range(p):
        u[:, pi, slot] = ck.circ_fact_transform(xc[:, pi], d1, d2, ops.kron)
    c = torch.arange(16)
    cols = []
    for j in range(nsb):
        for kind, a, b in steps:
            if kind == "sq":
                sl = 8 * j + (c % 8) // 2 + 4 * (c % 2)
                pil = torch.where(c < 8, a, b)
                sq = u[:, pil.clamp(max=p - 1), sl].abs() ** 2
                cols.append(torch.where(pil < p, sq, torch.zeros_like(sq)))
            else:
                sl = 8 * j + (c % 8) // 2 + 4 * (c // 8)
                z = u[:, a, sl] if kind == "u" else u[:, a, sl].conj() * u[
                    :, b, sl]
                cols.append(torch.where(c % 2 == 0, z.real, z.imag))
    lg = torch.cat(cols, 1) @ lcoef + ckb.const.double()[None]
    off = lg[:, :64].max(-1, keepdim=True).values
    off = torch.where(off > -1e29, off, torch.zeros_like(off))
    w = torch.softmax(mk._pool(lg - off, t, alpha), -1)
    cs = (w @ comb).reshape(n, ng, p + 1, 4, 2)
    cs = torch.complex(cs[..., 0], cs[..., 1]).transpose(1, 2).reshape(
        n, p + 1, 4 * ng)
    h = cs[:, 0] + (cs[:, 1:] * u[:, :, :4 * ng]).sum(1)
    out = ck.circ_fact_transform(h[:, slot], d1, d2, ops.kron, inverse=True)
    return torch.view_as_real(out).reshape(n, two_d)


@pytest.mark.parametrize("p,d,k,t,blocks", [
    (2, 144, 8, 1, None), (3, 24, 13, 4, None), (2, 256, 5, 1, (16, 16)),
    (4, 30, 3, 3, None)])
def test_fact_operands_read_back_bit_for_bit(p, d, k, t, blocks):
    """`mp_circ_fact_operands`: the planes' fragments decode to the
    permuted lcoef (`mp_circ_fact_bank`) in the kernel's step order and to
    the permuted comb slabs in its tile order, on the padded slots
    (`circ_kernels.circ_fact_slots`), zero at the pads, bit for bit; the
    tables are K6's; `mp_circ_fact_units` counts the lanes; and the
    kernel's arithmetic evaluated in float64 on the decoded operands
    (`_emulated`) is the plain version in float64."""
    bank = trc.random_dft_mp_bank(p, d, k, CPU, 1)
    ckb = mk.mp_circ_kernel_bank(bank, blocks, t, 0.5)
    ops = mk.mp_circ_fact_operands(ckb, blocks)
    d1, d2 = ops.d1, ops.d2
    dp = d1 * (d2 | 1)
    assert (d1, d2) == ck.circ_fact_blocks(d, blocks)
    assert ops.kron == (blocks is not None) and ops.p == p
    units = mk.mp_circ_fact_units(d1, d2, p, k)
    assert all(pl.shape == (units, 4) and pl.dtype == torch.bfloat16
               for pl in ops[:3])
    steps = mk.mp_circ_fact_steps(p)
    assert len(steps) == p + p * (p - 1) // 2 + (p + 1) // 2
    frags = sum(pl.double() for pl in ops[:3])
    n_logit = 32 * -(-dp // 8) * len(steps) * -(-k // 8)
    fb = mk.mp_circ_fact_bank(ckb, blocks)
    slot_pos = torch.full((dp,), -1, dtype=torch.long)
    slot_pos[ck.circ_fact_slots(d1, d2)] = torch.arange(d)
    lcoef = _decode(frags[:n_logit], 16 * -(-dp // 8) * len(steps), k, True)
    assert torch.equal(lcoef.float(), _logit_want(fb, d, p, steps, slot_pos))
    ng = -(-dp // 4)
    comb = _decode(frags[n_logit:], k, 8 * ng * (p + 1), False)
    comb = comb.reshape(k, ng, p + 1, 4, 2)
    want = torch.zeros(k, ng, p + 1, 4, 2)
    for gs in range(4 * ng):
        pos = int(slot_pos[gs]) if gs < dp else -1
        if pos >= 0:
            want[:, gs // 4, :, gs % 4] = fb.comb[:, :, 2 * pos:2 * pos + 2
                                                  ].transpose(0, 1)
    assert torch.equal(comb.float(), want)
    tw = ck.circ_fact_operands(ck.CircKernelBank(
        ckb.bfwd, torch.zeros(3 * d, 1), torch.zeros(1),
        torch.zeros(1, 4 * d), ckb.binv), blocks).tw
    assert torch.equal(ops.tw, tw)
    x2 = trc.random_rows(6 * t, 2 * p * d, CPU)
    exact = mk.mp_circ_fact_reference(x2.double(), _f64(ckb), t, 0.5, blocks)
    assert _rel(_emulated(x2, ckb, ops, t, 0.5), exact) < 1e-12


def test_routes_partition_the_rule():
    """Every shape `mp_circ_kernel_eligible` admits takes exactly one of
    the template, the factorised kernel and the dense wide form
    (`mp_circ_route`), and no other shape takes any; the factorised
    kernel only past the template, where D splits into two levels of at
    most 64 points, T <= 64 and its tile fits (`mp_circ_fact_plan`), and
    within its measured reach: K <= 64 and 3 K <= D, dense odd-prime
    stages of at most D / 10 points, two sweeps only without them. The
    edges: P = 4 fits at D = 256, K = 32 and not P = 5; at D = 357 P = 3
    and not P = 4; D = 249 = 3 x 83, 129 = 3 x 43, K = 96 at D = 256, K =
    64 at D = 144, T = 64 at D = 200 keep the dense wide form; T = 64 at D
    = 256 takes the factorised kernel."""
    ds = (1, 16, 24, 64, 128, 129, 131, 144, 189, 200, 249, 256, 336, 357,
          512, 652, 672, 673)
    ks = (1, 8, 32, 64, 128, 129, 1024)
    ps = (1, 2, 3, 4, 5, 12, 40)
    counts = {"template": 0, "fact": 0, "wide": 0}
    for d, k, p, t in itertools.product(ds, ks, ps, (1, 3, 4, 16, 64, 65)):
        ok = mk.mp_circ_kernel_eligible(d, k, p, t)
        takers = [mk.mp_circ_narrow(d, k, p, t),
                  mk.mp_circ_fact_eligible(d, k, p, t),
                  ok and not mk.mp_circ_narrow(d, k, p, t)
                  and not mk.mp_circ_fact_eligible(d, k, p, t)]
        assert sum(takers) == ok, (d, k, p, t)
        if not ok:
            with pytest.raises(ValueError, match="multi-pilot circulant"):
                mk.mp_circ_route(d, k, p, t)
            continue
        route = mk.mp_circ_route(d, k, p, t)
        counts[route] += 1
        if route == "fact":
            levels = ck.circ_fact_blocks(d)
            assert levels and 3 * k <= d and k <= 64 and t <= 64
            assert mk.mp_circ_fact_plan(*levels, p, k, t) is not None
            odd = mk._odd_points(levels[0]) + mk._odd_points(levels[1])
            assert 10 * odd <= d
    assert min(counts.values()) > 100, counts
    assert mk.mp_circ_route(256, 32, 2) == mk.mp_circ_route(256, 32, 2,
                                                             4) == "fact"
    assert mk.mp_circ_route(256, 32, 4) == "fact"
    assert mk.mp_circ_route(256, 32, 5) == "wide"
    assert mk.mp_circ_route(357, 1, 3, 4) == "fact"
    assert mk.mp_circ_route(357, 1, 4) == "wide"
    assert mk.mp_circ_route(249, 1, 3, 16) == "wide"
    assert mk.mp_circ_route(64, 256, 2) == "wide"
    assert mk.mp_circ_route(129, 8, 2) == mk.mp_circ_route(256, 96, 2) \
        == mk.mp_circ_route(144, 64, 2) == "wide"
    assert mk.mp_circ_route(200, 8, 2, 16) == "fact"
    assert mk.mp_circ_route(200, 8, 2, 64) == "wide"
    assert mk.mp_circ_route(256, 8, 2, 64) == "fact"
    assert mk.mp_circ_route(336, 64, 2) == mk.mp_circ_route(189, 8, 4) \
        == "fact"
    assert [mk._odd_points(n) for n in (16, 21, 43, 12, 25, 17)] == [
        0, 10, 43, 3, 10, 17]
    assert mk.mp_circ_route(256, 16, 2, 16, (16, 16)) == "fact"
    assert mk.mp_circ_route(256, 16, 2, 16, (2, 128)) == "wide"
    assert mk.mp_circ_route(64, 64, 2) == "template"
    assert mk.mp_circ_fact_plan(16, 16, 2, 32) == (2, mk.mp_circ_fact_smem(
        16, 16, 2, 32, 1, 2))
    assert mk.mp_circ_fact_plan(16, 21, 2, 64)[0] == 1


def test_entries_at_d256_take_the_plain_fact_route_on_cpu():
    """At D = 256, K = 4, P = 2 the entries and the stages' kernel route,
    flat and at T = 4, give the factorised route's plain version on CPU
    tensors, launch nothing, cache only the layouts, and agree with the
    `torch.fft` pipeline within 2e-4 of the scale; the factorised wrappers
    are counted kernels and K10's coherent one refuses T < 2."""
    p, d, k = 2, 256, 4
    bank = trc.random_dft_mp_bank(p, d, k, CPU, 1)
    r = torch.view_as_complex(trc.random_rows(16, 2 * p * d, CPU)
                              .reshape(16, p * d, 2).contiguous())
    cache = {}
    before = tkn.launch_counts()
    got = mk.estimate_fused_circulant_mp(bank, r, None, cache)
    x2 = mk._x2(r)
    assert torch.equal(got, mk._hc(mk.mp_circ_fact_reference(
        x2, mk.lowered(bank, cache)), torch.complex64))
    rb = r.reshape(4, 4, p * d)
    coh = mk.estimate_fused_circulant_mp_coherent(bank, rb, 0.5, None, cache)
    assert torch.equal(coh.reshape(16, d), mk._hc(mk.mp_circ_fact_reference(
        x2, mk.lowered(bank, cache, None, 4, 0.5), 4, 0.5), torch.complex64))
    assert tkn.launch_counts() == before
    assert set(cache) == {(None, 1, 1.0), (None, 4, 0.5)}
    assert torch.equal(tst.estimate_circulant(bank, r, method="kernel"), got)
    _close(got, tsb.estimate_circulant_mp(bank, r), 2e-4)
    _close(coh, tsb.estimate_circulant_mp_coherent(bank, rb, "all", 2048,
                                                   0.5), 2e-4)
    ops = mk.lowered_tc(bank, cache, None, fact=True)
    assert mk.lowered_tc(bank, cache, None, fact=True) is ops
    assert isinstance(ops, mk.MpCircFactOperands)
    assert ("mp_circ_fact_operands", None) in cache
    ckb = mk.lowered(bank, cache)
    assert torch.equal(mk.mp_circ_estimate_fact(x2, ckb, ops),
                       mk.mp_circ_estimate_fact(x2, ckb))
    with pytest.raises(ValueError, match="T >= 2"):
        mk.mp_circ_estimate_coherent_fact(x2, ckb, 1)
    assert {"mp_circ_estimate_fact", "mp_circ_estimate_coherent_fact"} <= set(
        tkn.launch_counts())


def test_tc_repeat_check_fact_mpcirc_mode_on_cpu():
    """Mode 'fact_mpcirc' of `tc_repeat_check` through the plain versions:
    every launch held, none off; its card shapes, each on the factorised
    route: P = 2 at D = 256, P = 3 at D = 144 with T = 3 and alpha 0.5, the
    largest P the route takes at D = 357, T past a tile's rows (two
    sweeps), a kron basis."""
    shapes = ((2, 24, 5, 20, 1, 1, 1.0, None), (3, 32, 4, 3 * 4, 0, 3, 0.5,
                                                 (4, 8)))
    got = trc.repeat_check(CPU, repeats=2, poison=False,
                           modes=("fact_mpcirc",), fact_mpcirc_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for label, rec in got["kernel"].items():
        assert label.endswith(" K10 fact")
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    shapes = trc.FACT_MPCIRC_SHAPES
    for p, d, k, n, _, t, _, blocks in shapes:
        assert mk.mp_circ_route(d, k, p, t, blocks) == "fact" and n % t == 0
    assert any(s[:3] == (2, 256, 32) for s in shapes)
    assert any(s[0] == 3 and s[1] == 144 and s[5] == 3 and s[6] == 0.5
               for s in shapes)
    top = max(s[0] for s in shapes if s[1] == 357)
    assert mk.mp_circ_route(357, 1, top) == "fact"
    assert not mk.mp_circ_fact_eligible(357, 1, top + 1)
    assert any(s[5] > 16 * mk.mp_circ_fact_plan(
        *ck.circ_fact_blocks(s[1], s[7]), s[0], s[2], s[5])[0]
        for s in shapes)
    assert any(s[7] is not None for s in shapes)


def test_circ_fact_bench_mp_leg_needs_a_card():
    """The `mp` leg of `tools/circ_fact_bench.py` measures on the card
    only."""
    from quantized_channel_estimation_torch.tools import circ_fact_bench
    with pytest.raises(SystemExit, match="needs a card"):
        circ_fact_bench.main(["mp"])
