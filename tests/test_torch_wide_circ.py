"""The circulant kernels K6-K9 on wide banks on the CPU: the shape rule
(`circ_kernels.circ_kernel_eligible`) against the JAX package's Pallas
rule, the port's K6-K9 entries against JAX's interpret-mode kernels at
D = 144, the wide form's bank and row layouts read back bit for bit, the
units walked in the kernel's order against the float64 plain version, a
bank past one launch's 128 components split and merged, the wide
layout's transforms rounded once from complex128, and the entry points
(stages, the service, a 2 x 2 in-process mesh) at D = 144.

The wide kernels themselves run only on the card (`tests/test_torch_cuda.py`,
`test_circ_wide_*`): their plain versions are the width-agnostic
`circ_estimate_reference` and its siblings, which every wrapper computes
here.

Tolerances, with their reasons:
- 2e-4 of the output scale against JAX's interpret-mode kernels, the
  existing circulant tests' own (`tests/test_torch_circ_kernels.py`): both
  sides are float32 and expand the quadratic logit, which cancels, with
  the products summed in another order;
- bit for bit for the layouts: hi + lo + lo2 of a float32 value is the
  value exactly, and the swizzle is a permutation;
- 1e-12 of the scale for the kernel's walk of the units in float64 against
  the float64 plain version: the same sums in another order;
- 1e-5 of the scale between the wide layout evaluated in float64 and the
  float64 `torch.fft` pipeline at D = 512: what is left is the layout's
  own float32 rounding (about 4e-6 at those inputs);
- 1e-4 of the scale between the kernel route and the `torch.fft` pipeline
  (stages, service, mesh, merged shards), the circulant tests' tolerance
  between those two float32 pipelines at D = 144.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.estimators import circ_kernels as ck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.parallel import mesh as pm
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from test_torch_circ_kernels import _banks, _close, _obs

torch.set_num_threads(2)

D, K = 144, 8


def _jax_pallas_rule(d, k, t=1):
    """The JAX package's rule for its Pallas circulant kernels
    (`models/structured_bank.py:412-415`, and :602-604 with T <= 16 for
    the coherent form): the bank's constants within 13 MiB."""
    kernel_bytes = 4 * (8 * d * d + 3 * d * k + 4 * k * d + 2 * k)
    return kernel_bytes <= 13 * 1024 * 1024 and 1 <= t <= 16


def test_rule_is_a_superset_of_the_jax_pallas_set():
    """Every (D, K, T <= 16) over K in {1, 2, 16, 64, 256, 1024} and D 16
    to 1024 in steps of 8 for which JAX runs a Pallas circulant kernel is
    admitted; past D = 128 the wide form takes it. The new edge is D = 672
    (the first 64-chunk edge of 2D at or past JAX's largest D, 652 at K =
    1); K10's template keeps D, K <= 128 and its wide form takes D past
    it, to the same edge."""
    admitted, wide = 0, set()
    for k, d, t in itertools.product((1, 2, 16, 64, 256, 1024),
                                     range(16, 1025, 8), (1, 2, 4, 16)):
        if not _jax_pallas_rule(d, k, t):
            continue
        admitted += 1
        assert ck.circ_kernel_eligible(d, k, t), (d, k, t)
        if d > ck.CIRC_MAX_D:
            wide.add(d)
    assert admitted > 1000
    assert {136, 512, 648} <= wide and max(wide) == 648
    assert _jax_pallas_rule(652, 1) and not _jax_pallas_rule(653, 1)
    assert ck.circ_kernel_eligible(672, 1) and ck.circ_kernel_eligible(
        672, 1000, 64)
    assert not ck.circ_kernel_eligible(673, 1)
    assert not ck.circ_kernel_eligible(200, 8, 65)
    assert ck.circ_tile_rows(673) == ck.circ_tile_rows(200) == 64
    assert ck.CIRC_MAX_D == mk.CIRC_MAX_D == 128
    # K10's template stays at D, K <= 128; past it K10's wide form, to the
    # same D = 672
    assert mk.mp_circ_narrow(128, 128, 1)
    assert not mk.mp_circ_narrow(129, 8, 1) and mk.mp_circ_kernel_eligible(
        129, 8, 1)
    assert not mk.mp_circ_narrow(64, 129, 2) and mk.mp_circ_kernel_eligible(
        64, 129, 2)
    assert mk.WIDE_MAX_D == ck.CIRC_WIDE_MAX_D
    assert not mk.mp_circ_kernel_eligible(673, 8, 1)


def test_launch_rows_keep_whole_blocks_within_the_scratch():
    """Rows of one wide launch: every row up to the budget, past it a
    multiple of 128 T whose scratch fits `kernels.WIDE_SCRATCH`."""
    assert ck.circ_wide_launch_rows(1000, 512, 16) == 1000
    for d, k, t in ((129, 1, 1), (512, 16, 4), (672, 128, 64)):
        rows = ck.circ_wide_launch_rows(10 ** 8, d, k, t)
        per_row = 384 * max(-(-3 * d // 64), -(-k // 64)) + 8 * d + 4 * k + 4
        assert rows % (128 * t) == 0 and rows >= 128 * t
        assert rows * per_row <= tkn.WIDE_SCRATCH


def test_plain_k6_k8_match_jax_interpret_kernels_at_d144():
    """K6 (flat and the kron basis (12, 12)) and K8, with two dead
    components, against JAX's interpret-mode kernels."""
    jbank, tbank = _banks(n_dead=2, d=D)
    r = _obs(256, d=D)
    got = ck.estimate_fused_circulant(tbank, torch.as_tensor(r))
    _close(got, pk.estimate_fused_circulant(jbank, jnp.asarray(r),
                                            interpret=True))
    jb, tb = _banks(n_dead=2, blocks=(12, 12), d=D)
    got = ck.estimate_fused_circulant(tb, torch.as_tensor(r), blocks=(12, 12))
    _close(got, pk.estimate_fused_circulant(jb, jnp.asarray(r),
                                            interpret=True, blocks=(12, 12)))
    got = ck.estimate_fused_circulant_stats(tbank, torch.as_tensor(r))
    want = pk.estimate_fused_circulant_stats(jbank, jnp.asarray(r),
                                             interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_plain_k7_k9_match_jax_interpret_kernels_at_d144(alpha):
    """K7 and K9 on blocks of T = 4, with a dead component."""
    jbank, tbank = _banks(n_dead=1, d=D)
    r = _obs(4 * 64, d=D).reshape(64, 4, D)
    got = ck.estimate_fused_circulant_coherent(tbank, torch.as_tensor(r),
                                               alpha=alpha)
    _close(got, pk.estimate_fused_circulant_coherent(
        jbank, jnp.asarray(r), alpha=alpha, interpret=True))
    got = ck.estimate_fused_circulant_coherent_stats(
        tbank, torch.as_tensor(r), alpha=alpha)
    want = pk.estimate_fused_circulant_coherent_stats(
        jbank, jnp.asarray(r), alpha=alpha, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


def _decoded(ops):
    """The float32 units behind the operands: unswizzled, hi + lo + lo2."""
    hi, lo, lo2 = (tkn._sw128(x).to(torch.float32) for x in ops)
    return (hi + lo) + lo2


@pytest.mark.parametrize("d,k,stats", [(144, 8, False), (130, 70, True),
                                       (672, 3, False)])
def test_wide_bank_layout_reads_back_bit_for_bit(d, k, stats):
    """`circ_wide_operands`: `circ_wide_units` units, each the transpose
    of its operand's 64 x 64 block, walked by hand: bfwd's (piece, chunk)
    units, lcoef's, the combine's bias and filter slabs piece by piece,
    binv's (not for the stats forms)."""
    ckb = trc.random_circ_bank(d, k, torch.device("cpu"), n_dead=1)
    ops = ck.circ_wide_operands(ckb, stats)
    units = _decoded(ops)
    assert units.shape == (ck.circ_wide_units(d, k, stats), 64, 64)
    assert torch.equal(units, ck.circ_wide_tc_units(ckb, stats))
    npd, nz, kp = -(-2 * d // 64), -(-3 * d // 64), -(-k // 64)
    comb = ck.circ_mp_bank(ckb).comb

    def block(w, c, j):
        b = torch.zeros(64, 64)
        part = w[64 * c:64 * c + 64, 64 * j:64 * j + 64]
        b[:part.shape[0], :part.shape[1]] = part
        return b.T

    want = [block(ckb.bfwd, c, j) for j in range(npd) for c in range(npd)]
    want += [block(ckb.lcoef, c, j) for j in range(kp) for c in range(nz)]
    want += [block(comb[s], c, j) for j in range(npd) for s in (0, 1)
             for c in range(kp)]
    if not stats:
        want += [block(ckb.binv, c, j) for j in range(npd)
                 for c in range(npd)]
    assert torch.equal(units, torch.stack(want))
    assert set(ops.hi.shape) == {units.shape[0], 64} and all(
        x.dtype == torch.bfloat16 and x.is_contiguous() for x in ops)


def test_wide_layout_transforms_are_rounded_once():
    """Past D = 128 the layout's DFT matrices are the complex128 ones
    rounded once to float32 (up to D = 128 JAX's complex64 construction
    stays), so the float64 evaluation of the layout at D = 512 lies within
    1e-5 of the scale of the float64 `torch.fft` pipeline (a complex64
    construction: 6.7e-4 at these inputs)."""
    from quantized_channel_estimation_torch.ops import linalg
    from quantized_channel_estimation_torch.tools import circ_kernel_bench
    bank = circ_kernel_bench.synthetic_bank(512, 16)
    ckb = ck.circ_kernel_bank(bank)
    f = linalg.unitary_dft(512, torch.complex128)
    assert torch.equal(ckb.bfwd, mk._cplx_interleaved(f.T).float())
    assert torch.equal(ckb.binv, mk._cplx_interleaved(f.conj()).float())
    narrow = ck.circ_kernel_bank(circ_kernel_bench.synthetic_bank(128, 4))
    assert torch.equal(narrow.bfwd, mk._cplx_interleaved(
        linalg.unitary_dft(128).T).float())
    r = circ_kernel_bench.complex_randn((256, 512))
    bank64 = type(bank)(*(x.to(torch.complex128) if x.is_complex()
                          else x.double() for x in bank))
    exact = tsb.estimate_circulant(bank64, r.to(torch.complex128),
                                   method="fft")
    got = ck.circ_estimate_reference(ck._x2(r).double(), ck.CircKernelBank(
        *(x.double() for x in ckb)))
    got = torch.view_as_complex(got.reshape(256, 512, 2))
    assert float((got - exact).abs().max() / exact.abs().max()) < 1e-5


def test_wide_row_layout_reads_back_bit_for_bit():
    """`circ_wide_rows`: the rows' (and u's features') three planes in
    64-row tiles of 64-deep chunks, padding zero."""
    rows = trc.random_rows(150, 2 * D, torch.device("cpu"))
    for feats in (False, True):
        a = ck.circ_wide_rows(rows, feats)
        want = rows
        if feats:
            u3 = rows.reshape(150, D, 2)
            want = torch.cat([rows, (u3 * u3).sum(-1)], 1)
        w = want.shape[1]
        assert a.shape == (3, 4, -(-w // 64), 64, 64)
        x = _decoded(a.reshape(3, -1, 64, 64)).reshape(4, -(-w // 64), 64,
                                                       64)
        x = x.permute(0, 2, 1, 3).reshape(256, -1)
        assert torch.equal(x[:150, :w], want)
        assert not x[150:].any() and not x[:, w:].any()


def _walk(x2, ckb, t, alpha, stats):
    """The wide form's arithmetic on its units in float64, each product as
    the kernel walks them (output piece j, contraction chunk c: unit j
    n_ch + c), the combine's piece pairs (bias, filter) of one slice."""
    two_d = x2.shape[1]
    d, k, n = two_d // 2, ckb.const.shape[0], x2.shape[0]
    units = _decoded(ck.circ_wide_operands(ckb, stats)).double()
    npd, nz, kp = -(-two_d // 64), -(-3 * d // 64), -(-k // 64)

    def product(a, u0, n_ch, n_pieces):
        a = torch.nn.functional.pad(a, (0, 64 * n_ch - a.shape[1]))
        out = a.new_zeros(n, 64 * n_pieces)
        for j in range(n_pieces):
            for c in range(n_ch):
                out[:, 64 * j:64 * j + 64] += (a[:, 64 * c:64 * c + 64]
                                               @ units[u0 + j * n_ch + c].T)
        return out

    u = product(x2.double(), 0, npd, npd)[:, :two_d]
    u3 = u.reshape(n, d, 2)
    lg = product(torch.cat([u, (u3 * u3).sum(-1)], 1), npd * npd, nz,
                 kp)[:, :k] + ckb.const.double()
    lg = mk._pool(lg, t, alpha)
    m = lg.max(-1, keepdim=True).values
    p = torch.exp(lg - m)
    den = p.sum(-1, keepdim=True)
    c = product(p if stats else p / den, npd * npd + kp * nz, kp,
                2 * npd).reshape(n, npd, 2, 64)
    cb, cf = (c[:, :, s].reshape(n, -1)[:, :two_d].reshape(n, d, 2)
              for s in (0, 1))
    ur, ui = u3[..., 0], u3[..., 1]
    h = torch.stack([cb[..., 0] + cf[..., 0] * ur - cf[..., 1] * ui,
                     cb[..., 1] + cf[..., 0] * ui + cf[..., 1] * ur],
                    -1).reshape(n, two_d)
    if stats:
        return m[:, 0], den[:, 0], h
    return (product(h, npd * npd + kp * nz + 2 * npd * kp, npd,
                    npd)[:, :two_d],)


@pytest.mark.parametrize("d,k,t,alpha,stats", [
    (150, 70, 1, 1.0, False), (130, 5, 4, 0.5, True),
    (200, 64, 3, 1.0, False), (129, 128, 1, 1.0, True)])
def test_wide_units_walked_in_kernel_order_give_the_estimate(d, k, t, alpha,
                                                             stats):
    """The units in the order the kernel reads them reproduce the float64
    plain version (K6-K9 at widths past 128, a 128-component shard, ragged
    pieces of 2D, 3D and K)."""
    ckb = trc.random_circ_bank(d, k, torch.device("cpu"), n_dead=2, t_coh=t)
    x2 = trc.random_rows(12 * t, 2 * d, torch.device("cpu"))
    f64 = ck.CircKernelBank(*(v.double() for v in ckb))
    want = ck._circ_reference(x2.double(), f64, t, alpha, stats, 16384)
    want = want if stats else (want,)
    for g, w in zip(_walk(x2, ckb, t, alpha, stats), want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-12


def test_banks_past_one_launch_split_and_merge_at_d144():
    """K = 200 at D = 144: two shards (128 + 72 components) through K8 /
    K9, merged and inverse-transformed once, equal the whole bank's
    `torch.fft` estimate, flat and on T = 4 blocks; their layouts and
    wide operands cached once."""
    _, tbank = _banks(n_dead=3, k=200, d=D)
    cache = {}
    assert len(ck.lowered(tbank, cache)) == 2
    r = torch.as_tensor(_obs(64, d=D))
    _close(ck.estimate_fused_circulant(tbank, r, cache=cache),
           tsb.estimate_circulant(tbank, r, method="fft").numpy(), 1e-4)
    rb = r.reshape(16, 4, D)
    _close(ck.estimate_fused_circulant_coherent(tbank, rb, 0.5, cache=cache),
           tsb.estimate_circulant_coherent(tbank, rb, alpha=0.5,
                                           method="fft").numpy(), 1e-4)
    ops = ck.lowered_tc(tbank, cache, stats=True)
    assert ck.lowered_tc(tbank, cache, stats=True) is ops
    assert ("circ_wide_operands", None, True) in cache
    assert [o.hi.shape[0] for o in ops] == [
        ck.circ_wide_units(D, 128, True), ck.circ_wide_units(D, 72, True)]


def test_entry_points_at_d144_give_the_fft_answers():
    """`stages.estimate_circulant[_coherent]` ('auto' takes the kernels at
    D = 144; 'kernel' no longer raises), the structured service and the
    same service over a 2 x 2 in-process mesh (K8 / K9 a shard) answer as
    the `torch.fft` pipeline does."""
    rng = np.random.default_rng(5)
    k = 8
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    w /= w.sum()
    means = (0.2 * (rng.standard_normal((k, D))
                    + 1j * rng.standard_normal((k, D)))).astype(np.complex64)
    spec = rng.uniform(0.05, 2.0, (k, D)).astype(np.float32)
    r = _obs(64, d=D, seed=7)
    _, tbank = _banks(n_dead=1, d=D)
    rt = torch.as_tensor(r)
    assert tst._circ_method("auto", "all", tbank) == "kernel"
    _close(tst.estimate_circulant(tbank, rt, method="kernel"),
           tsb.estimate_circulant(tbank, rt, method="fft").numpy(), 1e-4)
    rb = rt.reshape(16, 4, D)
    _close(tst.estimate_circulant_coherent(tbank, rb, alpha=0.25),
           tsb.estimate_circulant_coherent(tbank, rb, alpha=0.25,
                                           method="fft").numpy(), 1e-4)
    snr = 5.0
    svcs = [serving.EstimationService.from_circulant_spectra(
        w, means, spec, 1.0 + 0.0j, 2, device="cpu", max_delay_ms=1.0,
        use_kernels=use, mesh=mesh)
        for use, mesh in ((True, None), (False, None),
                          (True, pm.make_local_mesh(2, 2)))]
    try:
        assert [s.use_kernels for s in svcs] == [True, False, True]
        for req in (r, r.reshape(16, 4, D)):
            want = svcs[1].submit(req, snr, timeout=60)
            for s in (svcs[0], svcs[2]):
                _close(s.submit(req, snr, timeout=60), want, 1e-4)
    finally:
        for s in svcs:
            s.close(timeout=60)


def test_tc_repeat_check_wide_circ_mode_on_cpu():
    """Mode 'wide_circ' of `tc_repeat_check` through the plain versions:
    every launch held, none off; its card shapes cover each kernel, the
    rule's edge, a 128-component shard and the pool at T = 3, 4 and 64."""
    shapes = ((130, 3, 40, 1, 1, 1.0, False), (136, 5, 4 * 9, 0, 4, 0.5,
                                                True))
    got = trc.repeat_check(torch.device("cpu"), repeats=2, poison=False,
                           modes=("wide_circ",), wide_circ_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for label, rec in got["kernel"].items():
        assert label.endswith(" wide")
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    shapes = trc.WIDE_CIRC_SHAPES
    assert all(d > ck.CIRC_MAX_D for d, *_ in shapes)
    assert max(d for d, *_ in shapes) == ck.CIRC_WIDE_MAX_D
    assert any(k == 128 and stats for _, k, *_, stats in shapes)
    assert {(t > 1, stats) for *_, t, _, stats in shapes} == {
        (False, False), (False, True), (True, False), (True, True)}
    assert {3, 4, 64} <= {s[4] for s in shapes}


def test_circ_kernel_bench_runs_every_leg_on_cpu(capsys):
    """The port of the JAX `tools/circ_kernel_bench.py` at a small row
    scale through the plain versions: its four legs, each kernel route
    within 1e-4 (2e-3 at D = 512, where both float32 pipelines round a
    512-bin transform) of the `torch.fft` pipeline."""
    from quantized_channel_estimation_torch.tools import circ_kernel_bench
    rec = circ_kernel_bench.main(["--rows-scale", "0.004"], device="cpu")
    assert set(rec["legs"]) == {"flat", "coherent", "tp", "d512"}
    for leg, routes in rec["legs"].items():
        for label, route in routes.items():
            assert route["ms"] > 0 and route["launches"] == {}
            if "rel_to_fft" in route:
                assert route["rel_to_fft"] < (2e-3 if leg == "d512"
                                              else 1e-4), (leg, label)
                assert route["bound_by"] in ("operations", "bytes")
                assert route["bound_dft_ms"] > route["bound_ms"] > 0
    assert '"legs"' in capsys.readouterr().out


def test_circ_bound_counts_the_transforms_as_ffts():
    """`circ_bound`: the transforms as FFTs (5 D log2 D fp32 operations a
    row each, the stats forms the forward one alone), the logit and
    combine as six bf16 products, the rows and the bank's logit and
    combine operands read once; `bound_dft_ms` adds the dense (2D, 2D)
    products the kernels compute. At the d512 leg's shape the function is
    bound by bytes; the dense products alone take 0.86 ms at the bf16
    peak."""
    from quantized_channel_estimation_torch.utils import profiling
    n, d, k = 32768, 512, 16
    b = ck.circ_bound(n, d, k)
    rows = 4.0 * 2 * n * 2 * d
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == rows + 4.0 * (7 * d * k + k)
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)
    assert b["tc_flops"] == 6.0 * 2 * n * 7 * d * k
    assert b["fp32_flops"] == pytest.approx(
        n * (2 * 5.0 * d * 9 + 11 * d + 5 * k))
    dense = 6.0 * 2 * n * 2 * (2 * d) ** 2
    assert b["bound_dft_ms"] == pytest.approx(
        (dense + b["tc_flops"]) / profiling.PEAK_BF16_FLOPS * 1e3
        + n * (11 * d + 5 * k) / profiling.PEAK_FP32_FLOPS * 1e3)
    assert 0.85 < b["bound_dft_ms"] < 0.87
    s = ck.circ_bound(n, d, k, 4, stats=True)
    assert s["fp32_flops"] == pytest.approx(
        n * (5.0 * d * 9 + 11 * d + 8 * k))
    assert s["bytes"] == b["bytes"] + 8.0 * n
    assert 0.43 < s["bound_dft_ms"] < 0.45


def test_dft_construction_error_reads_the_layouts_floor():
    """`circ_kernel_bench.dft_construction_error`: the float64 evaluation
    of the float32 layout against the float64 `torch.fft` pipeline, by
    the DFT matrix's construction; the once-rounded complex128 matrix is
    the nearer one, at a narrow width as at a wide one."""
    from quantized_channel_estimation_torch.tools import circ_kernel_bench
    for d in (64, 144):
        e = circ_kernel_bench.dft_construction_error(d, 4, 64, "cpu")
        assert set(e) == {"complex64", "complex128_rounded"}
        assert 0 < e["complex128_rounded"] < e["complex64"] < 1e-3, (d, e)
