"""The multi-pilot circulant kernel K10 on wide banks on the CPU: the shape
rule (`mp_circ_kernels.mp_circ_kernel_eligible`) against the JAX package's
Pallas rule, the wide form's launch rows, its bank and feature layouts
read back bit for bit, its transforms rounded once, its plain version
`mp_circ_wide_reference` (which the wide wrappers compute here) against
JAX's interpret-mode K10 at D = 144 (P = 2 and 3) and at K = 200, the
stages' dispatch at those shapes, the port of `tools/mp_kernel_bench.py`,
`mp_circ_bound` and the wide K10 mode of `tools.tc_repeat_check`.

The wide kernels themselves run only on the card
(`tests/test_torch_cuda.py`, `test_mp_circ_wide_*`).

Tolerances, with their reasons:
- 2e-4 of the output scale against JAX's interpret-mode kernel, the
  multi-pilot tests' own (`tests/test_torch_multipilot.py`): both sides
  are float32 and expand the quadratic u^H Prec u, whose P^2 terms cancel,
  with the products summed in another order;
- bit for bit for the layouts: hi + lo + lo2 of a float32 value is the
  value exactly, and the swizzle is a permutation;
- 2e-4 of the scale between the kernel route and the `torch.fft` pipeline
  (the same two float32 evaluations of the expanded and the per-bin
  quadratic);
- 1e-6 of the scale for the wide plain version against the function in
  float64 on the same layout at small widths: six bf16 products of
  three-plane splits keep float32's accuracy (measured 1.0e-7 to 1.7e-7).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    mp_circ_kernels as mk)
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import structured_bank as tsb
from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc
from test_torch_multipilot import _banks, _close, _obs

torch.set_num_threads(2)

D = 144
CPU = torch.device("cpu")


def test_rule_is_a_superset_of_the_jax_pallas_set():
    """Every (D, K, P, T <= 16) of the grid for which JAX runs its Pallas
    K10 (`_mp_circ_kernel_eligible`, with T <= 16 for the coherent form)
    is admitted; past the template's rule the wide form takes it. The JAX
    rule's reach (D 357 at P = 2, K 8090 at D = 16, P 202 at D = 1) and the
    wide form's edges: D = 672, T = 64, P while 128 T rows fit the
    scratch."""
    ds = sorted({*range(1, 400, 13), 128, 129, 144, 189, 249, 256, 336,
                 357, 358})
    ks = (1, 2, 8, 64, 128, 129, 256, 1024, 1270, 2674, 4096, 8090, 8192)
    ps = (1, 2, 3, 4, 5, 8, 12, 16, 32, 64, 128, 168, 202, 209, 259)
    admitted, wide = 0, 0
    for d, k, p, t in itertools.product(ds, ks, ps, (1, 4, 16)):
        if not pk._mp_circ_kernel_eligible(d, k, p, t):
            continue
        admitted += 1
        assert mk.mp_circ_kernel_eligible(d, k, p, t), (d, k, p, t)
        wide += not mk.mp_circ_narrow(d, k, p, t)
    assert admitted > 3000 and wide > 1500
    jr = pk._mp_circ_kernel_eligible
    assert jr(357, 1, 2) and not jr(358, 1, 2)
    assert jr(16, 8090, 2) and not jr(16, 8091, 2)
    assert jr(1, 1, 202) and not jr(1, 1, 203)
    # the template keeps exactly its shapes; the wide form takes the rest
    assert mk.mp_circ_narrow(128, 128, 5) and not mk.mp_circ_narrow(129, 8, 2)
    assert not mk.mp_circ_narrow(64, 129, 2)
    assert not mk.mp_circ_narrow(64, 64, 12)
    assert mk.mp_circ_wide_eligible(672, 1, 2)
    assert not mk.mp_circ_kernel_eligible(673, 1, 2)
    assert mk.mp_circ_kernel_eligible(200, 8, 2, 64)
    assert not mk.mp_circ_kernel_eligible(200, 8, 2, 65)
    assert mk.mp_circ_kernel_eligible(16, 100_000, 2)
    assert mk.mp_circ_kernel_eligible(1, 1, 293, 16)
    assert not mk.mp_circ_kernel_eligible(1, 1, 294, 16)
    assert mk.mp_circ_kernel_eligible(1, 1, 1180)
    assert not mk.mp_circ_kernel_eligible(1, 1, 1181)


def test_launch_rows_keep_whole_blocks_within_the_scratch():
    """Rows of one wide launch: every row up to the budget, past it a
    multiple of 128 T whose scratch (`mp_circ_wide_row_bytes`) fits
    `kernels.WIDE_SCRATCH`."""
    assert mk.mp_circ_wide_launch_rows(1000, 256, 32, 2) == 1000
    for d, k, p, t in ((129, 1, 2, 1), (357, 1, 2, 16), (16, 8090, 2, 4),
                       (1, 1, 202, 1), (672, 64, 3, 64)):
        rows = mk.mp_circ_wide_launch_rows(10 ** 8, d, k, p, t)
        per_row = mk.mp_circ_wide_row_bytes(d, k, p)
        feat = d * (3 * p + p * (p - 1))
        assert per_row == (384 * max(p * -(-2 * d // 64), -(-feat // 64),
                                     -(-k // 64)) + 8 * p * d + 4 * k + 4)
        assert rows % (128 * t) == 0 and rows >= 128 * t
        assert rows * per_row <= tkn.WIDE_SCRATCH


def _decoded(ops):
    """The float32 units behind the operands: unswizzled, hi + lo + lo2."""
    hi, lo, lo2 = (tkn._sw128(x).to(torch.float32) for x in ops)
    return (hi + lo) + lo2


@pytest.mark.parametrize("p,d,k", [(2, 144, 8), (3, 40, 70), (1, 130, 3)])
def test_wide_bank_layout_reads_back_bit_for_bit(p, d, k):
    """`mp_circ_wide_operands`: `mp_circ_wide_units` units, each the
    transpose of its operand's 64 x 64 block, walked by hand: bfwd's
    (piece, chunk) units, lcoef's, the combine's P + 1 slabs piece by
    piece, binv's."""
    ckb = trc.random_mp_bank(p, d, k, CPU, n_dead=1)
    ops = mk.mp_circ_wide_operands(ckb)
    units = _decoded(ops)
    assert units.shape == (mk.mp_circ_wide_units(d, k, p), 64, 64)
    assert torch.equal(units, mk.mp_circ_wide_tc_units(ckb))
    feat = d * (3 * p + p * (p - 1))
    npd, nf, kp = -(-2 * d // 64), -(-feat // 64), -(-k // 64)

    def block(w, c, j):
        b = torch.zeros(64, 64)
        part = w[64 * c:64 * c + 64, 64 * j:64 * j + 64]
        b[:part.shape[0], :part.shape[1]] = part
        return b.T

    want = [block(ckb.bfwd, c, j) for j in range(npd) for c in range(npd)]
    want += [block(ckb.lcoef, c, j) for j in range(kp) for c in range(nf)]
    want += [block(ckb.comb[s], c, j) for j in range(npd)
             for s in range(p + 1) for c in range(kp)]
    want += [block(ckb.binv, c, j) for j in range(npd) for c in range(npd)]
    assert torch.equal(units, torch.stack(want))
    assert all(x.dtype == torch.bfloat16 and x.is_contiguous() for x in ops)


def test_wide_feature_rows_read_back_bit_for_bit():
    """`mp_circ_wide_rows`: a row's features [u_1..u_P | |u_p|^2 | v_pq]
    (pairs p < q in row-major order) in 64-row tiles of 64-deep chunks,
    padding zero."""
    p, d, n = 3, 20, 150
    u = trc.random_rows(n, 2 * p * d, CPU)
    a = mk.mp_circ_wide_rows(u, p)
    u4 = u.reshape(n, p, d, 2)
    ur, ui = u4[..., 0], u4[..., 1]
    want = [u, (ur * ur + ui * ui).reshape(n, -1)]
    for pi, qi in ((0, 1), (0, 2), (1, 2)):
        want.append(torch.stack([ur[:, pi] * ur[:, qi] + ui[:, pi] * ui[:, qi],
                                 ur[:, pi] * ui[:, qi] - ui[:, pi] * ur[:, qi]],
                                -1).reshape(n, 2 * d))
    want = torch.cat(want, 1)
    w = want.shape[1]
    assert w == d * (3 * p + p * (p - 1))
    assert a.shape == (3, 4, -(-w // 64), 64, 64)
    x = _decoded(a.reshape(3, -1, 64, 64)).reshape(4, -(-w // 64), 64, 64)
    x = x.permute(0, 2, 1, 3).reshape(256, -1)
    assert torch.equal(x[:n, :w], want)
    assert not x[n:].any() and not x[:, w:].any()


def test_wide_layout_transforms_are_rounded_once():
    """Past D = 128 the layout's DFT matrices are the complex128 ones
    rounded once to float32; up to D = 128 JAX's complex64 construction
    stays, which `test_mp_circ_kernel_bank_holds_the_jax_operands` pins."""
    for d, dtype in ((144, torch.complex128), (128, torch.complex64)):
        _, tb = _banks(2, d=d, k=2, n_dead=0)
        ckb = mk.mp_circ_kernel_bank(tb)
        f = linalg.unitary_dft(d, dtype)
        assert torch.equal(ckb.bfwd, mk._cplx_interleaved(f.T).float())
        assert torch.equal(ckb.binv, mk._cplx_interleaved(f.conj()).float())


@pytest.mark.parametrize("p,d,k,t,alpha", [
    (1, 5, 3, 2, 0.5), (2, 16, 130, 1, 1.0), (4, 3, 5, 4, 0.25)])
def test_wide_plain_version_keeps_fp32_accuracy(p, d, k, t, alpha):
    """`mp_circ_wide_reference`, six bf16 products of three-plane splits a
    chunk in compensated sums, within 1e-6 of the scale of the function in
    float64 on the same layout, as the float32 plain version is."""
    ckb = trc.random_mp_bank(p, d, k, CPU, n_dead=1, t_coh=t)
    x2 = trc.random_rows(40 * t, 2 * p * d, CPU)
    exact = mk._mp_reference(x2.double(), mk.MpCircKernelBank(
        *(v.double() for v in ckb)), t, alpha, 8192)
    got = mk.mp_circ_wide_reference(x2, ckb, t, alpha)
    assert float((got.double() - exact).abs().max() / exact.abs().max()) \
        < 1e-6


# (P, D, K): D one past the template at two and three pilots, K past one
# launch of the template
JAX_SHAPES = [(2, D, 8), (3, D, 8), (2, 16, 200)]


@pytest.mark.parametrize("p,d,k", JAX_SHAPES)
def test_plain_wide_k10_matches_jax_interpret_kernel(p, d, k):
    """The wide K10's plain version, flat and coherent at T = 4, alpha 1
    and 0.25, through its wrappers, and the entries (which take the wide
    form at K = 200 and the factorised kernel at D = 144 = 12 x 12,
    `mp_circ_route`: each the plain version of its route), against JAX's
    interpret-mode `estimate_fused_circulant_mp[_coherent]`."""
    jb, tb = _banks(p, d=d, k=k, n_dead=1)
    assert not mk.mp_circ_narrow(d, k, p)
    r = _obs(64, p * d)
    x2 = mk._x2(torch.as_tensor(r))
    ckb = mk.mp_circ_kernel_bank(tb)
    before = tkn.launch_counts()
    got = mk.estimate_fused_circulant_mp(tb, torch.as_tensor(r))
    wide = mk._hc(mk.mp_circ_estimate_wide(x2, ckb), torch.complex64)
    assert tkn.launch_counts() == before            # the CPU launches nothing
    assert torch.equal(wide, mk._hc(mk.mp_circ_wide_reference(x2, ckb),
                                    torch.complex64))
    plain = (mk.mp_circ_fact_reference if mk.mp_circ_route(d, k, p) == "fact"
             else mk.mp_circ_wide_reference)
    assert torch.equal(got, mk._hc(plain(x2, ckb), torch.complex64))
    want = pk.estimate_fused_circulant_mp(jb, jnp.asarray(r), interpret=True)
    _close(got, want, 2e-4)
    _close(wide, want, 2e-4)
    rb = r.reshape(16, 4, p * d)
    for alpha in (1.0, 0.25):
        got = mk.estimate_fused_circulant_mp_coherent(tb, torch.as_tensor(rb),
                                                      alpha)
        assert got.shape == (16, 4, d)
        want = pk.estimate_fused_circulant_mp_coherent(
            jb, jnp.asarray(rb), alpha=alpha, interpret=True)
        _close(got, want, 2e-4)
        wide = mk.mp_circ_estimate_coherent_wide(
            x2, mk.mp_circ_kernel_bank(tb, None, 4, alpha), 4, alpha)
        _close(mk._hc(wide, torch.complex64).reshape(16, 4, d), want, 2e-4)


@pytest.mark.parametrize("p,d,k", JAX_SHAPES)
def test_stages_at_wide_shapes_give_the_fft_answers(p, d, k):
    """`stages.estimate_circulant[_coherent]` ('auto' and 'kernel') take
    the kernel route at these shapes (the wide plain version here) and
    answer as the `torch.fft` pipeline does; the layouts and the wide
    operands are cached once."""
    _, tb = _banks(p, d=d, k=k, n_dead=2, seed=3)
    assert tst._circ_method("auto", "all", tb) == "kernel"
    assert tst._circ_method("auto", "all", tb, 4) == "kernel"
    r = torch.as_tensor(_obs(48, p * d, seed=4))
    cache = {}
    got = tst.estimate_circulant(tb, r, method="kernel", cache=cache)
    assert torch.equal(got, tst.estimate_circulant(tb, r, cache=cache))
    _close(got, tsb.estimate_circulant_mp(tb, r), 2e-4)
    rb = r.reshape(12, 4, p * d)
    _close(tst.estimate_circulant_coherent(tb, rb, alpha=0.5, cache=cache),
           tsb.estimate_circulant_mp_coherent(tb, rb, "all", 2048, 0.5),
           2e-4)
    assert set(cache) == {(None, 1, 1.0), (None, 4, 0.5)}
    ops = mk.lowered_tc(tb, cache, None, wide=True)
    assert mk.lowered_tc(tb, cache, None, wide=True) is ops
    assert ("mp_circ_wide_operands", None) in cache
    assert ops.hi.shape[0] == mk.mp_circ_wide_units(d, k, p)


def test_mp_kernel_bench_runs_every_leg_on_cpu(capsys):
    """The port of the JAX `tools/mp_kernel_bench.py` through the plain
    versions at D = 16 with K = 130 (the wide form): both legs, the kernel
    route within 2e-4 of the scale of the dense bank and of the
    `torch.fft` pipeline at both alphas, every route timed."""
    from quantized_channel_estimation_torch.tools import mp_kernel_bench
    rec = mp_kernel_bench.main(["--d", "16", "--k", "130", "--batch", "128"],
                               device="cpu")
    assert rec["wide_form"] == {"flat": True, "coherent": True}
    flat, coh = rec["legs"]["flat"], rec["legs"]["coherent"]
    assert flat["kernel_vs_dense"]["max_rel"] < 2e-4
    for alpha in (1.0, 0.25):
        assert coh[f"kernel_vs_fft alpha={alpha}"]["max_rel"] < 2e-4
    for leg in (flat, coh):
        for label, route in leg.items():
            if "ms" in route:
                assert route["ms"] > 0 and route["launches"] == {}, label
    assert flat["mp kernel"]["bound_dft_ms"] > flat["mp kernel"]["bound_ms"]
    assert '"legs"' in capsys.readouterr().out


def test_mp_circ_bound_counts_the_transforms_as_ffts():
    """`mp_circ_bound`: P forward transforms and the inverse as FFTs (5 D
    log2 D fp32 operations a row each), the logit and combine as six bf16
    products, the rows and the bank's logit and combine operands read
    once; `bound_dft_ms` adds the dense (2D, 2D) products the kernels
    compute, PERF.md's K10 formula (0.716 ms of products at D = 256, K =
    32, P = 2, 65536 rows)."""
    from quantized_channel_estimation_torch.utils import profiling
    n, d, k, p = 65536, 256, 32, 2
    b = mk.mp_circ_bound(n, d, k, p)
    feat = d * 8
    assert b["tc_flops"] == 6.0 * 2 * n * (feat * k + 3 * k * 2 * d)
    assert b["fp32_flops"] == pytest.approx(
        n * (3 * 5.0 * d * 8 + 11 * p * d + 6 * d + 5 * k))
    assert b["bytes"] == 4.0 * (n * 3 * 2 * d + feat * k + k + 3 * k * 2 * d)
    dense = 6.0 * 2 * n * (p * (2 * d) ** 2 + feat * k + 3 * k * 2 * d
                           + (2 * d) ** 2)
    assert dense / profiling.PEAK_BF16_FLOPS * 1e3 == pytest.approx(0.7166,
                                                                    abs=1e-4)
    assert b["bound_dft_ms"] == pytest.approx(
        dense / profiling.PEAK_BF16_FLOPS * 1e3
        + n * (11 * p * d + 6 * d + 5 * k) / profiling.PEAK_FP32_FLOPS * 1e3)
    assert 0.12 < b["bound_ms"] < 0.13 and b["bound_by"] == "operations"
    c = mk.mp_circ_bound(n, d, k, p, 4)
    assert c["fp32_flops"] == pytest.approx(b["fp32_flops"] + 3.0 * n * k)


def test_tc_repeat_check_wide_mpcirc_mode_on_cpu():
    """Mode 'wide_mpcirc' of `tc_repeat_check` through the plain versions:
    every launch held, none off; its card shapes cover D past the
    template's, K past one logit slice, P past its shared memory, many
    pilots at D = 1 and the pool at T = 3, 4 and 16."""
    shapes = ((2, 3, 130, 40, 1, 1, 1.0), (3, 5, 4, 4 * 9, 0, 4, 0.5))
    got = trc.repeat_check(CPU, repeats=2, poison=False,
                           modes=("wide_mpcirc",), wide_mpcirc_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for label, rec in got["kernel"].items():
        assert label.endswith(" K10 wide")
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    shapes = trc.WIDE_MPCIRC_SHAPES
    assert any(d > mk.CIRC_MAX_D for _, d, *_ in shapes)
    assert any(k > 128 for _, _, k, *_ in shapes)
    assert any(p > 1 and mk.mp_circ_tile_rows(d, k, p) == 0
               for p, d, k, *_ in shapes)
    assert {3, 4, 16} <= {s[5] for s in shapes}
    assert all(mk.mp_circ_wide_eligible(d, k, p, t)
               for p, d, k, _, _, t, _ in shapes)
