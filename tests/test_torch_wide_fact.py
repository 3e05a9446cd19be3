"""The factored kernels K11-K13 on wide banks on the CPU: the shape rule
(`fact_kernels.fact_kernel_eligible`) against the JAX package's Pallas
rule, the wide form's launch rows, its bank layout read back bit for bit,
its plain version `fact_wide_reference` (which the wide wrappers compute
here) against JAX's interpret-mode K11, K12 and K13 at D = 144 and at
D = 96, M = 72, and against the function in float64, the stages' dispatch,
the service and a 1 x 2 in-process mesh at those shapes, the port of
`tools/mfa_bank_bench.py`, `fact_bound` and the wide mode of
`tools.tc_repeat_check`.

The wide kernels themselves run only on the card
(`tests/test_torch_cuda.py`, `test_fact_wide_*`).

Tolerances, with their reasons:
- 2e-4 of the output scale against JAX's interpret-mode kernels and the
  `torch.matmul` pipeline: both sides are float32 and expand the
  quadratic logit, whose diagonal and low-rank terms cancel at 10 dB, with
  the products summed in another order (measured here 3.5e-6 to 4.0e-5;
  against float64 the wide plain version 2.4e-6 to 2.8e-6, JAX's kernel
  2.7e-6 to 1.3e-5, the pipeline 9.1e-6 to 3.8e-5);
- bit for bit for the layout: hi + lo + lo2 of a float32 value is the
  value exactly, and the swizzle is a permutation;
- 1e-6 of the scale for the wide plain version against the function in
  float64 on the same layout: six bf16 products of three-plane splits a
  64-deep chunk in compensated sums keep float32's accuracy (measured
  0.9e-7 to 3.2e-7, the float32 plain version 1.4e-7 to 9.6e-7).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as pk
from quantized_channel_estimation_tpu.models import mfa as jmfa
from quantized_channel_estimation_tpu.models import mfa_bank as jmb
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.estimators import circ_kernels as tck
from quantized_channel_estimation_torch.estimators import fact_kernels as tfk
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import mfa as tmfa
from quantized_channel_estimation_torch.models import mfa_bank as tmb
from quantized_channel_estimation_torch.parallel import mesh as pmesh
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc

torch.set_num_threads(2)

X0 = 0.7 - 0.2j
TOL = 2e-4
CPU = torch.device("cpu")
# (D, M, K): D past the template's 128, and M past its 64
WIDE = [(144, 4, 6), (96, 72, 4)]


def _params(d, m, k, n_dead=0, seed=0):
    """Seeded MFA parameters (numpy): loadings 0.5 CN(0, 1), psis in
    [0.1, 1.1), means 0.3 CN(0, 1), weights uniform in [0.1, 1.1) (the
    first n_dead at 1e-9)."""
    rng = np.random.default_rng(seed)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    lam = (0.5 * cr(k, d, m)).astype(np.complex64)
    psis = (0.1 + rng.uniform(size=(k, d))).astype(np.float32)
    means = (0.3 * cr(k, d)).astype(np.complex64)
    w = (rng.uniform(size=k) + 0.1).astype(np.float32)
    w[:n_dead] = 1e-9
    return w / w.sum(), means, lam, psis


def _banks(d, m, k, n_dead=1, seed=0):
    """The factored bank of seeded MFA parameters at 10 dB, 2 bits, pilot
    x0 I, prepared by the JAX package, and its port copy."""
    w, means, lam, psis = _params(d, m, k, n_dead, seed)
    params = jmfa.MfaParams(*(jnp.asarray(x) for x in (w, means, lam, psis)))
    jbank = jmb.prepare_bank_factored(params, 10.0, X0, 2,
                                      jq.design_quantizer(10.0, 2))
    return jbank, tmb.bank_from_numpy(jbank)


def _obs(n, d, seed=1):
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.5, 0.5, 1.5]) * 0.6
    return (rng.choice(levels, (n, d))
            + 1j * rng.choice(levels, (n, d))).astype(np.complex64)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = (want.numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


def test_rule_is_a_superset_of_the_jax_pallas_set():
    """Every (D, K, M, T <= 16) of the grid for which JAX runs its Pallas
    K11-K13 (`_fact_kernel_eligible`, T <= 16 for the coherent form) is
    admitted; past the template's rule the wide form takes it. The JAX
    rule's reach (D 10334 at K = M = 1, 5551 at M = 16, 2233 at M = 64; M
    2475 at D = 64; K 39 / 10 at D = 256, M = 16 / 64, 19 at D = 512, 2 at
    D = 2048, M = 32) and the wide form's edges."""
    ds = (1, 2, 16, 63, 64, 65, 128, 129, 144, 256, 317, 512, 2048, 2233,
          5389, 5551, 10334, 10335)
    ks = (1, 2, 4, 10, 11, 19, 20, 32, 39, 40, 64, 110, 128, 129, 300, 799,
          822)
    ms = (1, 4, 16, 32, 64, 65, 72, 96, 324, 325, 2216, 2475, 2476)
    admitted, wide = 0, 0
    for d, k, m, t in itertools.product(ds, ks, ms, (1, 4, 16)):
        if not pk._fact_kernel_eligible(d, k, m, t):
            continue
        admitted += 1
        assert tfk.fact_kernel_eligible(d, k, m, t), (d, k, m, t)
        wide += not tfk.fact_narrow(d, k, m, t)
    assert admitted > 1500 and wide > 400
    jr = pk._fact_kernel_eligible
    for yes, no in (((10334, 1, 1), (10335, 1, 1)),
                    ((5389, 1, 1, 16), (5390, 1, 1, 16)),
                    ((5551, 1, 16), (5552, 1, 16)),
                    ((2233, 1, 64), (2234, 1, 64)),
                    ((64, 1, 2475), (64, 1, 2476)),
                    ((64, 1, 2216, 16), (64, 1, 2217, 16)),
                    ((128, 4, 324), (128, 4, 325)),
                    ((256, 39, 16), (256, 40, 16)),
                    ((256, 10, 64), (256, 11, 64)),
                    ((512, 19, 16), (512, 20, 16)),
                    ((2048, 2, 32), (2048, 3, 32))):
        assert jr(*yes) and not jr(*no), (yes, no)
        assert tfk.fact_kernel_eligible(*yes)
        assert not tfk.fact_narrow(*yes)
    # the template keeps exactly its shapes; the wide form takes the rest
    assert tfk.fact_narrow(128, 1000, 64, 64)
    assert not tfk.fact_narrow(129, 8, 4) and not tfk.fact_narrow(64, 8, 65)
    assert tfk.fact_wide_eligible(29120, 1, 1, 16)
    assert not tfk.fact_kernel_eligible(29121, 1, 1, 16)
    assert tfk.fact_wide_eligible(64, 1, 13104, 16)
    assert not tfk.fact_kernel_eligible(64, 1, 13105, 16)
    assert tfk.fact_kernel_eligible(200, 8, 70, 64)
    assert not tfk.fact_kernel_eligible(200, 8, 70, 65)
    assert not tfk.fact_kernel_eligible(64, 8, 16, 65)


def test_launch_rows_keep_whole_blocks_within_the_scratch():
    """Rows of one wide launch: every row up to the budget, past it a
    multiple of 128 T whose scratch (`fact_wide_row_bytes`) fits
    `kernels.WIDE_SCRATCH`."""
    assert tfk.fact_wide_launch_rows(32768, 256, 32, 16) == 32768
    for d, k, m, t in ((129, 1, 4, 1), (10334, 1, 1, 16), (64, 1, 2475, 16),
                       (256, 39, 16, 4), (96, 3, 72, 64)):
        rows = tfk.fact_wide_launch_rows(10 ** 8, d, k, m, t)
        per_row = tfk.fact_wide_row_bytes(d, k, m)
        assert per_row == (384 * max(-(-2 * d // 64), -(-3 * d // 64),
                                     -(-4 * k * m // 64))
                           + 16 * k * m + 4 * k + 4)
        assert rows % (128 * t) == 0 and rows >= 128 * t
        assert rows * per_row <= tkn.WIDE_SCRATCH


def _decoded(ops):
    """The float32 units behind the operands: unswizzled, hi + lo + lo2."""
    hi, lo, lo2 = (tkn._sw128(x).to(torch.float32) for x in ops)
    return (hi + lo) + lo2


@pytest.mark.parametrize("d,m,k", [(144, 4, 5), (40, 70, 2), (20, 3, 130)])
def test_wide_bank_layout_reads_back_bit_for_bit(d, m, k):
    """`fact_wide_operands`: `fact_wide_units` units, each the transpose of
    its operand's 64 x 64 block, walked by hand: fwd (2D, K 4M) piece by
    piece (components consecutive, each [beta | gamma]), the logit operand
    (3D, K) against [x | |x|^2], comb (K 4M, 2D)."""
    fkb = trc.random_fact_bank(d, m, k, CPU, n_dead=1)
    ops = tfk.fact_wide_operands(fkb)
    units = _decoded(ops)
    assert units.shape == (tfk.fact_wide_units(d, k, m), 64, 64)
    assert torch.equal(units, tfk.fact_wide_tc_units(fkb))
    lc = tfk.fact_wide_logit_operand(fkb)
    assert lc.shape == (3 * d, k)
    for b in (0, d - 1):
        assert torch.equal(lc[2 * b], fkb.lcoef[:, b])
        assert torch.equal(lc[2 * b + 1], fkb.lcoef[:, d + b])
        assert torch.equal(lc[2 * d + b], fkb.lcoef[:, 2 * d + b])
    fwd = torch.cat(list(fkb.fwd), 1)                 # (2D, K 4M)
    comb = fkb.comb.reshape(-1, 2 * d)                # (K 4M, 2D)

    def block(w, c, j):
        b = torch.zeros(64, 64)
        part = w[64 * c:64 * c + 64, 64 * j:64 * j + 64]
        b[:part.shape[0], :part.shape[1]] = part
        return b.T

    def walk(w):
        return [block(w, c, j) for j in range(-(-w.shape[1] // 64))
                for c in range(-(-w.shape[0] // 64))]

    assert torch.equal(units, torch.stack(walk(fwd) + walk(lc) + walk(comb)))
    assert all(x.dtype == torch.bfloat16 and x.is_contiguous() for x in ops)


@pytest.mark.parametrize("d,m,k,t,alpha,stats", [
    (20, 3, 5, 1, 1.0, False), (70, 17, 3, 4, 0.25, False),
    (33, 6, 130, 1, 1.0, True), (10, 2, 4, 3, 1.0, False)])
def test_wide_plain_version_keeps_fp32_accuracy(d, m, k, t, alpha, stats):
    """`fact_wide_reference` within 1e-6 of the scale of the function in
    float64 on the same layout (each of m, den and the accumulator for
    K13), as the float32 plain version is; past K = 128 one logit slice
    is not all."""
    fkb = trc.random_fact_bank(d, m, k, CPU, n_dead=1, t_coh=t)
    x2 = trc.random_rows(40 * t, 2 * d, CPU)
    exact = tfk._fact_reference(x2.double(), tfk.FactKernelBank(
        *(v.double() for v in fkb)), t, alpha, stats, 8192)
    got = tfk.fact_wide_reference(x2, fkb, t, alpha, stats)
    for g, e in zip(got, exact) if stats else ((got, exact),):
        assert float((g.double() - e).abs().max() / e.abs().max()) < 1e-6


@pytest.mark.parametrize("d,m,k", WIDE)
def test_plain_wide_k11_k12_match_jax_interpret_kernels(d, m, k):
    """The wide K11's plain version through the entry (which takes the wide
    form here) against JAX's interpret-mode `estimate_fused_factored`; at
    D = 144 the coherent form at T = 4, alpha 1 and 0.25, against
    `estimate_fused_factored_coherent`."""
    jbank, tbank = _banks(d, m, k)
    assert pk._fact_kernel_eligible(d, k, m, 4)
    assert not tfk.fact_narrow(d, k, m)
    r = _obs(256, d)
    before = tkn.launch_counts()
    got = tfk.estimate_fused_factored(tbank, torch.as_tensor(r))
    assert tkn.launch_counts() == before            # the CPU launches nothing
    assert torch.equal(got, tck._hc(tfk.fact_wide_reference(
        tck._x2(torch.as_tensor(r)), tfk.fact_kernel_bank(tbank)),
        torch.complex64))
    _close(got, pk.estimate_fused_factored(jbank, jnp.asarray(r), tile_n=64,
                                           interpret=True))
    if d != 144:
        return
    rb = r.reshape(64, 4, d)
    for alpha in (1.0, 0.25):
        got = tfk.estimate_fused_factored_coherent(tbank, torch.as_tensor(rb),
                                                   alpha)
        assert got.shape == (64, 4, d)
        _close(got, pk.estimate_fused_factored_coherent(
            jbank, jnp.asarray(rb), alpha=alpha, interpret=True))


def test_plain_wide_k13_matches_jax_and_merges_with_pipeline_states():
    """At D = 96, M = 72 one component shard through the plain wide K13
    and through JAX's interpret-mode stats kernel: m, den and the
    accumulator agree (the wide form's m is the row's offset plus its
    largest offset logit, the same maximum), and the merge
    (`circ_kernels.merge_stats`) with the other shard's pipeline state
    reproduces the wide K11 over the whole bank."""
    d, m, k = 96, 72, 4
    jbank, tbank = _banks(d, m, k)
    r = _obs(200, d, seed=2)
    rt = torch.as_tensor(r)
    s1 = tmb.FactoredBank(*(x[:k // 2] for x in tbank))
    s2 = tmb.FactoredBank(*(x[k // 2:] for x in tbank))
    got = tfk.estimate_fused_factored_stats(s1, rt)
    assert got[0].shape == got[1].shape == (200,)
    assert got[2].shape == (200, d)
    want = pk.estimate_fused_factored_stats(
        jmb.FactoredBank(*(x[:k // 2] for x in jbank)), jnp.asarray(r),
        interpret=True)
    for g, w in zip(got, want):
        _close(g, w)
    _, den, acc = tck.merge_stats(*zip(got, tmb.estimate_factored_stats(
        s2, rt)))
    _close(acc / den[:, None], tfk.estimate_fused_factored(tbank, rt))


@pytest.mark.parametrize("d,m,k", WIDE)
def test_stages_service_and_mesh_at_wide_shapes(d, m, k):
    """`stages.estimate_factored[_coherent]` ('auto' and 'kernel') take the
    kernel route at these shapes (the wide plain version here) and answer
    as the `torch.matmul` pipeline does; the layouts and the wide operands
    are cached once. The factored service and a 1 x 2 in-process mesh
    (K13 a shard, merged) answer as the entries do."""
    _, tbank = _banks(d, m, k, n_dead=1, seed=3)
    assert stages._fact_method("auto", "all", tbank) == "kernel"
    assert stages._fact_method("auto", "all", tbank, 4) == "kernel"
    r = torch.as_tensor(_obs(48, d, seed=4))
    cache = {}
    got = stages.estimate_factored(tbank, r, method="kernel", cache=cache)
    assert torch.equal(got, stages.estimate_factored(tbank, r, cache=cache))
    _close(got, tmb.estimate_factored(tbank, r))
    rb = r.reshape(12, 4, d)
    _close(stages.estimate_factored_coherent(tbank, rb, alpha=0.5,
                                             cache=cache),
           tmb.estimate_factored_coherent(tbank, rb, "all", 1024, 0.5))
    ops = tfk.lowered_tc(tbank, cache)
    assert tfk.lowered_tc(tbank, cache) is ops
    assert set(cache) == {(1, 1.0), (4, 0.5), "fact_wide_operands"}
    assert ops.hi.shape[0] == tfk.fact_wide_units(d, k, m)
    _close(pmesh.estimate_sharded_factored(pmesh.make_local_mesh(1, 2),
                                           tbank, r), got)
    if d != 144:
        return
    w, means, lam, psis = _params(d, m, k, 1, seed=3)
    params = tmfa.MfaParams(*(torch.as_tensor(x)
                              for x in (w, means, lam, psis)))
    svc = serving.EstimationService.from_mfa(params, X0, 2, device="cpu",
                                             use_kernels=True)
    try:
        h = svc.submit(r.numpy(), 10.0, timeout=60)
    finally:
        svc.close()
    _close(torch.as_tensor(np.asarray(h)), got)


def test_mfa_bank_bench_runs_a_wide_leg_on_cpu(capsys):
    """The port of the JAX `tools/mfa_bank_bench.py` through the plain
    versions, its d512 leg cut to D = 144, K = 4, M = 8 (the wide form):
    the kernel route's NMSE within 1e-4 of the pipeline's and the dense
    bank's, its estimates within 2e-4 of the scale of the pipeline's,
    every route timed, nothing launched."""
    from quantized_channel_estimation_torch.tools import mfa_bank_bench
    rec = mfa_bank_bench.main(
        ["d512", "--d", "144", "--k", "4", "--m", "8", "--n-train", "600",
         "--n-val", "100", "--batch", "128", "--max-iter", "3"],
        device="cpu")
    leg = rec["legs"]["d512"]
    assert leg["kernel_eligible"] and leg["wide_form"]
    assert set(leg["nmse"]) == {"factored pipeline", "factored kernel",
                                "dense"}
    assert max(leg["nmse_rel_delta"].values()) < 1e-4
    assert leg["kernel_vs_pipeline"]["max_rel"] < TOL
    assert set(leg["routes"]) == {"factored pipeline", "factored kernel",
                                  "dense einsum"}
    for label, route in leg["routes"].items():
        assert route["ms"] > 0 and route["launches"] == {}, label
    assert leg["routes"]["factored kernel"]["bound_by"] in ("operations",
                                                           "bytes")
    assert '"legs"' in capsys.readouterr().out


def test_fact_bound_counts_both_products_and_the_epilogue():
    """`fact_bound`: the two products as six bf16 products of 2 N K (2D 4M
    + 4M 2D), 2 N K (3D + 2M + 6D) fp32 epilogue operations (3 N K more
    for the pool), the rows and the output once: 0.907 ms at D = 256, K =
    32, M = 16, 32768 rows and 1.741 ms at D = 512, K = 16, M = 32, both
    bound by operations."""
    from quantized_channel_estimation_torch.utils import profiling
    n, d, k, m = 32768, 256, 32, 16
    b = tfk.fact_bound(n, d, k, m)
    assert b["tc_flops"] == 6.0 * 2 * n * k * (2 * (2 * d) * (4 * m))
    assert b["fp32_flops"] == 2.0 * n * k * (3 * d + 2 * m + 6 * d)
    assert b["bound_ms"] == pytest.approx(
        (b["tc_flops"] / profiling.PEAK_BF16_FLOPS
         + b["fp32_flops"] / profiling.PEAK_FP32_FLOPS) * 1e3)
    assert b["bound_ms"] == pytest.approx(0.907, abs=1e-3)
    assert b["bound_by"] == "operations"
    assert tfk.fact_bound(n, 512, 16, 32)["bound_ms"] == pytest.approx(
        1.741, abs=1e-3)
    c = tfk.fact_bound(n, d, k, m, 4)
    assert c["fp32_flops"] == b["fp32_flops"] + 3.0 * n * k
    s = tfk.fact_bound(n, d, k, m, stats=True)
    assert s["bytes"] == b["bytes"] + 8.0 * n


def test_tc_repeat_check_wide_fact_mode_on_cpu():
    """Mode 'wide_fact' of `tc_repeat_check` through the plain versions:
    every launch held, none off; its card shapes cover D past the
    template's, M past it, K past one logit slice and the pool at T = 3, 4
    and 16, K11, K12 and K13."""
    shapes = ((130, 3, 2, 40, 1, 1, 1.0, "K11"),
              (10, 66, 2, 4 * 9, 0, 4, 0.5, "K12"),
              (8, 2, 131, 33, 1, 1, 1.0, "K13"))
    got = trc.repeat_check(CPU, repeats=2, poison=False,
                           modes=("wide_fact",), wide_fact_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for label, rec in got["kernel"].items():
        assert label.endswith(" wide")
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    shapes = trc.WIDE_FACT_SHAPES
    assert any(d > tfk.FACT_MAX_D for d, *_ in shapes)
    assert any(m > tfk.FACT_MAX_M for _, m, *_ in shapes)
    assert any(k > 128 for _, _, k, *_ in shapes)
    assert {3, 4, 16} <= {s[5] for s in shapes}
    assert {"K11", "K12", "K13"} == {s[7] for s in shapes}
    assert all(not tfk.fact_narrow(d, k, m, t)
               and tfk.fact_wide_eligible(d, k, m, t)
               for d, m, k, _, _, t, _, _ in shapes)
