"""K1's six-product bf16 route on the CPU: the three-plane split, the third
plane's B layout, the plain version of the six-product arithmetic against
K1's plain version and JAX's f32 kernel, the K3 tile rule, the bank's
tensor-core operands beside its layouts, and the tools that drive the route.

The wgmma kernels themselves run only on the card (`tests/test_torch_cuda.py`);
here every wrapper computes its plain version.

Tolerances (max |port - reference| / max |reference|): the six products
drop terms of order 2^-24 of each product, float32's own rounding, so the
six-product plain version stays within 1e-6 of K1's plain float32 version
(pooled over T = 4 rows, within 1e-5, and as close to the float64
evaluation as the float32 plain version); against JAX's interpret-mode f32
kernel (the same float32 products summed in another order) 1e-5, as
`tests/test_torch_variant_kernels.py` holds K14b.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.estimators import pallas_kernels as jpk
from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_estimator as jge
from quantized_channel_estimation_tpu.ops import linalg as jl
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.estimators import (
    variant_kernels as tvk)
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.tools import batch_sweep as tbs
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc

torch.set_num_threads(2)

D, K = 16, 8


def _banks(seed, snr, n_dead=1):
    """The same float64 GMM (the first n_dead components below the dead
    floor, non-zero means) prepared by both packages at 2 bits, one pilot,
    in complex64 / float32."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, D, D)) + 1j * rng.standard_normal((K, D, D))
    covs = a @ np.conj(np.swapaxes(a, -1, -2)) / D + 0.2 * np.eye(D)
    covs = covs * D / np.real(np.trace(covs, axis1=-2, axis2=-1))[:, None,
                                                                   None]
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    w = np.full(K, 1.0)
    w[:n_dead] = 1e-6
    w /= w.sum()
    means = 0.3 * (rng.standard_normal((K, D))
                   + 1j * rng.standard_normal((K, D)))
    a_mat = np.asarray(jp.pilot_matrix(D, 1, 2, dtype=jnp.complex128))
    qj = jq.design_quantizer(snr, 2)
    qt = tq.ScalarQuantizer(*(torch.as_tensor(np.array(x)) for x in qj))
    bj = jge.prepare_bank(jg.GmmParams(*(jnp.asarray(x) for x in (
        w, means, covs, prec))), snr, jnp.asarray(a_mat), 2, qj)
    bt = tge.prepare_bank(tg.GmmParams(*(torch.as_tensor(x) for x in (
        w, means, covs, prec))), snr, torch.as_tensor(a_mat), 2, qt)
    bj32 = jge.PreparedBank(*(x.astype(jnp.complex64)
                              if jnp.iscomplexobj(x) else
                              x.astype(jnp.float32) for x in bj))
    bt32 = tge.PreparedBank(*(x.to(torch.complex64) if x.is_complex()
                              else x.to(torch.float32) for x in bt))
    return bj32, bt32


def _obs(seed, n):
    """2-bit-like observations (n, D): +-1/1.4 per part."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, D)) + 1j * rng.standard_normal((n, D))
    return ((np.sign(r.real) + 1j * np.sign(r.imag)) / 1.4).astype(
        np.complex64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("spread", [0.0, 6.0])
def test_three_plane_split_is_exact(spread):
    """hi + lo + lo2 = x exactly for float32 x (pw-like values and values
    over 2 x `spread` decades), each plane rounded to nearest even, hi and
    lo bit for bit the two-plane split's; the plain version splits r2 the
    same way."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 24, 40))
         * 10.0 ** rng.uniform(-spread, spread, (3, 24, 40))).astype(
             np.float32)
    xt = torch.as_tensor(x)
    hi, lo, lo2 = tkn.split_planes3(xt)
    assert hi.dtype == lo.dtype == lo2.dtype == torch.bfloat16
    total = hi.double() + lo.double() + lo2.double()
    assert torch.equal(total, xt.double())
    for got, want in zip((hi, lo), tkn.split_planes(xt)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # each plane is its residual rounded: lo2 = bf16((x - hi) - lo)
    rest = (xt - hi.float()) - lo.float()
    assert torch.equal(lo2.float(), rest.to(torch.bfloat16).float())
    assert float(lo2.float().abs().max()) > 0
    # r2's planes in the plain products: with the bank's hi plane the
    # identity, the products that read it (lo2.hi, lo.hi, hi.hi) give x back
    eye, zero = torch.eye(40), torch.zeros(40, 40)
    assert torch.equal(tvk.tc_products(xt[0], [eye, zero, zero], 6), xt[0])


def test_third_plane_slab_reads_back_bit_for_bit():
    """The third plane's B layout (`tc_slab` of lo2), read back through the
    128-byte swizzle, is lo2 bit for bit with zero padding; `tc_operands`
    lays out all three planes and the vectors."""
    two_m, two_d, k = 40, 100, 2
    g = torch.Generator().manual_seed(3)
    pw = torch.randn(k, two_m, two_m + two_d, generator=g)
    mp, dp = -(-two_m // 64), -(-two_d // 64)
    col = torch.arange(64)[:, None]
    row = torch.arange(64)[None, :]
    pos = col * 64 + ((row // 8) ^ (col % 8)) * 8 + row % 8   # (n, kk)
    cols = tkn._tc_columns(two_m, two_d)
    lo2 = tkn.split_planes3(pw)[2]
    slab = tkn.tc_slab(lo2, two_m)
    assert slab.shape == (k, mp + dp, mp, 64, 64) and slab.is_contiguous()
    logical = slab.reshape(k, mp + dp, mp, 64 * 64)[..., pos]
    full = logical.permute(0, 2, 4, 1, 3).reshape(k, 64 * mp, 64 * (mp + dp))
    bits = full.view(torch.int16)
    assert torch.equal(bits[:, :two_m][:, :, cols >= 0], lo2.view(torch.int16))
    assert not bits[:, two_m:].any() and not bits[:, :, cols < 0].any()
    kb = tkn.KernelBankBlock(pw, torch.randn(k, two_m, generator=g),
                             torch.randn(k, two_d, generator=g),
                             torch.randn(k, generator=g))
    ops = tkn.tc_operands(kb)
    for got, plane in zip((ops.hi, ops.lo, ops.lo2), tkn.split_planes3(pw)):
        assert torch.equal(got, tkn.tc_slab(plane, two_m))
    assert torch.equal(ops.vec, tkn.tc_vectors(kb))


@pytest.mark.parametrize("snr,t,alpha", [(10.0, 1, 1.0), (20.0, 1, 1.0),
                                         (10.0, 4, 1.0), (20.0, 4, 0.5)])
def test_six_product_plain_matches_k1_plain_and_jax(snr, t, alpha):
    """The plain six-product arithmetic (`grouped_tc_estimate_reference`
    at 6 passes) on the same float32 bank layout and rows as K1's plain
    version (a dead component) within 1e-6 of the scale; at T = 4 (K3's,
    block-major rows) a pooled logit sums four rows' and both float32
    versions sit ~2e-6 from the float64 evaluation, so there the
    six-product version is held within 1e-5 of K3's plain one and as close
    to the float64 evaluation as twice the plain version plus 1e-6. Both
    within 1e-5 of JAX's f32 kernel in interpret mode
    (`estimate_block_grouped`, `estimate_fused_coherent` with T-major
    tiles)."""
    bj, bt = _banks(seed=int(snr) + t, snr=snr)
    n_blocks = 64
    r = _obs(seed=5, n=n_blocks * t)
    kb = tkn.kernel_bank_block(bt, t, alpha)
    r2 = tkn._r2(torch.as_tensor(r))
    six = tvk.grouped_tc_estimate_reference(r2, kb, tkn.split_planes3(kb.pw),
                                            6, t_coh=t, coh_alpha=alpha)
    if t == 1:
        plain = tkn.grouped_estimate_reference(r2, kb)
        want = np.asarray(jpk.estimate_block_grouped(bj, jnp.asarray(r), 64,
                                                     2, True))
    else:
        plain = tkn.grouped_estimate_coherent_reference(r2, kb, t, alpha)
        want = np.asarray(jpk.estimate_fused_coherent(
            bj, jnp.asarray(r.reshape(n_blocks, t, D)), interpret=True,
            alpha=alpha)).reshape(-1, D)
    if t == 1:
        assert _rel(six, plain) <= 1e-6
    else:
        assert _rel(six, plain) <= 1e-5
        exact = tkn.grouped_estimate_coherent_reference(
            r2.double(), tkn.KernelBankBlock(*(x.double() for x in kb)), t,
            alpha)
        scale = float(exact.abs().max())
        err_six = float((six.double() - exact).abs().max()) / scale
        err_plain = float((plain.double() - exact).abs().max()) / scale
        assert err_six <= 2 * err_plain + 1e-6, (err_six, err_plain)
    for h2 in (six, plain):
        got = (h2[:, :D] + 1j * h2[:, D:]).numpy()
        assert _rel(got, want) <= 1e-5


def test_tile_rule_takes_every_t_the_fp32_stream_took():
    """`tile_rows` and `coherent_kernel_eligible` accept every T the fp32
    stream's rule did (64 while 2M, 2D <= 128, else 32) at every width, and
    refuse T = 1 and T past the 64-row tile."""
    for m in (1, 8, 64, 65, 128):
        for d in (1, 8, 64, 65, 128):
            old = 64 if max(2 * m, 2 * d) <= 128 else 32
            assert tkn.tile_rows(2 * m, 2 * d) >= old
            bank = tge.PreparedBank(
                torch.zeros(2), torch.zeros(2, m, dtype=torch.complex64),
                torch.eye(m, dtype=torch.complex64).repeat(2, 1, 1),
                torch.zeros(2, d, m, dtype=torch.complex64),
                torch.zeros(2, d, dtype=torch.complex64))
            assert all(tkn.coherent_kernel_eligible(bank, t)
                       for t in range(2, old + 1))
            assert not tkn.coherent_kernel_eligible(bank, 1)
            assert not tkn.coherent_kernel_eligible(bank, 65)


def test_tc_operands_are_kept_once_beside_every_layout():
    """`lowered_tc` lays the bank's planes and operands out once per cache,
    shared by every (T, alpha) layout (they differ in logw only); an entry
    on CPU rows lays out nothing (the plain versions read kb alone)."""
    _, bt = _banks(seed=1, snr=10.0)
    cache = {}
    r = torch.as_tensor(_obs(seed=2, n=8))
    tkn.estimate_fused(bt, r, cache)
    tkn.estimate_fused_coherent(bt, r.reshape(2, 4, D), 0.5, cache)
    assert "tc_operands" not in cache and "bf16_planes" not in cache
    kb, planes, ops = tkn.lowered_tc(bt, cache)
    assert cache["tc_operands"] is ops and cache["bf16_planes"] is planes
    assert tkn.lowered_tc(bt, cache)[2] is ops
    kb4 = tkn.lowered(bt, cache, 4, 0.5)
    for got, want in zip(ops, tkn.tc_operands(kb4)):
        assert torch.equal(got, want)
    assert not torch.equal(kb4.logw, kb.logw)


def test_wrappers_take_operands_and_check_them():
    """On CPU rows each wrapper of the stream computes its plain version
    with or without operands; `check_tc_operands` refuses operands of
    another shape, dtype or without the third plane."""
    from quantized_channel_estimation_torch.tools import (
        kernel_floor_probe as tfp)
    g = torch.Generator().manual_seed(4)
    kb = tkn.KernelBankBlock(0.2 * torch.randn(3, 24, 24 + 16, generator=g),
                             torch.randn(3, 24, generator=g),
                             torch.randn(3, 16, generator=g),
                             torch.randn(3, generator=g))
    r2 = torch.randn(12, 24, generator=g)
    ops = tkn.tc_operands(kb)
    assert torch.equal(tkn.grouped_estimate(r2, kb, ops),
                       tkn.grouped_estimate_reference(r2, kb))
    assert torch.equal(tkn.grouped_estimate_coherent(r2, kb, 3, 0.5, ops),
                       tkn.grouped_estimate_coherent_reference(r2, kb, 3,
                                                               0.5))
    for got, want in zip(tkn.grouped_estimate_stats(r2, kb, ops),
                         tkn.grouped_estimate_stats_reference(r2, kb)):
        assert torch.equal(got, want)
    for got, want in zip(
            tkn.grouped_estimate_coherent_stats(r2, kb, 4, 1.0, ops),
            tkn.grouped_estimate_coherent_stats_reference(r2, kb, 4, 1.0)):
        assert torch.equal(got, want)
    assert torch.equal(tfp.floor_probe(r2, kb, "full", ops),
                       tfp.floor_probe_reference(r2, kb, "full"))
    cpu = torch.device("cpu")
    tkn.check_tc_operands("k", ops, kb, cpu)
    for bad in (ops._replace(lo2=None), ops._replace(hi=ops.hi.float()),
                ops._replace(vec=ops.vec[:, :-1].contiguous()),
                tkn.tc_operands(tkn.KernelBankBlock(*(x[:2] for x in kb)))):
        with pytest.raises(ValueError, match="tc_operands"):
            tkn.check_tc_operands("k", bad, kb, cpu)


def test_tc_repeat_check_f32_mode_on_cpu():
    """Mode 'f32' of `tc_repeat_check` (K1 and K3) through the plain
    versions: every launch held, none off, one record a shape; the card's
    shapes cover K1's two block sizes and the one-stage ring and K3's
    pooling routes."""
    shapes = ((40, 24, 3, 70, 1, 1, 1.0), (24, 100, 2, 4 * 9, 0, 4, 0.5),
              (40, 40, 2, 3 * 11, 0, 3, 1.0))
    got = trc.repeat_check(torch.device("cpu"), repeats=2, poison=False,
                           modes=("f32",), f32_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == len(shapes)
    for rec in got["kernel"].values():
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    ts = {s[5] for s in trc.F32_SHAPES}
    assert {1, 4, 16, 64} <= ts and any(t & (t - 1) for t in ts)
    assert any(s[0] > 128 for s in trc.F32_SHAPES)
    assert 150 * len(trc.F32_SHAPES) >= 1000     # chip_smoke's launches


def test_batch_sweep_on_cpu(capsys):
    """The small-batch timing tool (K1, K3, K14a, K11-K13 on a factored
    bank, K10 flat and at T = 4 on a 2-pilot circulant bank, and K6-K9 on
    a one-pilot circulant bank) at a tiny size through the plain versions
    (host clock), one JSON line."""
    out = tbs.main(["--device", "cpu", "--n-ant", "8", "--components", "4",
                    "--rows", "32", "64", "--repeats", "1", "--latent", "2"])
    assert set(out["ms"]) == {f"{k} N={n}" for k in ("K1", "K3 T=4",
                                                     "K3 T=16", "K14a",
                                                     "K11", "K12 T=4", "K13",
                                                     "K10 P=2", "K10 P=2 T=4",
                                                     "K6", "K7 T=4", "K8",
                                                     "K9 T=4")
                              for n in (32, 64)}
    assert all(v > 0 for v in out["ms"].values())
    assert capsys.readouterr().out.strip().startswith("{")
