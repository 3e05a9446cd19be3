"""The large-array dense path on the CPU: the shape rule of the dense
kernels K1-K3 (`kernels.fused_kernel_eligible`) against the JAX package's
Pallas rule, the port's estimation entries against JAX's split-K chunked
kernel K2 in interpret mode at widths past 256, the wide form's row and
bank layouts, and the port of `tools/scale_bench_large_d.py`.

The wide kernels themselves run only on the card (`tests/test_torch_cuda.py`:
their plain versions are `grouped_estimate_reference` and its coherent and
stats siblings, which every wrapper computes here).

Tolerances: estimates and the state's den and acc within 1e-4 of their
scale (max |port - JAX| / max |JAX|): float32 products over a 288- to
512-deep contraction summed in another order; den and acc are scaled by
exp(-m), whose float32 rounding at logits of ~400 moves them by ~1e-4 of
themselves (their quotient, the estimate, not). The bank's kernel fields
and the state's m within 1e-5.
"""
import itertools
import json

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
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.tools import scale_bench_large_d

torch.set_num_threads(2)

MIB = 1024 * 1024


def _jax_runs_pallas(m, d, k, t):
    """Does the JAX package hand an 'all'-mode request at observation dim
    M, channel dim D, K components and T-snapshot blocks (T = 1: flat) to a
    Pallas kernel? Restated from
    quantized_channel_estimation_tpu/estimators/pallas_kernels.py:
    `estimate_fused` (:1026-1066): the whole-bank kernel while K per_k <=
    13 MiB (`vmem_budget`, :1028, :1047), else the split-K chunks while
    k_chunk = (budget // per_k) // 4 * 4 >= 4 with budget 10 MiB for 2M <=
    256 and 8 MiB above (:1055-1061); `estimate_fused_stats` (:982-1010):
    the chunks under the same rule; `estimate_fused_coherent` (:1144-1187)
    with `_coherent_kernel_eligible` (:1113-1123): 1 < T <= 16 and budget
    // per_k >= 4, whole bank or chunks; T = 1 is `estimate_fused`."""
    per_k = 4 * (2 * m) * (2 * m + 2 * d)
    budget = (10 if 2 * m <= 256 else 8) * MIB
    chunked = (budget // per_k) // 4 * 4 >= 4
    if t == 1:
        return k * per_k <= 13 * MIB or chunked
    return 1 < t <= 16 and budget // per_k >= 4


def test_rule_is_a_superset_of_the_jax_pallas_set():
    """(a) Every (M, D, K, T) over K in {4, ..., 128}, D = 16 ... 512 in
    steps of 16, P = 1 ... 6 pilots (M = P D) and T = 1 ... 16 that JAX
    sends to a Pallas kernel is admitted by the port's rule (the flat
    entries by `fused_kernel_eligible`, T > 1 by `coherent_kernel_eligible`
    too); among them the widths past the stream's 256 (D = 256 at one
    pilot, D = 128 at two, D = 64 at three to five pilots), which the wide
    form takes."""
    admitted, wide = 0, set()
    for k, d, p in itertools.product((4, 8, 16, 32, 64, 128),
                                     range(16, 513, 16), range(1, 7)):
        m = p * d
        # the rules read the filters' shape (K, D, M) alone
        zero = torch.zeros(())
        bank = tge.PreparedBank(zero, zero, zero, zero.expand(k, d, m), zero)
        for t in range(1, 17):
            if not _jax_runs_pallas(m, d, k, t):
                continue
            admitted += 1
            assert tkn.fused_kernel_eligible(d, m), (m, d, k, t)
            assert t == 1 or tkn.coherent_kernel_eligible(bank, t), (m, d, k,
                                                                     t)
            if tkn.wide_form(2 * m, 2 * d):
                wide.add((p, d))
    assert admitted > 1000
    assert {(1, 256), (2, 128), (3, 64), (4, 64), (5, 64)} <= wide


@pytest.mark.parametrize("d,m,k_sel,ok", [
    (128, 1024, 1, True),    # 2M = 2048: the wide K4 / K5's edge
    (1024, 1024, 4, True),   # and any D
    (128, 1025, 1, False),   # 2M = 2050
    (8, 1025, 4, False),
])
def test_topk_keeps_its_width(d, m, k_sel, ok):
    """K4 / K5 take the widths of K1-K3 (`topk_width_eligible` is
    `fused_kernel_eligible`: 2M <= 2048, any D), in the wide form past 2M,
    2D <= 256; the edge's two sides."""
    assert tkn.topk_width_eligible(d, m) is ok
    assert tkn.topk_mode_eligible(d, 8, m, k_sel) is ok
    assert tkn.fused_kernel_eligible(d, m) is ok
    assert tkn.wide_form(2 * m, 2 * d)


@pytest.mark.parametrize("two_m,two_d,wide", [
    (256, 256, False), (258, 16, True), (16, 258, True), (2048, 2, True),
])
def test_wide_form_edge(two_m, two_d, wide):
    """The stream keeps 2M, 2D <= 256 (today's instantiations); one past
    either width the wide form takes it."""
    assert tkn.wide_form(two_m, two_d) is wide
    assert tkn.fused_kernel_eligible(two_d // 2, two_m // 2)


def _banks(seed, d, p, k, snr=10.0):
    """The same float64 GMM (one component below the dead floor, non-zero
    means) prepared by both packages at 2 bits under P pilots, in
    complex64 / float32."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, d, d)) + 1j * rng.standard_normal((k, d, d))
    covs = a @ np.conj(np.swapaxes(a, -1, -2)) / d + 0.2 * np.eye(d)
    covs = covs * d / np.real(np.trace(covs, axis1=-2, axis2=-1))[:, None,
                                                                   None]
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    w = np.full(k, 1.0)
    w[0] = 1e-6
    w /= w.sum()
    means = 0.3 * (rng.standard_normal((k, d))
                   + 1j * rng.standard_normal((k, d)))
    a_mat = np.asarray(jp.pilot_matrix(d, p, 2, dtype=jnp.complex128))
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


def _obs(seed, n, m):
    """2-bit-like observations (n, M): +-1/1.4 per part."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    return ((np.sign(r.real) + 1j * np.sign(r.imag)) / 1.4).astype(
        np.complex64)


def _close(got, want, tol):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


@pytest.mark.parametrize("d,p,n", [
    (48, 3, 256),     # 2M = 288, 2D = 96: three pilots
    (256, 1, 128),    # 2M = 2D = 512: D = 256 at one pilot
])
def test_entries_match_jax_chunked_k2(d, p, n):
    """(b) `stages.estimate_auto`, `kernels.estimate_fused_stats` and the
    coherent entry at T = 4 (alpha 0.5) against JAX's split-K chunked
    kernel K2 in interpret mode (a `vmem_budget` below the bank forces the
    chunks; `estimate_fused_stats` always takes them): three interpret
    calls a case, the port's wide plain versions on the same banks and
    observations."""
    k = 4
    bj, bt = _banks(0, d, p, k)
    kj, kt = jpk.kernel_bank_block(bj), tkn.kernel_bank_block(bt)
    for got, want in ((kt.pw, kj.pw), (kt.mu, np.asarray(kj.mu)[:, 0]),
                      (kt.b, np.asarray(kj.b)[:, 0]), (kt.logw, kj.logw)):
        _close(got, want, 1e-5)
    assert tkn.fused_kernel_eligible(d, p * d)
    assert tkn.wide_form(2 * p * d, 2 * d)
    r = _obs(1, n, p * d)
    small = 1024
    rt = torch.as_tensor(r)
    _close(tst.estimate_auto(bt, rt, "all"),
           jpk.estimate_fused(bj, jnp.asarray(r), interpret=True,
                              vmem_budget=small), 1e-4)
    got = tkn.estimate_fused_stats(bt, rt)
    want = jpk.estimate_fused_stats(bj, jnp.asarray(r), interpret=True)
    for g_x, w_x, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        _close(g_x, w_x, tol)
    rb = r.reshape(n // 4, 4, p * d)
    _close(tkn.estimate_fused_coherent(bt, torch.as_tensor(rb), 0.5),
           jpk.estimate_fused_coherent(bj, jnp.asarray(rb), interpret=True,
                                       vmem_budget=small, alpha=0.5), 1e-4)


@pytest.mark.parametrize("two_m,two_d", [(512, 512), (640, 128), (400, 400)])
def test_wide_b_layout_reads_back_bit_for_bit(two_m, two_d):
    """(c) The bank's B layout at wide widths (`tc_slab`, as the wide form
    streams it chunk by chunk) read back through the 128-byte swizzle is
    each bf16 plane bit for bit with zero padding; the row planes of the
    wide form (`wide_row_planes`) read back to r2's planes the same way,
    rows of a 64-row tile consecutive (T = 3: 63 rows a tile)."""
    k = 2
    g = torch.Generator().manual_seed(3)
    pw = torch.randn(k, two_m, two_m + two_d, generator=g)
    mp, dp = -(-two_m // 64), -(-two_d // 64)
    col = torch.arange(64)[:, None]
    row = torch.arange(64)[None, :]
    pos = col * 64 + ((row // 8) ^ (col % 8)) * 8 + row % 8   # (n, kk)
    cols = tkn._tc_columns(two_m, two_d)
    for plane in tkn.split_planes3(pw):
        slab = tkn.tc_slab(plane, two_m)
        assert slab.shape == (k, mp + dp, mp, 64, 64)
        logical = slab.reshape(k, mp + dp, mp, 64 * 64)[..., pos]
        full = logical.permute(0, 2, 4, 1, 3).reshape(k, 64 * mp,
                                                      64 * (mp + dp))
        bits = full.view(torch.int16)
        assert torch.equal(bits[:, :two_m][:, :, cols >= 0],
                           plane.view(torch.int16))
        assert not bits[:, two_m:].any() and not bits[:, :, cols < 0].any()
    n, t = 200, 3
    r2 = torch.randn(n - n % t, two_m, generator=g)
    a = tkn.wide_row_planes(r2, t)
    tiles = tkn.wide_row_tiles(r2.shape[0], t)
    assert a.shape == (3, tiles, mp, 64, 64) and tiles % 2 == 0
    # row rr's 16-byte unit c of a chunk sits at unit c ^ (rr % 8)
    unit = (torch.arange(64)[:, None] % 8) ^ torch.arange(8)[None, :]
    back = torch.gather(a.reshape(3, tiles, mp, 64, 8, 8), 4,
                        unit[None, None, None, :, :, None].expand(
                            3, tiles, mp, 64, 8, 8))
    back = back.reshape(3, tiles, mp, 64, 64).permute(0, 1, 3, 2, 4).reshape(
        3, tiles, 64, mp * 64)
    rows = back[:, :, :63].reshape(3, tiles * 63, mp * 64)
    for q, plane in enumerate(tkn.split_planes3(r2)):
        assert torch.equal(rows[q, :r2.shape[0], :two_m].view(torch.int16),
                           plane.view(torch.int16))
    assert not back[:, :, 63:].view(torch.int16).any()
    assert not rows[:, r2.shape[0]:].view(torch.int16).any()
    assert not back[..., two_m:].view(torch.int16).any()


def test_scale_bench_on_cpu(capsys):
    """(d) The port of `tools/scale_bench_large_d.py` at D = 16, K = 4 on
    the CPU (the Toeplitz fit in two segments): its one JSON line holds
    every field, the route through the stream's K1 at these widths, the
    kernel estimate on the einsum's, and genie < GMM < LS."""
    rec = scale_bench_large_d.main(16, 4, "toeplitz", 2, n_train=2000,
                                   n_val=200, batch=256, reps=2, max_iter=6,
                                   device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    for key in ("d", "k", "cov_type", "segments", "datagen_s", "fit_s",
                "n_iter", "lower_bound", "nmse_gmm", "nmse_genie", "nmse_ls",
                "gmm_over_genie", "route", "rate_kernel", "rate_einsum",
                "kernel_ms", "einsum_ms", "kernel_vs_einsum", "launches",
                "device"):
        assert key in rec, key
    assert rec["device"] == "cpu" and rec["route"] == "stream"
    assert rec["n_iter"] == 6 and rec["launches"] == {}
    assert rec["nmse_genie"] < rec["nmse_gmm"] < rec["nmse_ls"]
    assert rec["kernel_vs_einsum"] < 1e-4
