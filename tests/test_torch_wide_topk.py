"""Top-k selection on wide banks on the CPU: the shape rule of the top-k
kernels K4 / K5 (`kernels.topk_mode_eligible`) against the JAX package's
Pallas rule, the port's top-k entries against JAX's split-K chunked top-k
kernel in interpret mode at widths past 256, ties and dead components at a
wide shape, the layouts the wide form reads (the picks bucketed by
component, the bank's value slabs), and the int modes over an in-process
mesh.

The wide kernels themselves run only on the card (`tests/test_torch_cuda.py`:
their plain versions are `grouped_estimate_topk_reference` and
`grouped_estimate_topk_stats_reference`, which every wrapper computes
here).

Tolerance: estimates within 2e-4 of JAX's (absolute, as
`tests/test_pallas_kernels.py` holds JAX's chunked top-k), on the rows
whose k-th and (k+1)-th logits lie further apart than max(1e-3, 1e-5
|logit|): float32 sums over a 288-deep contraction in another order may
order closer logits differently (at least 90% of the rows are compared).
"""
import itertools

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
from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import gmm_estimator as tge
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.parallel import mesh as pm
from quantized_channel_estimation_torch.tools import tc_repeat_check

torch.set_num_threads(2)

K = 8


def test_rule_is_a_superset_of_the_jax_pallas_set():
    """Every (D, K, M, k) over K 2-128, D 16-1152 in steps of 16, P 1-6
    pilots (M = P D) and k 1-8 for which JAX's `topk_mode_eligible`
    (`pallas_kernels.py:764-780`: the whole bank within 13 MiB, or chunks
    of at least four components within the 8-10 MiB budget) runs a Pallas
    kernel is admitted by the port's rule; among them the widths past 256,
    which the wide form takes: D = 256 at one pilot, 2M = 2D = 512, and
    three to five pilots at D = 64, 2M = 384 to 640."""
    admitted, wide = 0, set()
    for k, d, p, k_sel in itertools.product(
            (2, 3, 4, 8, 16, 32, 64, 128), range(16, 1153, 16), range(1, 7),
            range(1, 9)):
        m = p * d
        if not jpk.topk_mode_eligible(d, k, m, k_sel):
            continue
        admitted += 1
        assert tkn.topk_mode_eligible(d, k, m, k_sel), (d, k, m, k_sel)
        if tkn.wide_form(2 * m, 2 * d):
            wide.add((p, d))
    assert admitted > 1000
    assert {(1, 256), (3, 64), (4, 64), (5, 64)} <= wide
    assert not tkn.topk_mode_eligible(64, 8, 1025, 1)       # 2M = 2050


def _banks(seed, d, p, k=K, snr=10.0):
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


def _keep(bank, r, k_sel):
    """Rows not near a tie at the k-th place (the module's tolerance)."""
    lg = tkn.component_logits(tkn._r2(r), tkn.kernel_bank_block(bank))
    return ~tc_repeat_check.topk_near_ties(lg, k_sel, 1e-3, 1e-5).numpy()


@pytest.mark.parametrize("d,p", [
    (48, 3),      # 2M = 288, 2D = 96: three pilots
    (144, 1),     # 2M = 2D = 288: one pilot, 2D past 256
])
@pytest.mark.parametrize("k_sel", [1, 3])
def test_entries_match_jax_chunked_topk(d, p, k_sel):
    """`kernels.estimate_fused_topk`, `estimate_fused_topk_stats` on two
    component shards merged with `merge_topk`, and `stages.estimate_auto`
    against JAX's `estimate_fused_topk` forced onto its split-K chunked
    path (`_topk_chunked`, a `vmem_budget` of five components, as
    `tests/test_pallas_kernels.py:330-341`) in interpret mode: one
    interpret call a case, 256 rows."""
    bj, bt = _banks(0, d, p)
    m = p * d
    assert tkn.topk_mode_eligible(d, K, m, k_sel)
    assert tkn.wide_form(2 * m, 2 * d)
    r = _obs(1, 256, m)
    per_k = 4 * (2 * m) * (2 * m + 2 * d)
    want = np.asarray(jpk.estimate_fused_topk(bj, jnp.asarray(r), k_sel,
                                              interpret=True,
                                              vmem_budget=5 * per_k))
    rt = torch.as_tensor(r)
    keep = _keep(bt, rt, k_sel)
    assert keep.sum() >= 0.9 * r.shape[0]
    shards = [tge.PreparedBank(*(x[sl] for x in bt))
              for sl in (slice(0, K // 2), slice(K // 2, K))]
    merged = tkn._h(tkn.merge_topk(*zip(*(
        tkn.estimate_fused_topk_stats(s, rt, k_sel) for s in shards)),
        k_sel), d, rt.dtype)
    for got in (tkn.estimate_fused_topk(bt, rt, k_sel), merged,
                tst.estimate_auto(bt, rt, k_sel)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=0,
                                   atol=2e-4)


def _tie_bank(two_m, two_d, logw, seed=0):
    """A float32 kernel bank of len(logw) components at these widths whose
    precision parts and means are one (so the logits differ by the
    log-weights alone, ties exact), their filter parts and biases
    differing."""
    g = torch.Generator().manual_seed(seed)
    k = len(logw)
    p = torch.randn(two_m, two_m, generator=g) / two_m ** 0.5
    pw = torch.stack([torch.cat([p, torch.randn(two_m, two_d, generator=g)],
                                1) for _ in range(k)])
    mu = torch.randn(two_m, generator=g).expand(k, two_m).contiguous()
    return tkn.KernelBankBlock(pw, mu, torch.randn(k, two_d, generator=g),
                               torch.tensor(logw, dtype=torch.float32))


@pytest.mark.parametrize("k_sel,logw,chosen", [
    (1, [-1e30, 0.0, 0.0, -50.0, -1e30], [1]),   # 1 and 2 tie for first
    (2, [50.0, -1e30, 0.0, 0.0, -1e30], [0, 2]),  # 2 and 3 tie for second
    (4, [-1e30, 3.0, -1e30, 1.0, -1e30, 2.0], [1, 5, 3, 0]),  # 3 dead, k = 4
])
def test_wide_ties_keep_the_lower_index_and_dead_never_win(k_sel, logw,
                                                           chosen):
    """At 2M = 2D = 288, K4 (through the wrapper that launches the wide
    form on a card), the wide K5 on two shards merged with `merge_topk`,
    and the wide wrappers' plain versions pick the lower index of an exact
    tie and never a dead component (log-weight -1e30) over a live one; a
    dead one fills a slot only past the live count, with a weight of
    zero."""
    kb = _tie_bank(288, 288, logw)
    r2 = torch.randn(30, 288, generator=torch.Generator().manual_seed(1))
    lg = tkn.component_logits(r2, kb)
    z = (r2 @ kb.pw[:, :, 288:]).transpose(0, 1) + kb.b[None]
    w = torch.exp(lg[:, chosen] - lg[:, chosen[:1]])
    want = (w[..., None] * z[:, chosen]).sum(1) / w.sum(1, keepdim=True)
    half = len(logw) // 2
    shards = [tkn.KernelBankBlock(*(x[sl] for x in kb))
              for sl in (slice(0, half), slice(half, len(logw)))]
    l_s, z_s = tkn.grouped_estimate_topk_stats_wide(r2, kb, k_sel)
    assert torch.equal(l_s, lg[:, chosen])
    for got in (tkn.grouped_estimate_topk(r2, kb, k_sel),
                tkn.grouped_estimate_topk_wide(r2, kb, k_sel),
                tkn.merge_topk(*zip(*(tkn.grouped_estimate_topk_stats(
                    r2, s, k_sel) for s in shards)), k_sel)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k_comp,k_sel,case", [
    (300, 7, 3, "random"),        # ragged buckets
    (500, 4, 1, "one"),           # every row picks component 0
    (129, 6, 2, "none"),          # components 2 and 5 picked by no row
    (40, 3, 5, "shard"),          # a shard of 3 < k: two empty slots a row
])
def test_wide_topk_buckets_read_back(n, k_comp, k_sel, case):
    """The layout the wide value pass reads (`wide_topk_buckets`, the
    plain version of the card's count, scan and scatter): every picked
    (row, slot) entry once, at a position of a block of its component,
    each component's entries from a block of its own, -1 elsewhere, at
    most `wide_topk_pairs` blocks; and the gathered rows' bf16 planes
    (`wide_row_planes` of the picked rows, as the card's split lays them
    out) read back to r2's planes bit for bit."""
    g = torch.Generator().manual_seed(n)
    idx = torch.stack([torch.randperm(k_comp, generator=g)[:k_sel]
                       for _ in range(n)]) if case != "shard" else None
    if case == "one":
        idx = torch.zeros((n, 1), dtype=torch.long)
    elif case == "none":
        idx = torch.where((idx == 2) | (idx == 5), 0, idx)
        idx[:, 1] = torch.where(idx[:, 1] == idx[:, 0], 1, idx[:, 1])
    elif case == "shard":
        idx = torch.cat([torch.stack([torch.randperm(k_comp, generator=g)
                                      for _ in range(n)]),
                         torch.full((n, k_sel - k_comp), -1)], 1)
    idx = idx.to(torch.int32)
    pair_comp, perm = tkn.wide_topk_buckets(idx, k_comp)
    pairs = tkn.wide_topk_pairs(n, k_comp, k_sel)
    assert pair_comp.shape == (pairs,) and perm.shape == (128 * pairs,)
    flat = idx.reshape(-1).long()
    used = perm >= 0
    assert torch.equal(perm[used].sort().values.long(),
                       torch.nonzero(flat >= 0)[:, 0])
    block = torch.arange(128 * pairs) // 128
    assert torch.equal(flat[perm[used].long()], pair_comp[block[used]].long())
    counts = torch.bincount(flat[flat >= 0], minlength=k_comp)
    blocks = (counts + 127) // 128
    assert int((pair_comp >= 0).sum()) == int(blocks.sum()) <= pairs
    assert not (pair_comp[int(blocks.sum()):] >= 0).any()
    assert torch.equal(torch.bincount(pair_comp[pair_comp >= 0].long(),
                                      minlength=k_comp), blocks)
    # the gathered rows' planes: row perm // k of r2 at each position
    r2 = torch.randn(n, 272, generator=g)
    rows = torch.zeros(128 * pairs, 272)
    rows[used] = r2[perm[used].long() // k_sel]
    a = tkn.wide_row_planes(rows)
    assert a.shape == (3, 2 * pairs, 5, 64, 64)
    unit = (torch.arange(64)[:, None] % 8) ^ torch.arange(8)[None, :]
    back = torch.gather(a.reshape(3, 2 * pairs, 5, 64, 8, 8), 4,
                        unit[None, None, None, :, :, None].expand(
                            3, 2 * pairs, 5, 64, 8, 8))
    back = back.reshape(3, 2 * pairs, 5, 64, 64).permute(0, 1, 3, 2, 4)
    back = back.reshape(3, 128 * pairs, 320)
    for q, plane in enumerate(tkn.split_planes3(r2)):
        assert torch.equal(
            back[q, used, :272].view(torch.int16),
            plane[perm[used].long() // k_sel].view(torch.int16))
    assert not back[:, ~used].view(torch.int16).any()
    assert not back[..., 272:].view(torch.int16).any()


def test_wide_value_slabs_read_back_bit_for_bit():
    """The B slabs the wide value pass reads for component j (pieces
    ceil(2M / 64) onwards of `tc_slab`, at 2M = 288, 2D = 300: five logit
    pieces, five value pieces, the last one 44 columns wide) read back
    through the 128-byte swizzle to W_j's bf16 planes bit for bit, padding
    zero."""
    two_m, two_d, k = 288, 300, 3
    g = torch.Generator().manual_seed(4)
    pw = torch.randn(k, two_m, two_m + two_d, generator=g)
    mp, dp = 5, 5
    col = torch.arange(64)[:, None]
    row = torch.arange(64)[None, :]
    pos = col * 64 + ((row // 8) ^ (col % 8)) * 8 + row % 8   # (n, kk)
    for plane in tkn.split_planes3(pw):
        slab = tkn.tc_slab(plane, two_m)
        for j in range(k):
            vals = slab[j, mp:].reshape(dp, mp, 64 * 64)[..., pos]
            full = vals.permute(1, 3, 0, 2).reshape(64 * mp, 64 * dp)
            bits = full.view(torch.int16)
            assert torch.equal(bits[:two_m, :two_d],
                               plane[j, :, two_m:].view(torch.int16))
            assert not bits[two_m:].any() and not bits[:, two_d:].any()


def test_int_modes_over_an_in_process_mesh():
    """`parallel.mesh.estimate_sharded` on a `LocalMesh` of 2 x 2 shards
    (the plain K5 on each component shard, merged with `merge_topk`) and
    the service over that mesh in an int mode equal the one-device
    `stages.estimate_auto` and service at 2M = 288 (three pilots); a
    float mode on the mesh takes the einsum estimator on the whole bank;
    blocks in an int mode too."""
    _, bt = _banks(2, 16, 3)
    r = torch.as_tensor(_obs(3, 64, 48))
    mesh = pm.make_local_mesh(2, 2)
    for mode in (1, 3):
        want = tst.estimate_auto(bt, r, mode)
        torch.testing.assert_close(pm.estimate_sharded(mesh, bt, r, mode),
                                   want, rtol=0, atol=1e-5)
    torch.testing.assert_close(pm.estimate_sharded(mesh, bt, r, 0.9),
                               tge.estimate(bt, r, 0.9), rtol=0, atol=1e-6)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((K, 16, 16)) + 1j * rng.standard_normal(
        (K, 16, 16))
    covs = (a @ np.conj(np.swapaxes(a, -1, -2)) / 16 + np.eye(16)).astype(
        np.complex64)
    params = tg.GmmParams(np.full(K, 1.0 / K, np.float32),
                          np.zeros((K, 16), np.complex64), covs,
                          np.asarray(jl.robust_precision_cholesky(
                              jnp.asarray(covs))).astype(np.complex64))
    a_mat = np.asarray(jp.pilot_matrix(16, 3, 2)).astype(np.complex64)
    req = _obs(6, 24, 48)
    outs = []
    for m in (None, mesh):
        svc = serving.EstimationService(params, a_mat, 2, mode=2, mesh=m,
                                        max_delay_ms=1.0, device="cpu")
        try:
            assert svc.use_kernels
            outs.append((svc.submit(req, 5.0, timeout=30.0),
                         svc.submit(req.reshape(6, 4, 48), 5.0,
                                    timeout=30.0)))
        finally:
            svc.close(timeout=30.0)
    for one, sharded in zip(*outs):
        np.testing.assert_allclose(sharded, one, rtol=0, atol=1e-5)
