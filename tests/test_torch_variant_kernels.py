"""Parity of the plain versions of K1's variants with the JAX package, and
the kernel-measurement tools on the CPU:

- K14a, the Karatsuba-layout estimator: `kernel_bank` against JAX's, the
  plain `reference_estimate_packed` against JAX's interpret-mode
  `estimate_packed`, the entry `estimate` at a ragged N with dead
  components against JAX's `estimate` and the einsum estimator, and the
  kernel's host side: its units (`karatsuba_operands`) read back through
  the swizzle to the bf16 planes and the six fp32 planes bit for bit, and
  the plain version of its six-product arithmetic
  (`karatsuba_tc_reference`) against the complex products and JAX's K14a;
- K14b, the GEMM-precision modes: the bf16 hi / lo bank planes bitwise
  equal to JAX's, each plain mode against JAX's interpret-mode
  `estimate_block_grouped(mode=)` and against f32 within JAX's bounds, the
  modes' refusals, and the kernel's host-side layouts: `tc_slab` read back
  through its swizzle to the bf16 planes bit for bit (ragged widths, zero
  padding) and `tc_vectors`, laid out once per bank cache (`lowered_tc`);
- K15, the floor probe: each plain body against the JAX tool's
  `BODIES[name]` called on JAX arrays in its GROUP = 4 layout, `full`
  equal to the plain K1;
- each tool's `main` at a tiny size on the CPU, and its refusal to run
  without a card unless `--device cpu` is given; `tc_repeat_check`'s
  repeated launches through the plain versions.

Tolerances (max |port - JAX| / max |JAX|): 1e-5 where both sides compute
the same float32 products summed in another order (K14b's bf16 products
are exact in float32, so the modes compare like f32); 1e-5 for the bank
fields (JAX lowers the float64 bank in float64, the port the complex64 one);
the Karatsuba kernel against complex products 1e-5 (three real products
round differently); its six bf16 products per real product against the
complex float32 products 1e-6 at these widths (the difference is the
three-product combine's rounding), against JAX's K14a 1e-5. Precision
modes against f32: JAX's own bounds, relative norms 3e-2 (bf16, split2)
and 1e-4 (split3).
"""
import importlib.util
from pathlib import Path

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
from quantized_channel_estimation_torch.tools import kernel_bench as tkb
from quantized_channel_estimation_torch.tools import kernel_floor_probe as tfp
from quantized_channel_estimation_torch.tools import kernel_split_bench as tks
from quantized_channel_estimation_torch.tools import tc_repeat_check as trc

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
D, K = 8, 8


def _banks(rng, n_dead=0, d=D, k=K, snr=10.0):
    """The same float64 GMM of k components (the first n_dead below the
    dead floor) prepared by both packages at 2 bits, one pilot: JAX's bank
    in complex64 / float32, and the port's likewise."""
    a = rng.standard_normal((k, d, d)) + 1j * rng.standard_normal((k, d, d))
    covs = a @ np.conj(np.swapaxes(a, -1, -2)) / d + 0.2 * np.eye(d)
    covs = covs * d / np.real(np.trace(covs, axis1=-2, axis2=-1))[:, None,
                                                                   None]
    prec = np.asarray(jl.robust_precision_cholesky(jnp.asarray(covs)))
    w = np.full(k, 1.0)
    w[:n_dead] = 1e-6
    w /= w.sum()
    means = 0.3 * (rng.standard_normal((k, d))
                   + 1j * rng.standard_normal((k, d)))
    a_mat = np.asarray(jp.pilot_matrix(d, 1, 2, dtype=jnp.complex128))
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


def _obs(rng, n, d=D):
    r = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    return ((np.sign(r.real) + 1j * np.sign(r.imag)) / 1.4).astype(
        np.complex64)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _rel_norm(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------- K14a

@pytest.mark.parametrize("n_dead", [0, 2])
def test_kernel_bank_matches_jax(rng, n_dead):
    bj, bt = _banks(rng, n_dead)
    kj = jpk.kernel_bank(bj)
    kt = tvk.kernel_bank(bt)
    for name in tvk.KernelBank._fields:
        want = np.asarray(getattr(kj, name))
        if name in ("mu_re", "mu_im", "b_re", "b_im"):   # JAX: (K, 1, X)
            want = want[:, 0]
        got = getattr(kt, name)
        assert got.dtype == torch.float32 and got.is_contiguous(), name
        _close(got, want)
    assert int((kt.logw == -1e30).sum()) == n_dead


def test_plain_k14a_matches_jax_kernel(rng):
    """The plain K14a on JAX's own Karatsuba layout against
    `estimate_packed(interpret=True)` (three real products a complex one)
    and JAX's `reference_estimate_packed` (complex products)."""
    bj, _ = _banks(rng, 1)
    kj = jpk.kernel_bank(bj)
    r = _obs(rng, 256)
    r_re, r_im = r.real.copy(), r.imag.copy()
    h_re, h_im = jpk.estimate_packed(kj, jnp.asarray(r_re), jnp.asarray(r_im),
                                     128, True)
    kt = tvk.KernelBank(*(torch.as_tensor(np.asarray(x)[:, 0]
                                          if x.ndim == 3 and x.shape[1] == 1
                                          else np.asarray(x)) for x in kj))
    got_re, got_im = tvk.reference_estimate_packed(
        kt, torch.as_tensor(r_re), torch.as_tensor(r_im), chunk=100)
    _close(got_re, h_re)
    _close(got_im, h_im)
    ref_re, ref_im = jpk.reference_estimate_packed(kj, jnp.asarray(r_re),
                                                   jnp.asarray(r_im))
    _close(got_re, ref_re)
    _close(got_im, ref_im)


def test_estimate_at_a_ragged_n_matches_jax_and_einsum(rng):
    """`estimate` (the plain K14a on the CPU, no padding) at N = 203 with
    dead components against JAX's `estimate` (padded to its tile) and the
    port's einsum estimator."""
    bj, bt = _banks(rng, 2)
    r = _obs(rng, 203)
    want = np.asarray(jpk.estimate(bj, jnp.asarray(r), 128, True))
    before = tvk.karatsuba_estimate.launches
    got = tvk.estimate(bt, torch.as_tensor(r))
    assert tvk.karatsuba_estimate.launches == before     # CPU: plain
    assert got.dtype == torch.complex64 and got.shape == (203, D)
    _close(got, want)
    _close(got, tge.estimate(bt, torch.as_tensor(r), "all"))
    _close(tvk.estimate_packed(tvk.kernel_bank(bt),
                               torch.as_tensor(r.real.copy()),
                               torch.as_tensor(r.imag.copy()))[0], want.real)


@pytest.mark.parametrize("m,d,k", [
    (64, 64, 3),     # 64-column pieces: one logit and one value piece
    (12, 20, 2),     # one padded piece each, 52 zero contraction rows
    (40, 100, 2),    # 32-column pieces: 2 logit, 4 value (one padded)
    (128, 40, 2),    # two contraction chunks
    (128, 128, 1),   # the widest: 4 + 4 pieces, 2 chunks
    (1, 1, 1),
])
def test_karatsuba_operands_unpermute_to_the_bank_planes(m, d, k):
    """K14a's units (`karatsuba_operands`), read back element by element
    through the 128-byte swizzle (column n, contraction row kk of a unit at
    n 64 + ((kk // 8) ^ (n % 8)) 8 + kk % 8), are `split_planes3` of the
    six fp32 planes bit for bit, hi + lo + lo2 is each fp32 plane exactly,
    every padding row and column is zero, and the vector values are mu and
    b by piece."""
    kb = trc.random_karatsuba_bank(m, d, k, torch.device("cpu"))
    ops = tvk.karatsuba_operands(kb)
    pw = tvk.karatsuba_piece(m, d)
    mp, dp, n_ch = -(-m // pw), -(-d // pw), -(-m // 64)
    assert pw == (64 if max(m, d) <= 64 else 32)
    for t in ops[:3]:
        assert t.shape == (k, mp + dp, 3, n_ch, pw, 64)
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
    col = torch.arange(pw)[:, None]
    row = torch.arange(64)[None, :]
    pos = col * 64 + ((row // 8) ^ (col % 8)) * 8 + row % 8   # (n, kk)
    halves = {}
    for q, plane in enumerate(ops[:3]):
        logical = plane.reshape(k, mp + dp, 3, n_ch, pw * 64)[..., pos]
        full = logical.permute(0, 2, 3, 5, 1, 4).reshape(
            k, 3, 64 * n_ch, pw * (mp + dp))      # (K, operand, row, col)
        for half, (names, width, cols) in enumerate((
                (("pc_re", "pc_im", "pc_s"), m, full[..., :mp * pw]),
                (("wt_re", "wt_im", "wt_s"), d, full[..., mp * pw:]))):
            bits = cols.view(torch.int16)
            assert not bits[:, :, m:].any() and not bits[..., width:].any()
            for o, name in enumerate(names):
                want = tkn.split_planes3(getattr(kb, name))[q]
                assert torch.equal(bits[:, o, :m, :width],
                                   want.view(torch.int16)), (name, q)
                halves.setdefault(name, []).append(cols[:, o, :m, :width])
    for name, (hi, lo, lo2) in halves.items():
        total = hi.double() + lo.double() + lo2.double()
        assert torch.equal(total, getattr(kb, name).double()), name
    for first, re, im, width in ((0, kb.mu_re, kb.mu_im, m),
                                 (mp, kb.b_re, kb.b_im, d)):
        n_p = mp if first == 0 else dp
        vec = ops.vec[:, first:first + n_p]       # (K, pieces, 2, pw)
        flat = vec.permute(0, 2, 1, 3).reshape(k, 2, n_p * pw)
        assert torch.equal(flat[:, 0, :width], re)
        assert torch.equal(flat[:, 1, :width], im)
        assert not flat[..., width:].any()
    assert ops.vec.shape == (k, mp + dp, 2, pw) and ops.vec.is_contiguous()
    with pytest.raises(ValueError, match="lo2"):
        tvk.check_karatsuba_operands(ops._replace(lo2=ops.lo2[:, :1]), kb,
                                     torch.device("cpu"))


@pytest.mark.parametrize("case", ["bank", "random 12x20", "random 32x32"])
def test_plain_six_product_k14a_matches_complex_products(rng, case):
    """`karatsuba_tc_reference`, the plain version of the kernel's six bf16
    products per real product (the stream's issue order) and its fp32
    Karatsuba combine, with dead components: against the float64 complex
    products at most twice as far as `reference_estimate_packed` (complex
    float32 products), and within 1e-6 of scale of it on the prepared bank
    (D = 8) and at 12 x 20 (at 32 x 32 the combine's own rounding, which a
    float32 Karatsuba shares, reaches ~1e-6 of scale); on the prepared
    bank also within 1e-5 of JAX's K14a (`estimate_packed` in interpret
    mode and `reference_estimate_packed`) on the same numpy inputs."""
    if case == "bank":
        bj, _ = _banks(rng, 2)
        kj = jpk.kernel_bank(bj)
        kb = tvk.KernelBank(*(torch.as_tensor(
            np.asarray(x)[:, 0] if x.ndim == 3 and x.shape[1] == 1
            else np.asarray(x)) for x in kj))
        r = _obs(rng, 128)
    else:
        m, d = (int(x) for x in case.split()[1].split("x"))
        kb = trc.random_karatsuba_bank(m, d, 8, torch.device("cpu"), 2)
        r = _obs(rng, 300, m)
    r_re, r_im = torch.as_tensor(r.real.copy()), torch.as_tensor(
        r.imag.copy())
    six = torch.cat(tvk.karatsuba_tc_reference(kb, r_re, r_im, chunk=100),
                    -1)
    plain = torch.cat(tvk.reference_estimate_packed(kb, r_re, r_im), -1)
    exact = torch.cat(tvk.reference_estimate_packed(
        tvk.KernelBank(*(x.double() for x in kb)), r_re.double(),
        r_im.double()), -1)
    assert six.shape == plain.shape and torch.isfinite(six).all()

    def err(x):
        return float((x.double() - exact).abs().max())

    assert err(six) <= 2 * err(plain), (err(six), err(plain))
    if case != "random 32x32":
        _close(six, plain, 1e-6)
    if case == "bank":
        jre, jim = jpk.estimate_packed(kj, jnp.asarray(r.real.copy()),
                                       jnp.asarray(r.imag.copy()), 128, True)
        _close(six, np.concatenate([np.asarray(jre), np.asarray(jim)], -1))
        ref = jpk.reference_estimate_packed(kj, jnp.asarray(r.real.copy()),
                                            jnp.asarray(r.imag.copy()))
        _close(six, np.concatenate([np.asarray(x) for x in ref], -1))


def test_estimate_keeps_the_karatsuba_layout_in_its_cache(rng):
    """`estimate(bank, r, cache)` lowers the bank once per cache (on the
    CPU the plain version reads the layout alone: no kernel operands), and
    equals the call without a cache."""
    _, bt = _banks(rng, 1)
    r = torch.as_tensor(_obs(rng, 40))
    cache = {}
    first = tvk.estimate(bt, r, cache)
    kb = cache["karatsuba"]
    again = tvk.estimate(bt, r, cache)
    assert cache["karatsuba"] is kb and "karatsuba_operands" not in cache
    assert torch.equal(first, again)
    assert torch.equal(first, tvk.estimate(bt, r))


def test_karatsuba_estimate_refuses_past_its_widths():
    wide = tge.PreparedBank(torch.zeros(1), torch.zeros(1, 130),
                            torch.zeros(1, 130, 130, dtype=torch.complex64),
                            torch.zeros(1, 4, 130, dtype=torch.complex64),
                            torch.zeros(1, 4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="128"):
        tvk.estimate(wide, torch.zeros(3, 130, dtype=torch.complex64))


# ----------------------------------------------------------------- K14b

def test_bf16_planes_are_bitwise_jax_planes(rng):
    """pw_hi = bf16(pw), pw_lo = bf16(pw - pw_hi), rounded to nearest even
    in both packages: equal bit for bit."""
    bj, _ = _banks(rng, 1)
    kj = jpk.kernel_bank_block(bj)
    pw = np.asarray(kj.pw)
    hi_j = jnp.asarray(pw).astype(jnp.bfloat16)
    lo_j = (jnp.asarray(pw) - hi_j.astype(jnp.float32)).astype(jnp.bfloat16)
    hi, lo = tkn.split_planes(torch.as_tensor(pw))
    assert hi.dtype == lo.dtype == torch.bfloat16
    for got, want in ((hi, hi_j), (lo, lo_j)):
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16))
    assert float(lo.abs().max()) > 0


@pytest.mark.parametrize("mode,bound", [("bf16", 3e-2), ("split3", 1e-4),
                                        ("split2", 3e-2)])
def test_plain_k14b_modes_match_jax(rng, mode, bound):
    """Each plain mode (through the port's entry, on the CPU) against
    JAX's `estimate_block_grouped(mode=, interpret=True)` on the same bank,
    and against the port's f32 estimate within JAX's bounds."""
    bj, bt = _banks(rng, 1)
    r = _obs(rng, 256)
    want = np.asarray(jpk.estimate_block_grouped(bj, jnp.asarray(r), 256, 2,
                                                 True, None, mode))
    cache = {}
    wrapper = tvk.TC_WRAPPERS[mode]
    before = wrapper.launches
    got = tvk.estimate_block_grouped(bt, torch.as_tensor(r), mode, cache)
    assert wrapper.launches == before                    # CPU: plain
    assert got.dtype == torch.complex64 and "bf16_planes" in cache
    _close(got, want)
    f32 = tvk.estimate_block_grouped(bt, torch.as_tensor(r), "f32", cache)
    assert _rel_norm(got, f32) < bound
    # the wrapper on the planes, against the plain version it takes
    kb, planes, _ = tkn.lowered_tc(bt, cache)
    r2 = tkn._r2(torch.as_tensor(r))
    assert torch.equal(wrapper(r2, kb, planes),
                       tvk.grouped_tc_estimate_reference(r2, kb, planes,
                                                         tvk.MODES[mode]))


def test_f32_mode_is_k1(rng):
    _, bt = _banks(rng)
    r = torch.as_tensor(_obs(rng, 100))
    want = tkn.estimate_fused(bt, r)
    assert torch.equal(tvk.estimate_block_grouped(bt, r), want)
    assert torch.equal(tvk.estimate_block(bt, r), want)


def test_precision_modes_refuse_as_jax_does(rng):
    """t_coh > 1 is f32-only, an unknown mode is refused, in both
    packages; K14b takes 1, 2 or 3 passes."""
    bj, bt = _banks(rng)
    kj = jpk.kernel_bank_block(bj)
    r2 = tkn._r2(torch.as_tensor(_obs(rng, 16)))
    kb = tkn.kernel_bank_block(bt)
    for mode in ("bf16", "split3", "split2"):
        with pytest.raises(NotImplementedError, match="f32-only"):
            tvk.estimate_packed_block_grouped(kb, r2, mode, t_coh=2)
        with pytest.raises(NotImplementedError, match="f32-only"):
            jpk.estimate_packed_block_grouped(kj, jnp.asarray(r2.numpy()),
                                              16, 2, True, None, mode, 2)
    for t_coh in (1, 2):
        with pytest.raises(ValueError, match="unknown mode"):
            tvk.estimate_packed_block_grouped(kb, r2, "tf32", t_coh=t_coh)
        with pytest.raises(ValueError, match="unknown mode"):
            jpk.estimate_packed_block_grouped(kj, jnp.asarray(r2.numpy()),
                                              16, 2, True, None, "tf32",
                                              t_coh)
    with pytest.raises(ValueError, match="unknown mode"):
        tvk.estimate_block_grouped(bt, torch.as_tensor(_obs(rng, 8)), "fp8")
    # f32 with t_coh > 1 is K3 (blocks of T consecutive rows)
    kb2 = tkn.kernel_bank_block(bt, 2, 1.0)
    assert torch.equal(tvk.estimate_packed_block_grouped(kb2, r2, "f32", 2),
                       tkn.grouped_estimate_coherent_reference(r2, kb2, 2))


@pytest.mark.parametrize("two_m,two_d,k", [
    (128, 128, 3),   # main-path widths: 2 logit + 2 value pieces
    (24, 24, 2),     # D = 12: one padded piece each, 40 zero rows
    (40, 100, 2),    # 2M + 2D = 140, value half in 2 pieces
    (256, 256, 1),   # the widest: 4 + 4 pieces, 4 contraction chunks
    (256, 24, 2),
    (2, 2, 1),       # M = D = 1
])
def test_tc_slab_unpermutes_to_the_bf16_planes(two_m, two_d, k):
    """K14b's B layout of each bf16 plane (`tc_slab`), read back element
    by element through the 128-byte swizzle (column n, contraction row kk
    of a 64 x 64 chunk at n 64 + ((kk // 8) ^ (n % 8)) 8 + kk % 8), is
    `split_planes(pw)` bit for bit, with every padding row and column
    zero."""
    g = torch.Generator().manual_seed(two_m + two_d)
    pw = torch.randn(k, two_m, two_m + two_d, generator=g)
    mp, dp = -(-two_m // 64), -(-two_d // 64)
    col = torch.arange(64)[:, None]
    row = torch.arange(64)[None, :]
    pos = col * 64 + ((row // 8) ^ (col % 8)) * 8 + row % 8   # (n, kk)
    cols = tkn._tc_columns(two_m, two_d)
    assert int((cols >= 0).sum()) == two_m + two_d
    for plane in tkn.split_planes(pw):
        slab = tkn.tc_slab(plane, two_m)
        assert slab.shape == (k, mp + dp, mp, 64, 64)
        assert slab.dtype == torch.bfloat16 and slab.is_contiguous()
        logical = slab.reshape(k, mp + dp, mp, 64 * 64)[..., pos]
        full = logical.permute(0, 2, 4, 1, 3).reshape(k, 64 * mp,
                                                      64 * (mp + dp))
        bits = full.view(torch.int16)
        assert torch.equal(bits[:, :two_m][:, :, cols >= 0],
                           plane.view(torch.int16))
        assert not bits[:, two_m:].any() and not bits[:, :, cols < 0].any()
        # the swizzle is its own inverse
        assert torch.equal(tkn._sw128(tkn._sw128(slab)), slab)


def test_lowered_tc_lays_out_the_operands_once_per_cache(rng):
    """`lowered_tc` keeps K14b's operands in the bank's cache beside its
    planes: one layout per cache, equal to `tc_operands` of the planes, and
    a fresh one without a cache; the entry fills the cache."""
    _, bt = _banks(rng, 1)
    cache = {}
    kb, planes, ops = tkn.lowered_tc(bt, cache)
    assert cache["tc_operands"] is ops and cache["bf16_planes"] is planes
    again = tkn.lowered_tc(bt, cache)
    assert again[2] is ops and again[1] is planes and again[0] is kb
    fresh = tkn.tc_operands(kb, planes)
    for got, want in zip(ops, fresh):
        assert torch.equal(got, want)
    assert torch.equal(ops.hi, tkn.tc_slab(planes[0], kb.mu.shape[1]))
    assert torch.equal(ops.lo, tkn.tc_slab(planes[1], kb.mu.shape[1]))
    assert torch.equal(ops.vec, tkn.tc_vectors(kb))
    assert tkn.lowered_tc(bt)[2] is not ops
    other = {}
    tvk.estimate_block_grouped(bt, torch.as_tensor(_obs(rng, 8)), "split3",
                               other)
    assert "tc_operands" in other


@pytest.mark.parametrize("two_m,two_d", [(128, 128), (40, 100), (256, 24)])
def test_tc_vectors_hold_mu_and_b_by_piece(two_m, two_d):
    """mu over the logit pieces, b over the value pieces, zero padding."""
    g = torch.Generator().manual_seed(two_m)
    kb = tkn.KernelBankBlock(torch.randn(3, two_m, two_m + two_d, generator=g),
                             torch.randn(3, two_m, generator=g),
                             torch.randn(3, two_d, generator=g),
                             torch.randn(3, generator=g))
    vec = tkn.tc_vectors(kb)
    mp, dp = -(-two_m // 64), -(-two_d // 64)
    assert vec.shape == (3, mp + dp, 64) and vec.is_contiguous()
    flat_m = vec[:, :mp].reshape(3, -1)
    flat_d = vec[:, mp:].reshape(3, -1)
    assert torch.equal(flat_m[:, :two_m], kb.mu)
    assert torch.equal(flat_d[:, :two_d], kb.b)
    assert not flat_m[:, two_m:].any() and not flat_d[:, two_d:].any()


# ----------------------------------------------------------------- K15

def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_floor_probe", REPO / "tools" / "kernel_floor_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe_case():
    """A bank of K = 8 live components (logw_0 anchors full_fixedmax), its
    JAX kernel layout regrouped as the JAX tool groups it (GROUP = 4), and
    256 rows."""
    rng = np.random.default_rng(3)
    bj, bt = _banks(rng, d=12)
    kj = jpk.kernel_bank_block(bj)
    mod = _jax_probe()
    g = mod.GROUP
    n_groups = K // g
    two_m, s_cols = kj.pw.shape[1], kj.pw.shape[2]
    pw = jnp.swapaxes(kj.pw.reshape(n_groups, g, two_m, s_cols),
                      1, 2).reshape(n_groups, two_m, g * s_cols)
    mu = kj.mu.reshape(n_groups, 1, g * two_m)
    bb = kj.b.reshape(n_groups, 1, g * (s_cols - two_m))
    r = _obs(rng, 256, 12)
    r2 = np.concatenate([r.real, r.imag], -1).astype(np.float32)
    kt = tkn.KernelBankBlock(torch.as_tensor(np.asarray(kj.pw)),
                             torch.as_tensor(np.asarray(kj.mu)[:, 0]),
                             torch.as_tensor(np.asarray(kj.b)[:, 0]),
                             torch.as_tensor(np.asarray(kj.logw)))
    return mod, (kj.logw, pw, mu, bb, n_groups, g, two_m,
                 s_cols - two_m), r2, kt


@pytest.mark.parametrize("name", tfp.VARIANTS)
def test_plain_k15_bodies_match_the_jax_tool(probe_case, name):
    mod, (logw, pw, mu, bb, n_groups, g, two_m, two_d), r2, kt = probe_case
    want = np.asarray(mod.BODIES[name](logw, pw, mu, bb, jnp.asarray(r2),
                                       n_groups, g, two_m, two_d))
    got = tfp.floor_probe_reference(torch.as_tensor(r2), kt, name, chunk=100)
    assert got.shape == (256, two_d) and torch.isfinite(got).all()
    _close(got, want)
    before = tfp.floor_probe.launches
    assert torch.equal(tfp.floor_probe(torch.as_tensor(r2), kt, name),
                       tfp.floor_probe_reference(torch.as_tensor(r2), kt,
                                                 name))
    assert tfp.floor_probe.launches == before            # CPU: plain


def test_plain_k15_full_is_the_plain_k1(probe_case):
    _, _, r2, kt = probe_case
    r2 = torch.as_tensor(r2)
    assert torch.equal(tfp.floor_probe_reference(r2, kt, "full"),
                       tkn.grouped_estimate_reference(r2, kt))


def test_floor_probe_refuses_unknown_variants_and_wide_squares(probe_case):
    _, _, r2, kt = probe_case
    r2 = torch.as_tensor(r2)
    with pytest.raises(ValueError, match="unknown variant"):
        tfp.floor_probe(r2, kt, "exp_only")
    narrow = tkn.KernelBankBlock(torch.zeros(2, 4, 20), torch.zeros(2, 4),
                                 torch.zeros(2, 16), torch.zeros(2))
    with pytest.raises(ValueError, match="2D <= 2M"):
        tfp.floor_probe(torch.zeros(3, 4), narrow, "square_only")
    assert tfp.floor_probe(torch.zeros(3, 4), narrow, "quad_only").shape \
        == (3, 16)


def test_new_wrappers_are_counted():
    counts = tkn.launch_counts()
    for name in ("karatsuba_estimate", "grouped_tc_bf16", "grouped_tc_split2",
                 "grouped_tc_split3", "floor_probe"):
        assert name in counts
    tkn.reset_launch_counts()
    assert all(v == 0 for v in tkn.launch_counts().values())


# ----------------------------------------------------------------- tools

TINY = ["--device", "cpu", "--n-ant", "8", "--components", "4",
        "--repeats", "1"]


def test_kernel_floor_probe_main_on_cpu(capsys):
    out = tfp.main(TINY + ["--batch", "200"])
    assert set(out["ms"]) == set(tfp.VARIANTS) and out["n"] == 200
    assert out["device"].startswith("cpu")
    text = capsys.readouterr().out
    for name in tfp.VARIANTS:
        assert name in text
    assert "vs full" in text


def test_kernel_bench_main_on_cpu(capsys):
    out = tkb.main(TINY + ["--batch", "200"])
    assert set(out["ms"]) == {"karatsuba", "block", "einsum"}
    assert out["karatsuba_over_block"] == (out["ms"]["karatsuba"]
                                           / out["ms"]["block"])
    text = capsys.readouterr().out
    assert "best:" in text and "karatsuba / block" in text


def test_kernel_split_bench_main_on_cpu(capsys):
    out = tks.main(TINY + ["--n-train", "400", "--n-val", "200",
                           "--max-iter", "3"])
    assert set(out["rows"]) == {10.0, 20.0}
    for row in out["rows"].values():
        assert set(row) == {"einsum_f32", "kernel_f32", "kernel_bf16",
                            "kernel_split3", "kernel_split2"}
        assert row["kernel_f32"]["rel_to_f32"] == 0.0
        assert row["kernel_split3"]["rel_to_f32"] < 1e-4
        assert row["kernel_bf16"]["rel_to_f32"] < 3e-2
        assert abs(row["kernel_f32"]["mse"] - row["einsum_f32"]["mse"]) \
            <= 1e-4 * row["einsum_f32"]["mse"]
    assert capsys.readouterr().out.count("einsum_f32") == 8


def test_tc_repeat_check_holds_every_launch_on_cpu():
    """`tc_repeat_check.repeat_check` on the CPU (the wrappers' plain
    versions, no poison): every launch of every (shape, mode) held, none
    off; the fence its copy removes is in the source once; `main` refuses
    the CPU."""
    shapes = ((40, 24, 3, 70, 0), (24, 100, 2, 5, 1))
    got = trc.repeat_check(torch.device("cpu"), shapes=shapes, repeats=2,
                           poison=False)
    assert set(got) == {"kernel"} and len(got["kernel"]) == 2 * 3
    for rec in got["kernel"].values():
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    src = (tkn.CSRC / trc.STREAM).read_text()
    assert src.count(trc.FENCE) == 1
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        trc.main(["--device", "cpu"])


def test_tc_repeat_check_holds_every_karatsuba_launch_on_cpu():
    """Mode 'karatsuba' of `tc_repeat_check.repeat_check` on the CPU (the
    plain K14a, no poison): every launch held; its default shapes cover
    both warpgroup counts, 32-column pieces and two contraction chunks."""
    shapes = ((12, 20, 3, 70, 1), (40, 100, 2, 5, 0))
    got = trc.repeat_check(torch.device("cpu"), repeats=2, poison=False,
                           modes=("karatsuba",), karatsuba_shapes=shapes)
    assert set(got) == {"kernel"} and len(got["kernel"]) == 2
    for rec in got["kernel"].values():
        assert rec == {"launches": 2, "failures": 0, "max_err": 0.0}
    sizes = {(max(m, d) <= 64, m > 64, n >= 132 * 128)
             for m, d, _, n, _ in trc.KARATSUBA_SHAPES}
    assert {(True, False, False), (True, False, True), (False, False, False),
            (False, True, False)} <= sizes


@pytest.mark.parametrize("tool", [tfp, tkb, tks, trc])
def test_tools_raise_without_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
