"""Time K1, K3, K14a, K11, K12, K13, K10 and K6-K9 at the batch sizes the
service and the sweeps send.

The service flushes microbatches of 256-1024 rows, `run_gmm` estimates
10000 rows an SNR, and the kernel tools 131072. A kernel's time at a small
batch is set by how many blocks it can spread over the card's SMs, so it
need not follow its time at the headline batch. This tool times, on the
headline bank (K = D = 64, 2 bits, 10 dB), K1 (`kernels.grouped_estimate`),
K3 (`kernels.grouped_estimate_coherent` at T = 4 and 16, alpha 1) and
K14a (`variant_kernels.karatsuba_estimate`), and on the factored bank of
a seeded MFA prior at the same widths (`--latent` M = 16, zero means,
loadings of total power 0.8 a dimension) K11 (`fact_kernels.fact_estimate`),
K12 (`fact_kernels.fact_estimate_coherent` at T = 4, alpha 1) and K13
(`fact_kernels.fact_estimate_stats`, the whole bank as one shard), and on
the 2-pilot bank of a seeded circulant prior at the same widths (spectra
uniform on [0.05, 2], small non-zero means, uniform weights; the P = 2
`pilots.pilot_matrix`) K10 (`mp_circ_kernels.mp_circ_estimate`) and its
coherent form at T = 4, alpha 1, and on the bank of the same prior under
the scalar pilot x0 = 1 K6 (`circ_kernels.circ_estimate`), K7 (T = 4,
alpha 1), K8 and K9 (T = 4, alpha 1; the whole bank as one shard), at
each `--rows`, with CUDA events (median of `--repeats`), the banks' kernel
layouts made once beforehand, and prints one JSON line. Run as a file with
an older checkout first on the path (`PYTHONPATH=<checkout> python3 <this
file>`), it times that checkout's kernels, so that one call can time a
parent and a change in turns; a K14a, K11-K13, K10 or K6-K9 wrapper that
takes no laid-out operands (the fp32 loops they replaced) gets none.

    python -m quantized_channel_estimation_torch.tools.batch_sweep \
        [--rows 512 4096 131072] [--repeats R] [--latent M]
"""
from __future__ import annotations

import json

import numpy as np
import torch

from quantized_channel_estimation_torch.estimators import circ_kernels
from quantized_channel_estimation_torch.estimators import fact_kernels
from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import mp_circ_kernels
from quantized_channel_estimation_torch.estimators import variant_kernels
from quantized_channel_estimation_torch.models import (
    gmm, mfa, mfa_bank, structured_bank)
from quantized_channel_estimation_torch.ops import observation, pilots
from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.tools import common

ROWS = (512, 4096, 131072)
LATENT = 16   # M of the MFA prior: run_mfa's D / 4
PILOTS = 2    # P of the multi-pilot bank: run_gmm's `n_pilots=2`


def fact_bank(dev, q, n_ant, k_comp, m, n_bits, seed=0):
    """The factored bank at 10 dB under x0 = 1 of a seeded MFA prior:
    weights uniform on [0.5, 1.5], zero means, loadings of total power 0.8
    a dimension, psi uniform on [0.05, 0.35]."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 1.5, k_comp)
    lam = np.sqrt(0.8 / m) * (rng.standard_normal((k_comp, n_ant, m))
                              + 1j * rng.standard_normal((k_comp, n_ant, m))
                              ) / np.sqrt(2)
    params = mfa.MfaParams(*(torch.as_tensor(x, device=dev) for x in (
        (w / w.sum()).astype(np.float32),
        np.zeros((k_comp, n_ant), np.complex64), lam.astype(np.complex64),
        rng.uniform(0.05, 0.35, (k_comp, n_ant)).astype(np.float32))))
    return mfa_bank.prepare_bank_factored(
        params, common.SNR_DB, torch.tensor(1.0 + 0.0j), n_bits, q)


def _circ_prior(dev, n_ant, k_comp, seed):
    """A seeded circulant prior (spectra uniform on [0.05, 2], means of
    power 0.08, uniform weights): (params with placeholder covariances,
    spectra)."""
    rng = np.random.default_rng(seed)
    spectra = torch.as_tensor(
        rng.uniform(0.05, 2.0, (k_comp, n_ant)).astype(np.float32),
        device=dev)
    means = torch.as_tensor(
        (0.2 * (rng.standard_normal((k_comp, n_ant))
                + 1j * rng.standard_normal((k_comp, n_ant)))).astype(
                    np.complex64), device=dev)
    dummy = torch.zeros((k_comp, 1, 1), dtype=torch.complex64, device=dev)
    params = gmm.GmmParams(torch.full((k_comp,), 1.0 / k_comp, device=dev),
                           means, dummy, dummy)
    return params, spectra


def mp_bank_rows(dev, q, n_ant, k_comp, n_bits, n, p=PILOTS, seed=0):
    """The multi-pilot bank at 10 dB under the P-pilot matrix of the
    seeded circulant prior (`_circ_prior`), and n of its quantized
    observations of unit-power channels, interleaved (n, 2 P D)."""
    params, spectra = _circ_prior(dev, n_ant, k_comp, seed)
    a = pilots.pilot_matrix(n_ant, p, n_bits, device=dev)
    bank = structured_bank.prepare_bank_circulant(
        params, common.SNR_DB, a, n_bits, q, spectra=spectra)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = observation.observe(gen, crandn(gen, (n, n_ant)), common.SNR_DB, a,
                            n_bits, q)
    return bank, torch.view_as_real(r.to(torch.complex64)).reshape(
        n, -1).contiguous()


def circ_bank_of(dev, q, n_ant, k_comp, n_bits, seed=0):
    """The circulant bank at 10 dB under the scalar pilot x0 = 1 of the
    seeded circulant prior (`_circ_prior`)."""
    params, spectra = _circ_prior(dev, n_ant, k_comp, seed)
    return structured_bank.prepare_bank_circulant(
        params, common.SNR_DB, torch.tensor(1.0 + 0.0j), n_bits, q,
        spectra=spectra)


def _circ_wrappers(bank, x2):
    """{label: (T, call(n))} of K6, K7 (T = 4, alpha 1), K8 and K9 (T = 4,
    alpha 1) on the circulant bank's layouts, each on the first n rows of
    x2 (interleaved), with the bank's tensor-core operands made once."""
    ck = circ_kernels
    ckb, ckb4 = ck.circ_kernel_bank(bank), ck.circ_kernel_bank(bank, None,
                                                               4, 1.0)
    tc = hasattr(ck, "circ_tc_operands")
    ops = (ck.circ_tc_operands(ckb),) if tc else ()
    ops_s = (ck.circ_tc_operands(ckb, True),) if tc else ()
    return {"K6": (1, lambda n: ck.circ_estimate(x2[:n], ckb, *ops)),
            "K7 T=4": (4, lambda n: ck.circ_estimate_coherent(
                x2[:n], ckb4, 4, 1.0, *ops)),
            "K8": (1, lambda n: ck.circ_estimate_stats(x2[:n], ckb, *ops_s)),
            "K9 T=4": (4, lambda n: ck.circ_estimate_coherent_stats(
                x2[:n], ckb4, 4, 1.0, *ops_s))}


def _mp_wrappers(bank, xm):
    """{label: (T, call(n))} of K10 and its coherent form (T = 4, alpha 1)
    on the multi-pilot bank's layouts, each on the first n rows of xm, with
    the bank's tensor-core operands made once."""
    mk = mp_circ_kernels
    ckb, ckb4 = mk.mp_circ_kernel_bank(bank), mk.mp_circ_kernel_bank(
        bank, None, 4, 1.0)
    ops = ((mk.mp_circ_tc_operands(ckb),)
           if hasattr(mk, "mp_circ_tc_operands") else ())
    return {"K10 P=2": (1, lambda n: mk.mp_circ_estimate(xm[:n], ckb, *ops)),
            "K10 P=2 T=4": (4, lambda n: mk.mp_circ_estimate_coherent(
                xm[:n], ckb4, 4, 1.0, *ops))}


def _wrappers(kb_t, kk, r2):
    """{label: (T, call(n))} of K1 and K3 on the layouts kb_t[T] and of
    K14a on the Karatsuba layout kk, each on the first n rows of r2 (K14a
    on its halves r_re, r_im), with the banks' tensor-core operands made
    once."""
    ops = kernels.tc_operands(kb_t[1])
    calls = {"K1": (1, lambda n: kernels.grouped_estimate(r2[:n], kb_t[1],
                                                          ops))}
    for t in (4, 16):
        calls[f"K3 T={t}"] = (t, lambda n, t=t: (
            kernels.grouped_estimate_coherent(r2[:n], kb_t[t], t, 1.0, ops)))
    vk = variant_kernels
    k_ops = ((vk.karatsuba_operands(kk),)
             if hasattr(vk, "karatsuba_operands") else ())
    m = kk.pc_re.shape[1]
    r_re, r_im = r2[:, :m].contiguous(), r2[:, m:].contiguous()
    calls["K14a"] = (1, lambda n: vk.karatsuba_estimate(
        r_re[:n], r_im[:n], kk, *k_ops))
    return calls


def _fact_wrappers(fbank, x2):
    """{label: (T, call(n))} of K11, K12 (T = 4, alpha 1) and K13 on the
    factored bank's layouts, each on the first n rows of x2 (interleaved),
    with the bank's tensor-core operands made once."""
    fk = fact_kernels
    fkb, fkb4 = fk.fact_kernel_bank(fbank), fk.fact_kernel_bank(fbank, 4,
                                                                1.0)
    ops = ((fk.fact_tc_operands(fkb),)
           if hasattr(fk, "fact_tc_operands") else ())
    return {"K11": (1, lambda n: fk.fact_estimate(x2[:n], fkb, *ops)),
            "K12 T=4": (4, lambda n: fk.fact_estimate_coherent(
                x2[:n], fkb4, 4, 1.0, *ops)),
            "K13": (1, lambda n: fk.fact_estimate_stats(x2[:n], fkb, *ops))}


def main(argv=None) -> dict:
    p = common.parser(__doc__)
    p.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    p.add_argument("--latent", type=int, default=LATENT)
    args = p.parse_args(argv)
    dev = common.device(args.device)
    bank, q = common.headline_bank(dev, args.n_ant, args.components,
                                   args.bits)
    kb_t = {t: kernels.kernel_bank_block(bank, t, 1.0) for t in (1, 4, 16)}
    kk = variant_kernels.kernel_bank(bank)
    r = common.observations(dev, q, max(args.rows), args.n_ant, args.bits)
    r2 = kernels._r2(r)
    x2 = torch.view_as_real(r.to(torch.complex64)).reshape(
        r.shape[0], -1).contiguous()            # interleaved [re, im]
    fbank = fact_bank(dev, q, args.n_ant, args.components, args.latent,
                      args.bits)
    mbank, xm = mp_bank_rows(dev, q, args.n_ant, args.components, args.bits,
                             max(args.rows))
    cbank = circ_bank_of(dev, q, args.n_ant, args.components, args.bits)
    calls = {**_wrappers(kb_t, kk, r2), **_fact_wrappers(fbank, x2),
             **_mp_wrappers(mbank, xm), **_circ_wrappers(cbank, x2)}
    ms = {}
    for label, (t, call) in calls.items():
        for n in args.rows:
            rows = n - n % t
            ms[f"{label} N={rows}"] = common.time_ms(
                lambda: call(rows), dev, args.repeats)
    out = {"device": common.device_label(dev), "ms": ms}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
