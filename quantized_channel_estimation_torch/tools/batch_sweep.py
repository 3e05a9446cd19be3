"""Time K1, K3 and K14a at the batch sizes the service and the sweeps send.

The service flushes microbatches of 256-1024 rows, `run_gmm` estimates
10000 rows an SNR, and the kernel tools 131072. A kernel's time at a small
batch is set by how many blocks it can spread over the card's SMs, so it
need not follow its time at the headline batch. This tool times, on the
headline bank (K = D = 64, 2 bits, 10 dB), K1 (`kernels.grouped_estimate`),
K3 (`kernels.grouped_estimate_coherent` at T = 4 and 16, alpha 1) and
K14a (`variant_kernels.karatsuba_estimate`) at each `--rows`, with CUDA
events (median of `--repeats`), the bank's kernel layouts made once
beforehand, and prints one JSON line. Run as a file with an older
checkout first on the path (`PYTHONPATH=<checkout> python3
<this file>`), it times that checkout's kernels, so that one call can time
a parent and a change in turns; a K14a wrapper that takes no laid-out
operands (the fp32 loop it replaced) gets none.

    python -m quantized_channel_estimation_torch.tools.batch_sweep \
        [--rows 512 4096 131072] [--repeats R]
"""
from __future__ import annotations

import json

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators import variant_kernels
from quantized_channel_estimation_torch.tools import common

ROWS = (512, 4096, 131072)


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


def main(argv=None) -> dict:
    p = common.parser(__doc__)
    p.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    args = p.parse_args(argv)
    dev = common.device(args.device)
    bank, q = common.headline_bank(dev, args.n_ant, args.components,
                                   args.bits)
    kb_t = {t: kernels.kernel_bank_block(bank, t, 1.0) for t in (1, 4, 16)}
    kk = variant_kernels.kernel_bank(bank)
    r2 = kernels._r2(common.observations(dev, q, max(args.rows), args.n_ant,
                                         args.bits))
    ms = {}
    for label, (t, call) in _wrappers(kb_t, kk, r2).items():
        for n in args.rows:
            rows = n - n % t
            ms[f"{label} N={rows}"] = common.time_ms(
                lambda: call(rows), dev, args.repeats)
    out = {"device": common.device_label(dev), "ms": ms}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
