"""Locate K1's bottleneck on the H100: the floor probe K15.

Port of the JAX repository's `tools/kernel_floor_probe.py` (`BODIES` :191,
`run_variant` :203). It times seven stripped variants of K1 on K1's own
stream (`csrc/floor_probe.cu`, which compiles `csrc/grouped_tc_stream.cuh`:
six bf16 tensor-core products a piece, an fp32 epilogue) to attribute K1's
time:

  full          K1 itself (GEMM + logits + online softmax + combine)
  gemm_only     the GEMM and a sum of the z columns (the GEMM floor)
  logits_only   GEMM + quadratic term + online-softmax denominator
  combine_only  GEMM + a combine weighted by logw_k, no logits or softmax
  square_only   GEMM + the elementwise square, no lane reduction
  quad_only     GEMM + square + lane reduction, no exp / max / denominator
  full_fixedmax the full math with the softmax anchored at logw_0

Every variant runs the whole (2M+2D)-wide GEMM as K1's six products (see
the source), so none can come in under their tensor-core operation floor.
The plain versions of the bodies (`BODIES`, `floor_probe_reference`) work
on K1's bank layout (`kernels.KernelBankBlock`); JAX's work on its GROUP =
4 layout, the same function.

    python -m quantized_channel_estimation_torch.tools.kernel_floor_probe \
        [--batch N] [--repeats R] [--device cpu]

prints, per variant, ms per batch, M estimates/s and the difference from
`full`, at the headline batch (131072 rows, K = D = 64, 2 bits, 10 dB, the
JAX tool's random bank).
"""
from __future__ import annotations

from typing import Optional

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.tools import common

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
TC_PASSES = 6             # K1's bf16 products a piece
PROBE_MAX = 128           # 2M and 2D of the probe's instantiations


def _full(yz, kb):
    lg, z = kernels.logits_and_estimates(yz, kb)
    return torch.einsum("nk,nkd->nd", torch.softmax(lg, -1), z)


def _gemm_only(yz, kb):
    return yz[..., kb.mu.shape[1]:].sum(1)


def _logits_only(yz, kb):
    lg = kernels.logits_and_estimates(yz, kb)[0]
    den = torch.exp(lg - lg.max(-1, keepdim=True).values).sum(-1)
    return den[:, None].expand(-1, kb.b.shape[1])


def _combine_only(yz, kb):
    z = kernels.logits_and_estimates(yz, kb)[1]
    return (kb.logw[None, :, None] * z).sum(1)


def _squares(yz, kb):
    dy = yz[..., :kb.mu.shape[1]] - kb.mu[None]
    return dy * dy


def _square_only(yz, kb):
    return _squares(yz, kb)[..., :kb.b.shape[1]].sum(1)


def _quad_only(yz, kb):
    q = _squares(yz, kb).sum(-1).sum(1)
    return q[:, None].expand(-1, kb.b.shape[1])


def _full_fixedmax(yz, kb):
    lg, z = kernels.logits_and_estimates(yz, kb)
    p = torch.exp(lg - kb.logw[0])
    return (p[..., None] * z).sum(1) / p.sum(1, keepdim=True)


# the probe's bodies on one chunk's products yz (n, K, 2M+2D) = r2 pw_k
BODIES = {
    "full": _full,
    "gemm_only": _gemm_only,
    "logits_only": _logits_only,
    "combine_only": _combine_only,
    "square_only": _square_only,
    "quad_only": _quad_only,
    "full_fixedmax": _full_fixedmax,
}
VARIANTS = tuple(BODIES)   # the kernel's VARIANT numbering


def _check_variant(variant: str, two_m: int, two_d: int) -> None:
    if variant not in BODIES:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if variant == "square_only" and two_d > two_m:
        raise ValueError(f"square_only takes 2D <= 2M; got 2M={two_m}, "
                         f"2D={two_d}")


def floor_probe_reference(r2: torch.Tensor, kb: kernels.KernelBankBlock,
                          variant: str, chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K15's `variant`: r2 (N, 2M) -> (N, 2D) (a
    row's denominator or quadratic sum in every column for logits_only and
    quad_only). `full` is `kernels.grouped_estimate_reference`."""
    pin_fp32()
    k_comp, two_m, s_cols = kb.pw.shape
    _check_variant(variant, two_m, s_cols - two_m)
    flat = kb.pw.permute(1, 0, 2).reshape(two_m, k_comp * s_cols)
    out = []
    for i0 in range(0, r2.shape[0], chunk):
        yz = (r2[i0:i0 + chunk] @ flat).reshape(-1, k_comp, s_cols)
        out.append(BODIES[variant](yz, kb))
    return torch.cat(out) if out else r2.new_zeros((0, s_cols - two_m))


def floor_probe(r2: torch.Tensor, kb: kernels.KernelBankBlock,
                variant: str,
                ops: Optional[kernels.TcOperands] = None) -> torch.Tensor:
    """K15's `variant` on r2 (N, 2M) float32 -> (N, 2D) float32; ops: the
    bank's `kernels.tc_operands` (laid out in the call when None). On a
    CUDA tensor it launches the CUDA kernel (2M and 2D at most 128) on the
    current stream and raises on any refusal; on a CPU tensor it computes
    the plain version."""
    if not r2.is_cuda:
        return floor_probe_reference(r2, kb, variant)
    n, k_comp, two_m, two_d = kernels._check_inputs("floor_probe", r2, kb)
    _check_variant(variant, two_m, two_d)
    if two_m > PROBE_MAX or two_d > PROBE_MAX:
        raise ValueError(f"floor_probe takes 2M, 2D <= {PROBE_MAX}; got "
                         f"2M={two_m}, 2D={two_d}")
    out = torch.empty((n, two_d), dtype=torch.float32, device=r2.device)
    if n == 0:
        return out
    # no sink (None, store_sink 0): the folded accumulators are not stored
    kernels.launch_tc("floor_probe", kernels._library("floor_probe")
                      .floor_probe_launch, r2, kb, ops, (out,), n, k_comp,
                      two_m, two_d, VARIANTS.index(variant), None, 0)
    floor_probe.launches += 1
    return out


kernels.register_wrappers(floor_probe)


def gemm_floor_ms(n: int, kb: kernels.KernelBankBlock) -> float:
    """K1's GEMM as its six bf16 products, 6 x 2 N 2M (2M+2D) K operations,
    at the H100's bf16 tensor-core peak: the least time any variant can
    take."""
    k_comp, two_m, s_cols = kb.pw.shape
    return (TC_PASSES * 2.0 * n * two_m * s_cols * k_comp / PEAK_BF16_FLOPS
            * 1e3)


def main(argv=None) -> dict:
    p = common.parser(__doc__)
    p.add_argument("--batch", type=int, default=common.BATCH)
    args = p.parse_args(argv)
    dev = common.device(args.device)
    bank, q = common.headline_bank(dev, args.n_ant, args.components,
                                   args.bits)
    kb, _, ops = kernels.lowered_tc(bank, {})
    r2 = kernels._r2(common.observations(dev, q, args.batch, args.n_ant,
                                         args.bits))
    n = r2.shape[0]
    floor = gemm_floor_ms(n, kb)
    print(f"# K15 floor probe on {common.device_label(dev)}: N={n}, "
          f"2M={r2.shape[1]}, 2D={kb.b.shape[1]}, K={kb.pw.shape[0]}; GEMM "
          f"operation floor {floor:.3f} ms ({TC_PASSES} bf16 products at "
          "the tensor-core peak)", flush=True)
    ms = {}
    for name in VARIANTS:
        out = floor_probe(r2, kb, name, ops)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        ms[name] = common.time_ms(
            lambda name=name: floor_probe(r2, kb, name, ops), dev,
            args.repeats)
        print(f"{name:14s} {ms[name]:8.3f} ms/batch  "
              f"{n / ms[name] / 1e3:8.2f} M/s  "
              f"{ms[name] - ms['full']:+8.3f} ms vs full", flush=True)
    return {"device": common.device_label(dev), "n": n, "ms": ms,
            "floor_ms": floor}


if __name__ == "__main__":
    main()
