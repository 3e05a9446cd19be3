"""Quantized observation model r = Q(A h + n).

Port of `quantized_channel_estimation_tpu/ops/observation.py`
(`apply_pilots`, `observe`). The noise draw is split from the rest
(`observe_noise`) so that a test can hand both packages the same noise.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, quantize)


def apply_pilots(h: torch.Tensor, a: Optional[torch.Tensor]) -> torch.Tensor:
    """y = A h for h (..., N); A (M, N) or None (identity)."""
    if a is None:
        return h
    return h @ a.T


def observe_noise(h: torch.Tensor, w: torch.Tensor, snr_db,
                  a: Optional[torch.Tensor], n_bits,
                  q: Optional[ScalarQuantizer] = None) -> torch.Tensor:
    """r = Q(A h + 10^(-snr/20) w) for given white noise w ~ CN(0, I) of
    the observation's shape."""
    y = apply_pilots(h, a)
    noise_amp = torch.tensor(10.0 ** (-float(snr_db) / 20.0),
                             dtype=y.real.dtype, device=y.device)
    return quantize(y + noise_amp * w, n_bits, q)


def observe(gen: torch.Generator, h: torch.Tensor, snr_db,
            a: Optional[torch.Tensor], n_bits,
            q: Optional[ScalarQuantizer] = None) -> torch.Tensor:
    """r = Q(A h + 10^(-snr/20) w), w ~ CN(0, I) drawn from `gen`."""
    m = h.shape[-1] if a is None else a.shape[0]
    w = crandn(gen, h.shape[:-1] + (m,), dtype=h.dtype)
    return observe_noise(h, w, snr_db, a, n_bits, q)
