"""Complex-array conventions and random sampling.

Port of `quantized_channel_estimation_tpu/ops/cplx.py` (main-path subset:
`crandn`, `cplx2real`, `real2cplx`). Random draws take an explicit
`torch.Generator` in place of a JAX key; the two frameworks' streams differ,
so tests hand both packages the same numpy noise.
"""
from __future__ import annotations

import math

import torch


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """float dtype matching a complex dtype (c64 -> f32, c128 -> f64)."""
    return torch.empty((), dtype=dtype).real.dtype


def crandn(gen: torch.Generator, shape,
           dtype=torch.complex64) -> torch.Tensor:
    """Circularly-symmetric complex standard normal, E[|x|^2] = 1, on the
    generator's device."""
    rdt = real_dtype_of(dtype)
    re = torch.randn(shape, generator=gen, dtype=rdt, device=gen.device)
    im = torch.randn(shape, generator=gen, dtype=rdt, device=gen.device)
    return math.sqrt(0.5) * torch.complex(re, im)


def cplx2real(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Concatenate real and imaginary parts along `dim`."""
    return torch.cat([x.real, x.imag], dim=dim)


def real2cplx(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`cplx2real`."""
    re, im = torch.chunk(x, 2, dim=dim)
    return torch.complex(re, im)
