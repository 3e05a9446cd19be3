"""Complex-array conventions and random sampling.

Port of `quantized_channel_estimation_tpu/ops/cplx.py`: `crandn`,
`cplx2real`, `real2cplx`, and the matrix products of the structured banks
(`cmatmul`, `cmatmul_realout`, `rcmatmul`). The JAX package spells those as
real block embeddings for the TPU's matrix unit; PyTorch has complex GEMMs,
so here each is the direct product. Random draws take an explicit
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


def cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex a @ b: a (..., n, k), b (..., k, m) -> (..., n, m)."""
    return a @ b


def cmatmul_realout(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re(a @ b) for complex a, b with two real GEMMs (the imaginary half
    is never computed). Returns a real tensor."""
    return a.real @ b.real - a.imag @ b.imag


def rcmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """real a @ complex b as two real GEMMs against Re b and Im b (a
    complex cast of `a` would spend half the product on a zero block)."""
    return torch.complex(a @ b.real, a @ b.imag)
