"""Pilot matrix construction.

Port of `quantized_channel_estimation_tpu/ops/pilots.py`. The observation
model is y = A h + n with A = kron(x, I_N) for a pilot vector x of length
n_pilots, so y has dimension n_pilots * N.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from quantized_channel_estimation_torch.ops.quantizer import is_inf_bits


def pilot_vector(gen: Optional[torch.Generator], n_pilots: int, n_bits,
                 pilot_type: str = "angle_amp", dtype=torch.complex64,
                 device=None) -> torch.Tensor:
    """Pilot vector x (n_pilots,): 'angle' (unit-modulus phase ramp over
    [0, pi/2)), 'angle_amp' (that ramp with amplitudes 0.5 -> 1,
    power-normalized), 'rand' (complex Gaussian from `gen`,
    power-normalized) or 'ones'; all ones for n_bits = inf."""
    if is_inf_bits(n_bits) or pilot_type == "ones":
        return torch.ones(n_pilots, dtype=dtype, device=device)
    ph = np.linspace(0.0, np.pi / 2.0, n_pilots, endpoint=False)
    if pilot_type == "angle":
        return torch.as_tensor(np.exp(1j * ph), device=device).to(dtype)
    if pilot_type == "angle_amp":
        amp = np.linspace(0.5, 1.0, n_pilots, endpoint=True)
        x = amp * np.exp(1j * ph)
        x = x * math.sqrt(n_pilots) / np.linalg.norm(x)
        return torch.as_tensor(x, device=device).to(dtype)
    if pilot_type == "rand":
        if gen is None:
            raise ValueError("pilot_type='rand' requires a torch.Generator")
        re = torch.randn(n_pilots, generator=gen, dtype=torch.float64,
                         device=gen.device)
        im = torch.randn(n_pilots, generator=gen, dtype=torch.float64,
                         device=gen.device)
        x = torch.complex(re, im)
        x = x * math.sqrt(n_pilots) / torch.linalg.norm(x)
        return x.to(device=device, dtype=dtype)
    raise NotImplementedError(f"Pilot type {pilot_type!r} is not implemented!")


def pilot_matrix(n_antennas: int, n_pilots: int, n_bits,
                 pilot_type: str = "angle_amp",
                 gen: Optional[torch.Generator] = None,
                 dtype=torch.complex64, device=None) -> torch.Tensor:
    """A = kron(x, I_N), shape (n_pilots * N, N)."""
    x = pilot_vector(gen, n_pilots, n_bits, pilot_type, dtype, device)
    return torch.kron(x[:, None],
                      torch.eye(n_antennas, dtype=dtype, device=device))
