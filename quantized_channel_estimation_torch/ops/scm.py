"""3GPP spatial channel model (SCM) simulation, batched.

Port of `quantized_channel_estimation_tpu/ops/scm.py` (`ScmConfig`,
`_laplace_mixture`, `angular_psd`, `sample_psd`, `channel_from_psd`,
`generate_channels`, `flatten_coherence`). ULA channels are white noise colored by the square
root of an angular power spectral density (wrapped Laplace mixture through
the ULA arcsine map), sampled on a 100x oversampled frequency lattice and
IFFT-truncated to the array. Returns the channels and the first row of each
sample's Toeplitz covariance (the genie covariance of genie-BLMMSE).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quantized_channel_estimation_torch.ops.cplx import crandn, real_dtype_of

OVERSAMPLING = 100  # frequency oversampling factor
LATTICE_EPS = 1.0 / 3.0  # lattice offset avoiding +-pi samples


class ScmConfig(NamedTuple):
    n_antennas: int
    n_path: int = 3
    path_sigma: float = 2.0  # angular spread (deg std) of each Laplace cluster
    n_coherence: int = 1


def _laplace_mixture(theta_deg: torch.Tensor, angles_deg: torch.Tensor,
                     weights: torch.Tensor, sigma: float) -> torch.Tensor:
    """Mixture of wrapped Laplace densities over angle (degrees);
    theta (..., F), angles/weights (..., P). Scale sigma/sqrt(2) makes sigma
    the angular standard deviation."""
    scale = sigma / math.sqrt(2.0)
    diff = theta_deg[..., :, None] - angles_deg[..., None, :]
    diff = torch.remainder(diff + 180.0, 360.0) - 180.0
    v = weights[..., None, :] / (2.0 * scale) * torch.exp(-diff.abs() / scale)
    return v.sum(-1)


def angular_psd(u: torch.Tensor, angles_deg: torch.Tensor,
                weights: torch.Tensor, sigma: float) -> torch.Tensor:
    """ULA spatial-frequency PSD: the Laplace mixture in angle mapped
    through u = pi sin(theta)."""
    u = torch.remainder(u + math.pi, 2.0 * math.pi) - math.pi
    theta = torch.rad2deg(torch.arcsin(u / math.pi))
    v = (_laplace_mixture(theta, angles_deg, weights, sigma)
         + _laplace_mixture(180.0 - theta, angles_deg, weights, sigma))
    return torch.rad2deg(2.0 * math.pi * v / torch.sqrt(math.pi ** 2 - u ** 2))


def sample_psd(angles_deg: torch.Tensor, weights: torch.Tensor,
               n_antennas: int, sigma: float) -> torch.Tensor:
    """Sampled, clipped, energy-normalized PSD on the oversampled lattice:
    (..., P) angles/weights -> (..., F), F = OVERSAMPLING * N. Endfire
    energies above F are clipped to F, and the total energy is F."""
    n_freq = OVERSAMPLING * n_antennas
    lattice = (torch.arange(LATTICE_EPS, n_freq + LATTICE_EPS,
                            dtype=angles_deg.dtype, device=angles_deg.device)
               / n_freq * 2.0 * math.pi - math.pi)
    fs = angular_psd(lattice, angles_deg, weights, sigma)
    fs = torch.where(fs.abs() > n_freq, torch.full_like(fs, float(n_freq)), fs)
    total = fs.sum(-1, keepdim=True)
    return torch.where(total > 0, fs / total * n_freq, fs)


def channel_from_noise(fs: torch.Tensor, x: torch.Tensor,
                       n_antennas: int):
    """Color white noise x (..., n_coherence, F) by sqrt(PSD) fs (..., F)
    and IFFT-truncate to the array. Returns (h (..., n_coherence, N), t
    (..., N)), t the first row of each sample's Toeplitz covariance."""
    dtype = x.dtype
    n_freq = fs.shape[-1]
    colored = torch.sqrt(fs)[..., None, :].to(dtype) * x
    # sqrt(F) is taken in float32, as the JAX model does (`scm.py:86`)
    root = torch.sqrt(torch.tensor(float(n_freq), dtype=torch.float32))
    h = torch.fft.ifft(colored, dim=-1) * root.to(dtype)
    # copies: a view of the first N of F = 100 N bins would keep the whole
    # lattice's storage alive for as long as the channels live
    h = h[..., :n_antennas].clone()
    t = (torch.fft.fft(fs.to(dtype), dim=-1) / n_freq)[..., :n_antennas]
    return h, t.clone()


def channel_from_psd(gen: torch.Generator, fs: torch.Tensor, n_antennas: int,
                     n_coherence: int = 1, dtype=torch.complex64):
    """`channel_from_noise` with the white noise drawn from `gen`."""
    x = crandn(gen, fs.shape[:-1] + (n_coherence, fs.shape[-1]), dtype=dtype)
    return channel_from_noise(fs, x, n_antennas)


def generate_channels(gen: torch.Generator, n_batches: int, cfg: ScmConfig,
                      dtype=torch.complex64):
    """A batch of SCM channels on the generator's device: per sample,
    n_path cluster gains ~ U(0,1) normalized to sum 1 and angles
    ~ U(-90, 90) degrees. Returns (h (B, n_coherence, N), or (B, N) when
    n_coherence == 1, t (B, N))."""
    device = gen.device
    rdt = real_dtype_of(dtype)
    gains = torch.rand((n_batches, cfg.n_path), generator=gen, dtype=rdt,
                       device=device)
    gains = gains / gains.sum(-1, keepdim=True)
    angles = (torch.rand((n_batches, cfg.n_path), generator=gen, dtype=rdt,
                         device=device) - 0.5) * 180.0
    fs = sample_psd(angles, gains, cfg.n_antennas, cfg.path_sigma)
    h, t = channel_from_psd(gen, fs, cfg.n_antennas, cfg.n_coherence, dtype)
    if cfg.n_coherence == 1:
        h = h[..., 0, :]
    return h, t


def flatten_coherence(h: torch.Tensor, t: torch.Tensor = None):
    """Coherence blocks (B, T, N) -> snapshots (B*T, N), block-major (the T
    snapshots of a block are consecutive rows). With `t`, the per-block
    Toeplitz rows (B, N) are repeated for each snapshot of their block and
    (h_flat, t_flat) is returned. Single-snapshot (B, N) input passes
    through unchanged."""
    if h.dim() == 2:
        return (h, t) if t is not None else h
    b, n_coh, n = h.shape
    h_flat = h.reshape(b * n_coh, n)
    if t is None:
        return h_flat
    return h_flat, t.repeat_interleave(n_coh, dim=0)
