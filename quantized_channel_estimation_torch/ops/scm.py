"""3GPP spatial channel model (SCM) simulation, batched.

Port of `quantized_channel_estimation_tpu/ops/scm.py` (`ScmConfig`,
`_laplace_mixture`, `angular_psd`, `sample_psd`, `channel_from_psd`,
`generate_channels`, `flatten_coherence`, `UrbanMacroConfig`,
`generate_channels_urban_macro`, `generate_channels_chunked`). ULA
channels are white noise colored by the square root of an angular power
spectral density (wrapped Laplace mixture through the ULA arcsine map),
sampled on a 100x oversampled frequency lattice and IFFT-truncated to the
array. Returns the channels and the first row of each sample's Toeplitz
covariance (the genie covariance of genie-BLMMSE).

The urban-macro generator is split into its random draws
(`urban_macro_draws`) and the deterministic transform of them
(`generate_channels_urban_macro_from_draws`), as `channel_from_psd` is
split from `channel_from_noise`: the JAX package draws from threefry keys
and the port from a `torch.Generator`, so the transforms are compared on
shared draws and the samplers by their statistics.
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


def generate_channels_chunked(gen: torch.Generator, n_batches: int,
                              cfg, chunk: int = 8192, dtype=torch.complex64,
                              generator=None):
    """Channel generation in chunks of at most `chunk` samples, bounding the
    (chunk, 100 N) PSD lattice and its FFT buffers; the chunks' outputs
    (each generator's tuple) are concatenated. `generator` is the one-batch
    generator (`generate_channels` by default; the urban-macro and MIMO
    ones take the same arguments)."""
    generator = generator or generate_channels
    outs = [generator(gen, min(chunk, n_batches - i0), cfg, dtype)
            for i0 in range(0, n_batches, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


class UrbanMacroConfig(NamedTuple):
    """3GPP urban-macro 15-degree parameterization: lognormal delay and
    angular spreads, per-path shadow fading, and a path loss drawn from
    distances of 1000-1500 m."""
    n_antennas: int
    mu_as: float = 1.18     # lognormal angular-spread mean (log10 deg)
    eps_as: float = 0.21    # lognormal angular-spread std
    r_as: float = 1.3       # AoD spread multiplier
    path_sigma: float = 2.82843  # per-path Laplace angular spread (deg std)
    mu_ds: float = -6.18    # lognormal delay-spread mean (log10 s)
    eps_ds: float = 0.18    # lognormal delay-spread std
    r_ds: float = 1.7       # delay distribution multiplier
    eps_pl: float = 35.0    # 10 x path-loss exponent
    n_paths: int = 6
    n_coherence: int = 1
    min_dist: float = 1000.0  # m
    max_dist: float = 1500.0


class UrbanMacroDraws(NamedTuple):
    """The random draws of one urban-macro batch of B samples and P paths:
    u_theta (B,) ~ U(0, 1) user angle, z_ds (B,) ~ N(0, 1) delay spread,
    e_tau (B, P) ~ Exp(1) path delays, z_shadow (B, P) ~ N(0, 1) shadow
    fading, z_as (B,) ~ N(0, 1) angular spread, z_aod (B, P) ~ N(0, 1) AoD
    offsets, x (B, n_coherence, 100 N) ~ CN(0, 1) white noise, u_dist (B,)
    ~ U(0, 1) distance."""
    u_theta: torch.Tensor
    z_ds: torch.Tensor
    e_tau: torch.Tensor
    z_shadow: torch.Tensor
    z_as: torch.Tensor
    z_aod: torch.Tensor
    x: torch.Tensor
    u_dist: torch.Tensor


def urban_macro_draws(gen: torch.Generator, n_batches: int,
                      cfg: UrbanMacroConfig,
                      dtype=torch.complex64) -> UrbanMacroDraws:
    """Draw one urban-macro batch from `gen` on its device (the real draws
    in the real dtype of `dtype`; the delays from `Tensor.exponential_`)."""
    device, rdt = gen.device, real_dtype_of(dtype)
    b, p = n_batches, cfg.n_paths

    def uniform(*shape):
        return torch.rand(shape, generator=gen, dtype=rdt, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=rdt, device=device)

    u_theta, z_ds = uniform(b), normal(b)
    e_tau = torch.empty((b, p), dtype=rdt, device=device).exponential_(
        generator=gen)
    z_shadow, z_as, z_aod = normal(b, p), normal(b), normal(b, p)
    x = crandn(gen, (b, cfg.n_coherence, OVERSAMPLING * cfg.n_antennas),
               dtype=dtype)
    return UrbanMacroDraws(u_theta, z_ds, e_tau, z_shadow, z_as, z_aod, x,
                           uniform(b))


def generate_channels_urban_macro_from_draws(d: UrbanMacroDraws,
                                             cfg: UrbanMacroConfig):
    """The urban-macro channels of a batch's draws. Per sample: user angle
    theta ~ U(-60, 60) deg; delay spread DS lognormal; path delays
    r_DS DS Exp(1), sorted and offset to 0; path powers decaying
    exponentially over delay with 3 dB lognormal shadow fading, normalized;
    AoD offsets ~ N(0, (r_AS AS)^2) with AS lognormal, ordered by magnitude
    (powers keep their delay order); the Laplace-PSD synthesis at
    `path_sigma`; and a path-loss factor beta from a distance
    U(min_dist, max_dist) (h scaled by sqrt(beta), the Toeplitz row t by
    beta). Returns (h (B, n_coherence, N), or (B, N) when n_coherence == 1,
    t (B, N)); h in the noise's dtype."""
    dtype = d.x.dtype
    theta = (d.u_theta - 0.5) * 120.0
    ds = 10.0 ** (cfg.mu_ds + cfg.eps_ds * d.z_ds)
    tau = torch.sort(cfg.r_ds * ds[:, None] * d.e_tau, dim=-1,
                     stable=True).values
    tau = tau - tau[:, :1]
    exponent = -(cfg.r_ds - 1.0) / cfg.r_ds / ds
    powers = (torch.exp(exponent[:, None] * tau)
              * 10.0 ** (0.1 * (3.0 * d.z_shadow)))
    powers = powers / powers.sum(-1, keepdim=True)
    as_deg = 10.0 ** (cfg.mu_as + cfg.eps_as * d.z_as)
    aod = d.z_aod * (cfg.r_as * as_deg)[:, None]
    aod = torch.take_along_dim(
        aod, torch.argsort(aod.abs(), dim=-1, stable=True), dim=-1)
    fs = sample_psd(theta[:, None] + aod, powers, cfg.n_antennas,
                    cfg.path_sigma)
    h, t = channel_from_noise(fs, d.x, cfg.n_antennas)
    dist = d.u_dist * (cfg.max_dist - cfg.min_dist) + cfg.min_dist
    beta = 10.0 ** (-0.1 * (cfg.eps_pl * torch.log10(dist / cfg.max_dist)))
    h = h * torch.sqrt(beta)[:, None, None].to(dtype)
    t = t * beta[:, None].to(dtype)
    if cfg.n_coherence == 1:
        h = h[..., 0, :]
    return h, t


def generate_channels_urban_macro(gen: torch.Generator, n_batches: int,
                                  cfg: UrbanMacroConfig,
                                  dtype=torch.complex64):
    """A batch of urban-macro channels on the generator's device: (h, t) of
    `generate_channels_urban_macro_from_draws` on fresh draws."""
    return generate_channels_urban_macro_from_draws(
        urban_macro_draws(gen, n_batches, cfg, dtype), cfg)
