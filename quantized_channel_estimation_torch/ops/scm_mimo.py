"""3GPP SCM MIMO channels under the Kronecker model, batched.

Port of `quantized_channel_estimation_tpu/ops/scm_mimo.py` (`ScmMimoConfig`,
`genie_toeplitz_rows`, `color_kron`, `generate_channels_mimo`,
`generate_channels_mimo_chunked`). Channels between an `n_antennas_ms`-
element mobile and an `n_antennas_bs`-element base-station ULA: per
sample an angular Laplace-mixture PSD is sampled at each link end (shared
cluster gains, independent angles), giving Toeplitz covariances C_BS and
C_MS, and the vectorized channel has covariance kron(C_MS, C_BS) (index
i_ms * N_BS + i_bs). With L_BS L_BS^H = C_BS and L_MS L_MS^H = C_MS,
kron(L_MS, L_BS) colors white noise, so h = vec(L_BS X L_MS^T): two small
batched Cholesky factorizations (the jitter ladder
`linalg.robust_chol_lower`, for the numerically rank-deficient truncated
Toeplitz matrices of narrow spreads) and two batched products; the dense
kron is never formed.

As in `ops.scm`, each generator is split into its draws (`mimo_draws`) and
the deterministic transform (`generate_channels_mimo_from_draws`,
`color_kron_from_noise`), so the transforms are compared with the JAX
package on shared draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from quantized_channel_estimation_torch.ops import linalg
from quantized_channel_estimation_torch.ops.cplx import crandn, real_dtype_of
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.scm import (
    generate_channels_chunked, sample_psd)


class ScmMimoConfig(NamedTuple):
    n_antennas_bs: int
    n_antennas_ms: int
    n_path: int = 3
    path_sigma_bs: float = 2.0   # BS-side angular spread (deg std)
    path_sigma_ms: float = 35.0  # MS-side angular spread (deg std)
    n_coherence: int = 1


def genie_toeplitz_rows(fs_bs: torch.Tensor, fs_ms: torch.Tensor,
                        n_bs: int, n_ms: int, dtype=torch.complex64):
    """First rows of each sample's Toeplitz covariance at each link end:
    t = FFT(fs) / F truncated to N. The rows are copies: a view of the
    first N of F = 100 N bins would keep the whole lattice alive."""
    t_bs = (torch.fft.fft(fs_bs.to(dtype), dim=-1)
            / fs_bs.shape[-1])[..., :n_bs].clone()
    t_ms = (torch.fft.fft(fs_ms.to(dtype), dim=-1)
            / fs_ms.shape[-1])[..., :n_ms].clone()
    return t_bs, t_ms


def coloring_factors(t_bs: torch.Tensor, t_ms: torch.Tensor):
    """(L_BS, L_MS): the jittered lower Cholesky factors of toeplitz(t_bs)
    and toeplitz(t_ms)."""
    return (linalg.robust_chol_lower(linalg.toeplitz_from_first_row(t_bs)),
            linalg.robust_chol_lower(linalg.toeplitz_from_first_row(t_ms)))


def color_kron_from_noise(t_bs: torch.Tensor, t_ms: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """vec(L_BS X L_MS^T) for white X (..., n_coherence, N_BS, N_MS):
    samples of CN(0, kron(toeplitz(t_ms), toeplitz(t_bs))) in layout
    i_ms * N_BS + i_bs. Returns (..., n_coherence, N_BS * N_MS); the
    products in full fp32 (TF32 off)."""
    pin_fp32()
    l_bs, l_ms = coloring_factors(t_bs.to(x.dtype), t_ms.to(x.dtype))
    y = l_bs[..., None, :, :] @ x @ l_ms[..., None, :, :].transpose(-1, -2)
    return y.transpose(-1, -2).reshape(*y.shape[:-2], -1)


def color_kron(gen: torch.Generator, t_bs: torch.Tensor, t_ms: torch.Tensor,
               n_coherence: int = 1, dtype=torch.complex64) -> torch.Tensor:
    """`color_kron_from_noise` with the white noise drawn from `gen`."""
    x = crandn(gen, t_bs.shape[:-1] + (n_coherence, t_bs.shape[-1],
                                       t_ms.shape[-1]), dtype=dtype)
    return color_kron_from_noise(t_bs, t_ms, x)


class MimoDraws(NamedTuple):
    """The random draws of one MIMO batch of B samples and P paths: u_gains,
    u_bs, u_ms (B, P) ~ U(0, 1) (cluster gains, BS and MS angles) and
    x (B, n_coherence, N_BS, N_MS) ~ CN(0, 1)."""
    u_gains: torch.Tensor
    u_bs: torch.Tensor
    u_ms: torch.Tensor
    x: torch.Tensor


def mimo_draws(gen: torch.Generator, n_batches: int, cfg: ScmMimoConfig,
               dtype=torch.complex64) -> MimoDraws:
    """Draw one MIMO batch from `gen` on its device."""
    rdt = real_dtype_of(dtype)
    shape = (n_batches, cfg.n_path)
    u = [torch.rand(shape, generator=gen, dtype=rdt, device=gen.device)
         for _ in range(3)]
    x = crandn(gen, (n_batches, cfg.n_coherence, cfg.n_antennas_bs,
                     cfg.n_antennas_ms), dtype=dtype)
    return MimoDraws(*u, x)


def generate_channels_mimo_from_draws(d: MimoDraws, cfg: ScmMimoConfig):
    """The Kronecker-model channels of a batch's draws. Per sample: n_path
    cluster gains U(0, 1) normalized to sum 1 and shared by both ends;
    angles U(-90, 90) deg drawn per end. Returns (h, t_bs, t_ms): h
    (B, n_coherence, N_BS * N_MS), or (B, N_BS * N_MS) when
    n_coherence == 1, and the Toeplitz first rows (B, N_BS), (B, N_MS);
    kron(toeplitz(t_ms), toeplitz(t_bs)) is the genie covariance."""
    gains = d.u_gains / d.u_gains.sum(-1, keepdim=True)
    fs_bs = sample_psd((d.u_bs - 0.5) * 180.0, gains, cfg.n_antennas_bs,
                       cfg.path_sigma_bs)
    fs_ms = sample_psd((d.u_ms - 0.5) * 180.0, gains, cfg.n_antennas_ms,
                       cfg.path_sigma_ms)
    t_bs, t_ms = genie_toeplitz_rows(fs_bs, fs_ms, cfg.n_antennas_bs,
                                     cfg.n_antennas_ms, d.x.dtype)
    del fs_bs, fs_ms
    h = color_kron_from_noise(t_bs, t_ms, d.x)
    if cfg.n_coherence == 1:
        h = h[..., 0, :]
    return h, t_bs, t_ms


def generate_channels_mimo(gen: torch.Generator, n_batches: int,
                           cfg: ScmMimoConfig, dtype=torch.complex64):
    """A batch of Kronecker-model MIMO channels on the generator's device:
    `generate_channels_mimo_from_draws` on fresh draws."""
    return generate_channels_mimo_from_draws(
        mimo_draws(gen, n_batches, cfg, dtype), cfg)


def generate_channels_mimo_chunked(gen: torch.Generator, n_batches: int,
                                   cfg: ScmMimoConfig, chunk: int = 4096,
                                   dtype=torch.complex64):
    """MIMO generation in chunks of at most `chunk` samples (bounding the
    (chunk, 100 N) PSD lattices): (h, t_bs, t_ms)."""
    return generate_channels_chunked(gen, n_batches, cfg, chunk, dtype,
                                     generator=generate_channels_mimo)
