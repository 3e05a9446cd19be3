"""Scalar quantizer design (uniform + Lloyd-Max) and quantization ops.

Port of `quantized_channel_estimation_tpu/ops/quantizer.py`. Per-real-
component scalar quantization of complex observations; Lloyd-Max cells use
the same closed-form truncated-Gaussian moments as the JAX design. Labels
are bit-exact with the JAX package for the same input and tables:
`torch.searchsorted(..., right=True)` is `jnp.searchsorted(side='right')`,
and the 1-bit quantizer keeps the reference's sign(0) = 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

INF_BITS = math.inf

# J. Max, "Quantizing for minimum distortion", Table 2: optimal uniform step
# for a standard Gaussian, 1..8 bits.
_MAX_OPTIMAL_STEP = {1: 1.596, 2: 0.9957, 3: 0.5860, 4: 0.3352,
                     5: 0.1881, 6: 0.1041, 7: 0.0569, 8: 0.0308}


def is_inf_bits(n_bits) -> bool:
    return n_bits == INF_BITS or n_bits == "inf"


def standard_quantization_step(n_bits: int) -> float:
    """Optimal uniform step for N(0,1) input; asymptotic 4 sqrt(b) 2^-b past
    8 bits (Hui & Neuhoff)."""
    if n_bits in _MAX_OPTIMAL_STEP:
        return _MAX_OPTIMAL_STEP[n_bits]
    return 4.0 * math.sqrt(n_bits) * 2.0 ** (-n_bits)


def noise_variance(snr_db) -> float:
    """sigma^2 = 10^(-snr/10) for unit-power signals."""
    return 10.0 ** (-float(snr_db) / 10.0)


def uniform_step(snr_db, n_bits: int) -> float:
    """Per-SNR uniform step sqrt((1 + sigma^2)/2) * Delta_std (the /2 is the
    per-real-component share of a unit-power complex signal). Computed in
    float64 on the host, as the JAX design is under x64."""
    return math.sqrt((1.0 + noise_variance(snr_db)) / 2.0) \
        * standard_quantization_step(n_bits)


def uniform_step_tensor(snr_db: torch.Tensor, n_bits: int) -> torch.Tensor:
    """`uniform_step` of a tensor of SNRs (one a sample, the VAE's 'real'
    mode), on their device and in their dtype."""
    return torch.sqrt((1.0 + 10.0 ** (-snr_db / 10.0)) / 2.0) \
        * standard_quantization_step(n_bits)


class ScalarQuantizer(NamedTuple):
    """Symmetric scalar quantizer for one real component.

    thresholds: (2^b - 1,) increasing decision levels.
    labels:     (2^b,) reconstruction levels; bin i is
                (thresholds[i-1], thresholds[i]].
    rho:        scalar distortion factor (Lloyd design) or 0.
    """
    thresholds: torch.Tensor
    labels: torch.Tensor
    rho: torch.Tensor

    @property
    def n_levels(self) -> int:
        return self.labels.shape[-1]

    def to(self, device) -> "ScalarQuantizer":
        return ScalarQuantizer(*(x.to(device) for x in self))


def design_uniform(snr_db, n_bits: int, dtype=torch.float32,
                   device=None) -> ScalarQuantizer:
    """Uniform quantizer: thresholds at integer multiples of the per-SNR
    step, labels at cell midpoints."""
    zero = torch.zeros((), dtype=dtype, device=device)
    if n_bits == 1:
        s = 1.0 / math.sqrt(2.0)
        return ScalarQuantizer(torch.zeros((1,), dtype=dtype, device=device),
                               torch.tensor([-s, s], dtype=dtype,
                                            device=device), zero)
    delta = torch.tensor(uniform_step(snr_db, n_bits), dtype=dtype,
                         device=device)
    n_thresh = 2 ** n_bits - 1
    half = (2 ** n_bits - 2) / 2.0
    thresholds = (torch.arange(n_thresh, dtype=dtype, device=device)
                  - half) * delta
    labels = torch.cat([thresholds - delta / 2.0,
                        thresholds[-1:] + delta / 2.0])
    return ScalarQuantizer(thresholds, labels, zero)


def _phi(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _cdf(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _cell_moments(a, b, sigma, weights):
    """(mass, first moment) of a mixture of N(0, sigma^2) over cells [a, b]
    (b may be +inf)."""
    alpha = a[None, :] / sigma[:, None]
    beta = b[None, :] / sigma[:, None]
    inf_b = torch.isinf(beta)
    mass_m = _cdf(beta) - _cdf(alpha)
    first_m = sigma[:, None] * (_phi(alpha) - torch.where(
        inf_b, torch.zeros_like(beta), _phi(beta)))
    return ((weights[:, None] * mass_m).sum(0),
            (weights[:, None] * first_m).sum(0))


def _cell_distortion(a, b, c, sigma, weights):
    """sum_cells int_a^b (x - c)^2 p(x) dx for a mixture of N(0, sigma^2)."""
    alpha = a[None, :] / sigma[:, None]
    beta = b[None, :] / sigma[:, None]
    inf_b = torch.isinf(beta)
    phi_a = _phi(alpha)
    phi_b = torch.where(inf_b, torch.zeros_like(beta), _phi(beta))
    mass = _cdf(beta) - _cdf(alpha)
    z2 = mass + alpha * phi_a - torch.where(inf_b, torch.zeros_like(beta),
                                            beta * phi_b)
    s = sigma[:, None]
    per = s ** 2 * z2 + c[None, :] ** 2 * mass \
        - 2.0 * s * c[None, :] * (phi_a - phi_b)
    # the mixture weights each component's own distortion; the JAX design
    # multiplies every weight into the sum over ALL components
    # (`quantizer.py:156`), which differs from this for mixtures of more
    # than one variance (ROADMAP Queue 3)
    return (weights * per.sum(1)).sum()


def lloyd_max_positive_half(levels: int, variance, mixture_weights=None,
                            max_iter: int = 200, tol: float = 1e-5,
                            device=None):
    """Lloyd-Max clustering of the positive half of N(0, variance) (or a
    mixture of variances) into `levels` cells, in float32 like the JAX
    design. Returns (edges (levels+1,), centroids (levels,), rho)."""
    f32 = dict(dtype=torch.float32, device=device)
    variance = torch.atleast_1d(torch.as_tensor(variance, **f32))
    sigma = torch.sqrt(variance)
    weights = (torch.ones_like(sigma) / sigma.shape[0]
               if mixture_weights is None
               else torch.as_tensor(mixture_weights, **f32))
    max_int = torch.clamp(3.0 * variance.max(), 0.0, 100.0)
    edges = torch.cat([torch.linspace(0.0, float(max_int), levels, **f32),
                       torch.tensor([math.inf], **f32)])
    centroids = torch.zeros(levels, **f32)
    for _ in range(max_iter):
        a, b = edges[:-1], edges[1:]
        mass, first = _cell_moments(a, b, sigma, weights)
        midpoints = torch.where(torch.isinf(b), a + 1.0, 0.5 * (a + b))
        centroids = torch.where(mass > 1e-30,
                                first / torch.clamp(mass, min=1e-30),
                                midpoints)
        new_edges = torch.cat([edges[:1],
                               0.5 * (centroids[1:] + centroids[:-1]),
                               edges[-1:]])
        delta = torch.linalg.norm(edges[:-1] - new_edges[:-1])
        edges = new_edges
        if float(delta) < tol:
            break
    rho = _cell_distortion(edges[:-1], edges[1:], centroids, sigma, weights)
    return edges, centroids, rho


def design_lloyd(snr_db, n_bits: int, mixture_variances=None,
                 mixture_weights=None, dtype=torch.float32,
                 device=None) -> ScalarQuantizer:
    """Symmetric Lloyd-Max quantizer for the per-component marginal
    N(0, (1 + sigma^2)/2) (optionally a mixture of variances), mirrored to
    the negative axis."""
    sigma2 = noise_variance(snr_db)
    if mixture_variances is None:
        input_var = 0.5 * (1.0 + sigma2)
    else:
        input_var = 0.5 * (torch.as_tensor(mixture_variances).real + sigma2)
    levels = 2 ** n_bits // 2
    edges, centroids, rho = lloyd_max_positive_half(
        levels, input_var, mixture_weights, device=device)
    pos = edges[:-1]
    thresholds = torch.cat([-pos[1:].flip(0), pos]).to(dtype)
    labels = torch.cat([-centroids.flip(0), centroids]).to(dtype)
    return ScalarQuantizer(thresholds, labels, rho.to(dtype))


def design_quantizer(snr_db, n_bits, quantizer_type: str = "uniform",
                     mixture_variances=None, mixture_weights=None,
                     dtype=torch.float32,
                     device=None) -> Optional[ScalarQuantizer]:
    """The quantizer for one SNR point; None for n_bits = inf."""
    if is_inf_bits(n_bits):
        return None
    if n_bits == 1 or quantizer_type == "uniform":
        return design_uniform(snr_db, n_bits, dtype, device)
    if quantizer_type == "lloyd":
        return design_lloyd(snr_db, n_bits, mixture_variances,
                            mixture_weights, dtype, device)
    raise NotImplementedError(
        f"Quantizer type {quantizer_type!r} not implemented")


def quantize_real(x: torch.Tensor, q: ScalarQuantizer) -> torch.Tensor:
    """Bin a real tensor by the thresholds (right-closed cells, as
    `np.digitize` and `jnp.searchsorted(side='right')`) and emit labels."""
    thr = q.thresholds.to(x.dtype)
    idx = torch.searchsorted(thr, x.contiguous(), right=True)
    return q.labels.to(x.dtype)[idx]


def quantize(x: torch.Tensor, n_bits,
             q: Optional[ScalarQuantizer]) -> torch.Tensor:
    """Quantize a complex tensor per real component. n_bits=inf passes
    through; n_bits=1 is the sign quantizer (+-1/sqrt(2), sign(0) = 0)."""
    if is_inf_bits(n_bits):
        return x
    if n_bits == 1:
        s = torch.tensor(1.0 / math.sqrt(2.0), dtype=x.real.dtype,
                         device=x.device)

        def sign(v):
            out = torch.where(v >= 0, s, -s)
            return torch.where(v == 0, torch.zeros_like(v), out)
        return torch.complex(sign(x.real), sign(x.imag))
    return torch.complex(quantize_real(x.real, q), quantize_real(x.imag, q))
