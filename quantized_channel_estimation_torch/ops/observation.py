"""Quantized observation model r = Q(A h + n).

Port of `quantized_channel_estimation_tpu/ops/observation.py`
(`apply_pilots`, `observe`, `observe_random_snr`). Each draw is split from
the rest (`observe_noise`; `draw_random_snr` and `observe_random_snr_noise`)
so that a test can hand both packages the same draws.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch

from quantized_channel_estimation_torch.ops.cplx import crandn
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits, quantize)


def apply_pilots(h: torch.Tensor, a: Optional[torch.Tensor]) -> torch.Tensor:
    """y = A h for h (..., N); A (M, N), a 0-d tensor x (A = x I, which
    the structured banks take too, without the (N, N) matrix) or None
    (identity)."""
    if a is None:
        return h
    if a.dim() == 0:
        return a * h
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
    m = h.shape[-1] if a is None or a.dim() == 0 else a.shape[0]
    w = crandn(gen, h.shape[:-1] + (m,), dtype=h.dtype)
    return observe_noise(h, w, snr_db, a, n_bits, q)


class QuantizerTables(NamedTuple):
    """The stacked tables of one quantizer an SNR: thresholds (S, T) and
    labels (S, L), row s the design at the s-th SNR."""
    thresholds: torch.Tensor
    labels: torch.Tensor


def stack_quantizers(quantizers: List[ScalarQuantizer],
                     device=None) -> QuantizerTables:
    """`QuantizerTables` of a list of same-shaped designs."""
    return QuantizerTables(
        torch.stack([q.thresholds for q in quantizers]).to(device),
        torch.stack([q.labels for q in quantizers]).to(device))


def quantize_rows(y: torch.Tensor, thresholds: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Quantize each row y[b] (any trailing shape) per real component by its
    own tables thresholds[b] (B, T), labels[b] (B, L): right-closed cells,
    as `quantize_real`."""
    shape = y.shape
    flat = y.reshape(shape[0], -1)
    thr = thresholds.to(flat.real.dtype).contiguous()
    lab = labels.to(flat.real.dtype)

    def one(x):
        idx = torch.searchsorted(thr, x.contiguous(), right=True)
        return torch.gather(lab, 1, idx)
    return torch.complex(one(flat.real), one(flat.imag)).reshape(shape)


def draw_random_snr(gen: torch.Generator, batch: int, n_snrs: int,
                    obs_shape, snr_probs: Optional[torch.Tensor] = None,
                    dtype=torch.complex64):
    """The draws of `observe_random_snr`: an SNR index a sample, uniform or
    by `snr_probs`, and white noise w ~ CN(0, I) of the observation's shape
    (batch first), on the generator's device."""
    if snr_probs is not None:
        probs = torch.as_tensor(snr_probs, dtype=torch.float32,
                                device=gen.device)
        idx = torch.multinomial(probs, batch, replacement=True,
                                generator=gen)
    else:
        idx = torch.randint(0, n_snrs, (batch,), generator=gen,
                            device=gen.device)
    return idx, crandn(gen, tuple(obs_shape), dtype=dtype)


def observe_random_snr_noise(h: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor, snrs_db: torch.Tensor,
                             a: Optional[torch.Tensor], n_bits,
                             quantizers: Union[List[ScalarQuantizer],
                                               QuantizerTables, None] = None,
                             return_tables: bool = False):
    """r = Q_s(A h + 10^(-snr_s/20) w) for given SNR indices idx (B,) into
    `snrs_db` and noise w: the noise amplitude broadcasts over every
    trailing axis (h (B, N) or coherence blocks (B, T, N)), and each row is
    quantized by the tables of its own SNR. Returns (r, snr per sample), or
    with `return_tables` (r, snr, thresholds (B, T), labels (B, L)); the
    tables are None at inf and 1 bit, which have none."""
    snrs_db = torch.as_tensor(snrs_db, dtype=torch.float32, device=h.device)
    snr = snrs_db[idx]
    y = apply_pilots(h, a)
    amp = (10.0 ** (-snr / 20.0)).to(y.real.dtype)
    y = y + amp.reshape((-1,) + (1,) * (y.dim() - 1)) * w
    if is_inf_bits(n_bits) or n_bits == 1:
        r = quantize(y, n_bits, None)
        return (r, snr, None, None) if return_tables else (r, snr)
    if not isinstance(quantizers, QuantizerTables):
        quantizers = stack_quantizers(quantizers, h.device)
    thresholds = quantizers.thresholds[idx]
    labels = quantizers.labels[idx]
    r = quantize_rows(y, thresholds, labels)
    return (r, snr, thresholds, labels) if return_tables else (r, snr)


def observe_random_snr(gen: torch.Generator, h: torch.Tensor,
                       snrs_db, a: Optional[torch.Tensor], n_bits,
                       quantizers=None, snr_probs=None,
                       return_tables: bool = False):
    """Per-sample random SNR draw from a discrete set (SNR-robust VAE
    training): `draw_random_snr` from `gen`, then
    `observe_random_snr_noise`. `quantizers`: one `ScalarQuantizer` an SNR
    (same shapes), or their `stack_quantizers` tables."""
    snrs_db = torch.as_tensor(snrs_db, dtype=torch.float32, device=h.device)
    m = h.shape[-1] if a is None or a.dim() == 0 else a.shape[0]
    idx, w = draw_random_snr(gen, h.shape[0], snrs_db.shape[0],
                             h.shape[:-1] + (m,), snr_probs, h.dtype)
    return observe_random_snr_noise(h, idx, w, snrs_db, a, n_bits,
                                    quantizers, return_tables)
