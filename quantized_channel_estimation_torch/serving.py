"""Continuous-batching service for channel-estimation requests.

Port of `quantized_channel_estimation_tpu/serving.py`:
`ServiceOverloadedError`, `ServiceClosedError`, `_Metrics`, `_Request` and
`EstimationService` with a dense GMM bank, with `structured=True` /
`from_circulant_spectra` the FFT-domain circulant bank of
`models.structured_bank`, or with `factored=True` / `from_mfa` the factored
(Woodbury) bank of an MFA prior (`models.mfa_bank`), on one device or over
an in-process mesh (`mesh=`). Requests of any size are queued per (SNR, T),
coalesced into power-of-two microbatches of at most `max_batch` snapshots
(a coherence block is never split), and flushed when a queue fills or its
oldest request is older than `max_delay_ms`. Banks are prepared per
snapped SNR and kept in an LRU cache together with their kernel layouts,
lowered once per (T, alpha).

On the service's device (the CUDA card unless `device` says otherwise) the
estimates run through the hand-written kernels: 'all'-mode flat requests
through K1, (n, T, M) coherence blocks through K3 (T beyond its range
through the einsum estimator), int top-k modes through K4; float
cumulative-p modes, and selection modes on blocks, through the einsum
estimators. A structured service runs 'all'-mode flat requests through the
circulant kernel K6 and blocks through K7 (within
`circ_kernels.circ_kernel_eligible`: D <= 672, past D = 128 their wide
form), with a multi-pilot kron(x, I) matrix
through the two forms of K10 (within
`mp_circ_kernels.mp_circ_kernel_eligible`), and every selection mode through
the `torch.fft` pipeline. A factored service runs 'all'-mode flat requests
through K11 and blocks through K12 (within
`fact_kernels.fact_kernel_eligible`), and selection modes through the
`torch.matmul` pipeline. On the CPU the same dispatch reaches the kernels'
plain versions. A worker thread computes on the service's device and its
own CUDA stream; every fault reaches the waiting clients through their
request.

With `mesh=parallel.mesh.make_local_mesh(n_data, n_component)` ('all'
mode, or on a dense bank an int top-k mode within
`kernels.topk_mode_eligible`) every microbatch runs split: its rows over
"data", the bank's components over "component", each component shard
through its stats kernel on its own CUDA stream (K2 flat and coherent for
a dense bank, K8 / K9 for a single-pilot circulant one, K13 for flat
factored requests; the pipelines' stats forms for a multi-pilot circulant
bank and factored blocks), the shard states merged with
`kernels.merge_stats` (`parallel.mesh.estimate_sharded_kernel` /
`_circulant` / `_factored`); in a top-k mode each dense shard's flat rows
through K5, the candidates merged with `kernels.merge_topk`, and blocks
through the einsum estimator (`parallel.mesh.estimate_sharded`).
Each bank shard's kernel layouts are kept with the bank. The service is one
process: a `torch.distributed` `DeviceMesh` is refused.

`VaeEstimationService` serves a trained VAE prior (noisy and real modes)
on the same runtime: each microbatch through `models.vae.estimate` (the
per-sample circulant algebra for A = x0 I, else the dense per-sample
solve); it launches no kernel of the port.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from quantized_channel_estimation_torch.estimators import (
    circ_kernels, fact_kernels, kernels, mp_circ_kernels)
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.harness.stages import resolve_device
from quantized_channel_estimation_torch.models import (
    gmm, gmm_estimator, mfa, mfa_bank, structured_bank)
from quantized_channel_estimation_torch.models.gmm_estimator import (
    PreparedBank)
from quantized_channel_estimation_torch.models.mfa_bank import FactoredBank
from quantized_channel_estimation_torch.models.structured_bank import (
    CirculantBank, CirculantBankMP)
from quantized_channel_estimation_torch.ops import observation
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.parallel import mesh as pmesh


class ServiceOverloadedError(RuntimeError):
    """Raised by submit() when the pending-sample queue exceeds its
    high-water mark: explicit load shedding instead of unbounded memory
    growth and blind latency."""


class ServiceClosedError(RuntimeError):
    """Raised by submit() on a closing or closed service, and delivered to
    requests still queued when `close(drain=False)` fails them fast."""


# latency histogram bucket upper bounds (seconds); +inf implicit
_MESH_MODES = ("mesh-backed serving computes the 'all'-mode merge, or on a "
               "dense bank an int top-k mode within "
               "kernels.topk_mode_eligible (got mode={!r})")
_LATENCY_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2,
                    0.5, 1.0, 2.0, 5.0)


class _Metrics:
    """Internal counters; mutated under the service lock (submit side) or
    by the single serving thread (completion side)."""

    def __init__(self):
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_failed = 0
        self.requests_shed = 0
        self.estimates_served = 0      # snapshots, not requests
        self.microbatches = 0
        self.bank_cache_hits = 0
        self.bank_cache_misses = 0
        self.latency_counts = [0] * (len(_LATENCY_BUCKETS) + 1)
        self.latency_sum = 0.0

    def observe_latency(self, seconds: float):
        self.latency_counts[bisect.bisect_left(_LATENCY_BUCKETS,
                                               seconds)] += 1
        self.latency_sum += seconds

    def quantile(self, p: float) -> float:
        """Histogram-quantile estimate (upper bucket bound, the
        conservative Prometheus convention)."""
        total = sum(self.latency_counts)
        if total == 0:
            return 0.0
        rank = p * total
        acc = 0
        for i, c in enumerate(self.latency_counts):
            acc += c
            if acc >= rank:
                return (_LATENCY_BUCKETS[i] if i < len(_LATENCY_BUCKETS)
                        else float("inf"))
        return float("inf")


@dataclass
class _Request:
    r: np.ndarray                 # (n, M) or (n, T, M) complex observations
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


class _BankEntry(NamedTuple):
    """A cached per-SNR bank and its kernel layouts (the `kernels.lowered`
    or `fact_kernels.lowered` cache keyed by (T, alpha), or for a
    structured bank the `circ_kernels.lowered` / `mp_circ_kernels.lowered`
    cache keyed by (blocks, T, alpha)); on a mesh one such cache a
    component shard (`shards`)."""
    bank: Union[PreparedBank, CirculantBank, CirculantBankMP, FactoredBank]
    lowered: dict
    shards: Tuple[dict, ...] = ()


class EstimationService:
    """Microbatching front-end over a prepared GMM bank.

    submit() is thread-safe and blocks until the estimate is ready; a
    background thread coalesces outstanding requests per (SNR, T) into
    padded microbatches and computes them on the service's device.
    """

    def __init__(self, params: gmm.GmmParams, a, n_bits,
                 quantizer_type="uniform", max_batch: int = 4096,
                 max_delay_ms: float = 5.0,
                 use_kernels: Optional[bool] = None, mode="all",
                 max_banks: int = 64, snr_step_db: Optional[float] = 0.1,
                 max_queue: int = 262_144,
                 coherence_alpha: Union[float, str] = 1.0,
                 alpha_val: Optional[np.ndarray] = None,
                 mesh=None, structured: bool = False,
                 structured_blocks=None, factored: bool = False,
                 device=None):
        """params: the GMM (tensors or numpy arrays; moved to `device`), or
        with `factored=True` an `mfa.MfaParams`;
        a: the (M, N) pilot matrix, or the scalar x0 for A = x0 I (a
        structured service takes A = x0 I or a multi-pilot kron(x, I), a
        factored one A = x0 I). max_banks: LRU
        cap on cached per-SNR banks. snr_step_db: submitted SNRs snap to
        this grid before bank lookup, so nearby floats share one bank; None
        disables.
        max_queue: high-water mark on pending snapshots across queues;
        submit() raises ServiceOverloadedError beyond it.
        use_kernels: None uses the kernels wherever the mode allows
        ('all', or an int top-k mode within `kernels.topk_mode_eligible`);
        True raises for a mode they cannot compute; False serves through
        the einsum estimators. structured: serve through the FFT-domain
        circulant bank (`models.structured_bank`: exact for circulant and
        block-circulant fits under a kron(x, I) pilot);
        `structured_blocks` selects the kron basis of block-circulant fits;
        the kernels are then the circulant ones ('all' mode within
        `circ_kernels.circ_kernel_eligible`, or for P > 1 pilots
        `mp_circ_kernels.mp_circ_kernel_eligible`). factored: serve an MFA
        prior through the factored (Woodbury) bank (`models.mfa_bank`: exact
        for n-bit and unquantized observations under A = x0 I; 1-bit is
        refused here); the kernels are then K11 / K12 ('all' mode within
        `fact_kernels.fact_kernel_eligible`), and `use_kernels` names them
        as it names the dense and circulant ones. coherence_alpha: evidence
        blend for (n, T, M)
        block requests (1 the block posterior, 0 independent snapshots), or
        'auto' to select it per (SNR, T) from
        `gmm_estimator.DEFAULT_ALPHA_GRID` by NMSE on `alpha_val`, real
        held-out channel blocks (n, T, D). device: as
        `stages.resolve_device` (the CUDA card by default; raises without
        one)."""
        if structured and factored:
            raise ValueError("structured and factored are mutually "
                             "exclusive bank representations")
        if factored and not Q.is_inf_bits(n_bits) and n_bits == 1:
            # fail at construction, not in the serving thread at the first
            # submit: the factored prepare refuses 1-bit
            raise ValueError(
                "factored serving does not support 1-bit quantization "
                "(arcsine destroys the low-rank structure); use the dense "
                "bank: from_mfa(..., factored=False)")
        if mesh is not None and not isinstance(mesh, pmesh.LocalMesh):
            raise ValueError(
                "the service is one process: mesh= takes the in-process mesh "
                "of parallel.mesh.make_local_mesh(n_data, n_component), not "
                f"{type(mesh).__name__} (a torch.distributed DeviceMesh "
                "serves through the harness stages instead)")
        if mesh is not None and mode != "all" and (
                structured or factored or not isinstance(mode, int)
                or isinstance(mode, bool)):
            raise ValueError(_MESH_MODES.format(mode))
        n_data = 1 if mesh is None else mesh.shape[pmesh.DATA_AXIS]
        if n_data & (n_data - 1):
            # microbatches are padded to powers of two
            raise ValueError(f"the mesh's data axis must be a power of two "
                             f"(got {n_data})")
        self.device = resolve_device(device)
        if (mesh is not None and mesh.device is not None
                and mesh.device != self.device):
            raise ValueError(f"the mesh's shards are on {mesh.device}; the "
                             f"service runs on {self.device}")
        self.mesh = mesh
        n_comp = 1 if mesh is None else mesh.shape[pmesh.COMPONENT_AXIS]
        if factored:
            self.params = mfa.MfaParams(*(torch.as_tensor(
                x, device=self.device) for x in params))
            dtype = self.params.lambdas.dtype
        else:
            self.params = gmm.GmmParams(*(torch.as_tensor(
                x, device=self.device) for x in params))
            dtype = self.params.covariances.dtype
        k_comp, d = self.params.means.shape
        if k_comp % n_comp:
            raise ValueError(f"the bank's {k_comp} components must divide "
                             f"over the mesh's {n_comp} component shards")
        k_shard = k_comp // n_comp
        a = torch.as_tensor(a, device=self.device).to(dtype)
        if a.dim() == 0:   # a scalar pilot is x0 I
            a = a * torch.eye(d, dtype=a.dtype, device=self.device)
        if a.dim() != 2:
            raise ValueError(f"the pilot matrix must be (M, N); got shape "
                             f"{tuple(a.shape)}")
        self.a = a
        self.n_bits = n_bits
        self.quantizer_type = quantizer_type
        self.mode = mode
        self.structured = structured
        self.structured_blocks = structured_blocks
        self.factored = factored
        self._spectra = None   # set by `from_circulant_spectra`
        m = self.a.shape[0]
        if factored:
            # the factored bank is exact only for A = x0 I: refuse any
            # other matrix here, like the 1-bit guard above
            structured_bank._pilot_scalar(self.a, d)
            rank = self.params.lambdas.shape[-1]
            kernel_ok = (mode == "all"
                         and fact_kernels.fact_kernel_eligible(d, k_shard,
                                                               rank))
            if use_kernels and not kernel_ok:
                raise ValueError(
                    "use_kernels=True on a factored service requires "
                    "mode='all' and (D, M) within the factored kernels' "
                    f"range (got mode={mode!r}, D={d}, M={rank})")
        elif structured:
            # fail at construction, not in the serving thread at the first
            # submit: the circulant banks take A = kron(x, I) only
            p = structured_bank._pilot_vector(self.a, d).shape[0]
            # a mesh runs multi-pilot shards through the pipeline: K10 has
            # no stats form
            kernel_ok = mode == "all" and (
                circ_kernels.circ_kernel_eligible(d, k_shard) if p == 1
                else mesh is None
                and mp_circ_kernels.mp_circ_kernel_eligible(d, k_comp, p))
            if use_kernels and not kernel_ok:
                raise ValueError(
                    "use_kernels=True on a structured service requires "
                    "mode='all' and (D, K, P) within the circulant kernels' "
                    f"range (got mode={mode!r}, D={d}, K={k_comp}, P={p})")
        else:
            kernel_ok = (kernels.fused_kernel_eligible(d, m)
                         if mode == "all" else kernels.topk_mode_eligible(
                             d, k_comp, m, mode))
            if mesh is not None and mode != "all" and not kernel_ok:
                raise ValueError(_MESH_MODES.format(mode))
            if use_kernels and not kernel_ok:
                # the kernels compute the 'all' combine and int top-k
                # selections; serving 'all' results for another mode would
                # be wrong answers, not slow ones
                raise ValueError(
                    "use_kernels=True requires mode='all' or an int top-k "
                    f"mode with 1 <= k <= min({kernels.TOPK_KERNEL_MAX}, "
                    f"K-1), and 2M <= {kernels.WIDE_MAX_TWO_M} at any D "
                    "(2M, 2D past 256: the kernels' wide form) (got "
                    f"mode={mode!r}, K={k_comp}, M={m}, D={d})")
        self.use_kernels = kernel_ok if use_kernels is None else use_kernels
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._init_runtime(max_batch, max_delay_ms, max_banks, snr_step_db,
                           max_queue, coherence_alpha, alpha_val)
        if (mesh is not None and coherence_alpha == "auto"
                and self.alpha_val.shape[0]
                < mesh.shape[pmesh.DATA_AXIS]):
            raise ValueError(
                f"alpha_val has {self.alpha_val.shape[0]} blocks; the mesh "
                f"data axis needs at least {mesh.shape[pmesh.DATA_AXIS]}")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _init_runtime(self, max_batch, max_delay_ms, max_banks, snr_step_db,
                      max_queue, coherence_alpha=1.0, alpha_val=None):
        """Queue, cache, lifecycle and metrics state."""
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        self.max_banks = max_banks
        self.snr_step = snr_step_db
        self.max_queue = max_queue
        self.coherence_alpha = coherence_alpha
        if coherence_alpha == "auto":
            if alpha_val is None:
                raise ValueError(
                    "coherence_alpha='auto' needs alpha_val: held-out real "
                    "channel blocks (n, T, D); model-drawn samples cannot "
                    "reveal model mismatch, so there is nothing to select "
                    "on without them")
            alpha_val = np.asarray(alpha_val)
            if alpha_val.ndim != 3:
                raise ValueError(f"alpha_val must be (n, T, D) blocks; got "
                                 f"shape {alpha_val.shape}")
        elif not isinstance(coherence_alpha, (int, float)):
            raise ValueError(f"coherence_alpha must be a float or 'auto'; "
                             f"got {coherence_alpha!r}")
        self.alpha_val = alpha_val
        self._alpha_cache: dict = {}
        self._banks: "OrderedDict[float, _BankEntry]" = OrderedDict()
        # queues are keyed by (snapped snr, T), T=None for flat (n, M)
        # requests, so blocks only co-batch with same-T blocks
        self._queues: "OrderedDict[Tuple[float, Optional[int]], List[Tuple[float, _Request]]]" = (
            OrderedDict())
        self._pending = 0  # total queued snapshots, guarded by _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._closing = False
        self._drain_on_close = True
        self._metrics = _Metrics()

    @classmethod
    def from_circulant_spectra(cls, weights, means, spectra, a, n_bits,
                               **kwargs):
        """Serve a spectra-native circulant prior: any (weights (K,), means
        (K, D), spectra (K, D)) triple goes straight into the structured
        service; no dense (K, D, D) covariance is ever built, so the memory
        of a per-SNR bank stays O(K D)."""
        k = np.asarray(weights).shape[0]
        dummy = np.zeros((k, 1, 1), np.complex64)
        svc = cls(gmm.GmmParams(np.asarray(weights), np.asarray(means),
                                dummy, dummy), a, n_bits, structured=True,
                  **kwargs)
        # the banks are prepared from the stored spectra (the covariances
        # are placeholders); the worker reads them at its first request
        svc._spectra = torch.as_tensor(np.asarray(spectra),
                                       device=svc.device)
        return svc

    @classmethod
    def from_mfa(cls, mfa_params, a, n_bits, reg: float = 1e-6,
                 factored: Optional[bool] = None, **kwargs):
        """Serve an MFA prior. factored=True (the default for n-bit and
        unquantized observations under A = x0 I) keeps the factor model
        factored end to end: per-SNR Woodbury banks and O(N K D M)
        estimation through K11 / K12 (`models.mfa_bank`). factored=False,
        and by default 1-bit or any other pilot matrix, densifies once
        (`mfa.to_gmm_params` with jitter `reg`) and serves the dense bank.
        `use_kernels` names the kernels of whichever bank is served (the
        JAX `use_pallas=True` forces the dense bank instead)."""
        if factored is None:
            factored = Q.is_inf_bits(n_bits) or n_bits != 1
            if factored:
                try:   # the factored bank needs A = x0 I
                    structured_bank._pilot_scalar(a, mfa_params[3].shape[-1])
                except ValueError:
                    factored = False
        if factored:
            return cls(mfa_params, a, n_bits, factored=True, **kwargs)
        dev = resolve_device(kwargs.get("device"))
        params = mfa.MfaParams(*(torch.as_tensor(x, device=dev)
                                 for x in mfa_params))
        return cls(mfa.to_gmm_params(params, reg), a, n_bits, **kwargs)

    def _snap(self, snr: float) -> float:
        if self.snr_step is None:
            return float(snr)
        return round(float(snr) / self.snr_step) * self.snr_step

    def _bank(self, snr: float) -> _BankEntry:
        """LRU-cached prepared bank for a (snapped) SNR. Only the serving
        thread touches the cache, so no lock; the cap bounds memory against
        clients sweeping many distinct SNRs."""
        if snr in self._banks:
            self._banks.move_to_end(snr)
            self._metrics.bank_cache_hits += 1
            return self._banks[snr]
        self._metrics.bank_cache_misses += 1
        q = Q.design_quantizer(snr, self.n_bits, self.quantizer_type)
        q = None if q is None else q.to(self.device)
        if self.structured:
            bank = structured_bank.prepare_bank_circulant(
                self.params, snr, self.a, self.n_bits, q,
                blocks=self.structured_blocks, spectra=self._spectra)
        elif self.factored:
            bank = mfa_bank.prepare_bank_factored(self.params, snr, self.a,
                                                  self.n_bits, q)
        else:
            bank = gmm_estimator.prepare_bank(self.params, snr, self.a,
                                              self.n_bits, q)
        entry = _BankEntry(bank, {}, self._lower_shards(bank))
        self._banks[snr] = entry
        while len(self._banks) > self.max_banks:
            self._banks.popitem(last=False)
        return entry

    def _lower_shards(self, bank) -> Tuple[dict, ...]:
        """On a mesh, one layout cache a component shard of `bank`, its T =
        1 kernel layouts and operands made here, once for the bank (the
        coherent layouts once per (T, alpha) at first use); () without a
        mesh."""
        if self.mesh is None:
            return ()
        n_c = self.mesh.shape[pmesh.COMPONENT_AXIS]
        caches = tuple({} for _ in range(n_c))
        if not self.use_kernels or self.device.type != "cuda":
            return caches
        for j, cache in enumerate(caches):
            shard = pmesh.bank_shard(bank, n_c, j)
            if self.structured:
                circ_kernels.lowered_tc(shard, cache, self.structured_blocks,
                                        stats=True)
            elif self.factored:
                fact_kernels.lowered_tc(shard, cache)
            else:
                kernels.lowered_tc(shard, cache)
        return caches

    def _estimate_mesh(self, entry: _BankEntry, r: torch.Tensor,
                       alpha: float) -> torch.Tensor:
        """Flat rows or blocks through the mesh's component shards, merged
        (`parallel.mesh`): K2 (K5 in a top-k mode), K8 / K9 or K13 with
        the kernels, else the einsum, `torch.fft` or `torch.matmul` stats
        paths."""
        if self.structured:
            return pmesh.estimate_sharded_circulant(
                self.mesh, entry.bank, r, coherence_alpha=alpha,
                blocks=self.structured_blocks,
                use_kernel=None if self.use_kernels else False,
                caches=entry.shards)
        if self.factored:
            return pmesh.estimate_sharded_factored(
                self.mesh, entry.bank, r, coherence_alpha=alpha,
                use_kernel=None if self.use_kernels else False,
                caches=entry.shards)
        return pmesh.estimate_sharded(
            self.mesh, entry.bank, r, self.mode, coherence_alpha=alpha,
            use_kernel=self.use_kernels, caches=entry.shards)

    def _resolve_alpha(self, snr: float, t_coh: int) -> float:
        """Blend for a (snr, T) block queue: the fixed setting, or the
        cached grid winner of 'auto' selection."""
        if self.coherence_alpha != "auto":
            return float(self.coherence_alpha)
        key = (snr, t_coh)
        if key not in self._alpha_cache:
            if self.alpha_val.shape[1] != t_coh:
                raise ValueError(
                    f"auto-alpha validation blocks have "
                    f"T={self.alpha_val.shape[1]} but the request stream has "
                    f"T={t_coh}; provide alpha_val blocks matching the "
                    "serving block length")
            q = Q.design_quantizer(snr, self.n_bits, self.quantizer_type)
            q = None if q is None else q.to(self.device)
            h_val = torch.as_tensor(self.alpha_val, device=self.device).to(
                self.a.dtype)
            if self.mesh is not None:
                # the mesh splits the blocks over its data axis
                n_d = self.mesh.shape[pmesh.DATA_AXIS]
                h_val = h_val[:(h_val.shape[0] // n_d) * n_d]
            gen = torch.Generator(device=self.device).manual_seed(0)
            r_val = observation.observe(gen, h_val, snr, self.a, self.n_bits,
                                        q)
            entry = self._bank(snr)
            best, _ = gmm_estimator.select_coherence_alpha(
                lambda rb, alpha: self._estimate_coherent(entry, rb, alpha),
                r_val, h_val)
            self._alpha_cache[key] = best
        return self._alpha_cache[key]

    def submit(self, r: np.ndarray, snr: float,
               timeout: Optional[float] = 30.0) -> np.ndarray:
        """Estimate channels for observations r at the given SNR.

        r of shape (n, M) is n independent snapshots and returns (n, D);
        (n, T, M) is n coherence blocks of T snapshots sharing one
        propagation state, estimated jointly, and returns (n, T, D). Blocks
        co-batch only with same-T requests.

        Shapes are validated here, so one malformed request fails alone
        instead of poisoning every co-batched request at its SNR."""
        r = np.asarray(r)
        m = self.a.shape[0]
        if r.ndim not in (2, 3) or r.shape[-1] != m:
            raise ValueError(f"observations must have shape (n, {m}) or "
                             f"(n, T, {m}); got {r.shape} (a 1-D vector "
                             "would be misread as per-row requests)")
        t_coh = r.shape[1] if r.ndim == 3 else None
        if t_coh == 0 or r.shape[0] == 0:
            raise ValueError(f"empty request: shape {r.shape}")
        n_snapshots = r.shape[0] * (t_coh or 1)
        snr = self._snap(snr)
        req = _Request(r)
        with self._lock:
            if self._closing:
                raise ServiceClosedError("service is closing; no new "
                                         "requests accepted")
            if self._pending + n_snapshots > self.max_queue:
                self._metrics.requests_shed += 1
                raise ServiceOverloadedError(
                    f"pending queue at {self._pending} samples; request of "
                    f"{n_snapshots} exceeds the max_queue={self.max_queue} "
                    "high-water mark; retry with backoff or shrink the "
                    "request")
            self._metrics.requests_submitted += 1
            self._pending += n_snapshots
            self._queues.setdefault((snr, t_coh), []).append(
                (time.monotonic(), req))
        if not req.event.wait(timeout):
            raise TimeoutError("estimation request timed out")
        if req.error is not None:
            if isinstance(req.error, ServiceClosedError):
                raise req.error
            raise RuntimeError("estimation request failed") from req.error
        return req.result

    def _flush(self, key: Tuple[float, Optional[int]],
               batch: List[Tuple[float, _Request]]):
        snr, t_coh = key
        try:
            rs = np.concatenate([q.r for _, q in batch], axis=0)
            n = rs.shape[0]
            entry = self._bank(snr)
            alpha = (self._resolve_alpha(snr, t_coh)
                     if t_coh is not None else None)
            # power-of-two microbatches capped at max_batch snapshots: a
            # bounded set of shapes, and no arbitrarily large one-off batch.
            # For coherence blocks the unit is a block (never split across
            # microbatches: the pooled posterior needs all T snapshots) and
            # the cap and the minimum pad scale down by T (floor 1 block).
            cap = 1 << max(4, self.max_batch.bit_length() - 1)
            min_bits = 4
            if t_coh is not None:
                cap = max(1, cap // t_coh)
                min_bits = max(0, 4 - (t_coh - 1).bit_length())
            if self.mesh is not None:
                # the mesh splits a microbatch's rows over its data axis:
                # pads are powers of two, so a floor of at least n_data
                # keeps them divisible for power-of-two meshes
                min_bits = max(min_bits, (self.mesh.shape[pmesh.DATA_AXIS]
                                          - 1).bit_length())
            outs = []
            for off in range(0, n, cap):
                chunk = rs[off:off + cap]
                m = chunk.shape[0]
                n_pad = 1 << max(min_bits, (m - 1).bit_length())
                rp = np.zeros((n_pad,) + rs.shape[1:], rs.dtype)
                rp[:m] = chunk
                outs.append(self._compute(entry, rp, t_coh, alpha)[:m])
                self._metrics.microbatches += 1
            out_np = np.concatenate(outs, axis=0)
        except BaseException as e:  # deliver to the waiting clients
            self._fail(batch, e)
            if not isinstance(e, Exception):
                raise
            return
        off = 0
        now = time.monotonic()
        for ts, q in batch:
            m = q.r.shape[0]
            q.result = out_np[off:off + m]
            off += m
            self._metrics.requests_completed += 1
            self._metrics.estimates_served += m * (t_coh or 1)
            self._metrics.observe_latency(now - ts)
            q.event.set()

    def _fail(self, batch: List[Tuple[float, _Request]],
              error: BaseException):
        now = time.monotonic()
        for ts, q in batch:
            q.error = error
            self._metrics.requests_failed += 1
            self._metrics.observe_latency(now - ts)
            q.event.set()

    def _estimate(self, entry: _BankEntry, r: torch.Tensor) -> torch.Tensor:
        """Flat snapshots r (n, M) -> (n, D): K1 ('all') or K4 (top-k)
        with the kernels, else the einsum estimator; structured: K6, else
        the `torch.fft` pipeline; factored: K11, else the `torch.matmul`
        pipeline; on a mesh the sharded stats merge."""
        if self.mesh is not None:
            return self._estimate_mesh(entry, r, 1.0)
        if self.structured:
            return stages.estimate_circulant(
                entry.bank, r, self.mode, self.structured_blocks,
                "auto" if self.use_kernels else "fft", entry.lowered)
        if self.factored:
            return stages.estimate_factored(
                entry.bank, r, self.mode,
                "auto" if self.use_kernels else "pipeline", entry.lowered)
        if self.use_kernels:
            if self.mode == "all":
                return kernels.estimate_fused(entry.bank, r, entry.lowered)
            return kernels.estimate_fused_topk(entry.bank, r, self.mode,
                                               entry.lowered)
        return gmm_estimator.estimate(entry.bank, r, self.mode,
                                      min(r.shape[0], 2048))

    def _estimate_coherent(self, entry: _BankEntry, r: torch.Tensor,
                           alpha: float) -> torch.Tensor:
        """Blocks r (n, T, M) -> (n, T, D): K3 ('all' with the kernels),
        else the einsum coherent estimator; structured: K7, else the
        `torch.fft` coherent pipeline; factored: K12, else the
        `torch.matmul` coherent pipeline; on a mesh the sharded stats
        merge."""
        if self.mesh is not None:
            return self._estimate_mesh(entry, r, alpha)
        if self.structured:
            return stages.estimate_circulant_coherent(
                entry.bank, r, self.mode, alpha, self.structured_blocks,
                "auto" if self.use_kernels else "fft", entry.lowered)
        if self.factored:
            return stages.estimate_factored_coherent(
                entry.bank, r, self.mode, alpha,
                "auto" if self.use_kernels else "pipeline", entry.lowered)
        if self.use_kernels and self.mode == "all":
            return kernels.estimate_fused_coherent(entry.bank, r, alpha,
                                                   entry.lowered)
        return gmm_estimator.estimate_coherent(
            entry.bank, r, self.mode, max(1, 2048 // r.shape[1]), alpha)

    def _compute(self, entry: _BankEntry, rp: np.ndarray,
                 t_coh: Optional[int], alpha: Optional[float]) -> np.ndarray:
        """One padded microbatch through the estimator, host to host."""
        r = torch.as_tensor(rp, device=self.device).to(self.a.dtype)
        if t_coh is not None:
            out = self._estimate_coherent(entry, r, alpha)
        else:
            out = self._estimate(entry, r)
        return out.cpu().numpy()

    def _drain_work(self, force_all: bool):
        """Collect due queues under the lock. force_all flushes everything
        regardless of age or size (the close(drain=True) path)."""
        work = []
        now = time.monotonic()
        with self._lock:
            for key, queue in self._queues.items():
                if not queue:
                    continue
                t_mul = key[1] or 1  # snapshots per request row
                total = sum(q.r.shape[0] * t_mul for _, q in queue)
                oldest = queue[0][0]
                if (force_all or total >= self.max_batch
                        or now - oldest >= self.max_delay):
                    take, keep, acc = [], [], 0
                    for item in queue:
                        if force_all or acc < self.max_batch:
                            take.append(item)
                            acc += item[1].r.shape[0] * t_mul
                        else:
                            keep.append(item)
                    self._queues[key] = keep
                    self._pending -= acc
                    work.append((key, take))
        return work

    def _loop(self):
        """The worker: on the service's device and stream, flush due queues
        until stopped, then drain or fail what is left."""
        with contextlib.ExitStack() as ctx:
            if self._stream is not None:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(self._stream))
            while not self._stop.is_set():
                work = self._drain_work(force_all=False)
                for key, batch in work:
                    self._flush(key, batch)
                if not work:
                    time.sleep(0.0005)
            # stop requested: flush everything still queued (drain) or fail
            # it fast; never leave clients waiting for their timeout
            for key, batch in self._drain_work(force_all=True):
                if self._drain_on_close:
                    self._flush(key, batch)
                else:
                    self._fail(batch, ServiceClosedError(
                        "service closed before this request was processed"))

    def metrics(self) -> dict:
        """Self-reported operational snapshot (thread-safe)."""
        with self._lock:
            m = self._metrics
            total = sum(m.latency_counts)
            return {
                "requests_submitted": m.requests_submitted,
                "requests_completed": m.requests_completed,
                "requests_failed": m.requests_failed,
                "requests_shed": m.requests_shed,
                "estimates_served": m.estimates_served,
                "microbatches": m.microbatches,
                "bank_cache_hits": m.bank_cache_hits,
                "bank_cache_misses": m.bank_cache_misses,
                "banks_cached": len(self._banks),
                "queue_depth_samples": self._pending,
                "latency_count": total,
                "latency_mean_s": (m.latency_sum / total) if total else 0.0,
                "latency_p50_s": m.quantile(0.5),
                "latency_p99_s": m.quantile(0.99),
                "coherence_alpha_selected": dict(self._alpha_cache),
            }

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Stop the service. drain=True (default) flushes every queued
        request before the worker exits; drain=False fails queued requests
        fast with ServiceClosedError. Either way new submits are refused
        at once and no client is left waiting for its timeout."""
        with self._lock:
            self._closing = True
        self._drain_on_close = drain
        self._stop.set()
        self._thread.join(timeout=timeout)


class VaeEstimationService(EstimationService):
    """Microbatching front-end over a trained VAE prior (noisy and real
    modes): each request's per-sample conditional covariance comes from the
    decoder and feeds the batched Bussgang-LMMSE of `vae.estimate` on the
    service's device.

    Unlike the GMM services there is no prepared bank (the covariance
    depends on the request), so the per-SNR cache holds the quantizer
    design. Genie mode is refused at construction: its encoder needs the
    true channel, which a client asking for an estimate cannot have.
    Coherence blocks (n, T, M) pool the decoder's predicted spectra per
    block (`vae.estimate(coherence=T)`). Queues, microbatching, metrics,
    drain and backpressure are the base service's (`_init_runtime`)."""

    def __init__(self, model, params, cfg, a, max_batch: int = 4096,
                 max_delay_ms: float = 5.0, max_banks: int = 64,
                 snr_step_db: Optional[float] = 0.1,
                 max_queue: int = 262_144, chunk_size: int = 512,
                 structured: Union[bool, str] = "auto", device=None):
        """model: the `vae.DnnVae`; params: its flat parameter vector
        (`VaeTrainState.params`), a params dict, or None for the module's
        own; a: the (M, N) pilot matrix or a scalar x0 for A = x0 I.
        structured: route `vae.estimate` through its per-sample circulant
        path, exact when A = x0 I, which 'auto' detects from the pilot
        matrix. device: as `stages.resolve_device` (the CUDA card by
        default; raises without one)."""
        if cfg.vae_mode == "genie":
            raise ValueError(
                "genie-mode VAE estimation is genie-aided (the encoder "
                "sees the true channel); it cannot serve estimation "
                "requests: train and serve 'noisy' or 'real' instead")
        from quantized_channel_estimation_torch.models import vae
        self._vae = vae
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.params = (None if params is None else
                       {k: torch.as_tensor(v, device=self.device)
                        for k, v in params.items()}
                       if isinstance(params, dict)
                       else torch.as_tensor(params, device=self.device))
        self.cfg = cfg
        a = torch.as_tensor(a, device=self.device).to(torch.complex64)
        if a.dim() == 0:
            a = a * torch.eye(cfg.n_antennas, dtype=a.dtype,
                              device=self.device)
        self.a = a
        self.n_bits = cfg.n_bits
        self.quantizer_type = cfg.quantizer_type
        self.mode = "all"
        self.use_kernels = False
        self.mesh = None
        if structured == "auto":
            x0 = a[0, 0]
            structured = bool(
                a.shape[0] == a.shape[1]
                and torch.allclose(a, x0 * torch.eye(a.shape[0], dtype=a.dtype,
                                                     device=self.device),
                                   rtol=0.0,
                                   atol=1e-6 * max(1.0, float(x0.abs()))))
        self.structured = bool(structured)
        self._chunk = chunk_size
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._init_runtime(max_batch, max_delay_ms, max_banks, snr_step_db,
                           max_queue)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _bank(self, snr: float):
        """The per-SNR cached object: (snr, quantizer design)."""
        if snr in self._banks:
            self._banks.move_to_end(snr)
            self._metrics.bank_cache_hits += 1
            return self._banks[snr]
        self._metrics.bank_cache_misses += 1
        q = Q.design_quantizer(snr, self.n_bits, self.quantizer_type)
        self._banks[snr] = (snr, None if q is None else q.to(self.device))
        while len(self._banks) > self.max_banks:
            self._banks.popitem(last=False)
        return self._banks[snr]

    def _compute(self, bank, rp: np.ndarray, t_coh: Optional[int],
                 alpha: Optional[float]) -> np.ndarray:
        snr, q = bank
        r = torch.as_tensor(rp, device=self.device).to(torch.complex64)
        t = t_coh or 1
        # vae.estimate pools T consecutive rows: blocks go block-major
        flat = r.reshape(r.shape[0] * t, r.shape[-1])
        out = self._vae.estimate(self.model, self.params, self.cfg, flat,
                                 float(snr), self.a, q,
                                 chunk_size=self._chunk, coherence=t,
                                 structured=self.structured)
        return out.reshape(r.shape[:-1] + (-1,)).cpu().numpy()
