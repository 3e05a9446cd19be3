"""Pipeline stages shared by the harness runners.

Port of `quantized_channel_estimation_tpu/harness/stages.py`:
`generate_channels`, `pilot_matrix`, `sample_cov`, `observe`,
`blmmse_global`, `blmmse_genie`, `ls_global`, `gmm_fit`, `prepare_bank`,
`nmse`, `rate`, `rate_mf`, `estimate_auto`, `estimate_coherent`,
`estimate_coherent_auto`, `flatten_coherence`, for the structured banks
`prepare_bank_circulant`, `prepare_bank_circulant_spectra`,
`estimate_circulant`, `estimate_circulant_coherent`, and for MFA `mfa_fit`,
`mfa_to_gmm`, `prepare_bank_factored`, `estimate_factored`,
`estimate_factored_coherent`, and `ShardedStages`, the mesh-parallel set
of the fits and estimators (`parallel.mesh`), which `sharded_stages` builds
for a harness run over several ranks. The JAX stages wrap every
function in `cjit` so that complex data crosses program boundaries as
packed (re, im) reals, because the TPU runtime has no complex buffers;
PyTorch on CUDA has complex64 tensors, so here the stages are the plain
functions and `ops/boundary.py` has no port.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from quantized_channel_estimation_torch.estimators import (
    blmmse, circ_kernels, fact_kernels, kernels, ls, mp_circ_kernels)
from quantized_channel_estimation_torch.models import (
    gmm, gmm_estimator, mfa, mfa_bank, structured_bank)
from quantized_channel_estimation_torch.ops import observation, pilots, scm
from quantized_channel_estimation_torch.parallel import mesh as pmesh
from quantized_channel_estimation_torch.utils import metrics


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. Without a card and without an explicit device this
    raises: the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def generate_channels(gen: torch.Generator, n_batches: int,
                      cfg: scm.ScmConfig, chunk: int = 8192):
    """Chunked SCM channel generation (bounds the (chunk, 100 N) PSD
    intermediate): (h, t) on the generator's device."""
    hs, ts = [], []
    for i0 in range(0, n_batches, chunk):
        h, t = scm.generate_channels(gen, min(chunk, n_batches - i0), cfg)
        hs.append(h)
        ts.append(t)
    return torch.cat(hs), torch.cat(ts)


def pilot_matrix(n_antennas, n_pilots, n_bits, pilot_type="angle_amp",
                 gen: Optional[torch.Generator] = None, device=None):
    """Pilot matrix A = kron(x, I); pilot_type='rand' draws from `gen`
    (seeded 0 when absent, like the JAX stage's PRNGKey(0))."""
    device = resolve_device(device)
    if pilot_type == "rand" and gen is None:
        gen = torch.Generator(device).manual_seed(0)
    return pilots.pilot_matrix(n_antennas, n_pilots, n_bits, pilot_type, gen,
                               device=device)


def sample_cov(h: torch.Tensor) -> torch.Tensor:
    """Sample covariance sum_n h_n h_n^H / N."""
    return h.T @ h.conj() / h.shape[0]


observe = observation.observe
blmmse_global = blmmse.estimate_global
blmmse_genie = blmmse.estimate_genie
ls_global = ls.estimate_global
gmm_fit = gmm.fit
mfa_fit = mfa.fit
mfa_to_gmm = mfa.to_gmm_params
prepare_bank = gmm_estimator.prepare_bank
estimate_coherent = gmm_estimator.estimate_coherent
# block-major snapshot order: (B, T, N) -> (B*T, N), Toeplitz rows repeated
flatten_coherence = scm.flatten_coherence


def estimate_auto(bank: gmm_estimator.PreparedBank, r: torch.Tensor, mode):
    """'all' mode within `kernels.fused_kernel_eligible` -> the estimation
    kernel K1 (`kernels.estimate_fused`); int selection modes within
    `kernels.topk_kernel_eligible` -> the top-k kernel K4
    (`kernels.estimate_fused_topk`); anything else (float cumulative-p
    modes, k >= K, banks wider than the kernels) -> the einsum estimator.
    Each kernel entry launches the CUDA kernel for a CUDA tensor and
    computes its plain version for a CPU tensor."""
    _, d, m = bank.filters.shape
    if mode == "all" and kernels.fused_kernel_eligible(d, m):
        return kernels.estimate_fused(bank, r)
    if kernels.topk_kernel_eligible(bank, mode):
        return kernels.estimate_fused_topk(bank, r, mode)
    return gmm_estimator.estimate(bank, r, mode)


def estimate_coherent_auto(bank: gmm_estimator.PreparedBank, r: torch.Tensor,
                           mode, alpha: float = 1.0):
    """Coherent analog of `estimate_auto` for blocks r (B, T, M): 'all'
    mode -> `kernels.estimate_fused_coherent` (K3, the alpha blend in the
    kernel, or K1 at T = 1; T or widths beyond their range take the einsum
    path there), other modes -> the einsum coherent estimator."""
    if mode == "all":
        return kernels.estimate_fused_coherent(bank, r, alpha)
    return estimate_coherent(bank, r, mode, 512, alpha)


def prepare_bank_circulant(params, snr_db, a, n_bits, q=None, blocks=None):
    """FFT-domain bank of a (block-)circulant fit and a kron(x, I) pilot
    (`structured_bank.prepare_bank_circulant`): a `CirculantBank` for the
    single scaled-identity pilot, a `CirculantBankMP` for P > 1."""
    return structured_bank.prepare_bank_circulant(params, snr_db, a, n_bits,
                                                  q, blocks=blocks)


def prepare_bank_circulant_spectra(params, spectra, snr_db, a, n_bits, q=None,
                                   blocks=None):
    """The same bank straight from channel-covariance spectra (K, D); the
    covariances of `params` are not read."""
    return structured_bank.prepare_bank_circulant(
        params, snr_db, a, n_bits, q, blocks=blocks, spectra=spectra)


def _circ_method(method: str, mode, bank, t: int = 1) -> str:
    """The one dispatch rule of the structured estimators, from shapes
    only: 'auto' is the kernels for an 'all'-mode request within
    `circ_kernels.circ_kernel_eligible` (a multi-pilot bank:
    `mp_circ_kernels.mp_circ_kernel_eligible`), else the `torch.fft`
    pipeline; 'kernel' raises outside that range; 'fft' / 'dft' name the
    pipeline."""
    if isinstance(bank, structured_bank.CirculantBankMP):
        k, d, p = bank.mean_rf.shape
        kernel_ok = mp_circ_kernels.mp_circ_kernel_eligible(d, k, p, t)
        rule = f"mp_circ_kernel_eligible (P={p})"
    else:
        k, d = bank.spec_cr.shape
        kernel_ok = circ_kernels.circ_kernel_eligible(d, k, t)
        rule = "circ_kernel_eligible"
    kernel_ok = kernel_ok and mode == "all"
    if method == "kernel" and not kernel_ok:
        raise ValueError(
            f"method='kernel' needs mode='all' and (D, K, T) within {rule} "
            f"(got mode={mode!r}, D={d}, K={k}, T={t})")
    if method == "auto":
        return "kernel" if kernel_ok else "fft"
    return method


def estimate_circulant(bank, r: torch.Tensor, mode="all", blocks=None,
                       method: str = "auto", cache: Optional[dict] = None):
    """Structured analog of `estimate_auto` for r (N, M) and a bank of
    either kind: 'all' mode within the kernels' range -> the circulant
    kernel K6, or K10 for a multi-pilot bank (the CUDA kernel for a CUDA
    tensor, its plain version for a CPU tensor); selection modes and wider
    banks -> the `torch.fft` pipeline. `method` as in `_circ_method`;
    `cache` holds the kernel layouts of a bank served many times
    (`circ_kernels.lowered`, `mp_circ_kernels.lowered`)."""
    method = _circ_method(method, mode, bank)
    if method != "kernel":
        return structured_bank.estimate_circulant(bank, r, mode, 16384,
                                                  blocks, method)
    if isinstance(bank, structured_bank.CirculantBankMP):
        return mp_circ_kernels.estimate_fused_circulant_mp(bank, r, blocks,
                                                           cache)
    return circ_kernels.estimate_fused_circulant(bank, r, blocks, cache)


def estimate_circulant_coherent(bank, r: torch.Tensor, mode="all",
                                alpha: float = 1.0, blocks=None,
                                method: str = "auto",
                                cache: Optional[dict] = None):
    """Coherent analog of `estimate_circulant` for blocks r (B, T, M): 'all'
    mode with (D, K, T) within the kernels' range -> K7, or the coherent
    K10 for a multi-pilot bank (the alpha blend in the kernel), else the
    `torch.fft` coherent pipeline."""
    if r.dim() != 3:
        raise ValueError(f"estimate_circulant_coherent expects (B, T, M) "
                         f"blocks, got shape {tuple(r.shape)}")
    method = _circ_method(method, mode, bank, r.shape[1])
    if method != "kernel":
        return structured_bank.estimate_circulant_coherent(
            bank, r, mode, 4096, alpha, blocks, method)
    if isinstance(bank, structured_bank.CirculantBankMP):
        return mp_circ_kernels.estimate_fused_circulant_mp_coherent(
            bank, r, alpha, blocks, cache)
    return circ_kernels.estimate_fused_circulant_coherent(bank, r, alpha,
                                                          blocks, cache)


def prepare_bank_factored(params: mfa.MfaParams, snr_db, a, n_bits, q=None):
    """Factored (Woodbury) bank of an MFA fit and a scaled-identity pilot
    (`mfa_bank.prepare_bank_factored`): O(K D M) memory, no dense
    covariance."""
    return mfa_bank.prepare_bank_factored(params, snr_db, a, n_bits, q)


def _fact_method(method: str, mode, bank: mfa_bank.FactoredBank,
                 t: int = 1) -> str:
    """The one dispatch rule of the factored estimators, from shapes only:
    'auto' is the kernels for an 'all'-mode request within
    `fact_kernels.fact_kernel_eligible`, else the `torch.matmul` pipeline;
    'kernel' raises outside that range; 'pipeline' names the pipeline."""
    k, m, d = bank.t_mat.shape
    kernel_ok = mode == "all" and fact_kernels.fact_kernel_eligible(d, k, m,
                                                                    t)
    if method == "kernel" and not kernel_ok:
        raise ValueError(
            f"method='kernel' needs mode='all' and (D, M, T) within "
            f"fact_kernel_eligible (got mode={mode!r}, D={d}, M={m}, K={k}, "
            f"T={t})")
    if method == "auto":
        return "kernel" if kernel_ok else "pipeline"
    if method not in ("kernel", "pipeline"):
        raise ValueError(f"method must be 'auto', 'kernel' or 'pipeline'; "
                         f"got {method!r}")
    return method


def estimate_factored(bank: mfa_bank.FactoredBank, r: torch.Tensor,
                      mode="all", method: str = "auto",
                      cache: Optional[dict] = None) -> torch.Tensor:
    """Factored analog of `estimate_auto` for r (N, D): 'all' mode within
    the kernels' range -> K11 (the CUDA kernel for a CUDA tensor, its plain
    version for a CPU tensor); selection modes and wider banks -> the
    `torch.matmul` pipeline. `method` as in `_fact_method`; `cache` holds
    the kernel layouts of a bank served many times
    (`fact_kernels.lowered`)."""
    if _fact_method(method, mode, bank) == "kernel":
        return fact_kernels.estimate_fused_factored(bank, r, cache)
    return mfa_bank.estimate_factored(bank, r, mode, 4096)


def estimate_factored_coherent(bank: mfa_bank.FactoredBank, r: torch.Tensor,
                               mode="all", alpha: float = 1.0,
                               method: str = "auto",
                               cache: Optional[dict] = None) -> torch.Tensor:
    """Coherent analog of `estimate_factored` for blocks r (B, T, D):
    'all' mode with (D, M, T) within the kernels' range -> K12 (the alpha
    blend in the kernel), else the `torch.matmul` coherent pipeline."""
    if r.dim() != 3:
        raise ValueError(f"estimate_factored_coherent expects (B, T, D) "
                         f"blocks, got shape {tuple(r.shape)}")
    if _fact_method(method, mode, bank, r.shape[1]) == "kernel":
        return fact_kernels.estimate_fused_factored_coherent(bank, r, alpha,
                                                             cache)
    return mfa_bank.estimate_factored_coherent(bank, r, mode, 1024, alpha)


def rank_device(device=None) -> torch.device:
    """The device of this rank of a multi-rank run: `device` when given,
    else the card cuda:LOCAL_RANK (raises without CUDA, as
    `resolve_device`)."""
    if device is not None:
        return torch.device(device)
    resolve_device()
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def sharded_stages(n_data_shards: int = 1, n_component_shards: int = 1):
    """The `ShardedStages` of a harness run over n_data_shards x
    n_component_shards ranks, or None for one rank. The default process
    group must be initialised with exactly that many ranks, as `torchrun`
    and `parallel.distributed.initialize` do."""
    n = n_data_shards * n_component_shards
    if n == 1:
        return None
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != n:
        raise ValueError(
            f"n_data_shards * n_component_shards = {n} needs torch.distributed"
            f" initialised with {n} ranks (it has {world}): launch the script "
            f"under torchrun --nproc-per-node={n} and call "
            "parallel.distributed.initialize() first")
    return ShardedStages(pmesh.make_mesh(n_data_shards, n_component_shards))


class ShardedStages:
    """Mesh-parallel stage set for the harness runners (JAX
    `stages.ShardedStages`): fits run data-parallel over 'data'
    (`parallel.mesh.fit_gmm_shard_map` / `fit_mfa_shard_map`); 'all'-mode
    estimation runs through the sharded stats merges (samples on 'data',
    bank on 'component': `estimate_sharded_kernel` with K2,
    `estimate_sharded_circulant` with K8 / K9, `estimate_sharded_factored`
    with K13), selection modes through `estimate_sharded` (K5 candidates,
    or the einsum estimator). Every rank holds the global rows; the
    estimators return them whole, gathered over 'data'
    (`parallel.mesh.gather_data`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_data = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
        self.n_component = pmesh.axis_size(mesh, pmesh.COMPONENT_AXIS)

    @property
    def writer(self) -> bool:
        """Does this rank write the run's files (rank 0)?"""
        return dist.get_rank() == 0

    def barrier(self) -> None:
        dist.barrier()

    def check_divisible(self, n_train: int, n_val: int, k: int) -> None:
        """Fail before any compute when the sweep's shapes cannot shard
        over this mesh."""
        if n_train % self.n_data or n_val % self.n_data:
            raise ValueError(
                f"n_train={n_train} and n_val={n_val} must divide over "
                f"{self.n_data} data shards")
        if k % self.n_component:
            raise ValueError(f"n_components={k} must divide over "
                             f"{self.n_component} component shards")

    def gmm_fit(self, gen, h, cfg):
        return pmesh.fit_gmm_shard_map(self.mesh, gen, h, cfg)

    def mfa_fit(self, gen, x, cfg):
        return pmesh.fit_mfa_shard_map(self.mesh, gen, x, cfg)

    def gmm_quant_fit(self, *args, **kwargs):
        raise NotImplementedError("the data-parallel quantized-training EM "
                                  "is not ported yet (ROADMAP Queue 1 item "
                                  "10)")

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        return pmesh.gather_data(self.mesh, x)

    def estimate(self, bank, r, mode):
        """Dense-bank sharded estimation of flat rows r (N, M)."""
        return self._whole(pmesh.estimate_sharded(self.mesh, bank, r, mode))

    def estimate_coherent(self, bank, r, mode, alpha: float = 1.0):
        """Dense-bank sharded block estimation (r (B, T, M))."""
        return self._whole(pmesh.estimate_sharded(
            self.mesh, bank, r, mode, coherence_alpha=float(alpha)))

    def estimate_circulant(self, bank, r, mode, blocks=None,
                           alpha: float = 1.0):
        """FFT-domain sharded estimation, flat or blocks; the stats merge
        computes the 'all'-mode combine only."""
        if mode != "all":
            raise ValueError(
                "mesh-sharded structured estimation computes the 'all'-mode "
                f"stats merge (got mode={mode!r}); run selection modes "
                "single-device or through the dense sharded route")
        return self._whole(pmesh.estimate_sharded_circulant(
            self.mesh, bank, r, coherence_alpha=float(alpha), blocks=blocks))

    def estimate_factored(self, bank, r, mode, alpha: float = 1.0):
        """Factored-bank sharded estimation ('all'-mode stats merge), flat
        or blocks."""
        if mode != "all":
            raise ValueError(
                "mesh-sharded factored estimation computes the 'all'-mode "
                f"stats merge (got mode={mode!r}); run selection modes "
                "single-device or densify for the dense sharded route")
        return self._whole(pmesh.estimate_sharded_factored(
            self.mesh, bank, r, coherence_alpha=float(alpha)))


def nmse(h_est: torch.Tensor, h: torch.Tensor) -> float:
    return float(metrics.nmse(h_est, h))


def rate(h_est, h, cov, snr_db, n_bits, q, norm_clip=None) -> float:
    """Statistical rate lower bound against the global Bussgang stats."""
    b, cq = metrics.global_bussgang_stats(cov, snr_db, n_bits, q)
    return float(metrics.rate_lower_bound(h_est, h, b, cq, norm_clip))


def rate_mf(h_est, h, cov, snr_db, n_bits, q) -> float:
    """Matched-filter rate bound."""
    b, cq = metrics.global_bussgang_stats(cov, snr_db, n_bits, q)
    return float(metrics.rate_mf_bound(h_est, h, b, cq))
