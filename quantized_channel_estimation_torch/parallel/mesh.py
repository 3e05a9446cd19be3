"""Data and tensor parallelism over a (data, component) device mesh.

Port of `quantized_channel_estimation_tpu/parallel/mesh.py`. JAX runs one
program over a mesh of devices and reduces with `psum` / `pmax` inside
`shard_map`; here every rank is one process with one device (one card, or
the CPU under Gloo) and the mesh is a `torch.distributed` `DeviceMesh`
with dims named "data" and "component", whose per-dim process groups carry
the collectives:

  - EM training is data-parallel: each rank holds a window of the samples
    (its "data" coordinate), the E+M pass produces the window's sufficient
    statistics, and one all-reduce over "data" makes every rank run the
    same M-step (`fit_gmm_shard_map`, `kmeans_shard_map`,
    `fit_mfa_shard_map`);
  - estimation shards the samples over "data" and the component bank over
    "component": each rank computes the un-normalised online-softmax state
    (m, den, acc) of its components, and the shards merge exactly with one
    all-reduce MAX of m and two SUMs of exp(m - m*) den and exp(m - m*) acc
    over "component" (`estimate_sharded_kernel` through K2,
    `estimate_sharded_circulant` through K8 / K9, `estimate_sharded_factored`
    through K13). Per sample the payload is two floats and one complex
    D-vector, independent of K. Top-k modes gather each shard's k
    candidates (K5) and merge them (`estimate_sharded`).

The functions take the global bank and rows, which every rank holds (every
rank builds the same data from the seed), work on this rank's shard and
return this rank's data shard of the result; `gather_data` reassembles
rows over "data". Rows and components must divide evenly over their axes.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from quantized_channel_estimation_torch.estimators import (
    circ_kernels, fact_kernels, kernels)
from quantized_channel_estimation_torch.models import (
    gmm, gmm_estimator, mfa, mfa_bank, structured_bank)
from quantized_channel_estimation_torch.models.gmm import GmmConfig
from quantized_channel_estimation_torch.models.gmm_estimator import (
    PreparedBank)
from quantized_channel_estimation_torch.models.kmeans import kmeans

DATA_AXIS = "data"
COMPONENT_AXIS = "component"


def make_mesh(n_data: Optional[int] = None, n_component: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """The (data, component) mesh over every rank of the initialised
    default group (n_data * n_component of them): ranks in row-major
    order, so the component shards of one data shard are neighbours.
    `device_type`: 'cuda' under NCCL, else 'cpu' by default."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_component
    if n_data * n_component != world:
        raise ValueError(f"a {n_data} x {n_component} mesh needs "
                         f"{n_data * n_component} ranks; the group has "
                         f"{world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_component),
                            mesh_dim_names=(DATA_AXIS, COMPONENT_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _window(n: int, parts: int, idx: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} must divide over {parts} shards")
    per = n // parts
    return slice(idx * per, (idx + 1) * per)


def shard_data(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a sample-batched tensor (its 'data' window)."""
    return x[_window(x.shape[0], axis_size(mesh, DATA_AXIS),
                     mesh.get_local_rank(DATA_AXIS), "n_samples")]


def shard_bank(mesh: DeviceMesh, bank):
    """This rank's components of a bank of any type (`PreparedBank`,
    `CirculantBank`, `CirculantBankMP`, `FactoredBank`: every field leads
    with K)."""
    sl = _window(bank[0].shape[0], axis_size(mesh, COMPONENT_AXIS),
                 mesh.get_local_rank(COMPONENT_AXIS), "K")
    return type(bank)(*(x[sl] for x in bank))


def _all_gather(group, x: torch.Tensor, n: int) -> list:
    """The n ranks' x (equal shapes) over `group`, in rank order."""
    if n == 1:
        return [x]
    xr = torch.view_as_real(x.resolve_conj()) if x.is_complex() else x
    xr = xr.contiguous()
    parts = [torch.empty_like(xr) for _ in range(n)]
    dist.all_gather(parts, xr, group=group)
    return [torch.view_as_complex(p) if x.is_complex() else p
            for p in parts]


def gather_data(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Rows of every 'data' shard in global order: the inverse of
    `shard_data`, on every rank (for the harness's whole-set metrics)."""
    return torch.cat(_all_gather(mesh.get_group(DATA_AXIS), x,
                                 axis_size(mesh, DATA_AXIS)))


def _gather_components(mesh: DeviceMesh, x: torch.Tensor) -> list:
    return _all_gather(mesh.get_group(COMPONENT_AXIS), x,
                       axis_size(mesh, COMPONENT_AXIS))


def _merge_components(mesh: DeviceMesh, m, den, acc) -> torch.Tensor:
    """The exact cross-rank merge of shard states (`kernels.merge_stats`
    as collectives): m* = all-reduce MAX of m over 'component', then
    all-reduce SUMs of exp(m - m*) den and exp(m - m*) acc. Returns the
    normalised quotient acc* / den*. m, den: (N,), (B,) or (B, T); acc
    (N, D) or (B, T, D)."""
    group = mesh.get_group(COMPONENT_AXIS)
    m_star = m.clone()
    dist.all_reduce(m_star, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_star)
    den = (den * w).contiguous()
    dist.all_reduce(den, group=group)
    expand = (1,) * (acc.dim() - w.dim())
    acc = (acc * w.reshape(w.shape + expand).to(acc.dtype)).contiguous()
    dist.all_reduce(torch.view_as_real(acc) if acc.is_complex() else acc,
                    group=group)
    return acc / den.reshape(den.shape + expand).to(acc.dtype)


def _shards(mesh: DeviceMesh, bank, r: torch.Tensor):
    return shard_bank(mesh, bank), shard_data(mesh, r)


# ---------------------------------------------------------------------------
# data-parallel fits
# ---------------------------------------------------------------------------

def fit_gmm_shard_map(mesh: DeviceMesh, gen: torch.Generator,
                      h: torch.Tensor, cfg: GmmConfig) -> gmm.GmmFitResult:
    """Data-parallel GMM EM: each rank fits on its 'data' window of the
    global h and the sufficient statistics are all-reduced over 'data'
    (one O(K D^2) all-reduce an iteration, `cfg.psum_segments` pieces);
    the init is the data-parallel k-means (or the global random stream's
    window). Every rank returns the fit of the global rows, up to float32
    summation order; `gen` must be seeded alike on every rank."""
    return gmm.fit(gen, shard_data(mesh, h), cfg,
                   group=mesh.get_group(DATA_AXIS))


# JAX's GSPMD form of the same fit; here both are the explicit collectives
fit_gmm_sharded = fit_gmm_shard_map


def kmeans_shard_map(mesh: DeviceMesh, gen: torch.Generator, x: torch.Tensor,
                     k: int, max_iter: int = 50, tol: float = 1e-4):
    """Data-parallel k-means over 'data': all-reduced Lloyd statistics and
    the single-device k-means++ draws. Returns (centers (K, D), labels
    (N,) gathered in global row order)."""
    res = kmeans(gen, shard_data(mesh, x), k, max_iter=max_iter, tol=tol,
                 group=mesh.get_group(DATA_AXIS))
    return res.centers, gather_data(mesh, res.labels)


def fit_mfa_shard_map(mesh: DeviceMesh, gen: torch.Generator,
                      x: torch.Tensor, cfg: mfa.MfaConfig) -> mfa.MfaFitResult:
    """Data-parallel MFA EM: the MFA's statistics are the GMM's, all-reduced
    over 'data' the same way; zero-mean and nonzero-mean fits (the means
    init is the data-parallel k-means), psi from the global variance."""
    return mfa.fit(gen, shard_data(mesh, x), cfg,
                   group=mesh.get_group(DATA_AXIS))


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                              f"item {item})")


def fit_gmm_quant_shard_map(mesh, gen, r, cfg, n_bits, sigma2, q=None):
    """Data-parallel quantized-training EM (CSI-free training)."""
    _not_ported("the data-parallel quantized-training EM", 10)


def fit_circulant_spectra_shard_map(mesh, gen, r, cfg, n_bits, sigma2,
                                    q=None):
    """Data-parallel spectra-native circulant quantized EM."""
    _not_ported("the data-parallel spectra-native quantized EM", 10)


def make_vae_epochs_runner(mesh, model, cfg, a, snrs, quantizers, n_steps,
                           n_epochs):
    """Data-parallel VAE epoch runner."""
    _not_ported("the data-parallel VAE trainer", 13)


def vae_run_epochs_shard_map(mesh, model, cfg, a, snrs, quantizers, state,
                             h_train, key, n_steps, n_epochs, epoch0=0):
    """One-shot form of `make_vae_epochs_runner`."""
    _not_ported("the data-parallel VAE trainer", 13)


# ---------------------------------------------------------------------------
# tensor-parallel estimation
# ---------------------------------------------------------------------------

def estimate_sharded_kernel(mesh: DeviceMesh, bank: PreparedBank,
                            r: torch.Tensor, use_kernel: bool = True,
                            chunk_size: int = 2048,
                            coherence_alpha: float = 1.0) -> torch.Tensor:
    """Tensor-parallel 'all'-mode estimation: samples over 'data', the
    bank's components over 'component'. Each rank runs K2 on its shard
    (`kernels.estimate_fused_stats`: the CUDA kernel on a card, its plain
    version on the CPU, the einsum stats path past the kernel's widths) and
    the shard states merge exactly across ranks (`_merge_components`).
    `use_kernel=False` takes the einsum stats path
    (`gmm_estimator.estimate_stats`, the same logit convention).

    r of rank 3 is (B, T, M) coherence blocks: each shard's block-pooled
    state through K2's coherent form (`kernels.estimate_fused_coherent_stats`
    with the alpha blend; per block at alpha = 1, per snapshot below),
    merged the same way; equals `estimate_coherent(bank, r, 'all')` on
    every mesh. Returns this rank's data shard of the estimate."""
    bank_l, r_l = _shards(mesh, bank, r)
    alpha = float(coherence_alpha)
    if r.dim() == 3:
        if use_kernel:
            m, den, acc = kernels.estimate_fused_coherent_stats(bank_l, r_l,
                                                                alpha)
        else:
            m, den, acc = gmm_estimator.estimate_coherent_stats(
                bank_l, r_l, max(1, chunk_size // r.shape[1]), alpha)
    elif use_kernel:
        m, den, acc = kernels.estimate_fused_stats(bank_l, r_l)
    else:
        m, den, acc = gmm_estimator.estimate_stats(bank_l, r_l, chunk_size)
    return _merge_components(mesh, m, den, acc).to(r.dtype)


def estimate_sharded_circulant(mesh: DeviceMesh, bank, r: torch.Tensor,
                               chunk_size: int = 16384,
                               coherence_alpha: float = 1.0, blocks=None,
                               use_kernel: Optional[bool] = None
                               ) -> torch.Tensor:
    """Tensor-parallel FFT-domain estimation of a `CirculantBank` or
    `CirculantBankMP` split over 'component': each rank computes its
    components' DFT-domain state, the shards merge as in
    `estimate_sharded_kernel`, and one inverse transform runs on the merged
    quotient (it commutes with the per-row normalisation). Rank-3 r:
    coherence blocks.

    `use_kernel=None` takes the stats kernels K8 (flat) / K9 (coherent)
    for a single-pilot bank whose shard is within
    `circ_kernels.circ_kernel_eligible`, else the `torch.fft` pipelines'
    stats forms; a `CirculantBankMP` always takes the pipeline. The route
    is decided from shapes equal on every rank, so every shard takes the
    same one: kernel and pipeline logits differ by a row constant and must
    not be merged."""
    multi = isinstance(bank, structured_bank.CirculantBankMP)
    bank_l, r_l = _shards(mesh, bank, r)
    coherent = r.dim() == 3
    t = r.shape[1] if coherent else 1
    alpha = float(coherence_alpha)
    if use_kernel is None:
        k_l, d = bank_l.mean_rf.shape[:2]
        use_kernel = (not multi
                      and circ_kernels.circ_kernel_eligible(d, k_l, t))
    if use_kernel and multi:
        raise ValueError("the circulant stats kernels take single-pilot "
                         "banks; a CirculantBankMP takes the pipeline")
    sb = structured_bank
    if multi and coherent:
        m, den, acc = sb.estimate_circulant_mp_coherent_stats(
            bank_l, r_l, max(1, chunk_size // (4 * t)), alpha, blocks)
    elif multi:
        m, den, acc = sb.estimate_circulant_mp_stats(
            bank_l, r_l, max(1, chunk_size // 4), blocks)
    elif use_kernel and coherent:
        m, den, acc = circ_kernels.estimate_fused_circulant_coherent_stats(
            bank_l, r_l, alpha, blocks)
    elif use_kernel:
        m, den, acc = circ_kernels.estimate_fused_circulant_stats(
            bank_l, r_l, blocks)
    elif coherent:
        m, den, acc = sb.estimate_circulant_coherent_stats(
            bank_l, r_l, max(1, chunk_size // t), alpha, blocks)
    else:
        m, den, acc = sb.estimate_circulant_stats(bank_l, r_l, chunk_size,
                                                  blocks)
    h_f = _merge_components(mesh, m, den, acc)
    return sb.unitary_ifft(h_f, blocks).to(r.dtype)


def estimate_sharded_factored(mesh: DeviceMesh, bank, r: torch.Tensor,
                              chunk_size: int = 4096,
                              coherence_alpha: float = 1.0,
                              use_kernel: Optional[bool] = None
                              ) -> torch.Tensor:
    """Tensor-parallel factored (MFA, Woodbury) estimation of a
    `FactoredBank` split over 'component', merged as in
    `estimate_sharded_kernel`. `use_kernel=None` takes the stats kernel
    K13 for flat rows whose shard is within
    `fact_kernels.fact_kernel_eligible`, else the `torch.matmul` pipeline's
    stats form (the same logit convention); coherence blocks (rank-3 r)
    take the pipeline's coherent stats form."""
    bank_l, r_l = _shards(mesh, bank, r)
    alpha = float(coherence_alpha)
    if r.dim() == 3:
        m, den, acc = mfa_bank.estimate_factored_coherent_stats(
            bank_l, r_l, max(1, chunk_size // r.shape[1]), alpha)
    else:
        if use_kernel is None:
            k_l, m_lat, d = bank_l.t_mat.shape
            use_kernel = fact_kernels.fact_kernel_eligible(d, k_l, m_lat)
        if use_kernel:
            m, den, acc = fact_kernels.estimate_fused_factored_stats(bank_l,
                                                                     r_l)
        else:
            m, den, acc = mfa_bank.estimate_factored_stats(bank_l, r_l,
                                                           chunk_size)
    return _merge_components(mesh, m, den, acc).to(r.dtype)


def _gather_bank(mesh: DeviceMesh, bank_l):
    """The whole bank, all-gathered over 'component' from the shards."""
    return type(bank_l)(*(torch.cat(_gather_components(mesh, x))
                          for x in bank_l))


def estimate_sharded(mesh: DeviceMesh, bank: PreparedBank, r: torch.Tensor,
                     mode: Union[str, int, float] = "all",
                     chunk_size: int = 2048,
                     coherence_alpha: float = 1.0) -> torch.Tensor:
    """Sharded estimation in every selection mode, samples over 'data' and
    the bank over 'component':

      - 'all': `estimate_sharded_kernel`;
      - int top-k modes within `kernels.topk_mode_eligible` (flat rows): K5
        on each shard, the shards' k candidates all-gathered over
        'component' (k (1 + 2D) floats a row, independent of K) and merged
        with `kernels.merge_topk` (ties to the lower component, as one K4
        launch);
      - float cumulative-p modes and rank-3 selection requests: the einsum
        estimator on the bank all-gathered over 'component' (JAX's GSPMD
        route is that einsum).

    Returns this rank's data shard of the estimate."""
    if mode == "all":
        return estimate_sharded_kernel(mesh, bank, r, chunk_size=chunk_size,
                                       coherence_alpha=coherence_alpha)
    k, d, m = bank.filters.shape
    bank_l, r_l = _shards(mesh, bank, r)
    if r.dim() == 2 and kernels.topk_mode_eligible(d, k, m, mode):
        ls, zs = kernels.estimate_fused_topk_stats(bank_l, r_l, mode)
        h2 = kernels.merge_topk(_gather_components(mesh, ls),
                                _gather_components(mesh, zs), mode)
        return kernels._h(h2, d, r.dtype)
    whole = _gather_bank(mesh, bank_l)
    if r.dim() == 3:
        return gmm_estimator.estimate_coherent(
            whole, r_l, mode, max(1, chunk_size // r.shape[1]),
            float(coherence_alpha))
    return gmm_estimator.estimate(whole, r_l, mode, chunk_size)
