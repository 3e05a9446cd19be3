"""Data and tensor parallelism over a (data, component) device mesh.

Port of `quantized_channel_estimation_tpu/parallel/mesh.py`. JAX runs one
program over a mesh of devices and reduces with `psum` / `pmax` inside
`shard_map`. Here a mesh is one of two kinds, with dims named "data" and
"component":

  - a `torch.distributed` `DeviceMesh` (`make_mesh`): every rank is one
    process with one device (one card, or the CPU under Gloo), and the
    per-dim process groups carry the collectives;
  - a `LocalMesh` (`make_local_mesh`): one process drives every shard on
    one device, each component shard on its own CUDA stream on a card (the
    counterpart of JAX's single controller; the estimation service's
    `mesh=`).

  - EM training is data-parallel: each rank holds a window of the samples
    (its "data" coordinate), the E+M pass produces the window's sufficient
    statistics, and one all-reduce over "data" makes every rank run the
    same M-step (`fit_gmm_shard_map`, `kmeans_shard_map`,
    `fit_mfa_shard_map`, `fit_gmm_quant_shard_map`,
    `fit_circulant_spectra_shard_map`; `DeviceMesh` only); VAE training
    is data-parallel the same way, its gradient averaged over "data" every
    step (`make_vae_epochs_runner`);
  - estimation shards the samples over "data" and the component bank over
    "component": each shard computes the un-normalised online-softmax state
    (m, den, acc) of its components, and the shards merge exactly: across
    ranks with one all-reduce MAX of m and two SUMs of exp(m - m*) den and
    exp(m - m*) acc over "component", in one process with
    `kernels.merge_stats` (`estimate_sharded_kernel` through K2,
    `estimate_sharded_circulant` through K8 / K9, `estimate_sharded_factored`
    through K13). Per sample the payload is two floats and one complex
    D-vector, independent of K. Top-k modes gather each shard's k
    candidates (K5) and merge them (`estimate_sharded`, `DeviceMesh` only).

The functions take the global bank and rows, which every rank holds (every
rank builds the same data from the seed). On a `DeviceMesh` they work on
this rank's shard and return this rank's data shard of the result
(`gather_data` reassembles rows over "data"); on a `LocalMesh` they run
every shard and return all rows, the data shards concatenated in order.
Rows and components must divide evenly over their axes.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from quantized_channel_estimation_torch.estimators import (
    circ_kernels, fact_kernels, kernels)
from quantized_channel_estimation_torch.estimators.kernels import merge_stats
from quantized_channel_estimation_torch.models import (
    gmm, gmm_estimator, gmm_quant, mfa, mfa_bank, structured_bank)
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


class LocalMesh:
    """A (data, component) mesh of one process on one device (JAX's single
    controller): `shape` maps "data" and "component" to their sizes, and on
    a card each component shard runs on its own CUDA stream (`streams`),
    made at first use. Built by `make_local_mesh`."""

    def __init__(self, n_data: int, n_component: int, device=None):
        if n_data < 1 or n_component < 1:
            raise ValueError(f"a mesh needs at least one shard an axis; got "
                             f"{n_data} x {n_component}")
        self.shape = {DATA_AXIS: int(n_data), COMPONENT_AXIS: int(n_component)}
        self.device = None if device is None else torch.device(device)
        self._streams = {}
        self._lock = threading.Lock()   # services sharing a mesh

    def streams(self, device: torch.device) -> list:
        """One CUDA stream a component shard on `device` (a card), or Nones
        on the CPU, where the shards run in turn."""
        n_c = self.shape[COMPONENT_AXIS]
        if device.type != "cuda":
            return [None] * n_c
        with self._lock:
            if device not in self._streams:
                self._streams[device] = [torch.cuda.Stream(device)
                                         for _ in range(n_c)]
            return self._streams[device]


def make_local_mesh(n_data: int, n_component: int,
                    device=None) -> LocalMesh:
    """The in-process (data, component) mesh of n_data x n_component
    shards on one device (`device`, or the device of the rows it is given:
    an estimation service's). No process group is needed."""
    return LocalMesh(n_data, n_component, device)


def axis_size(mesh, axis: str) -> int:
    if isinstance(mesh, LocalMesh):
        return mesh.shape[axis]
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


def bank_shard(bank, n_component: int, idx: int):
    """Component shard `idx` of `n_component` of a bank of any type
    (`PreparedBank`, `CirculantBank`, `CirculantBankMP`, `FactoredBank`:
    every field leads with K); views, no copy."""
    sl = _window(bank[0].shape[0], n_component, idx, "K")
    return type(bank)(*(x[sl] for x in bank))


def shard_bank(mesh: DeviceMesh, bank):
    """This rank's components of a bank (`bank_shard` at its 'component'
    coordinate)."""
    return bank_shard(bank, axis_size(mesh, COMPONENT_AXIS),
                      mesh.get_local_rank(COMPONENT_AXIS))


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


def _quotient(den: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The normalised estimate acc / den of a merged state."""
    expand = (1,) * (acc.dim() - den.dim())
    return acc / den.reshape(den.shape + expand).to(acc.dtype)


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
    return _quotient(den, acc)


def _merged_quotient(states) -> torch.Tensor:
    """The component shards' states (m, den, acc) merged with
    `kernels.merge_stats`: the normalised quotient."""
    return _quotient(*merge_stats(*zip(*states))[1:])


def _local_merged(mesh: LocalMesh, bank, r: torch.Tensor, stats_fn,
                  caches, merge: Callable = _merged_quotient) -> torch.Tensor:
    """Every shard of an in-process mesh: for each 'data' window of r, each
    component shard's state by `stats_fn(bank_l, r_l, cache)` on its own
    stream, merged by `merge` (default: `kernels.merge_stats` and the
    quotient); the windows' estimates in order. On a card every shard
    stream waits for r to land on the current stream, r is recorded on the
    streams that read it and the states on the current stream, which waits
    for every shard before the merge."""
    n_d, n_c = mesh.shape[DATA_AXIS], mesh.shape[COMPONENT_AXIS]
    shards = [bank_shard(bank, n_c, j) for j in range(n_c)]
    caches = [None] * n_c if caches is None else caches
    rows = [r[_window(r.shape[0], n_d, i, "n_samples")] for i in range(n_d)]
    streams = mesh.streams(r.device)
    if streams[0] is None:
        return torch.cat([merge([stats_fn(shards[j], r_i, caches[j])
                                 for j in range(n_c)]) for r_i in rows])
    main = torch.cuda.current_stream(r.device)
    landed = main.record_event()
    states = [[None] * n_c for _ in rows]
    for j, stream in enumerate(streams):
        stream.wait_event(landed)
        r.record_stream(stream)
        with torch.cuda.stream(stream):
            for i, r_i in enumerate(rows):
                states[i][j] = stats_fn(shards[j], r_i, caches[j])
        main.wait_event(stream.record_event())
    for row_states in states:
        for state in row_states:
            for x in state:
                x.record_stream(main)
    return torch.cat([merge(row_states) for row_states in states])


def _sharded(mesh, bank, r: torch.Tensor, stats_fn: Callable,
             caches: Optional[Sequence[dict]]) -> torch.Tensor:
    """The merged quotient of the sharded estimate: on a `DeviceMesh`
    this rank's shard state `stats_fn(bank_l, r_l, cache)` merged by
    collectives (this rank's rows); on a `LocalMesh` every shard's, merged
    in process (all rows). `caches`: one dict a component shard for the
    kernel layouts of its bank shard, or None."""
    if isinstance(mesh, LocalMesh):
        return _local_merged(mesh, bank, r, stats_fn, caches)
    j = mesh.get_local_rank(COMPONENT_AXIS)
    m, den, acc = stats_fn(shard_bank(mesh, bank), shard_data(mesh, r),
                           None if caches is None else caches[j])
    return _merge_components(mesh, m, den, acc)


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


def fit_gmm_quant_shard_map(mesh: DeviceMesh, gen: torch.Generator,
                            r: torch.Tensor, cfg: GmmConfig, n_bits, sigma2,
                            q=None) -> gmm_quant.QuantGmmFitResult:
    """Data-parallel quantized-training EM (CSI-free training): the
    recovery statistics (1-bit requantized correlation, bin-occupancy
    counts) are data sums like the moments and are all-reduced with them
    over 'data', so the covariance recovery runs replicated; the init is
    the data-parallel k-means (or the global random stream's window).
    `gen` must be seeded alike on every rank (its Gauss-Newton restarts
    keep the M-step replicated)."""
    return gmm_quant.fit(gen, shard_data(mesh, r), cfg, n_bits, sigma2, q,
                         group=mesh.get_group(DATA_AXIS))


def fit_circulant_spectra_shard_map(mesh: DeviceMesh, gen: torch.Generator,
                                    r: torch.Tensor, cfg: GmmConfig, n_bits,
                                    sigma2, q=None
                                    ) -> gmm_quant.QuantCircFitResult:
    """Data-parallel spectra-native circulant quantized EM: the statistics
    all-reduced an iteration are O(K D) spectra sums (O(K D^2) for the
    dense types); the init is the data-parallel dense one."""
    return gmm_quant.fit_circulant_spectra(gen, shard_data(mesh, r), cfg,
                                           n_bits, sigma2, q,
                                           group=mesh.get_group(DATA_AXIS))


def make_vae_epochs_runner(mesh: DeviceMesh, model, cfg, a, snrs, quantizers,
                           n_steps: int, n_epochs: int):
    """A data-parallel VAE epoch-block runner over the mesh's 'data' axis:
    each rank trains on its window of the rows and draws its own batches
    (its data rank keys its stream; rank 0 draws the single-device stream),
    and the gradient and the loss are averaged over 'data' every step in one
    all-reduce (`vae.make_train_step(group=)`), so the state stays
    replicated. Effective batch cfg.batch_size x n_data_shards.

    Returns run(state, h_train, stream, epoch0) -> (state, per-epoch mean
    losses on the device): h_train the global rows, which every rank
    holds; stream the training SeedSequence (`vae.train`'s second child of
    its seed); epoch0 the first epoch's index."""
    from quantized_channel_estimation_torch.models import vae
    if isinstance(mesh, LocalMesh):
        raise ValueError("data-parallel VAE training runs over the ranks of "
                         "a torch.distributed DeviceMesh (make_mesh), not an "
                         "in-process LocalMesh")
    step = vae.make_train_step(model, cfg, a, snrs, quantizers,
                               group=mesh.get_group(DATA_AXIS),
                               rank=mesh.get_local_rank(DATA_AXIS))

    def run(state, h_train, stream, epoch0: int = 0):
        return step.run_epochs(state, shard_data(mesh, h_train), stream,
                               int(epoch0), n_steps, n_epochs)

    return run


def vae_run_epochs_shard_map(mesh: DeviceMesh, model, cfg, a, snrs,
                             quantizers, state, h_train: torch.Tensor,
                             stream, n_steps: int, n_epochs: int,
                             epoch0: int = 0):
    """One-shot form of `make_vae_epochs_runner`."""
    run = make_vae_epochs_runner(mesh, model, cfg, a, snrs, quantizers,
                                 n_steps, n_epochs)
    return run(state, h_train, stream, epoch0)


# ---------------------------------------------------------------------------
# tensor-parallel estimation
# ---------------------------------------------------------------------------

def kernel_shard_stats(bank_l: PreparedBank, r_l: torch.Tensor,
                       use_kernel: bool = True, chunk_size: int = 2048,
                       coherence_alpha: float = 1.0,
                       cache: Optional[dict] = None):
    """One dense shard's 'all'-mode state (m, den, acc) of rows r_l: K2
    (`kernels.estimate_fused_stats`: the CUDA kernel on a card, its plain
    version on the CPU, the einsum stats path past the kernel's widths),
    for rank-3 r_l (B, T, M) K2's coherent form with the alpha blend;
    `use_kernel=False` the einsum stats path (the same logit convention).
    `cache`: the shard's kernel layouts (`kernels.lowered`)."""
    alpha = float(coherence_alpha)
    if r_l.dim() == 3:
        if use_kernel:
            return kernels.estimate_fused_coherent_stats(bank_l, r_l, alpha,
                                                         cache)
        return gmm_estimator.estimate_coherent_stats(
            bank_l, r_l, max(1, chunk_size // r_l.shape[1]), alpha)
    if use_kernel:
        return kernels.estimate_fused_stats(bank_l, r_l, cache)
    return gmm_estimator.estimate_stats(bank_l, r_l, chunk_size)


def estimate_sharded_kernel(mesh, bank: PreparedBank,
                            r: torch.Tensor, use_kernel: bool = True,
                            chunk_size: int = 2048,
                            coherence_alpha: float = 1.0,
                            caches: Optional[Sequence[dict]] = None
                            ) -> torch.Tensor:
    """Tensor-parallel 'all'-mode estimation: samples over 'data', the
    bank's components over 'component'. Each shard runs K2
    (`kernel_shard_stats`) and the shard states merge exactly.

    r of rank 3 is (B, T, M) coherence blocks: each shard's block-pooled
    state through K2's coherent form (per block at alpha = 1, per snapshot
    below), merged the same way; equals `estimate_coherent(bank, r,
    'all')` on every mesh. Returns this rank's data shard of the estimate
    (a `LocalMesh`: all rows). `caches`: see `_sharded`."""
    return _sharded(mesh, bank, r, lambda b, x, c: kernel_shard_stats(
        b, x, use_kernel, chunk_size, coherence_alpha, c), caches).to(r.dtype)


def circulant_shard_stats(bank_l, r_l: torch.Tensor, use_kernel: bool,
                          chunk_size: int = 16384,
                          coherence_alpha: float = 1.0, blocks=None,
                          cache: Optional[dict] = None):
    """One circulant shard's DFT-domain state (m, den, acc) of rows r_l
    (rank 3: coherence blocks): K8 (flat) / K9 (coherent) with
    `use_kernel` (past D = 128 the factorised kernel's STATS form where the
    transform splits, else their dense wide form: `circ_kernels.circ_route`),
    else the `torch.fft` pipelines' stats forms (a `CirculantBankMP`: the
    multi-pilot ones). `cache`: the shard's kernel layouts and operands
    (`circ_kernels.lowered`, `lowered_tc`)."""
    multi = isinstance(bank_l, structured_bank.CirculantBankMP)
    if use_kernel and multi:
        raise ValueError("the circulant stats kernels take single-pilot "
                         "banks; a CirculantBankMP takes the pipeline")
    coherent = r_l.dim() == 3
    t = r_l.shape[1] if coherent else 1
    alpha = float(coherence_alpha)
    sb = structured_bank
    if multi and coherent:
        return sb.estimate_circulant_mp_coherent_stats(
            bank_l, r_l, max(1, chunk_size // (4 * t)), alpha, blocks)
    if multi:
        return sb.estimate_circulant_mp_stats(
            bank_l, r_l, max(1, chunk_size // 4), blocks)
    if use_kernel and coherent:
        return circ_kernels.estimate_fused_circulant_coherent_stats(
            bank_l, r_l, alpha, blocks, cache)
    if use_kernel:
        return circ_kernels.estimate_fused_circulant_stats(bank_l, r_l,
                                                           blocks, cache)
    if coherent:
        return sb.estimate_circulant_coherent_stats(
            bank_l, r_l, max(1, chunk_size // t), alpha, blocks)
    return sb.estimate_circulant_stats(bank_l, r_l, chunk_size, blocks)


def estimate_sharded_circulant(mesh, bank, r: torch.Tensor,
                               chunk_size: int = 16384,
                               coherence_alpha: float = 1.0, blocks=None,
                               use_kernel: Optional[bool] = None,
                               caches: Optional[Sequence[dict]] = None
                               ) -> torch.Tensor:
    """Tensor-parallel FFT-domain estimation of a `CirculantBank` or
    `CirculantBankMP` split over 'component': each shard computes its
    components' DFT-domain state (`circulant_shard_stats`), the shards
    merge as in `estimate_sharded_kernel`, and one inverse transform runs
    on the merged quotient (it commutes with the per-row normalisation).
    Rank-3 r: coherence blocks. `use_kernel=None` takes the stats kernels
    K8 / K9 (past D = 128 the factorised kernel's STATS form where the
    transform splits, else their dense wide form) for a single-pilot bank
    whose shard is within `circ_kernels.circ_kernel_eligible` (D <= 672),
    else the pipelines (always for a `CirculantBankMP`): a rule of shapes
    equal on every shard, so every shard takes the same route (kernel and
    pipeline logits differ by a row constant and must not be merged; the
    two kernel routes keep one logit convention, and their states merge).
    `caches`: see `_sharded`."""
    if use_kernel is None:
        k, d = bank.mean_rf.shape[:2]
        use_kernel = (not isinstance(bank, structured_bank.CirculantBankMP)
                      and circ_kernels.circ_kernel_eligible(
                          d, k // axis_size(mesh, COMPONENT_AXIS),
                          r.shape[1] if r.dim() == 3 else 1))
    h_f = _sharded(mesh, bank, r, lambda b, x, c: circulant_shard_stats(
        b, x, use_kernel, chunk_size, coherence_alpha, blocks, c), caches)
    return structured_bank.unitary_ifft(h_f, blocks).to(r.dtype)


def factored_shard_stats(bank_l, r_l: torch.Tensor, use_kernel: bool,
                         chunk_size: int = 4096, coherence_alpha: float = 1.0,
                         cache: Optional[dict] = None):
    """One factored shard's state (m, den, acc) of rows r_l: K13 with
    `use_kernel` (flat rows), else the `torch.matmul` pipeline's stats
    forms (rank-3 r_l: the coherent one). `cache`: the shard's kernel
    layouts and operands (`fact_kernels.lowered`, `lowered_tc`)."""
    if r_l.dim() == 3:
        return mfa_bank.estimate_factored_coherent_stats(
            bank_l, r_l, max(1, chunk_size // r_l.shape[1]),
            float(coherence_alpha))
    if use_kernel:
        return fact_kernels.estimate_fused_factored_stats(bank_l, r_l, cache)
    return mfa_bank.estimate_factored_stats(bank_l, r_l, chunk_size)


def estimate_sharded_factored(mesh, bank, r: torch.Tensor,
                              chunk_size: int = 4096,
                              coherence_alpha: float = 1.0,
                              use_kernel: Optional[bool] = None,
                              caches: Optional[Sequence[dict]] = None
                              ) -> torch.Tensor:
    """Tensor-parallel factored (MFA, Woodbury) estimation of a
    `FactoredBank` split over 'component' (`factored_shard_stats`), merged
    as in `estimate_sharded_kernel`. `use_kernel=None` takes the stats
    kernel K13 for flat rows whose shard is within
    `fact_kernels.fact_kernel_eligible`; coherence blocks take the
    pipeline (K12 has no stats form). `caches`: see `_sharded`."""
    if use_kernel is None:
        k, m_lat, d = bank.t_mat.shape
        use_kernel = r.dim() == 2 and fact_kernels.fact_kernel_eligible(
            d, k // axis_size(mesh, COMPONENT_AXIS), m_lat)
    return _sharded(mesh, bank, r, lambda b, x, c: factored_shard_stats(
        b, x, use_kernel, chunk_size, coherence_alpha, c), caches).to(r.dtype)


def _gather_bank(mesh: DeviceMesh, bank_l):
    """The whole bank, all-gathered over 'component' from the shards."""
    return type(bank_l)(*(torch.cat(_gather_components(mesh, x))
                          for x in bank_l))


def estimate_sharded(mesh: DeviceMesh, bank: PreparedBank, r: torch.Tensor,
                     mode: Union[str, int, float] = "all",
                     chunk_size: int = 2048,
                     coherence_alpha: float = 1.0, use_kernel: bool = True,
                     caches: Optional[Sequence[dict]] = None
                     ) -> torch.Tensor:
    """Sharded estimation in every selection mode, samples over 'data' and
    the bank over 'component':

      - 'all': `estimate_sharded_kernel`;
      - int top-k modes within `kernels.topk_mode_eligible` (flat rows): K5
        (past 2M, 2D <= 256 its wide form) on each shard, the shards' k
        candidates all-gathered over 'component' (k (1 + 2D) floats a row,
        independent of K) and merged with `kernels.merge_topk` (ties to the
        lower component, as one K4 launch);
      - float cumulative-p modes, rank-3 selection requests and, with
        `use_kernel=False`, every selection mode: the einsum estimator on
        the bank all-gathered over 'component' (JAX's GSPMD route is that
        einsum).

    On a `LocalMesh` every shard runs in process (`_local_merged`: each
    component shard on its own stream) and all rows are returned; else
    this rank's data shard of the estimate. `caches`: see `_sharded`."""
    if mode == "all":
        return estimate_sharded_kernel(mesh, bank, r, use_kernel, chunk_size,
                                       coherence_alpha, caches)
    k, d, m = bank.filters.shape
    topk = (use_kernel and r.dim() == 2
            and kernels.topk_mode_eligible(d, k, m, mode))
    if isinstance(mesh, LocalMesh):
        if topk:
            return _local_merged(
                mesh, bank, r,
                lambda b, x, c: kernels.estimate_fused_topk_stats(b, x, mode,
                                                                  c),
                caches, lambda states: kernels._h(kernels.merge_topk(
                    *zip(*states), mode), d, r.dtype))
        if r.dim() == 3:
            return gmm_estimator.estimate_coherent(
                bank, r, mode, max(1, chunk_size // r.shape[1]),
                float(coherence_alpha))
        return gmm_estimator.estimate(bank, r, mode, chunk_size)
    bank_l, r_l = shard_bank(mesh, bank), shard_data(mesh, r)
    if topk:
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
