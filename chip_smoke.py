"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of every CUDA kernel of the port from `csrc/` with `nvcc` (the
     `-Xptxas -v` summary of the redesigned sources; K14a's forms at M, D
     <= 64 and every instantiation of K11-K13 and of K6-K10 (the 44 of
     `mp_circ_estimate.cu`) and of the wide K6-K10
     (`circ_wide_estimate.cu`) must not spill);
  2. every kernel against its plain PyTorch version on the card, at the
     widths of the main path (D = M = 64, K = 64): K1 at the headline batch
     N = 131072, at the main path's ragged N = 10000 and with dead
     components; K3 at B*T = 131072 rows for T in {2, 4, 16} and alpha in
     {1, 0.25}, T = 3 (alpha 0.5) and T = 64 (alpha 1, held under the
     float64 rule), and at a ragged block count with dead components; K4 for
     k in {1, 2, 4, 8} at N = 131072, and at a ragged N with dead
     components (rows whose k-th and (k+1)-th logits lie within 1e-3 are
     counted, not compared); the circulant kernels on a seeded circulant
     bank (2-bit, 10 dB): K6 at the same three sizes, K7 over the same
     (T, alpha) grid and ragged case, K8 and K9 as a two-shard split of
     the K = 64 bank merged with `merge_stats` and inverse-transformed
     once, against K6 / K7 and against the plain stats, one
     block-circulant case `blocks=(8, 8)` and two other template widths
     (D = 32 with K = 40, D = 128 with K = 128), and K8 / K9 on the two
     128-component shards of a K = 256 bank, as the K = 256 service runs
     them, at a 512-row microbatch and at N = 131072, K7 and K9 at T = 64
     at D = K = 128, and K6, K7 (T = 4), K8 and K9 (T = 4, two shards,
     each state and the merged quotient) at the headline and at D = K =
     128 under the float64 rule (`fp32_accuracy`, below); the multi-pilot
     circulant kernel K10 on seeded banks under the kron(x, I) pilot of
     `pilots.pilot_matrix`: P in {2, 3, 4} pilots at D, K = (16, 8),
     (24, 40), (64, 64) with dead components and a ragged N, 1-bit and
     unquantized banks, `blocks=(8, 8)`, the widest instantiation (D = K =
     128, P = 4), and its coherent form over the same (T, alpha) grid at
     N = 131072, a ragged block count and the largest T of both tile
     sizes, and K10 flat and coherent (T = 4) at the headline for P = 2
     and 4 under the float64 rule (`fp32_accuracy`, below); the factored
     (MFA) kernels on seeded MFA priors (D = K = 64,
     M = 16, 2-bit, 10 dB, zero and non-zero means, dead components): K11
     and K13 at N = 131072, the main path's N and a ragged N, K12 for T = 4
     at alpha in {1, 0.25, 0}, T = 16 and a ragged block count, the edges
     M = 6 and D = 32, and K13 as a two-shard split merged with
     `merge_stats` against K11, and K11, K12 (T = 4) and K13 at the
     headline under the float64 rule (`fp32_accuracy`: within twice the
     float32 plain version's error against float64, their six-product
     claim); the split-K kernels of the mesh path: K2
     on the whole bank and on two and four component shards, with dead
     components and a ragged N, and on the two 128-component shards of a
     K = 256 bank, its coherent form at T = 4 for alpha in {1, 0.5}, each
     shard's (m, den, acc) against the plain version and the shards merged
     with `merge_stats` against one K1 / K3 launch (to 1e-5 of the scale),
     and K5 for k in {1, 4} (and k = 4 with dead components at a ragged N)
     on two shards against the plain version and merged with `merge_topk`
     against one K4 launch (near-tie rows not compared); fault F1: a dense
     bank with 2M = 2064 (129 pilots, D = 8), past the dense kernels' 2M <=
     2048, through
     `stages.estimate_auto` and `kernels.estimate_fused_coherent` at T = 1
     against the einsum estimator (to 1e-5, no kernel launched); and the
     entries the mesh path runs on each rank (K8, K9, K13) on two
     in-process shards, merged, against the unsharded K6 / K7 / K11 stages.
     Where float32 sums in
     another order push a circulant or factored kernel past TOL of its plain
     version (large T, or K10's one long logit product), both are held
     against the float64 evaluation of the same
     arithmetic, the kernel to within twice the plain version's own error;
  3. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after: `run_gmm.run` at the `GmmBenchConfig`
     defaults (its fitted bank and observations kept: K1, K3 at T = 4 and
     K14a against their plain versions and under the float64 rule at each
     of its 7 SNRs, with the blmmse_gmm NMSE of K1 and K3), and again with
     `n_coherence=4` (alpha 1),
     then both once
     more with `cov_type='circulant'` (the FFT-domain bank, K6 and K7; the
     fitted circulant bank of each of the 7 SNRs kept: K6, K7 at T = 4 and
     K8 / K9 as two merged shards under the float64 rule),
     and those two with `n_pilots=2` (the multi-pilot bank, K10 and its
     coherent form; the fitted 2-pilot bank of each of the 7 SNRs kept: K10
     and its coherent form at T = 4 against their plain versions and under
     the float64 rule), with the scientific invariants of their MSE tables
     and the multi-pilot estimate held against the dense bank's (K1 at M =
     128) from the same fit; `run_mfa.run` at the `MfaBenchConfig` defaults
     (the factored bank, K11; its fitted bank at each of its 7 SNRs kept:
     K11, K12 at T = 4 and K13 against their plain versions and under the
     float64 rule) and with `n_coherence=4` (K12), its MSE invariants
     checked and the factored estimate held against the dense bank's (K1)
     from the same fit at -10 and 10 dB; then the
     `EstimationService` at the headline widths (the synthetic bank of
     `tools/serving_bench.py`, 8 closed-loop clients of 64-snapshot
     requests at -5/5/15 dB, max_batch 1024) in ten modes: flat 'all',
     T=4 blocks, top-1 and top-4, each held against the plain einsum
     estimator on one request; `structured=True` flat and T=4 blocks (K6,
     K7) and `from_circulant_spectra` with K = 256 components flat and
     T=4 blocks (two shards through K8 / K9, merged), and
     `structured=True` with a P = 2 kron(x, I) matrix flat and T=4 blocks
     (K10 and its coherent form), each held against the `torch.fft`
     pipeline, and `from_mfa` with a seeded MFA prior (D = K = 64, M = 16)
     flat and T=4 blocks (K11, K12), held against the `torch.matmul`
     pipeline; with its throughput, latency and `metrics()`; then the mesh
     path at world size 1: a one-rank NCCL group and a (1, 1) mesh,
     `ShardedStages.gmm_fit` at the `run_gmm` defaults against `gmm.fit`
     from the same generator (lower bound per iteration to rtol 2e-5), the
     quantized EMs' mesh forms `ShardedStages.gmm_quant_fit` ('full') and
     `gmm_quant_fit_circulant_spectra` on 2-bit pilots of those channels at
     5 dB against the single-device fits (lower bound per iteration to
     rtol 2e-5, covariances / spectra to TOL of scale), and
     `estimate_sharded_kernel` (flat, T = 4 blocks),
     `estimate_sharded_circulant` and `estimate_sharded_factored` (each
     flat and T = 4 blocks) and `estimate_sharded` (k = 4) on the headline
     banks against their single-device stages, launching K2, K5, K8, K9
     and K13; then `run_gmm` at the defaults with `cov_type='toeplitz'`
     (the inverse EM; K1 launched once an SNR, genie < gmm < LS at 10 dB,
     the fitted covariances Toeplitz to the JAX test's 5e-2), and again
     with `gmm_fit_segments=4` (every segment but the last its 25
     iterations, the total the whole fit's unless that converged earlier,
     when both must have; its lower bound within 0.3 of the whole fit's),
     both runs' NMSE rows printed; then CSI-free training:
     `run_gmm_quant.run` at the `QuantGmmBenchConfig` defaults (the
     quantized EM on 100k 2-bit pilots at 5 dB, K1 launched exactly once;
     K1 on its fitted bank and validation observations against its plain
     version and under the float64 rule; every recovered covariance at or
     above its floor; the NMSE finite and below the LS estimate's on the
     same observations, printed beside `run_gmm`'s `blmmse_gmm` at 5 dB;
     the fit's iterations, seconds and host synchronizations) and again
     with 'toeplitz', 'diag' (K1 once each) and 'circulant' at
     `n_coherence=4` (K6 and K7 once each), and `run_cov_recovery.run` at
     the `CovRecoveryConfig` defaults without its plot (the recovered NMSE
     falling with n and below the quantized sample covariance's from
     n = 10^4 on: at D = 64 the two cross between 10^3 and 10^4 samples,
     in the JAX harness too); then CSI-free training at frontier D (phase
     3f): the circulant `n_coherence=4` run with `use_spectra_fit=True`
     (K6 and K7 launched once each on the spectra-fed bank and held
     against their plain versions and under the float64 rule; the NMSE
     within 1.25x of the dense-recovery circulant run), again with the
     streamed k-means init forced (within 1.15x), and through
     `tools.quant_frontier` the JAX tool's D = 16384 row (K = 16, 40k / 2k
     rows, 10 dB, 30 iterations: streamed pilots, streamed init and the
     spectra fit engaged by 'auto') and D = 2048 with 60k rows and the
     rate column, each with datagen and fit seconds, iterations, host
     synchronizations, peak memory and the NMSE below LS; then the VAE
     (phase 3g, `vae_phase`; no kernel of its own, its launch counts read
     and held at 0): `run_vae.run` in genie, noisy and real mode at the
     `VaeBenchConfig` widths (D = 64, latent 16, 4 layers, batch 200, 2
     bits, 7 SNRs) under the JAX package's D = 64 protocol (20k / 2k
     channels, 60 epochs), its NMSE at 5 and 15 dB within 1.10x the JAX
     package's recorded values and falling from -10 to 10 dB, with train
     seconds, steps/s, host synchronizations per epoch and peak memory;
     noisy with `n_coherence=4`; the structured estimate against the dense
     one at every SNR, 1 and 2 bits; one epoch at 100k channels timed and
     projected to 500 epochs; bit-identical resume, the NaN guard, the
     data-parallel trainer over a one-rank NCCL group against one device,
     and `VaeEstimationService` under the serving protocol (flat, T = 4)
     against direct `vae.estimate`; then the other channel models (phase
     3h, `channel_models_phase`): `run_gmm` on Kronecker-MIMO channels
     (16 x 4 antennas, 2 paths, T = 4 at alpha 0.25; K1 and K3 once an SNR
     and held against their plain versions on the run's fitted banks, the
     kron genie < GMM < global BLMMSE at 20 dB, the NMSE at -10 and -5 dB
     within 1.10x of BASELINE.md:101), on urban-macro channels (6 paths,
     T = 4, alpha 1; within 1.10x of BASELINE.md:100 at -10 dB), `run_mfa`
     on the MIMO data set (T = 4, alpha 'auto'; K11 and K12 held against
     their plain versions, within 1.10x of BASELINE.md:149 at every SNR),
     `run_gmm_quant` on urban-macro channels (K1 once, NMSE below LS),
     `run_vae` noisy on MIMO channels (no kernel, NMSE falling), and the
     three generators alone at 110k rows (datagen seconds, host
     synchronizations, peak memory, the MIMO power and covariance against
     the kron genie, the urban-macro path-loss range), each run with its
     seconds, datagen seconds, fit iterations, host synchronizations and
     peak memory; then the user examples (phase 3i, `examples_phase`):
     the ten modules of `quantized_channel_estimation_torch.examples` at
     their JAX scripts' sizes (10 at a 1 x 1 mesh), each with its own
     claim held (`check`), its seconds, headline NMSE and the launches of
     the kernels it reaches (K1 in 01, 07 and 10, K2 in 03, K3 and K11 in
     07, K6 / K7 in 08, K11 in 09; none in 02 and 04-06); then the
     large-array dense path (phase 3j, `wide_dense_phase`): the wide form
     of K1-K3 (2M or 2D past 256) at (2M, 2D) = (512, 512), (512, 128),
     (640, 128), (512, 256) and (400, 400) against the plain versions and
     under the float64 rule, K2 on two component shards merged against
     one K1 launch, `tools.scale_bench_large_d` at D = 256, K = 32
     (Toeplitz; genie < GMM < LS, the wide K1 within TOL of the einsum
     estimator, its rate beside the einsum's), the wide K3 through
     `stages.estimate_coherent_auto` and the wide K2 through
     `estimate_sharded_kernel` on a four-pilot bank (2M = 512), the einsum
     estimators made to raise on those routes, 20 NaN-poisoned repeats a
     shape, and the wide kernels' times at D = 256, K = 32, 32768 rows;
     then top-k selection on wide banks (phase 3k, `wide_topk_phase`): the
     wide form of K4 and K5 at the same five widths for k in {1, 4}
     against their plain versions (rows whose k-th and (k+1)-th logits lie
     within max(1e-3, 1e-5 |logit|) not compared, at least 90% compared),
     its picks those of the float64 plain version and under the float64
     rule, K5 on two component shards merged within 1e-5 of one K4 launch;
     `stages.estimate_auto` at k = 1 and 4 on phase 3j's fitted D = 256
     bank (its NMSE beside the 'all' mode's), `run_gmm` at the defaults
     with three pilots (2M = 384) in top-1 mode, the service in mode 1 on
     the four-pilot headline prior (every answer against an einsum
     service's) and `estimate_sharded` at k = 4 over an in-process 1 x 2
     mesh, the einsum estimator made to raise on those routes; 20
     repeats a shape on NaN-filled outputs, and the times at D = 256, K =
     32, 32768 rows beside the bound, the fp32 logit GEMM and the einsum
     estimator; then the circulant kernels on wide banks (phase 3l,
     `wide_circ_phase`): past D = 128, up to the rule's D = 672, K6 / K7
     on the factorised kernel where the transform splits and on the wide
     form elsewhere, K8 / K9 on the wide form, at D in {129, 131, 134,
     192, 256, 357, 512, 640, 652, 672}, K in {1, 8, 16, 64, 128, 200}
     (200: two K8 / K9 shards merged), T in {1, 4, 16, 64}, alpha in {1,
     0.25}, dead components and `blocks=(16, 16)` against the plain
     versions within TOL, K6-K9 at D = 512 and 672 under the float64 rule,
     the factorised K6 / K7 there against the float64 `torch.fft`
     pipeline, `tools.circ_kernel_bench` (its four legs), `run_gmm` at D =
     512, K = 16 with `cov_type='circulant'` flat and at T = 4 (genie <
     GMM < LS at every SNR; the flat run's NMSE within TOL of the same
     run through the `torch.fft` pipeline), the structured service on a D
     = 512 bank against the `torch.fft` service,
     `estimate_sharded_circulant` over
     an in-process 1 x 2 mesh flat and at T = 4 (past TOL of the
     `torch.fft` answers, held against float64), the stages' entries at D
     = 652 (the wide K6 / K7), 20 NaN-poisoned repeats a shape, and the
     times at D = 512, K = 16, 32768 rows beside the bound, the plain
     version and the `torch.fft` pipeline (the factorised K6 / K7 and the
     wide form in one call; the factorised ones at D = 672 too), and one
     record of the narrow headline (D = 64, K = 64, 131072 rows: the
     factorised kernel beside the narrow K6 template); then the
     multi-pilot circulant
     kernel on wide banks (phase 3m, `wide_mp_circ_phase`): the wide form
     of K10 (past the template's rule) at twelve (D, K, P, T, alpha)
     cases from D = 129 to 357, K to 4096, P to 4, T in {1, 4, 16}, dead
     components and `blocks=(16, 16)` against its plain version
     `mp_circ_wide_reference` within TOL (or the float64 rule of
     `compare64` at ceiling TOL), each case's entry the same bits, the
     float64 rule (`fp32_accuracy`) at D = 256 and 336,
     `tools.mp_kernel_bench` at its defaults (D = K = 64) and at D = 256,
     K = 32, `run_gmm` at D = 256, K = 32, circulant, two pilots, flat and
     at T = 4 (the wide K10 once an SNR; genie < GMM < LS at -10 and -5
     dB), the structured service on a two-pilot D = 256 prior against the
     one-shot estimates, 20 NaN-poisoned repeats a shape, and the times at
     D = 256, K = 32, P = 2, 65536 rows beside the bound, the plain
     version and the `torch.fft` pipeline; then the factored kernels on
     wide banks (phase 3n, `wide_fact_phase`): the wide form of K11-K13
     (past the template's D <= 128, M <= 64) at eleven (D, K, M, T,
     alpha) cases from D = 129 to 5551, M to 2475, the JAX rule's reach
     edges among them, T in {1, 4, 16}, dead components, against its
     plain version `fact_wide_reference` within TOL (or the float64 rule
     of `compare64` at ceiling TOL), each case's entry the same bits, K13
     on two shards merged against K11, the float64 rule (`fp32_accuracy`)
     at the widest D and M, `tools.mfa_bank_bench` (its d64 and d512
     legs), `run_mfa` at D = 256, K = 32, M = 16 flat and at T = 4 (the
     wide K11 / K12 once an SNR; genie < MFA < LS at -10 and -5 dB; the
     factored estimate within TOL of the dense bank's), the factored
     service on a D = 256 prior against the one-shot estimates, the wide
     K13 over an in-process 1 x 2 mesh against the wide K11, 20
     NaN-poisoned repeats a shape, and the times at D = 256, K = 32, M =
     16, 32768 rows beside the bound, the plain version and the
     `torch.matmul` pipeline; then the service over
     in-process meshes (`parallel.mesh.make_local_mesh`) of 1 x 2 and 2 x 2
     shards in eight modes each (dense, structured at K = 64 and the K =
     256 spectra-native prior, factored; flat and T=4 blocks; 1 s each),
     every answer within TOL of scale of the one-device service's to the
     same request, each mode launching its stats kernel (K2, K8 / K9, K13;
     factored blocks the `torch.matmul` coherent stats, K12 having no stats
     form) and no pipeline stats path where the kernel is eligible, with
     estimates/s, p50 and p99 beside the one-device service's;
  4. CUDA-event times of each kernel, its plain version and a library
     yardstick at the headline shapes (K11-K13 at M = 16; K2 also on one
     32-component shard), beside the least time the card could take (for
     K1-K3, K6-K10, K11-K13 and K15, six bf16 products on the tensor cores,
     also the bound of their products as fp32 FMAs; for K1-K3 and K15 a
     chain of the six bf16 GEMMs, each adding into one float32 result);
  5. the kernel-measurement path, K1's variants: the Karatsuba estimator
     K14a, the bf16 tensor-core modes K14b ('bf16', 'split2', 'split3') and
     the seven bodies of the floor probe K15 against their plain versions
     at the headline shapes, a ragged N and with dead components, and
     against K1 (K14a to 1e-4 of the scale, K15 `full` bit for bit, K14b
     within the JAX tests' relative norms 3e-2 / 1e-4 / 3e-2; split3's
     max-abs error against K1's plain version); K1, K3 at T = 4, K14a and
     split3 against the plain version in float64, where K1, K3 and K14a
     must be within twice the float32 plain version's error and split3
     must not be (`fp32_accuracy`, also on the fitted banks of phase 3);
     K14b, K14a, K11-K13, K10 and K6-K9 launched 100 times and K1 / K3 150
     times at
     each shape of `tools.tc_repeat_check`, each launch after a fill of
     every SM's shared memory with NaN and held against its plain version;
     then the
     tools `kernel_floor_probe`, `kernel_bench` and `kernel_split_bench`
     at their defaults with their own launch counts (no probe variant under
     the GEMM's operation floor; K1's and split3's MSE within 1e-3 of the
     einsum estimator's at 10 and 20 dB), the times of K14a, K14b and K15
     as in phase 4 (K14a's bound that of its six bf16 products per real
     product), one K1 launch under `utils.profiling.trace` with its row of
     the profiler's table, and K1 / K3 / K14a / K11-K13 / K10 / K6-K9 at
     512, 4096 and 131072 rows (`tools.batch_sweep`);
then one JSON line of kernels, one of the main paths' results, one of the
serving phases (one device and meshes), one of the examples, the card
line, and the final status line. It imports nothing
of JAX and uses one card.
"""
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # dense, tensor cores
PEAK_HBM_BYTES = 3.35e12
TOL = 1e-4          # max |kernel - plain| / max |plain|, float32 sums
# K14b against K1: relative norms of the JAX tests (test_pallas_kernels.py)
TC_BOUNDS = {"bf16": 3e-2, "split3": 1e-4, "split2": 3e-2}
TIE_GAP = 1e-3      # top-k rows closer than this to a tie are not compared
N_BENCH, D, K, N_BITS, SNR = 131072, 64, 64, 2, 10.0
K_WIDE = 256        # components of the spectra-native serving prior
M_LAT = 16          # latent rank of the MFA priors (run_mfa's D / 4)
SERVE_SNRS = (-5.0, 5.0, 15.0)
SERVE_CLIENTS, SERVE_REQ, SERVE_MAX_BATCH, SERVE_SECONDS = 8, 64, 1024, 3.0


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def ptxas_summary(out):
    """Per entry of an `nvcc -Xptxas -v` log: its template arguments,
    registers, spill stores / loads (bytes), static shared memory and the
    codes of ptxas's wgmma notes (C7514: wgmma serialised)."""
    def template_args(name):
        return ",".join(re.findall(r"L[ib](\d+)E", name))
    notes = {}
    for line in out.splitlines():
        m = re.search(r"\((C75\d+)\).* function '(\S+?)'", line)
        if m:
            notes.setdefault(template_args(m.group(2)), set()).add(m.group(1))
    rows, args, spills = [], "?", "spills ?"
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            args = template_args(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            note = ", ".join(sorted(notes.get(args, ())))
            rows.append(f"<{args}> {m.group(1)} registers, {spills}, "
                        f"{smem.group(1) if smem else 0} B static smem"
                        + (f", wgmma notes {note}" if note else ""))
    return rows


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def circ_prior(dev, d=D, k=K, n_dead=0):
    """A seeded circulant prior: spectra uniform on [0.05, 2] (as the
    structured-bank tests draw them), small non-zero means, uniform weights
    (n_dead of them pushed below the dead floor). Returns (params with
    placeholder covariances, spectra)."""
    from quantized_channel_estimation_torch.models import gmm
    rng = np.random.default_rng(0)
    spectra = torch.as_tensor(
        rng.uniform(0.05, 2.0, (k, d)).astype(np.float32), device=dev)
    means = torch.as_tensor(
        (0.2 * (rng.standard_normal((k, d))
                + 1j * rng.standard_normal((k, d)))).astype(np.complex64),
        device=dev)
    w = torch.full((k,), 1.0 / k, device=dev)
    w[:n_dead] = 1e-9
    dummy = torch.zeros((k, 1, 1), dtype=torch.complex64, device=dev)
    return gmm.GmmParams(w / w.sum(), means, dummy, dummy), spectra


def circ_bank(dev, q, d=D, k=K, n_dead=0, blocks=None):
    """The bank of `circ_prior` at 2 bits, 10 dB, under the scalar pilot
    x0 = 1."""
    from quantized_channel_estimation_torch.models import structured_bank
    params, spectra = circ_prior(dev, d, k, n_dead)
    return structured_bank.prepare_bank_circulant(
        params, SNR, torch.tensor(1.0 + 0.0j), N_BITS, q, blocks=blocks,
        spectra=spectra)


def mp_bank(dev, p, d=D, k=K, n_bits=N_BITS, n_dead=0, blocks=None):
    """The multi-pilot bank of `circ_prior` at 10 dB under the P-pilot
    matrix A = kron(x, I) of `pilots.pilot_matrix`. Returns (bank, A,
    quantizer)."""
    from quantized_channel_estimation_torch.models import structured_bank
    from quantized_channel_estimation_torch.ops import pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    params, spectra = circ_prior(dev, d, k, n_dead)
    q = Q.design_quantizer(SNR, n_bits)
    q = None if q is None else q.to(dev)
    a = pilots.pilot_matrix(d, p, n_bits, device=dev)
    bank = structured_bank.prepare_bank_circulant(
        params, SNR, a, n_bits, q, blocks=blocks, spectra=spectra)
    return bank, a, q


def mp_obs(dev, a, q, n, n_bits=N_BITS):
    """Quantized multi-pilot observations (n, P D) of unit-power channels
    at 10 dB under the pilot matrix a (P D, D)."""
    from quantized_channel_estimation_torch.ops import observation
    from quantized_channel_estimation_torch.ops.cplx import crandn
    gen = torch.Generator(device=dev).manual_seed(1)
    h = crandn(gen, (n, a.shape[1]))
    return observation.observe(gen, h, SNR, a, n_bits, q)


def mfa_prior(dev, d=D, k=K, m=M_LAT, n_dead=0, zero_mean=True, seed=0):
    """Seeded MFA parameters: loadings of total power 0.8 a dimension, psi
    uniform on [0.05, 0.35], means zero or 0.3 CN(0, 1), weights uniform
    on [0.5, 1.5] (n_dead of them pushed below the dead floor)."""
    from quantized_channel_estimation_torch.models import mfa
    rng = np.random.default_rng(seed)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    w = rng.uniform(0.5, 1.5, k)
    w[:n_dead] = 1e-9
    params = (w / w.sum(), np.zeros((k, d)) if zero_mean else 0.3 * cr(k, d),
              np.sqrt(0.8 / m) * cr(k, d, m), rng.uniform(0.05, 0.35, (k, d)))
    return mfa.MfaParams(*(torch.as_tensor(
        x.astype(np.complex64 if np.iscomplexobj(x) else np.float32),
        device=dev) for x in params))


def mfa_bank_obs(dev, q, n, **prior):
    """The factored bank of `mfa_prior(**prior)` at 2 bits, 10 dB under
    x0 = 1, and n quantized observations of channels drawn from the
    mixture."""
    from quantized_channel_estimation_torch.models import mfa_bank
    from quantized_channel_estimation_torch.ops import observation
    from quantized_channel_estimation_torch.ops.cplx import crandn
    p = mfa_prior(dev, **prior)
    k, d, m = p.lambdas.shape
    gen = torch.Generator(device=dev).manual_seed(1)
    c = torch.randint(0, k, (n,), generator=gen, device=dev)
    h = (p.means[c] + (p.lambdas[c] @ crandn(gen, (n, m, 1)))[..., 0]
         + p.psis[c].sqrt() * crandn(gen, (n, d)))
    bank = mfa_bank.prepare_bank_factored(p, SNR, torch.tensor(1.0 + 0.0j),
                                          N_BITS, q)
    return bank, observation.observe(gen, h, SNR, None, N_BITS, q)


def serving_params():
    """The synthetic GMM of `tools/serving_bench.py` (`synthetic_params`):
    K random covariances A A^H / D + I, uniform weights, zero means, numpy
    seed 0; the precision Cholesky P = (L^-1)^H."""
    from quantized_channel_estimation_torch.models import gmm
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K, D, D)) + 1j * rng.standard_normal((K, D, D))
    covs = (a @ a.conj().transpose(0, 2, 1) / D
            + np.eye(D)[None]).astype(np.complex64)
    chol = np.linalg.cholesky(covs)
    linv = np.stack([np.linalg.solve(lk, np.eye(D)) for lk in chol])
    prec = np.ascontiguousarray(linv.conj().transpose(0, 2, 1)).astype(
        np.complex64)
    return gmm.GmmParams(np.full((K,), 1.0 / K, np.float32),
                         np.zeros((K, D), np.complex64), covs, prec)


def near_ties(r2, kb, k_sel):
    """Rows whose k-th and (k+1)-th largest logits lie within TIE_GAP: the
    kernel's and the plain version's float32 sums may order them
    differently."""
    from quantized_channel_estimation_torch.estimators import kernels
    lg = kernels.component_logits(r2, kb).sort(-1, descending=True).values
    return (lg[:, k_sel - 1] - lg[:, k_sel]) < TIE_GAP


def near_order_ties(r2, kb, k_sel):
    """Rows whose top k_sel + 1 logits hold two live ones within TIE_GAP,
    equal ones included: K5 writes its candidates in the order its float32
    sums give them, and two logits equal in the plain version's sums need
    not be in the kernel's. (Dead components sit exactly at the -1e30 floor
    in both versions and are ordered by index.)"""
    from quantized_channel_estimation_torch.estimators import kernels
    lg = kernels.component_logits(r2, kb).sort(-1, descending=True).values
    top = lg[:, :k_sel + 1]
    gaps = top[:, :-1] - top[:, 1:]
    return ((gaps < TIE_GAP) & (top[:, 1:] > -1e29)).any(-1)


def compare(name, label, got, want, skip=None, tol=TOL):
    """Max |got - want| over the compared rows, checked against `tol` of
    the output scale; returns the absolute error."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    n_skip = 0 if skip is None else int(skip.sum())
    if skip is not None:
        diff = diff[~skip]
    abs_err = float(diff.max())
    rel = abs_err / float(want.abs().max())
    log(f"{name} vs plain [{label}, N={got.shape[0]}]: max abs "
        f"{abs_err:.3e}, max rel {rel:.3e} (tol {tol})"
        + (f", {n_skip} near-tie rows not compared" if skip is not None
           else ""))
    if not (rel <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label}): {rel:.3e}")
    return abs_err


def compare64(name, label, got, want, want64, ceiling=10 * TOL,
              record=None):
    """`compare` for kernels whose logits pool many rows or expand a
    product (K3 past T = 16, the circulant kernels): within TOL of the plain
    version, or, where float32 sums in another order push the two apart,
    both held against `want64`, the plain
    version evaluated in float64: the kernel's error at most twice the
    plain version's own and at most `ceiling` of the output scale (10 TOL;
    the wide circulant kernels TOL itself). With `record` (a dict), the
    comparison's readings go in under `name label`: the kernel's distance
    from the plain version and both versions' from float64, as fractions
    of the scale, and whether the float64 rule decided. Returns the
    absolute error against the plain version."""
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    abs_err = float((got - want).abs().max())
    ok = abs_err / scale <= TOL
    msg = (f"{name} vs plain [{label}, N={got.shape[0]}]: max abs "
           f"{abs_err:.3e}, max rel {abs_err / scale:.3e} (tol {TOL})")
    if not ok or record is not None:
        e_k = float((got.double() - want64).abs().max())
        e_p = float((want.double() - want64).abs().max())
    if not ok:
        ok = e_k <= 2.0 * e_p and e_k / scale <= ceiling
        msg += (f"; past tol, against float64: kernel {e_k:.3e}, plain "
                f"{e_p:.3e} (kernel must be <= 2x plain and <= "
                f"{ceiling:g} of scale)")
    if record is not None:
        record[f"{name} {label}"] = {
            "rel_to_plain": abs_err / scale, "kernel_to_f64": e_k / scale,
            "plain_to_f64": e_p / scale, "float64_rule": abs_err / scale > TOL}
    log(msg)
    if not (ok and torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label})")
    return abs_err


def fp32_accuracy(name, label, got, want, want64):
    """The six-product route's claim, that it keeps float32's accuracy:
    got's max |error| against `want64` (the plain version in float64) at
    most twice that of `want` (the plain version in float32). TOL cannot
    tell: K14b's split3, which drops the 2^-16 terms, stays within it.
    Returns {"kernel", "plain"} (errors as fractions of the output scale)
    and whether the rule held."""
    torch.cuda.synchronize()
    scale = float(want64.abs().max())
    e = {"kernel": float((got.double() - want64).abs().max()) / scale,
         "plain": float((want.double() - want64).abs().max()) / scale}
    held = bool(e["kernel"] <= 2.0 * e["plain"])
    log(f"{name} against float64 [{label}, N={got.shape[0]}]: "
        f"{e['kernel']:.3e} of scale, the float32 plain version "
        f"{e['plain']:.3e} ({'held' if held else 'NOT held'}: at most 2x)")
    return e, held


def mfa_path_run(run_mfa, stages, kernels, dev, tmp, fitted_calls=None,
                 **change):
    """run_mfa at the defaults (plus `change`) on the card with the data
    set cached in `tmp`, its kernel launches counted alone; the (bank,
    observations) of each flat factored estimate are appended to
    `fitted_calls` where one is given. Returns the config, tables, timings,
    seconds, launches and the fit it made."""
    cfg = run_mfa.MfaBenchConfig(results_dir=tmp,
                                 cache_dir=os.path.join(tmp, "saves"),
                                 **change)
    fits, mfa_fit = [], stages.mfa_fit
    estimate_factored = stages.estimate_factored

    def keep_fit(*args):
        fits.append(mfa_fit(*args))
        return fits[-1]

    def keep_estimate(bank_s, r_s, *args, **kwargs):
        if fitted_calls is not None:
            fitted_calls.append((bank_s, r_s))
        return estimate_factored(bank_s, r_s, *args, **kwargs)

    stages.mfa_fit, stages.estimate_factored = keep_fit, keep_estimate
    try:
        kernels.reset_launch_counts()
        tm = time.time()
        mse, rate, timings = run_mfa.run(cfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.time() - tm
        launches = kernels.launch_counts()
    finally:
        stages.mfa_fit, stages.estimate_factored = mfa_fit, estimate_factored
    log(f"run_mfa {change or 'defaults'} (D={cfg.n_antennas}, "
        f"K={cfg.n_components}, M={cfg.latent_dim}, n_train={cfg.n_train}, "
        f"n_val={cfg.n_val}, {len(cfg.snrs)} SNRs): {seconds:.1f}s, MFA fit "
        f"{timings['fit']:.1f}s ({timings['mfa_iters']} iterations); "
        f"launches {launches}")
    for name, vals in list(mse.items()) + list(rate.items()):
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite row {name}: {vals}")
    return cfg, mse, rate, timings, seconds, launches, fits[0].params


def main_path_run(run_gmm, kernels, dev, tmp, falling=True, use_cache=False,
                  **change):
    """run_gmm at the defaults (plus `change`) on the card, its kernel
    launches counted alone; checks every column finite and (`falling`)
    falling with SNR."""
    cfg = run_gmm.GmmBenchConfig(results_dir=tmp,
                                 cache_dir=os.path.join(tmp, "saves"),
                                 use_cache=use_cache, **change)
    kernels.reset_launch_counts()
    tm = time.time()
    mse, rate, timings = run_gmm.run(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - tm
    launches = kernels.launch_counts()
    log(f"run_gmm {change or 'defaults'} (D={cfg.n_antennas}, "
        f"K={cfg.n_components}, n_train={cfg.n_train}, n_val={cfg.n_val}, "
        f"{len(cfg.snrs)} SNRs): {seconds:.1f}s, GMM fit "
        f"{timings['gmm_fit']:.1f}s; launches {launches}")
    for name, vals in mse.items():
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite MSE in {name}: {vals}")
        if falling and not vals[0] > vals[-1]:
            raise AssertionError(f"MSE of {name} does not fall with SNR")
    if not all(math.isfinite(v) for v in sum(rate.values(), [])):
        raise AssertionError("non-finite rate row")
    return cfg, mse, rate, timings, seconds, launches


def quant_path_run(run_gmm_quant, stages, kernels, dev, **change):
    """run_gmm_quant at the defaults (plus `change`) on the card, its
    kernel launches counted alone. The fit's host synchronizations are
    counted (`torch.cuda.set_sync_debug_mode('warn')` around the fit, dense
    or spectra-native, k-means init included), and the run keeps the fit,
    the training sample covariance, and each bank, observations and truth
    it estimated and scored. Returns (cfg, mse, rate, timings, seconds,
    launches, kept)."""
    kept = {"banks": [], "truth": []}
    names = ("gmm_quant_fit", "gmm_quant_fit_circulant_spectra",
             "sample_cov", "estimate_auto", "estimate_circulant", "nmse")
    saved = {name: getattr(stages, name) for name in names}

    def counted_fit(name):
        def fit(*args, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    kept["fit"] = saved[name](*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            kept["fit_syncs"] = sum("synchroniz" in str(w.message)
                                    for w in caught)
            return kept["fit"]
        return fit

    def sample_cov(h):
        kept["cov"] = saved["sample_cov"](h)
        return kept["cov"]

    def estimate(name):
        def kept_estimate(bank_s, r_s, *args, **kw):
            kept["banks"].append((bank_s, r_s))
            return saved[name](bank_s, r_s, *args, **kw)
        return kept_estimate

    def nmse(h_est, h):
        kept["truth"][:] = [h]
        return saved["nmse"](h_est, h)

    for name, fn in (("gmm_quant_fit", counted_fit("gmm_quant_fit")),
                     ("gmm_quant_fit_circulant_spectra",
                      counted_fit("gmm_quant_fit_circulant_spectra")),
                     ("sample_cov", sample_cov),
                     ("estimate_auto", estimate("estimate_auto")),
                     ("estimate_circulant", estimate("estimate_circulant")),
                     ("nmse", nmse)):
        setattr(stages, name, fn)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = run_gmm_quant.QuantGmmBenchConfig(
                results_dir=tmp, cache_dir=os.path.join(tmp, "saves"),
                use_cache=False, **change)
            kernels.reset_launch_counts()
            tm = time.time()
            mse, rate, timings = run_gmm_quant.run(cfg, verbose=False,
                                                   device=dev)
            torch.cuda.synchronize()
            seconds = time.time() - tm
            launches = kernels.launch_counts()
            csvs = os.listdir(os.path.join(tmp, "3gpp"))
    finally:
        for name, fn in saved.items():
            setattr(stages, name, fn)
    if len(csvs) != 1:
        raise AssertionError(f"run_gmm_quant {change}: CSV missing: {csvs}")
    for name, vals in list(mse.items()) + list(rate.items()):
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"run_gmm_quant {change}: non-finite row "
                                 f"{name}: {vals}")
    return cfg, mse, rate, timings, seconds, launches, kept


def serve_mode(svc, kernels, dev, label, t_coh, kernel_name, reference,
               near_tie=None, seconds=SERVE_SECONDS, same_as=None,
               same_as_near_tie=None, d=D, same_as_exact=None):
    """Closed-loop load on one service mode: warm-up, then SERVE_CLIENTS
    clients for `seconds`, the launch counts read around the window.
    `reference(r)` is the mode's plain estimator on the card, `near_tie(r)`
    the rows not compared. With `same_as` (another service) every answer
    of the window is held within TOL of the scale of that service's answer
    to the same request (`same_as_near_tie(r, snr)`: a numpy mask of the
    rows not compared); `d`, the width of an estimate. With
    `same_as_exact(r, snr)` (the same request evaluated in float64) an
    answer further than TOL from that service's passes only under the
    float64 rule of `compare64` at the wide circulant kernels' ceiling:
    its error against the float64 answer at most twice that service's own
    and at most TOL of the scale (the largest such error is recorded).
    Returns the mode's record; raises on a failed
    request, a kernel that was not launched (`kernel_name` None: no kernel
    to count) or an answer off the reference."""
    rng = np.random.default_rng(1)
    width = svc.a.shape[0]                   # P D observations a snapshot

    def request(size):
        x = (rng.standard_normal((size, width))
             + 1j * rng.standard_normal((size, width))).astype(np.complex64)
        return x.reshape(size // t_coh, t_coh, width) if t_coh > 1 else x

    # one request held against the plain estimator on the card
    r = request(SERVE_REQ)
    got = torch.as_tensor(svc.submit(r, SNR, timeout=120.0), device=dev)
    rt = torch.as_tensor(r, device=dev)
    skip = None if near_tie is None else near_tie(rt)
    err = compare("service", label, got.reshape(-1, d),
                  reference(rt).reshape(-1, d), skip)

    # warm-up: every padded microbatch size the load can form, per SNR
    cap = 1 << max(4, SERVE_MAX_BATCH.bit_length() - 1)
    size = 1 << max(4, (SERVE_REQ - 1).bit_length())
    while size <= min(cap, SERVE_CLIENTS * SERVE_REQ):
        for snr in SERVE_SNRS:
            svc.submit(request(size - size % t_coh), snr, timeout=120.0)
        size *= 2

    reqs = [request(SERVE_REQ) for _ in range(SERVE_CLIENTS)]
    expected = None if same_as is None else {
        (i, snr): same_as.submit(reqs[i], snr, timeout=120.0)
        for i in range(SERVE_CLIENTS) for snr in SERVE_SNRS}
    compared = None if same_as_near_tie is None else {
        (i, snr): ~same_as_near_tie(reqs[i], snr)
        for i in range(SERVE_CLIENTS) for snr in SERVE_SNRS}
    exact = None if same_as_exact is None else {
        (i, snr): same_as_exact(reqs[i], snr)
        for i in range(SERVE_CLIENTS) for snr in SERVE_SNRS}
    latencies, stop, lock = [], threading.Event(), threading.Lock()
    served, off, past = [0], [0.0], [0, 0]   # past TOL: answers, not held
    past_f64 = [0.0, 0.0]   # past TOL: largest e_k, largest e_k / e_p

    def client(i):
        j = 0
        while not stop.is_set():
            snr = SERVE_SNRS[(i + j) % len(SERVE_SNRS)]
            t0 = time.perf_counter()
            out = svc.submit(reqs[i], snr, timeout=120.0)
            dt = time.perf_counter() - t0
            dev_rel, held = 0.0, True
            if expected is not None:
                want = expected[(i, snr)]
                rows = (slice(None) if compared is None
                        else compared[(i, snr)])
                dev_rel = float(np.abs(out - want)[rows].max()
                                / np.abs(want).max())
                if exact is not None and not dev_rel <= TOL:
                    x = exact[(i, snr)]
                    scale = np.abs(x).max()
                    e_k = np.abs(out - x)[rows].max() / scale
                    e_p = np.abs(want - x)[rows].max() / scale
                    held = bool(e_k <= 2 * e_p and e_k <= TOL)
            with lock:
                latencies.append(dt)
                served[0] += SERVE_REQ
                off[0] = max(off[0], dev_rel)
                if not dev_rel <= TOL:
                    past[0] += 1
                    past[1] += not held
                    if exact is not None:
                        past_f64[0] = max(past_f64[0], float(e_k))
                        past_f64[1] = max(past_f64[1],
                                          float(e_k / max(e_p, 1e-30)))
            j += 1

    m0 = svc.metrics()
    kernels.reset_launch_counts()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(SERVE_CLIENTS)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(seconds)
    stop.set()
    for th in threads:
        th.join(timeout=120.0)
        if th.is_alive():
            raise AssertionError(f"serving client hung ({label})")
    elapsed = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    m = svc.metrics()
    lat = np.sort(np.asarray(latencies)) * 1e3
    rec = {"mode": label, "requests": len(lat),
           "estimates_per_s": served[0] / elapsed,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "microbatches": m["microbatches"] - m0["microbatches"],
           "launches": launches, "max_abs_err": err, "metrics": m}
    if expected is not None:
        rec["max_rel_to_same_as"] = off[0]
    if exact is not None:
        rec["answers_past_tol"], rec["past_tol_not_held"] = past
        (rec["past_tol_max_kernel_to_f64"],
         rec["past_tol_max_ratio_to_plain"]) = past_f64
    log(f"serving [{label}]: {rec['estimates_per_s']:.0f} estimates/s, "
        f"p50 {rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms over "
        f"{len(lat)} requests in {rec['microbatches']} microbatches; "
        f"launches {launches}; metrics {m}")
    if m["requests_failed"] != 0:
        raise AssertionError(f"failed requests in {label}: {m}")
    if kernel_name is not None and launches[kernel_name] < 1:
        raise AssertionError(f"{label} did not launch {kernel_name}")
    if expected is not None and not off[0] <= TOL and (
            exact is None or past[1]):
        raise AssertionError(f"{label}: an answer {off[0]:.3e} of scale off "
                             "the one-device service's"
                             + ("" if exact is None else
                                f" ({past[1]} of {past[0]} answers past "
                                "tol not held against float64)"))
    return rec


# phase 3g: the VAE under the JAX package's D = 64 protocol (20k / 2k
# channels, 60 epochs at the `VaeBenchConfig` widths), held to 1.10x the
# NMSE the JAX package recorded under it at 5 and 15 dB (PARITY_NOTES.md)
VAE_PROTOCOL = dict(n_train=20_000, n_val=2_000, epochs=60)
VAE_JAX_NMSE = {"genie": (0.19668, 0.10051), "noisy": (0.25639, 0.12664),
                "real": (0.24875, 0.12121)}
VAE_BAND = 1.10


def vae_phase(dev, card, kernels):
    """Phase 3g, the VAE (no kernel of its own; the launch counts are read
    around every run and stay 0): `run_vae.run` at the `VaeBenchConfig`
    widths under VAE_PROTOCOL in genie, noisy and real mode (train
    seconds, steps/s, host synchronizations per epoch from
    `set_sync_debug_mode('warn')` around `vae.train`, peak memory, the MSE
    and rate rows; NMSE at 5 and 15 dB within VAE_BAND of the JAX
    package's, the MSE falling from -10 to 10 dB), noisy with
    n_coherence=4 (the `_coh` columns finite); on the trained noisy and
    real parameters the structured estimate against the dense one at every
    SNR at 1 and 2 bits (TOL of scale); one epoch at the default 100k
    channels (noisy), timed and projected to 500 epochs; a run of 2 epochs
    resumed to 3 against an uninterrupted 3 (losses to rtol 1e-6,
    parameters within 1e-6 of scale); 2 epochs as CUDA-graph replays of
    the step against the eager steps (bit for bit; ms a step of each); the
    NaN guard on a poisoned batch;
    `vae.train(mesh=)` over a one-rank NCCL group against the one-device
    run; and `VaeEstimationService` on the noisy parameters under the
    serving protocol, flat and T = 4, every answer within TOL of scale of
    direct `vae.estimate`. Returns the phase's record."""
    import torch.distributed as dist
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.harness import run_vae, stages
    from quantized_channel_estimation_torch.models import vae
    from quantized_channel_estimation_torch.ops import pilots, scm
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    t_phase = time.time()
    rec = {"protocol": dict(VAE_PROTOCOL), "runs": {}}
    kept = {}
    train = vae.train

    def timed_train(label):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t = time.time()
                try:
                    out = train(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            kept[label] = {"train_s": time.time() - t, "out": out,
                           "h_train": args[2], "quantizers": args[5],
                           "syncs": sum("synchroniz" in str(w.message)
                                        for w in caught),
                           "peak_gib": torch.cuda.max_memory_allocated(dev)
                           / 2 ** 30}
            return out
        return wrapped

    def run(label, **change):
        vae.train = timed_train(label)
        kernels.reset_launch_counts()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                cfg = run_vae.VaeBenchConfig(
                    **VAE_PROTOCOL, use_cache=False, plot=False,
                    results_dir=tmp, cache_dir=os.path.join(tmp, "saves"),
                    **change)
                t = time.time()
                mse, rate, times = run_vae.run(cfg, verbose=False, device=dev)
                sec = time.time() - t
                csvs = sorted(os.listdir(os.path.join(tmp, "vae")))
        finally:
            vae.train = train
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        k = kept[label]
        steps = cfg.epochs * (k["h_train"].shape[0] // cfg.batch_size)
        r = {"mse": mse, "rate": rate, "seconds": sec, "timings": times,
             "train_s": k["train_s"], "steps": steps,
             "steps_per_s": steps / k["train_s"],
             "host_syncs": k["syncs"],
             "host_syncs_per_epoch": k["syncs"] / cfg.epochs,
             "peak_gib": k["peak_gib"], "final_loss": k["out"][2][-1],
             "launches": launches}
        rec["runs"][label] = r
        col = f"vae_{cfg.vae_mode}"
        log(f"run_vae {label} (D={cfg.n_antennas}, latent "
            f"{cfg.latent_dim}, {cfg.n_layers} layers, batch "
            f"{cfg.batch_size}, {cfg.n_train} / {cfg.n_val} channels, "
            f"{cfg.epochs} epochs): {sec:.1f}s, train {k['train_s']:.1f}s "
            f"({steps} steps, {r['steps_per_s']:.0f} steps/s, "
            f"{k['syncs']} host synchronizations = "
            f"{r['host_syncs_per_epoch']:.3f} an epoch), peak memory "
            f"{k['peak_gib']:.2f} GiB, final loss {r['final_loss']:.2f}; "
            f"NMSE {dict(zip(cfg.snrs, mse[col]))}"
            + (f"; coherent {dict(zip(cfg.snrs, mse[col + '_coh']))}"
               if col + "_coh" in mse else "") + f"; launches {launches}; "
            f"{card}")
        if len(csvs) != 3:
            raise AssertionError(f"run_vae {label}: CSVs {csvs}")
        for name, vals in (*mse.items(), *rate.items()):
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"run_vae {label}: {name} {vals}")
        if launches:
            raise AssertionError(f"run_vae {label} launched {launches}")
        return cfg, r

    snrs = list(run_vae.VaeBenchConfig().snrs)
    i5, i15 = snrs.index(5), snrs.index(15)
    for mode in ("genie", "noisy", "real"):
        cfg, r = run(mode, vae_mode=mode)
        got = r["mse"][f"vae_{mode}"]
        want = VAE_JAX_NMSE[mode]
        r["rel_to_jax_recorded"] = [got[i5] / want[0], got[i15] / want[1]]
        log(f"run_vae {mode}: NMSE at 5 / 15 dB {got[i5]:.5f} / "
            f"{got[i15]:.5f}, the JAX package's recorded {want[0]} / "
            f"{want[1]} ({r['rel_to_jax_recorded'][0]:.3f}x / "
            f"{r['rel_to_jax_recorded'][1]:.3f}x; band {VAE_BAND}x)")
        if not (got[i5] <= VAE_BAND * want[0]
                and got[i15] <= VAE_BAND * want[1]):
            raise AssertionError(f"run_vae {mode}: NMSE past {VAE_BAND}x "
                                 "the JAX package's")
        low = got[:snrs.index(10) + 1]
        if not all(x > y for x, y in zip(low, low[1:])):
            raise AssertionError(f"run_vae {mode}: MSE not falling from "
                                 f"-10 to 10 dB: {low}")
    cfg_c, _ = run("noisy, T=4", vae_mode="noisy", n_coherence=4)

    # the structured estimate against the dense one on the trained noisy
    # and real parameters, fresh validation channels, 1 and 2 bits
    d = cfg_c.n_antennas
    h_val, _ = stages.generate_channels(
        torch.Generator(dev).manual_seed(60), VAE_PROTOCOL["n_val"],
        scm.ScmConfig(d, cfg_c.n_path, cfg_c.path_sigma))
    a = pilots.pilot_matrix(d, 1, N_BITS, device=dev)
    gen = torch.Generator(dev).manual_seed(61)
    rec["structured_vs_dense"] = {}
    for mode in ("noisy", "real"):
        model, state, _ = kept[mode]["out"]
        for bits in (1, 2):
            vcfg = model.cfg._replace(n_bits=bits)
            rels = []
            for snr in snrs:
                q = Q.design_quantizer(snr, bits).to(dev)
                r_o = stages.observe(gen, h_val, snr, a, bits, q)
                dense, circ = (vae.estimate(model, state.params, vcfg, r_o,
                                            snr, a, q, structured=s)
                               for s in (False, True))
                rels.append(float((circ - dense).abs().max()
                                  / dense.abs().max()))
            rec["structured_vs_dense"][f"{mode}, {bits} bit"] = rels
            log(f"vae {mode}, {bits} bit: structured vs dense max rel "
                f"{max(rels):.2e} over {snrs} dB")
            if not max(rels) <= TOL:
                raise AssertionError(f"vae {mode} {bits} bit: structured "
                                     f"off dense: {rels}")

    # one epoch at the default 100k channels (noisy, 500 steps)
    model_n, state_n, _ = kept["noisy"]["out"]
    vcfg_n = model_n.cfg
    qs = kept["noisy"]["quantizers"]
    full = run_vae.VaeBenchConfig()
    h_full, _ = stages.generate_channels(
        torch.Generator(dev).manual_seed(62), full.n_train,
        scm.ScmConfig(d, full.n_path, full.path_sigma),
        stages.auto_gen_chunk(d))
    torch.cuda.synchronize()
    t = time.time()
    _, _, l_full = train(63, vcfg_n._replace(epochs=1), h_full, a, snrs, qs,
                         verbose=False)
    torch.cuda.synchronize()
    epoch_s = time.time() - t
    # the first call of a new training set captures its step graph
    rec["epoch_100k"] = {"seconds": epoch_s,
                         "steps": full.n_train // full.batch_size,
                         "projected_500_epochs_s": 500 * epoch_s,
                         "loss": l_full[0]}
    log(f"vae noisy, one epoch at {full.n_train} channels "
        f"({full.n_train // full.batch_size} steps): {epoch_s:.2f}s; "
        f"projected {full.epochs} epochs {full.epochs * epoch_s:.0f}s; "
        f"{card}")
    del h_full

    # resume: 2 epochs, then resumed to 3, against an uninterrupted 3
    h_tr = kept["noisy"]["h_train"]
    cfg3 = vcfg_n._replace(epochs=3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        _, _, l_2 = train(64, cfg3._replace(epochs=2), h_tr, a, snrs, qs,
                          verbose=False, checkpoint_path=path)
        _, s_res, l_res = train(64, cfg3, h_tr, a, snrs, qs, verbose=False,
                                checkpoint_path=path)
    _, s_one, l_one = train(64, cfg3, h_tr, a, snrs, qs, verbose=False)
    p_rel = float((s_res.params - s_one.params).abs().max()
                  / s_one.params.abs().max())
    rec["resume"] = {"losses_resumed": l_res, "losses_uninterrupted": l_one,
                     "params_max_rel": p_rel,
                     "bit_identical": all(torch.equal(x, y) for x, y in
                                          zip(s_res, s_one))}
    log(f"vae resume: 2 epochs + 1 resumed vs 3: losses {l_res} vs {l_one},"
        f" parameters max rel {p_rel:.2e}, bit identical "
        f"{rec['resume']['bit_identical']}")
    if not (l_res[:2] == l_2 and np.allclose(l_res, l_one, rtol=1e-6,
                                              atol=0) and p_rel <= 1e-6):
        raise AssertionError("vae resume differs from the uninterrupted run")

    # the epochs as CUDA-graph replays of the step against the eager
    # steps: bit for bit, and each timed (the graph's first call captures)
    step = vae.make_train_step(model_n, vcfg_n, a, snrs, qs)
    n_steps = h_tr.shape[0] // vcfg_n.batch_size
    runs = {}
    for label, graphed in (("eager", False), ("graph, capture", True),
                           ("graph", True)):
        torch.cuda.synchronize()
        t = time.time()
        st_g, ml_g = step.run_epochs(state_n, h_tr,
                                     np.random.SeedSequence(67), 0, n_steps,
                                     2, cuda_graph=graphed)
        torch.cuda.synchronize()
        runs[label] = (st_g, ml_g, time.time() - t)
    same = all(torch.equal(x, y) for x, y in zip(runs["eager"][0],
                                                 runs["graph"][0])) \
        and torch.equal(runs["eager"][1], runs["graph"][1]) \
        and all(torch.equal(x, y) for x, y in zip(
            runs["graph, capture"][0], runs["graph"][0]))
    rec["cuda_graph"] = {
        "bit_identical": same,
        **{f"{k} ms/step": 1e3 * v[2] / (2 * n_steps)
           for k, v in runs.items()}}
    log(f"vae epochs as CUDA-graph replays vs eager steps (2 epochs of "
        f"{n_steps}): bit identical {same}; ms a step "
        + ", ".join(f"{k} {1e3 * v[2] / (2 * n_steps):.3f}"
                    for k, v in runs.items()) + f"; {card}")
    if not same:
        raise AssertionError("vae CUDA-graph epochs differ from eager")
    del runs

    # the NaN guard: a poisoned batch keeps parameters, moments and count
    g = torch.Generator(dev).manual_seed(65)
    guarded, loss = step(state_n, torch.full_like(h_tr[:1000],
                                                  complex("nan")), g)
    kept_all = all(torch.equal(x, y) for x, y in zip(guarded[:4],
                                                     state_n[:4]))
    rec["nan_guard"] = {"loss": repr(float(loss)), "state_kept": kept_all,
                        "step_counted": int(guarded.step)
                        == int(state_n.step) + 1}
    log(f"vae NaN guard: loss {float(loss)}, state kept {kept_all}")
    if not (kept_all and rec["nan_guard"]["step_counted"]):
        raise AssertionError("vae NaN guard changed the state")

    # data parallelism at world size 1 (a one-rank NCCL group) against the
    # one-device run
    cfg2 = vcfg_n._replace(epochs=2)
    _, s_1, l_1 = train(66, cfg2, h_tr, a, snrs, qs, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh(1, 1)
            _, s_dp, l_dp = train(66, cfg2, h_tr, a, snrs, qs,
                                  verbose=False, mesh=mesh)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    dp_rel = float((s_dp.params - s_1.params).abs().max()
                   / s_1.params.abs().max())
    rec["dp_world_size_1"] = {"losses": l_dp, "losses_one_device": l_1,
                              "params_max_rel": dp_rel}
    log(f"vae DP over a one-rank NCCL group vs one device: losses {l_dp} vs "
        f"{l_1}, parameters max rel {dp_rel:.2e}")
    if not (np.allclose(l_dp, l_1, rtol=1e-6, atol=0) and dp_rel <= 1e-6):
        raise AssertionError("vae DP at world size 1 off the one-device run")

    # the service on the trained noisy parameters
    class Direct:
        """`vae.estimate` behind the service's submit()."""

        def submit(self, r_np, snr, timeout=None):
            rt = torch.as_tensor(r_np, device=dev)
            t_coh = rt.shape[1] if rt.dim() == 3 else 1
            q = Q.design_quantizer(snr, N_BITS).to(dev)
            out = vae.estimate(model_n, state_n.params, vcfg_n,
                               rt.reshape(-1, d), snr, a, q,
                               coherence=t_coh, structured=True)
            return out.reshape(rt.shape).cpu().numpy()

    direct = Direct()
    rec["serving"] = []
    svc = serving.VaeEstimationService(model_n, state_n.params, vcfg_n, a,
                                       max_batch=SERVE_MAX_BATCH, device=dev)
    try:
        if not svc.structured:
            raise AssertionError("the VAE service did not detect A = x0 I")
        for label, t_coh in (("vae noisy flat", 1),
                             ("vae noisy T=4 blocks", 4)):
            rec["serving"].append(serve_mode(
                svc, kernels, dev, label, t_coh, None,
                lambda rt, t=t_coh: torch.as_tensor(
                    direct.submit(rt.cpu().numpy(), SNR), device=dev),
                same_as=direct))
    finally:
        svc.close(timeout=120.0)
    rec["seconds"] = time.time() - t_phase
    log(f"VAE phase 3g: {rec['seconds']:.1f}s")
    return rec


# phase 3h: the other channel models (ROADMAP item 14) at the `run_gmm`
# defaults (D = 64, K = 64, 2 bits, 100k / 10k channels, 7 SNRs), each
# held to 1.10x the NMSE the JAX package recorded at full scale
# (BASELINE.md)
MODELS_BAND = 1.10
MIMO = dict(channel_model="mimo", n_antennas=16, n_antennas_ms=4, n_path=2)
MACRO = dict(channel_model="urban-macro", n_path=6)
# BASELINE.md:101: run_gmm, MIMO 16 x 4, T = 4, alpha 0.25
MIMO_GMM_JAX = {"blmmse_gmm": {-10: 0.813, -5: 0.506},
                "blmmse_gmm_coh": {-10: 0.779, -5: 0.460}}
# BASELINE.md:100: run_gmm, urban-macro, 6 paths, T = 4, alpha 1
MACRO_GMM_JAX = {"blmmse_gmm": {-10: 1.546}, "blmmse_gmm_coh": {-10: 1.421}}
# BASELINE.md:149: run_mfa, MIMO 16 x 4, T = 4, alpha 'auto', per snapshot
MIMO_MFA_JAX = (0.832, 0.522, 0.272, 0.154, 0.105, 0.089, 0.084)
GEN_ROWS = 110_000


def channel_models_phase(dev, card, kernels, errs, add):
    """Phase 3h, the other channel models: (a) `run_gmm` on Kronecker-MIMO
    channels (16 x 4 antennas, 2 paths, T = 4 at alpha 0.25): K1 and K3
    launched once an SNR and held against their plain versions on the
    run's fitted banks and observations, blmmse_genie (the kron genie) <
    blmmse_gmm < blmmse_glob at 20 dB, the per-snapshot and coherent NMSE
    at -10 and -5 dB within MODELS_BAND of BASELINE.md:101 and the
    coherent column below the per-snapshot one at -5 dB; (b) `run_gmm` on
    urban-macro channels (6 paths, T = 4, alpha 1), K1 and K3 launched,
    the NMSE at -10 dB within MODELS_BAND of BASELINE.md:100; (c)
    `run_mfa` on (a)'s data set (T = 4, alpha 'auto'), K11 and K12
    launched and held against their plain versions, the per-snapshot NMSE
    within MODELS_BAND of BASELINE.md:149 at every SNR; (d)
    `run_gmm_quant` on urban-macro channels, K1 launched, the NMSE at 5 dB
    below LS; (e) `run_vae` in noisy mode on MIMO channels under
    VAE_PROTOCOL, no kernel launched, the NMSE finite and falling from -10
    to 10 dB; (f) the generators alone, GEN_ROWS rows of each model:
    datagen seconds (CUDA events), host synchronizations and peak memory,
    MIMO power per entry within 2% of 1 and the sample covariance within
    5% (relative Frobenius) of the mean kron genie covariance, urban-macro
    genie powers inside the path-loss range [1, 1.5^3.5]. Every run prints
    its seconds, datagen seconds, fit iterations, host synchronizations
    and peak memory. Returns the phase's record."""
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels, fact_kernels)
    from quantized_channel_estimation_torch.harness import (
        run_gmm, run_gmm_quant, run_mfa, run_vae, stages)
    from quantized_channel_estimation_torch.models import gmm_estimator
    from quantized_channel_estimation_torch.ops import linalg, scm, scm_mimo
    t_phase = time.time()
    rec = {}
    wrapped = ("generate_channels", "generate_channels_macro",
               "generate_channels_mimo", "gmm_fit", "mfa_fit",
               "estimate_auto", "estimate_coherent_auto",
               "estimate_factored", "estimate_factored_coherent")

    def instrumented(label, run_fn, cfg):
        """`run_fn(cfg)` on the card with the launch counts set to 0 just
        before it and read just after, the host synchronizations counted
        (`set_sync_debug_mode('warn')`), datagen timed with CUDA events
        around the stages' generators, the fit's iterations read, and each
        (bank, observations, alpha) the stages estimated kept."""
        saved = {name: getattr(stages, name) for name in wrapped}
        kept = {"gen_events": [], "fits": [], "flat": [], "coh": [],
                "gen_syncs": 0}
        caught = []

        def generator(name):
            def gen_fn(*args, **kw):
                n0 = len(caught)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = saved[name](*args, **kw)
                ev[1].record()
                kept["gen_events"].append(ev)
                kept["gen_syncs"] += len(caught) - n0
                return out
            return gen_fn

        def fit(name):
            def fit_fn(*args, **kw):
                kept["fits"].append(saved[name](*args, **kw))
                return kept["fits"][-1]
            return fit_fn

        def keep(name, key):
            def est_fn(bank_s, r_s, mode="all", *args, **kw):
                alpha = (args[0] if args else kw.get("alpha", 1.0))
                kept[key].append((bank_s, r_s, float(alpha)))
                return saved[name](bank_s, r_s, mode, *args, **kw)
            return est_fn

        for name in wrapped[:3]:
            setattr(stages, name, generator(name))
        for name in ("gmm_fit", "mfa_fit"):
            setattr(stages, name, fit(name))
        stages.estimate_auto = keep("estimate_auto", "flat")
        stages.estimate_factored = keep("estimate_factored", "flat")
        stages.estimate_coherent_auto = keep("estimate_coherent_auto", "coh")
        stages.estimate_factored_coherent = keep("estimate_factored_coherent",
                                                 "coh")
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launch_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t = time.time()
                try:
                    mse, rate, timings = run_fn(cfg, verbose=False,
                                                device=dev)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                seconds = time.time() - t
            launches = kernels.launch_counts()
        finally:
            for name, fn in saved.items():
                setattr(stages, name, fn)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        r = {"mse": mse, "rate": rate, "seconds": seconds,
             "timings": {k: v for k, v in timings.items()
                         if isinstance(v, (int, float))},
             "datagen_s": sum(a.elapsed_time(b) for a, b in
                              kept["gen_events"]) / 1e3,
             "datagen_host_syncs": kept["gen_syncs"],
             "fit_iterations": [int(f.n_iter) for f in kept["fits"]],
             "host_syncs": syncs,
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
             "launches": {k: v for k, v in launches.items() if v}}
        if "coherence_alpha_by_snr" in timings:
            r["alpha_by_snr"] = {str(k): v for k, v in
                                 timings["coherence_alpha_by_snr"].items()}
        for name, vals in (*mse.items(), *rate.items()):
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"{label}: non-finite row {name}")
        add(launches)
        rec[label] = r
        log(f"{label}: {seconds:.1f}s, datagen {r['datagen_s']:.2f}s "
            f"({r['datagen_host_syncs']} host synchronizations), fit "
            f"iterations {r['fit_iterations']}, {syncs} host "
            f"synchronizations, peak memory {r['peak_gib']:.2f} GiB; "
            f"launches {r['launches']}; {card}")
        for name, vals in mse.items():
            log(f"  {name:16s} " + " ".join(f"{v:.5f}" for v in vals))
        return r, kept

    def within(label, got, want):
        ratio = got / want
        log(f"{label}: {got:.5f} against the JAX package's recorded "
            f"{want} ({ratio:.3f}x; band {MODELS_BAND}x)")
        if not ratio <= MODELS_BAND:
            raise AssertionError(f"{label} past {MODELS_BAND}x the JAX "
                                 "package's")
        return ratio

    def check_k1_k3(label, kept, snrs, t_coh):
        """K1 and K3 against their plain versions on each fitted bank and
        observations a run estimated."""
        for snr, (bank_s, r_s, _) in zip(snrs, kept["flat"]):
            r2 = kernels._r2(r_s)
            kb = kernels.kernel_bank_block(bank_s)
            errs["grouped_estimate"].append(compare(
                "grouped_estimate", f"{label} fitted bank, {snr} dB",
                kernels.grouped_estimate(r2, kb),
                kernels.grouped_estimate_reference(r2, kb)))
        for snr, (bank_s, rb, alpha) in zip(snrs, kept["coh"]):
            r2 = kernels._r2(rb.reshape(-1, rb.shape[-1]))
            kb = kernels.kernel_bank_block(bank_s, t_coh, alpha)
            errs["grouped_estimate_coherent"].append(compare64(
                "grouped_estimate_coherent",
                f"{label} fitted bank, {snr} dB, T={t_coh}, alpha {alpha}",
                kernels.grouped_estimate_coherent(r2, kb, t_coh, alpha),
                kernels.grouped_estimate_coherent_reference(r2, kb, t_coh,
                                                            alpha),
                kernels.grouped_estimate_coherent_reference(
                    r2.double(), type(kb)(*(x.double() for x in kb)),
                    t_coh, alpha)))

    with tempfile.TemporaryDirectory() as tmp:
        common = dict(results_dir=tmp, cache_dir=os.path.join(tmp, "saves"))
        # (a) MIMO GMM; its data set stays cached for (c)
        cfg_a = run_gmm.GmmBenchConfig(**MIMO, n_coherence=4,
                                       coherence_alpha=0.25, **common)
        r_a, kept = instrumented("(a) run_gmm mimo 16x4, T=4, alpha 0.25",
                                 run_gmm.run, cfg_a)
        snrs = list(cfg_a.snrs)
        for name in ("grouped_estimate", "grouped_estimate_coherent"):
            if r_a["launches"].get(name) != len(snrs):
                raise AssertionError(f"(a) launched {name} "
                                     f"{r_a['launches'].get(name)} times")
        check_k1_k3("(a) mimo", kept, snrs, 4)
        del kept
        mse = r_a["mse"]
        at20 = {k: v[snrs.index(20)] for k, v in mse.items()}
        if not (at20["blmmse_genie"] < at20["blmmse_gmm"]
                < at20["blmmse_glob"]):
            raise AssertionError(f"(a) order at 20 dB broken: {at20}")
        r_a["rel_to_jax_recorded"] = {
            f"{col} {snr}": within(f"(a) {col} at {snr} dB",
                                   mse[col][snrs.index(snr)], want)
            for col, by_snr in MIMO_GMM_JAX.items()
            for snr, want in by_snr.items()}
        i5 = snrs.index(-5)
        if not mse["blmmse_gmm_coh"][i5] < mse["blmmse_gmm"][i5]:
            raise AssertionError("(a) coherent column not below the "
                                 "per-snapshot one at -5 dB")

        # (c) MIMO MFA on (a)'s data set (read from the cache)
        cfg_c = run_mfa.MfaBenchConfig(**MIMO, n_coherence=4,
                                       coherence_alpha="auto", **common)
        r_c, kept = instrumented("(c) run_mfa mimo 16x4, T=4, alpha auto",
                                 run_mfa.run, cfg_c)
        if r_c["datagen_s"] != 0.0:
            raise AssertionError("(c) generated its data set again")
        if (r_c["launches"].get("fact_estimate") != len(snrs)
                or r_c["launches"].get("fact_estimate_coherent", 0)
                < len(snrs)):
            raise AssertionError(f"(c) launches {r_c['launches']}")
        n_blocks = cfg_c.n_val // 4
        evals = [k for k in kept["coh"] if k[1].shape[0] == n_blocks]
        for snr, (bank_s, r_s, _), (bank_b, rb, alpha) in zip(
                snrs, kept["flat"], evals):
            fkb = fact_kernels.fact_kernel_bank(bank_s)
            x2 = circ_kernels._x2(r_s)
            errs["fact_estimate"].append(compare(
                "fact_estimate", f"(c) mimo fitted bank, {snr} dB",
                fact_kernels.fact_estimate(x2, fkb),
                fact_kernels.fact_estimate_reference(x2, fkb)))
            fkb4 = fact_kernels.fact_kernel_bank(bank_b, 4, alpha)
            xb2 = circ_kernels._x2(rb.reshape(-1, rb.shape[-1]))
            errs["fact_estimate_coherent"].append(compare64(
                "fact_estimate_coherent",
                f"(c) mimo fitted bank, {snr} dB, T=4, alpha {alpha}",
                fact_kernels.fact_estimate_coherent(xb2, fkb4, 4, alpha),
                fact_kernels.fact_estimate_coherent_reference(xb2, fkb4, 4,
                                                              alpha),
                fact_kernels.fact_estimate_coherent_reference(
                    xb2.double(), type(fkb4)(*(x.double() for x in fkb4)),
                    4, alpha)))
        del kept, evals
        r_c["rel_to_jax_recorded"] = [
            within(f"(c) blmmse_mfa at {snr} dB", got, want)
            for snr, got, want in zip(snrs, r_c["mse"]["blmmse_mfa"],
                                      MIMO_MFA_JAX)]

    # (b) urban-macro GMM
    with tempfile.TemporaryDirectory() as tmp:
        cfg_b = run_gmm.GmmBenchConfig(**MACRO, n_coherence=4,
                                       coherence_alpha=1.0, use_cache=False,
                                       results_dir=tmp,
                                       cache_dir=os.path.join(tmp, "saves"))
        r_b, kept = instrumented("(b) run_gmm urban-macro, T=4, alpha 1",
                                 run_gmm.run, cfg_b)
        del kept
    for name in ("grouped_estimate", "grouped_estimate_coherent"):
        if r_b["launches"].get(name) != len(snrs):
            raise AssertionError(f"(b) launched {name} "
                                 f"{r_b['launches'].get(name)} times")
    r_b["rel_to_jax_recorded"] = {
        f"{col} {snr}": within(f"(b) {col} at {snr} dB",
                               r_b["mse"][col][snrs.index(snr)], want)
        for col, by_snr in MACRO_GMM_JAX.items()
        for snr, want in by_snr.items()}

    # (d) urban-macro CSI-free
    torch.cuda.reset_peak_memory_stats(dev)
    cfg_d, mse_d, rate_d, times_d, sec_d, launches_d, kept = quant_path_run(
        run_gmm_quant, stages, kernels, dev, **MACRO)
    peak_d = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    add(launches_d)
    if launches_d["grouped_estimate"] != 1:
        raise AssertionError(f"(d) launched K1 "
                             f"{launches_d['grouped_estimate']} times")
    (bank_d, r_d, *_), h_d = kept["banks"][0], kept["truth"][0]
    a_d = stages.pilot_matrix(cfg_d.n_antennas, 1, cfg_d.n_bits, device=dev)
    from quantized_channel_estimation_torch.ops import quantizer as Q
    ls_d = stages.nmse(stages.ls_global(
        r_d, kept["cov"], 5.0, a_d, cfg_d.n_bits,
        Q.design_quantizer(5.0, cfg_d.n_bits).to(dev)), h_d)
    nmse_d = mse_d["blmmse_gmm_quant"][0]
    rec["(d) run_gmm_quant urban-macro"] = {
        "mse": mse_d, "seconds": sec_d, "fit_s": times_d["fit"],
        "fit_iterations": int(kept["fit"].n_iter),
        "fit_host_syncs": kept["fit_syncs"], "ls_nmse": ls_d,
        "peak_gib": peak_d,
        "launches": {k: v for k, v in launches_d.items() if v}}
    log(f"(d) run_gmm_quant urban-macro: {sec_d:.1f}s, fit "
        f"{times_d['fit']:.2f}s ({int(kept['fit'].n_iter)} iterations, "
        f"{kept['fit_syncs']} host synchronizations), peak memory "
        f"{peak_d:.2f} GiB; NMSE at 5 dB {nmse_d:.5f} (LS {ls_d:.5f}); "
        f"launches {rec['(d) run_gmm_quant urban-macro']['launches']}; "
        f"{card}")
    del kept, bank_d, r_d, h_d
    if not nmse_d < ls_d:
        raise AssertionError(f"(d) NMSE {nmse_d} not below LS {ls_d}")

    # (e) MIMO VAE, noisy mode, under the D = 64 protocol
    with tempfile.TemporaryDirectory() as tmp:
        cfg_e = run_vae.VaeBenchConfig(**VAE_PROTOCOL, **MIMO,
                                       vae_mode="noisy", use_cache=False,
                                       plot=False, results_dir=tmp,
                                       cache_dir=os.path.join(tmp, "saves"))
        r_e, kept = instrumented("(e) run_vae noisy mimo 16x4", run_vae.run,
                                 cfg_e)
        del kept
    if r_e["launches"]:
        raise AssertionError(f"(e) run_vae launched {r_e['launches']}")
    low = r_e["mse"]["vae_noisy"][:snrs.index(10) + 1]
    if not all(x > y for x, y in zip(low, low[1:])):
        raise AssertionError(f"(e) MSE not falling from -10 to 10 dB: {low}")

    # (f) the generators alone
    gens = {}
    for label, fn, cfg_g in (
            ("3gpp", stages.generate_channels, scm.ScmConfig(64, 1)),
            ("urban-macro", stages.generate_channels_macro,
             scm.UrbanMacroConfig(64, n_paths=6)),
            ("mimo 16x4", stages.generate_channels_mimo,
             scm_mimo.ScmMimoConfig(16, 4, n_path=2))):
        gen = torch.Generator(dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ev[0].record()
                out = fn(gen, GEN_ROWS, cfg_g, stages.auto_gen_chunk(
                    cfg_g[0]))
                ev[1].record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        g = {"datagen_s": ev[0].elapsed_time(ev[1]) / 1e3,
             "host_syncs": sum("synchroniz" in str(w.message)
                               for w in caught),
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        h = out[0]
        g["mean_power"] = float((h.abs() ** 2).mean())
        if label == "mimo 16x4":
            _, t_bs, t_ms = out
            c_bs = linalg.toeplitz_from_first_row(t_bs)
            c_ms = linalg.toeplitz_from_first_row(t_ms)
            genie = torch.einsum("bij,bkl->ikjl", c_ms, c_bs).reshape(
                64, 64) / GEN_ROWS
            sample = h.T @ h.conj() / GEN_ROWS
            g["cov_rel_frobenius"] = float(torch.linalg.norm(sample - genie)
                                           / torch.linalg.norm(genie))
            if not abs(g["mean_power"] - 1.0) <= 0.02:
                raise AssertionError(f"(f) MIMO power {g['mean_power']}")
            if not g["cov_rel_frobenius"] <= 0.05:
                raise AssertionError(f"(f) MIMO sample covariance "
                                     f"{g['cov_rel_frobenius']} off the "
                                     "kron genie")
        if label == "urban-macro":
            t0 = out[1][:, 0].real
            g["genie_power_range"] = [float(t0.min()), float(t0.max())]
            if not (g["genie_power_range"][0] >= 1.0 - 1e-3
                    and g["genie_power_range"][1] <= 1.5 ** 3.5 + 1e-3):
                raise AssertionError(f"(f) urban-macro powers "
                                     f"{g['genie_power_range']}")
            g["mean_power_over_genie"] = g["mean_power"] / float(t0.mean())
            if not abs(g["mean_power_over_genie"] - 1.0) <= 0.02:
                raise AssertionError(f"(f) urban-macro power "
                                     f"{g['mean_power_over_genie']}x its "
                                     "genie's")
        del out, h
        gens[label] = g
        log(f"(f) {label} generator, {GEN_ROWS} rows: {g['datagen_s']:.3f}s "
            f"({g['host_syncs']} host synchronizations), peak memory "
            f"{g['peak_gib']:.2f} GiB; "
            + ", ".join(f"{k} {v}" for k, v in g.items()
                        if k not in ("datagen_s", "host_syncs", "peak_gib"))
            + f"; {card}")
    rec["generators"] = gens
    rec["seconds"] = time.time() - t_phase
    log(f"channel models phase 3h: {rec['seconds']:.1f}s")
    return rec


# phase 3i: the user examples (ROADMAP item 17), each at its JAX script's
# sizes, 10 at a 1 x 1 mesh (one card)
EXAMPLE_KERNELS = {   # the kernels each example must launch, and no other
    "01": {"grouped_estimate"},                             # K1
    "02": set(), "04": set(), "05": set(), "06": set(),
    "03": {"grouped_estimate_stats"},                       # K2
    "07": {"grouped_estimate", "grouped_estimate_coherent",  # K1, K3, K11
           "fact_estimate"},
    "08": {"circ_estimate", "circ_estimate_coherent"},      # K6, K7
    "09": {"fact_estimate"},                                # K11
    "10": {"grouped_estimate"},                             # K1
}


def example_numbers(key, out):
    """The headline numbers of one example's result: its NMSE values (and
    the differences its claim reads)."""
    if key == "01":
        return dict(out["nmse"])
    if key == "02":
        return {**out["nmse"], "genie": out["genie"], "ls": out["ls"]}
    if key == "03":
        return {k: out[k] for k in ("nmse", "max_abs_diff", "scale",
                                    "lower_bound", "n_iter")}
    if key == "04":
        return {"nmse": out["nmse"], "loss_first": out["losses"][0],
                "loss_last": out["losses"][-1]}
    if key == "05":
        whole = out["whole"]
        return {"nmse": whole["nmse"], "lower_bound": whole["lower_bound"],
                "n_iter": whole["n_iter"],
                "resumed_after": out["resumed"]["resumed_after"]}
    if key == "06":
        return {str(snr): m for snr, m in out["nmse"].items()}
    if key == "07":
        return {p: out[p]["max_rel_diff"] for p in ("gmm", "mfa", "vae")}
    if key == "08":
        return {**{str(snr): {k: m[k] for k in ("dense", "structured",
                                                 "max_rel_diff")}
                   for snr, m in out["nmse"].items()},
                "auto_alpha": out["auto_alpha"]}
    if key == "09":
        return {**{k: out["nmse"][k] for k in ("factored", "dense",
                                               "coherent", "max_rel_diff")},
                "served": out["service"]["served_nmse"]}
    return {"single": out["single"]["blmmse_gmm"],
            "mesh": out["mesh_rows"]["blmmse_gmm"],
            "max_rel_diff": out["max_rel_diff"]}


def examples_phase(kernels, add):
    """Phase 3i, the user examples (`quantized_channel_estimation_torch.
    examples`): each example's `main()` on the card at the JAX script's
    sizes (05 as `cut_and_resume`: a run cut after segment 2, resumed on
    its checkpoints to 5 segments, and an uninterrupted 5-segment run; 10
    at a 1 x 1 mesh), with the launch counts set to 0 just before it and
    read just after; each example's own claim (`check`) must hold and it
    must launch exactly the kernels of EXAMPLE_KERNELS. Returns the
    phase's record: per example its seconds (host clock, from the first
    call of the phase's shapes), headline numbers and launches."""
    from quantized_channel_estimation_torch import examples
    t_phase = time.time()
    rec = {}
    for name in examples.NAMES:
        key = name[:2]
        ex = examples.load(name)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        if key == "05":
            with tempfile.TemporaryDirectory() as tmp:
                out = ex.cut_and_resume(None, tmp)
        elif key == "10":
            out = ex.main(mesh=(1, 1))
        else:
            out = ex.main()
        torch.cuda.synchronize()
        seconds = time.time() - t
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        add(launches)
        ex.check(out)
        if set(launches) != EXAMPLE_KERNELS[key]:
            raise AssertionError(f"example {name} launched {launches}; it "
                                 f"must launch {EXAMPLE_KERNELS[key]}")
        rec[key] = {"seconds": seconds,
                    "numbers": example_numbers(key, out),
                    "launches": launches}
        log(f"example {name}: {seconds:.1f}s, launches {launches}, "
            f"{rec[key]['numbers']}")
    rec["seconds"] = time.time() - t_phase
    log(f"examples phase 3i: {rec['seconds']:.1f}s")
    return rec


WIDE_SHAPES = ((512, 512), (512, 128), (640, 128), (512, 256), (400, 400))
WIDE_K = 32        # components of the wide shapes' random banks (the scale
#                    bench's K)
WIDE_N = 8191      # rows a shape's check: a ragged count
# GMM banks at the deep end of the rule, (D, pilots, K): 2M = 896 (JAX's
# chunk rule at K = 4) and 2M = 1792 (its whole-bank rule at K < 4)
WIDE_DEEP = ((64, 7, 4), (128, 7, 2))
WIDE_BATCH = 32768  # rows of the times (the scale bench's batch)


def wide_bound(n, two_m, two_d, k, coherent=False, stats=False):
    """(bound ms, 'operations' or 'bytes', tc operations, fp32 operations,
    bytes) of K1 / K2 / K3 at these widths: six bf16 products of r2 [P_k |
    W_k] on the tensor cores plus the fp32 epilogue 2 N K (2M + 2D) (K3 +
    3 N K), against r2 read once, the output (and m, den) written once and
    the fp32 bank read once."""
    tc = 6.0 * 2 * n * two_m * (two_m + two_d) * k
    fp32 = 2.0 * n * k * (two_m + two_d) + (3.0 * n * k if coherent else 0)
    nbytes = 4.0 * (n * two_m + n * two_d + (2 * n if stats else 0)
                    + k * two_m * (two_m + two_d) + k * (two_m + two_d + 1))
    ops_s = fp32 / PEAK_FP32_FLOPS + tc / PEAK_BF16_FLOPS
    by = "operations" if ops_s >= nbytes / PEAK_HBM_BYTES else "bytes"
    return (max(ops_s, nbytes / PEAK_HBM_BYTES) * 1e3, by, tc, fp32, nbytes)


def wide_dense_phase(dev, card, kernels, errs, add, keep=None):
    """Phase 3j, the large-array dense path: the wide form of K1, K2 and K3
    (`csrc/grouped_wide_estimate.cu`, past the stream's 2M, 2D <= 256).

    1. At (2M, 2D) in WIDE_SHAPES (random banks of 32 components, two
       dead, 8191 rows): K1, K3 (T = 4, alpha 1) and K2 (flat on two
       component shards, and coherent at T = 4, alpha 0.5) against their
       plain versions within TOL of the scale; K1, K3 and the shards'
       merged quotient under the float64 rule (`fp32_accuracy`); the two
       shards merged with `merge_stats` within 1e-5 of one K1 launch.
       Then GMM banks at WIDE_DEEP (2M = 896, K = 4; 2M = 1792, K = 2):
       K1 within TOL, and K1, K3 (T = 4) and K2 on two shards merged
       under the float64 rule.
    2. The main paths, each with the launch counts set to 0 just before it
       and read just after, the einsum estimators made to raise inside the
       kernel routes: `tools.scale_bench_large_d` at its defaults (D = 256,
       K = 32, Toeplitz, 60k / 2k rows, 30 iterations, 10 dB, 2 bits;
       genie < GMM < LS, the kernel's estimate within TOL of the einsum
       estimator's, the wide K1 launched and the stream's not);
       `stages.estimate_coherent_auto` at T = 4 on the four-pilot D = 64
       headline bank (2M = 512: the wide K3) and
       `parallel.mesh.estimate_sharded_kernel` over an in-process 1 x 2
       mesh, flat and T = 4 blocks at alpha 0.5 (the wide K2, flat and
       coherent), each within TOL of the einsum estimator's scale.
    3. The wide K1 and K3 launched 20 times at each shape of
       `tools.tc_repeat_check.WIDE_SHAPES` after a NaN fill of shared
       memory, bit for bit the first launch.
    4. CUDA-event times at D = 256, K = 32, 32768 rows (K1, K3 at T = 4,
       K2 flat and coherent), each beside its plain version, the bound
       (`wide_bound`) and the library yardstick (one cuBLAS fp32 GEMM of
       r2 against all K [P_k | W_k] blocks), and K1 at every WIDE_SHAPES
       width.
    Returns the phase's record; its timing records are the kernels line's
    entries of the four wide wrappers. `keep` (a dict) receives the scale
    bench's fitted bank, observations and timed batch (phase 3k reads
    them)."""
    from quantized_channel_estimation_torch.harness import stages
    from quantized_channel_estimation_torch.models import gmm_estimator
    from quantized_channel_estimation_torch.ops import observation, pilots
    from quantized_channel_estimation_torch.ops.cplx import crandn
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    from quantized_channel_estimation_torch.tools import common
    from quantized_channel_estimation_torch.tools import (
        scale_bench_large_d, tc_repeat_check as trc)
    from quantized_channel_estimation_torch.utils import profiling
    t_phase = time.time()
    rec = {"shapes": {}}

    def f64(kb_c):
        return type(kb_c)(*(x.double() for x in kb_c))

    # 1. every listed width against its plain version
    for two_m, two_d in WIDE_SHAPES:
        label = f"2M={two_m}, 2D={two_d}, K={WIDE_K}"
        kb = trc.random_bank(two_m, two_d, WIDE_K, dev, n_dead=2)
        kb64 = f64(kb)
        ops = kernels.tc_operands(kb)
        rows = trc.random_rows(WIDE_N, two_m, dev)
        rows4 = rows[:WIDE_N // 4 * 4]
        got = kernels.grouped_estimate(rows, kb, ops)
        want = kernels.grouped_estimate_reference(rows, kb)
        want64 = kernels.grouped_estimate_reference(rows.double(), kb64)
        errs["grouped_estimate_wide"].append(compare(
            "grouped_estimate_wide", label, got, want))
        acc1, held1 = fp32_accuracy("grouped_estimate_wide", label, got,
                                    want, want64)
        got3 = kernels.grouped_estimate_coherent(rows4, kb, 4, 1.0, ops)
        want3 = kernels.grouped_estimate_coherent_reference(rows4, kb, 4,
                                                            1.0)
        errs["grouped_estimate_coherent_wide"].append(compare(
            "grouped_estimate_coherent_wide", f"{label}, T=4", got3, want3))
        acc3, held3 = fp32_accuracy(
            "grouped_estimate_coherent_wide", f"{label}, T=4", got3, want3,
            kernels.grouped_estimate_coherent_reference(rows4.double(), kb64,
                                                        4, 1.0))
        del got3, want3
        half = WIDE_K // 2
        shards = [kernels.KernelBankBlock(*(x[sl].contiguous() for x in kb))
                  for sl in (slice(0, half), slice(half, WIDE_K))]
        states = []
        for j, shard in enumerate(shards):
            st = kernels.grouped_estimate_stats(rows, shard,
                                                kernels.tc_operands(shard))
            for field, g_x, w_x in zip(
                    ("m", "den", "acc"), st,
                    kernels.grouped_estimate_stats_reference(rows, shard)):
                errs["grouped_estimate_stats_wide"].append(compare(
                    "grouped_estimate_stats_wide",
                    f"{label}, shard {j} {field}", g_x, w_x))
            states.append(st)
        _, den, acc = kernels.merge_stats(*zip(*states))
        merged = acc / den[:, None]
        compare("K2 wide, two shards merged, against one K1 launch", label,
                merged, got, tol=1e-5)
        acc2, held2 = fp32_accuracy(
            "grouped_estimate_stats_wide", f"{label}, merged", merged, want,
            want64)
        for field, g_x, w_x in zip(
                ("m", "den", "acc"),
                kernels.grouped_estimate_coherent_stats(rows4, kb, 4, 0.5,
                                                        ops),
                kernels.grouped_estimate_coherent_stats_reference(
                    rows4, kb, 4, 0.5)):
            errs["grouped_estimate_coherent_stats_wide"].append(compare(
                "grouped_estimate_coherent_stats_wide",
                f"{label}, T=4, alpha=0.5, {field}", g_x, w_x))
        if not (held1 and held2 and held3):
            raise AssertionError(f"the wide form at {label} is less "
                                 "accurate than float32")
        rec["shapes"][label] = {"fp32_accuracy": {
            "K1": acc1, "K3 T=4": acc3, "K2 merged": acc2}}
        del got, want, want64, merged, states, kb64

    # 1b. the float64 rule on GMM banks at the deep end of the rule
    rec["deep"] = {}
    for d_g, p_g, k_g in WIDE_DEEP:
        two_m = 2 * d_g * p_g
        label = f"GMM bank D={d_g}, {p_g} pilots (2M={two_m}), K={k_g}"
        bank_g, _ = common.headline_bank(dev, n_ant=d_g, k_comp=k_g,
                                         n_dead=1 if k_g > 2 else 0,
                                         n_pilots=p_g)
        rows = trc.random_rows(WIDE_N, two_m, dev)
        rows4 = rows[:WIDE_N // 4 * 4]
        kb = kernels.kernel_bank_block(bank_g, 1, 1.0)
        got = kernels.grouped_estimate(rows, kb)
        want = kernels.grouped_estimate_reference(rows, kb)
        want64 = kernels.grouped_estimate_reference(rows.double(), f64(kb))
        errs["grouped_estimate_wide"].append(compare(
            "grouped_estimate_wide", label, got, want))
        acc1, held1 = fp32_accuracy("grouped_estimate_wide", label, got,
                                    want, want64)
        shards = [kernels.KernelBankBlock(*(x[sl].contiguous() for x in kb))
                  for sl in (slice(0, k_g // 2), slice(k_g // 2, k_g))]
        _, den, acc = kernels.merge_stats(*zip(*(
            kernels.grouped_estimate_stats(rows, sh) for sh in shards)))
        acc2, held2 = fp32_accuracy("grouped_estimate_stats_wide",
                                    f"{label}, merged", acc / den[:, None],
                                    want, want64)
        kb4 = kernels.kernel_bank_block(bank_g, 4, 1.0)
        acc3, held3 = fp32_accuracy(
            "grouped_estimate_coherent_wide", f"{label}, T=4",
            kernels.grouped_estimate_coherent(rows4, kb4, 4, 1.0),
            kernels.grouped_estimate_coherent_reference(rows4, kb4, 4, 1.0),
            kernels.grouped_estimate_coherent_reference(rows4.double(),
                                                        f64(kb4), 4, 1.0))
        if not (held1 and held2 and held3):
            raise AssertionError(f"the wide form on the {label} is less "
                                 "accurate than float32")
        rec["deep"][label] = {"fp32_accuracy": {
            "K1": acc1, "K3 T=4": acc3, "K2 merged": acc2}}
        del bank_g, kb, kb4, got, want, want64, acc, den, shards

    # 2. the main paths, the einsum estimators raising inside the kernel
    # routes
    names = ("estimate", "estimate_coherent", "estimate_stats",
             "estimate_coherent_stats")
    saved = {n: getattr(gmm_estimator, n) for n in names}
    in_route = [0]

    def guarded(name):
        def run(*args, **kw):
            if in_route[0]:
                raise AssertionError(f"the einsum {name} was reached on a "
                                     "wide kernel route")
            return saved[name](*args, **kw)
        return run

    def route(fn):
        def run(*args, **kw):
            in_route[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                in_route[0] -= 1
        return run

    def counted(label, fn, want_kernels):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.time() - t
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        add(launches)
        log(f"wide path {label}: {seconds:.1f}s, launches {launches}")
        if set(launches) != want_kernels:
            raise AssertionError(f"wide path {label} launched {launches}; "
                                 f"it must launch {want_kernels}")
        return out, launches, seconds

    saved_auto = stages.estimate_auto
    try:
        for n in names:
            setattr(gmm_estimator, n, guarded(n))
        stages.estimate_auto = route(saved_auto)
        sb, sb_launches, sb_s = counted(
            "scale_bench_large_d (D=256, K=32, toeplitz)",
            lambda: scale_bench_large_d.main(device=dev, keep=keep),
            {"grouped_estimate_wide"})
    finally:
        stages.estimate_auto = saved_auto
        for n, fn in saved.items():
            setattr(gmm_estimator, n, fn)
    log(f"scale_bench_large_d: datagen {sb['datagen_s']:.1f}s, fit "
        f"{sb['fit_s']:.1f}s ({sb['n_iter']} iterations), NMSE gmm "
        f"{sb['nmse_gmm']:.5f}, genie {sb['nmse_genie']:.5f}, LS "
        f"{sb['nmse_ls']:.5f} (gmm / genie {sb['gmm_over_genie']:.3f}); "
        f"estimation {sb['rate_kernel']:.4g} est/s through the {sb['route']}"
        f" K1 ({sb['kernel_ms']:.3f} ms a {WIDE_BATCH}-row call), einsum "
        f"{sb['rate_einsum']:.4g} est/s ({sb['einsum_ms']:.3f} ms); kernel "
        f"vs einsum {sb['kernel_vs_einsum']:.2e} of scale; {card}")
    if not (sb["nmse_genie"] < sb["nmse_gmm"] < sb["nmse_ls"]):
        raise AssertionError(f"scale_bench_large_d: NMSE order off: {sb}")
    if not (sb["kernel_vs_einsum"] <= TOL and sb["route"] == "wide"):
        raise AssertionError(f"scale_bench_large_d: the kernel estimate is "
                             f"off the einsum's: {sb}")
    rec["scale_bench_large_d"] = {**sb, "seconds": sb_s}

    bank4, q = common.headline_bank(dev, n_pilots=4)    # 2M = 512, 2D = 128
    a4 = pilots.pilot_matrix(D, 4, N_BITS, device=dev)
    g4 = torch.Generator(device=dev).manual_seed(2)
    r4 = observation.observe(g4, crandn(g4, (8192, D)), SNR, a4, N_BITS, q)
    rb4 = r4.reshape(-1, 4, r4.shape[1])
    want_flat = gmm_estimator.estimate(bank4, r4, "all")
    want_b = {a: gmm_estimator.estimate_coherent(bank4, rb4, "all", 512, a)
              for a in (1.0, 0.5)}
    mesh12 = pmesh.make_local_mesh(1, 2)
    paths = (
        ("stages.estimate_coherent_auto, T=4",
         lambda: stages.estimate_coherent_auto(bank4, rb4, "all", 1.0),
         want_b[1.0], {"grouped_estimate_coherent_wide"}),
        ("estimate_sharded_kernel, 1 x 2 mesh, flat",
         lambda: pmesh.estimate_sharded_kernel(mesh12, bank4, r4),
         want_flat, {"grouped_estimate_stats_wide"}),
        ("estimate_sharded_kernel, 1 x 2 mesh, T=4, alpha=0.5",
         lambda: pmesh.estimate_sharded_kernel(mesh12, bank4, rb4,
                                               coherence_alpha=0.5),
         want_b[0.5], {"grouped_estimate_coherent_stats_wide"}))
    rec["paths"] = {}
    try:
        for n in names:
            setattr(gmm_estimator, n, guarded(n))
        in_route[0] += 1
        for label, fn, want, kset in paths:
            got, launches, seconds = counted(label, fn, kset)
            rel = float((got - want).abs().max() / want.abs().max())
            log(f"{label} on the four-pilot bank (2M = 512, N = "
                f"{r4.shape[0]}): {rel:.3e} of the einsum estimator's "
                f"scale (tol {TOL})")
            if not (rel <= TOL and torch.isfinite(got.abs()).all()):
                raise AssertionError(f"{label}: off the einsum estimator")
            rec["paths"][label] = {"rel_to_einsum": rel,
                                   "launches": launches, "seconds": seconds}
    finally:
        in_route[0] -= 1
        for n, fn in saved.items():
            setattr(gmm_estimator, n, fn)
    del bank4, r4, rb4, want_flat, want_b

    # 3. repeated launches
    tm = time.time()
    rep = trc.repeat_check(dev, repeats=20, modes=("wide",))["kernel"]
    bad = {k: v for k, v in rep.items() if v["failures"]}
    log(f"wide K1 / K3 repeated: {sum(v['launches'] for v in rep.values())}"
        f" launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"the wide K1 / K3 off on repeated launches: "
                             f"{bad}")
    rec["repeat_check"] = rep

    # 4. times at the scale bench's widths, and K1 at every listed width
    n = WIDE_BATCH
    times = {}
    for two_m, two_d in WIDE_SHAPES:     # (512, 512) first
        kb = trc.random_bank(two_m, two_d, WIDE_K, dev, n_dead=2)
        ops = kernels.tc_operands(kb)
        r2 = trc.random_rows(n, two_m, dev)
        flat = kb.pw.permute(1, 0, 2).reshape(two_m, -1).contiguous()
        gemm = lambda: r2 @ flat  # noqa: E731
        forms = [("grouped_estimate_wide", False, False,
                  lambda: kernels.grouped_estimate(r2, kb, ops),
                  lambda: kernels.grouped_estimate_reference(r2, kb))]
        if (two_m, two_d) == (512, 512):
            forms += [
                ("grouped_estimate_coherent_wide", True, False,
                 lambda: kernels.grouped_estimate_coherent(r2, kb, 4, 1.0,
                                                           ops),
                 lambda: kernels.grouped_estimate_coherent_reference(
                     r2, kb, 4, 1.0)),
                ("grouped_estimate_stats_wide", False, True,
                 lambda: kernels.grouped_estimate_stats(r2, kb, ops),
                 lambda: kernels.grouped_estimate_stats_reference(r2, kb)),
                ("grouped_estimate_coherent_stats_wide", True, True,
                 lambda: kernels.grouped_estimate_coherent_stats(
                     r2, kb, 4, 1.0, ops),
                 lambda: kernels.grouped_estimate_coherent_stats_reference(
                     r2, kb, 4, 1.0))]
        for name, coh, stats, kern, plain in forms:
            plain_ms = profiling.device_ms(plain)
            ms = profiling.device_ms(kern)
            ms2 = profiling.device_ms(kern)
            plain_ms2 = profiling.device_ms(plain)
            library_ms = profiling.device_ms(gemm)
            bound_ms, by, tc, fp32, nbytes = wide_bound(
                n, two_m, two_d, WIDE_K, coh, stats)
            t = {"ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
                 "plain_ms_again": plain_ms2, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": library_ms,
                 "tc_flops": tc, "fp32_flops": fp32, "bytes": nbytes,
                 "share_of_bound": bound_ms / ms}
            log(f"{name} at N={n}, 2M={two_m}, 2D={two_d}, K={WIDE_K}"
                + (", T=4" if coh else "") + f": kernel {ms:.3f} / "
                f"{ms2:.3f} ms, plain {plain_ms:.3f} / {plain_ms2:.3f} ms, "
                f"library (fp32 GEMM) {library_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({by}; {bound_ms / ms:.0%} reached), "
                f"{n / (ms * 1e-3):.4g} estimates/s; {card}")
            times[name if (two_m, two_d) == (512, 512)
                  else f"{name} 2M={two_m}, 2D={two_d}"] = t
        del kb, ops, r2, flat
    rec["times"] = times
    rec["seconds"] = time.time() - t_phase
    log(f"wide dense phase 3j: {rec['seconds']:.1f}s")
    return rec

WIDE_TIE_REL = 1e-5  # the wide top-k's tie gap: max(TIE_GAP, 1e-5 |logit|)
WIDE_TOPK_K = (1, 4)


def wide_topk_bound(n, two_m, two_d, k, k_sel, stats=False):
    """(bound ms, 'operations' or 'bytes', tc operations, fp32 operations,
    bytes) of the wide K4 / K5: six bf16 products of the logits r2 P_k (2 N
    2M 2M K) and of the picked rows' values r2 W_j (2 N 2M 2D a slot) on
    the tensor cores, plus the fp32 epilogue (the logits' 2 N K 2M, the
    values' bias N k 2D and K4's combine 2 N k 2D), against r2 read once,
    the outputs written once (K4 (N, 2D); K5 (N, k) and (N, k, 2D)) and
    the fp32 bank read once."""
    tc = 6.0 * 2 * n * two_m * (two_m * k + two_d * k_sel)
    fp32 = 2.0 * n * k * two_m + n * k_sel * two_d * (1 if stats else 3)
    out = n * k_sel * (1 + two_d) if stats else n * two_d
    nbytes = 4.0 * (n * two_m + out + k * two_m * (two_m + two_d)
                    + k * (two_m + two_d + 1))
    ops_s = fp32 / PEAK_FP32_FLOPS + tc / PEAK_BF16_FLOPS
    by = "operations" if ops_s >= nbytes / PEAK_HBM_BYTES else "bytes"
    return (max(ops_s, nbytes / PEAK_HBM_BYTES) * 1e3, by, tc, fp32, nbytes)


def wide_keep(kernels, r2, kb, k_sel, order=False):
    """The rows the wide top-k is compared on: those whose k-th and
    (k+1)-th logits (`order`: any two live ones of the top k + 1, whose
    order K5 writes) lie further apart than max(TIE_GAP, WIDE_TIE_REL
    |logit|). At 2M = 512 a logit is a sum of hundreds of squares in the
    hundreds, where TIE_GAP is a few float32 ulps."""
    from quantized_channel_estimation_torch.tools.tc_repeat_check import (
        topk_near_ties)
    lg = kernels.component_logits(r2, kb)
    if not order:
        return ~topk_near_ties(lg, k_sel, TIE_GAP, WIDE_TIE_REL)
    top = lg.sort(-1, descending=True).values[:, :k_sel + 1]
    gap = torch.clamp(WIDE_TIE_REL * top[:, :-1].abs(), min=TIE_GAP)
    return ~(((top[:, :-1] - top[:, 1:]) < gap)
             & (top[:, 1:] > -1e29)).any(-1)


def wide_picks(kernels, r2, kb, k_sel):
    """The components the wide top-k picks a row, read through the wide K5
    on kb with W = 0 and b_j = j: the same logits and picks, and each
    candidate's first value its component (-1 for an empty slot)."""
    k_comp, two_m, _ = kb.pw.shape
    tag = kb._replace(
        pw=torch.cat([kb.pw[:, :, :two_m],
                      torch.zeros_like(kb.pw[:, :, two_m:])], -1)
        .contiguous(),
        b=torch.arange(k_comp, dtype=torch.float32, device=kb.b.device)[
            :, None].expand_as(kb.b).contiguous())
    l_t, z_t = kernels.grouped_estimate_topk_stats_wide(r2, tag, k_sel)
    return torch.where(torch.isinf(l_t), -1, z_t[..., 0].round().long())


def wide_topk_phase(dev, card, kernels, errs, add, fitted):
    """Phase 3k, top-k selection on wide banks: the wide form of K4 and K5
    (`grouped_wide_topk_launch` in `csrc/grouped_wide_estimate.cu`, past
    the narrow `grouped_topk.cu`'s 2M, 2D <= 256).

    1. At (2M, 2D) in WIDE_SHAPES (random banks of 32 components, two
       dead, 8191 rows), k in {1, 4}: the wide K4 against its plain
       version within TOL of the scale on the rows not near a tie
       (`wide_keep`; the count left out printed; at least 90% compared),
       its picks (`wide_picks`) the float64 plain version's on those rows
       and its error against float64 at most twice the float32 plain
       version's (`fp32_accuracy`); K5 on two component shards against
       its plain version (rows without a near tie among the top k + 1)
       and merged with `merge_topk` within 1e-5 of one wide K4 launch.
    2. The main paths, each with the launch counts set to 0 just before it
       and read just after, the einsum estimator made to raise inside the
       kernel routes: `stages.estimate_auto` at k = 1 and 4 on the D = 256,
       K = 32 Toeplitz bank phase 3j fitted (`fitted`: the scale bench's
       `keep`), its NMSE at 10 dB beside the 'all' mode's and the
       estimate on the 32768-row batch within TOL of the einsum
       estimator's; `run_gmm` at the defaults with `n_pilots=3` (2M = 384)
       and `n_summands_or_proba=1` (genie < GMM < LS at -10 and -5 dB; at
       5 dB on every Bussgang column loses to LS under `angle_amp` pilots,
       so those rows are printed); the service in mode 1 on the
       four-pilot headline prior (2M = 512), 8 clients x 64 snapshots for
       1 s, every answer within TOL of the scale of an einsum service's
       (near-tie rows left out) and no failed request; and
       `parallel.mesh.estimate_sharded` at k = 4 over an in-process 1 x 2
       mesh (the wide K5 a shard, merged).
    3. The wide K4 and K5 launched 20 times at each shape of
       `tools.tc_repeat_check.WIDE_TOPK_SHAPES`, each launch on the NaN-
       filled memory of the last one's outputs after a NaN fill of shared
       memory, bit for bit the first launch.
    4. CUDA-event times on the fitted bank at 32768 rows, k = 1 and 4: the
       wide K4 and K5, each beside its plain version, the bound
       (`wide_topk_bound`), the library yardstick (one cuBLAS fp32 GEMM of
       r2 against all K precision blocks P_k: the logits' product) and the
       einsum estimator in the same mode.
    Returns the phase's record; its timing records are the kernels line's
    entries of the two wide top-k wrappers."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.harness import run_gmm, stages
    from quantized_channel_estimation_torch.models import gmm_estimator
    from quantized_channel_estimation_torch.ops import observation, pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.ops.cplx import crandn
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    from quantized_channel_estimation_torch.tools import (
        tc_repeat_check as trc)
    from quantized_channel_estimation_torch.utils import profiling
    t_phase = time.time()
    rec = {"tie_gap": {"abs": TIE_GAP, "rel": WIDE_TIE_REL}, "shapes": {}}
    k4, k5 = "grouped_estimate_topk_wide", "grouped_estimate_topk_stats_wide"

    # 1. every listed width against its plain version
    for two_m, two_d in WIDE_SHAPES:
        kb = trc.random_bank(two_m, two_d, WIDE_K, dev, n_dead=2)
        kb64 = type(kb)(*(x.double() for x in kb))
        ops = kernels.tc_operands(kb)
        rows = trc.random_rows(WIDE_N, two_m, dev)
        lg64 = kernels.component_logits(rows.double(), kb64)
        half = WIDE_K // 2
        shards = [kernels.KernelBankBlock(*(x[sl].contiguous() for x in kb))
                  for sl in (slice(0, half), slice(half, WIDE_K))]
        for k_sel in WIDE_TOPK_K:
            label = f"2M={two_m}, 2D={two_d}, K={WIDE_K}, k={k_sel}"
            keep = wide_keep(kernels, rows, kb, k_sel)
            n_cmp = int(keep.sum())
            if n_cmp < 0.9 * WIDE_N:
                raise AssertionError(f"wide top-k at {label}: only {n_cmp} "
                                     f"of {WIDE_N} rows clear of a tie")
            got = kernels.grouped_estimate_topk(rows, kb, k_sel, ops)
            want = kernels.grouped_estimate_topk_reference(rows, kb, k_sel)
            want64 = kernels.grouped_estimate_topk_reference(
                rows.double(), kb64, k_sel)
            errs[k4].append(compare(k4, label, got, want, ~keep))
            acc, held = fp32_accuracy(k4, label, got[keep], want[keep],
                                      want64[keep])
            picked64 = lg64.sort(dim=-1, descending=True,
                                 stable=True).indices[:, :k_sel]
            mine = wide_picks(kernels, rows, kb, k_sel)
            same = bool(torch.equal(mine[keep].sort(-1).values,
                                    picked64[keep].sort(-1).values))
            cands = []
            for j, shard in enumerate(shards):
                l_j, z_j = kernels.grouped_estimate_topk_stats(
                    rows, shard, k_sel, kernels.tc_operands(shard))
                l_p, z_p = kernels.grouped_estimate_topk_stats_reference(
                    rows, shard, k_sel)
                ok = wide_keep(kernels, rows, shard, k_sel, order=True)
                errs[k5].append(compare(k5, f"{label}, shard {j} z",
                                        z_j.reshape(WIDE_N, -1),
                                        z_p.reshape(WIDE_N, -1), ~ok))
                compare(k5, f"{label}, shard {j} l", l_j, l_p, ~ok)
                cands.append((l_j, z_j))
            merged = kernels.merge_topk(*zip(*cands), k_sel)
            compare("K5 wide, two shards merged, against one K4 launch",
                    label, merged, got, ~keep, tol=1e-5)
            log(f"wide top-k at {label}: {WIDE_N - n_cmp} rows within the "
                f"tie gap max({TIE_GAP}, {WIDE_TIE_REL} |logit|) not "
                f"compared; picks equal float64's: {same}")
            if not (held and same):
                raise AssertionError(f"the wide K4 at {label}: float64 rule "
                                     f"{held}, picks {same}")
            rec["shapes"][label] = {"rows_not_compared": WIDE_N - n_cmp,
                                    "fp32_accuracy": acc}
        del kb, kb64, ops, rows, lg64, shards, got, want, want64, merged

    # 2. the main paths, the einsum estimator raising inside the kernel
    # routes
    saved = gmm_estimator.estimate
    in_route = [0]

    def guarded(*args, **kw):
        if in_route[0]:
            raise AssertionError("the einsum estimator was reached on a "
                                 "wide top-k route")
        return saved(*args, **kw)

    def route(fn):
        def run(*args, **kw):
            in_route[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                in_route[0] -= 1
        return run

    def counted(label, fn, want_kernels):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.time() - t
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        add(launches)
        log(f"wide top-k path {label}: {seconds:.1f}s, launches {launches}")
        if set(launches) != want_kernels:
            raise AssertionError(f"wide top-k path {label} launched "
                                 f"{launches}; it must launch {want_kernels}")
        return out, launches, seconds

    bank, r_val, h_val, rb = (fitted[x] for x in ("bank", "r", "h_val",
                                                  "batch"))
    kb = kernels.kernel_bank_block(bank)
    r2b = kernels._r2(rb)
    saved_auto, saved_topk = stages.estimate_auto, kernels.estimate_fused_topk
    rec["paths"] = {}
    try:
        gmm_estimator.estimate = guarded
        stages.estimate_auto = route(saved_auto)
        kernels.estimate_fused_topk = route(saved_topk)
        for k_sel in WIDE_TOPK_K:
            label = f"stages.estimate_auto, k={k_sel}, D=256, K=32"
            (h_k, got_b), launches, seconds = counted(
                label, lambda: (stages.estimate_auto(bank, r_val, k_sel),
                                stages.estimate_auto(bank, rb, k_sel)),
                {k4})
            nmse = stages.nmse(h_k, h_val)
            want_b = saved(bank, rb, k_sel, 4096)
            keep = wide_keep(kernels, r2b, kb, k_sel)
            rel = float((got_b - want_b).abs()[keep].max()
                        / want_b.abs().max())
            log(f"{label}: NMSE at 10 dB {nmse:.5f} ('all' "
                f"{fitted['nmse_gmm']:.5f}, genie {fitted['nmse_genie']:.5f},"
                f" LS {fitted['nmse_ls']:.5f}); on the {r2b.shape[0]}-row "
                f"batch {rel:.3e} of the einsum estimator's scale "
                f"({int((~keep).sum())} near-tie rows not compared)")
            if not (rel <= TOL and math.isfinite(nmse)
                    and nmse < fitted["nmse_ls"]):
                raise AssertionError(f"{label}: off the einsum estimator or "
                                     f"above LS: {rel}, {nmse}")
            rec["paths"][label] = {"nmse": nmse, "rel_to_einsum": rel,
                                   "launches": launches, "seconds": seconds}
        del h_k, got_b, want_b

        # run_gmm under three angle_amp pilots (2M = 384), argmax mode
        with tempfile.TemporaryDirectory() as tmp:
            (cfg, mse, _, _, seconds, launches) = main_path_run(
                run_gmm, kernels, dev, tmp, falling=False, n_pilots=3,
                n_summands_or_proba=1)
        launches = {k: v for k, v in launches.items() if v}
        add(launches)
        for snr in (-10, -5):
            i = list(cfg.snrs).index(snr)
            at = {k: v[i] for k, v in mse.items()}
            if not (at["blmmse_genie"] < at["blmmse_gmm"] < at["LS_glob"]):
                raise AssertionError(f"run_gmm n_pilots=3, top-1: MSE order "
                                     f"at {snr} dB broken: {at}")
        if launches != {k4: len(cfg.snrs)}:
            raise AssertionError(f"run_gmm n_pilots=3, top-1 launched "
                                 f"{launches}")
        log("run_gmm n_pilots=3, n_summands_or_proba=1 (2M = 384): "
            + "; ".join(f"{k} {['%.4f' % v for v in vals]}"
                        for k, vals in mse.items()))
        rec["paths"]["run_gmm n_pilots=3, top-1"] = {
            "mse": mse, "launches": launches, "seconds": seconds}
    finally:
        gmm_estimator.estimate = saved
        stages.estimate_auto = saved_auto
        kernels.estimate_fused_topk = saved_topk

    # the service in mode 1 on the four-pilot prior (2M = 512), every
    # answer held against an einsum service's to the same request
    params = serving_params()
    a4 = pilots.pilot_matrix(D, 4, N_BITS, device=dev)
    a4_np = a4.cpu().numpy()
    params_dev = type(params)(*(torch.as_tensor(x, device=dev)
                                for x in params))
    banks4 = {snr: gmm_estimator.prepare_bank(
        params_dev, snr, a4, N_BITS,
        Q.design_quantizer(snr, N_BITS, device=dev))
        for snr in (*SERVE_SNRS, SNR)}

    def near_tie4(r_np, snr):
        rt = torch.as_tensor(r_np, device=dev)
        return (~wide_keep(kernels, kernels._r2(rt),
                           kernels.kernel_bank_block(banks4[snr]), 1)
                ).cpu().numpy()

    svc = serving.EstimationService(params, a4_np, N_BITS, mode=1,
                                    use_kernels=True,
                                    max_batch=SERVE_MAX_BATCH, device=dev)
    plain = serving.EstimationService(params, a4_np, N_BITS, mode=1,
                                      use_kernels=False,
                                      max_batch=SERVE_MAX_BATCH, device=dev)
    try:
        gmm_estimator.estimate = guarded
        kernels.estimate_fused_topk = route(saved_topk)
        rec["service"] = serve_mode(
            svc, kernels, dev, "top-1, 4 pilots (2M = 512)", 1, k4,
            lambda rt: saved(banks4[SNR], rt, 1),
            lambda rt: torch.as_tensor(near_tie4(rt.cpu().numpy(), SNR),
                                       device=dev),
            seconds=1.0, same_as=plain, same_as_near_tie=near_tie4)
        add(rec["service"]["launches"])
    finally:
        gmm_estimator.estimate = saved
        kernels.estimate_fused_topk = saved_topk
        svc.close(timeout=120.0)
        plain.close(timeout=120.0)
    if set(k for k, v in rec["service"]["launches"].items() if v) != {k4}:
        raise AssertionError(f"the top-1 service launched "
                             f"{rec['service']['launches']}")

    # estimate_sharded at k = 4 over an in-process 1 x 2 mesh
    bank4 = banks4[SNR]
    g4 = torch.Generator(device=dev).manual_seed(2)
    r4 = observation.observe(g4, crandn(g4, (8192, D)), SNR, a4, N_BITS,
                             Q.design_quantizer(SNR, N_BITS, device=dev))
    want4 = saved(bank4, r4, 4)
    keep4 = wide_keep(kernels, kernels._r2(r4),
                      kernels.kernel_bank_block(bank4), 4)
    try:
        gmm_estimator.estimate = guarded
        in_route[0] += 1
        got4, launches, seconds = counted(
            "estimate_sharded, k=4, 1 x 2 mesh",
            lambda: pmesh.estimate_sharded(pmesh.make_local_mesh(1, 2),
                                           bank4, r4, 4), {k5})
    finally:
        in_route[0] -= 1
        gmm_estimator.estimate = saved
    rel = float((got4 - want4).abs()[keep4].max() / want4.abs().max())
    log(f"estimate_sharded, k=4 over a 1 x 2 mesh (2M = 512, N = 8192): "
        f"{rel:.3e} of the einsum estimator's scale (tol {TOL}; "
        f"{int((~keep4).sum())} near-tie rows not compared)")
    if not rel <= TOL:
        raise AssertionError("estimate_sharded, k=4: off the einsum "
                             "estimator")
    rec["paths"]["estimate_sharded, k=4, 1 x 2 mesh"] = {
        "rel_to_einsum": rel, "launches": launches, "seconds": seconds}
    del r4, want4, got4

    # 3. repeated launches
    tm = time.time()
    rep = trc.repeat_check(dev, repeats=20, modes=("wide_topk",))["kernel"]
    bad = {k: v for k, v in rep.items() if v["failures"]}
    log(f"wide K4 / K5 repeated: {sum(v['launches'] for v in rep.values())}"
        f" launches in {time.time() - tm:.1f}s, failures {bad or 0}")
    if bad:
        raise AssertionError(f"the wide K4 / K5 off on repeated launches: "
                             f"{bad}")
    rec["repeat_check"] = rep

    # 4. times on the fitted bank at the scale bench's batch
    ops = kernels.tc_operands(kb)
    two_m = kb.mu.shape[1]
    two_d = kb.b.shape[1]
    k_comp = kb.pw.shape[0]
    n = r2b.shape[0]
    logit_flat = kb.pw[:, :, :two_m].permute(1, 0, 2).reshape(
        two_m, -1).contiguous()
    gemm = lambda: r2b @ logit_flat  # noqa: E731
    times = {}
    for k_sel in WIDE_TOPK_K:
        einsum_ms = profiling.device_ms(lambda: saved(bank, rb, k_sel, 4096))
        for name, stats, kern, plain_fn in (
                (k4, False,
                 lambda: kernels.grouped_estimate_topk(r2b, kb, k_sel, ops),
                 lambda: kernels.grouped_estimate_topk_reference(r2b, kb,
                                                                 k_sel)),
                (k5, True,
                 lambda: kernels.grouped_estimate_topk_stats(r2b, kb, k_sel,
                                                             ops),
                 lambda: kernels.grouped_estimate_topk_stats_reference(
                     r2b, kb, k_sel))):
            plain_ms = profiling.device_ms(plain_fn)
            ms = profiling.device_ms(kern)
            ms2 = profiling.device_ms(kern)
            plain_ms2 = profiling.device_ms(plain_fn)
            library_ms = profiling.device_ms(gemm)
            bound_ms, by, tc, fp32, nbytes = wide_topk_bound(
                n, two_m, two_d, k_comp, k_sel, stats)
            t = {"ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
                 "plain_ms_again": plain_ms2, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": library_ms,
                 "einsum_ms": einsum_ms, "tc_flops": tc, "fp32_flops": fp32,
                 "bytes": nbytes, "share_of_bound": bound_ms / ms}
            log(f"{name} at N={n}, 2M={two_m}, 2D={two_d}, K={k_comp}, "
                f"k={k_sel}: kernel {ms:.3f} / {ms2:.3f} ms, plain "
                f"{plain_ms:.3f} / {plain_ms2:.3f} ms, library (fp32 logit "
                f"GEMM) {library_ms:.3f} ms, einsum estimator "
                f"{einsum_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}; "
                f"{bound_ms / ms:.0%} reached), {n / (ms * 1e-3):.4g} "
                f"estimates/s; {card}")
            times[f"{name} k={k_sel}"] = t
    rec["times"] = times
    rec["seconds"] = time.time() - t_phase
    log(f"wide top-k phase 3k: {rec['seconds']:.1f}s")
    return rec


# phase 3l: the circulant kernels on wide banks. Cases (D, K, T, alpha,
# dead components, blocks): K <= 128 through one launch of K6 / K7 and of
# K8 / K9 (the factorised kernel where D splits, and its STATS form where
# the route admits K and T too, `circ_kernels.circ_route`; else the dense
# wide form, as at 131, 134 and 652), K = 200 through two K8 / K9 shards,
# merged (at D = 256 one on each route)
WIDE_CIRC_CASES = (
    (129, 1, 1, 1.0, 0, None),
    (131, 16, 1, 1.0, 1, None),
    (134, 8, 4, 0.25, 1, None),
    (652, 16, 4, 1.0, 2, None),
    (357, 128, 64, 0.25, 3, None),
    (129, 16, 4, 0.25, 1, None),
    (192, 64, 16, 1.0, 2, None),
    (256, 16, 1, 1.0, 2, (16, 16)),
    (256, 200, 4, 1.0, 3, None),
    (512, 16, 1, 1.0, 2, None),
    (512, 64, 64, 0.25, 1, None),
    (640, 200, 1, 1.0, 2, None),
    (640, 16, 4, 1.0, 1, None),
    (672, 16, 16, 0.25, 1, None),
    (672, 1, 4, 1.0, 0, None),
)
WIDE_CIRC_N = 4097      # rows a case: whole T-row blocks below it
WIDE_CIRC_F64_D = (512, 672)  # widths under the float64 rule, at K = 16
# (D, K) of the service, the mesh path and the times, and the rows of the
# times: the JAX tool's d512 leg
WIDE_CIRC_DK, WIDE_CIRC_BATCH = (512, 16), 32768
# `run_gmm` at the JAX tool's width (tools/circ_kernel_bench.py:104-115)
# and the sizes of the JAX `tools/structured_bank_bench.py` large-D legs
WIDE_CIRC_FIT = dict(n_antennas=512, n_components=16, cov_type="circulant",
                     use_structured_bank=True, n_train=60_000, n_val=2_000)
WIDE_CIRC_NAMES = {(False, False): "circ_estimate_wide",
                   (True, False): "circ_estimate_coherent_wide",
                   (False, True): "circ_estimate_stats_wide",
                   (True, True): "circ_estimate_coherent_stats_wide"}
FACT_CIRC_NAMES = {(False, False): "circ_estimate_fact",
                   (True, False): "circ_estimate_coherent_fact",
                   (False, True): "circ_estimate_stats_fact",
                   (True, True): "circ_estimate_coherent_stats_fact"}
# a width the factorised kernel does not split (4 x 163): the dense wide
# K6 / K7's main path, the stages' entries
WIDE_CIRC_DENSE_D = 652


def wide_circ_phase(dev, card, kernels, errs, add):
    """Phase 3l, the circulant kernels on wide banks, past the template's
    D = 128 up to the rule's D = 672: K6 / K7 on the factorised kernel
    (`csrc/circ_fact_estimate.cu`) where the transform splits and K8 / K9
    on its STATS form where the route admits their K and T too
    (`circ_kernels.circ_route`), each on the wide form
    (`csrc/circ_wide_estimate.cu`) elsewhere.

    1. At each of WIDE_CIRC_CASES (seeded circulant banks at 10 dB, 2
       bits, their quantized observations, 4097 rows or the whole blocks
       below): K6 (T = 1) or K7 and K8 or K9 against their plain versions
       (the factorised kernel's `circ_fact_reference`, with `stats=True`
       for K8 / K9) within TOL of the
       scale, or where the float32 plain version's own rounding (logits in
       the thousands, pooled over T rows) pushes the two apart, both
       against the plain version in float64 (`compare64` at ceiling TOL:
       the kernel within TOL of the scale of the float64 plain version
       and its error at most twice the float32 plain version's; every
       comparison's readings kept under "against_float64"); K = 200: each
       of the two shards' K8 / K9 states, and the merged quotient, which
       the entry returns, against the plain states merged likewise (the
       factorised K8 / K9 at D = 640; at D = 256 the 128-component shard
       on the dense wide form). Then K6, K7 (T = 4), K8 and
       K9 (T = 4) at D = 512 and 672, K = 16, under the float64 rule
       (`fp32_accuracy`, each of m, den and acc for the stats forms).
    2. `tools.circ_kernel_bench`, its four legs (flat, coherent, tp, d512)
       with the kernels' ms, bound and the `torch.fft` pipeline's ms; on
       the d512 leg's inputs, and the same at D = 672, the factorised K6
       and K7 (T = 4) through the entries, their plain version (in
       float32, and in float64 on the same layout) and the pipeline
       against the pipeline in float64, the kernel at most twice the
       error of its plain version and of the pipeline; the tool's
       `dft_construction_error` at D = 64, 128 and 512 (recorded).
    3. The main paths, each with the launch counts set to 0 just before it
       and read just after: `run_gmm` at D = 512, K = 16 (`WIDE_CIRC_FIT`,
       7 SNRs) flat and at T = 4 (genie < GMM < LS at every SNR; the
       factorised K6, and K7 for the coherent column, launched once an SNR
       and no other kernel; the flat run's NMSE within TOL of the same run
       on the saved fit through the `torch.fft` pipeline); the structured
       service on a D = 512, K = 16 circulant prior (8 clients x 64
       snapshots, 1 s, flat and T = 4 blocks), every answer within TOL of
       the scale of a `torch.fft` service's to the same request or, past
       it, within TOL of the factorised kernel's plain version in float64
       and no further from it than twice that service's answer
       (`serve_mode(same_as_exact=)`); the same service over an in-process
       1 x 2 mesh (the factorised K8 / K9 a shard, and no other kernel);
       `parallel.mesh.estimate_sharded_circulant` over an in-process 1 x 2
       mesh, flat and T = 4 blocks (the factorised K8 / K9), against the
       `torch.fft` pipeline under the same rule (`compare64`); and
       `stages.estimate_circulant[_coherent]` at D = 652 = 4 x 163 (the
       wide K6 / K7) under the same rule.
    4. The wide K6-K9 launched 20 times at each shape of
       `tools.tc_repeat_check.WIDE_CIRC_SHAPES`, and the factorised K6-K9
       at each of `FACT_CIRC_SHAPES`, on NaN-filled outputs, bit for bit
       the first launch.
    5. CUDA-event times at D = 512, K = 16, 32768 rows (the factorised K6,
       K7 at T = 4, K8 and K9 at T = 4, and in the same call the dense
       wide K6, K7, K8 and K9), each beside its plain version, the bound
       (`circ_kernels.circ_bound`: the transforms as FFTs; and the
       kernels' dense transforms) and the library yardstick (the
       `torch.fft` pipeline over the batch as one chunk); the factorised
       K6 / K7 at D = 672 beside the pipeline; at the narrow headline (D =
       64, K = 64, 131072 rows) the factorised kernel and the narrow K6
       template in turns.
    Returns the phase's record; its timing records are the kernels line's
    entries of the four wide wrappers and the four factorised ones."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck)
    from quantized_channel_estimation_torch.harness import run_gmm, stages
    from quantized_channel_estimation_torch.models import (
        structured_bank as sb)
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    from quantized_channel_estimation_torch.tools import (
        circ_kernel_bench, common, tc_repeat_check as trc)
    from quantized_channel_estimation_torch.utils import profiling
    t_phase = time.time()
    rec = {"cases": {}, "fp32_accuracy": {}, "against_float64": {}}
    q = Q.design_quantizer(SNR, N_BITS, device=dev)

    def held(name, label, got, want, want64):
        """`compare64` at the wide kernels' ceiling (TOL of the scale
        against the float64 plain version), its readings recorded."""
        return compare64(name, label, got, want, want64, ceiling=TOL,
                         record=rec["against_float64"])

    def f64(ckb):
        return ck.CircKernelBank(*(x.double() for x in ckb))

    def kernel(ckb, x2, t, alpha, stats):
        if stats:
            return (ck.circ_estimate_coherent_stats(x2, ckb, t, alpha)
                    if t > 1 else ck.circ_estimate_stats(x2, ckb))
        return (ck.circ_estimate_coherent(x2, ckb, t, alpha) if t > 1
                else ck.circ_estimate(x2, ckb),)

    def plain(ckb, x2, t, alpha, stats, blocks=None):
        """The plain version of the kernel the wrappers launch (`name`)."""
        name = route_name(x2.shape[1] // 2, t, stats, blocks,
                          ckb.const.shape[0])
        if name in FACT_CIRC_NAMES.values():
            out = ck.circ_fact_reference(x2, ckb, t, alpha, blocks,
                                         stats=stats)
        else:
            out = ck._circ_reference(x2, ckb, t, alpha, stats, 16384)
        return out if stats else (out,)

    def route_name(d, t, stats, blocks=None, k=1):
        """The wrapper that counts the launch at (D, T, stats, basis, K)."""
        names = (FACT_CIRC_NAMES
                 if ck.circ_route(d, blocks, stats, k, t) == "fact"
                 else WIDE_CIRC_NAMES)
        return names[(t > 1, stats)]

    def quotient(states):
        _, den, acc = ck.merge_stats(*zip(*states))
        return acc / den[:, None]

    def real_rows(x):
        """Complex (..., D) -> rows of interleaved [re, im] pairs (n, 2D),
        in x's own precision."""
        return torch.view_as_real(x.contiguous()).reshape(-1,
                                                          2 * x.shape[-1])

    def c128(bank_c):
        """The float32 bank's own values in float64 / complex128."""
        return type(bank_c)(*(x.to(torch.complex128) if x.is_complex()
                              else x.double() for x in bank_c))

    # 1. every case against its plain version
    for d, k, t, alpha, n_dead, blocks in WIDE_CIRC_CASES:
        label = (f"D={d}, K={k}, T={t}, alpha={alpha}, dead={n_dead}"
                 + (f", blocks={blocks}" if blocks else ""))
        bank = circ_bank(dev, q, d, k, n_dead, blocks)
        n = WIDE_CIRC_N // t * t
        r = common.observations(dev, q, n, n_ant=d)
        x2 = ck._x2(r)
        ckbs = ck.lowered(bank, None, blocks, t, alpha)
        worst = 0.0
        for stats in (False, True) if len(ckbs) == 1 else (True,):
            states, want_states, exact_states = [], [], []
            for j, ckb in enumerate(ckbs):
                wname = route_name(d, t, stats, blocks, ckb.const.shape[0])
                got = kernel(ckb, x2, t, alpha, stats)
                want = plain(ckb, x2, t, alpha, stats, blocks)
                want64 = plain(f64(ckb), x2.double(), t, alpha, stats, blocks)
                for part, g, w, w64 in zip(("m", "den", "acc") if stats
                                           else ("out",), got, want, want64):
                    errs[wname].append(held(
                        wname, f"{label}, shard {j} {part}",
                        g.reshape(n, -1), w.reshape(n, -1),
                        w64.reshape(n, -1)))
                    worst = max(worst, errs[wname][-1]
                                / float(w.abs().max()))
                states.append(got)
                want_states.append(want)
                exact_states.append(want64)
            if len(ckbs) > 1:       # the shards merged, as the entry does
                held(wname, f"{label}, {len(ckbs)} shards merged",
                          quotient(states), quotient(want_states),
                          quotient(exact_states))
                entry = (ck.estimate_fused_circulant_coherent(
                    bank, r.reshape(-1, t, d), alpha, blocks) if t > 1
                    else ck.estimate_fused_circulant(bank, r, blocks))
                compare(f"{wname}, the entry", label,
                        ck._x2(sb.unitary_ifft(ck._hc(
                            quotient(states), torch.complex64), blocks)),
                        ck._x2(entry.reshape(n, d)), tol=1e-5)
        rec["cases"][label] = {"max_rel_err": worst}
        del bank, r, x2, ckbs

    # the float64 rule at D = 512 and 672
    for d in WIDE_CIRC_F64_D:
        bank = circ_bank(dev, q, d, 16, 2)
        r = common.observations(dev, q, WIDE_CIRC_N // 4 * 4, n_ant=d)
        x2 = ck._x2(r)
        for t, stats in ((1, False), (4, False), (1, True), (4, True)):
            wname = route_name(d, t, stats, None, 16)
            ckb = ck.circ_kernel_bank(bank, None, t, 1.0)
            got = kernel(ckb, x2, t, 1.0, stats)
            want = plain(ckb, x2, t, 1.0, stats)
            want64 = plain(f64(ckb), x2.double(), t, 1.0, stats)
            for part, g, w, w64 in zip(("m", "den", "acc") if stats
                                       else ("out",), got, want, want64):
                label = f"D={d}, K=16, T={t}, {part}"
                errs[wname].append(held(wname, label, g, w, w64))
                acc, rule = fp32_accuracy(wname, label, g, w, w64)
                rec["fp32_accuracy"][f"{wname} {label}"] = acc
                if not rule:
                    raise AssertionError(f"{wname} at {label}: the float64 "
                                         "rule does not hold")
        del bank, r, x2

    # 2. the JAX tool's four legs
    tool = circ_kernel_bench.main([], device=dev)
    for leg, routes in tool["legs"].items():
        for label, route in routes.items():
            if "rel_to_fft" in route and not (
                    math.isfinite(route["rel_to_fft"])
                    and route["launches"]):
                raise AssertionError(f"circ_kernel_bench {leg} {label}: "
                                     f"{route}")
    if tool["legs"]["d512"]["fused circ kernel"]["launches"] != {
            "circ_estimate_fact": 1}:
        raise AssertionError(f"the d512 leg launched "
                             f"{tool['legs']['d512']['fused circ kernel']}")
    rec["circ_kernel_bench"] = tool
    # the d512 leg's inputs (and the same at D = 672) against the
    # torch.fft pipeline in float64, K6 and K7 at T = 4: the kernel the
    # entry launches (the factorised one), its float32 plain version, that
    # plain version in float64 on the same float32 layout and the float32
    # pipeline; the kernel at most twice the error of its plain version
    # and of the pipeline
    rec["against_float64_fft"] = {}
    for d_f in (512, 672):
        syn = circ_kernel_bench.synthetic_bank(d_f, 16, device=dev)
        r_syn = circ_kernel_bench.complex_randn((WIDE_CIRC_BATCH, d_f),
                                                device=dev)
        x_syn = ck._x2(r_syn)
        for t in (1, 4):
            rt = r_syn.reshape(-1, t, d_f) if t > 1 else r_syn

            def pipeline(bank_c, r_c, t=t):
                if t > 1:
                    return sb.estimate_circulant_coherent(
                        bank_c, r_c, "all", 4096, 1.0, None, "fft")
                return sb.estimate_circulant(bank_c, r_c, "all", 16384, None,
                                             "fft")

            exact = real_rows(pipeline(c128(syn), rt.to(torch.complex128)))
            ckb_syn = ck.circ_kernel_bank(syn, None, t, 1.0)
            entry = (ck.estimate_fused_circulant_coherent(syn, rt, 1.0)
                     if t > 1 else ck.estimate_fused_circulant(syn, rt))
            scale = float(exact.abs().max())
            acc_f = {
                label: float((x.double() - exact).abs().max()) / scale
                for label, x in (
                    ("kernel", real_rows(entry)),
                    ("plain", ck.circ_fact_reference(x_syn, ckb_syn, t)),
                    ("plain_float64_layout_float32", ck.circ_fact_reference(
                        x_syn.double(), f64(ckb_syn), t)),
                    ("fft", real_rows(pipeline(syn, rt))))}
            key = f"D={d_f}, K=16, T={t}"
            rec["against_float64_fft"][key] = acc_f
            log(f"circ_kernel_bench inputs at {key} against the torch.fft "
                "pipeline in float64 (fractions of scale): " + ", ".join(
                    f"{k2} {v:.3e}" for k2, v in acc_f.items()))
            if not acc_f["kernel"] <= 2 * min(acc_f["plain"], acc_f["fft"]):
                raise AssertionError(f"the factorised K6 / K7 at {key} less "
                                     f"accurate than its plain version or "
                                     f"the torch.fft pipeline: {acc_f}")
        del syn, r_syn, x_syn, exact, entry
    rec["d512_against_float64_fft"] = rec["against_float64_fft"][
        "D=512, K=16, T=1"]
    # the layout's own floor by the construction of its DFT matrix, at the
    # narrow template's widths and at D = 512
    rec["dft_construction"] = {
        d_c: circ_kernel_bench.dft_construction_error(d_c, device=dev)
        for d_c in (64, 128, 512)}
    log("the layout in float64 against the float64 torch.fft pipeline, by "
        "the DFT matrix's construction (fractions of scale): " + "; ".join(
            f"D={d_c} " + ", ".join(f"{k2} {v:.3e}" for k2, v in e.items())
            for d_c, e in rec["dft_construction"].items()))

    # 3. the main paths
    def counted(label, fn, want_kernels):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tm = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.time() - tm
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        add(launches)
        log(f"wide circulant path {label}: {seconds:.1f}s, launches "
            f"{launches}")
        if set(launches) != want_kernels:
            raise AssertionError(f"wide circulant path {label} launched "
                                 f"{launches}; it must launch {want_kernels}")
        return out, launches, seconds

    rec["paths"] = {}
    for label, change, want_kernels in (
            ("run_gmm D=512, K=16, circulant", {}, {"circ_estimate_fact"}),
            ("run_gmm D=512, K=16, circulant, T=4",
             dict(n_coherence=4, coherence_alpha=1.0),
             {"circ_estimate_fact", "circ_estimate_coherent_fact"})):
        with tempfile.TemporaryDirectory() as tmp:
            cfg, mse, _, timings, seconds, launches = main_path_run(
                run_gmm, kernels, dev, tmp, use_cache=True, **WIDE_CIRC_FIT,
                **change)
            launches = {k: v for k, v in launches.items() if v}
            add(launches)
            rel_fft = None
            if not change:
                # the flat run on the saved fit through the torch.fft
                # pipeline (the coherent kernel is held against it by the
                # service and the float64 checks above)
                circ_method = stages._circ_method
                stages._circ_method = lambda method, mode, bank, t=1: "fft"
                try:
                    mse_fft = main_path_run(run_gmm, kernels, dev, tmp,
                                            use_cache=True,
                                            **WIDE_CIRC_FIT)[1]
                finally:
                    stages._circ_method = circ_method
                rel_fft = max(abs(m - f) / f for m, f in zip(
                    mse["blmmse_gmm"], mse_fft["blmmse_gmm"]))
                log(f"{label}: NMSE through the kernels against the "
                    f"torch.fft pipeline on the same fit, largest relative "
                    f"difference {rel_fft:.3e}")
                if not rel_fft <= TOL:
                    raise AssertionError(f"{label}: NMSE {rel_fft:.3e} from "
                                         f"the torch.fft pipeline's")
        if set(launches) != want_kernels or any(
                v < len(cfg.snrs) for v in launches.values()):
            raise AssertionError(f"{label} launched {launches}")
        cols = ["blmmse_gmm"] + (["blmmse_gmm_coh"] if change else [])
        for i, snr in enumerate(cfg.snrs):
            for col in cols:
                if not (mse["blmmse_genie"][i] < mse[col][i]
                        < mse["LS_glob"][i]):
                    raise AssertionError(
                        f"{label}: genie < {col} < LS broken at {snr} dB: "
                        f"{mse['blmmse_genie'][i]}, {mse[col][i]}, "
                        f"{mse['LS_glob'][i]}")
        log(f"{label}: " + "; ".join(f"{k} {['%.4f' % v for v in vals]}"
                                     for k, vals in mse.items())
            + f"; fit {timings['gmm_fit']:.1f}s of {seconds:.1f}s")
        rec["paths"][label] = {"mse": mse, "launches": launches,
                               "seconds": seconds,
                               "gmm_fit_s": timings["gmm_fit"],
                               "nmse_rel_to_fft": rel_fft}

    # the structured service on a D = 512 prior against a torch.fft
    # service, and the sharded estimator over a 1 x 2 in-process mesh.
    # Where the kernels and the float32 pipeline part by more than TOL (both
    # round logits in the hundreds to float32), both are held against the
    # kernels' plain version in float64 on the bank's layout (`compare64`'s
    # rule)
    d, k = WIDE_CIRC_DK
    params, spectra = circ_prior(dev, d, k, n_dead=1)
    w_np, means_np, spec_np = (x.cpu().numpy() for x in
                               (params.weights, params.means, spectra))
    a_eye = np.eye(d, dtype=np.complex64)
    banks = {snr: sb.prepare_bank_circulant(
        params, snr, torch.as_tensor(a_eye, device=dev), N_BITS,
        Q.design_quantizer(snr, N_BITS, device=dev), spectra=spectra)
        for snr in (*SERVE_SNRS, SNR)}
    bank = banks[SNR]

    def fft_reference(rt, bank_c=bank):
        if rt.dim() == 3:
            return sb.estimate_circulant_coherent(bank_c, rt, "all", 4096,
                                                  1.0, None, "fft")
        return sb.estimate_circulant(bank_c, rt, "all", 16384, None, "fft")

    def plain64(rt, snr=SNR, fact=False):
        """The kernels' plain version in float64 on the float32 layout of
        the bank at `snr`, complex (n, D) or blocks (B, T, D): with `fact`
        the factorised kernel's (`circ_fact_reference`: its tables exact
        in float64), else the wide form's."""
        t = rt.shape[1] if rt.dim() == 3 else 1
        x = torch.view_as_real(rt.to(torch.complex128).contiguous()).reshape(
            -1, 2 * d)
        lay = f64(ck.circ_kernel_bank(banks[snr], None, t, 1.0))
        out = (ck.circ_fact_reference(x, lay, t) if fact
               else ck._circ_reference(x, lay, t, 1.0, False, 16384))
        return torch.view_as_complex(out.reshape(-1, d, 2)).reshape(
            rt.shape)

    def fact64(rt, snr=SNR):
        return plain64(rt, snr, fact=True)

    def fact64_np(r_np, snr):
        return fact64(torch.as_tensor(r_np, device=dev), snr).cpu().numpy()

    svc, fft_svc, mesh_svc = (
        serving.EstimationService.from_circulant_spectra(
            w_np, means_np, spec_np, a_eye, N_BITS, max_batch=SERVE_MAX_BATCH,
            device=dev, use_kernels=use, mesh=mesh)
        for use, mesh in ((True, None), (False, None),
                          (True, pmesh.make_local_mesh(1, 2))))
    try:
        rec["service"] = []
        # one device: the factorised K6 / K7; over a 1 x 2 in-process mesh
        # the factorised K8 / K9 on each component shard, merged
        for service, label, t_coh, name in (
                (svc, "structured D=512 flat all", 1, "circ_estimate_fact"),
                (svc, "structured D=512 T=4 blocks, alpha=1", 4,
                 "circ_estimate_coherent_fact"),
                (mesh_svc, "structured D=512 flat all, 1 x 2 mesh", 1,
                 "circ_estimate_stats_fact"),
                (mesh_svc, "structured D=512 T=4 blocks, alpha=1, 1 x 2 mesh",
                 4, "circ_estimate_coherent_stats_fact")):
            rec["service"].append(serve_mode(
                service, kernels, dev, label, t_coh, name, fact64,
                seconds=1.0, same_as=fft_svc, d=d, same_as_exact=fact64_np))
            add(rec["service"][-1]["launches"])
            log(f"serving [{label}]: answers further than {TOL} from the "
                f"torch.fft service's: {rec['service'][-1]['answers_past_tol']}"
                f" (largest {rec['service'][-1]['max_rel_to_same_as']:.3e} "
                "of scale), each held against the float64 plain version")
            used = {k2 for k2, v in rec["service"][-1]["launches"].items()
                    if v}
            if used != {name}:
                raise AssertionError(f"{label} launched {used}")
    finally:
        for service in (svc, fft_svc, mesh_svc):
            service.close(timeout=120.0)
    r = common.observations(dev, q, 8192, n_ant=d)
    for label, rr, want_kernels in (
            ("estimate_sharded_circulant, 1 x 2 mesh", r,
             {"circ_estimate_stats_fact"}),
            ("estimate_sharded_circulant, 1 x 2 mesh, T=4",
             r.reshape(-1, 4, d), {"circ_estimate_coherent_stats_fact"})):
        got, launches, seconds = counted(
            label, lambda x=rr: pmesh.estimate_sharded_circulant(
                pmesh.make_local_mesh(1, 2), bank, x), want_kernels)
        want = fft_reference(rr)
        rel = held(label, "against the torch.fft pipeline", real_rows(got),
                   real_rows(want), real_rows(plain64(rr))) / float(
                       want.abs().max())
        rec["paths"][label] = {"rel_to_fft": rel, "launches": launches,
                               "seconds": seconds}
    del r, bank, banks
    # the dense wide K6-K9's main paths: the stages' entries and the
    # sharded estimator over a 1 x 2 in-process mesh at a width the
    # factorised kernel does not split, against the torch.fft pipeline
    # under the same rule
    d_w = WIDE_CIRC_DENSE_D
    bank_w = circ_bank(dev, q, d_w, k, 2)
    r_w = common.observations(dev, q, 8192, n_ant=d_w)
    for label, rr, want_kernels, fn in (
            (f"stages.estimate_circulant D={d_w}", r_w,
             {"circ_estimate_wide"}, stages.estimate_circulant),
            (f"stages.estimate_circulant_coherent D={d_w}, T=4",
             r_w.reshape(-1, 4, d_w), {"circ_estimate_coherent_wide"},
             stages.estimate_circulant_coherent),
            (f"estimate_sharded_circulant D={d_w}, 1 x 2 mesh", r_w,
             {"circ_estimate_stats_wide"},
             lambda b, x: pmesh.estimate_sharded_circulant(
                 pmesh.make_local_mesh(1, 2), b, x)),
            (f"estimate_sharded_circulant D={d_w}, 1 x 2 mesh, T=4",
             r_w.reshape(-1, 4, d_w), {"circ_estimate_coherent_stats_wide"},
             lambda b, x: pmesh.estimate_sharded_circulant(
                 pmesh.make_local_mesh(1, 2), b, x))):
        t = rr.shape[1] if rr.dim() == 3 else 1
        got, launches, seconds = counted(
            label, lambda x=rr, fn=fn: fn(bank_w, x), want_kernels)
        want = (sb.estimate_circulant_coherent(bank_w, rr, "all", 4096, 1.0,
                                               None, "fft") if t > 1
                else sb.estimate_circulant(bank_w, rr, "all", 16384, None,
                                           "fft"))
        want64 = ck._circ_reference(
            real_rows(rr.to(torch.complex128)),
            f64(ck.circ_kernel_bank(bank_w, None, t, 1.0)), t, 1.0, False,
            16384)
        rel = held(label, "against the torch.fft pipeline", real_rows(got),
                   real_rows(want), want64) / float(want.abs().max())
        rec["paths"][label] = {"rel_to_fft": rel, "launches": launches,
                               "seconds": seconds}
    del bank_w, r_w
    f64_rec = rec["against_float64"].values()
    ruled = [v for v in f64_rec if v["float64_rule"]]
    log(f"wide circulant comparisons: {len(f64_rec)}, {len(ruled)} decided "
        f"by the float64 rule (plain float32 version past {TOL}: largest "
        f"{max((v['rel_to_plain'] for v in ruled), default=0.0):.3e} of "
        f"scale); the kernels' largest distance from the float64 plain "
        f"version {max(v['kernel_to_f64'] for v in f64_rec):.3e} of scale, "
        f"the float32 plain version's "
        f"{max(v['plain_to_f64'] for v in f64_rec):.3e}")

    # 4. repeated launches
    tm = time.time()
    rep = trc.repeat_check(dev, repeats=20,
                           modes=("wide_circ", "fact_circ"))["kernel"]
    bad = {k2: v for k2, v in rep.items() if v["failures"]}
    log(f"wide and factorised K6-K9 repeated: "
        f"{sum(v['launches'] for v in rep.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"the wide or factorised K6-K9 off on repeated "
                             f"launches: {bad}")
    rec["repeat_check"] = rep

    # 5. times at D = 512, K = 16, 32768 rows
    n = WIDE_CIRC_BATCH
    bank = circ_bank(dev, q, d, k, 2)
    r = common.observations(dev, q, n, n_ant=d)
    rb = r.reshape(-1, 4, d)
    x2 = ck._x2(r)
    ckb, ckb4 = ck.circ_kernel_bank(bank), ck.circ_kernel_bank(bank, None,
                                                                 4, 1.0)
    ops, ops_s = ck.circ_wide_operands(ckb), ck.circ_wide_operands(ckb, True)
    fops = ck.circ_fact_operands(ckb)
    times = {}
    for name, t, stats, kern, library, chunked in (
            # the factorised K6-K9 (the wrappers' route at D = 512) and, in
            # the same call, the dense wide form they replace there
            ("circ_estimate_fact", 1, False,
             lambda: ck.circ_estimate(x2, ckb, fops),
             lambda: sb.estimate_circulant(bank, r, "all", n, None, "fft"),
             lambda: sb.estimate_circulant(bank, r, "all", 16384, None,
                                           "fft")),
            ("circ_estimate_coherent_fact", 4, False,
             lambda: ck.circ_estimate_coherent(x2, ckb4, 4, 1.0, fops),
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", n // 4,
                                                    1.0, None, "fft"),
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", 4096,
                                                    1.0, None, "fft")),
            ("circ_estimate_wide", 1, False,
             lambda: ck.circ_estimate_wide(x2, ckb, ops),
             lambda: sb.estimate_circulant(bank, r, "all", n, None, "fft"),
             lambda: sb.estimate_circulant(bank, r, "all", 16384, None,
                                           "fft")),
            ("circ_estimate_coherent_wide", 4, False,
             lambda: ck.circ_estimate_coherent_wide(x2, ckb4, 4, 1.0, ops),
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", n // 4,
                                                    1.0, None, "fft"),
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", 4096,
                                                    1.0, None, "fft")),
            ("circ_estimate_stats_fact", 1, True,
             lambda: ck.circ_estimate_stats(x2, ckb, fops),
             lambda: sb.estimate_circulant_stats(bank, r, n, None, "fft"),
             lambda: sb.estimate_circulant_stats(bank, r, 16384, None,
                                                 "fft")),
            ("circ_estimate_coherent_stats_fact", 4, True,
             lambda: ck.circ_estimate_coherent_stats(x2, ckb4, 4, 1.0, fops),
             lambda: sb.estimate_circulant_coherent_stats(bank, rb, n // 4,
                                                          1.0, None, "fft"),
             lambda: sb.estimate_circulant_coherent_stats(bank, rb, 4096,
                                                          1.0, None,
                                                          "fft")),
            ("circ_estimate_stats_wide", 1, True,
             lambda: ck.circ_estimate_stats_wide(x2, ckb, ops_s),
             lambda: sb.estimate_circulant_stats(bank, r, n, None, "fft"),
             lambda: sb.estimate_circulant_stats(bank, r, 16384, None,
                                                 "fft")),
            ("circ_estimate_coherent_stats_wide", 4, True,
             lambda: ck.circ_estimate_coherent_stats_wide(x2, ckb4, 4, 1.0,
                                                          ops_s),
             lambda: sb.estimate_circulant_coherent_stats(bank, rb, n // 4,
                                                          1.0, None, "fft"),
             lambda: sb.estimate_circulant_coherent_stats(bank, rb, 4096,
                                                          1.0, None,
                                                          "fft"))):
        c = ckb4 if t > 1 else ckb
        plain_fn = (lambda c=c, t=t, stats=stats:
                    ck._circ_reference(x2, c, t, 1.0, stats, 16384))
        if name in FACT_CIRC_NAMES.values():
            plain_fn = (lambda c=c, t=t, stats=stats:
                        ck.circ_fact_reference(x2, c, t, stats=stats))
        plain_ms = profiling.device_ms(plain_fn)
        ms = profiling.device_ms(kern)
        ms2 = profiling.device_ms(kern)
        plain_ms2 = profiling.device_ms(plain_fn)
        library_ms = profiling.device_ms(library)
        chunked_ms = profiling.device_ms(chunked)
        b = ck.circ_bound(n, d, k, t, stats)
        times[name] = {"ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
                       "plain_ms_again": plain_ms2, **b,
                       "library_ms": library_ms,
                       "library_chunked_ms": chunked_ms,
                       "share_of_bound": b["bound_ms"] / ms,
                       "share_of_bound_dft": b["bound_dft_ms"] / ms}
        log(f"{name} at N={n}, D={d}, K={k}" + (", T=4" if t > 1 else "")
            + f": kernel {ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} / "
            f"{plain_ms2:.3f} ms, library (torch.fft pipeline, one chunk) "
            f"{library_ms:.3f} ms (default chunks {chunked_ms:.3f}), bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}; "
            f"{b['bound_ms'] / ms:.1%} reached), with the kernels' dense "
            f"transforms {b['bound_dft_ms']:.3f} ms "
            f"({b['bound_dft_ms'] / ms:.0%}), {n / (ms * 1e-3):.4g} "
            f"estimates/s; {card}")
    rec["times"] = times
    del bank, r, rb, x2, ckb, ckb4, ops, ops_s, fops

    # the factorised K6 / K7 at the rule's edge, D = 672 = 24 x 28, beside
    # the one-chunk pipeline; and one record of the narrow headline (D = 64
    # = 8 x 8, K = 64, 131072 rows), the factorised kernel beside the
    # narrow K6 template in one call (no dispatch changes there)
    rec["times_d672"] = {}
    d7 = 672
    bank = circ_bank(dev, q, d7, k, 2)
    r = common.observations(dev, q, n, n_ant=d7)
    x2 = ck._x2(r)
    for name, t in (("circ_estimate_fact", 1),
                    ("circ_estimate_coherent_fact", 4)):
        c = ck.circ_kernel_bank(bank, None, t, 1.0)
        fops = ck.circ_fact_operands(c)
        rt = r.reshape(-1, t, d7)
        kern = (lambda c=c, t=t, fops=fops:
                ck.circ_estimate_coherent(x2, c, t, 1.0, fops) if t > 1
                else ck.circ_estimate(x2, c, fops))
        library = (lambda rt=rt, t=t: sb.estimate_circulant_coherent(
            bank, rt, "all", n // t, 1.0, None, "fft") if t > 1
            else sb.estimate_circulant(bank, r, "all", n, None, "fft"))
        ms = profiling.device_ms(kern)
        library_ms = profiling.device_ms(library)
        b = ck.circ_bound(n, d7, k, t)
        rec["times_d672"][name] = {"ms": ms, "library_ms": library_ms,
                                   "bound_ms": b["bound_ms"],
                                   "share_of_bound": b["bound_ms"] / ms}
        log(f"{name} at N={n}, D={d7}, K={k}" + (", T=4" if t > 1 else "")
            + f": kernel {ms:.3f} ms, library (torch.fft pipeline, one "
            f"chunk) {library_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
            f"({b['bound_ms'] / ms:.1%} reached); {card}")
    del bank, r, x2
    n64 = 131072
    bank = circ_bank(dev, q, 64, 64, 2)
    r = common.observations(dev, q, n64, n_ant=64)
    x2 = ck._x2(r)
    cache = {}
    c = ck.lowered(bank, cache)[0]
    fops, tops = ck.circ_fact_operands(c), ck.lowered_tc(bank, cache)[0]
    narrow = {}
    for label, fn in (("fact", lambda: ck.circ_estimate_fact(x2, c, fops)),
                      ("template", lambda: ck.circ_estimate(x2, c, tops)),
                      ("template_again",
                       lambda: ck.circ_estimate(x2, c, tops)),
                      ("fact_again",
                       lambda: ck.circ_estimate_fact(x2, c, fops))):
        narrow[f"{label}_ms"] = profiling.device_ms(fn)
    want = ck.circ_fact_reference(x2, c)
    narrow["fact_rel_to_plain"] = float(
        (ck.circ_estimate_fact(x2, c, fops) - want).abs().max()
        / want.abs().max())
    narrow["bound_ms"] = ck.circ_bound(n64, 64, 64)["bound_ms"]
    rec["narrow_headline"] = narrow
    log(f"the narrow headline (D = 64 = 8 x 8, K = 64, {n64} rows): the "
        f"factorised kernel {narrow['fact_ms']:.3f} / "
        f"{narrow['fact_again_ms']:.3f} ms, the narrow K6 template "
        f"{narrow['template_ms']:.3f} / {narrow['template_again_ms']:.3f} "
        f"ms, bound {narrow['bound_ms']:.3f} ms; the factorised kernel "
        f"{narrow['fact_rel_to_plain']:.2e} of scale from its plain "
        f"version; {card}")
    if not narrow["fact_rel_to_plain"] <= TOL:
        raise AssertionError(f"the factorised kernel at D = 64: {narrow}")
    del bank, r, x2, cache
    rec["seconds"] = time.time() - t_phase
    log(f"wide circulant phase 3l: {rec['seconds']:.1f}s")
    return rec


# phase 3m: the multi-pilot circulant kernel K10 on wide banks. Cases (D,
# K, P, T, alpha, dead components, blocks), each past the template's rule:
# D past 128 to the JAX rule's largest (357 at P = 2, 249 at P = 3, 189
# at P = 4), K past 128 to 4096, the pool at T = 4 and 16; the factorised
# kernel takes those whose transform splits and whose tile fits
# (`mp_circ_kernels.mp_circ_route`), the dense wide form the rest (249 = 3
# x 83, K past 128)
WIDE_MP_CASES = (
    (129, 1, 2, 1, 1.0, 0, None),
    (144, 16, 3, 4, 0.25, 1, None),
    (256, 32, 2, 1, 1.0, 2, None),
    (256, 32, 2, 4, 1.0, 2, None),
    (256, 16, 2, 16, 0.25, 1, (16, 16)),
    (336, 64, 2, 1, 1.0, 3, None),
    (357, 1, 2, 4, 1.0, 0, None),
    (249, 1, 3, 16, 1.0, 0, None),
    (189, 8, 4, 1, 1.0, 1, None),
    (64, 256, 2, 1, 1.0, 4, None),
    (64, 1024, 2, 4, 0.25, 8, None),
    (16, 4096, 2, 1, 1.0, 16, None),
)
WIDE_MP_N = 4097        # rows a case: whole T-row blocks below it
WIDE_MP_F64_D = (256, 336)  # widths under the float64 rule
# (D, K) of the service and the times, and the rows of the times: the
# scale bench's D = 256, K = 32 at the JAX `tools/mp_kernel_bench.py`'s P =
# 2 and 65536 rows
WIDE_MP_DK, WIDE_MP_BATCH = (256, 32), 65536
WIDE_MP_FIT = dict(n_antennas=256, n_components=32, cov_type="circulant",
                   use_structured_bank=True, n_pilots=2, n_train=60_000,
                   n_val=2_000)
WIDE_MP_NAMES = {False: "mp_circ_estimate_wide",
                 True: "mp_circ_estimate_coherent_wide"}
FACT_MP_NAMES = {False: "mp_circ_estimate_fact",
                 True: "mp_circ_estimate_coherent_fact"}
# (D, K, P) of the dense wide K10's main path, the stages' entries at a width
# the factorised kernel does not split: the JAX rule's widest at P = 3
WIDE_MP_DENSE = (249, 8, 3)


def wide_mp_circ_phase(dev, card, kernels, errs, add):
    """Phase 3m, the multi-pilot circulant kernel K10 on wide banks, past
    the template's rule (D or K past 128, a P whose u does not fit a
    block's shared memory, a T past its live rows): the factorised kernel
    (`csrc/mp_circ_fact_estimate.cu`) where the transform splits, K <= 128
    and its tile fits, and the dense wide form (`mp_circ_wide_launch` in
    `csrc/circ_wide_estimate.cu`) elsewhere (`mp_circ_kernels.
    mp_circ_route`).

    1. At each of WIDE_MP_CASES (seeded multi-pilot circulant banks at 10
       dB, 2 bits, under the P-pilot matrix kron(x, I), their quantized
       observations, 4097 rows or the whole blocks below): K10 on the
       route's kernel (flat, or coherent at T > 1) against that kernel's
       plain version (`mp_circ_fact_reference`, or `mp_circ_wide_reference`)
       within TOL of the scale, or where the two part by more, both against
       the function in float64 on the same layout (`compare64` at ceiling
       TOL; every comparison's readings kept under "against_float64"); the
       entry (`estimate_fused_circulant_mp[_coherent]`) the same bits; at D
       = 256 and 336 the float64 rule (`fp32_accuracy`, against the float32
       plain version `_mp_reference`).
    2. `tools.mp_kernel_bench` at the JAX tool's sizes (D = K = 64: the
       template) and at D = 256, K = 32 (the factorised kernel): both legs,
       the kernel route against the dense bank and the `torch.fft`
       pipeline, every route's rate.
    3. The main paths, each with the launch counts set to 0 just before it
       and read just after: `run_gmm` at D = 256, K = 32, circulant, two
       pilots (`WIDE_MP_FIT`, 7 SNRs) flat and at T = 4 (genie < GMM < LS
       at -10 and -5 dB, the recorded two-pilot deviation; the factorised
       K10, and the factorised coherent K10 for the coherent column,
       launched once an SNR and no other kernel: no dense wide K10); the
       structured service on a D = 256, K = 32 two-pilot prior (8 clients x
       64 snapshots, 1 s, flat and T = 4 blocks), every answer within TOL
       of the scale of the one-shot estimate of the same request
       (`stages.estimate_circulant[_coherent]` on the bank of its SNR); and
       the dense wide K10's own path, `stages.estimate_circulant[
       _coherent]` at D = 249 = 3 x 83, K = 8, P = 3 (`WIDE_MP_DENSE`),
       flat and T = 4, against the `torch.fft` pipeline under `compare64`.
    4. The wide K10 launched 20 times at each shape of
       `tools.tc_repeat_check.WIDE_MPCIRC_SHAPES`, and the factorised K10
       at each of `FACT_MPCIRC_SHAPES`, on NaN-filled outputs, bit for bit
       the first launch.
    5. CUDA-event times at D = 256, K = 32, P = 2, 65536 rows (flat, and
       T = 4 at alpha 1) of the factorised K10 and, in the same call, the
       dense wide form it replaces there, each beside its plain version,
       the bound (`mp_circ_kernels.mp_circ_bound`: the transforms as FFTs;
       and the kernels' dense transforms) and the library yardstick (the
       `torch.fft` pipeline over the batch as one chunk).
    Returns the phase's record; its timing records are the kernels line's
    entries of the two wide wrappers and the two factorised ones."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck, mp_circ_kernels as mk)
    from quantized_channel_estimation_torch.harness import run_gmm, stages
    from quantized_channel_estimation_torch.models import (
        structured_bank as sb)
    from quantized_channel_estimation_torch.ops import pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.tools import (
        mp_kernel_bench, tc_repeat_check as trc)
    from quantized_channel_estimation_torch.utils import profiling
    t_phase = time.time()
    rec = {"cases": {}, "fp32_accuracy": {}, "against_float64": {}}

    def f64(ckb):
        return mk.MpCircKernelBank(*(x.double() for x in ckb))

    def kernel(ckb, x2, t, alpha, ops=None, fact=False):
        if fact:
            return (mk.mp_circ_estimate_coherent_fact(x2, ckb, t, alpha, ops)
                    if t > 1 else mk.mp_circ_estimate_fact(x2, ckb, ops))
        return (mk.mp_circ_estimate_coherent_wide(x2, ckb, t, alpha, ops)
                if t > 1 else mk.mp_circ_estimate_wide(x2, ckb, ops))

    # 1. every case against the plain version of the route's kernel
    rec["routes"] = {}
    for d, k, p, t, alpha, n_dead, blocks in WIDE_MP_CASES:
        label = (f"D={d}, K={k}, P={p}, T={t}, alpha={alpha}, dead={n_dead}"
                 + (f", blocks={blocks}" if blocks else ""))
        route = mk.mp_circ_route(d, k, p, t, blocks)
        if route == "template":
            raise AssertionError(f"phase 3m case {label} is the template's")
        rec["routes"][label] = route
        fact = route == "fact"
        name = (FACT_MP_NAMES if fact else WIDE_MP_NAMES)[t > 1]
        bank, a, q = mp_bank(dev, p, d, k, n_dead=n_dead, blocks=blocks)
        n = WIDE_MP_N // t * t
        r = mp_obs(dev, a, q, n)
        x2 = ck._x2(r)
        ckb = mk.mp_circ_kernel_bank(bank, blocks, t, alpha)
        got = kernel(ckb, x2, t, alpha, fact=fact)
        if fact:
            want = mk.mp_circ_fact_reference(x2, ckb, t, alpha, blocks)
            want64 = mk.mp_circ_fact_reference(x2.double(), f64(ckb), t,
                                               alpha, blocks)
        else:
            want = mk.mp_circ_wide_reference(x2, ckb, t, alpha)
            want64 = mk._mp_reference(x2.double(), f64(ckb), t, alpha, 8192)
        errs[name].append(compare64(name, label, got, want, want64,
                                    ceiling=TOL,
                                    record=rec["against_float64"]))
        entry = (mk.estimate_fused_circulant_mp_coherent(
            bank, r.reshape(-1, t, p * d), alpha, blocks) if t > 1
            else mk.estimate_fused_circulant_mp(bank, r, blocks))
        if not torch.equal(ck._x2(entry.reshape(n, d)), got):
            raise AssertionError(f"{name} at {label}: the entry's bits "
                                 "differ from the wrapper's")
        case = {"max_rel_err": errs[name][-1] / float(want.abs().max())}
        if d in WIDE_MP_F64_D:
            acc, rule = fp32_accuracy(name, label, got, mk._mp_reference(
                x2, ckb, t, alpha, 8192), want64)
            rec["fp32_accuracy"][f"{name} {label}"] = case["fp32"] = acc
            if not rule:
                raise AssertionError(f"{name} at {label}: the float64 rule "
                                     "does not hold")
        rec["cases"][label] = case
        del bank, r, x2, ckb, got, want, want64

    # 2. the JAX tool, at its sizes and at D = 256, K = 32
    rec["mp_kernel_bench"] = {}
    for label, argv, want_names in (
            ("D=64, K=64", [], ("mp_circ_estimate",
                                "mp_circ_estimate_coherent")),
            ("D=256, K=32", ["--d", "256", "--k", "32"],
             ("mp_circ_estimate_fact", "mp_circ_estimate_coherent_fact"))):
        tool = mp_kernel_bench.main(argv, device=dev)
        flat, coh = tool["legs"]["flat"], tool["legs"]["coherent"]
        got_names = (flat["mp kernel"]["launches"],
                     coh["mp coh kernel"]["launches"])
        if tuple(set(g) for g in got_names) != tuple({w}
                                                     for w in want_names):
            raise AssertionError(f"mp_kernel_bench {label} launched "
                                 f"{got_names}")
        for key, v in [("kernel_vs_dense", flat["kernel_vs_dense"])] + [
                (key, v) for key, v in coh.items()
                if key.startswith("kernel_vs_fft")]:
            if not math.isfinite(v["max_rel"]):
                raise AssertionError(f"mp_kernel_bench {label} {key}: {v}")
        rec["mp_kernel_bench"][label] = tool

    # 3. the main paths
    rec["paths"] = {}
    for label, change, want_kernels in (
            ("run_gmm D=256, K=32, circulant, 2 pilots", {},
             {"mp_circ_estimate_fact"}),
            ("run_gmm D=256, K=32, circulant, 2 pilots, T=4",
             dict(n_coherence=4, coherence_alpha=1.0),
             {"mp_circ_estimate_fact", "mp_circ_estimate_coherent_fact"})):
        with tempfile.TemporaryDirectory() as tmp:
            cfg, mse, _, timings, seconds, launches = main_path_run(
                run_gmm, kernels, dev, tmp, falling=False, **WIDE_MP_FIT,
                **change)
        launches = {k2: v for k2, v in launches.items() if v}
        add(launches)
        if set(launches) != want_kernels or any(
                v != len(cfg.snrs) for v in launches.values()):
            raise AssertionError(f"{label} launched {launches}")
        cols = ["blmmse_gmm"] + (["blmmse_gmm_coh"] if change else [])
        for snr in (-10, -5):
            i = list(cfg.snrs).index(snr)
            for col in cols:
                if not (mse["blmmse_genie"][i] < mse[col][i]
                        < mse["LS_glob"][i]):
                    raise AssertionError(
                        f"{label}: genie < {col} < LS broken at {snr} dB: "
                        f"{mse['blmmse_genie'][i]}, {mse[col][i]}, "
                        f"{mse['LS_glob'][i]}")
        log(f"{label}: " + "; ".join(f"{k2} {['%.4f' % v for v in vals]}"
                                     for k2, vals in mse.items())
            + f"; fit {timings['gmm_fit']:.1f}s of {seconds:.1f}s")
        rec["paths"][label] = {"mse": mse, "launches": launches,
                               "seconds": seconds,
                               "gmm_fit_s": timings["gmm_fit"]}

    # the structured service on a D = 256, K = 32 two-pilot prior, each
    # answer held against the one-shot estimate of the same request
    d, k = WIDE_MP_DK
    params, spectra = circ_prior(dev, d, k, n_dead=1)
    w_np, means_np, spec_np = (x.cpu().numpy() for x in
                               (params.weights, params.means, spectra))
    a_mp = pilots.pilot_matrix(d, 2, N_BITS, device=dev)
    banks = {snr: sb.prepare_bank_circulant(
        params, snr, a_mp, N_BITS, Q.design_quantizer(snr, N_BITS,
                                                      device=dev),
        spectra=spectra) for snr in (*SERVE_SNRS, SNR)}

    def one_shot(rt, snr=SNR):
        if rt.dim() == 3:
            return stages.estimate_circulant_coherent(banks[snr], rt)
        return stages.estimate_circulant(banks[snr], rt)

    class OneShot:
        """The one-shot estimate of a request, as a service answers it."""

        @staticmethod
        def submit(r_np, snr, timeout=None):
            return one_shot(torch.as_tensor(r_np, device=dev),
                            snr).cpu().numpy()

    svc = serving.EstimationService.from_circulant_spectra(
        w_np, means_np, spec_np, a_mp.cpu().numpy(), N_BITS,
        max_batch=SERVE_MAX_BATCH, device=dev, use_kernels=True)
    try:
        rec["service"] = []
        for label, t_coh in (("structured 2 pilots D=256 flat all", 1),
                             ("structured 2 pilots D=256 T=4 blocks, "
                              "alpha=1", 4)):
            name = FACT_MP_NAMES[t_coh > 1]
            rec["service"].append(serve_mode(
                svc, kernels, dev, label, t_coh, name, one_shot,
                seconds=1.0, same_as=OneShot, d=d))
            add(rec["service"][-1]["launches"])
            used = {k2 for k2, v in rec["service"][-1]["launches"].items()
                    if v}
            if used != {name}:
                raise AssertionError(f"{label} launched {used}")
    finally:
        svc.close(timeout=120.0)
    del banks, params, spectra

    # the dense wide K10's main path: the stages' entries at a width the
    # factorised kernel does not split, against the torch.fft pipeline
    # under compare64's rule (the function in float64 on the layout)
    d_w, k_w, p_w = WIDE_MP_DENSE
    bank_w, a_w, q_w = mp_bank(dev, p_w, d_w, k_w, n_dead=1)
    r_w = mp_obs(dev, a_w, q_w, 8192)
    for t in (1, 4):
        label = f"stages.estimate_circulant D={d_w}, P={p_w}, K={k_w}, T={t}"
        rt = r_w.reshape(-1, t, p_w * d_w) if t > 1 else r_w
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tm = time.time()
        got = (stages.estimate_circulant_coherent(bank_w, rt) if t > 1
               else stages.estimate_circulant(bank_w, rt))
        torch.cuda.synchronize()
        seconds = time.time() - tm
        launches = {k2: v for k2, v in kernels.launch_counts().items() if v}
        add(launches)
        if launches != {WIDE_MP_NAMES[t > 1]: 1}:
            raise AssertionError(f"{label} launched {launches}")
        want = (sb.estimate_circulant_coherent(bank_w, rt, "all", 2048, 1.0,
                                               None, "fft") if t > 1
                else sb.estimate_circulant(bank_w, rt, "all", 8192, None,
                                           "fft"))
        x64 = torch.view_as_real(r_w.to(torch.complex128)).reshape(
            r_w.shape[0], -1)
        want64 = mk._mp_reference(
            x64, f64(mk.mp_circ_kernel_bank(bank_w, None, t, 1.0)), t, 1.0,
            8192)
        rel = compare64(WIDE_MP_NAMES[t > 1], label, ck._x2(got).float(),
                        ck._x2(want).float(), want64, ceiling=TOL,
                        record=rec["against_float64"]) / float(
                            want.abs().max())
        rec["paths"][label] = {"rel_to_fft": rel, "launches": launches,
                               "seconds": seconds}
        log(f"{label}: {seconds:.2f}s, launches {launches}, "
            f"{rel:.3e} of scale from the torch.fft pipeline")
    del bank_w, r_w

    f64_rec = rec["against_float64"].values()
    ruled = [v for v in f64_rec if v["float64_rule"]]
    log(f"wide K10 comparisons: {len(f64_rec)}, {len(ruled)} decided by "
        f"the float64 rule (plain version past {TOL}: largest "
        f"{max((v['rel_to_plain'] for v in ruled), default=0.0):.3e} of "
        f"scale); the kernel's largest distance from float64 "
        f"{max(v['kernel_to_f64'] for v in f64_rec):.3e} of scale, the "
        f"plain version's {max(v['plain_to_f64'] for v in f64_rec):.3e}")

    # 4. repeated launches
    tm = time.time()
    rep = trc.repeat_check(dev, repeats=20,
                           modes=("wide_mpcirc", "fact_mpcirc"))["kernel"]
    bad = {k2: v for k2, v in rep.items() if v["failures"]}
    log(f"wide and factorised K10 repeated: {sum(v['launches'] for v in rep.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"the wide or factorised K10 off on repeated "
                             f"launches: {bad}")
    rec["repeat_check"] = rep

    # 5. times at D = 256, K = 32, P = 2, 65536 rows
    n = WIDE_MP_BATCH
    bank, a, q = mp_bank(dev, 2, d, k, n_dead=2)
    r = mp_obs(dev, a, q, n)
    rb = r.reshape(-1, 4, r.shape[-1])
    x2 = ck._x2(r)
    ckb, ckb4 = (mk.mp_circ_kernel_bank(bank, None, t, 1.0) for t in (1, 4))
    ops = mk.mp_circ_wide_operands(ckb)      # laid out once
    fops = mk.mp_circ_fact_operands(ckb)
    times = {}
    for name, t, c, library, chunked in (
            # the factorised K10 (the entries' route at D = 256) and, in the
            # same call, the dense wide form it replaces there
            ("mp_circ_estimate_fact", 1, ckb,
             lambda: sb.estimate_circulant(bank, r, "all", n, None, "fft"),
             lambda: sb.estimate_circulant(bank, r, "all", 8192, None,
                                           "fft")),
            ("mp_circ_estimate_coherent_fact", 4, ckb4,
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", n // 4,
                                                    1.0, None, "fft"),
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", 2048,
                                                    1.0, None, "fft")),
            ("mp_circ_estimate_wide", 1, ckb,
             lambda: sb.estimate_circulant(bank, r, "all", n, None, "fft"),
             lambda: sb.estimate_circulant(bank, r, "all", 8192, None,
                                           "fft")),
            ("mp_circ_estimate_coherent_wide", 4, ckb4,
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", n // 4,
                                                    1.0, None, "fft"),
             lambda: sb.estimate_circulant_coherent(bank, rb, "all", 2048,
                                                    1.0, None, "fft"))):
        fact = name in FACT_MP_NAMES.values()
        kern = (lambda c=c, t=t, fact=fact: kernel(
            c, x2, t, 1.0, fops if fact else ops, fact))
        plain_fn = (lambda c=c, t=t: mk.mp_circ_wide_reference(x2, c, t,
                                                               1.0))
        if fact:
            plain_fn = (lambda c=c, t=t: mk.mp_circ_fact_reference(x2, c, t,
                                                                   1.0))
        # the plain versions' six-product walks take ~0.3-0.65 s a call on
        # an H100: one timed call after the warm-up, either side of the
        # kernel's
        plain_ms = profiling.device_ms(plain_fn, reps=1)
        ms = profiling.device_ms(kern)
        ms2 = profiling.device_ms(kern)
        plain_ms2 = profiling.device_ms(plain_fn, reps=1)
        library_ms = profiling.device_ms(library)
        chunked_ms = profiling.device_ms(chunked)
        b = mk.mp_circ_bound(n, d, k, 2, t)
        times[name] = {"ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
                       "plain_ms_again": plain_ms2, **b,
                       "library_ms": library_ms,
                       "library_chunked_ms": chunked_ms,
                       "share_of_bound": b["bound_ms"] / ms,
                       "share_of_bound_dft": b["bound_dft_ms"] / ms}
        log(f"{name} at N={n}, D={d}, K={k}, P=2"
            + (", T=4" if t > 1 else "")
            + f": kernel {ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} / "
            f"{plain_ms2:.3f} ms, library (torch.fft pipeline, one chunk) "
            f"{library_ms:.3f} ms (default chunks {chunked_ms:.3f}), bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}; "
            f"{b['bound_ms'] / ms:.1%} reached), with the kernels' dense "
            f"transforms {b['bound_dft_ms']:.3f} ms "
            f"({b['bound_dft_ms'] / ms:.0%}), {n / (ms * 1e-3):.4g} "
            f"estimates/s; {card}")
    rec["times"] = times
    rec["seconds"] = time.time() - t_phase
    log(f"wide multi-pilot circulant phase 3m: {rec['seconds']:.1f}s")
    return rec


# phase 3n: the factored kernels K11-K13 on wide banks. Cases (D, K, M, T,
# alpha, dead components), each past the template's rule (D <= 128, M <=
# 64): D one and more past 128, M past 64, and the JAX rule's reach (K 39
# at D = 256, M = 16; K 10 at M = 64; K 19 at D = 512; K 2 at D = 2048, M
# = 32; K = 1 at D = 5551, M = 16 and at D = 64, M = 2475)
WIDE_FACT_CASES = (
    (129, 4, 4, 1, 1.0, 1),
    (144, 8, 8, 4, 0.25, 1),
    (144, 8, 8, 16, 1.0, 2),
    (128, 4, 96, 1, 1.0, 1),
    (96, 2, 72, 4, 1.0, 0),
    (256, 39, 16, 1, 1.0, 3),
    (256, 10, 64, 16, 0.25, 2),
    (512, 19, 16, 4, 1.0, 2),
    (2048, 2, 32, 1, 1.0, 0),
    (5551, 1, 16, 1, 1.0, 0),
    (64, 1, 2475, 1, 1.0, 0),
)
WIDE_FACT_N = 4097     # rows a case: whole T-row blocks below it
WIDE_FACT_F64 = ((2048, 32), (5551, 16), (64, 2475),  # (D, M) under the
                 (256, 16), (144, 8))                 # float64 rule
# the slice's path at full width: the JAX docstring's D = 256, K = 32, M =
# 16 (`models/mfa_bank.py:272-276`), with `tools/scale_bench_mfa.py`'s 60k
# / 2k rows; max_iter cut from run_mfa's 100 to that tool's 30
WIDE_FACT_DKM, WIDE_FACT_BATCH = (256, 32, 16), 32768
WIDE_FACT_FIT = dict(n_antennas=256, n_components=32, latent_dim=16,
                     n_train=60_000, n_val=2_000, max_iter=30)
WIDE_FACT_NAMES = {"K11": "fact_estimate_wide",
                   "K12": "fact_estimate_coherent_wide",
                   "K13": "fact_estimate_stats_wide"}
FUSED_FACT_NAMES = {"K11": "fact_estimate_fused",
                    "K12": "fact_estimate_coherent_fused"}


def wide_fact_phase(dev, card, kernels, errs, add):
    """Phase 3n, the factored kernels K11-K13 on wide banks, past the
    template's D <= 128, M <= 64: the wide form (`csrc/fact_wide_estimate.cu`)
    that the entries take, and the fused K11 / K12
    (`csrc/fact_fused_estimate.cu`, 129 <= D <= 256, M <= 16), which only
    its wrappers and `tools.mfa_bank_bench`'s fused leg launch.

    1. At each of WIDE_FACT_CASES (seeded MFA priors, their factored banks
       at 10 dB, 2 bits, under x0 = 1, quantized observations of channels
       drawn from the mixture, 4097 rows or the whole blocks below): the
       wide K11 (T = 1) or K12 against its plain version
       `fact_wide_reference` within TOL of the scale, or where the two part
       by more, both against the function in float64 on the same layout
       (`compare64` at ceiling TOL; every reading kept under
       "against_float64"); where the fused kernel's tile fits, the fused
       K11 or K12 on the same rows against `fact_fused_reference` likewise;
       the entry the same bits as the wide wrapper; at an even K the wide
       K13 on two component shards, each state (m, den, acc) held likewise,
       and the shards merged (`merge_stats`) against the wide K11; at (D,
       M) of WIDE_FACT_F64 the float64 rule (`fp32_accuracy`, against the
       float32 plain version).
    2. `tools.mfa_bank_bench`, the JAX tool's d64 and d512 legs at its
       sizes: the kernel route (the template at d64, the wide form at d512)
       against the pipeline and the dense bank, every route's rate.
    3. The main paths, each with the launch counts set to 0 just before it
       and read just after: `tools.mfa_bank_bench`'s fused leg (D = 256,
       K = 32, M = 16, 32768 rows: the fused K11 / K12 through their
       wrappers, the entries, the wide form and the one-chunk pipeline in
       turns), the path that launches the fused kernel, its entries
       finite; `run_mfa` at D = 256, K = 32, M = 16
       (`WIDE_FACT_FIT`, 7 SNRs) flat and at T = 4 (the wide K11, and the
       wide K12 for the coherent column, launched once an SNR and no other
       kernel); on its fit and validation channels genie < MFA < LS at -10
       and -5 dB, and the factored estimate within TOL of the scale of the
       dense bank's (`mfa_to_gmm`, K1's wide form) at -10 and 10 dB; the
       factored service on a D = 256, K = 32, M = 16 prior (8 clients x 64
       snapshots, 1 s, flat and T = 4 blocks), every answer within TOL of
       the scale of the one-shot estimate of the same request; and
       `parallel.mesh.estimate_sharded_factored` over an in-process 1 x 2
       mesh (the wide K13 a shard, merged) against the wide K11, and the
       fused K11 against the same merge.
    4. The wide K11-K13 and the fused K11 / K12 launched 20 times at each
       shape of `tools.tc_repeat_check.WIDE_FACT_SHAPES` and
       `FUSED_FACT_SHAPES` on NaN-filled outputs, bit for bit the first
       launch.
    5. At D = 256, K = 32, M = 16, 32768 rows, the fused K11 and K12 (T =
       4) under the float64 rule; CUDA-event times there (the fused K11
       and K12 at T = 4, the wide K11, K12 and K13), each beside its
       plain version, the bound (`fact_kernels.fact_bound`) and the library
       yardstick (the `torch.matmul` pipeline over the batch as one chunk,
       and chunked);
       then at the d64 leg's shape (D = 64, K = 64, M = 16, 131072 rows),
       where the entries take the template, the template's K11 against the
       wide K11 on the same rows: within TOL of the scale of each other,
       and both times.
    Returns the phase's record; its timing records are the kernels line's
    entries of the three wide and the two fused wrappers."""
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels as ck, fact_kernels as fk)
    from quantized_channel_estimation_torch.harness import run_mfa, stages
    from quantized_channel_estimation_torch.models import mfa, mfa_bank
    from quantized_channel_estimation_torch.ops import observation, pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    from quantized_channel_estimation_torch.tools import (
        mfa_bank_bench, tc_repeat_check as trc)
    from quantized_channel_estimation_torch.utils import io as qio
    from quantized_channel_estimation_torch.utils import profiling
    t_phase = time.time()
    rec = {"cases": {}, "fp32_accuracy": {}, "against_float64": {}}
    q = Q.design_quantizer(SNR, N_BITS, device=dev)

    def held(name, label, got, want, want64):
        return compare64(name, label, got, want, want64, ceiling=TOL,
                         record=rec["against_float64"])

    def f64(fkb):
        return fk.FactKernelBank(*(x.double() for x in fkb))

    def kernel(fkb, x2, t, alpha, route="wide", ops=None):
        if route == "fused":
            return (fk.fact_estimate_coherent_fused(x2, fkb, t, alpha, ops)
                    if t > 1 else fk.fact_estimate_fused(x2, fkb, ops))
        return (fk.fact_estimate_coherent_wide(x2, fkb, t, alpha, ops)
                if t > 1 else fk.fact_estimate_wide(x2, fkb, ops))

    def quotient(states):
        _, den, acc = ck.merge_stats(*zip(*states))
        return acc / den[:, None]

    # 1. every case against its plain version
    for d, k, m, t, alpha, n_dead in WIDE_FACT_CASES:
        label = f"D={d}, K={k}, M={m}, T={t}, alpha={alpha}, dead={n_dead}"
        if fk.fact_narrow(d, k, m, t):
            raise AssertionError(f"phase 3n case {label} is the template's")
        kid = "K12" if t > 1 else "K11"
        name = WIDE_FACT_NAMES[kid]
        n = WIDE_FACT_N // t * t
        bank, r = mfa_bank_obs(dev, q, n, d=d, k=k, m=m, n_dead=n_dead)
        x2 = ck._x2(r)
        fkb = fk.fact_kernel_bank(bank, t, alpha)
        got = kernel(fkb, x2, t, alpha)
        want = fk.fact_wide_reference(x2, fkb, t, alpha)
        want64 = fk._fact_reference(x2.double(), f64(fkb), t, alpha, False,
                                    8192)
        errs[name].append(held(name, label, got, want, want64))
        if fk.fact_fused_fits(d, m, t):   # the fused kernel on the same rows
            f_name = FUSED_FACT_NAMES[kid]
            errs[f_name].append(held(
                f_name, label, kernel(fkb, x2, t, alpha, "fused"),
                fk.fact_fused_reference(x2, fkb, t, alpha), want64))
        entry = (fk.estimate_fused_factored_coherent(
            bank, r.reshape(-1, t, d), alpha) if t > 1
            else fk.estimate_fused_factored(bank, r))
        if not torch.equal(ck._x2(entry.reshape(n, d)), got):
            raise AssertionError(f"{name} at {label}: the entry's bits "
                                 "differ from the wrapper's")
        case = {"max_rel_err": errs[name][-1] / float(want.abs().max())}
        if (d, m) in WIDE_FACT_F64:
            acc, rule = fp32_accuracy(name, label, got, fk._fact_reference(
                x2, fkb, t, alpha, False, 8192), want64)
            rec["fp32_accuracy"][f"{name} {label}"] = case["fp32"] = acc
            if not rule:
                raise AssertionError(f"{name} at {label}: the float64 rule "
                                     "does not hold")
        if k % 2 == 0:       # K13 on two component shards
            s_name = WIDE_FACT_NAMES["K13"]
            flat = fk.fact_kernel_bank(bank)
            states, want_states, exact_states = [], [], []
            for j in range(2):
                shard = fk.FactKernelBank(*(x[j * k // 2:(j + 1) * k // 2]
                                            for x in flat))
                st = fk.fact_estimate_stats_wide(x2, shard)
                w_st = fk.fact_wide_reference(x2, shard, stats=True)
                e_st = fk._fact_reference(x2.double(), f64(shard), 1, 1.0,
                                          True, 8192)
                for part, g, w, w64 in zip(("m", "den", "acc"), st, w_st,
                                           e_st):
                    errs[s_name].append(held(
                        s_name, f"{label}, shard {j} {part}",
                        g.reshape(n, -1), w.reshape(n, -1),
                        w64.reshape(n, -1)))
                states.append(st)
                want_states.append(w_st)
                exact_states.append(e_st)
            whole = fk.fact_estimate_wide(x2, flat)
            held(s_name, f"{label}, 2 shards merged against the wide K11",
                 quotient(states), whole, quotient(exact_states))
        rec["cases"][label] = case
        del bank, r, x2, fkb, got, want, want64, entry

    # 2. the JAX tool's d64 and d512 legs at its sizes
    tool = mfa_bank_bench.main([], device=dev)
    for leg, want_name in (("d64", "fact_estimate"),
                           ("d512", "fact_estimate_wide")):
        got_leg = tool["legs"][leg]
        if "dense" not in got_leg["nmse"] or "dense_error" in got_leg:
            raise AssertionError(f"mfa_bank_bench {leg}: no dense bank "
                                 f"({got_leg.get('dense_error')})")
        launched = got_leg["routes"]["factored kernel"]["launches"]
        if set(launched) != {want_name}:
            raise AssertionError(f"mfa_bank_bench {leg} launched {launched}")
        deltas = got_leg["nmse_rel_delta"]
        if not (math.isfinite(got_leg["kernel_vs_pipeline"]["max_rel"])
                and max(deltas.values()) <= 1e-3):
            raise AssertionError(f"mfa_bank_bench {leg}: NMSE deltas "
                                 f"{deltas}, kernel against the pipeline "
                                 f"{got_leg['kernel_vs_pipeline']}")
    rec["mfa_bank_bench"] = tool

    # 3. the main paths
    rec["paths"] = {}
    # the bench's fused leg: the path that launches the fused K11 / K12
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fused_leg = mfa_bank_bench.main(["fused"], device=dev)["legs"]["fused"]
    torch.cuda.synchronize()
    launches = {k2: v for k2, v in kernels.launch_counts().items() if v}
    add(launches)
    if not all(launches.get(f_name) for f_name in FUSED_FACT_NAMES.values()):
        raise AssertionError(f"mfa_bank_bench fused launched {launches}")
    for kid, leg in fused_leg.items():
        if not math.isfinite(leg["entry_rel_to_pipeline"]):
            raise AssertionError(f"mfa_bank_bench fused {kid}: the entry "
                                 "is not finite")
    rec["paths"]["mfa_bank_bench fused"] = {"launches": launches,
                                            "legs": fused_leg}
    d, k, m = WIDE_FACT_DKM
    a_f = pilots.pilot_matrix(d, 1, N_BITS, device=dev)
    for label, change, want_kernels in (
            ("run_mfa D=256, K=32, M=16", {}, {"fact_estimate_wide"}),
            ("run_mfa D=256, K=32, M=16, T=4",
             dict(n_coherence=4, coherence_alpha=1.0),
             {"fact_estimate_wide", "fact_estimate_coherent_wide"})):
        with tempfile.TemporaryDirectory() as tmp:
            cfg, mse, _, timings, seconds, launches, fit = mfa_path_run(
                run_mfa, stages, kernels, dev, tmp, **WIDE_FACT_FIT,
                **change)
            data_file, = os.listdir(os.path.join(tmp, "saves"))
            h_all, t_all = qio.load_channels(os.path.join(tmp, "saves",
                                                          data_file))
        launches = {k2: v for k2, v in launches.items() if v}
        add(launches)
        if set(launches) != want_kernels or any(
                v != len(cfg.snrs) for v in launches.values()):
            raise AssertionError(f"{label} launched {launches}")
        path = {"mse": mse, "launches": launches, "seconds": seconds,
                "fit_s": timings["fit"]}
        if not change:
            # genie < MFA < LS, and the factored bank against the dense
            # bank, on the run's fit and validation channels
            h_tr = torch.as_tensor(h_all[:cfg.n_train], device=dev)
            h_val = torch.as_tensor(h_all[cfg.n_train:], device=dev)
            t_val = torch.as_tensor(t_all[cfg.n_train:], device=dev)
            cov = stages.sample_cov(h_tr)
            dense_params = mfa.to_gmm_params(fit, 1e-6)
            path["invariants"], path["rel_to_dense_bank"] = {}, {}
            for snr in (-10.0, -5.0, 10.0):
                q_snr = Q.design_quantizer(snr, N_BITS, device=dev)
                r_val = observation.observe(
                    torch.Generator(dev).manual_seed(3), h_val, snr, a_f,
                    N_BITS, q_snr)
                via_fact = stages.estimate_factored(
                    stages.prepare_bank_factored(fit, snr, a_f, N_BITS,
                                                 q_snr), r_val)
                if snr < 0:
                    nm = {"genie": stages.chunked_genie_nmse(
                              r_val, t_val, h_val, snr, a_f, N_BITS, q_snr),
                          "mfa": stages.nmse(via_fact, h_val),
                          "ls": stages.nmse(stages.ls_global(
                              r_val, cov, snr, a_f, N_BITS, q_snr), h_val)}
                    path["invariants"][str(snr)] = nm
                    if not nm["genie"] < nm["mfa"] < nm["ls"]:
                        raise AssertionError(f"{label}: genie < MFA < LS "
                                             f"broken at {snr} dB: {nm}")
                if snr in (-10.0, 10.0):
                    via_dense = stages.estimate_auto(stages.prepare_bank(
                        dense_params, snr, a_f, N_BITS, q_snr), r_val, "all")
                    torch.cuda.synchronize()
                    rel = float((via_fact - via_dense).abs().max()
                                / via_dense.abs().max())
                    path["rel_to_dense_bank"][str(snr)] = rel
                    log(f"{label}: factored bank (wide K11) vs dense bank "
                        f"of the same fit at {snr} dB, N={r_val.shape[0]}: "
                        f"max rel {rel:.3e} (tol {TOL})")
                    if not rel <= TOL:
                        raise AssertionError(f"{label}: factored bank off "
                                             f"the dense bank at {snr} dB: "
                                             f"{rel:.3e}")
            log(f"{label}: genie < MFA < LS {path['invariants']}")
            del h_tr, h_val, t_val, cov, dense_params
        log(f"{label}: blmmse_mfa {['%.4f' % v for v in mse['blmmse_mfa']]}"
            + (f", blmmse_mfa_coh "
               f"{['%.4f' % v for v in mse['blmmse_mfa_coh']]}"
               if change else "")
            + f"; fit {timings['fit']:.1f}s of {seconds:.1f}s")
        rec["paths"][label] = path
        del h_all, t_all, fit

    # the factored service on a D = 256, K = 32, M = 16 prior, each answer
    # held against the one-shot estimate of the same request
    prior = mfa_prior(dev, d, k, m, n_dead=1)
    x0 = torch.tensor(1.0 + 0.0j)
    banks = {snr: mfa_bank.prepare_bank_factored(
        prior, snr, x0, N_BITS, Q.design_quantizer(snr, N_BITS, device=dev))
        for snr in (*SERVE_SNRS, SNR)}

    def one_shot(rt, snr=SNR):
        if rt.dim() == 3:
            return stages.estimate_factored_coherent(banks[snr], rt)
        return stages.estimate_factored(banks[snr], rt)

    class OneShot:
        """The one-shot estimate of a request, as a service answers it."""

        @staticmethod
        def submit(r_np, snr, timeout=None):
            return one_shot(torch.as_tensor(r_np, device=dev),
                            snr).cpu().numpy()

    svc = serving.EstimationService.from_mfa(
        prior, np.eye(d, dtype=np.complex64), N_BITS,
        max_batch=SERVE_MAX_BATCH, device=dev, use_kernels=True)
    try:
        if not svc.factored:
            raise AssertionError("from_mfa did not take the factored bank")
        rec["service"] = []
        for label, t_coh in (("factored D=256 flat all", 1),
                             ("factored D=256 T=4 blocks, alpha=1", 4)):
            name = WIDE_FACT_NAMES["K12" if t_coh > 1 else "K11"]
            rec["service"].append(serve_mode(
                svc, kernels, dev, label, t_coh, name, one_shot,
                seconds=1.0, same_as=OneShot, d=d))
            add(rec["service"][-1]["launches"])
            used = {k2 for k2, v in rec["service"][-1]["launches"].items()
                    if v}
            if used != {name}:
                raise AssertionError(f"{label} launched {used}")
    finally:
        svc.close(timeout=120.0)

    # the sharded estimator over a 1 x 2 in-process mesh: the wide K13 a
    # shard, merged, against the wide K11, and the fused K11 against it
    bank, r = mfa_bank_obs(dev, q, 8192, d=d, k=k, m=m, n_dead=1)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tm = time.time()
    got = pmesh.estimate_sharded_factored(pmesh.make_local_mesh(1, 2), bank,
                                          r)
    torch.cuda.synchronize()
    seconds = time.time() - tm
    launches = {k2: v for k2, v in kernels.launch_counts().items() if v}
    add(launches)
    if launches != {"fact_estimate_stats_wide": 2}:
        raise AssertionError(f"estimate_sharded_factored launched "
                             f"{launches}")
    fkb = fk.fact_kernel_bank(bank)
    exact = fk._fact_reference(ck._x2(r).double(), f64(fkb), 1, 1.0, False,
                               8192)
    rel = held("fact_estimate_stats_wide", "1 x 2 mesh against the wide K11",
               ck._x2(got), fk.fact_estimate_wide(ck._x2(r), fkb),
               exact) / float(got.abs().max())
    rel_fused = held("fact_estimate_fused",
                     "the fused K11 against the 1 x 2 mesh",
                     fk.fact_estimate_fused(ck._x2(r), fkb), ck._x2(got),
                     exact) / float(got.abs().max())
    rec["paths"]["estimate_sharded_factored, 1 x 2 mesh"] = {
        "rel_to_k11": rel, "fused_k11_rel": rel_fused, "launches": launches,
        "seconds": seconds}
    log(f"estimate_sharded_factored, 1 x 2 mesh: {seconds:.2f}s, launches "
        f"{launches}")
    del banks, prior, bank, r, got

    f64_rec = rec["against_float64"].values()
    ruled = [v for v in f64_rec if v["float64_rule"]]
    log(f"wide K11-K13 and fused K11 / K12 comparisons: {len(f64_rec)}, "
        f"{len(ruled)} decided by "
        f"the float64 rule (plain version past {TOL}: largest "
        f"{max((v['rel_to_plain'] for v in ruled), default=0.0):.3e} of "
        f"scale); the kernels' largest distance from float64 "
        f"{max(v['kernel_to_f64'] for v in f64_rec):.3e} of scale, the "
        f"plain version's {max(v['plain_to_f64'] for v in f64_rec):.3e}")

    # 4. repeated launches
    tm = time.time()
    rep = trc.repeat_check(dev, repeats=20,
                           modes=("wide_fact", "fused_fact"))["kernel"]
    bad = {k2: v for k2, v in rep.items() if v["failures"]}
    log(f"wide K11-K13 and fused K11 / K12 repeated: "
        f"{sum(v['launches'] for v in rep.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"the wide K11-K13 or the fused K11 / K12 off "
                             f"on repeated launches: "
                             f"{bad}")
    rec["repeat_check"] = rep

    # 5. times at D = 256, K = 32, M = 16, 32768 rows
    n = WIDE_FACT_BATCH
    bank, r = mfa_bank_obs(dev, q, n, d=d, k=k, m=m, n_dead=2)
    rb = r.reshape(-1, 4, d)
    x2 = ck._x2(r)
    fkb, fkb4 = fk.fact_kernel_bank(bank), fk.fact_kernel_bank(bank, 4, 1.0)
    ops = fk.fact_wide_operands(fkb)      # laid out once
    fops = fk.fact_fused_operands(fkb)
    times = {}
    for name, t, stats, kern, library, chunked in (
            ("fact_estimate_fused", 1, False,
             lambda: fk.fact_estimate_fused(x2, fkb, fops),
             lambda: mfa_bank.estimate_factored(bank, r, "all", n),
             lambda: mfa_bank.estimate_factored(bank, r)),
            ("fact_estimate_coherent_fused", 4, False,
             lambda: fk.fact_estimate_coherent_fused(x2, fkb4, 4, 1.0, fops),
             lambda: mfa_bank.estimate_factored_coherent(bank, rb, "all",
                                                         n // 4, 1.0),
             lambda: mfa_bank.estimate_factored_coherent(bank, rb)),
            ("fact_estimate_wide", 1, False,
             lambda: fk.fact_estimate_wide(x2, fkb, ops),
             lambda: mfa_bank.estimate_factored(bank, r, "all", n),
             lambda: mfa_bank.estimate_factored(bank, r)),
            ("fact_estimate_coherent_wide", 4, False,
             lambda: fk.fact_estimate_coherent_wide(x2, fkb4, 4, 1.0, ops),
             lambda: mfa_bank.estimate_factored_coherent(bank, rb, "all",
                                                         n // 4, 1.0),
             lambda: mfa_bank.estimate_factored_coherent(bank, rb)),
            ("fact_estimate_stats_wide", 1, True,
             lambda: fk.fact_estimate_stats_wide(x2, fkb, ops),
             lambda: mfa_bank.estimate_factored_stats(bank, r, n),
             lambda: mfa_bank.estimate_factored_stats(bank, r))):
        c = fkb4 if t > 1 else fkb
        if "fused" in name:
            plain_fn = (lambda c=c, t=t:
                        fk.fact_fused_reference(x2, c, t, 1.0))
            label = f"N={n}, D={d}, K={k}, M={m}, T={t}"
            acc, rule = fp32_accuracy(
                name, label, kern(), fk._fact_reference(x2, c, t, 1.0, False,
                                                        8192),
                fk._fact_reference(x2.double(), f64(c), t, 1.0, False, 8192))
            rec["fp32_accuracy"][f"{name} {label}"] = acc
            if not rule:
                raise AssertionError(f"{name} at {label}: the float64 rule "
                                     "does not hold")
        else:
            plain_fn = (lambda c=c, t=t, stats=stats:
                        fk.fact_wide_reference(x2, c, t, 1.0, stats))
        plain_ms = profiling.device_ms(plain_fn, reps=1)
        ms = profiling.device_ms(kern)
        ms2 = profiling.device_ms(kern)
        plain_ms2 = profiling.device_ms(plain_fn, reps=1)
        library_ms = profiling.device_ms(library)
        chunked_ms = profiling.device_ms(chunked)
        b = fk.fact_bound(n, d, k, m, t, stats)
        times[name] = {"ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
                       "plain_ms_again": plain_ms2, **b,
                       "library_ms": library_ms,
                       "library_chunked_ms": chunked_ms,
                       "share_of_bound": b["bound_ms"] / ms}
        log(f"{name} at N={n}, D={d}, K={k}, M={m}"
            + (", T=4" if t > 1 else "")
            + f": kernel {ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} / "
            f"{plain_ms2:.3f} ms, library (torch.matmul pipeline, one chunk) "
            f"{library_ms:.3f} ms (default chunks {chunked_ms:.3f}), bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}; "
            f"{b['bound_ms'] / ms:.1%} reached), {n / (ms * 1e-3):.4g} "
            f"estimates/s; {card}")
    rec["times"] = times

    # the template against the wide form at the d64 leg's shape, where
    # the entries take the template
    n, (d, k, m) = 131072, (64, 64, 16)
    bank, r = mfa_bank_obs(dev, q, n, d=d, k=k, m=m)
    x2, fkb = ck._x2(r), fk.fact_kernel_bank(bank)
    ops_t, ops_w = fk.fact_tc_operands(fkb), fk.fact_wide_operands(fkb)
    narrow = fk.fact_estimate(x2, fkb, ops_t)
    wide = fk.fact_estimate_wide(x2, fkb, ops_w)
    gap = float((wide - narrow).abs().max() / narrow.abs().max())
    if not gap <= TOL:
        raise AssertionError(f"at D={d}, K={k}, M={m} the wide K11 parts "
                             f"from the template by {gap:.3e} of scale")
    ms_t = profiling.device_ms(lambda: fk.fact_estimate(x2, fkb, ops_t))
    ms_w = profiling.device_ms(lambda: fk.fact_estimate_wide(x2, fkb, ops_w))
    ms_w2 = profiling.device_ms(lambda: fk.fact_estimate_wide(x2, fkb,
                                                              ops_w))
    ms_t2 = profiling.device_ms(lambda: fk.fact_estimate(x2, fkb, ops_t))
    b = fk.fact_bound(n, d, k, m)
    rec["template_against_wide"] = {
        "n": n, "d": d, "k": k, "m": m, "template_ms": [ms_t, ms_t2],
        "wide_ms": [ms_w, ms_w2], "wide_rel_to_template": gap, **b}
    log(f"at the d64 leg's shape (N={n}, D={d}, K={k}, M={m}): template "
        f"K11 {ms_t:.3f} / {ms_t2:.3f} ms ({b['bound_ms'] / ms_t:.1%} of "
        f"bound), wide K11 {ms_w:.3f} / {ms_w2:.3f} ms "
        f"({b['bound_ms'] / ms_w:.1%}), bound {b['bound_ms']:.3f} ms; the "
        f"two {gap:.3e} of scale apart; {card}")
    del bank, r, x2, fkb, ops_t, ops_w, narrow, wide
    rec["seconds"] = time.time() - t_phase
    log(f"wide factored phase 3n: {rec['seconds']:.1f}s")
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from quantized_channel_estimation_torch import serving
    from quantized_channel_estimation_torch.estimators import (
        circ_kernels, fact_kernels, kernels, mp_circ_kernels, variant_kernels)
    from quantized_channel_estimation_torch.harness import (
        run_gmm, run_mfa, stages)
    from quantized_channel_estimation_torch.models import (
        gmm_estimator, mfa, mfa_bank, structured_bank)
    from quantized_channel_estimation_torch.ops import observation, pilots
    from quantized_channel_estimation_torch.ops import quantizer as Q
    from quantized_channel_estimation_torch.tools import (
        batch_sweep, common, kernel_bench, kernel_floor_probe,
        kernel_split_bench, tc_repeat_check)
    from quantized_channel_estimation_torch.utils import io as qio
    from quantized_channel_estimation_torch.utils import profiling
    from quantized_channel_estimation_torch.ops.precision import pin_fp32

    t0 = time.time()
    dev = torch.device("cuda", 0)
    pin_fp32()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build every kernel (one nvcc per source, all started together)
    tb = time.time()
    build_logs = kernels.build()
    for name, out in build_logs.items():
        # ptxas's wgmma notes come a line per injected wait: counted here,
        # listed by code in the summary below
        notes = sum("(C75" in line for line in out.splitlines())
        kept = "\n".join(line for line in out.splitlines()
                         if "(C75" not in line)
        log(f"nvcc {name} ({notes} wgmma note lines):\n{kept.strip()}")
    # the sources redesigned for Hopper (the wgmma stream of K1-K3, K15 and
    # K14b; K4 / K5; K14a): registers, spills and shared memory of every
    # instantiation
    for name in ("grouped_estimate", "grouped_wide_estimate", "floor_probe",
                 "grouped_tc_estimate", "grouped_topk", "karatsuba_estimate",
                 "fact_estimate", "mp_circ_estimate"):
        summary = ptxas_summary(build_logs.get(name, ""))
        log(f"ptxas {name} (dynamic shared memory is set per launch): "
            + ("; ".join(summary) if summary else "not rebuilt"))
    # K14a's forms at M, D <= 64 (64-column pieces: <MC,64,XP,WGS>) must
    # not spill
    k14a_rows = [row for row in ptxas_summary(
        build_logs.get("karatsuba_estimate", "")) if row.startswith("<1,64,")]
    if "karatsuba_estimate" in build_logs and (
            len(k14a_rows) != 2
            or not all("spills 0/0 B" in row for row in k14a_rows)):
        raise AssertionError(f"K14a's forms at M, D <= 64 spill: {k14a_rows}")
    # K11-K13 (the factored template on the tensor cores): no instantiation
    # may spill
    fact_rows = ptxas_summary(build_logs.get("fact_estimate", ""))
    if "fact_estimate" in build_logs and (
            not fact_rows
            or not all("spills 0/0 B" in row for row in fact_rows)):
        raise AssertionError(f"K11-K13 instantiations spill: {fact_rows}")
    # K6-K10 (the multi-pilot template on the tensor cores, K10's 28 forms
    # and the 16 STATS forms of K8 / K9): no instantiation may spill
    mp_rows = ptxas_summary(build_logs.get("mp_circ_estimate", ""))
    if "mp_circ_estimate" in build_logs and (
            len(mp_rows) != 44
            or not all("spills 0/0 B" in row for row in mp_rows)):
        raise AssertionError(f"K6-K10 instantiations spill or are missing: "
                             f"{mp_rows}")
    # the wide form of K6-K10 (three product kernels, two row splits, two
    # softmax kernels): no instantiation may spill
    circ_wide_rows = ptxas_summary(build_logs.get("circ_wide_estimate", ""))
    log("ptxas circ_wide_estimate: " + ("; ".join(circ_wide_rows)
                                        if circ_wide_rows else "not rebuilt"))
    if "circ_wide_estimate" in build_logs and (
            len(circ_wide_rows) != 7
            or not all("spills 0/0 B" in row for row in circ_wide_rows)):
        raise AssertionError(f"the wide K6-K10 spill or are missing: "
                             f"{circ_wide_rows}")
    # the factorised K6 / K7 and K10 (one kernel a tile, mma.sync products
    # at 128 registers a thread): registers and spills, recorded
    for name in ("circ_fact_estimate", "mp_circ_fact_estimate"):
        rows = ptxas_summary(build_logs.get(name, ""))
        log(f"ptxas {name}: " + ("; ".join(rows) if rows else "not rebuilt"))
    # the wide form of K11-K13 (two product kernels, three row splits, two
    # softmax kernels, the quadratic terms and the fold): no instantiation
    # may spill
    fact_wide_rows = ptxas_summary(build_logs.get("fact_wide_estimate", ""))
    log("ptxas fact_wide_estimate: " + ("; ".join(fact_wide_rows)
                                        if fact_wide_rows else "not rebuilt"))
    if "fact_wide_estimate" in build_logs and (
            len(fact_wide_rows) != 9
            or not all("spills 0/0 B" in row for row in fact_wide_rows)):
        raise AssertionError(f"the wide K11-K13 spill or are missing: "
                             f"{fact_wide_rows}")
    # the fused K11 / K12 (one kernel a row tile, two consumer warpgroups at
    # 168 registers): registers and spills, recorded
    rows = ptxas_summary(build_logs.get("fact_fused_estimate", ""))
    log("ptxas fact_fused_estimate: " + ("; ".join(rows) if rows
                                         else "not rebuilt"))
    # the wide form of K1-K3: no instantiation may spill
    wide_rows = ptxas_summary(build_logs.get("grouped_wide_estimate", ""))
    if "grouped_wide_estimate" in build_logs and (
            not wide_rows
            or not all("spills 0/0 B" in row for row in wide_rows)):
        raise AssertionError(f"the wide K1-K3 spill: {wide_rows}")
    log(f"build: {time.time() - tb:.1f}s")

    # 2. kernels against their plain versions
    bank, q = common.headline_bank(dev)
    dead_bank = common.headline_bank(dev, n_dead=5)[0]
    kb = kernels.kernel_bank_block(bank)
    r = common.observations(dev, q, N_BENCH)
    r2 = torch.cat([r.real, r.imag], dim=-1).float().contiguous()
    errs = {name: [] for name in kernels.launch_counts()}
    n_val = run_gmm.GmmBenchConfig().n_val     # the main path's batch
    for label, bank_c, rows in (("full", bank, r2),
                                ("main path", bank, r2[:n_val]),
                                ("dead", dead_bank, r2[:8191])):
        kb_c = kernels.kernel_bank_block(bank_c)
        errs["grouped_estimate"].append(compare(
            "grouped_estimate", label, kernels.grouped_estimate(rows, kb_c),
            kernels.grouped_estimate_reference(rows, kb_c)))
    for label, bank_c, t, alpha, rows in (
            [(f"T={t}, alpha={a}", bank, t, a, r2)
             for t in (2, 4, 16) for a in (1.0, 0.25)]
            + [("dead, B=2501", dead_bank, 4, 0.25, r2[:2501 * 4]),
               ("T=3, alpha=0.5", bank, 3, 0.5, r2[:3 * 43690]),
               ("T=64, alpha=1", bank, 64, 1.0, r2)]):
        # T = 2, 4, 16 pooled by shuffles, T = 3 and 64 through shared
        # memory; past T = 16 both float32 versions round the pooled logit
        # apart and are held against the float64 evaluation (as the card
        # tests hold them)
        kb_c = kernels.kernel_bank_block(bank_c, t, alpha)
        got = kernels.grouped_estimate_coherent(rows, kb_c, t, alpha)
        want = kernels.grouped_estimate_coherent_reference(rows, kb_c, t,
                                                           alpha)
        errs["grouped_estimate_coherent"].append(
            compare("grouped_estimate_coherent", label, got, want) if t <= 16
            else compare64("grouped_estimate_coherent", label, got, want,
                           kernels.grouped_estimate_coherent_reference(
                               rows.double(), type(kb_c)(
                                   *(x.double() for x in kb_c)), t, alpha)))
        del got, want
    for label, bank_c, k_sel, rows in (
            [(f"k={k}", bank, k, r2) for k in (1, 2, 4, 8)]
            + [("dead, k=4", dead_bank, 4, r2[:10001])]):
        kb_c = kernels.kernel_bank_block(bank_c)
        errs["grouped_estimate_topk"].append(compare(
            "grouped_estimate_topk", label,
            kernels.grouped_estimate_topk(rows, kb_c, k_sel),
            kernels.grouped_estimate_topk_reference(rows, kb_c, k_sel),
            near_ties(rows, kb_c, k_sel)))

    # 2b. the circulant kernels K6-K9 against their plain versions
    ck = circ_kernels

    def f64(ckb):
        return type(ckb)(*(x.double() for x in ckb))

    def check_circ(label, bank_c, x2, blocks=None, t=1, alpha=1.0):
        """K6 (t = 1) or K7 on rows x2 against the plain version. Returns
        the kernel's output."""
        ckb = ck.circ_kernel_bank(bank_c, blocks, t, alpha)
        if t == 1:
            name, got = "circ_estimate", ck.circ_estimate(x2, ckb)
            want = ck.circ_estimate_reference(x2, ckb)
            want64 = ck.circ_estimate_reference(x2.double(), f64(ckb))
        else:
            name = "circ_estimate_coherent"
            got = ck.circ_estimate_coherent(x2, ckb, t, alpha)
            want = ck.circ_estimate_coherent_reference(x2, ckb, t, alpha)
            want64 = ck.circ_estimate_coherent_reference(
                x2.double(), f64(ckb), t, alpha)
        errs[name].append(compare64(name, label, got, want, want64))
        return got

    def merged(states):
        _, den, acc = ck.merge_stats(*zip(*states))
        return ck._x2(structured_bank.unitary_ifft(
            ck._hc(acc / den[:, None], torch.complex64)))

    def check_stats(label, bank_c, x2, whole=None, t=1, alpha=1.0,
                    merge64=False):
        """K8 (t = 1) or K9 on the two component shards of bank_c: each
        shard's state against the plain stats, and the merged,
        inverse-transformed quotient against `whole`, K6's / K7's output
        over the whole bank (None, for a bank past one launch's 128
        components: the plain states merged likewise; `merge64`: those
        under `compare64`, against the plain states in float64 merged
        likewise)."""
        name = "circ_estimate_stats" if t == 1 \
            else "circ_estimate_coherent_stats"
        half = bank_c.spec_cr.shape[0] // 2
        states, plain, exact = [], [], []
        for lo, hi in ((0, half), (half, 2 * half)):
            shard = type(bank_c)(*(x[lo:hi] for x in bank_c))
            ckb = ck.circ_kernel_bank(shard, None, t, alpha)
            if t == 1:
                got = ck.circ_estimate_stats(x2, ckb)
                want = ck.circ_estimate_stats_reference(x2, ckb)
                want64 = ck.circ_estimate_stats_reference(x2.double(),
                                                          f64(ckb))
            else:
                got = ck.circ_estimate_coherent_stats(x2, ckb, t, alpha)
                want = ck.circ_estimate_coherent_stats_reference(
                    x2, ckb, t, alpha)
                want64 = ck.circ_estimate_coherent_stats_reference(
                    x2.double(), f64(ckb), t, alpha)
            for part, g, w, w64 in zip(("m", "den", "acc"), got, want,
                                       want64):
                errs[name].append(compare64(
                    name, f"{label}, shard {lo}:{hi}, {part}",
                    g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1),
                    w64.reshape(w64.shape[0], -1)))
            states.append(got)
            plain.append(want)
            exact.append(want64)
        if merge64:
            compare64(name, f"{label}, two shards merged",
                      merged(states), merged(plain), merged64(exact))
        else:
            compare(name, f"{label}, two shards merged vs the whole bank",
                    merged(states), merged(plain) if whole is None else whole)

    def merged64(states):
        """Per-row stats states merged in float64 and inverse-transformed
        once: rows of interleaved [re, im] pairs."""
        _, den, acc = ck.merge_stats(*zip(*[[x.double() for x in st]
                                            for st in states]))
        hq = ck._hc(acc / den[:, None], torch.complex128)
        return torch.view_as_real(structured_bank.unitary_ifft(hq)).reshape(
            hq.shape[0], -1)

    def circ_accuracy(label, bank_c, rows, t=4):
        """K6 and K7 (T = t, alpha 1) on the complex rows (N, D) of bank_c,
        and K8 and K9 (T = t) on its two component shards (each shard's m,
        den and accumulator, and the states merged in float64 and
        inverse-transformed once), against their plain versions in float64
        under the float64 rule `fp32_accuracy` (the operands laid out once);
        raises where a kernel breaks the rule. Returns the errors of each."""
        xr = ck._x2(rows)
        x64 = xr.double()

        def held(key, name, got, want, want64, where=""):
            e, ok = fp32_accuracy(name, label + where, got, want, want64)
            if not ok:
                raise AssertionError(f"{key} less accurate than float32 "
                                     f"({label}{where}): {e}")
            return e

        ckb1 = ck.circ_kernel_bank(bank_c)
        ckbt = ck.circ_kernel_bank(bank_c, None, t, 1.0)
        ops_c = ck.circ_tc_operands(ckb1)
        acc = {"K6": held("K6", "circ_estimate",
                          ck.circ_estimate(xr, ckb1, ops_c),
                          ck.circ_estimate_reference(xr, ckb1),
                          ck.circ_estimate_reference(x64, f64(ckb1))),
               "K7": held(
                   "K7", "circ_estimate_coherent",
                   ck.circ_estimate_coherent(xr, ckbt, t, 1.0, ops_c),
                   ck.circ_estimate_coherent_reference(xr, ckbt, t, 1.0),
                   ck.circ_estimate_coherent_reference(x64, f64(ckbt), t,
                                                       1.0), f", T={t}")}
        half = bank_c.spec_cr.shape[0] // 2
        for key, tt in (("K8", 1), ("K9", t)):
            name = ("circ_estimate_stats" if tt == 1
                    else "circ_estimate_coherent_stats")
            states, plain, exact, parts = [], [], [], {}
            for lo, hi in ((0, half), (half, 2 * half)):
                c = ck.circ_kernel_bank(
                    type(bank_c)(*(x[lo:hi] for x in bank_c)), None, tt, 1.0)
                o = ck.circ_tc_operands(c, True)
                if tt == 1:
                    got = ck.circ_estimate_stats(xr, c, o)
                    want = ck.circ_estimate_stats_reference(xr, c)
                    want64 = ck.circ_estimate_stats_reference(x64, f64(c))
                else:
                    got = ck.circ_estimate_coherent_stats(xr, c, tt, 1.0, o)
                    want = ck.circ_estimate_coherent_stats_reference(
                        xr, c, tt, 1.0)
                    want64 = ck.circ_estimate_coherent_stats_reference(
                        x64, f64(c), tt, 1.0)
                for part, g, w, w64 in zip(("m", "den", "acc"), got, want,
                                           want64):
                    parts[f"shard {lo}:{hi} {part}"] = held(
                        key, name, g.reshape(g.shape[0], -1),
                        w.reshape(w.shape[0], -1),
                        w64.reshape(w64.shape[0], -1),
                        f", T={tt}, shard {lo}:{hi}, {part}")
                states.append(got)
                plain.append(want)
                exact.append(want64)
            parts["merged"] = held(key, name, merged64(states),
                                   merged64(plain), merged64(exact),
                                   f", T={tt}, two shards merged")
            acc[key] = parts
        return acc

    cbank = circ_bank(dev, q)
    cdead = circ_bank(dev, q, n_dead=5)
    x2 = ck._x2(r)
    for label, bank_c, rows in (("full", cbank, x2),
                                ("main path", cbank, x2[:n_val]),
                                ("dead", cdead, x2[:8191])):
        whole = check_circ(label, bank_c, rows)
        if label != "main path":
            check_stats(label, bank_c, rows, whole)
    for label, bank_c, t, alpha, rows in (
            [(f"T={t}, alpha={a}", cbank, t, a, x2)
             for t in (2, 4, 16) for a in (1.0, 0.25)]
            + [("dead, B=2501", cdead, 4, 0.25, x2[:2501 * 4])]):
        whole = check_circ(label, bank_c, rows, None, t, alpha)
        if t == 4:
            check_stats(label, bank_c, rows, whole, t, alpha)
    bbank = circ_bank(dev, q, blocks=(8, 8))
    check_circ("blocks=(8, 8)", bbank, x2[:n_val], (8, 8))
    check_circ("blocks=(8, 8), T=4, alpha=0.25", bbank, x2[:n_val], (8, 8),
               4, 0.25)
    for d_w, k_w in ((32, 40), (128, 128)):
        wbank = circ_bank(dev, q, d_w, k_w, n_dead=3)
        rw = common.observations(dev, q, 20001 * 4, d_w)
        xw = ck._x2(rw)
        whole = check_circ(f"D={d_w}, K={k_w}", wbank, xw[:20001])
        check_stats(f"D={d_w}, K={k_w}", wbank, xw[:20001], whole)
        check_circ(f"D={d_w}, K={k_w}, T=4, alpha=0.25", wbank, xw, None, 4,
                   0.25)
    # T = 64 at D = 128, which the fp32 loop K6-K9 replaced did not take:
    # both float32 versions round the pooled logit of 64 rows (the plain
    # version's merged shards lie 2.4e-4 of the scale off the kernel's),
    # so the merge too is held against float64
    check_circ("D=128, K=128, T=64", wbank, xw[:64 * 301], None, 64, 1.0)
    check_stats("D=128, K=128, T=64", wbank, xw[:64 * 301], None, 64, 1.0,
                merge64=True)

    # the float64 rule at the headline (flat, T = 4, two shards) and at
    # D = K = 128 (T = 4)
    circ_acc = {
        "headline": circ_accuracy("headline", cbank, r),
        "D=K=128": circ_accuracy("D=K=128", wbank, rw[:8192])}

    # the shards the K = 256 service gives K8 / K9: 128 components at
    # D = 64 (the widest instantiation of the stats template), on a service
    # microbatch of 512 rows and on the headline batch
    kbank = circ_bank(dev, q, k=K_WIDE, n_dead=5)
    for t, alpha in ((1, 1.0), (4, 1.0), (4, 0.25)):
        for rows in (x2[:512], x2):
            check_stats(f"K={K_WIDE}, T={t}, alpha={alpha}", kbank, rows,
                        None, t, alpha)

    # 2c. the multi-pilot circulant kernel K10 against its plain version
    mk = mp_circ_kernels

    def check_mp(label, p, d=D, k=K, n=N_BENCH, t=1, alpha=1.0, n_bits=N_BITS,
                 n_dead=0, blocks=None):
        """K10 (t = 1) or its coherent form on n rows of a seeded P-pilot
        bank against the plain version."""
        bank_c, a_c, q_c = mp_bank(dev, p, d, k, n_bits, n_dead, blocks)
        xm = ck._x2(mp_obs(dev, a_c, q_c, n, n_bits))
        ckb = mk.mp_circ_kernel_bank(bank_c, blocks, t, alpha)
        label = (f"{label}, P={p}, D={d}, K={k}"
                 + (f", T={t}, alpha={alpha}" if t > 1 else ""))
        if t == 1:
            name, got = "mp_circ_estimate", mk.mp_circ_estimate(xm, ckb)
            want = mk.mp_circ_estimate_reference(xm, ckb)
            want64 = mk.mp_circ_estimate_reference(xm.double(), f64(ckb))
        else:
            name = "mp_circ_estimate_coherent"
            got = mk.mp_circ_estimate_coherent(xm, ckb, t, alpha)
            want = mk.mp_circ_estimate_coherent_reference(xm, ckb, t, alpha)
            want64 = mk.mp_circ_estimate_coherent_reference(
                xm.double(), f64(ckb), t, alpha)
        errs[name].append(compare64(name, label, got, want, want64))

    for p in (2, 3, 4):
        for d_w, k_w in ((16, 8), (24, 40), (D, K)):
            check_mp("dead, ragged", p, d_w, k_w, 10001, n_dead=2)
    check_mp("main path", 2, n=n_val)
    check_mp("1-bit", 2, n=n_val, n_bits=1)
    check_mp("unquantized", 3, n=n_val, n_bits="inf")
    check_mp("blocks=(8, 8)", 2, n=n_val, blocks=(8, 8))
    check_mp("blocks=(8, 8)", 2, n=n_val, t=4, alpha=0.25, blocks=(8, 8))
    check_mp("widest", 4, 128, 128, 20001, n_dead=3)
    check_mp("widest", 4, 128, 128, 32 * 601, 32, 0.25, n_dead=3)
    check_mp("full", 2)
    check_mp("full", 4)
    for t in (2, 4, 16):
        for alpha in (1.0, 0.25):
            check_mp("full", 2, t=t, alpha=alpha)
    check_mp("dead, B=2501", 3, 24, 40, 2501 * 4, 4, 0.25, n_dead=2)
    check_mp("largest T", 2, n=64 * 301, t=64)

    def mp_accuracy(label, bank_c, rows):
        """K10 and its coherent form (T = 4, alpha 1) on the complex rows
        (N, P D) of the multi-pilot bank bank_c against their plain versions
        (`compare64`) and under the float64 rule `fp32_accuracy` (the bank's
        operands laid out once); raises where the kernel breaks the rule.
        Returns the errors of each."""
        xm = ck._x2(rows)
        ckb1 = mk.mp_circ_kernel_bank(bank_c)
        ckb4 = mk.mp_circ_kernel_bank(bank_c, None, 4, 1.0)
        ops_c = mk.mp_circ_tc_operands(ckb1)
        x64 = xm.double()
        runs = {
            "K10": ("mp_circ_estimate", mk.mp_circ_estimate(xm, ckb1, ops_c),
                    mk.mp_circ_estimate_reference(xm, ckb1),
                    mk.mp_circ_estimate_reference(x64, f64(ckb1))),
            "K10 T=4": ("mp_circ_estimate_coherent",
                        mk.mp_circ_estimate_coherent(xm, ckb4, 4, 1.0, ops_c),
                        mk.mp_circ_estimate_coherent_reference(xm, ckb4, 4,
                                                               1.0),
                        mk.mp_circ_estimate_coherent_reference(
                            x64, f64(ckb4), 4, 1.0))}
        acc = {}
        for key, (name, got, want, want64) in runs.items():
            errs[name].append(compare64(name, label, got, want, want64))
            acc[key], held = fp32_accuracy(name, label, got, want, want64)
            if not held:
                raise AssertionError(f"{key} less accurate than float32 "
                                     f"({label}): {acc[key]}")
        return acc

    # the float64 rule at the headline: P = 2 and 4, flat and T = 4
    mp_acc = {}
    for p_h in (2, 4):
        bank_h, a_h, q_h = mp_bank(dev, p_h)
        mp_acc[f"headline P={p_h}"] = mp_accuracy(
            f"headline, P={p_h}", bank_h, mp_obs(dev, a_h, q_h, N_BENCH))

    # 2d. the factored (MFA) kernels K11-K13 against their plain versions
    fk = fact_kernels

    def check_fact(label, bank_c, xf, t=1, alpha=1.0):
        """K11 (t = 1) or K12 on rows xf against the plain version.
        Returns the kernel's output."""
        fkb = fk.fact_kernel_bank(bank_c, t, alpha)
        if t == 1:
            name, got = "fact_estimate", fk.fact_estimate(xf, fkb)
            want = fk.fact_estimate_reference(xf, fkb)
            want64 = fk.fact_estimate_reference(xf.double(), f64(fkb))
        else:
            name = "fact_estimate_coherent"
            got = fk.fact_estimate_coherent(xf, fkb, t, alpha)
            want = fk.fact_estimate_coherent_reference(xf, fkb, t, alpha)
            want64 = fk.fact_estimate_coherent_reference(
                xf.double(), f64(fkb), t, alpha)
        errs[name].append(compare64(name, label, got, want, want64))
        return got

    def check_fact_stats(label, bank_c, xf, whole):
        """K13 on the two component shards of bank_c, each state against
        the plain stats, the merged quotient against `whole` (K11 over the
        whole bank)."""
        half = bank_c.t_mat.shape[0] // 2
        states = []
        for lo, hi in ((0, half), (half, 2 * half)):
            fkb = fk.fact_kernel_bank(type(bank_c)(*(x[lo:hi]
                                                     for x in bank_c)))
            got = fk.fact_estimate_stats(xf, fkb)
            want = fk.fact_estimate_stats_reference(xf, fkb)
            want64 = fk.fact_estimate_stats_reference(xf.double(), f64(fkb))
            for part, g, w, w64 in zip(("m", "den", "acc"), got, want,
                                       want64):
                errs["fact_estimate_stats"].append(compare64(
                    "fact_estimate_stats", f"{label}, shard {lo}:{hi}, {part}",
                    g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1),
                    w64.reshape(w64.shape[0], -1)))
            states.append(got)
        _, den, acc = ck.merge_stats(*zip(*states))
        compare("fact_estimate_stats", f"{label}, two shards merged vs K11",
                acc / den[:, None], whole)

    def fact_accuracy(label, bank_c, xf_c):
        """K11, K12 (T = 4, alpha 1) and K13 (the whole bank as one shard)
        on rows xf_c against their plain versions (TOL, or `compare64`) and
        under the float64 rule `fp32_accuracy` (K13: its un-normalised
        accumulator); raises where a kernel breaks the rule. Returns the
        errors of each."""
        fkb1 = fk.fact_kernel_bank(bank_c)
        fkb4 = fk.fact_kernel_bank(bank_c, 4, 1.0)
        ops_c = fk.fact_tc_operands(fkb1)
        x64 = xf_c.double()
        runs = {
            "K11": ("fact_estimate", fk.fact_estimate(xf_c, fkb1, ops_c),
                    fk.fact_estimate_reference(xf_c, fkb1),
                    fk.fact_estimate_reference(x64, f64(fkb1))),
            "K12 T=4": ("fact_estimate_coherent",
                        fk.fact_estimate_coherent(xf_c, fkb4, 4, 1.0, ops_c),
                        fk.fact_estimate_coherent_reference(xf_c, fkb4, 4,
                                                            1.0),
                        fk.fact_estimate_coherent_reference(x64, f64(fkb4),
                                                            4, 1.0)),
            "K13": ("fact_estimate_stats",
                    fk.fact_estimate_stats(xf_c, fkb1, ops_c)[2],
                    fk.fact_estimate_stats_reference(xf_c, fkb1)[2],
                    fk.fact_estimate_stats_reference(x64, f64(fkb1))[2])}
        acc = {}
        for key, (name, got, want, want64) in runs.items():
            errs[name].append(compare64(name, label, got, want, want64))
            acc[key], held = fp32_accuracy(name, label, got, want, want64)
            if not held:
                raise AssertionError(f"{key} less accurate than float32 "
                                     f"({label}): {acc[key]}")
        return acc

    fbank, r_f = mfa_bank_obs(dev, q, N_BENCH)
    fdead, r_fd = mfa_bank_obs(dev, q, N_BENCH, n_dead=5, zero_mean=False)
    xf, xfd = ck._x2(r_f), ck._x2(r_fd)
    # the float64 rule at the headline: the six-product route keeps
    # float32's accuracy
    fact_acc = {"headline": fact_accuracy("headline", fbank, xf)}
    for label, bank_c, rows in (("zero means", fbank, xf),
                                ("main path", fbank, xf[:n_val]),
                                ("means, dead, ragged", fdead, xfd[:8191])):
        whole = check_fact(label, bank_c, rows)
        if label != "main path":
            check_fact_stats(label, bank_c, rows, whole)
    for label, bank_c, t, alpha, rows in (
            [(f"T=4, alpha={a}", fbank, 4, a, xf) for a in (1.0, 0.25, 0.0)]
            + [("T=16, alpha=1", fbank, 16, 1.0, xf),
               ("means, dead, B=2501", fdead, 4, 0.25, xfd[:2501 * 4]),
               ("largest T", fdead, 64, 1.0, xfd[:64 * 301])]):
        check_fact(label, bank_c, rows, t, alpha)
    for d_w, m_w, k_w in ((D, 6, K), (32, 8, 40)):
        wbank, rw = mfa_bank_obs(dev, q, 20001 * 4, d=d_w, m=m_w, k=k_w,
                                 n_dead=3, zero_mean=False)
        xw = ck._x2(rw)
        label = f"D={d_w}, M={m_w}, K={k_w}"
        whole = check_fact(label, wbank, xw[:20001])
        check_fact_stats(label, wbank, xw[:20001], whole)
        check_fact(label + ", T=4, alpha=0.25", wbank, xw, 4, 0.25)

    # 2e. the split-K kernels of the mesh path: K2 (K1's and K3's
    # un-normalised state) and K5 (K4's candidates), each shard's output
    # against its plain version and the shards merged against one K1 / K3 /
    # K4 launch over the whole bank
    def shards_of(kb_c, parts):
        k_c = kb_c.pw.shape[0] // parts
        return [type(kb_c)(*(x[i * k_c:(i + 1) * k_c] for x in kb_c))
                for i in range(parts)]

    def check_k2(label, kb_c, rows, parts, whole, t=1, alpha=1.0):
        """K2 (t = 1) or its coherent form on `parts` component shards of
        kb_c: each state against the plain version, the merged quotient
        against `whole` (one K1 / K3 launch) to 1e-5 of its scale."""
        if t == 1:
            name = "grouped_estimate_stats"
            launch = kernels.grouped_estimate_stats
            plain, args = kernels.grouped_estimate_stats_reference, ()
        else:
            name = "grouped_estimate_coherent_stats"
            launch = kernels.grouped_estimate_coherent_stats
            plain = kernels.grouped_estimate_coherent_stats_reference
            args = (t, alpha)
        states = []
        for i, shard in enumerate(shards_of(kb_c, parts)):
            got = launch(rows, shard, *args)
            for part, g, w in zip(("m", "den", "acc"), got,
                                  plain(rows, shard, *args)):
                errs[name].append(compare(
                    name, f"{label}, shard {i + 1}/{parts}, {part}",
                    g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)))
            states.append(got)
        _, den, acc = kernels.merge_stats(*zip(*states))
        compare(name, f"{label}, {parts} shards merged vs one launch",
                acc / den[:, None], whole, tol=1e-5)

    def check_k5(label, kb_c, rows, k_sel, parts=2):
        """K5 on `parts` component shards of kb_c: the candidates against
        the plain version (rows with near-ties among the top k + 1 logits
        not compared), and merged with `merge_topk` against one K4 launch
        (rows near a tie at the k-th place not compared)."""
        name = "grouped_estimate_topk_stats"
        cands = []
        for i, shard in enumerate(shards_of(kb_c, parts)):
            l, z = kernels.grouped_estimate_topk_stats(rows, shard, k_sel)
            l_p, z_p = kernels.grouped_estimate_topk_stats_reference(
                rows, shard, k_sel)
            skip = near_order_ties(rows, shard, k_sel)
            # the empty slots of a shard smaller than k: -inf in both, and
            # compared as such
            empty = torch.isinf(l_p)
            if not torch.equal(torch.isinf(l), empty):
                raise AssertionError(f"{name}: -inf slots differ ({label}, "
                                     f"shard {i + 1}/{parts})")
            errs[name].append(compare(name, f"{label}, shard {i + 1}/{parts}"
                                      ", logits", l.masked_fill(empty, 0.0),
                                      l_p.masked_fill(empty, 0.0), skip))
            errs[name].append(compare(
                name, f"{label}, shard {i + 1}/{parts}, estimates",
                z.reshape(z.shape[0], -1), z_p.reshape(z_p.shape[0], -1),
                skip))
            cands.append((l, z))
        compare(name, f"{label}, {parts} shards merged vs one K4 launch",
                kernels.merge_topk(*zip(*cands), k_sel),
                kernels.grouped_estimate_topk(rows, kb_c, k_sel),
                near_ties(rows, kb_c, k_sel))

    one_k1 = kernels.grouped_estimate(r2, kb)
    for parts in (1, 2, 4):
        check_k2("full", kb, r2, parts, one_k1)
    check_k2("dead, ragged", kernels.kernel_bank_block(dead_bank), r2[:8191],
             2, kernels.grouped_estimate(r2[:8191],
                                         kernels.kernel_bank_block(dead_bank)))
    # the 128-component shards of a K = 256 bank (the widest a shard of the
    # served K = 256 prior is); one K1 launch streams all 256
    kb_wide = kernels.kernel_bank_block(
        common.headline_bank(dev, k_comp=K_WIDE)[0])
    check_k2(f"K={K_WIDE}", kb_wide, r2, 2, kernels.grouped_estimate(r2,
                                                                     kb_wide))
    del kb_wide
    for alpha in (1.0, 0.5):
        kb_t = kernels.kernel_bank_block(bank, 4, alpha)
        check_k2(f"T=4, alpha={alpha}", kb_t, r2, 2,
                 kernels.grouped_estimate_coherent(r2, kb_t, 4, alpha), 4,
                 alpha)
    for k_sel in (1, 4, 8):
        check_k5(f"k={k_sel}", kb, r2, k_sel)
    # shards of 4 components: four empty slots of -inf and zeros a row
    check_k5("k=8, 16 shards of 4", kb, r2[:20001], 8, parts=16)
    check_k5("dead, ragged, k=4", kernels.kernel_bank_block(dead_bank),
             r2[:10001], 4)

    # 2f. fault F1: a dense bank past the kernels' widths (129 pilots at
    # D = 8, so 2M = 2064 > 2048) through the stages takes the einsum
    # estimator instead of raising in K1 (2M = 512 takes the wide K1: phase
    # 3j)
    wide_bank = common.headline_bank(dev, n_ant=8, k_comp=8,
                                     n_pilots=129)[0]
    a_f1 = pilots.pilot_matrix(8, 129, N_BITS, device=dev)
    g4 = torch.Generator(device=dev).manual_seed(2)
    from quantized_channel_estimation_torch.ops.cplx import crandn
    r_wide = observation.observe(g4, crandn(g4, (8192, 8)), SNR, a_f1,
                                 N_BITS, q)
    before = kernels.launch_counts()
    want_wide = gmm_estimator.estimate(wide_bank, r_wide, "all")
    f1 = {}
    for label, got in (
            ("stages.estimate_auto", stages.estimate_auto(wide_bank, r_wide,
                                                          "all")),
            ("kernels.estimate_fused_coherent, T=1",
             kernels.estimate_fused_coherent(wide_bank,
                                             r_wide[:, None])[:, 0])):
        torch.cuda.synchronize()
        f1[label] = float((got - want_wide).abs().max()
                          / want_wide.abs().max())
        log(f"F1: {label} on a dense bank with 2M = {2 * r_wide.shape[1]}, "
            f"N={r_wide.shape[0]}: max rel {f1[label]:.3e} against the "
            "einsum estimator (tol 1e-5)")
        if not (f1[label] <= 1e-5 and torch.isfinite(got.abs()).all()):
            raise AssertionError(f"F1: {label} off the einsum estimator")
    if kernels.launch_counts() != before:
        raise AssertionError("F1: a kernel was launched past its widths")
    del wide_bank, r_wide, want_wide

    # 2g. in-process component shards through the entries the mesh path
    # runs on each rank: K8 / K9 and K13 on two shards, merged, against the
    # unsharded K6 / K7 / K11 stages
    def halves_of(bank_c):
        k_c = bank_c[0].shape[0] // 2
        return [type(bank_c)(*(x[lo:lo + k_c] for x in bank_c))
                for lo in (0, k_c)]

    def quotient(states):
        _, den, acc = kernels.merge_stats(*zip(*states))
        return acc / den.reshape(den.shape + (1,) * (acc.dim() - den.dim()))

    rb_c = r.reshape(-1, 4, D)
    in_process = {
        "K8 vs K6": (structured_bank.unitary_ifft(quotient(
            [ck.estimate_fused_circulant_stats(h, r)
             for h in halves_of(cbank)])),
            stages.estimate_circulant(cbank, r)),
        "K9 vs K7 (T=4, alpha=1)": (structured_bank.unitary_ifft(quotient(
            [ck.estimate_fused_circulant_coherent_stats(h, rb_c, 1.0)
             for h in halves_of(cbank)])),
            stages.estimate_circulant_coherent(cbank, rb_c, "all", 1.0)),
        "K13 vs K11": (quotient([fk.estimate_fused_factored_stats(h, r_f)
                                 for h in halves_of(fbank)]),
                       stages.estimate_factored(fbank, r_f)),
    }
    for label, (got, want) in in_process.items():
        compare("two in-process shards", label, ck._x2(got.reshape(-1, D)),
                ck._x2(want.reshape(-1, D)))
    del in_process

    # 3. the main paths, each with its own launch counts
    total_launches = dict.fromkeys(errs, 0)

    def add(counts):
        for name, c in counts.items():
            total_launches[name] += c

    # the default run keeps the fitted banks and observations it estimates
    # (stages.estimate_auto) and the channels it scores against
    # (stages.nmse) for the fitted-bank check below
    fitted_calls, truth = [], []
    estimate_auto, nmse = stages.estimate_auto, stages.nmse

    def keep_estimate(bank_s, r_s, mode):
        fitted_calls.append((bank_s, r_s))
        return estimate_auto(bank_s, r_s, mode)

    def keep_truth(h_est, h):
        truth[:] = [h]
        return nmse(h_est, h)

    stages.estimate_auto, stages.nmse = keep_estimate, keep_truth
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg, mse, rate, timings, main_s, launches = main_path_run(
                run_gmm, kernels, dev, tmp)
            csvs = sorted(os.listdir(os.path.join(tmp, "3gpp")))
    finally:
        stages.estimate_auto, stages.nmse = estimate_auto, nmse
    add(launches)
    i10 = list(cfg.snrs).index(10)
    at10 = {k: v[i10] for k, v in mse.items()}
    if not (at10["blmmse_genie"] < at10["blmmse_gmm"] < at10["blmmse_glob"]
            < at10["LS_glob"]):
        raise AssertionError(f"MSE order at 10 dB broken: {at10}")
    if launches["grouped_estimate"] < len(cfg.snrs):
        raise AssertionError(f"main path launched K1 only "
                             f"{launches['grouped_estimate']} times")
    if len(csvs) != 2:
        raise AssertionError(f"CSV rows missing: {csvs}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg_c, mse_c, rate_c, timings_c, coh_s, launches_c = main_path_run(
            run_gmm, kernels, dev, tmp, n_coherence=4, coherence_alpha=1.0)
    add(launches_c)
    i_low = list(cfg_c.snrs).index(-10)
    if not mse_c["blmmse_gmm_coh"][i_low] < mse_c["blmmse_gmm"][i_low]:
        raise AssertionError(f"coherent column no better at -10 dB: "
                             f"{mse_c['blmmse_gmm_coh'][i_low]} vs "
                             f"{mse_c['blmmse_gmm'][i_low]}")
    if launches_c["grouped_estimate_coherent"] < len(cfg_c.snrs):
        raise AssertionError(f"coherent run launched K3 only "
                             f"{launches_c['grouped_estimate_coherent']} "
                             "times")
    log(f"coherent column vs per-snapshot GMM at -10 dB: "
        f"{mse_c['blmmse_gmm_coh'][i_low]:.5f} vs "
        f"{mse_c['blmmse_gmm'][i_low]:.5f}")

    # 3a. the fitted GMM of the default run at each of its SNRs (the
    # logits are largest at 20 dB): K1, K3 at T = 4 (four consecutive
    # validation snapshots a block) and K14a, against their plain float32
    # versions at TOL of the scale and against float64 under
    # `fp32_accuracy` (K14b's split3 beside them, recorded), with the
    # blmmse_gmm NMSE of K1 and K3
    if len(fitted_calls) != len(cfg.snrs):
        raise AssertionError(f"the default run estimated {len(fitted_calls)}"
                             f" banks for {len(cfg.snrs)} SNRs")
    fitted, fitted_acc, fitted_acc14 = {}, {}, {}
    for snr, (bank_s, r_s) in zip(cfg.snrs, fitted_calls):
        r2_s = kernels._r2(r_s)
        kb_1 = kernels.kernel_bank_block(bank_s)
        kb_4 = kernels.kernel_bank_block(bank_s, 4, 1.0)
        outs = {"K1": kernels.grouped_estimate(r2_s, kb_1),
                "K1 plain": kernels.grouped_estimate_reference(r2_s, kb_1),
                "K3 T=4": kernels.grouped_estimate_coherent(r2_s, kb_4, 4,
                                                            1.0),
                "K3 T=4 plain": kernels.grouped_estimate_coherent_reference(
                    r2_s, kb_4, 4, 1.0)}
        errs["grouped_estimate"].append(compare(
            "grouped_estimate", f"fitted bank, {snr} dB", outs["K1"],
            outs["K1 plain"]))
        errs["grouped_estimate_coherent"].append(compare(
            "grouped_estimate_coherent", f"fitted bank, {snr} dB, T=4",
            outs["K3 T=4"], outs["K3 T=4 plain"]))
        x64 = r2_s.double()
        want64 = {"K1": kernels.grouped_estimate_reference(x64, f64(kb_1)),
                  "K3 T=4": kernels.grouped_estimate_coherent_reference(
                      x64, f64(kb_4), 4, 1.0)}
        acc = {}
        for key, name in (("K1", "grouped_estimate"),
                          ("K3 T=4", "grouped_estimate_coherent")):
            acc[key], held = fp32_accuracy(
                name, f"fitted bank, {snr} dB", outs[key],
                outs[key + " plain"], want64[key])
            if not held:
                raise AssertionError(f"{key} less accurate than float32 on "
                                     f"the fitted bank at {snr} dB: {acc}")
        acc["split3"], _ = fp32_accuracy(
            "grouped_tc_split3", f"fitted bank, {snr} dB",
            variant_kernels.grouped_tc_split3(
                r2_s, kb_1, kernels.split_planes(kb_1.pw)),
            outs["K1 plain"], want64["K1"])
        fitted_acc[str(snr)] = acc
        # K14a on the same bank in the Karatsuba layout: within TOL of its
        # plain version and under the same float64 rule
        kk_s = variant_kernels.kernel_bank(bank_s)
        x_re = r_s.real.to(torch.float32).contiguous()
        x_im = r_s.imag.to(torch.float32).contiguous()
        got14 = torch.cat(variant_kernels.karatsuba_estimate(x_re, x_im,
                                                             kk_s), -1)
        plain14 = torch.cat(variant_kernels.reference_estimate_packed(
            kk_s, x_re, x_im), -1)
        errs["karatsuba_estimate"].append(compare(
            "karatsuba_estimate", f"fitted bank, {snr} dB", got14, plain14))
        want14 = torch.cat(variant_kernels.reference_estimate_packed(
            f64(kk_s), x_re.double(), x_im.double()), -1)
        fitted_acc14[str(snr)], held = fp32_accuracy(
            "karatsuba_estimate", f"fitted bank, {snr} dB", got14, plain14,
            want14)
        if not held:
            raise AssertionError(f"K14a less accurate than float32 on the "
                                 f"fitted bank at {snr} dB: "
                                 f"{fitted_acc14[str(snr)]}")
        del x64, want64, got14, plain14, want14
        fitted[str(snr)] = {name: stages.nmse(kernels._h(x, D, r_s.dtype),
                                              truth[0])
                            for name, x in outs.items()}
        log(f"fitted bank at {snr} dB: blmmse_gmm NMSE "
            + ", ".join(f"{k} {v:.6f}" for k, v in fitted[str(snr)].items()))
    del fitted_calls, truth

    # the same two runs with circulant covariances: the FFT-domain bank
    # through K6 and K7. The 3GPP covariances are Toeplitz, so the circulant
    # fit is an approximation; its NMSE cost is recorded, not asserted. The
    # flat run keeps the fitted banks and observations it estimates
    # (stages.estimate_circulant) for the float64 rule below.
    circ_calls, estimate_circulant = [], stages.estimate_circulant

    def keep_circ(bank_s, r_s, *args, **kwargs):
        if isinstance(bank_s, structured_bank.CirculantBank):
            circ_calls.append((bank_s, r_s))
        return estimate_circulant(bank_s, r_s, *args, **kwargs)

    stages.estimate_circulant = keep_circ
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg_s, mse_s, rate_s, timings_s, circ_s, launches_s = \
                main_path_run(run_gmm, kernels, dev, tmp,
                              cov_type="circulant")
    finally:
        stages.estimate_circulant = estimate_circulant
    add(launches_s)
    at10 = {k: v[i10] for k, v in mse_s.items()}
    if not (at10["blmmse_genie"] < at10["blmmse_gmm"] < at10["LS_glob"]):
        raise AssertionError(f"circulant MSE order at 10 dB broken: {at10}")
    if launches_s["circ_estimate"] < len(cfg_s.snrs):
        raise AssertionError(f"circulant run launched K6 only "
                             f"{launches_s['circ_estimate']} times")
    log(f"blmmse_gmm, circulant fit: {mse_s['blmmse_gmm']}")
    log(f"blmmse_gmm, full fit:      {mse['blmmse_gmm']}")
    # K6, K7 (T = 4: four consecutive validation snapshots a block), K8 and
    # K9 (two shards, merged) on the fitted circulant bank of each SNR and
    # the observations the run estimated, under the float64 rule
    if len(circ_calls) != len(cfg_s.snrs):
        raise AssertionError(f"the circulant run estimated {len(circ_calls)} "
                             f"circulant banks for {len(cfg_s.snrs)} SNRs")
    circ_acc["fitted_bank"] = {
        str(snr): circ_accuracy(f"fitted circulant bank, {snr} dB", bank_s,
                                r_s)
        for snr, (bank_s, r_s) in zip(cfg_s.snrs, circ_calls)}
    del circ_calls
    with tempfile.TemporaryDirectory() as tmp:
        cfg_sc, mse_sc, rate_sc, timings_sc, circ_coh_s, launches_sc = \
            main_path_run(run_gmm, kernels, dev, tmp, cov_type="circulant",
                          n_coherence=4, coherence_alpha=1.0)
    add(launches_sc)
    if not mse_sc["blmmse_gmm_coh"][i_low] < mse_sc["blmmse_gmm"][i_low]:
        raise AssertionError(f"circulant coherent column no better at "
                             f"-10 dB: {mse_sc['blmmse_gmm_coh'][i_low]} vs "
                             f"{mse_sc['blmmse_gmm'][i_low]}")
    if launches_sc["circ_estimate_coherent"] < len(cfg_sc.snrs):
        raise AssertionError(f"circulant coherent run launched K7 only "
                             f"{launches_sc['circ_estimate_coherent']} "
                             "times")
    log(f"circulant coherent column vs per-snapshot at -10 dB: "
        f"{mse_sc['blmmse_gmm_coh'][i_low]:.5f} vs "
        f"{mse_sc['blmmse_gmm'][i_low]:.5f}")

    # the circulant runs under two pilots: the per-bin P x P bank through
    # K10 and its coherent form. Under several `angle_amp` pilots the
    # Bussgang gain of the weakest pilot exceeds 1 from 5 dB on, and every
    # Bussgang estimator of the harness (genie, global, GMM, dense or
    # structured) then loses to LS, so the invariants are held where the
    # model is sound (-10 and -5 dB) and the tables are recorded.
    low = [list(cfg.snrs).index(snr) for snr in (-10, -5)]

    def mp_invariants(label, mse_m, launches_m, kernel_name):
        for i in low:
            at = {k: v[i] for k, v in mse_m.items()}
            if not (at["blmmse_genie"] < at["blmmse_gmm"] < at["LS_glob"]):
                raise AssertionError(f"{label}: MSE order at "
                                     f"{cfg.snrs[i]} dB broken: {at}")
            if not at["blmmse_gmm"] < mse_s["blmmse_gmm"][i]:
                raise AssertionError(
                    f"{label}: a second pilot does not help at "
                    f"{cfg.snrs[i]} dB: {at['blmmse_gmm']} vs "
                    f"{mse_s['blmmse_gmm'][i]}")
        if launches_m[kernel_name] != len(cfg.snrs):
            raise AssertionError(f"{label} launched {kernel_name} "
                                 f"{launches_m[kernel_name]} times")
        log(f"blmmse_gmm, {label}: {mse_m['blmmse_gmm']}")

    # the 2-pilot run keeps the fitted multi-pilot banks and observations
    # it estimates (stages.estimate_circulant) for the float64 rule below
    mp_calls, estimate_circulant = [], stages.estimate_circulant

    def keep_circulant(bank_s, r_s, *args, **kwargs):
        if isinstance(bank_s, structured_bank.CirculantBankMP):
            mp_calls.append((bank_s, r_s))
        return estimate_circulant(bank_s, r_s, *args, **kwargs)

    stages.estimate_circulant = keep_circulant
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg_m, mse_m, rate_m, timings_m, mp_s, launches_m = \
                main_path_run(run_gmm, kernels, dev, tmp, falling=False,
                              use_cache=True, cov_type="circulant",
                              n_pilots=2)
            # the same fit and validation channels through the dense bank
            # (K1 at M = 128) and through the multi-pilot bank (K10), at
            # -10 and 10 dB
            saves = os.path.join(tmp, "saves")
            fit_file, = [f for f in os.listdir(saves)
                         if f.startswith("trained")]
            data_file, = [f for f in os.listdir(saves)
                          if f.startswith("saved")]
            fit_params = qio.load_gmm_params(os.path.join(saves, fit_file),
                                             dev)
            h_val = torch.as_tensor(qio.load_channels(
                os.path.join(saves, data_file))[0][cfg_m.n_train:],
                device=dev)
    finally:
        stages.estimate_circulant = estimate_circulant
    add(launches_m)
    mp_invariants("circulant, 2 pilots", mse_m, launches_m,
                  "mp_circ_estimate")
    a_mp = pilots.pilot_matrix(D, 2, N_BITS, device=dev)
    mp_vs_dense = {}
    for snr in (-10.0, 10.0):
        q_snr = Q.design_quantizer(snr, N_BITS).to(dev)
        r_val = observation.observe(torch.Generator(dev).manual_seed(3),
                                    h_val, snr, a_mp, N_BITS, q_snr)
        via_k10 = stages.estimate_circulant(
            stages.prepare_bank_circulant(fit_params, snr, a_mp, N_BITS,
                                          q_snr), r_val)
        via_k1 = stages.estimate_auto(
            stages.prepare_bank(fit_params, snr, a_mp, N_BITS, q_snr), r_val,
            "all")
        torch.cuda.synchronize()
        mp_vs_dense[snr] = float((via_k10 - via_k1).abs().max()
                                 / via_k1.abs().max())
        log(f"multi-pilot bank (K10) vs dense bank (K1, M=128) at {snr} dB, "
            f"N={r_val.shape[0]}: max rel {mp_vs_dense[snr]:.3e} (tol {TOL} "
            "at -10 dB)")
    if not mp_vs_dense[-10.0] <= TOL:
        raise AssertionError(f"multi-pilot bank off the dense bank: "
                             f"{mp_vs_dense}")
    # K10 and its coherent form (T = 4) on the fitted 2-pilot bank of each
    # SNR and the observations the run estimated, under the float64 rule
    if len(mp_calls) != len(cfg_m.snrs):
        raise AssertionError(f"the 2-pilot run estimated {len(mp_calls)} "
                             f"multi-pilot banks for {len(cfg_m.snrs)} SNRs")
    mp_acc["fitted_bank"] = {
        str(snr): mp_accuracy(f"fitted 2-pilot bank, {snr} dB", bank_s, r_s)
        for snr, (bank_s, r_s) in zip(cfg_m.snrs, mp_calls)}
    del mp_calls
    with tempfile.TemporaryDirectory() as tmp:
        cfg_mc, mse_mc, rate_mc, timings_mc, mp_coh_s, launches_mc = \
            main_path_run(run_gmm, kernels, dev, tmp, falling=False,
                          cov_type="circulant", n_pilots=2, n_coherence=4,
                          coherence_alpha=1.0)
    add(launches_mc)
    mp_invariants("circulant, 2 pilots, n_coherence=4", mse_mc, launches_mc,
                  "mp_circ_estimate_coherent")
    if launches_mc["mp_circ_estimate"] != len(cfg_mc.snrs):
        raise AssertionError(f"the coherent 2-pilot run launched K10 "
                             f"{launches_mc['mp_circ_estimate']} times")
    if not mse_mc["blmmse_gmm_coh"][i_low] < mse_mc["blmmse_gmm"][i_low]:
        raise AssertionError(f"2-pilot coherent column no better at -10 dB: "
                             f"{mse_mc['blmmse_gmm_coh'][i_low]} vs "
                             f"{mse_mc['blmmse_gmm'][i_low]}")
    log(f"2-pilot coherent column vs per-snapshot at -10 dB: "
        f"{mse_mc['blmmse_gmm_coh'][i_low]:.5f} vs "
        f"{mse_mc['blmmse_gmm'][i_low]:.5f}")

    # run_mfa at the defaults: the factored bank through K11, and with
    # n_coherence=4 the coherent column through K12; the invariants of the
    # JAX harness tests (`tests/test_harness.py`), and the factored estimate
    # held against the dense bank (K1) of the same fit
    fact_calls = []
    with tempfile.TemporaryDirectory() as tmp:
        (cfg_f, mse_f, rate_f, timings_f, mfa_s, launches_f,
         fit_f) = mfa_path_run(run_mfa, stages, kernels, dev, tmp,
                               fact_calls)
        data_file, = os.listdir(os.path.join(tmp, "saves"))
        h_val_f = torch.as_tensor(qio.load_channels(os.path.join(
            tmp, "saves", data_file))[0][cfg_f.n_train:], device=dev)
    add(launches_f)
    i0, i10, i_low = (list(cfg_f.snrs).index(snr) for snr in (0, 10, -10))
    if not (mse_f["blmmse_mfa"][i0] > mse_f["blmmse_mfa"][i10]
            and mse_f["blmmse_mfa"][i10] < 1.0):
        raise AssertionError(f"blmmse_mfa does not fall from 0 to 10 dB: "
                             f"{mse_f['blmmse_mfa']}")
    if launches_f["fact_estimate"] != len(cfg_f.snrs):
        raise AssertionError(f"run_mfa launched K11 "
                             f"{launches_f['fact_estimate']} times")
    log(f"blmmse_mfa: {mse_f['blmmse_mfa']}; mfa_rstat: "
        f"{rate_f['mfa_rstat']}")
    # the factored bank of each SNR of the run (the logits are largest at
    # 20 dB): K11, K12 (T = 4: four consecutive validation snapshots a
    # block) and K13 against their plain versions and under the float64
    # rule
    if len(fact_calls) != len(cfg_f.snrs):
        raise AssertionError(f"run_mfa estimated {len(fact_calls)} banks for "
                             f"{len(cfg_f.snrs)} SNRs")
    fact_acc["fitted_bank"] = {
        str(snr): fact_accuracy(f"fitted bank, {snr} dB", bank_s,
                                ck._x2(r_s))
        for snr, (bank_s, r_s) in zip(cfg_f.snrs, fact_calls)}
    del fact_calls
    a_f = pilots.pilot_matrix(D, 1, N_BITS, device=dev)
    dense_params = mfa.to_gmm_params(fit_f, 1e-6)
    mfa_vs_dense = {}
    for snr in (-10.0, 10.0):
        q_snr = Q.design_quantizer(snr, N_BITS).to(dev)
        r_val = observation.observe(torch.Generator(dev).manual_seed(3),
                                    h_val_f, snr, a_f, N_BITS, q_snr)
        via_k11 = stages.estimate_factored(
            stages.prepare_bank_factored(fit_f, snr, a_f, N_BITS, q_snr),
            r_val)
        via_k1 = stages.estimate_auto(
            stages.prepare_bank(dense_params, snr, a_f, N_BITS, q_snr), r_val,
            "all")
        torch.cuda.synchronize()
        mfa_vs_dense[snr] = float((via_k11 - via_k1).abs().max()
                                  / via_k1.abs().max())
        log(f"factored bank (K11) vs dense bank (K1) of the same MFA fit at "
            f"{snr} dB, N={r_val.shape[0]}: max rel {mfa_vs_dense[snr]:.3e} "
            f"(tol {TOL})")
    if not max(mfa_vs_dense.values()) <= TOL:
        raise AssertionError(f"factored bank off the dense bank: "
                             f"{mfa_vs_dense}")
    with tempfile.TemporaryDirectory() as tmp:
        (cfg_fc, mse_fc, rate_fc, timings_fc, mfa_coh_s, launches_fc,
         _) = mfa_path_run(run_mfa, stages, kernels, dev, tmp, n_coherence=4)
    add(launches_fc)
    if not (mse_fc["blmmse_mfa_coh"][i_low]
            <= 1.02 * mse_fc["blmmse_mfa"][i_low]):
        raise AssertionError(f"MFA coherent column above 1.02x the "
                             f"per-snapshot one at -10 dB: {mse_fc}")
    if (launches_fc["fact_estimate_coherent"] != len(cfg_fc.snrs)
            or launches_fc["fact_estimate"] != len(cfg_fc.snrs)):
        raise AssertionError(f"the coherent run_mfa launched K12 / K11 "
                             f"{launches_fc}")
    log(f"MSE table, run_mfa (SNRs {list(cfg_f.snrs)}):")
    for label, table in (("flat", mse_f), ("n_coherence=4", mse_fc)):
        for name, vals in table.items():
            log(f"  {label:14s} {name:15s} "
                + " ".join(f"{v:.5f}" for v in vals))

    params = serving_params()
    a_eye = np.eye(D, dtype=np.complex64)     # the tool's pilot matrix
    params_dev = type(params)(*(torch.as_tensor(x, device=dev)
                                for x in params))
    q_serve = Q.design_quantizer(SNR, N_BITS).to(dev)
    serve_bank = gmm_estimator.prepare_bank(
        params_dev, SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve)
    # the structured service serves the same prior through its
    # Frobenius-best circulant approximation
    serve_cbank = structured_bank.prepare_bank_circulant(
        params_dev, SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve)

    def dense_reference(mode):
        return lambda rt: (
            gmm_estimator.estimate_coherent(serve_bank, rt, mode)
            if rt.dim() == 3 else gmm_estimator.estimate(serve_bank, rt,
                                                         mode))

    def dense_near_tie(mode):
        return lambda rt: near_ties(
            torch.cat([rt.real, rt.imag], -1).float(),
            kernels.kernel_bank_block(serve_bank), mode)

    def fft_reference(rt):
        if rt.dim() == 3:
            return structured_bank.estimate_circulant_coherent(
                serve_cbank, rt, "all", 4096, 1.0, None, "fft")
        return structured_bank.estimate_circulant(serve_cbank, rt, "all",
                                                  16384, None, "fft")

    # the same prior under the two-pilot matrix: the multi-pilot bank
    a_mp_np = a_mp.cpu().numpy()
    serve_mpbank = structured_bank.prepare_bank_circulant(
        params_dev, SNR, a_mp, N_BITS, q_serve)

    def mp_reference(rt):
        if rt.dim() == 3:
            return structured_bank.estimate_circulant_coherent(
                serve_mpbank, rt, "all", 4096, 1.0, None, "fft")
        return structured_bank.estimate_circulant(serve_mpbank, rt, "all",
                                                  16384, None, "fft")

    # a spectra-native prior of K = 256 components: two shards of 128
    # through the stats kernels K8 / K9, merged
    wide_spectra = np.random.default_rng(2).uniform(
        0.05, 2.0, (K_WIDE, D)).astype(np.float32)
    dummy = torch.zeros((K_WIDE, 1, 1), dtype=torch.complex64, device=dev)
    wide_bank = structured_bank.prepare_bank_circulant(
        type(params)(torch.full((K_WIDE,), 1.0 / K_WIDE, device=dev),
                     torch.zeros((K_WIDE, D), dtype=torch.complex64,
                                 device=dev), dummy, dummy),
        SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve,
        spectra=torch.as_tensor(wide_spectra, device=dev))

    def wide_reference(rt):
        if rt.dim() == 3:
            return structured_bank.estimate_circulant_coherent(
                wide_bank, rt, "all", 4096, 1.0, None, "fft")
        return structured_bank.estimate_circulant(wide_bank, rt, "all",
                                                  16384, None, "fft")

    # an MFA prior at the headline widths through the factored bank
    mfa_serve = mfa_prior(dev, n_dead=0, zero_mean=True, seed=2)
    serve_fbank = mfa_bank.prepare_bank_factored(
        mfa_serve, SNR, torch.as_tensor(a_eye, device=dev), N_BITS, q_serve)

    def fact_reference(rt):
        if rt.dim() == 3:
            return mfa_bank.estimate_factored_coherent(serve_fbank, rt)
        return mfa_bank.estimate_factored(serve_fbank, rt)

    serve = []
    for kwargs, modes in (
            (dict(mode="all"),
             (("flat all", 1, "grouped_estimate", dense_reference("all"),
               None),
              ("T=4 blocks, alpha=1", 4, "grouped_estimate_coherent",
               dense_reference("all"), None))),
            (dict(mode=1), (("top-1", 1, "grouped_estimate_topk",
                             dense_reference(1), dense_near_tie(1)),)),
            (dict(mode=4), (("top-4", 1, "grouped_estimate_topk",
                             dense_reference(4), dense_near_tie(4)),)),
            (dict(mode="all", structured=True),
             (("structured flat all", 1, "circ_estimate", fft_reference,
               None),
              ("structured T=4 blocks, alpha=1", 4, "circ_estimate_coherent",
               fft_reference, None))),
            (dict(mode="all", spectra=wide_spectra),
             (("structured K=256 flat all", 1, "circ_estimate_stats",
               wide_reference, None),
              ("structured K=256 T=4 blocks, alpha=1", 4,
               "circ_estimate_coherent_stats", wide_reference, None))),
            (dict(mode="all", structured=True, a=a_mp_np),
             (("structured 2 pilots flat all", 1, "mp_circ_estimate",
               mp_reference, None),
              ("structured 2 pilots T=4 blocks, alpha=1", 4,
               "mp_circ_estimate_coherent", mp_reference, None))),
            (dict(mode="all", mfa=True),
             (("factored flat all", 1, "fact_estimate", fact_reference,
               None),
              ("factored T=4 blocks, alpha=1", 4, "fact_estimate_coherent",
               fact_reference, None)))):
        spectra = kwargs.pop("spectra", None)
        a_serve = kwargs.pop("a", a_eye)
        if kwargs.pop("mfa", False):
            svc = serving.EstimationService.from_mfa(
                mfa_serve, a_eye, N_BITS, max_batch=SERVE_MAX_BATCH,
                device=dev, **kwargs)
            if not svc.factored:
                raise AssertionError("from_mfa did not take the factored bank")
        elif spectra is not None:
            svc = serving.EstimationService.from_circulant_spectra(
                np.full((K_WIDE,), 1.0 / K_WIDE, np.float32),
                np.zeros((K_WIDE, D), np.complex64), spectra, a_eye, N_BITS,
                max_batch=SERVE_MAX_BATCH, device=dev, **kwargs)
        else:
            svc = serving.EstimationService(params, a_serve, N_BITS,
                                            max_batch=SERVE_MAX_BATCH,
                                            device=dev, **kwargs)
        try:
            for label, t_coh, kernel_name, reference, near_tie in modes:
                serve.append(serve_mode(svc, kernels, dev, label, t_coh,
                                        kernel_name, reference, near_tie))
                add(serve[-1]["launches"])
        finally:
            svc.close(timeout=120.0)

    # 3b. the mesh path at world size 1: a one-rank NCCL group (a file
    # store in a temporary directory) and a (1, 1) (data, component) mesh.
    # The data-parallel GMM fit at the `run_gmm` defaults against the
    # single-device fit from the same generator, and the sharded estimators
    # on the headline banks against their single-device stages; the
    # single-device results are made first, so the launch counts read
    # around the mesh calls are the mesh path's alone.
    import torch.distributed as dist
    from quantized_channel_estimation_torch.models import gmm
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    cfg_g = run_gmm.GmmBenchConfig(use_cache=False)
    s_data, s_gmm, _ = np.random.SeedSequence(cfg_g.seed).spawn(3)
    h_all, _ = run_gmm._get_data(cfg_g, run_gmm._generator(s_data, dev))
    h_fit = h_all[:cfg_g.n_train]
    del h_all
    gcfg = gmm.GmmConfig(n_components=cfg_g.n_components,
                         cov_type=cfg_g.cov_type, blocks=cfg_g.blocks,
                         zero_mean=cfg_g.zero_mean_gmm,
                         max_iter=cfg_g.gmm_max_iter)
    tm = time.time()
    fit_one = stages.gmm_fit(run_gmm._generator(s_gmm, dev), h_fit, gcfg)
    torch.cuda.synchronize()
    fit_one_s = time.time() - tm
    # the quantized EMs' mesh forms (item 10b): 'full' and the
    # spectra-native circulant EM on 2-bit pilots of the same channels at
    # 5 dB, single-device first
    from quantized_channel_estimation_torch.models import gmm_quant
    q5 = Q.design_quantizer(5.0, N_BITS).to(dev)
    r_q5 = observation.observe(torch.Generator(dev).manual_seed(5), h_fit,
                               5.0, pilots.pilot_matrix(D, 1, N_BITS,
                                                        device=dev),
                               N_BITS, q5)
    quant_cfgs = {
        "fit_gmm_quant_shard_map, full": (
            gmm_quant.fit, "gmm_quant_fit",
            gmm.GmmConfig(n_components=K, max_iter=100)),
        "fit_circulant_spectra_shard_map": (
            gmm_quant.fit_circulant_spectra,
            "gmm_quant_fit_circulant_spectra",
            gmm.GmmConfig(n_components=K, cov_type="circulant",
                          max_iter=100))}
    quant_one = {name: fn(torch.Generator(dev).manual_seed(6), r_q5, c,
                          N_BITS, 10 ** -0.5, q5)
                 for name, (fn, _, c) in quant_cfgs.items()}
    torch.cuda.synchronize()
    rb_d = r.reshape(-1, 4, D)
    rb_f = r_f.reshape(-1, 4, D)
    mesh_cases = {   # name: (mesh call, single-device stage, near-tie rows)
        "estimate_sharded_kernel": (
            lambda m: pmesh.estimate_sharded_kernel(m, bank, r),
            stages.estimate_auto(bank, r, "all"), None),
        "estimate_sharded_kernel, T=4 blocks": (
            lambda m: pmesh.estimate_sharded_kernel(m, bank, rb_d),
            stages.estimate_coherent_auto(bank, rb_d, "all", 1.0), None),
        "estimate_sharded_circulant": (
            lambda m: pmesh.estimate_sharded_circulant(m, cbank, r),
            stages.estimate_circulant(cbank, r), None),
        "estimate_sharded_circulant, T=4 blocks": (
            lambda m: pmesh.estimate_sharded_circulant(m, cbank, rb_d),
            stages.estimate_circulant_coherent(cbank, rb_d, "all", 1.0),
            None),
        "estimate_sharded_factored": (
            lambda m: pmesh.estimate_sharded_factored(m, fbank, r_f),
            stages.estimate_factored(fbank, r_f), None),
        "estimate_sharded_factored, T=4 blocks": (
            lambda m: pmesh.estimate_sharded_factored(m, fbank, rb_f),
            stages.estimate_factored_coherent(fbank, rb_f), None),
        "estimate_sharded, k=4": (
            lambda m: pmesh.estimate_sharded(m, bank, r, 4),
            stages.estimate_auto(bank, r, 4), near_ties(r2, kb, 4)),
    }
    torch.cuda.synchronize()
    mesh_rec = {"gmm_fit_single_s": fit_one_s, "max_abs_err": {}}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh(1, 1)
            sharded = stages.ShardedStages(mesh)
            # NCCL builds its communicator at the first collective: outside
            # the timed fit
            dist.all_reduce(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tm = time.time()
            fit_dp = sharded.gmm_fit(run_gmm._generator(s_gmm, dev), h_fit,
                                     gcfg)
            torch.cuda.synchronize()
            mesh_rec["gmm_fit_mesh_s"] = time.time() - tm
            tm = time.time()
            mesh_out = {name: call(mesh)
                        for name, (call, _, _) in mesh_cases.items()}
            torch.cuda.synchronize()
            mesh_rec["estimates_s"] = time.time() - tm
            launches_mesh = kernels.launch_counts()
            quant_dp = {name: getattr(sharded, stage)(
                torch.Generator(dev).manual_seed(6), r_q5, c, N_BITS,
                10 ** -0.5, q5)
                for name, (_, stage, c) in quant_cfgs.items()}
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    add(launches_mesh)
    lb_dp = np.asarray(fit_dp.lb_history)
    lb_one = np.asarray(fit_one.lb_history)
    log(f"mesh (1, 1), NCCL: GMM fit at the run_gmm defaults (N="
        f"{h_fit.shape[0]}, D={D}, K={cfg_g.n_components}) "
        f"{len(lb_dp)} iterations in {mesh_rec['gmm_fit_mesh_s']:.1f}s "
        f"(single device: {len(lb_one)} in {fit_one_s:.1f}s)")
    if lb_dp.shape != lb_one.shape or not np.allclose(lb_dp, lb_one,
                                                     rtol=2e-5, atol=0):
        raise AssertionError(f"mesh GMM fit off the single-device fit: "
                             f"{lb_dp} vs {lb_one}")
    mesh_rec["gmm_fit_iters"] = int(len(lb_dp))
    mesh_rec["gmm_lb_max_rel"] = float(np.max(np.abs(lb_dp - lb_one)
                                              / np.abs(lb_one)))
    # the quantized mesh forms equal the single-device fits: the lower
    # bound per iteration to rtol 2e-5, the covariances or spectra to 1e-4
    # of scale
    mesh_rec["quant"] = {}
    for name, dp in quant_dp.items():
        one = quant_one[name]
        lb_q, lb_q1 = np.asarray(dp.lb_history), np.asarray(one.lb_history)
        got, want = ((dp.params.covariances, one.params.covariances)
                     if hasattr(dp, "params") else (dp.spectra, one.spectra))
        rel = float((got - want).abs().max() / want.abs().max())
        mesh_rec["quant"][name] = {
            "n_iter": int(dp.n_iter),
            "lb_max_rel": float(np.max(np.abs(lb_q - lb_q1)
                                       / np.abs(lb_q1))),
            "max_rel": rel}
        log(f"mesh (1, 1), NCCL: {name} on 2-bit pilots at 5 dB (N="
            f"{r_q5.shape[0]}, D={D}, K={K}): {dp.n_iter} iterations "
            f"(single device {one.n_iter}), lower bound max rel "
            f"{mesh_rec['quant'][name]['lb_max_rel']:.2e}, "
            f"{'covariances' if hasattr(dp, 'params') else 'spectra'} "
            f"max rel {rel:.2e}")
        if lb_q.shape != lb_q1.shape or not np.allclose(lb_q, lb_q1,
                                                        rtol=2e-5, atol=0):
            raise AssertionError(f"mesh {name} off the single-device fit: "
                                 f"{lb_q} vs {lb_q1}")
        if not rel <= TOL:
            raise AssertionError(f"mesh {name}: parameters {rel:.3e} of "
                                 "scale off the single-device fit")
    del quant_dp, quant_one, r_q5
    for name, (_, want, skip) in mesh_cases.items():
        got = mesh_out[name]
        mesh_rec["max_abs_err"][name] = compare(
            "mesh (1, 1)", f"{name} vs the single-device stage",
            ck._x2(got.reshape(-1, D)), ck._x2(want.reshape(-1, D)), skip)
    mesh_rec["launches"] = launches_mesh
    log(f"mesh path launches {launches_mesh}")
    for name in ("grouped_estimate_stats", "grouped_estimate_coherent_stats",
                 "grouped_estimate_topk_stats", "circ_estimate_stats",
                 "circ_estimate_coherent_stats", "fact_estimate_stats"):
        if launches_mesh[name] < 1:
            raise AssertionError(f"the mesh path did not launch {name}")
    del h_fit, mesh_out, mesh_cases

    # 3c. the Toeplitz fit (ROADMAP item 8): run_gmm at the defaults with
    # cov_type='toeplitz' (the inverse EM; a dense fit, estimated through
    # K1), once whole and once as 4 segments (`em_driver.fit_segmented`
    # over `gmm.fit_resume`), each fit kept for its checks
    t_new = time.time()
    toep_fits = {}
    gmm_fit, gmm_fit_resume = stages.gmm_fit, stages.gmm_fit_resume

    def keep_fit(label, fn):
        def kept(*args, **kw):
            toep_fits.setdefault(label, []).append(fn(*args, **kw))
            return toep_fits[label][-1]
        return kept

    toep = {}
    try:
        for label, change in (("toeplitz", {}),
                              ("toeplitz, 4 segments",
                               dict(gmm_fit_segments=4))):
            stages.gmm_fit = keep_fit(label, gmm_fit)
            stages.gmm_fit_resume = keep_fit(label, gmm_fit_resume)
            with tempfile.TemporaryDirectory() as tmp:
                cfg_t, mse_t, rate_t, timings_t, sec_t, launches_t = \
                    main_path_run(run_gmm, kernels, dev, tmp,
                                  cov_type="toeplitz", **change)
            add(launches_t)
            fits_t = toep_fits[label]
            toep[label] = {"mse": mse_t, "rate": rate_t, "seconds": sec_t,
                           "timings": timings_t, "launches": launches_t,
                           "segments": len(fits_t),
                           "n_iter": sum(f.n_iter for f in fits_t),
                           "lower_bound": float(fits_t[-1].lower_bound),
                           "converged": fits_t[-1].converged}
            at10 = {k: v[list(cfg_t.snrs).index(10)]
                    for k, v in mse_t.items()}
            if not (at10["blmmse_genie"] < at10["blmmse_gmm"]
                    < at10["LS_glob"]):
                raise AssertionError(f"{label}: MSE order at 10 dB broken: "
                                     f"{at10}")
            if launches_t["grouped_estimate"] != len(cfg_t.snrs):
                raise AssertionError(f"{label}: K1 launched "
                                     f"{launches_t['grouped_estimate']} "
                                     f"times, not {len(cfg_t.snrs)}")
            # the fitted covariances are Toeplitz: each of the first four
            # off-diagonals constant to 5e-2 of the mean diagonal
            # (`tests/test_gmm.py:88`)
            covs = fits_t[-1].params.covariances
            diag = torch.diagonal(covs, dim1=-2, dim2=-1).abs().mean(-1)
            spread = max(float(((d - d.mean(-1, keepdim=True)).abs()
                                .amax(-1) / diag).max())
                         for d in (torch.diagonal(covs, off, -2, -1)
                                   for off in range(1, 5)))
            toep[label]["toeplitz_spread"] = spread
            if not spread < 5e-2:
                raise AssertionError(f"{label}: covariances not Toeplitz "
                                     f"({spread:.3e} of the diagonal)")
            log(f"{label}: {toep[label]['segments']} fit call(s), "
                f"{toep[label]['n_iter']} iterations, lower bound "
                f"{toep[label]['lower_bound']:.4f}, converged "
                f"{toep[label]['converged']}, off-diagonal spread "
                f"{spread:.2e}; NMSE (SNRs {list(cfg_t.snrs)}):")
            for name, vals in mse_t.items():
                log(f"  {name:15s} " + " ".join(f"{v:.5f}" for v in vals))
    finally:
        stages.gmm_fit, stages.gmm_fit_resume = gmm_fit, gmm_fit_resume
    # the segments' budgets are ceil(100 / 4) = 25; the total is the whole
    # fit's unless that converged before its budget, and then both did
    whole, seg = toep["toeplitz"], toep["toeplitz, 4 segments"]
    seg_iters = [f.n_iter for f in toep_fits["toeplitz, 4 segments"]]
    seg["segment_iters"] = seg_iters
    budget = run_gmm.GmmBenchConfig().gmm_max_iter
    if any(n != -(-budget // 4) for n in seg_iters[:-1]):
        raise AssertionError(f"a segment stopped short: {seg_iters}")
    if not (seg["n_iter"] == whole["n_iter"]
            or (whole["converged"] and seg["converged"])):
        raise AssertionError(f"segmented fit ran {seg['n_iter']} iterations, "
                             f"the whole fit {whole['n_iter']}")
    if not abs(seg["lower_bound"] - whole["lower_bound"]) < 0.3:
        raise AssertionError(f"segmented lower bound {seg['lower_bound']} "
                             f"off the whole fit's {whole['lower_bound']}")
    toep_s = time.time() - t_new

    # 3e. CSI-free training (ROADMAP item 10a): run_gmm_quant at the
    # QuantGmmBenchConfig defaults (D = K = 64, 2 bits, 'full', trained and
    # evaluated at 5 dB on 100k / 10k channels, max_iter 100), the GMM
    # column through K1, launched exactly once; on its fitted bank and
    # validation observations K1 against its plain version (TOL) and under
    # the float64 rule; every recovered covariance keeps its floor (min
    # eigenvalue >= reg_covar within float32 rounding of its norm); the
    # NMSE finite and below the LS estimate's on the same observations.
    # Then 'toeplitz', 'diag' (each K1 once) and 'circulant' with
    # n_coherence=4 (K6 and K7 once each), and run_cov_recovery at the
    # CovRecoveryConfig defaults without its plot (matplotlib is not on
    # every machine): the recovered NMSE falls with n and stays below the
    # quantized sample covariance's from n = 10^4 on (at D = 64 the
    # recovery's noise still exceeds the quantization bias at 10^3 samples,
    # in the JAX harness as here).
    from quantized_channel_estimation_torch.harness import (
        run_cov_recovery, run_gmm_quant)
    t_quant = time.time()
    i5 = list(cfg.snrs).index(5)
    quant = {}
    for label, change, expect in (
            ("full", {}, {"grouped_estimate": 1}),
            ("toeplitz", dict(cov_type="toeplitz"), {"grouped_estimate": 1}),
            ("diag", dict(cov_type="diag"), {"grouped_estimate": 1}),
            ("circulant, T=4", dict(cov_type="circulant", n_coherence=4),
             {"circ_estimate": 1, "circ_estimate_coherent": 1})):
        cfg_q, mse_q, rate_q, times_q, sec_q, launches_q, kept = \
            quant_path_run(run_gmm_quant, stages, kernels, dev, **change)
        add(launches_q)
        for name, n in expect.items():
            if launches_q[name] != n:
                raise AssertionError(f"run_gmm_quant {label}: {name} "
                                     f"launched {launches_q[name]} times, "
                                     f"not {n}")
        fit_q = kept["fit"]
        covs = fit_q.params.covariances
        eig_min = torch.linalg.eigvalsh(covs).min(-1).values
        slack = 2e-6 * torch.linalg.matrix_norm(covs)
        floor_margin = float((eig_min - 1e-5 + slack).min())
        if floor_margin < 0:
            raise AssertionError(f"run_gmm_quant {label}: a recovered "
                                 f"covariance under its floor "
                                 f"({float(eig_min.min()):.3e})")
        # the LS estimate of the same validation observations
        (bank_q, r_q), h_q = kept["banks"][0], kept["truth"][0]
        a_q = stages.pilot_matrix(cfg_q.n_antennas, 1, cfg_q.n_bits,
                                  device=dev)
        q5 = Q.design_quantizer(5.0, cfg_q.n_bits).to(dev)
        ls_q = stages.nmse(stages.ls_global(r_q, kept["cov"], 5.0, a_q,
                                            cfg_q.n_bits, q5), h_q)
        nmse_q = mse_q["blmmse_gmm_quant"][0]
        if not nmse_q < ls_q:
            raise AssertionError(f"run_gmm_quant {label}: NMSE {nmse_q} not "
                                 f"below LS {ls_q}")
        rec = {"mse": mse_q, "rate": rate_q, "seconds": sec_q,
               "timings": times_q, "launches": launches_q,
               "n_iter": fit_q.n_iter, "converged": fit_q.converged,
               "lower_bound": float(fit_q.lower_bound),
               "fit_s": times_q["fit"],
               "ms_per_em_iteration": 1e3 * times_q["fit"] / fit_q.n_iter,
               "fit_host_syncs": kept["fit_syncs"], "ls_nmse": ls_q,
               "floor_margin": floor_margin}
        if label == "full":
            # K1 on the fitted bank and the observations the run estimated
            r2_q = kernels._r2(r_q)
            kb_q = kernels.kernel_bank_block(bank_q)
            got_q = kernels.grouped_estimate(r2_q, kb_q)
            plain_q = kernels.grouped_estimate_reference(r2_q, kb_q)
            errs["grouped_estimate"].append(compare(
                "grouped_estimate", "CSI-free fitted bank, 5 dB", got_q,
                plain_q))
            rec["k1_fp32_accuracy"], held = fp32_accuracy(
                "grouped_estimate", "CSI-free fitted bank, 5 dB", got_q,
                plain_q, kernels.grouped_estimate_reference(
                    r2_q.double(), f64(kb_q)))
            if not held:
                raise AssertionError("K1 less accurate than float32 on the "
                                     "CSI-free fitted bank")
            rec["run_gmm_blmmse_gmm_5db"] = mse["blmmse_gmm"][i5]
        quant[label] = rec
        del kept, bank_q, r_q, h_q
        log(f"run_gmm_quant {label}: {sec_q:.1f}s, fit {times_q['fit']:.2f}s "
            f"({fit_q.n_iter} iterations, {rec['ms_per_em_iteration']:.1f} "
            f"ms an iteration, {rec['fit_host_syncs']} host synchronizations), "
            f"lower bound {rec['lower_bound']:.4f}, converged "
            f"{fit_q.converged}; NMSE at 5 dB {nmse_q:.5f} (LS {ls_q:.5f}"
            + (f", run_gmm's CSI-trained blmmse_gmm {mse['blmmse_gmm'][i5]:.5f}"
               if label == "full" else "")
            + "); launches "
            + str({k: v for k, v in launches_q.items() if v}))
    tc = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cov_rec = run_cov_recovery.run(run_cov_recovery.CovRecoveryConfig(
            plot=False, results_dir=tmp), verbose=False, device=dev)
    cov_rec_s = time.time() - tc
    rec_n, quant_n = cov_rec["Cov_est"], cov_rec["sampcov_quant"]
    n_list = list(run_cov_recovery.CovRecoveryConfig().n_data_list)
    log(f"run_cov_recovery defaults ({cov_rec_s:.1f}s), NMSE by n {n_list}:")
    for name, vals in cov_rec.items():
        log(f"  {name:16s} " + " ".join(f"{v:.4g}" for v in vals))
    if not all(a > b for a, b in zip(rec_n, rec_n[1:])):
        raise AssertionError(f"recovered NMSE does not fall with n: {rec_n}")
    if not all(r < q for n_, r, q in zip(n_list, rec_n, quant_n)
               if n_ >= 10_000):
        raise AssertionError("recovery not below the quantized sample "
                             f"covariance from n = 10^4 on: {cov_rec}")
    quant_s = time.time() - t_quant

    # 3f. CSI-free training at frontier D (ROADMAP item 10b): phase 3e's
    # circulant run (D = K = 64, 2 bits, 5 dB, 100k / 10k, T = 4) with the
    # spectra-native fit, K6 and K7 launched once each on the spectra-fed
    # bank and held against their plain versions (TOL, the float64 rule);
    # its NMSE within 1.25x of 3e's dense-recovery circulant run (the JAX
    # harness test's band); the same with the streamed k-means init forced
    # (budget 0), within 1.15x of the dense init (the JAX test's band).
    # Then the frontier through `tools.quant_frontier` (the JAX tool's
    # D = 16384 row: K = 16, 40k / 2k rows, 10 dB, 30 iterations, no rate;
    # 'auto' must stream the pilots, stream the init and fit the spectra),
    # and D = 2048, K = 16, 60k rows with the rate column (the spectra fit
    # alone): datagen and fit seconds, iterations, host synchronizations,
    # peak memory, the NMSE below LS on the same observations.
    from quantized_channel_estimation_torch.models import gmm_quant
    from quantized_channel_estimation_torch.tools import quant_frontier
    t_front = time.time()
    frontier = {}
    base_nmse = quant["circulant, T=4"]["mse"]["blmmse_gmm_quant"][0]
    streamed_init = gmm_quant._streamed_init_stats
    for label, budget in (("spectra, T=4", gmm_quant._INIT_ELEM_BUDGET),
                          ("spectra, T=4, streamed init", 0)):
        calls = []
        gmm_quant._INIT_ELEM_BUDGET, saved_budget = (
            budget, gmm_quant._INIT_ELEM_BUDGET)
        gmm_quant._streamed_init_stats = lambda *args: (
            calls.append(1), streamed_init(*args))[1]
        try:
            cfg_q, mse_q, rate_q, times_q, sec_q, launches_q, kept = \
                quant_path_run(run_gmm_quant, stages, kernels, dev,
                               cov_type="circulant", n_coherence=4,
                               use_spectra_fit=True)
        finally:
            gmm_quant._INIT_ELEM_BUDGET = saved_budget
            gmm_quant._streamed_init_stats = streamed_init
        add(launches_q)
        if calls != ([1] if budget == 0 else []):
            raise AssertionError(f"run_gmm_quant {label}: streamed init "
                                 f"calls {calls}")
        for name in ("circ_estimate", "circ_estimate_coherent"):
            if launches_q[name] != 1:
                raise AssertionError(f"run_gmm_quant {label}: {name} "
                                     f"launched {launches_q[name]} times")
        fit_q = kept["fit"]
        (bank_q, r_q), h_q = kept["banks"][0], kept["truth"][0]
        nmse_q = mse_q["blmmse_gmm_quant"][0]
        rec = {"mse": mse_q, "rate": rate_q, "seconds": sec_q,
               "timings": times_q, "launches": launches_q,
               "n_iter": fit_q.n_iter, "converged": fit_q.converged,
               "lower_bound": float(fit_q.lower_bound),
               "fit_s": times_q["fit"],
               "ms_per_em_iteration": 1e3 * times_q["fit"] / fit_q.n_iter,
               "fit_host_syncs": kept["fit_syncs"],
               "dense_recovery_nmse": base_nmse}
        if label == "spectra, T=4":
            # K6 and K7 (T = 4: the run's validation blocks) on the
            # spectra-fed bank of the run
            x2_q = ck._x2(r_q)
            check_circ("spectra-fed bank, 5 dB", bank_q, x2_q)
            check_circ("spectra-fed bank, 5 dB, T=4", bank_q, x2_q, t=4)
            rec["fp32_accuracy"] = circ_accuracy(
                "spectra-fed bank, 5 dB", bank_q, r_q)
            if not nmse_q <= 1.25 * base_nmse:
                raise AssertionError(
                    f"run_gmm_quant {label}: NMSE {nmse_q} past 1.25x the "
                    f"dense-recovery circulant run's {base_nmse}")
        elif not nmse_q <= 1.15 * frontier["spectra, T=4"]["mse"][
                "blmmse_gmm_quant"][0]:
            raise AssertionError(f"run_gmm_quant {label}: NMSE {nmse_q} "
                                 "past 1.15x the dense init's")
        frontier[label] = rec
        del kept, bank_q, r_q, h_q
        log(f"run_gmm_quant {label} (D={cfg_q.n_antennas}, "
            f"K={cfg_q.n_components}): {sec_q:.1f}s, fit "
            f"{times_q['fit']:.2f}s ({fit_q.n_iter} iterations, "
            f"{rec['ms_per_em_iteration']:.1f} ms an iteration, "
            f"{rec['fit_host_syncs']} host synchronizations), NMSE at 5 dB "
            f"{nmse_q:.5f} (coherent {mse_q['blmmse_gmm_quant_coh'][0]:.5f}"
            f"; dense recovery {base_nmse:.5f}); launches "
            + str({k: v for k, v in launches_q.items() if v}))
    for label, kw, engaged in (
            ("D=16384", dict(), dict(stream_pilots=True, spectra_fit=True,
                                 streamed_init=True)),
            ("D=2048, rate", dict(n_antennas=2048, n_train=60_000,
                                  eval_rate=True),
             dict(stream_pilots=False, spectra_fit=True,
                  streamed_init=False))):
        kernels.reset_launch_counts()
        rec = quant_frontier.measure(device=dev, **kw)
        rec["launches"] = {k: v for k, v in kernels.launch_counts().items()
                           if v}
        frontier[label] = rec
        log(f"run_gmm_quant {label} (K={rec['n_components']}, n_train="
            f"{rec['n_train']}, n_val={rec['n_val']}, {rec['snr']} dB): "
            f"datagen {rec['datagen_s']:.1f}s, fit {rec['fit_s']:.1f}s "
            f"({rec['n_iter']} iterations, {rec['ms_per_iteration']:.0f} ms "
            f"an iteration, {rec['host_syncs']} host synchronizations), "
            f"total {rec['total_s']:.1f}s, peak memory "
            f"{rec['peak_gib']:.2f} GiB ({rec['allocated_before_gib']:.2f} "
            f"GiB held before the run); NMSE {rec['nmse']:.5f} (LS "
            f"{rec['ls_nmse']:.5f})"
            + (f", rate {rec['rate']:.4f}" if rec["rate"] is not None
               else "") + f"; engaged {rec['engaged']}; {card}")
        for key, want in engaged.items():
            if rec["engaged"][key] != want:
                raise AssertionError(f"run_gmm_quant {label}: {key} "
                                     f"engaged {rec['engaged'][key]}")
        if not (math.isfinite(rec["nmse"]) and rec["nmse"] < rec["ls_nmse"]):
            raise AssertionError(f"run_gmm_quant {label}: NMSE "
                                 f"{rec['nmse']} not below LS "
                                 f"{rec['ls_nmse']}")
        if rec["rate"] is not None and not math.isfinite(rec["rate"]):
            raise AssertionError(f"run_gmm_quant {label}: rate "
                                 f"{rec['rate']}")
    frontier_s = time.time() - t_front
    log(f"CSI-free frontier phase 3f: {frontier_s:.1f}s")

    # 3g. the VAE (ROADMAP item 13), `vae_phase` above
    vae_rec = vae_phase(dev, card, kernels)

    # 3h. the other channel models (ROADMAP item 14),
    # `channel_models_phase` above
    models_rec = channel_models_phase(dev, card, kernels, errs, add)

    # 3i. the user examples (ROADMAP item 17), `examples_phase` above
    examples_rec = examples_phase(kernels, add)

    # 3j. the large-array dense path: the wide K1-K3, `wide_dense_phase`
    # above
    scale_fit = {}
    wide_rec = wide_dense_phase(dev, card, kernels, errs, add, scale_fit)

    # 3k. top-k selection on wide banks: the wide K4 / K5,
    # `wide_topk_phase` above, on the bank phase 3j fitted
    topk_rec = wide_topk_phase(
        dev, card, kernels, errs, add,
        {**scale_fit, **wide_rec["scale_bench_large_d"]})
    del scale_fit

    # 3l. the circulant kernels on wide banks: the wide K6-K9,
    # `wide_circ_phase` above
    circ_wide_rec = wide_circ_phase(dev, card, kernels, errs, add)

    # 3m. the multi-pilot circulant kernel on wide banks: the wide K10,
    # `wide_mp_circ_phase` above
    mp_wide_rec = wide_mp_circ_phase(dev, card, kernels, errs, add)

    # 3n. the factored kernels on wide banks: the wide K11-K13,
    # `wide_fact_phase` above
    fact_wide_rec = wide_fact_phase(dev, card, kernels, errs, add)

    # 3d. the service over in-process meshes of 1 x 2 and 2 x 2 shards: the
    # dense, structured (K = 64, and the K = 256 spectra-native prior in two
    # component shards of 128, which K8 / K9 take whole) and factored banks
    # of the serving phase above, flat and T = 4 blocks, each window 1 s,
    # every answer held against the one-device service's to the same
    # request. Each mode must launch its stats kernel (K2, K8 / K9, K13;
    # factored blocks have none in either package: the `torch.matmul`
    # coherent stats) and run no pipeline stats path where the kernel is
    # eligible.
    from quantized_channel_estimation_torch.parallel import mesh as pmesh
    t_mesh = time.time()
    pipeline_stats = {
        "einsum": (gmm_estimator, ("estimate_stats",
                                   "estimate_coherent_stats")),
        "fft": (structured_bank, ("estimate_circulant_stats",
                                  "estimate_circulant_coherent_stats")),
        "matmul": (mfa_bank, ("estimate_factored_stats",
                              "estimate_factored_coherent_stats"))}
    pipeline_calls = {}
    saved = {}
    for mod, names in pipeline_stats.values():
        for name in names:
            saved[(mod, name)] = getattr(mod, name)

            def counted(*args, _fn=saved[(mod, name)], _name=name, **kw):
                pipeline_calls[_name] = pipeline_calls.get(_name, 0) + 1
                return _fn(*args, **kw)
            setattr(mod, name, counted)
    one_device = {rec["mode"]: rec for rec in serve}
    mesh_serve = []
    try:
        for shape in ((1, 2), (2, 2)):
            for kind, modes in (
                    ("dense", (("flat all", 1, "grouped_estimate_stats",
                                dense_reference("all")),
                               ("T=4 blocks, alpha=1", 4,
                                "grouped_estimate_coherent_stats",
                                dense_reference("all")))),
                    ("structured", (("structured flat all", 1,
                                     "circ_estimate_stats", fft_reference),
                                    ("structured T=4 blocks, alpha=1", 4,
                                     "circ_estimate_coherent_stats",
                                     fft_reference))),
                    ("wide", (("structured K=256 flat all", 1,
                               "circ_estimate_stats", wide_reference),
                              ("structured K=256 T=4 blocks, alpha=1", 4,
                               "circ_estimate_coherent_stats",
                               wide_reference))),
                    ("factored", (("factored flat all", 1,
                                   "fact_estimate_stats", fact_reference),
                                  ("factored T=4 blocks, alpha=1", 4, None,
                                   fact_reference)))):
                svcs = []
                for mesh in (None, pmesh.make_local_mesh(*shape)):
                    kw = dict(max_batch=SERVE_MAX_BATCH, device=dev,
                              mesh=mesh)
                    if kind == "factored":
                        svcs.append(serving.EstimationService.from_mfa(
                            mfa_serve, a_eye, N_BITS, **kw))
                    elif kind == "wide":
                        svcs.append(
                            serving.EstimationService.from_circulant_spectra(
                                np.full((K_WIDE,), 1.0 / K_WIDE, np.float32),
                                np.zeros((K_WIDE, D), np.complex64),
                                wide_spectra, a_eye, N_BITS, **kw))
                    else:
                        svcs.append(serving.EstimationService(
                            params, a_eye, N_BITS,
                            structured=kind == "structured", **kw))
                one, svc = svcs
                try:
                    for label, t_coh, kernel_name, reference in modes:
                        pipeline_calls.clear()
                        rec = serve_mode(
                            svc, kernels, dev,
                            f"mesh {shape[0]}x{shape[1]} {label}", t_coh,
                            kernel_name, reference, seconds=1.0,
                            same_as=one)
                        add(rec["launches"])
                        rec["pipeline_stats_calls"] = dict(pipeline_calls)
                        ran = {k for k, v in pipeline_calls.items() if v}
                        allowed = ({"estimate_factored_coherent_stats"}
                                   if kernel_name is None else set())
                        if ran != allowed:
                            raise AssertionError(
                                f"{rec['mode']}: pipeline stats paths "
                                f"{pipeline_calls}, expected only "
                                f"{allowed or 'none'}")
                        base = one_device[label]
                        rec["one_device"] = {
                            k: base[k] for k in ("estimates_per_s", "p50_ms",
                                                 "p99_ms")}
                        log(f"  beside the one-device service: "
                            f"{rec['estimates_per_s']:.0f} vs "
                            f"{base['estimates_per_s']:.0f} estimates/s, "
                            f"p50 {rec['p50_ms']:.2f} vs "
                            f"{base['p50_ms']:.2f} ms, p99 "
                            f"{rec['p99_ms']:.2f} vs {base['p99_ms']:.2f} "
                            f"ms; max {rec['max_rel_to_same_as']:.2e} of "
                            "scale off its answers")
                        mesh_serve.append(rec)
                finally:
                    for x in svcs:
                        x.close(timeout=120.0)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    mesh_serve_s = time.time() - t_mesh
    log(f"new phases (Toeplitz and segmented run_gmm {toep_s:.1f}s, "
        f"CSI-free run_gmm_quant and run_cov_recovery {quant_s:.1f}s, mesh "
        f"service {mesh_serve_s:.1f}s): "
        f"{toep_s + quant_s + mesh_serve_s:.1f}s")

    # 4. times at the headline benchmark's shapes
    n, two_m = r2.shape
    _, _, s_cols = kb.pw.shape
    two_d = s_cols - two_m
    gemm_flops = 2.0 * n * two_m * s_cols * K
    nbytes = 4.0 * (n * two_m + n * two_d + kb.pw.numel() + kb.mu.numel()
                    + kb.b.numel() + kb.logw.numel())

    def bound(flops, nbytes=nbytes, tc_flops=0.0):
        ops_s = flops / PEAK_FP32_FLOPS + tc_flops / PEAK_BF16_FLOPS
        ms = max(ops_s, nbytes / PEAK_HBM_BYTES) * 1e3
        by = "operations" if ops_s >= nbytes / PEAK_HBM_BYTES else "bytes"
        return ms, by

    def timed(label, kern, plain, library, flops, nbytes=nbytes,
              library_chunked=None, two_m=two_m, tc_flops=0.0):
        plain_ms = profiling.device_ms(plain)
        ms = profiling.device_ms(kern)
        ms2 = profiling.device_ms(kern)
        plain_ms2 = profiling.device_ms(plain)
        library_ms = profiling.device_ms(library)
        bound_ms, bound_by = bound(flops, nbytes, tc_flops)
        rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        note = ""
        if library_chunked is not None:
            rec["library_chunked_ms"] = profiling.device_ms(library_chunked)
            note = (f" (at the pipeline's default chunks "
                    f"{rec['library_chunked_ms']:.3f} ms)")
        log(f"{label} at N={n}, 2M={two_m}, 2D={two_d}, K={K}: kernel "
            f"{ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} / "
            f"{plain_ms2:.3f} ms, library {library_ms:.3f} ms{note}, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {n / (ms * 1e-3):.4g} "
            "estimates/s")
        return rec

    flat = kb.pw.permute(1, 0, 2).reshape(two_m, K * s_cols).contiguous()
    flat_p = kb.pw[:, :, :two_m].permute(1, 0, 2).reshape(
        two_m, K * two_m).contiguous()
    gemm = lambda: r2 @ flat  # noqa: E731
    logit_gemm = lambda: r2 @ flat_p  # noqa: E731

    # K1-K3 and K15 (the wgmma stream): six bf16 products of K1's GEMM on
    # the tensor cores plus 2 N K (2M + 2D) fp32 epilogue operations (K3:
    # + 3 N K); beside it the bound of the same products as fp32 FMAs
    # (`bound_fp32_ms`), the fp32 GEMM yardstick (`library_ms`) and a chain
    # of the six bf16 products, one cuBLAS call a product, each adding into
    # one float32 result as the kernel's accumulator does
    # (`library_six_bf16_ms`)
    tc_ops = kernels.tc_operands(kb)   # laid out once, as lowered_tc
    rh = r2.to(torch.bfloat16)
    rl = (r2 - rh.float()).to(torch.bfloat16)
    rl2 = ((r2 - rh.float()) - rl.float()).to(torch.bfloat16)
    r_planes = (rh, rl, rl2)

    def six_chain(kb_c):
        """The six bf16 products of kb_c's bank, one call each, in the
        kernel's order, summed into a float32 result (torch.mm, then
        torch.addmm, with out_dtype float32)."""
        flats = [p.permute(1, 0, 2).reshape(two_m, -1).contiguous()
                 for p in kernels.split_planes3(kb_c.pw)]
        pairs = ((0, 2), (1, 1), (2, 0), (1, 0), (0, 1), (0, 0))
        f32 = torch.float32

        def run():
            (a, b), *rest = pairs
            acc = torch.mm(r_planes[a], flats[b], out_dtype=f32)
            for a, b in rest:
                acc = torch.addmm(acc, r_planes[a], flats[b], out_dtype=f32)
            return acc
        return run

    def timed_tc6(label, kern, plain, library, gemm_fl, extra=0.0,
                  nbytes=nbytes, kb_c=kb):
        rec = timed(label, kern, plain, library,
                    2.0 * n * kb_c.pw.shape[0] * (two_m + two_d) + extra,
                    nbytes, tc_flops=6.0 * gemm_fl)
        rec["bound_fp32_ms"] = bound(gemm_fl + extra, nbytes)[0]
        rec["library_six_bf16_ms"] = profiling.device_ms(six_chain(kb_c))
        log(f"{label}: bound of the six products {rec['bound_ms']:.3f} ms, "
            f"as fp32 FMAs {rec['bound_fp32_ms']:.3f} ms; yardsticks fp32 "
            f"GEMM {rec['library_ms']:.3f} ms, six bf16 GEMMs "
            f"{rec['library_six_bf16_ms']:.3f} ms")
        return rec

    t1 = timed_tc6("K1", lambda: kernels.grouped_estimate(r2, kb, tc_ops),
                   lambda: kernels.grouped_estimate_reference(r2, kb), gemm,
                   gemm_flops)
    kb3 = kernels.kernel_bank_block(bank, 4, 1.0)
    t3 = timed_tc6("K3 (T=4, alpha=1)",
                   lambda: kernels.grouped_estimate_coherent(r2, kb3, 4, 1.0,
                                                             tc_ops),
                   lambda: kernels.grouped_estimate_coherent_reference(
                       r2, kb3, 4, 1.0), gemm, gemm_flops, 3.0 * n * K)
    kb16 = kernels.kernel_bank_block(bank, 16, 1.0)
    t3_16 = timed_tc6("K3 (T=16, alpha=1)",
                      lambda: kernels.grouped_estimate_coherent(
                          r2, kb16, 16, 1.0, tc_ops),
                      lambda: kernels.grouped_estimate_coherent_reference(
                          r2, kb16, 16, 1.0), gemm, gemm_flops, 3.0 * n * K)
    t4 = {k_sel: timed(
        f"K4 (k={k_sel})",
        lambda: kernels.grouped_estimate_topk(r2, kb, k_sel),
        lambda: kernels.grouped_estimate_topk_reference(r2, kb, k_sel),
        logit_gemm,
        2.0 * n * two_m * two_m * K + k_sel * 2.0 * n * two_m * two_d)
        for k_sel in (1, 4)}

    # the circulant kernels K6-K9 (the multi-pilot template at one pilot):
    # `bound_ms` is `circ_kernels.circ_bound`'s, the function's least time
    # with its transforms counted as FFTs; `bound_dft_ms` counts the
    # products the kernels compute, 2 N (2D 2D + 3D K + K 4D + 2D 2D) (K8/K9
    # less the inverse transform) as six bf16 products on the tensor cores,
    # plus the fp32 work around them, N (3D + 8D + 5K): |u|^2, the complex
    # combine, the constant and the softmax (K7 / K9 + 3 N K for the pool);
    # `bound_fp32_ms`: the products as fp32 FMAs (the bound of the fp32
    # loop these replaced). Bytes: the rows read and written once, the
    # operands once, m and den for the stats forms. The bank's units from
    # L2 (`l2_operand_bytes`): `mp_circ_units` x 24 KB a block, of 128
    # rows where two warpgroups take a block, as for K10. Library
    # yardstick: the torch.fft pipeline of the same entry, which the port
    # never calls where the kernel is eligible, over the batch as one chunk
    # (the best the library calls do); at the pipeline's default chunks of
    # 16384 rows / 4096 blocks it is bound by host launches and is kept as
    # `library_chunked_ms` only. The operands are laid out once, as
    # `circ_kernels.lowered_tc` keeps them.
    ckb = ck.circ_kernel_bank(cbank)
    ckb4 = ck.circ_kernel_bank(cbank, None, 4, 1.0)
    ops6, ops8 = ck.circ_tc_operands(ckb), ck.circ_tc_operands(ckb, True)
    circ_flops = 2.0 * n * (2 * two_d * two_d + 3 * D * K + 4 * K * D)
    circ_epi = n * (3.0 * D + 8.0 * D + 5.0 * K)
    circ_bytes = 4.0 * (2 * n * two_d + sum(x.numel() for x in ckb))
    r_blocks = r.reshape(-1, 4, D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def circ_rec(rec, label, gemm, epi, nbytes_c, t, stats):
        rec["tc_flops"] = 6.0 * gemm
        rec["bound_fp32_ms"] = bound(gemm, nbytes_c)[0]
        rec["bound_dft_ms"] = rec["bound_ms"]
        fn = ck.circ_bound(n, D, K, t, stats)
        rec["bound_ms"], rec["bound_by"] = fn["bound_ms"], fn["bound_by"]
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["share_of_bound_dft"] = rec["bound_dft_ms"] / rec["ms"]
        wg_rows = 64 // t * t
        block_rows = (2 if -(-n // (2 * wg_rows)) >= sms else 1) * wg_rows
        rec["block_rows"] = block_rows
        rec["l2_operand_bytes"] = (mk.mp_circ_units(D, K, 1, stats)
                                   * 24576.0 * -(-n // block_rows))
        log(f"{label}: bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}; "
            f"{rec['share_of_bound']:.1%} reached), of the six products with "
            f"dense transforms {rec['bound_dft_ms']:.3f} ms "
            f"({rec['share_of_bound_dft']:.0%}), as fp32 FMAs "
            f"{rec['bound_fp32_ms']:.3f} ms; the bank's units from L2 "
            f"{rec['l2_operand_bytes'] / 1e9:.3f} GB ({block_rows}-row "
            "blocks)")
        return rec

    t6 = circ_rec(timed(
        "K6", lambda: ck.circ_estimate(x2, ckb, ops6),
        lambda: ck.circ_estimate_reference(x2, ckb),
        lambda: structured_bank.estimate_circulant(
            cbank, r, "all", n, None, "fft"),
        circ_epi, circ_bytes,
        lambda: structured_bank.estimate_circulant(
            cbank, r, "all", 16384, None, "fft"),
        tc_flops=6.0 * circ_flops), "K6", circ_flops, circ_epi, circ_bytes,
        1, False)
    t7 = circ_rec(timed(
        "K7 (T=4, alpha=1)",
        lambda: ck.circ_estimate_coherent(x2, ckb4, 4, 1.0, ops6),
        lambda: ck.circ_estimate_coherent_reference(x2, ckb4, 4, 1.0),
        lambda: structured_bank.estimate_circulant_coherent(
            cbank, r_blocks, "all", n // 4, 1.0, None, "fft"),
        circ_epi + 3.0 * n * K, circ_bytes,
        lambda: structured_bank.estimate_circulant_coherent(
            cbank, r_blocks, "all", 4096, 1.0, None, "fft"),
        tc_flops=6.0 * circ_flops), "K7", circ_flops,
        circ_epi + 3.0 * n * K, circ_bytes, 4, False)
    stats_flops = circ_flops - 2.0 * n * two_d * two_d
    stats_bytes = circ_bytes + 8.0 * n - 4.0 * ckb.binv.numel()
    t8 = circ_rec(timed(
        "K8", lambda: ck.circ_estimate_stats(x2, ckb, ops8),
        lambda: ck.circ_estimate_stats_reference(x2, ckb),
        lambda: structured_bank.estimate_circulant_stats(
            cbank, r, n, None, "fft"), circ_epi, stats_bytes,
        lambda: structured_bank.estimate_circulant_stats(
            cbank, r, 16384, None, "fft"),
        tc_flops=6.0 * stats_flops), "K8", stats_flops, circ_epi,
        stats_bytes, 1, True)
    t9 = circ_rec(timed(
        "K9 (T=4, alpha=1)",
        lambda: ck.circ_estimate_coherent_stats(x2, ckb4, 4, 1.0, ops8),
        lambda: ck.circ_estimate_coherent_stats_reference(
            x2, ckb4, 4, 1.0),
        lambda: structured_bank.estimate_circulant_coherent_stats(
            cbank, r_blocks, n // 4, 1.0, None, "fft"),
        circ_epi + 3.0 * n * K, stats_bytes,
        lambda: structured_bank.estimate_circulant_coherent_stats(
            cbank, r_blocks, 4096, 1.0, None, "fft"),
        tc_flops=6.0 * stats_flops), "K9", stats_flops,
        circ_epi + 3.0 * n * K, stats_bytes, 4, True)

    # K10: `bound_ms` is `mp_circ_kernels.mp_circ_bound`'s, the function's
    # least time with its transforms counted as FFTs; `bound_dft_ms` counts
    # its four products, 2 N (P 2D 2D + F K + (P+1) K 2D + 2D 2D) with
    # F = D (3P + P (P-1)) features (the useful work only: the TPU kernel's
    # forward operands are mostly zero blocks), as six bf16 products on the
    # tensor cores, plus the fp32 work around them: the features (3 P D for
    # |u_p|^2, 6 D a pair), the complex combine (8 P D), the constant and the
    # softmax (5 K), the coherent pool (3 K); `bound_fp32_ms`: the products
    # as fp32 FMAs. Bytes: the (N, 2PD) rows read and the (N, 2D) rows
    # written once, the operands once. The bank's units from L2
    # (`l2_operand_bytes`): `mp_circ_units` x 24 KB a block, of 128 rows
    # where two warpgroups take a block (D, K <= 64, both warpgroups' u
    # beside a ring of two units, blocks over the SMs: `mp_plan` in
    # csrc/mp_circ_estimate.cu), else of 64. Library yardstick as for K6:
    # the torch.fft pipeline over the batch as one chunk; its default
    # chunks are 8192 rows / 2048 blocks.
    def timed_mp(p, t=1):
        bank_p, a_p, q_p = mp_bank(dev, p)
        rp = mp_obs(dev, a_p, q_p, n)
        xp = ck._x2(rp)
        ckb_p = mk.mp_circ_kernel_bank(bank_p, None, t, 1.0)
        ops_p = mk.mp_circ_tc_operands(ckb_p)   # laid out once
        feat = D * (3 * p + p * (p - 1))
        gemm = 2.0 * n * (p * two_d * two_d + feat * K
                          + (p + 1) * K * two_d + two_d * two_d)
        epi = n * (3.0 * p * D + 3.0 * p * (p - 1) * D + 8.0 * p * D
                   + 5.0 * K + (3.0 * K if t > 1 else 0.0))
        nbytes_p = 4.0 * (n * (p * two_d + two_d)
                          + sum(x.numel() for x in ckb_p))
        wg_rows = 64 // t * t
        two_wg = (D <= 64 and K <= 64 and mk.mp_circ_smem_bytes(
            D, K, p, t, 2) <= mk.SMEM_BLOCK_BYTES
                  and (n + 2 * wg_rows - 1) // (2 * wg_rows)
                  >= torch.cuda.get_device_properties(dev)
                  .multi_processor_count)
        block_rows = (2 if two_wg else 1) * wg_rows
        if t == 1:
            rec = timed(
                f"K10 (P={p})", lambda: mk.mp_circ_estimate(xp, ckb_p, ops_p),
                lambda: mk.mp_circ_estimate_reference(xp, ckb_p),
                lambda: structured_bank.estimate_circulant_mp(
                    bank_p, rp, "all", n, None, "fft"), epi, nbytes_p,
                lambda: structured_bank.estimate_circulant_mp(
                    bank_p, rp, "all", 8192, None, "fft"), p * two_d,
                tc_flops=6.0 * gemm)
        else:
            rp_blocks = rp.reshape(-1, t, rp.shape[-1])
            rec = timed(
                f"K10 coherent (P={p}, T={t}, alpha=1)",
                lambda: mk.mp_circ_estimate_coherent(xp, ckb_p, t, 1.0,
                                                     ops_p),
                lambda: mk.mp_circ_estimate_coherent_reference(xp, ckb_p, t,
                                                               1.0),
                lambda: structured_bank.estimate_circulant_mp_coherent(
                    bank_p, rp_blocks, "all", n // t, 1.0, None, "fft"),
                epi, nbytes_p,
                lambda: structured_bank.estimate_circulant_mp_coherent(
                    bank_p, rp_blocks, "all", 2048, 1.0, None, "fft"),
                p * two_d, tc_flops=6.0 * gemm)
        rec["tc_flops"] = 6.0 * gemm
        rec["bound_fp32_ms"] = bound(gemm + epi, nbytes_p)[0]
        rec["bound_dft_ms"] = rec["bound_ms"]
        fn = mk.mp_circ_bound(n, D, K, p, t)
        rec["bound_ms"], rec["bound_by"] = fn["bound_ms"], fn["bound_by"]
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["share_of_bound_dft"] = rec["bound_dft_ms"] / rec["ms"]
        rec["block_rows"] = block_rows
        rec["l2_operand_bytes"] = (mk.mp_circ_units(D, K, p) * 24576.0
                                   * -(-n // block_rows))
        log(f"K10 (P={p}, T={t}): bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']}; {rec['share_of_bound']:.1%} reached), of "
            f"the six products with dense transforms "
            f"{rec['bound_dft_ms']:.3f} ms ({rec['share_of_bound_dft']:.0%}"
            f"), as fp32 FMAs {rec['bound_fp32_ms']:.3f} ms; the bank's "
            f"units from L2 {rec['l2_operand_bytes'] / 1e9:.3f} GB "
            f"({block_rows}-row blocks)")
        return rec

    t10, t10_p4, t10_coh = timed_mp(2), timed_mp(4), timed_mp(2, 4)

    # K11-K13: the forward and combine products, 2 N K (2D 4M + 4M 2D), as
    # six bf16 products on the tensor cores, plus 2 N K (3D + 2M + 6D) fp32
    # operations (the logit's diagonal and latent terms, the bias and
    # diagonal combine), K12 plus 3 N K for the pool (`bound_fp32_ms`: the
    # products as fp32 FMAs); bytes: the rows read and written once, the
    # bank once, m and den for K13. Library yardstick: the `torch.matmul`
    # pipeline of `models.mfa_bank` over the batch as one chunk
    # (`library_chunked_ms`: at its default chunks). The bank's operands
    # are laid out once, as `fact_kernels.lowered_tc` keeps them.
    fkb = fk.fact_kernel_bank(fbank)
    fkb4 = fk.fact_kernel_bank(fbank, 4, 1.0)
    fact_ops = fk.fact_tc_operands(fkb)
    fact_gemm = 2.0 * n * K * (2 * two_d * 4 * M_LAT)
    fact_epi = 2.0 * n * K * (3 * D + 2 * M_LAT + 6 * D)
    fact_bytes = 4.0 * (2 * n * two_d + sum(x.numel() for x in fkb))
    rf_blocks = r_f.reshape(-1, 4, D)

    def timed_fact(label, kern, plain, library, extra, nbytes, chunked):
        rec = timed(label, kern, plain, library, fact_epi + extra, nbytes,
                    chunked, tc_flops=6.0 * fact_gemm)
        rec["bound_fp32_ms"] = bound(fact_gemm + fact_epi + extra, nbytes)[0]
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        log(f"{label}: bound of the six products {rec['bound_ms']:.3f} ms, "
            f"as fp32 FMAs {rec['bound_fp32_ms']:.3f} ms")
        return rec

    t11 = timed_fact("K11", lambda: fk.fact_estimate(xf, fkb, fact_ops),
                     lambda: fk.fact_estimate_reference(xf, fkb),
                     lambda: mfa_bank.estimate_factored(fbank, r_f, "all", n),
                     0.0, fact_bytes,
                     lambda: mfa_bank.estimate_factored(fbank, r_f))
    t12 = timed_fact("K12 (T=4, alpha=1)",
                     lambda: fk.fact_estimate_coherent(xf, fkb4, 4, 1.0,
                                                       fact_ops),
                     lambda: fk.fact_estimate_coherent_reference(xf, fkb4, 4,
                                                                 1.0),
                     lambda: mfa_bank.estimate_factored_coherent(
                         fbank, rf_blocks, "all", n // 4, 1.0),
                     3.0 * n * K, fact_bytes,
                     lambda: mfa_bank.estimate_factored_coherent(fbank,
                                                                 rf_blocks))
    t13 = timed_fact("K13", lambda: fk.fact_estimate_stats(xf, fkb, fact_ops),
                     lambda: fk.fact_estimate_stats_reference(xf, fkb),
                     lambda: mfa_bank.estimate_factored_stats(fbank, r_f, n),
                     0.0, fact_bytes + 8.0 * n,
                     lambda: mfa_bank.estimate_factored_stats(fbank, r_f))

    # K2: K1's work and bytes plus m and den written (8 bytes a row); on one
    # 32-component shard half the bank's work and bytes. K5: K4's work; its
    # bytes the rows read once, the bank once and k (1 + 2D) floats a row
    # written. Library yardstick: the GEMM-only torch.matmul, as for K1 / K4.
    t2 = timed_tc6("K2", lambda: kernels.grouped_estimate_stats(r2, kb,
                                                                tc_ops),
                   lambda: kernels.grouped_estimate_stats_reference(r2, kb),
                   gemm, gemm_flops, nbytes=nbytes + 8.0 * n)
    kb32 = type(kb)(*(x[:K // 2] for x in kb))
    ops32 = kernels.tc_operands(kb32)
    flat32 = kb32.pw.permute(1, 0, 2).reshape(two_m, -1).contiguous()
    bytes32 = 4.0 * (n * two_m + n * two_d + 2 * n + sum(
        x.numel() for x in kb32))
    t2_32 = timed_tc6("K2, one 32-component shard",
                      lambda: kernels.grouped_estimate_stats(r2, kb32, ops32),
                      lambda: kernels.grouped_estimate_stats_reference(r2,
                                                                       kb32),
                      lambda: r2 @ flat32, gemm_flops / 2, nbytes=bytes32,
                      kb_c=kb32)
    t2c = timed_tc6("K2 coherent (T=4, alpha=1)",
                    lambda: kernels.grouped_estimate_coherent_stats(
                        r2, kb3, 4, 1.0, tc_ops),
                    lambda: kernels.grouped_estimate_coherent_stats_reference(
                        r2, kb3, 4, 1.0), gemm, gemm_flops, 3.0 * n * K,
                    nbytes + 8.0 * n)
    bank_bytes = 4.0 * sum(x.numel() for x in kb)
    t5 = {k_sel: timed(
        f"K5 (k={k_sel})",
        lambda: kernels.grouped_estimate_topk_stats(r2, kb, k_sel),
        lambda: kernels.grouped_estimate_topk_stats_reference(r2, kb, k_sel),
        logit_gemm,
        2.0 * n * two_m * two_m * K + k_sel * 2.0 * n * two_m * two_d,
        4.0 * n * (two_m + k_sel * (1 + two_d)) + bank_bytes)
        for k_sel in (1, 4)}

    # 5. the kernel-measurement path: K1's variants K14a (Karatsuba), K14b
    # ('bf16', 'split2', 'split3' on bf16 tensor cores) and the floor probe
    # K15. 5a: each against its plain version at the headline shapes, a
    # ragged N and with 5 dead components (full_fixedmax not on the dead
    # bank: it anchors its softmax at logw_0, a dead component there, so
    # both versions give NaN), and against K1 on the same bank: K14a and
    # K15 full are K1's function (K15 full bit for bit), K14b within the
    # JAX tests' bounds.
    vk, fp_tool = variant_kernels, kernel_floor_probe
    r_re, r_im = r.real.contiguous(), r.imag.contiguous()
    kk = vk.kernel_bank(bank)
    planes = kernels.split_planes(kb.pw)
    probe_errs = {}
    for label, bank_c, rows in (("full", bank, r),
                                ("ragged", bank, r[:10001]),
                                ("dead", dead_bank, r[:8191])):
        kb_c, kk_c = kernels.kernel_bank_block(bank_c), vk.kernel_bank(bank_c)
        planes_c = kernels.split_planes(kb_c.pw)
        x2 = kernels._r2(rows)
        x_re, x_im = rows.real.contiguous(), rows.imag.contiguous()
        errs["karatsuba_estimate"].append(compare(
            "karatsuba_estimate", label,
            torch.cat(vk.karatsuba_estimate(x_re, x_im, kk_c), -1),
            torch.cat(vk.reference_estimate_packed(kk_c, x_re, x_im), -1)))
        for mode, wrapper in vk.TC_WRAPPERS.items():
            errs[wrapper.__name__].append(compare(
                wrapper.__name__, label, wrapper(x2, kb_c, planes_c),
                vk.grouped_tc_estimate_reference(x2, kb_c, planes_c,
                                                 vk.MODES[mode])))
        for name in fp_tool.VARIANTS:
            if name == "full_fixedmax" and label == "dead":
                continue
            err = compare("floor_probe", f"{name}, {label}",
                          fp_tool.floor_probe(x2, kb_c, name),
                          fp_tool.floor_probe_reference(x2, kb_c, name))
            probe_errs[name] = max(probe_errs.get(name, 0.0), err)
    # the row's error is `full`'s; combine_only weighs a dead component by
    # its -1e30 log-weight, so its outputs (and errors) reach 1e30 there
    errs["floor_probe"].append(probe_errs["full"])
    h1 = kernels.grouped_estimate(r2, kb)
    scale1 = float(h1.abs().max())
    vs_k1 = {"karatsuba_estimate": float((torch.cat(vk.karatsuba_estimate(
        r_re, r_im, kk), -1) - h1).abs().max()) / scale1}
    if not vs_k1["karatsuba_estimate"] <= TOL:
        raise AssertionError(f"K14a off K1: {vs_k1}")
    if not torch.equal(fp_tool.floor_probe(r2, kb, "full"), h1):
        raise AssertionError("K15 full is not K1 bit for bit")
    for mode, wrapper in vk.TC_WRAPPERS.items():
        got = wrapper(r2, kb, planes)
        vs_k1[wrapper.__name__] = float(torch.linalg.vector_norm(got - h1)
                                        / torch.linalg.vector_norm(h1))
        if not vs_k1[wrapper.__name__] < TC_BOUNDS[mode]:
            raise AssertionError(f"K14b {mode} off K1: {vs_k1}")
    # split3 against K1's plain float32 version, max-abs (the rule K1 is
    # held to), beside K1's own; then K1, K3 at T = 4 and split3 against
    # float64 (`fp32_accuracy`): K1 and K3 must hold the rule, split3, which
    # TOL passes, must fail it
    plain1 = kernels.grouped_estimate_reference(r2, kb)
    scale_p = float(plain1.abs().max())
    split3 = vk.grouped_tc_split3(r2, kb, planes, tc_ops)
    split3_vs_plain = float((split3 - plain1).abs().max()) / scale_p
    k1_vs_plain = float((h1 - plain1).abs().max()) / scale_p
    log(f"max |x - K1 plain| / max |K1 plain| at N={n}: K14b split3 "
        f"{split3_vs_plain:.3e}, K1 {k1_vs_plain:.3e} (K1's tol {TOL})")
    r64 = r2.double()
    want64 = kernels.grouped_estimate_reference(r64, f64(kb))
    headline_acc = {}
    headline_acc["K1"], held_1 = fp32_accuracy(
        "grouped_estimate", "headline", h1, plain1, want64)
    headline_acc["split3"], held_s = fp32_accuracy(
        "grouped_tc_split3", "headline", split3, plain1, want64)
    del plain1, split3
    kb4 = kernels.kernel_bank_block(bank, 4, 1.0)
    want64 = kernels.grouped_estimate_coherent_reference(r64, f64(kb4), 4,
                                                         1.0)
    headline_acc["K3 T=4"], held_3 = fp32_accuracy(
        "grouped_estimate_coherent", "headline, T=4",
        kernels.grouped_estimate_coherent(r2, kb4, 4, 1.0),
        kernels.grouped_estimate_coherent_reference(r2, kb4, 4, 1.0),
        want64)
    del r64, want64
    # K14a, six bf16 products for each of its three real products, under
    # the same rule on the same rows (in the Karatsuba layout)
    kk_ops = vk.karatsuba_operands(kk)
    got14 = torch.cat(vk.karatsuba_estimate(r_re, r_im, kk, kk_ops), -1)
    plain14 = torch.cat(vk.reference_estimate_packed(kk, r_re, r_im), -1)
    want14 = torch.cat(vk.reference_estimate_packed(
        f64(kk), r_re.double(), r_im.double()), -1)
    headline_acc["K14a"], held_14 = fp32_accuracy(
        "karatsuba_estimate", "headline", got14, plain14, want14)
    del got14, plain14, want14
    if not (held_1 and held_3 and held_14) or held_s:
        raise AssertionError(f"float64 rule at the headline: K1, K3 and K14a "
                             f"must hold it, split3 must not: "
                             f"{headline_acc}")
    log(f"against K1 at N={n}: K14a max rel {vs_k1['karatsuba_estimate']:.3e}"
        f" (tol {TOL}); K15 full bit for bit; K14b relative norms "
        + ", ".join(f"{m} {vs_k1[w.__name__]:.3e} (bound {TC_BOUNDS[m]})"
                    for m, w in vk.TC_WRAPPERS.items()))

    # 5a'. K14b launched many times at each shape of tc_repeat_check (the
    # shared-memory-A path at 2M > 128, one and two warpgroups, one block
    # to three waves, and a main-path shape), each launch after a kernel
    # that fills every SM's shared memory with NaN and held against the
    # plain version: a race that one launch may not show fails here
    tm = time.time()
    rep = tc_repeat_check.repeat_check(dev, repeats=100)["kernel"]
    bad = {k: v for k, v in rep.items() if v["failures"]}
    log(f"K14b repeated: {sum(v['launches'] for v in rep.values())} launches "
        f"in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep.values()):.3e} (tol "
        f"{tc_repeat_check.TOL}), failures {bad or 0}")
    if bad:
        raise AssertionError(f"K14b off its plain version on repeated "
                             f"launches: {bad}")
    # ... and K1 / K3 at each of tc_repeat_check's F32_SHAPES (64- and
    # 128-row blocks, the one-stage ring, each pooling route), at least
    # 1000 launches, each bit for bit the first and within the card tests'
    # rule of the plain version
    tm = time.time()
    rep_f32 = tc_repeat_check.repeat_check(dev, repeats=150,
                                           modes=("f32",))["kernel"]
    n_rep = sum(v["launches"] for v in rep_f32.values())
    bad = {k: v for k, v in rep_f32.items() if v["failures"]}
    log(f"K1 / K3 repeated: {n_rep} launches in {time.time() - tm:.1f}s, max "
        f"err {max(v['max_err'] for v in rep_f32.values()):.3e}, failures "
        f"{bad or 0}")
    if bad or n_rep < 1000:
        raise AssertionError(f"K1 / K3 off on repeated launches ({n_rep}): "
                             f"{bad}")
    # ... and K14a at each of tc_repeat_check's KARATSUBA_SHAPES (one and
    # two warpgroups, 32-column pieces, two contraction chunks), each
    # launch bit for bit the first and within TOL of its plain version
    tm = time.time()
    rep_14 = tc_repeat_check.repeat_check(dev, repeats=100,
                                          modes=("karatsuba",))["kernel"]
    bad = {k: v for k, v in rep_14.items() if v["failures"]}
    log(f"K14a repeated: {sum(v['launches'] for v in rep_14.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep_14.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"K14a off on repeated launches: {bad}")
    # ... and K11-K13 at each of tc_repeat_check's FACT_SHAPES (the
    # combine's A in registers with one and two warpgroups, A in shared
    # memory with 64-, 32- and 16-column pieces, each pooling route, K13),
    # each launch bit for bit the first and within TOL of its plain version
    # or within the float64 rule
    tm = time.time()
    rep_fact = tc_repeat_check.repeat_check(dev, repeats=100,
                                            modes=("fact",))["kernel"]
    bad = {k: v for k, v in rep_fact.items() if v["failures"]}
    log(f"K11-K13 repeated: {sum(v['launches'] for v in rep_fact.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep_fact.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"K11-K13 off on repeated launches: {bad}")
    # ... and K10 at each of tc_repeat_check's MPCIRC_SHAPES (one and two
    # warpgroups a block, 32 live rows, one, two and four pieces of 2D, two
    # of K, each pool), under the same rule
    tm = time.time()
    rep_mp = tc_repeat_check.repeat_check(dev, repeats=100,
                                          modes=("mpcirc",))["kernel"]
    bad = {k: v for k, v in rep_mp.items() if v["failures"]}
    log(f"K10 repeated: {sum(v['launches'] for v in rep_mp.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep_mp.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"K10 off on repeated launches: {bad}")
    # ... and K6-K9 at each of tc_repeat_check's CIRC_SHAPES (one and two
    # warpgroups a block, one, two and four pieces of 2D, a 128-component
    # shard, D = K = 128, each pool), under the same rule
    tm = time.time()
    rep_circ = tc_repeat_check.repeat_check(dev, repeats=100,
                                            modes=("circ",))["kernel"]
    bad = {k: v for k, v in rep_circ.items() if v["failures"]}
    log(f"K6-K9 repeated: {sum(v['launches'] for v in rep_circ.values())} "
        f"launches in {time.time() - tm:.1f}s, max err "
        f"{max(v['max_err'] for v in rep_circ.values()):.3e}, failures "
        f"{bad or 0}")
    if bad:
        raise AssertionError(f"K6-K9 off on repeated launches: {bad}")

    # 5b. the path itself, through the tools' entry points at their
    # defaults, its launches counted alone: the floor probe, kernel_bench
    # and kernel_split_bench (an SCM fit, 10 and 20 dB). No probe variant
    # may run under the GEMM's operation floor (a variant that did would
    # have lost GEMM work); K1's and split3's MSE within 1e-3 of the
    # einsum estimator's.
    kernels.reset_launch_counts()
    tm = time.time()
    probe = kernel_floor_probe.main([])
    bench = kernel_bench.main([])
    split = kernel_split_bench.main([])
    torch.cuda.synchronize()
    tools_s = time.time() - tm
    launches_tools = kernels.launch_counts()
    add(launches_tools)
    log(f"kernel tools: {tools_s:.1f}s; launches {launches_tools}")
    for name in ("grouped_estimate", "karatsuba_estimate", "floor_probe",
                 *(w.__name__ for w in vk.TC_WRAPPERS.values())):
        if launches_tools[name] < 1:
            raise AssertionError(f"the kernel tools did not launch {name}")
    under = {k: v for k, v in probe["ms"].items() if v < probe["floor_ms"]}
    if under:
        raise AssertionError(f"probe variants under the GEMM floor "
                             f"{probe['floor_ms']:.3f} ms: {under}")
    for snr, row in split["rows"].items():
        yard = row["einsum_f32"]["mse"]
        for name, rec in row.items():
            if not math.isfinite(rec["mse"]):
                raise AssertionError(f"non-finite MSE at {snr} dB: {name}")
        for name in ("kernel_f32", "kernel_split3"):
            if abs(row[name]["mse"] - yard) > 1e-3 * yard:
                raise AssertionError(f"{name} MSE off the einsum estimator's "
                                     f"at {snr} dB: {row[name]['mse']} vs "
                                     f"{yard}")

    # 5c. times at the headline shapes. K14a: three real products, each
    # six bf16 products on the tensor cores, 3 x 6 x 2 N M (M+D) K
    # operations, plus N K (9 M + 11 D) fp32 epilogue operations (as fp32
    # FMAs the products are 6 N M (M+D) K: `bound_fp32_ms`); bytes: r_re,
    # r_im read, h_re, h_im written, the bank once; library: the complex
    # GEMM r [conj(P) | W^T] over all components. K14b: passes x K1's GEMM
    # on the bf16 tensor cores plus 2 N K (2M + 2D) fp32 epilogue
    # operations; bytes: r2 read, the output written, the bf16 planes (one,
    # or hi and lo) and mu, b, logw once; library: the same one, two or
    # three bf16 torch.matmul products. K15 full: K1's bound and yardstick.
    kar_bytes = 4.0 * (4 * n * D + sum(x.numel() for x in kk))
    kar_epilogue = n * K * (9.0 * D + 11.0 * D)
    flat_c = torch.cat([torch.complex(kk.pc_re, kk.pc_im),
                        torch.complex(kk.wt_re, kk.wt_im)], -1).permute(
        1, 0, 2).reshape(D, -1).contiguous()
    t14a = timed("K14a",
                 lambda: vk.karatsuba_estimate(r_re, r_im, kk, kk_ops),
                 lambda: vk.reference_estimate_packed(kk, r_re, r_im),
                 lambda: r @ flat_c, kar_epilogue, kar_bytes, two_m=D,
                 tc_flops=36.0 * n * D * (D + D) * K)
    t14a["bound_fp32_ms"] = bound(6.0 * n * D * (D + D) * K + kar_epilogue,
                                  kar_bytes)[0]
    rh = r2.to(torch.bfloat16)
    rl = (r2 - rh.float()).to(torch.bfloat16)
    fh, fl = (p.permute(1, 0, 2).reshape(two_m, -1).contiguous()
              for p in planes)
    library_tc = {"bf16": lambda: rh @ fh,
                  "split2": lambda: (rh @ fh, rh @ fl),
                  "split3": lambda: (rh @ fh, rh @ fl, rl @ fh)}
    t14b = {}
    for mode, wrapper in vk.TC_WRAPPERS.items():
        passes = vk.MODES[mode]
        tc_bytes = 4.0 * (n * two_m + n * two_d + kb.mu.numel()
                          + kb.b.numel() + kb.logw.numel()) \
            + 2.0 * kb.pw.numel() * min(passes, 2)
        t14b[mode] = timed(
            f"K14b ({mode})", lambda w=wrapper: w(r2, kb, planes, tc_ops),
            lambda p=passes: vk.grouped_tc_estimate_reference(r2, kb, planes,
                                                              p),
            library_tc[mode], 2.0 * n * K * (two_m + two_d), tc_bytes,
            tc_flops=passes * gemm_flops)
    t15 = timed_tc6("K15 (full)",
                    lambda: fp_tool.floor_probe(r2, kb, "full", tc_ops),
                    lambda: fp_tool.floor_probe_reference(r2, kb, "full"),
                    gemm, gemm_flops)
    # the kernels redesigned for Hopper (K14b on wgmma, K4 / K5 on a
    # register-tiled fp32 loop): time, bound, the share of the bound
    # reached, and the one-call yardstick
    for label, rec in ([("K14a", t14a), ("K11", t11), ("K12 T=4", t12),
                        ("K13", t13)]
                       + [(f"K14b {m}", t14b[m]) for m in t14b]
                       + [(f"K4 k={k}", t4[k]) for k in (1, 4)]
                       + [(f"K5 k={k}", t5[k]) for k in (1, 4)]):
        log(f"redesigned {label}: {rec['ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}; "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it reached), yardstick "
            f"{rec['library_ms']:.3f} ms")

    # 5d. one K1 launch under `profiling.trace`, and its row of the
    # profiler's table
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            kernels.grouped_estimate(r2, kb)
        table = prof.key_averages().table(row_limit=-1).splitlines()
        traced = os.path.getsize(os.path.join(tmp, "trace.json"))
    rows_k1 = [line for line in table if "grouped_tc_kernel" in line]
    log("profiler (one K1 launch, trace "
        f"{traced} bytes):\n" + "\n".join(table[:3] + rows_k1))
    if not rows_k1:
        raise AssertionError("the profiler table holds no K1 kernel row")

    # 5e. K1 / K3 / K14a / K11-K13 / K10 / K6-K9 at the service's
    # microbatch sizes and the headline batch
    sweep = batch_sweep.main([])["ms"]

    src = "quantized_channel_estimation_torch/csrc/"
    tpu = "quantized_channel_estimation_tpu/estimators/pallas_kernels.py"
    print(json.dumps({"kernels": [
        {"name": "grouped_estimate", "id": "K1", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:327",
         "launches": total_launches["grouped_estimate"],
         "max_abs_err": max(errs["grouped_estimate"]), **t1,
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K1 ")},
         "fitted_bank_nmse": fitted,
         "fp32_accuracy": {"headline": headline_acc,
                           "fitted_bank": fitted_acc}},
        {"name": "grouped_estimate_coherent", "id": "K3", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:1151",
         "launches": total_launches["grouped_estimate_coherent"],
         "max_abs_err": max(errs["grouped_estimate_coherent"]),
         "t_coh": 4, "coh_alpha": 1.0, **t3, "at_t16": t3_16,
         "at_rows_ms": {k: v for k, v in sweep.items() if k.startswith("K3")}},
        {"name": "grouped_estimate_stats", "id": "K2", "route": "cuda",
         "source": src + "grouped_estimate.cu", "replaces": f"{tpu}:454",
         "launches": total_launches["grouped_estimate_stats"],
         "max_abs_err": max(errs["grouped_estimate_stats"]), **t2,
         "at_shard_k32": t2_32},
        {"name": "grouped_estimate_coherent_stats", "id": "K2_coh",
         "route": "cuda", "source": src + "grouped_estimate.cu",
         "replaces": f"{tpu}:454",
         "launches": total_launches["grouped_estimate_coherent_stats"],
         "max_abs_err": max(errs["grouped_estimate_coherent_stats"]),
         "t_coh": 4, "coh_alpha": 1.0, **t2c},
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "grouped_wide_estimate.cu",
           "replaces": f"{tpu}:454", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "widths": [512, 512],
           "n_components": WIDE_K,
           **({"t_coh": 4, "coh_alpha": 1.0} if "coherent" in name else {}),
           **wide_rec["times"][name],
           **({"at_widths": {k.split(" ", 1)[1]: v for k, v in
                             wide_rec["times"].items() if " " in k}}
              if name == "grouped_estimate_wide" else {})}
          for name, kid in (("grouped_estimate_wide", "K1_wide"),
                            ("grouped_estimate_coherent_wide", "K3_wide"),
                            ("grouped_estimate_stats_wide", "K2_wide"),
                            ("grouped_estimate_coherent_stats_wide",
                             "K2_coh_wide"))),
        {"name": "grouped_estimate_topk", "id": "K4", "route": "cuda",
         "source": src + "grouped_topk.cu", "replaces": f"{tpu}:568",
         "launches": total_launches["grouped_estimate_topk"],
         "max_abs_err": max(errs["grouped_estimate_topk"]),
         "k_sel": 1, **t4[1], "at_k4": t4[4]},
        {"name": "grouped_estimate_topk_stats", "id": "K5", "route": "cuda",
         "source": src + "grouped_topk.cu", "replaces": f"{tpu}:677",
         "launches": total_launches["grouped_estimate_topk_stats"],
         "max_abs_err": max(errs["grouped_estimate_topk_stats"]),
         "k_sel": 1, **t5[1], "at_k4": t5[4]},
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "grouped_wide_estimate.cu",
           "replaces": f"{tpu}:{line}", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "widths": [512, 512],
           "n_components": 32, "k_sel": 1,
           **topk_rec["times"][f"{name} k=1"],
           "at_k4": topk_rec["times"][f"{name} k=4"]}
          for name, kid, line in (
              ("grouped_estimate_topk_wide", "K4_wide", 568),
              ("grouped_estimate_topk_stats_wide", "K5_wide", 677))),
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "mp_circ_estimate.cu", "replaces": f"{tpu}:{line}",
           "launches": total_launches[name], "max_abs_err": max(errs[name]),
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}), **rec,
           "at_rows_ms": {k: v for k, v in sweep.items()
                          if k.startswith(f"{kid} ")},
           "fp32_accuracy": {k: v[key] for k, v in circ_acc.items()
                             if k != "fitted_bank"}
           | {"fitted_bank": {k: v[key] for k, v in
                              circ_acc["fitted_bank"].items()}}}
          for name, kid, line, coh, key, rec in (
              ("circ_estimate", "K6", 1309, False, "K6", t6),
              ("circ_estimate_coherent", "K7", 1647, True, "K7", t7),
              ("circ_estimate_stats", "K8", 1749, False, "K8", t8),
              ("circ_estimate_coherent_stats", "K9", 1822, True, "K9",
               t9))),
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "circ_wide_estimate.cu",
           "replaces": f"{tpu}:{line}", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "d": 512, "n_components": 16,
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **circ_wide_rec["times"][name]}
          for name, kid, line, coh in (
              ("circ_estimate_wide", "K6_wide", 1309, False),
              ("circ_estimate_coherent_wide", "K7_wide", 1647, True),
              ("circ_estimate_stats_wide", "K8_wide", 1749, False),
              ("circ_estimate_coherent_stats_wide", "K9_wide", 1822,
               True))),
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "circ_fact_estimate.cu",
           "replaces": f"{tpu}:{line}", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "d": 512, "n_components": 16,
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **circ_wide_rec["times"][name],
           "at_d672": circ_wide_rec["times_d672"][name],
           **({} if coh else
              {"at_narrow_headline": circ_wide_rec["narrow_headline"]})}
          for name, kid, line, coh in (
              ("circ_estimate_fact", "K6_fact", 1309, False),
              ("circ_estimate_coherent_fact", "K7_fact", 1647, True))),
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "circ_fact_estimate.cu",
           "replaces": f"{tpu}:{line}", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "d": 512, "n_components": 16,
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **circ_wide_rec["times"][name]}
          for name, kid, line, coh in (
              ("circ_estimate_stats_fact", "K8_fact", 1749, False),
              ("circ_estimate_coherent_stats_fact", "K9_fact", 1822,
               True))),
        {"name": "mp_circ_estimate", "id": "K10", "route": "cuda",
         "source": src + "mp_circ_estimate.cu", "replaces": f"{tpu}:1505",
         "launches": total_launches["mp_circ_estimate"],
         "max_abs_err": max(errs["mp_circ_estimate"]),
         "n_pilots": 2, **t10, "at_p4": t10_p4,
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K10 P=2 N")},
         "fp32_accuracy": {
             "headline": {k: v["K10"] for k, v in mp_acc.items()
                          if k.startswith("headline")},
             "fitted_bank": {k: v["K10"]
                             for k, v in mp_acc["fitted_bank"].items()}}},
        {"name": "mp_circ_estimate_coherent", "id": "K10_coh", "route": "cuda",
         "source": src + "mp_circ_estimate.cu", "replaces": f"{tpu}:1505",
         "launches": total_launches["mp_circ_estimate_coherent"],
         "max_abs_err": max(errs["mp_circ_estimate_coherent"]),
         "n_pilots": 2, "t_coh": 4, "coh_alpha": 1.0, **t10_coh,
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K10 P=2 T=4")},
         "fp32_accuracy": {
             "headline": {k: v["K10 T=4"] for k, v in mp_acc.items()
                          if k.startswith("headline")},
             "fitted_bank": {k: v["K10 T=4"]
                             for k, v in mp_acc["fitted_bank"].items()}}},
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "circ_wide_estimate.cu", "replaces": f"{tpu}:1505",
           "launches": total_launches[name], "max_abs_err": max(errs[name]),
           "d": WIDE_MP_DK[0], "n_components": WIDE_MP_DK[1],
           "n_pilots": 2,
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **mp_wide_rec["times"][name]}
          for name, kid, coh in (
              ("mp_circ_estimate_wide", "K10_wide", False),
              ("mp_circ_estimate_coherent_wide", "K10_coh_wide", True))),
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "mp_circ_fact_estimate.cu",
           "replaces": f"{tpu}:1505", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "d": WIDE_MP_DK[0],
           "n_components": WIDE_MP_DK[1], "n_pilots": 2,
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **mp_wide_rec["times"][name]}
          for name, kid, coh in (
              ("mp_circ_estimate_fact", "K10_fact", False),
              ("mp_circ_estimate_coherent_fact", "K10_coh_fact", True))),
        {"name": "fact_estimate", "id": "K11", "route": "cuda",
         "source": src + "fact_estimate.cu", "replaces": f"{tpu}:2048",
         "launches": total_launches["fact_estimate"],
         "max_abs_err": max(errs["fact_estimate"]), "latent_dim": M_LAT,
         **t11,
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K11 ")},
         "fp32_accuracy": {
             "headline": fact_acc["headline"]["K11"],
             "fitted_bank": {k: v["K11"]
                             for k, v in fact_acc["fitted_bank"].items()}}},
        {"name": "fact_estimate_coherent", "id": "K12", "route": "cuda",
         "source": src + "fact_estimate.cu", "replaces": f"{tpu}:2126",
         "launches": total_launches["fact_estimate_coherent"],
         "max_abs_err": max(errs["fact_estimate_coherent"]),
         "latent_dim": M_LAT, "t_coh": 4, "coh_alpha": 1.0, **t12,
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K12 ")},
         "fp32_accuracy": {
             "headline": fact_acc["headline"]["K12 T=4"],
             "fitted_bank": {k: v["K12 T=4"]
                             for k, v in fact_acc["fitted_bank"].items()}}},
        {"name": "fact_estimate_stats", "id": "K13", "route": "cuda",
         "source": src + "fact_estimate.cu", "replaces": f"{tpu}:2231",
         "launches": total_launches["fact_estimate_stats"],
         "max_abs_err": max(errs["fact_estimate_stats"]),
         "latent_dim": M_LAT, **t13,
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K13 ")},
         "fp32_accuracy": {
             "headline": fact_acc["headline"]["K13"],
             "fitted_bank": {k: v["K13"]
                             for k, v in fact_acc["fitted_bank"].items()}}},
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "fact_wide_estimate.cu",
           "replaces": f"{tpu}:{line}", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "d": WIDE_FACT_DKM[0],
           "n_components": WIDE_FACT_DKM[1], "latent_dim": WIDE_FACT_DKM[2],
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **fact_wide_rec["times"][name]}
          for name, kid, line, coh in (
              ("fact_estimate_wide", "K11_wide", 2048, False),
              ("fact_estimate_coherent_wide", "K12_wide", 2126, True),
              ("fact_estimate_stats_wide", "K13_wide", 2231, False))),
        *({"name": name, "id": kid, "route": "cuda",
           "source": src + "fact_fused_estimate.cu",
           "replaces": f"{tpu}:{line}", "launches": total_launches[name],
           "max_abs_err": max(errs[name]), "d": WIDE_FACT_DKM[0],
           "n_components": WIDE_FACT_DKM[1], "latent_dim": WIDE_FACT_DKM[2],
           **({"t_coh": 4, "coh_alpha": 1.0} if coh else {}),
           **fact_wide_rec["times"][name]}
          for name, kid, line, coh in (
              ("fact_estimate_fused", "K11_fused", 2048, False),
              ("fact_estimate_coherent_fused", "K12_fused", 2126, True))),
        {"name": "karatsuba_estimate", "id": "K14a", "route": "cuda",
         "source": src + "karatsuba_estimate.cu", "replaces": f"{tpu}:105",
         "launches": total_launches["karatsuba_estimate"],
         "max_abs_err": max(errs["karatsuba_estimate"]),
         "vs_k1_max_rel": vs_k1["karatsuba_estimate"], **t14a,
         "share_of_bound": t14a["bound_ms"] / t14a["ms"],
         "at_rows_ms": {k: v for k, v in sweep.items()
                        if k.startswith("K14a")},
         "fp32_accuracy": {"headline": headline_acc["K14a"],
                           "fitted_bank": fitted_acc14}},
        *({"name": w.__name__, "id": f"K14b_{mode}", "route": "cuda",
           "source": src + "grouped_tc_estimate.cu",
           "replaces": f"{tpu}:{430 if mode == 'bf16' else 440}",
           "launches": total_launches[w.__name__],
           "max_abs_err": max(errs[w.__name__]),
           "vs_k1_rel_norm": vs_k1[w.__name__], **t14b[mode],
           **({"vs_k1_plain_max_rel": split3_vs_plain}
              if mode == "split3" else {})}
          for mode, w in vk.TC_WRAPPERS.items()),
        {"name": "floor_probe", "id": "K15", "route": "cuda",
         "source": src + "floor_probe.cu",
         "replaces": "tools/kernel_floor_probe.py:191",
         "launches": total_launches["floor_probe"],
         "max_abs_err": max(errs["floor_probe"]), "variant": "full", **t15,
         "variants_ms": probe["ms"], "gemm_floor_ms": probe["floor_ms"],
         "variants_max_abs_err": probe_errs},
    ]}))
    print(json.dumps({"main_path": {
        "defaults": {"mse": mse, "rate": rate, "seconds": main_s,
                     "timings": timings, "launches": launches},
        "n_coherence_4": {"mse": mse_c, "rate": rate_c, "seconds": coh_s,
                          "timings": timings_c, "launches": launches_c},
        "circulant": {"mse": mse_s, "rate": rate_s, "seconds": circ_s,
                      "timings": timings_s, "launches": launches_s},
        "circulant_n_coherence_4": {
            "mse": mse_sc, "rate": rate_sc, "seconds": circ_coh_s,
            "timings": timings_sc, "launches": launches_sc},
        "circulant_n_pilots_2": {
            "mse": mse_m, "rate": rate_m, "seconds": mp_s,
            "timings": timings_m, "launches": launches_m,
            "rel_to_dense_bank": {str(k): v for k, v in mp_vs_dense.items()}},
        "circulant_n_pilots_2_n_coherence_4": {
            "mse": mse_mc, "rate": rate_mc, "seconds": mp_coh_s,
            "timings": timings_mc, "launches": launches_mc},
        "run_mfa": {
            "mse": mse_f, "rate": rate_f, "seconds": mfa_s,
            "timings": timings_f, "launches": launches_f,
            "rel_to_dense_bank": {str(k): v for k, v in mfa_vs_dense.items()}},
        "run_mfa_n_coherence_4": {
            "mse": mse_fc, "rate": rate_fc, "seconds": mfa_coh_s,
            "timings": timings_fc, "launches": launches_fc},
        "mesh_world_size_1": mesh_rec, "f1_rel_to_einsum": f1,
        "toeplitz": toep["toeplitz"],
        "toeplitz_4_segments": toep["toeplitz, 4 segments"],
        "gmm_quant": quant,
        "cov_recovery": {"n_data": n_list, "nmse": cov_rec,
                         "seconds": cov_rec_s},
        "gmm_quant_frontier": frontier,
        "vae": vae_rec,
        "channel_models": models_rec,
        "wide_dense": {k: v for k, v in wide_rec.items() if k != "times"},
        "wide_topk": {k: v for k, v in topk_rec.items() if k != "times"},
        "wide_circ": {k: v for k, v in circ_wide_rec.items()
                      if k != "times"},
        "wide_mp_circ": {k: v for k, v in mp_wide_rec.items()
                         if k != "times"},
        "wide_fact": {k: v for k, v in fact_wide_rec.items()
                      if k != "times"},
        "new_phases_seconds": {"toeplitz": toep_s,
                               "mesh_service": mesh_serve_s,
                               "csi_free": quant_s,
                               "csi_free_frontier": frontier_s,
                               "vae": vae_rec["seconds"],
                               "channel_models": models_rec["seconds"],
                               "wide_dense": wide_rec["seconds"],
                               "wide_topk": topk_rec["seconds"],
                               "wide_circ": circ_wide_rec["seconds"],
                               "wide_mp_circ": mp_wide_rec["seconds"],
                               "wide_fact": fact_wide_rec["seconds"]},
        "kernel_tools": {"seconds": tools_s, "launches": launches_tools,
                         "kernel_bench_ms": bench["ms"],
                         "split_bench": split},
        "total_seconds": time.time() - t0}}))
    print(json.dumps({"serving": serve, "mesh_serving": mesh_serve}))
    print(json.dumps({"examples": examples_rec}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
