"""One rank of the 2-rank Gloo groups of the port's parallel tests.

    python tests/_torch_parallel_worker.py <rank> <store file> <out dir> <job>

Each rank joins a 2-rank CPU group through a file store, runs one job on
seeded inputs and saves what it computed, beside the single-device results
of the same inputs, to <out dir>/rank<rank>.pt: 'mesh' runs the data- and
tensor-parallel fits and estimators (`parallel.mesh`, the quantized EMs'
data-parallel forms among them, and the data-parallel VAE trainer: its
step on injected draws, `vae.train(mesh=)` with a checkpoint that rank 0
then resumes on one device, and `run_vae` over both ranks) for
tests/test_torch_parallel.py,
'harness' the `n_data_shards` / `n_component_shards` options of
`run_gmm` (one run on Kronecker-MIMO channels), `run_mfa` and
`run_gmm_quant` for tests/test_torch_harness.py, 'examples' the user
examples 03 and 10 over the group for tests/test_torch_examples_mesh.py.
`spawn_group` starts both
ranks and reads their results. Imports torch, not JAX; the inputs are made
by the functions below, which the test files import too.
"""
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from quantized_channel_estimation_torch.models import (  # noqa: E402
    gmm, gmm_estimator, gmm_quant, mfa, mfa_bank, structured_bank, vae)
from quantized_channel_estimation_torch.ops import (  # noqa: E402
    linalg, observation, pilots)
from quantized_channel_estimation_torch.ops import quantizer as Q  # noqa

D, K, M_LAT, N, T, SNR = 8, 4, 2, 512, 4, 0.0


def _cr(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def gmm_params(seed=0, d=D, k=K):
    """A seeded full-covariance GMM, its means small and non-zero."""
    rng = np.random.default_rng(seed)
    a = _cr(rng, k, d, d)
    covs = torch.as_tensor((a @ a.conj().transpose(0, 2, 1) / d
                            + 0.2 * np.eye(d)).astype(np.complex64))
    w = rng.uniform(0.5, 1.5, k)
    return gmm.GmmParams(
        torch.as_tensor((w / w.sum()).astype(np.float32)),
        torch.as_tensor((0.2 * _cr(rng, k, d)).astype(np.complex64)), covs,
        linalg.robust_precision_cholesky(covs))


def observe(h, a, q, seed=1):
    return observation.observe(torch.Generator().manual_seed(seed), h, SNR,
                               a, 2, q)


def dense_case(n_pilots=1):
    """(bank, flat rows (N, M), blocks (N / T, T, M)) at 0 dB, 2 bits."""
    params = gmm_params()
    q = Q.design_quantizer(SNR, 2)
    a = pilots.pilot_matrix(D, n_pilots, 2, device="cpu")
    bank = gmm_estimator.prepare_bank(params, SNR, a, 2, q)
    rng = np.random.default_rng(2)
    h = torch.as_tensor(_cr(rng, N, D).astype(np.complex64))
    r = observe(h, a, q)
    return bank, r, r.reshape(N // T, T, -1)


def circ_case(n_pilots=1):
    """A seeded circulant prior's bank under P pilots, rows and blocks."""
    rng = np.random.default_rng(3)
    spectra = torch.as_tensor(rng.uniform(0.05, 2.0, (K, D)).astype(
        np.float32))
    dummy = torch.zeros((K, 1, 1), dtype=torch.complex64)
    w = rng.uniform(0.5, 1.5, K)
    params = gmm.GmmParams(
        torch.as_tensor((w / w.sum()).astype(np.float32)),
        torch.as_tensor((0.2 * _cr(rng, K, D)).astype(np.complex64)),
        dummy, dummy)
    q = Q.design_quantizer(SNR, 2)
    a = (torch.tensor(1.0 + 0.0j) if n_pilots == 1
         else pilots.pilot_matrix(D, n_pilots, 2, device="cpu"))
    bank = structured_bank.prepare_bank_circulant(params, SNR, a, 2, q,
                                                  spectra=spectra)
    h = torch.as_tensor(_cr(rng, N, D).astype(np.complex64))
    r = observe(h, None if n_pilots == 1 else a, q)
    return bank, r, r.reshape(N // T, T, -1)


def mfa_params(seed=4, zero_mean=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 1.5, K)
    return mfa.MfaParams(
        torch.as_tensor((w / w.sum()).astype(np.float32)),
        torch.as_tensor((np.zeros((K, D)) if zero_mean
                         else 0.3 * _cr(rng, K, D)).astype(np.complex64)),
        torch.as_tensor((0.5 * _cr(rng, K, D, M_LAT)).astype(np.complex64)),
        torch.as_tensor(rng.uniform(0.05, 0.35, (K, D)).astype(np.float32)))


def fact_case():
    q = Q.design_quantizer(SNR, 2)
    bank = mfa_bank.prepare_bank_factored(mfa_params(), SNR,
                                          torch.tensor(1.0 + 0.0j), 2, q)
    rng = np.random.default_rng(5)
    r = observe(torch.as_tensor(_cr(rng, N, D).astype(np.complex64)), None,
                q)
    return bank, r, r.reshape(N // T, T, -1)


def fit_data(n=2048, seed=6):
    """Channels drawn from the seeded GMM: (n, D) complex64."""
    params = gmm_params(seed)
    rng = np.random.default_rng(seed + 1)
    c = rng.integers(0, K, n)
    chol = np.linalg.cholesky(params.covariances.numpy())
    h = (params.means.numpy()[c]
         + np.einsum("nde,ne->nd", chol[c], _cr(rng, n, D)))
    return torch.as_tensor(h.astype(np.complex64))


GMM_FITS = {   # name: config changes; chunk 256 gives 4 chunks a rank
    "full_kmeans_seg2": dict(psum_segments=2),
    "full_random": dict(init="random", zero_mean=False),
    "diag_kmeans": dict(cov_type="diag", zero_mean=False),
}
GMM_BASE = dict(n_components=K, max_iter=8, tol=0.0, chunk_size=256)
QUANT_FITS = {   # name: (EM, config changes); 2-bit pilots at 0 dB
    "full": ("dense", dict()),
    "diag": ("dense", dict(cov_type="diag", zero_mean=False,
                           psum_segments=2)),
    "spectra": ("spectra", dict(cov_type="circulant", psum_segments=2)),
}
MFA_FITS = {"zero_mean": dict(zero_mean=True, ppca=True),
            "means_seg2": dict(zero_mean=False, psum_segments=2)}
MFA_BASE = dict(n_components=K, latent_dim=M_LAT, max_iter=8, tol=0.0,
                chunk_size=256, kmeans_iter=10)
HARNESS = {   # name: (runner, config changes)
    "gmm_data2": ("gmm", dict(n_data_shards=2)),
    "gmm_comp2": ("gmm", dict(n_component_shards=2)),
    "gmm_comp2_coh": ("gmm", dict(n_component_shards=2, n_coherence=2)),
    "gmm_circ_comp2": ("gmm", dict(n_component_shards=2,
                                   cov_type="circulant")),
    "gmm_mimo_data2": ("gmm", dict(n_data_shards=2, channel_model="mimo",
                                   n_antennas_ms=2, n_coherence=2,
                                   coherence_alpha=0.5)),
    "mfa_data2": ("mfa", dict(n_data_shards=2)),
    "mfa_comp2": ("mfa", dict(n_component_shards=2)),
    "mfa_comp2_coh": ("mfa", dict(n_component_shards=2, n_coherence=2)),
    "quant_data2": ("quant", dict(n_data_shards=2)),
    "quant_comp2": ("quant", dict(n_component_shards=2)),
    "quant_spectra_data2": ("quant", dict(n_data_shards=2,
                                          cov_type="circulant",
                                          use_spectra_fit=True)),
}


VAE_MODES = ("genie", "noisy", "real")
VAE_SNRS = (-5.0, 5.0)
VAE_STEPS = 3


def vae_case(mode):
    """(cfg, channels (512, D), pilot matrix, quantizers, model, initial
    state) of the data-parallel VAE cases."""
    cfg = vae.VaeConfig(n_antennas=D, latent_dim=2, n_layers=2,
                        vae_mode=mode, batch_size=32, epochs=2,
                        steps_per_epoch=VAE_STEPS)
    qs = [Q.design_quantizer(s, 2) for s in VAE_SNRS]
    model, state = vae.init_vae(torch.Generator().manual_seed(20), cfg)
    return (cfg, fit_data(512), pilots.pilot_matrix(D, 1, 2, device="cpu"),
            qs, model, state)


def vae_dp_steps(pm, mesh, mode):
    """VAE_STEPS data-parallel steps on injected draws (each rank's from
    its own seed), beside the one-process steps on the two ranks' draws
    concatenated (the rows of rank 1 offset by its window)."""
    cfg, h, a, qs, model, state = vae_case(mode)
    one = vae.make_train_step(model, cfg, a, VAE_SNRS, qs)
    dp = vae.make_train_step(model, cfg, a, VAE_SNRS, qs,
                             group=mesh.get_group(pm.DATA_AXIS),
                             rank=mesh.get_local_rank(pm.DATA_AXIS))
    h_local = pm.shard_data(mesh, h)
    n_local = h_local.shape[0]
    st_dp, st_one, l_dp, l_one = state, state, [], []
    for i in range(VAE_STEPS):
        draws = [one.draw(torch.Generator().manual_seed(100 + 10 * i + r),
                          n_local) for r in range(2)]
        st_dp, loss = dp.apply(st_dp, h_local,
                               draws[mesh.get_local_rank(pm.DATA_AXIS)])
        l_dp.append(float(loss))
        cat = vae.StepDraws(*(
            None if x0 is None else torch.cat([x0, x1 + n_local])
            if k == 0 else torch.cat([x0, x1])
            for k, (x0, x1) in enumerate(zip(*draws))))
        st_one, loss = one.apply(st_one, h, cat)
        l_one.append(float(loss))
    return (l_dp, tuple(st_dp)), (l_one, tuple(st_one))


def vae_run(cfg_kw, root, mesh=None, path=None):
    """`vae.train` of the noisy case (data-parallel with `mesh`):
    (losses, state)."""
    cfg, h, a, qs, _, _ = vae_case("noisy")
    _, state, losses = vae.train(21, cfg._replace(**cfg_kw), h, a, VAE_SNRS,
                                 qs, verbose=False, checkpoint_path=path,
                                 mesh=mesh)
    return losses, tuple(state)


def harness_run(kind, root, change):
    """run_gmm / run_mfa / run_gmm_quant at a small size, results under
    `root`."""
    from quantized_channel_estimation_torch.harness import (
        run_gmm, run_gmm_quant, run_mfa, run_vae)
    if kind == "vae":
        cfg = run_vae.VaeBenchConfig(
            n_antennas=D, latent_dim=2, n_layers=2, n_train=1024, n_val=256,
            batch_size=64, epochs=2, snrs=(-10, 10), results_dir=str(root),
            cache_dir=str(root / "saves"), use_cache=False, plot=False,
            **change)
        return run_vae.run(cfg, verbose=False, device="cpu")[:2]
    common = dict(n_antennas=D, n_components=K, n_train=3000, n_val=400,
                  snrs=(-10, 10), results_dir=str(root), use_cache=False,
                  cache_dir=str(root / "saves"))
    if kind == "gmm":
        cfg = run_gmm.GmmBenchConfig(gmm_max_iter=8, **common, **change)
        return run_gmm.run(cfg, verbose=False, device="cpu")[:2]
    if kind == "quant":
        cfg = run_gmm_quant.QuantGmmBenchConfig(max_iter=8, **common,
                                                **change)
        return run_gmm_quant.run(cfg, verbose=False, device="cpu")[:2]
    cfg = run_mfa.MfaBenchConfig(latent_dim=M_LAT, max_iter=8, **common,
                                 **change)
    return run_mfa.run(cfg, verbose=False, device="cpu")[:2]


def sharded_paths(pm, mesh, out, tag):
    """The tensor-parallel estimators on one mesh, each beside its
    single-device stage."""
    from quantized_channel_estimation_torch.harness import stages
    bank, r, rb = dense_case()
    whole = lambda x: pm.gather_data(mesh, x)  # noqa: E731
    out[f"{tag}/kernel_flat"] = (
        whole(pm.estimate_sharded_kernel(mesh, bank, r)),
        stages.estimate_auto(bank, r, "all"))
    out[f"{tag}/kernel_flat_einsum"] = (
        whole(pm.estimate_sharded_kernel(mesh, bank, r, use_kernel=False)),
        gmm_estimator.estimate(bank, r, "all"))
    for alpha in (1.0, 0.5):
        out[f"{tag}/kernel_coh_{alpha}"] = (
            whole(pm.estimate_sharded_kernel(mesh, bank, rb,
                                             coherence_alpha=alpha)),
            stages.estimate_coherent_auto(bank, rb, "all", alpha))
    out[f"{tag}/topk2"] = (whole(pm.estimate_sharded(mesh, bank, r, 2)),
                           stages.estimate_auto(bank, r, 2))
    out[f"{tag}/p0.9"] = (whole(pm.estimate_sharded(mesh, bank, r, 0.9)),
                          gmm_estimator.estimate(bank, r, 0.9))
    out[f"{tag}/coh_top1"] = (
        whole(pm.estimate_sharded(mesh, bank, rb, 1, coherence_alpha=0.5)),
        gmm_estimator.estimate_coherent(bank, rb, 1, 512, 0.5))
    for p in (1, 2):
        cbank, cr, crb = circ_case(p)
        out[f"{tag}/circ_p{p}_flat"] = (
            whole(pm.estimate_sharded_circulant(mesh, cbank, cr)),
            stages.estimate_circulant(cbank, cr))
        out[f"{tag}/circ_p{p}_coh"] = (
            whole(pm.estimate_sharded_circulant(mesh, cbank, crb,
                                                coherence_alpha=0.5)),
            stages.estimate_circulant_coherent(cbank, crb, "all", 0.5))
    fbank, fr, frb = fact_case()
    out[f"{tag}/fact_flat"] = (
        whole(pm.estimate_sharded_factored(mesh, fbank, fr)),
        stages.estimate_factored(fbank, fr))
    out[f"{tag}/fact_coh"] = (
        whole(pm.estimate_sharded_factored(mesh, fbank, frb)),
        stages.estimate_factored_coherent(fbank, frb))


def mesh_job(rank, root):
    """The fits and estimators of `parallel.mesh` on (2, 1) and (1, 2)
    meshes, each beside its single-device result."""
    from quantized_channel_estimation_torch.models.kmeans import kmeans
    from quantized_channel_estimation_torch.parallel import mesh as pm
    out = {}
    data_mesh = pm.make_mesh(2, 1)
    comp_mesh = pm.make_mesh(1, 2)

    x = fit_data()
    xr = torch.cat([x.real, x.imag], -1)
    out["kmeans"] = (pm.kmeans_shard_map(data_mesh,
                                         torch.Generator().manual_seed(0),
                                         xr, K, max_iter=20),
                     tuple(kmeans(torch.Generator().manual_seed(0), xr, K,
                                  max_iter=20)))
    for name, change in GMM_FITS.items():
        cfg = gmm.GmmConfig(**GMM_BASE, **change)
        dp = pm.fit_gmm_shard_map(data_mesh, torch.Generator().manual_seed(1),
                                  x, cfg)
        one = gmm.fit(torch.Generator().manual_seed(1), x, cfg)
        out[f"gmm/{name}"] = ((dp.lb_history, tuple(dp.params)),
                              (one.lb_history, tuple(one.params)))
    q = Q.design_quantizer(SNR, 2)
    r = observe(x / x.abs().pow(2).mean().sqrt(),
                pilots.pilot_matrix(D, 1, 2, device="cpu"), q, seed=8)
    for name, (kind, change) in QUANT_FITS.items():
        cfg = gmm.GmmConfig(**GMM_BASE, **change)
        dp_fit, one_fit = (
            (pm.fit_gmm_quant_shard_map, gmm_quant.fit) if kind == "dense"
            else (pm.fit_circulant_spectra_shard_map,
                  gmm_quant.fit_circulant_spectra))
        fits = (dp_fit(data_mesh, torch.Generator().manual_seed(3), r, cfg,
                       2, 10 ** (-SNR / 10), q),
                one_fit(torch.Generator().manual_seed(3), r, cfg, 2,
                        10 ** (-SNR / 10), q))
        out[f"quant/{name}"] = tuple(
            (f.lb_history, tuple(f.params[:3]) if kind == "dense"
             else (f.weights, f.means, f.spectra, f.spec_quant))
            for f in fits)
    for name, change in MFA_FITS.items():
        cfg = mfa.MfaConfig(**MFA_BASE, **change)
        dp = pm.fit_mfa_shard_map(data_mesh, torch.Generator().manual_seed(2),
                                  x, cfg)
        one = mfa.fit(torch.Generator().manual_seed(2), x, cfg)
        out[f"mfa/{name}"] = ((float(dp.log_likelihood), tuple(dp.params)),
                              (float(one.log_likelihood), tuple(one.params)))

    for mode in VAE_MODES:
        out[f"vae_step/{mode}"] = vae_dp_steps(pm, data_mesh, mode)
    out["vae_train_dp"] = vae_run({}, root, data_mesh,
                                  str(root / "vae_ckpt"))
    cfg, h, a, qs, model, state = vae_case("real")
    stream = np.random.SeedSequence(22)
    one_shot = pm.vae_run_epochs_shard_map(data_mesh, model, cfg, a,
                                           VAE_SNRS, qs, state, h, stream,
                                           VAE_STEPS, 2, epoch0=1)
    runner = pm.make_vae_epochs_runner(data_mesh, model, cfg, a, VAE_SNRS,
                                       qs, VAE_STEPS, 1)
    st1, l1 = runner(state, h, stream, 1)
    st2, l2 = runner(st1, h, stream, 2)
    out["vae_blocks"] = ((tuple(one_shot[0]), one_shot[1]),
                         (tuple(st2), torch.cat([l1, l2])))
    out["vae_run_dp"] = harness_run("vae", root / f"vae_rank{rank}",
                                    dict(n_data_shards=2))
    sharded_paths(pm, data_mesh, out, "data2")
    sharded_paths(pm, comp_mesh, out, "comp2")
    # the dense TP case the test holds against JAX's estimate_sharded_kernel
    bank, r, _ = dense_case()
    out["jax_case"] = (tuple(x.resolve_conj().numpy() for x in bank),
                       r.numpy(),
                       pm.gather_data(comp_mesh, pm.estimate_sharded_kernel(
                           comp_mesh, bank, r)).numpy())
    return out


def harness_job(rank, root):
    """The sharded harness runs; rank 0 then repeats each on one device
    (outside the group, after `main` destroys it: see `single_runs`)."""
    return {f"harness/{name}": harness_run(kind, root / name / f"rank{rank}",
                                           change)
            for name, (kind, change) in HARNESS.items()}


def vae_resume_single(root):
    """Rank 0, after the group: the data-parallel run's checkpoint resumed
    on one device to a third epoch."""
    return {"vae_resume_single": vae_run(dict(epochs=3), root,
                                         path=str(root / "vae_ckpt"))}


def single_runs(root):
    one = {k: 1 for k in ("n_data_shards", "n_component_shards")}
    return {f"harness1/{name}": harness_run(kind, root / name / "single",
                                            {**change, **one})
            for name, (kind, change) in HARNESS.items()}


# the user examples over the group: 03's sizes (its data-parallel fit) and
# 10's sweep (at a 1 x 2 mesh)
EX03 = dict(n_ant=16, k=8, n_train=2000, n_val=400, max_iter=10)
EX10 = dict(n_antennas=16, n_components=8, n_train=2000, n_val=400,
            snrs=(-10, 0, 10), gmm_max_iter=10)


def examples_job(rank, root):
    """03 and 10 of `quantized_channel_estimation_torch.examples` on the
    group (each uses the group it finds and leaves it), and 10 asked for a
    mesh the group does not hold (its refusal's message)."""
    from quantized_channel_estimation_torch import examples
    ex03, ex10 = examples.load("03"), examples.load("10")
    out = {"ex03": ex03.main(device="cpu", **EX03),
           "ex10": ex10.main(device="cpu", mesh=(1, 2), **EX10)}
    try:
        ex10.main(device="cpu", mesh=(2, 2), **EX10)
    except ValueError as err:
        out["ex10_refused"] = str(err)
    return out


def examples_single(root):
    """Rank 0, after the group: 03's fit on one device (the same data,
    config and generator)."""
    from quantized_channel_estimation_torch import examples
    ex03 = examples.load("03")
    h_train, _ = ex03.data("cpu", EX03["n_ant"], EX03["n_train"],
                           EX03["n_val"])
    res = gmm.fit(ex03.generator(2, "cpu"), h_train,
                  ex03.config(EX03["k"], EX03["max_iter"]))
    return {"ex03_single_lb": [float(v) for v in res.lb_history]}


JOBS = {"mesh": mesh_job, "harness": harness_job, "examples": examples_job}
# run by rank 0 alone once the group is destroyed
AFTER = {"mesh": vae_resume_single, "harness": single_runs,
         "examples": examples_single}


def spawn_group(out_dir, job, timeout):
    """Run `job` in a 2-rank group of fresh processes; the two ranks'
    results. A group that has not finished after `timeout` seconds is
    killed and raises, so a hang fails its tests instead of the suite's
    clock."""
    out_dir = pathlib.Path(out_dir)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(out_dir / "store"),
         str(out_dir), job], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"the 2-rank group ({job}) did not finish in "
                           f"{timeout} s")
    for p, out in zip(procs, outs):
        if p.returncode != 0 or "WORKER_OK" not in out:
            raise RuntimeError(f"a rank of the {job} group failed:\n"
                               + out[-4000:])
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def main():
    rank, store_file, out_dir, job = (int(sys.argv[1]), sys.argv[2],
                                      sys.argv[3], sys.argv[4])
    torch.set_num_threads(2)
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_file, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    root = pathlib.Path(out_dir)
    out = JOBS[job](rank, root)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        out.update(AFTER[job](root))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
