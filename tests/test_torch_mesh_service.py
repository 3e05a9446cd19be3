"""The estimation service over an in-process mesh (`mesh=`) against the
one-device service and the JAX direct estimators.

A `parallel.mesh.make_local_mesh(n_data, n_component)` mesh splits every
microbatch's rows over "data" and the bank over "component"; on the CPU
each shard runs the plain version of its stats kernel (K2, K8 / K9, K13)
and the states merge with `kernels.merge_stats`. Every answer is held
against the one-device port service on the same requests and against the
JAX `gmm_estimator.estimate` / `estimate_coherent` (or the structured and
factored pipelines) on the same bank, at atol 1e-4, as
`tests/test_serving.py` holds the JAX mesh service. D = 16, K = 8.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_estimator as jge
from quantized_channel_estimation_tpu.models import mfa as jmfa
from quantized_channel_estimation_tpu.models import mfa_bank as jmb
from quantized_channel_estimation_tpu.models import structured_bank as jsb
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.ops import observation as tobs
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.ops import scm as tscm
from quantized_channel_estimation_torch.parallel import mesh as pm

torch.set_num_threads(2)

D, K, M_LAT, SNR, TIMEOUT = 16, 8, 4, 5.0, 30.0
MESHES = [(4, 2), (1, 2)]


@pytest.fixture(scope="module")
def setup():
    """A full and a circulant fit of the port on one set of SCM channels,
    a seeded MFA prior, the pilot matrix and held-out observations."""
    h, _ = tscm.generate_channels(torch.Generator().manual_seed(60), 3200,
                                  tscm.ScmConfig(D, 1))
    fits = {cov: tg.fit(torch.Generator().manual_seed(61), h[:3000],
                        tg.GmmConfig(n_components=K, cov_type=cov,
                                     max_iter=8, chunk_size=1024)).params
            for cov in ("full", "circulant")}
    rng = np.random.default_rng(7)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    w = (rng.uniform(size=K) + 0.1).astype(np.float32)
    mfa = (w / w.sum(), (0.3 * cr(K, D)).astype(np.complex64),
           (0.5 * cr(K, D, M_LAT)).astype(np.complex64),
           (0.1 + rng.uniform(size=(K, D))).astype(np.float32))
    a = tp.pilot_matrix(D, 1, 2)
    r = tobs.observe(torch.Generator().manual_seed(62), h[3000:3192], SNR, a,
                     2, tq.design_quantizer(SNR, 2)).numpy()
    return fits, mfa, a.numpy(), r


def _np_params(params):
    return [p.numpy() for p in params]


def _jax_direct(setup, kind, r):
    """The JAX direct estimator of the bank `kind` on requests r."""
    fits, mfa, a, _ = setup
    q = jq.design_quantizer(SNR, 2)
    rj = jnp.asarray(r)
    if kind == "dense":
        bank = jge.prepare_bank(jg.GmmParams(*_np_params(fits["full"])), SNR,
                                jnp.asarray(a), 2, q)
        if r.ndim == 3:
            return np.asarray(jge.estimate_coherent(bank, rj, "all", 512))
        return np.asarray(jge.estimate(bank, rj, "all"))
    if kind == "structured":
        bank = jsb.prepare_bank_circulant(
            jg.GmmParams(*_np_params(fits["circulant"])), SNR, jnp.asarray(a),
            2, q)
        if r.ndim == 3:
            return np.asarray(jsb.estimate_circulant_coherent(
                bank, rj, "all", 4096, 1.0, None, "fft"))
        return np.asarray(jsb.estimate_circulant(bank, rj, "all", 16384,
                                                 None, "fft"))
    bank = jmb.prepare_bank_factored(
        jmfa.MfaParams(*(jnp.asarray(x) for x in mfa)), SNR, 1.0 + 0.0j, 2, q)
    if r.ndim == 3:
        return np.asarray(jmb.estimate_factored_coherent(bank, rj, "all",
                                                         1024, 1.0, "xla"))
    return np.asarray(jmb.estimate_factored(bank, rj, "all", 4096, "xla"))


def _service(setup, kind, mesh=None, **kw):
    fits, mfa, a, _ = setup
    kw.setdefault("max_delay_ms", 1.0)
    if kind == "factored":
        return serving.EstimationService.from_mfa(mfa, 1.0 + 0.0j, 2,
                                                  device="cpu", mesh=mesh,
                                                  **kw)
    params = fits["circulant" if kind == "structured" else "full"]
    return serving.EstimationService(params, a, 2, device="cpu", mesh=mesh,
                                     structured=kind == "structured", **kw)


@pytest.mark.parametrize("kind", ["dense", "structured", "factored"])
@pytest.mark.parametrize("n_data,n_comp", MESHES)
def test_mesh_service_matches_one_device_and_jax(setup, kind, n_data,
                                                 n_comp):
    """Flat requests and T = 4 blocks through the mesh's shards (K2, K8 /
    K9, K13 flat with the factored blocks on the pipeline, all plain here),
    against the one-device service and the JAX direct estimator, atol
    1e-4; one layout cache a component shard, kept with the bank."""
    r = setup[3]
    mesh = pm.make_local_mesh(n_data, n_comp)
    one, svc = _service(setup, kind), _service(setup, kind, mesh)
    try:
        assert svc.mesh is mesh and svc.use_kernels
        for req in (r[:96], r[:128].reshape(32, 4, D)):
            got = svc.submit(req, SNR, timeout=TIMEOUT)
            assert got.shape == req.shape[:-1] + (D,)
            np.testing.assert_allclose(
                got, one.submit(req, SNR, timeout=TIMEOUT), atol=1e-4)
            np.testing.assert_allclose(got, _jax_direct(setup, kind, req),
                                       atol=1e-4)
        entry = svc._banks[svc._snap(SNR)]
        assert len(entry.shards) == n_comp and entry.lowered == {}
        layouts = [dict(c) for c in entry.shards]
        svc.submit(r[96:160], SNR, timeout=TIMEOUT)
        for before, after in zip(layouts, entry.shards):
            assert before and all(after[k] is v for k, v in before.items())
        m = svc.metrics()
        assert m["requests_failed"] == 0 and m["requests_completed"] == 3
    finally:
        one.close(timeout=TIMEOUT)
        svc.close(timeout=TIMEOUT)


def test_mesh_service_pipeline_routes_match(setup):
    """use_kernels=False takes the einsum / `torch.fft` / `torch.matmul`
    stats paths on every shard, and a 2-pilot structured bank the
    multi-pilot pipeline's (K10 has no stats form): the same answers."""
    fits, _, _, r = setup
    mesh = pm.make_local_mesh(2, 2)
    for kind in ("dense", "structured", "factored"):
        one = _service(setup, kind)
        svc = _service(setup, kind, mesh, use_kernels=False)
        try:
            assert not svc.use_kernels
            for req in (r[:64], r[:64].reshape(16, 4, D)):
                np.testing.assert_allclose(
                    svc.submit(req, SNR, timeout=TIMEOUT),
                    one.submit(req, SNR, timeout=TIMEOUT), atol=1e-4)
        finally:
            one.close(timeout=TIMEOUT)
            svc.close(timeout=TIMEOUT)
    a2 = tp.pilot_matrix(D, 2, 2)
    r2 = tobs.observe(torch.Generator().manual_seed(63),
                      torch.as_tensor(r[:64]), SNR, a2, 2,
                      tq.design_quantizer(SNR, 2)).numpy()
    one = serving.EstimationService(fits["circulant"], a2.numpy(), 2,
                                    device="cpu", structured=True,
                                    max_delay_ms=1.0)
    svc = serving.EstimationService(fits["circulant"], a2.numpy(), 2,
                                    device="cpu", structured=True, mesh=mesh,
                                    max_delay_ms=1.0)
    try:
        assert one.use_kernels and not svc.use_kernels
        for req in (r2, r2.reshape(16, 4, 2 * D)):
            np.testing.assert_allclose(svc.submit(req, SNR, timeout=TIMEOUT),
                                       one.submit(req, SNR, timeout=TIMEOUT),
                                       atol=1e-4)
    finally:
        one.close(timeout=TIMEOUT)
        svc.close(timeout=TIMEOUT)


def test_mesh_large_t_pads_divide_over_data(setup):
    """T = 16 blocks: the T-aware floor would pad 3 blocks to 4 anyway;
    on an 8-way data axis the mesh floor pads 1 block to 8 (divisible),
    where the one-device floor keeps 1."""
    r = setup[3]
    for n_data, blocks in ((4, 3), (8, 1)):
        svc = _service(setup, "dense", pm.make_local_mesh(n_data, 2))
        try:
            rb = r[:blocks * 16].reshape(blocks, 16, D)
            np.testing.assert_allclose(svc.submit(rb, SNR, timeout=TIMEOUT),
                                       _jax_direct(setup, "dense", rb),
                                       atol=1e-4)
            assert svc.metrics()["microbatches"] == 1
        finally:
            svc.close(timeout=TIMEOUT)


def test_mesh_auto_alpha_trims_to_the_data_axis(setup):
    """coherence_alpha='auto' selects on alpha_val trimmed to a multiple of
    the data axis (50 blocks over 4: 48); fewer blocks than the axis is
    refused at construction."""
    h, _ = tscm.generate_channels(torch.Generator().manual_seed(76), 103,
                                  tscm.ScmConfig(D, 1, n_coherence=4))
    mesh = pm.make_local_mesh(4, 2)
    svc = _service(setup, "dense", mesh, coherence_alpha="auto",
                   alpha_val=h[:50].numpy())
    seen = []
    estimate = svc._estimate_coherent

    def spy(entry, rb, alpha):
        seen.append(rb.shape[0])
        return estimate(entry, rb, alpha)

    svc._estimate_coherent = spy
    try:
        rb = tobs.observe(torch.Generator().manual_seed(77), h[50:98], SNR,
                          torch.as_tensor(setup[2]), 2,
                          tq.design_quantizer(SNR, 2)).numpy()
        out = svc.submit(rb, SNR, timeout=TIMEOUT)
        assert out.shape == (48, 4, D)
        assert (SNR, 4) in svc.metrics()["coherence_alpha_selected"]
        assert 48 in seen and 50 not in seen
    finally:
        svc.close(timeout=TIMEOUT)
    with pytest.raises(ValueError, match="data axis needs at least 4"):
        _service(setup, "dense", mesh, coherence_alpha="auto",
                 alpha_val=h[:3].numpy())


def test_mesh_service_refusals(setup, tmp_path):
    """A selection mode other than a dense bank's int top-k modes (a float
    cumulative-p mode, k = K), a bank that does not divide over the
    component axis, a data axis that is not a power of two (the microbatch
    pads are), a mesh on another device and a torch.distributed DeviceMesh
    are refused at construction; the factored 1-bit guard fires first."""
    mesh = pm.make_local_mesh(2, 2)
    for mode in (0.9, K):
        with pytest.raises(ValueError, match="mesh-backed"):
            _service(setup, "dense", mesh, mode=mode)
    with pytest.raises(ValueError, match="divide over the mesh's 3"):
        _service(setup, "dense", pm.make_local_mesh(1, 3))
    with pytest.raises(ValueError, match="power of two"):
        _service(setup, "dense", pm.make_local_mesh(3, 2))
    with pytest.raises(ValueError, match="shards are on"):
        _service(setup, "dense", pm.make_local_mesh(1, 2, device="meta"))
    with pytest.raises(ValueError, match="1-bit"):
        serving.EstimationService(setup[1], 1.0, 1, device="cpu",
                                  factored=True, mesh=object(), mode=1)
    with pytest.raises(ValueError, match="mesh-backed"):
        _service(setup, "structured", mesh, mode=2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="make_local_mesh"):
            _service(setup, "dense", pm.make_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="at least one shard"):
        pm.make_local_mesh(0, 2)
