"""The port's estimation service against the JAX direct estimators.

The single-device cases of `tests/test_serving.py`, on the CPU: the port's
`EstimationService` (device='cpu', so its kernel dispatch reaches the plain
versions of K1, K3 and K4, and of K6 and K7 for a structured service)
serves the JAX fit, carried over with `gmm.params_from_numpy`, and each
answer is held against the JAX direct estimator on the same observations
at atol 1e-4, as the JAX tests hold the JAX service (complex64 estimates,
float32 sums in another order). `VaeEstimationService` serves a VAE trained
by JAX (`vae_setup`) and is held against JAX's direct `vae.estimate`.
Every submit has a timeout of at most 30 s and every close a timeout, so a
hang fails one test.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import gmm as jg
from quantized_channel_estimation_tpu.models import gmm_estimator as jge
from quantized_channel_estimation_tpu.models import structured_bank as jsb
from quantized_channel_estimation_tpu.ops import observation as jobs
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as jscm
from quantized_channel_estimation_torch import serving
from quantized_channel_estimation_torch.estimators import circ_kernels as tck
from quantized_channel_estimation_torch.estimators import kernels as tkn
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import gmm as tg
from quantized_channel_estimation_torch.models import mfa_bank as tmb
from quantized_channel_estimation_torch.ops import quantizer as tq

torch.set_num_threads(2)

N_ANT = 16
TIMEOUT = 30.0


@pytest.fixture(scope="module")
def setup():
    h, _ = jscm.generate_channels(jax.random.PRNGKey(60), 6000,
                                  jscm.ScmConfig(N_ANT, 1))
    fit = jg.fit(jax.random.PRNGKey(61), h[:5000],
                 jg.GmmConfig(n_components=4, max_iter=10, chunk_size=2048))
    a = jp.pilot_matrix(N_ANT, 1, 2)
    params = tg.params_from_numpy([np.asarray(x) for x in fit.params])
    return fit.params, params, a, h[5000:]


def _service(setup, **kw):
    _, params, a, _ = setup
    kw.setdefault("max_delay_ms", 1.0)
    return serving.EstimationService(params, np.asarray(a), 2, device="cpu",
                                     **kw)


def _observe(setup, n, snr, key, t=None):
    _, _, a, h_val = setup
    h = h_val[:n * (t or 1)]
    if t:
        h = h.reshape(n, t, N_ANT)
    return np.asarray(jobs.observe(jax.random.PRNGKey(key), h, snr, a, 2,
                                   jq.design_quantizer(snr, 2)))


def _direct(setup, snr, r, mode="all", alpha=None):
    """The JAX direct estimator: einsum `estimate`, or `estimate_coherent`
    for blocks."""
    jparams, _, a, _ = setup
    bank = jge.prepare_bank(jparams, snr, a, 2, jq.design_quantizer(snr, 2))
    if r.ndim == 3:
        return np.asarray(jge.estimate_coherent(bank, jnp.asarray(r), mode,
                                                512, 1.0 if alpha is None
                                                else alpha))
    return np.asarray(jge.estimate(bank, jnp.asarray(r), mode))


def test_single_request_matches_direct(setup):
    r = _observe(setup, 100, 5.0, 62)
    svc = _service(setup)
    try:
        before = tkn.launch_counts()
        got = svc.submit(r, 5.0, timeout=TIMEOUT)
        np.testing.assert_allclose(got, _direct(setup, 5.0, r), atol=1e-4)
        assert got.shape == (100, N_ANT) and got.dtype == np.complex64
        assert svc.use_kernels and tkn.launch_counts() == before   # CPU
    finally:
        svc.close(timeout=TIMEOUT)


def test_bank_cache_lru_bounded(setup):
    r = _observe(setup, 8, 5.0, 65)
    svc = _service(setup, max_delay_ms=0.5, max_banks=3, snr_step_db=0.1)
    try:
        for snr in (0.0, 2.0, 4.0, 6.0, 8.0, 10.0):
            svc.submit(r, snr, timeout=TIMEOUT)
        assert len(svc._banks) == 3
        assert 10.0 in svc._banks and 0.0 not in svc._banks
        keys_before = set(svc._banks)
        svc.submit(r, 6.03, timeout=TIMEOUT)   # both snap to the 6.0 bank
        svc.submit(r, 5.97, timeout=TIMEOUT)
        assert set(svc._banks) == keys_before
    finally:
        svc.close(timeout=TIMEOUT)


def test_bank_lowered_once_per_layout(setup):
    """The kernel layout of a cached bank is built once per (T, alpha) and
    reused by later microbatches."""
    r = _observe(setup, 32, 5.0, 66)
    svc = _service(setup)
    try:
        svc.submit(r, 5.0, timeout=TIMEOUT)
        svc.submit(r.reshape(8, 4, N_ANT), 5.0, timeout=TIMEOUT)
        entry = svc._banks[5.0]
        assert set(entry.lowered) == {(1, 1.0), (4, 1.0)}
        kb = entry.lowered[(1, 1.0)]
        svc.submit(r, 5.0, timeout=TIMEOUT)
        assert svc._banks[5.0].lowered[(1, 1.0)] is kb
    finally:
        svc.close(timeout=TIMEOUT)


def test_queue_backpressure_sheds_load(setup):
    r = _observe(setup, 64, 5.0, 66)
    svc = _service(setup, max_delay_ms=10_000.0, max_batch=1 << 20,
                   max_queue=100)
    try:
        results = []
        th = threading.Thread(
            target=lambda: results.append(svc.submit(r, 5.0,
                                                     timeout=TIMEOUT)))
        th.start()
        time.sleep(0.05)   # the first 64 snapshots are queued
        with pytest.raises(serving.ServiceOverloadedError):
            svc.submit(r, 5.0, timeout=TIMEOUT)
        svc.max_delay = 0.001   # let the queued request complete
        th.join(timeout=TIMEOUT)
        assert not th.is_alive() and results[0].shape == (64, N_ANT)
        time.sleep(0.05)
        assert svc.submit(r, 5.0, timeout=TIMEOUT).shape == (64, N_ANT)
        assert svc.metrics()["requests_shed"] == 1
    finally:
        svc.close(timeout=TIMEOUT)


def test_concurrent_requests_coalesce(setup):
    r = _observe(setup, 320, 10.0, 63)
    svc = _service(setup, max_delay_ms=20.0)
    results = {}

    def worker(i):
        results[i] = svc.submit(r[i * 32:(i + 1) * 32], 10.0,
                                timeout=TIMEOUT)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        want = _direct(setup, 10.0, r)
        for i in range(10):
            np.testing.assert_allclose(results[i], want[i * 32:(i + 1) * 32],
                                       atol=1e-4)
        assert svc.metrics()["microbatches"] < 10   # requests were merged
    finally:
        svc.close(timeout=TIMEOUT)


def test_many_clients_keep_the_counters_consistent(setup):
    """More client threads than cores, with a short switch interval: every
    request completes and no counter update is lost."""
    r = _observe(setup, 4, 5.0, 64)
    svc = _service(setup, max_delay_ms=0.5)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    done = []

    def client():
        for _ in range(5):
            done.append(svc.submit(r, 5.0, timeout=TIMEOUT).shape)

    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        svc.close(timeout=TIMEOUT)
    m = svc.metrics()
    assert len(done) == 80
    assert m["requests_submitted"] == m["requests_completed"] == 80
    assert m["estimates_served"] == 80 * 4 and m["queue_depth_samples"] == 0


def test_oversized_request_microbatched(setup):
    r = _observe(setup, 700, 5.0, 65)
    svc = _service(setup, max_batch=256)
    try:
        got = svc.submit(r, 5.0, timeout=TIMEOUT)
        want = _direct(setup, 5.0, r)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert svc.metrics()["microbatches"] == 3   # 256 + 256 + 188
    finally:
        svc.close(timeout=TIMEOUT)


def test_malformed_request_fails_alone(setup):
    svc = _service(setup)
    try:
        with pytest.raises(ValueError, match="shape"):
            svc.submit(np.ones((4, 8), np.complex64), 5.0, timeout=TIMEOUT)
        with pytest.raises(ValueError, match="shape"):
            svc.submit(np.ones((N_ANT,), np.complex64), 5.0, timeout=TIMEOUT)
        r = _observe(setup, 8, 5.0, 66)
        assert svc.submit(r, 5.0, timeout=TIMEOUT).shape == (8, N_ANT)
    finally:
        svc.close(timeout=TIMEOUT)


def test_kernels_with_ineligible_selection_mode_rejected(setup):
    """use_kernels=True with a mode no kernel computes (float
    cumulative-p, k >= K) is refused instead of serving 'all' results."""
    with pytest.raises(ValueError, match="mode"):
        _service(setup, use_kernels=True, mode=0.9)
    with pytest.raises(ValueError, match="mode"):
        _service(setup, use_kernels=True, mode=4)   # K = 4: the 'all' combine


def test_flush_errors_propagate_to_clients(setup):
    _, _, _, h_val = setup
    svc = _service(setup)

    def boom(*args):
        raise ValueError("boom")

    svc._estimate = boom
    try:
        with pytest.raises(RuntimeError) as info:
            svc.submit(np.asarray(h_val[:8]), 5.0, timeout=10)
        assert isinstance(info.value.__cause__, ValueError)
        assert svc.metrics()["requests_failed"] == 1
    finally:
        svc.close(timeout=TIMEOUT)


def test_coherent_request_matches_direct(setup):
    rb = _observe(setup, 24, 0.0, 70, t=4)
    svc = _service(setup)
    try:
        got = svc.submit(rb, 0.0, timeout=TIMEOUT)
        assert got.shape == (24, 4, N_ANT)
        np.testing.assert_allclose(got, _direct(setup, 0.0, rb), atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("use_kernels", [None, False])
def test_mixed_t_requests_isolated(setup, use_kernels):
    """Flat, T=2 and T=4 requests at one SNR are queued apart (a block
    never co-batches with another T), each matching its direct path."""
    r = _observe(setup, 64, 5.0, 72)
    svc = _service(setup, max_delay_ms=10.0, use_kernels=use_kernels)
    jobs_ = {"flat": r[:16], "t2": r[:32].reshape(16, 2, -1),
             "t4": r[:64].reshape(16, 4, -1)}
    results = {}

    def worker(name, arr):
        results[name] = svc.submit(arr, 5.0, timeout=TIMEOUT)

    try:
        threads = [threading.Thread(target=worker, args=(n, v))
                   for n, v in jobs_.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
            assert not th.is_alive()
        for name, arr in jobs_.items():
            np.testing.assert_allclose(results[name],
                                       _direct(setup, 5.0, arr), atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


def test_coherent_malformed_rejected(setup):
    svc = _service(setup)
    try:
        for bad in (np.zeros((4, 2, N_ANT + 1), np.complex64),
                    np.zeros((4, 0, N_ANT), np.complex64),
                    np.zeros((2, 2, 2, N_ANT), np.complex64)):
            with pytest.raises(ValueError):
                svc.submit(bad, 5.0, timeout=TIMEOUT)
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("alpha", [0.0, 0.25])
def test_coherent_alpha_service(setup, alpha):
    """coherence_alpha reaches the block path: alpha = 0 serves the
    independent per-snapshot estimates, 0.25 the leave-one-out blend."""
    rb = _observe(setup, 16, 0.0, 95, t=4)
    svc = _service(setup, coherence_alpha=alpha)
    try:
        got = svc.submit(rb, 0.0, timeout=TIMEOUT)
        np.testing.assert_allclose(got, _direct(setup, 0.0, rb, alpha=alpha),
                                   atol=1e-4)
        if alpha == 0.0:
            flat = _direct(setup, 0.0, rb.reshape(-1, N_ANT))
            np.testing.assert_allclose(got.reshape(-1, N_ANT), flat,
                                       atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


def test_auto_alpha_service(setup):
    """'auto' selects once per (SNR, T) from the grid, and the served
    result matches the direct estimator at the selected alpha."""
    _, _, a, _ = setup
    h_blocks, _ = jscm.generate_channels(
        jax.random.PRNGKey(73), 300, jscm.ScmConfig(N_ANT, 1, n_coherence=4))
    rb = np.asarray(jobs.observe(jax.random.PRNGKey(77), h_blocks[:200], 0.0,
                                 a, 2, jq.design_quantizer(0.0, 2)))
    svc = _service(setup, coherence_alpha="auto",
                   alpha_val=np.asarray(h_blocks[200:]))
    try:
        got = svc.submit(rb, 0.0, timeout=TIMEOUT)
        sel = svc.metrics()["coherence_alpha_selected"]
        assert list(sel) == [(0.0, 4)]
        alpha = sel[(0.0, 4)]
        assert alpha in jge.DEFAULT_ALPHA_GRID
        np.testing.assert_allclose(got, _direct(setup, 0.0, rb, alpha=alpha),
                                   atol=1e-4)
        with pytest.raises(RuntimeError) as info:    # T differs from alpha_val
            svc.submit(rb[:, :2], 0.0, timeout=TIMEOUT)
        assert "alpha_val" in str(info.value.__cause__)
    finally:
        svc.close(timeout=TIMEOUT)


def test_auto_alpha_requires_val_blocks(setup):
    with pytest.raises(ValueError, match="alpha_val"):
        _service(setup, coherence_alpha="auto")
    with pytest.raises(ValueError, match="alpha_val"):
        _service(setup, coherence_alpha="auto",
                 alpha_val=np.zeros((4, N_ANT), np.complex64))
    with pytest.raises(ValueError, match="float or 'auto'"):
        _service(setup, coherence_alpha="best")


def test_close_drains_queued_requests(setup):
    r = _observe(setup, 64, 5.0, 70)
    svc = _service(setup, max_delay_ms=60_000.0)
    results = {}

    def client(i):
        results[i] = svc.submit(r, 5.0, timeout=TIMEOUT)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)   # let the requests queue
    svc.close(drain=True, timeout=TIMEOUT)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert set(results) == {0, 1, 2}
    for i in range(3):
        np.testing.assert_allclose(results[i], _direct(setup, 5.0, r),
                                   atol=1e-4)
    m = svc.metrics()
    assert m["requests_completed"] == 3 and m["queue_depth_samples"] == 0
    assert not svc._thread.is_alive()


def test_close_fail_fast(setup):
    r = _observe(setup, 16, 5.0, 71)
    svc = _service(setup, max_delay_ms=60_000.0)
    errs = {}

    def client(i):
        try:
            svc.submit(r, 5.0, timeout=TIMEOUT)
            errs[i] = None
        except serving.ServiceClosedError as e:
            errs[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    svc.close(drain=False, timeout=TIMEOUT)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert len(errs) == 2 and all(
        isinstance(e, serving.ServiceClosedError) for e in errs.values())
    with pytest.raises(serving.ServiceClosedError):
        svc.submit(r, 5.0, timeout=TIMEOUT)
    assert svc.metrics()["requests_failed"] == 2


def test_metrics_surface(setup):
    r = _observe(setup, 32, 5.0, 72)
    svc = _service(setup)
    try:
        for _ in range(3):
            svc.submit(r, 5.0, timeout=TIMEOUT)
        svc.submit(r, 10.0, timeout=TIMEOUT)
        m = svc.metrics()
        assert set(m) == {
            "requests_submitted", "requests_completed", "requests_failed",
            "requests_shed", "estimates_served", "microbatches",
            "bank_cache_hits", "bank_cache_misses", "banks_cached",
            "queue_depth_samples", "latency_count", "latency_mean_s",
            "latency_p50_s", "latency_p99_s", "coherence_alpha_selected"}
        assert m["requests_submitted"] == m["requests_completed"] == 4
        assert m["estimates_served"] == 4 * 32
        assert m["bank_cache_misses"] == 2 and m["banks_cached"] == 2
        assert m["latency_count"] == 4
        assert m["latency_p99_s"] >= m["latency_p50_s"] > 0
        assert m["requests_failed"] == 0 and m["requests_shed"] == 0
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("mode,use_kernels", [(1, True), (2, None),
                                              (2, False), (0.9, None)])
def test_selection_modes_match_direct(setup, mode, use_kernels):
    """int top-k modes serve through K4 (its plain version here) unless
    use_kernels=False; float cumulative-p through the einsum estimator;
    selection modes on blocks through the einsum coherent estimator."""
    r = _observe(setup, 64, 5.0, 66)
    svc = _service(setup, mode=mode, use_kernels=use_kernels)
    try:
        assert svc.use_kernels == (isinstance(mode, int)
                                   and use_kernels is not False)
        np.testing.assert_allclose(svc.submit(r, 5.0, timeout=TIMEOUT),
                                   _direct(setup, 5.0, r, mode), atol=1e-4)
        rb = r.reshape(16, 4, N_ANT)
        np.testing.assert_allclose(svc.submit(rb, 5.0, timeout=TIMEOUT),
                                   _direct(setup, 5.0, rb, mode), atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


# ------------------------------------------------- the structured service

@pytest.fixture(scope="module")
def circ_setup():
    """A JAX circulant fit and a block-circulant (4, 4) one on the same
    channels, with the pilot matrix and held-out channels."""
    h, _ = jscm.generate_channels(jax.random.PRNGKey(90), 6000,
                                  jscm.ScmConfig(N_ANT, 1))
    fits = {}
    for blocks in (None, (4, 4)):
        fits[blocks] = jg.fit(
            jax.random.PRNGKey(91), h[:5000], jg.GmmConfig(
                n_components=4, max_iter=12, chunk_size=2048, blocks=blocks,
                cov_type="circulant" if blocks is None
                else "block-circulant")).params
    return fits, jp.pilot_matrix(N_ANT, 1, 2), h[5000:]


def _circ_service(circ_setup, blocks=None, **kw):
    fits, a, _ = circ_setup
    kw.setdefault("max_delay_ms", 1.0)
    return serving.EstimationService(
        tg.params_from_numpy([np.asarray(x) for x in fits[blocks]]),
        np.asarray(a), 2, device="cpu", structured=True,
        structured_blocks=blocks, **kw)


def _circ_observe(circ_setup, n, snr, key, t=None):
    _, a, h_val = circ_setup
    h = h_val[:n * (t or 1)]
    if t:
        h = h.reshape(n, t, N_ANT)
    return np.asarray(jobs.observe(jax.random.PRNGKey(key), h, snr, a, 2,
                                   jq.design_quantizer(snr, 2)))


def _circ_direct(circ_setup, snr, r, mode="all", alpha=1.0, blocks=None,
                 spectra=None):
    """The JAX direct structured estimator (its FFT pipeline)."""
    fits, a, _ = circ_setup
    bank = jsb.prepare_bank_circulant(
        fits[blocks], snr, a, 2, jq.design_quantizer(snr, 2), blocks=blocks,
        spectra=spectra)
    if r.ndim == 3:
        return np.asarray(jsb.estimate_circulant_coherent(
            bank, jnp.asarray(r), mode, 4096, alpha, blocks, "fft"))
    return np.asarray(jsb.estimate_circulant(bank, jnp.asarray(r), mode,
                                             16384, blocks, "fft"))


@pytest.mark.parametrize("blocks", [None, (4, 4)])
def test_structured_service_matches_jax_direct(circ_setup, blocks):
    """structured=True serves through the FFT-domain bank: flat requests
    through K6 and blocks through K7 (their plain versions here), equal to
    the JAX structured estimator, and on these (block-)circulant fits to
    the JAX dense one (atol 2e-4, as `tests/test_serving.py` holds it)."""
    fits, a, _ = circ_setup
    r = _circ_observe(circ_setup, 100, 5.0, 92)
    rb = r[:96].reshape(24, 4, N_ANT)
    svc = _circ_service(circ_setup, blocks)
    try:
        assert svc.use_kernels and svc.structured
        before = tkn.launch_counts()
        got = svc.submit(r, 5.0, timeout=TIMEOUT)
        got_b = svc.submit(rb, 5.0, timeout=TIMEOUT)
        assert tkn.launch_counts() == before                    # the CPU
        assert got.shape == (100, N_ANT) and got.dtype == np.complex64
        np.testing.assert_allclose(
            got, _circ_direct(circ_setup, 5.0, r, blocks=blocks), atol=1e-4)
        np.testing.assert_allclose(
            got_b, _circ_direct(circ_setup, 5.0, rb, blocks=blocks),
            atol=1e-4)
        dense = jge.prepare_bank(fits[blocks], 5.0, a, 2,
                                 jq.design_quantizer(5.0, 2))
        np.testing.assert_allclose(
            got, np.asarray(jge.estimate(dense, jnp.asarray(r))), atol=2e-4)
        np.testing.assert_allclose(
            got_b, np.asarray(jge.estimate_coherent(dense, jnp.asarray(rb))),
            atol=2e-4)
        # the kernel layouts are lowered once per (blocks, T, alpha)
        entry = svc._banks[5.0]
        assert isinstance(entry.bank, tck.CirculantBank)
        assert set(entry.lowered) == {(blocks, 1, 1.0), (blocks, 4, 1.0)}
        ckb = entry.lowered[(blocks, 1, 1.0)]
        svc.submit(r, 5.0, timeout=TIMEOUT)
        assert svc._banks[5.0].lowered[(blocks, 1, 1.0)] is ckb
        assert svc.metrics()["requests_failed"] == 0
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("mode,use_kernels", [(1, None), (2, False),
                                              (0.9, None), ("all", False)])
def test_structured_service_selection_modes(circ_setup, mode, use_kernels):
    """Selection modes, and 'all' without the kernels, take the
    `torch.fft` pipeline, flat and on blocks."""
    r = _circ_observe(circ_setup, 64, 5.0, 66)
    svc = _circ_service(circ_setup, mode=mode, use_kernels=use_kernels)
    try:
        assert not svc.use_kernels
        np.testing.assert_allclose(svc.submit(r, 5.0, timeout=TIMEOUT),
                                   _circ_direct(circ_setup, 5.0, r, mode),
                                   atol=1e-4)
        rb = r.reshape(16, 4, N_ANT)
        np.testing.assert_allclose(svc.submit(rb, 5.0, timeout=TIMEOUT),
                                   _circ_direct(circ_setup, 5.0, rb, mode),
                                   atol=1e-4)
        assert svc._banks[5.0].lowered == {}
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("alpha", [0.0, 0.25, "auto"])
def test_structured_service_coherence_alpha(circ_setup, alpha):
    """The alpha blend reaches K7, and 'auto' selects through the
    structured coherent estimator."""
    _, a, _ = circ_setup
    h_blocks, _ = jscm.generate_channels(
        jax.random.PRNGKey(97), 200, jscm.ScmConfig(N_ANT, 1, n_coherence=4))
    rb = np.asarray(jobs.observe(jax.random.PRNGKey(98), h_blocks[:120], 0.0,
                                 a, 2, jq.design_quantizer(0.0, 2)))
    kw = dict(alpha_val=np.asarray(h_blocks[120:])) if alpha == "auto" else {}
    svc = _circ_service(circ_setup, coherence_alpha=alpha, **kw)
    try:
        got = svc.submit(rb, 0.0, timeout=TIMEOUT)
        if alpha == "auto":
            sel = svc.metrics()["coherence_alpha_selected"]
            assert list(sel) == [(0.0, 4)]
            alpha = sel[(0.0, 4)]
            assert alpha in jge.DEFAULT_ALPHA_GRID
        np.testing.assert_allclose(
            got, _circ_direct(circ_setup, 0.0, rb, alpha=alpha), atol=1e-4)
        if alpha == 0.0:
            np.testing.assert_allclose(
                got.reshape(-1, N_ANT),
                _circ_direct(circ_setup, 0.0, rb.reshape(-1, N_ANT)),
                atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("pilot", ["matrix", "scalar"])
def test_from_circulant_spectra_service(circ_setup, pilot):
    """A spectra-native prior serves with no dense covariance anywhere:
    equal to the JAX structured estimator prepared from the same spectra,
    flat and on blocks, with the (M, M) pilot matrix or its scalar."""
    fits, a, _ = circ_setup
    p = fits[None]
    spectra = np.asarray(jsb.spectra_from_params(p))
    x0 = np.asarray(a)[0, 0]
    svc = serving.EstimationService.from_circulant_spectra(
        np.asarray(p.weights), np.asarray(p.means), spectra,
        np.asarray(a) if pilot == "matrix" else x0, 2, max_delay_ms=1.0,
        device="cpu")
    r = _circ_observe(circ_setup, 64, 5.0, 101)
    rb = r.reshape(16, 4, N_ANT)
    try:
        assert svc.structured and svc.use_kernels
        assert svc.params.covariances.shape == (4, 1, 1)
        np.testing.assert_allclose(
            svc.submit(r, 5.0, timeout=TIMEOUT),
            _circ_direct(circ_setup, 5.0, r, spectra=jnp.asarray(spectra)),
            atol=1e-4)
        np.testing.assert_allclose(
            svc.submit(rb, 5.0, timeout=TIMEOUT),
            _circ_direct(circ_setup, 5.0, rb, spectra=jnp.asarray(spectra)),
            atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


def test_spectra_fit_serves_like_the_densified_dense_service():
    """A CSI-free spectra-native fit (`gmm_quant.fit_circulant_spectra` on
    2-bit pilots at 5 dB) served through `from_circulant_spectra`, with no
    dense covariance anywhere, equals the dense service of the densified
    spectra, F^H diag(s) F + 1e-5 I (JAX `test_from_circulant_spectra_service`,
    atol 2e-3)."""
    from quantized_channel_estimation_torch.models import gmm_quant as tgq
    from quantized_channel_estimation_torch.ops import linalg as tl
    from quantized_channel_estimation_torch.ops import quantizer as tq
    h, _ = jscm.generate_channels(jax.random.PRNGKey(98), 7064,
                                  jscm.ScmConfig(N_ANT, 1))
    snr, a, q = 5.0, jp.pilot_matrix(N_ANT, 1, 2), jq.design_quantizer(5.0, 2)
    r_train, r = (np.asarray(jobs.observe(jax.random.PRNGKey(k), rows, snr,
                                          a, 2, q))
                  for k, rows in ((99, h[:7000]), (101, h[7000:])))
    res = tgq.fit_circulant_spectra(
        torch.Generator().manual_seed(100), torch.as_tensor(r_train),
        tg.GmmConfig(n_components=4, cov_type="circulant", max_iter=10,
                     chunk_size=2048), 2, 10 ** (-snr / 10),
        tq.design_quantizer(snr, 2))
    f = tl.unitary_dft(N_ANT)
    covs = tl.hermitize(torch.einsum("fd,kf,fe->kde", f.conj(),
                                     res.spectra.to(f.dtype), f))
    covs = tl.add_jitter(covs, 1e-5)
    dense = tg.GmmParams(res.weights, res.means, covs,
                         tl.robust_precision_cholesky(covs))
    svcs = [serving.EstimationService.from_circulant_spectra(
                res.weights.numpy(), res.means.numpy(), res.spectra.numpy(),
                np.asarray(a), 2, max_delay_ms=1.0, device="cpu"),
            serving.EstimationService(dense, np.asarray(a), 2,
                                      max_delay_ms=1.0, device="cpu")]
    try:
        assert svcs[0].structured and not svcs[1].structured
        assert svcs[0].params.covariances.shape == (4, 1, 1)
        got, want = (svc.submit(r, snr, timeout=TIMEOUT) for svc in svcs)
    finally:
        for svc in svcs:
            svc.close(timeout=TIMEOUT)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("blocks,how", [(None, "params"), ((4, 4), "params"),
                                        (None, "spectra")])
def test_structured_service_multipilot_matches_jax_direct(circ_setup, blocks,
                                                          how):
    """A kron(x, I) matrix of P = 2 pilots: the structured service prepares
    the per-bin P x P bank and serves flat (n, P*D) requests through K10
    and (n, T, P*D) blocks through its coherent form (their plain versions
    here), equal to the JAX structured estimator of the same matrix (atol
    1e-4); `from_circulant_spectra` does so with no dense covariance."""
    fits, a1, h_val = circ_setup
    x = np.array([[1.0], [-1.0j]], np.complex64)
    a = np.kron(x, np.asarray(a1)).astype(np.complex64)
    spectra = np.asarray(jsb.spectra_from_params(fits[blocks], blocks))
    r = np.asarray(jobs.observe(jax.random.PRNGKey(93), h_val[:100], 5.0,
                                jnp.asarray(a), 2,
                                jq.design_quantizer(5.0, 2)))
    assert r.shape == (100, 2 * N_ANT)
    rb = r[:96].reshape(24, 4, 2 * N_ANT)
    if how == "spectra":
        p = fits[blocks]
        svc = serving.EstimationService.from_circulant_spectra(
            np.asarray(p.weights), np.asarray(p.means), spectra, a, 2,
            max_delay_ms=1.0, device="cpu")
    else:
        svc = serving.EstimationService(
            tg.params_from_numpy([np.asarray(v) for v in fits[blocks]]), a,
            2, device="cpu", structured=True, structured_blocks=blocks,
            max_delay_ms=1.0, use_kernels=True)
    jbank = jsb.prepare_bank_circulant(
        fits[blocks], 5.0, jnp.asarray(a), 2, jq.design_quantizer(5.0, 2),
        blocks=blocks, spectra=jnp.asarray(spectra) if how == "spectra"
        else None)
    try:
        assert svc.use_kernels and svc.structured
        before = tkn.launch_counts()
        got = svc.submit(r, 5.0, timeout=TIMEOUT)
        got_b = svc.submit(rb, 5.0, timeout=TIMEOUT)
        assert tkn.launch_counts() == before                    # the CPU
        assert got.shape == (100, N_ANT) and got_b.shape == (24, 4, N_ANT)
        np.testing.assert_allclose(got, np.asarray(jsb.estimate_circulant(
            jbank, jnp.asarray(r), "all", 16384, blocks, "xla")), atol=1e-4)
        np.testing.assert_allclose(
            got_b, np.asarray(jsb.estimate_circulant_coherent(
                jbank, jnp.asarray(rb), "all", 4096, 1.0, blocks, "xla")),
            atol=1e-4)
        entry = svc._banks[5.0]
        assert isinstance(entry.bank, serving.CirculantBankMP)
        assert set(entry.lowered) == {(blocks, 1, 1.0), (blocks, 4, 1.0)}
        with pytest.raises(ValueError, match="observations must have shape"):
            svc.submit(r[:, :N_ANT], 5.0, timeout=TIMEOUT)
        assert svc.metrics()["requests_failed"] == 0
    finally:
        svc.close(timeout=TIMEOUT)


def test_structured_service_refusals(circ_setup):
    fits, a, _ = circ_setup
    params = tg.params_from_numpy([np.asarray(x) for x in fits[None]])
    with pytest.raises(ValueError, match="mode='all'"):
        _circ_service(circ_setup, mode=1, use_kernels=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _circ_service(circ_setup, factored=True)
    with pytest.raises(ValueError, match="kron"):
        serving.EstimationService(params, np.ones((N_ANT, N_ANT)), 2,
                                  device="cpu", structured=True)
    svc = _circ_service(circ_setup, mode="all", use_kernels=True)  # accepted
    svc.close(timeout=TIMEOUT)
    # 48 pilots at D = 16 are past the template's shared memory: K10's
    # wide form takes them
    wide = np.kron(np.ones((48, 1)), np.asarray(a))
    svc = serving.EstimationService(params, wide, 2, device="cpu",
                                    structured=True)
    assert svc.use_kernels
    svc.close(timeout=TIMEOUT)
    # 294 pilots at D = 16 are past the wide form's scratch (128 rows of
    # their features): served through the `torch.fft` pipeline unless the
    # kernels are demanded
    past = np.kron(np.ones((294, 1)), np.asarray(a))
    with pytest.raises(ValueError, match="circulant kernels' range"):
        serving.EstimationService(params, past, 2, device="cpu",
                                  structured=True, use_kernels=True)
    svc = serving.EstimationService(params, past, 2, device="cpu",
                                    structured=True)
    assert not svc.use_kernels
    svc.close(timeout=TIMEOUT)


VAE_SNRS = (-5.0, 5.0, 15.0)


@pytest.fixture(scope="module")
def vae_setup(setup):
    """A noisy VAE trained by JAX (2 epochs of 5 steps at D = 16) and its
    port: (jax cfg, jax model, jax state, port cfg, port model, params)."""
    from quantized_channel_estimation_tpu.models import vae as jv
    from quantized_channel_estimation_torch.models import vae as tv
    _, _, a, h_val = setup
    kw = dict(n_antennas=N_ANT, latent_dim=4, n_layers=2, vae_mode="noisy",
              batch_size=200, epochs=2, steps_per_epoch=5)
    jcfg = jv.VaeConfig(**kw)
    jmodel, jstate, _ = jv.train(
        jax.random.PRNGKey(81), jcfg, h_val, a, VAE_SNRS,
        [jq.design_quantizer(s, 2) for s in VAE_SNRS], verbose=False)
    tcfg = tv.VaeConfig(**kw)
    params = tv.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tcfg)
    return jcfg, jmodel, jstate, tcfg, tv.DnnVae(tcfg), params


def _jax_vae(vae_setup, r, snr, t=1):
    from quantized_channel_estimation_tpu.models import vae as jv
    jcfg, jmodel, jstate, _, _, _ = vae_setup
    out = jv.estimate(jmodel, jstate.params, jcfg,
                      jnp.asarray(r.reshape(-1, N_ANT)), snr,
                      jp.pilot_matrix(N_ANT, 1, 2),
                      jq.design_quantizer(snr, 2), coherence=t)
    return np.asarray(out).reshape(r.shape)


def _vae_service_matches_jax(setup, vae_setup):
    _, _, _, tcfg, tmodel, params = vae_setup
    _, _, a, _ = setup
    svc = serving.VaeEstimationService(tmodel, params, tcfg, np.asarray(a),
                                       max_delay_ms=1.0, device="cpu")
    try:
        assert svc.structured        # A = x0 I: the per-sample circulant
        r = _observe(setup, 64, 5.0, 74)
        for req, t in ((r, 1), (r.reshape(16, 4, N_ANT), 4)):
            got = svc.submit(req, 5.0, timeout=TIMEOUT)
            assert got.shape == req.shape and got.dtype == np.complex64
            np.testing.assert_allclose(got, _jax_vae(vae_setup, req, 5.0, t),
                                       atol=1e-4)
        m = svc.metrics()
        assert m["requests_failed"] == 0 and m["requests_completed"] == 2
        assert m["banks_cached"] == 1
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("pilot", ["matrix", "scalar", "two_pilots",
                                   "dense"])
def test_vae_service_pilots_and_structure(setup, vae_setup, pilot):
    """'auto' takes the circulant path for A = x0 I (a matrix or a scalar
    x0) and the dense per-sample solve otherwise (two pilots; or asked);
    every path answers as the port's direct `vae.estimate` (atol 1e-5)
    and, for one pilot, as JAX's (atol 1e-4)."""
    from quantized_channel_estimation_torch.models import vae as tv
    from quantized_channel_estimation_torch.ops import pilots as tp
    _, _, _, tcfg, tmodel, params = vae_setup
    two = pilot == "two_pilots"
    cfg = tcfg._replace(n_pilots=2, n_pilot_convs=1) if two else tcfg
    model = tv.DnnVae(cfg) if two else tmodel
    if two:
        _, st = tv.init_vae(torch.Generator().manual_seed(5), cfg)
        params = st.params
    a = tp.pilot_matrix(N_ANT, 2 if two else 1, 2)
    a_arg = {"scalar": a[0, 0]}.get(pilot, a)
    svc = serving.VaeEstimationService(
        model, params, cfg, a_arg, max_delay_ms=1.0, device="cpu",
        **({"structured": False} if pilot == "dense" else {}))
    try:
        assert svc.structured == (pilot in ("matrix", "scalar"))
        _, _, _, h_val = setup
        q = tq.design_quantizer(15.0, 2)
        r = tst.observe(torch.Generator().manual_seed(75),
                        torch.as_tensor(np.asarray(h_val[:48])), 15.0, a, 2,
                        q).numpy()
        got = svc.submit(r, 15.0, timeout=TIMEOUT)
        want = tv.estimate(model, params, cfg, torch.as_tensor(r), 15.0, a,
                           q, structured=svc.structured)
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5)
        if not two:
            np.testing.assert_allclose(got, _jax_vae(vae_setup, r, 15.0),
                                       atol=1e-4)
        with pytest.raises(ValueError, match="observations must have"):
            svc.submit(r[:, :N_ANT - 1], 15.0, timeout=TIMEOUT)
    finally:
        svc.close(timeout=TIMEOUT)


def test_vae_service_refuses_genie_and_needs_a_device(vae_setup,
                                                      monkeypatch):
    _, _, _, tcfg, tmodel, params = vae_setup
    a = np.eye(N_ANT, dtype=np.complex64)
    with pytest.raises(ValueError, match="genie-aided"):
        serving.VaeEstimationService(tmodel, params,
                                     tcfg._replace(vae_mode="genie"), a,
                                     device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.VaeEstimationService(tmodel, params, tcfg, a)


@pytest.mark.parametrize("make,item", [
    (lambda p, a: serving.EstimationService(p, a, 2, device="cpu",
                                            mesh=object()),
     "mesh-backed serving.*Queue 1 item 15"),
    (lambda p, a: serving.EstimationService(p, a, 2, device="cpu",
                                            structured=True, mesh=object()),
     "mesh-backed serving.*Queue 1 item 15"),
    (lambda p, a: serving.EstimationService(p, a, 2, device="cpu",
                                            factored=True, mesh=object()),
     "mesh-backed serving.*Queue 1 item 15"),
    (lambda p, a: serving.EstimationService.from_mfa(p, a, 2, device="cpu",
                                                     mesh=object()),
     "mesh-backed serving.*Queue 1 item 15"),
    (lambda p, a: serving.VaeEstimationService(None, p, None, a),
     "VaeEstimationService.*Queue 1 item 13"),
])
def test_unported_options_raise(setup, make, item, request):
    """Options of later slices raise naming their ROADMAP item. Item 15
    (the service's `mesh=`) is ported: each of its cases builds that
    service over an in-process mesh instead (the dense and structured
    banks of the JAX fit, the factored bank of the seeded MFA prior) and
    holds its flat and T = 4 answers against the one-device service and
    the JAX direct estimator (atol 1e-4); a mesh that is not a
    `LocalMesh` is refused. Item 13 (the VAE) is ported: its case serves
    the JAX-trained VAE (`vae_setup`) and holds the flat and T = 4 answers
    against JAX's direct `vae.estimate` (atol 1e-4)."""
    _, params, a, _ = setup
    if "item 13" in item:
        _vae_service_matches_jax(setup, request.getfixturevalue("vae_setup"))
        return
    if "item 15" not in item:
        with pytest.raises(NotImplementedError, match=item):
            make(params, np.asarray(a))
        return
    with pytest.raises(ValueError, match="make_local_mesh"):
        make(params, np.asarray(a))
    case = request.node.callspec.indices["make"]
    from quantized_channel_estimation_torch.parallel import mesh as pm
    mesh = pm.make_local_mesh(*((4, 2), (1, 2), (2, 2), (1, 4))[case])
    if case < 2:
        kw = dict(structured=case == 1, max_delay_ms=1.0, device="cpu")
        one = serving.EstimationService(params, np.asarray(a), 2, **kw)
        svc = serving.EstimationService(params, np.asarray(a), 2, mesh=mesh,
                                        **kw)
        r = _observe(setup, 64, 5.0, 74)
        if case == 0:
            want = [_direct(setup, 5.0, r),
                    _direct(setup, 5.0, r.reshape(16, 4, N_ANT))]
        else:
            jparams = setup[0]
            bank = jsb.prepare_bank_circulant(jparams, 5.0, a, 2,
                                              jq.design_quantizer(5.0, 2))
            want = [np.asarray(jsb.estimate_circulant(
                        bank, jnp.asarray(r), "all", 16384, None, "fft")),
                    np.asarray(jsb.estimate_circulant_coherent(
                        bank, jnp.asarray(r).reshape(16, 4, N_ANT), "all",
                        4096, 1.0, None, "fft"))]
    else:
        mparams, jmparams, r = request.getfixturevalue("mfa_setup")
        kw = dict(max_delay_ms=1.0, device="cpu")
        if case == 2:
            one = serving.EstimationService(mparams, MFA_X0, 2, factored=True,
                                            **kw)
            svc = serving.EstimationService(mparams, MFA_X0, 2, factored=True,
                                            mesh=mesh, **kw)
        else:
            one = serving.EstimationService.from_mfa(mparams, MFA_X0, 2, **kw)
            svc = serving.EstimationService.from_mfa(mparams, MFA_X0, 2,
                                                     mesh=mesh, **kw)
        r = r[:64]
        want = [_jax_factored(jmparams, r),
                _jax_factored(jmparams, r.reshape(16, 4, MFA_D), alpha=1.0)]
    try:
        assert svc.mesh is mesh and svc.use_kernels
        for req, ref in zip((r, r.reshape(16, 4, -1)), want):
            got = svc.submit(req, 5.0 if case < 2 else 10.0, timeout=TIMEOUT)
            np.testing.assert_allclose(got, ref, atol=1e-4)
            np.testing.assert_allclose(
                got, one.submit(req, 5.0 if case < 2 else 10.0,
                                timeout=TIMEOUT), atol=1e-4)
        assert svc.metrics()["requests_failed"] == 0
    finally:
        one.close(timeout=TIMEOUT)
        svc.close(timeout=TIMEOUT)


def test_service_needs_a_card_or_an_explicit_device(setup, monkeypatch):
    _, params, a, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.EstimationService(params, np.asarray(a), 2)


# ---------------------------------------------------------------------------
# MFA priors: the factored (Woodbury) bank
# ---------------------------------------------------------------------------

MFA_D, MFA_M, MFA_K = 32, 6, 8
MFA_X0 = 0.7 - 0.2j


@pytest.fixture(scope="module")
def mfa_setup():
    """Seeded MFA parameters (numpy, as the JAX tests draw them in
    `tests/test_mfa_bank.py`) and 256 observations from the mixture, 2-bit
    at 10 dB under x0 I."""
    from quantized_channel_estimation_tpu.models import mfa as jmfa
    rng = np.random.default_rng(7)

    def cr(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    lam = (0.5 * cr(MFA_K, MFA_D, MFA_M)).astype(np.complex64)
    psis = (0.1 + rng.uniform(size=(MFA_K, MFA_D))).astype(np.float32)
    means = (0.3 * cr(MFA_K, MFA_D)).astype(np.complex64)
    w = (rng.uniform(size=MFA_K) + 0.1).astype(np.float32)
    params = (w / w.sum(), means, lam, psis)
    comp = rng.integers(0, MFA_K, 256)
    h = (means[comp] + np.einsum("ndm,nm->nd", lam[comp], cr(256, MFA_M))
         + np.sqrt(psis[comp]) * cr(256, MFA_D))
    y = (MFA_X0 * h + np.sqrt(0.1) * cr(256, MFA_D)).astype(np.complex64)
    r = np.array(jq.quantize(jnp.asarray(y), 2, jq.design_quantizer(10.0,
                                                                    2)))
    return params, jmfa.MfaParams(*(jnp.asarray(x) for x in params)), r


def _jax_factored(jparams, r, mode="all", alpha=None):
    from quantized_channel_estimation_tpu.models import mfa_bank as jmb
    bank = jmb.prepare_bank_factored(jparams, 10.0, MFA_X0, 2,
                                     jq.design_quantizer(10.0, 2))
    if r.ndim == 3:
        return np.asarray(jmb.estimate_factored_coherent(
            bank, jnp.asarray(r), mode, 1024, alpha, "xla"))
    return np.asarray(jmb.estimate_factored(bank, jnp.asarray(r), mode,
                                            4096, "xla"))


def test_from_mfa_serves_the_factored_bank(mfa_setup):
    """`from_mfa` defaults to the factored bank for n-bit under x0 I and
    serves the JAX factored estimate (and the JAX dense one) to atol
    1e-4, flat requests through the plain K11, its layout lowered once."""
    from quantized_channel_estimation_tpu.models import mfa as jmfa
    params, jparams, r = mfa_setup
    svc = serving.EstimationService.from_mfa(params, MFA_X0, 2,
                                             max_delay_ms=1.0, device="cpu")
    try:
        assert svc.factored and svc.use_kernels
        got = svc.submit(r[:64], 10.0, timeout=TIMEOUT)
        np.testing.assert_allclose(got, _jax_factored(jparams, r[:64]),
                                   atol=1e-4)
        a = jnp.asarray(MFA_X0, jnp.complex64) * jnp.eye(MFA_D,
                                                         dtype=jnp.complex64)
        dense = jge.prepare_bank(jmfa.to_gmm_params(jparams), 10.0, a, 2,
                                 jq.design_quantizer(10.0, 2))
        np.testing.assert_allclose(
            got, np.asarray(jge.estimate(dense, jnp.asarray(r[:64]), "all")),
            atol=1e-4)
        svc.submit(r[64:96], 10.0, timeout=TIMEOUT)
        entry = svc._banks[svc._snap(10.0)]
        assert isinstance(entry.bank, tmb.FactoredBank)
        assert set(entry.lowered) == {(1, 1.0)}
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_from_mfa_serves_coherent_blocks(mfa_setup, alpha):
    params, jparams, r = mfa_setup
    rb = r[:64].reshape(16, 4, MFA_D)
    svc = serving.EstimationService.from_mfa(
        params, MFA_X0, 2, max_delay_ms=1.0, coherence_alpha=alpha,
        device="cpu")
    try:
        got = svc.submit(rb, 10.0, timeout=TIMEOUT)
        np.testing.assert_allclose(got, _jax_factored(jparams, rb,
                                                      alpha=alpha),
                                   atol=1e-4)
    finally:
        svc.close(timeout=TIMEOUT)


@pytest.mark.parametrize("mode,use_kernels", [(1, None), (0.9, False),
                                              ("all", False)])
def test_factored_service_pipeline_modes(mfa_setup, mode, use_kernels):
    """Selection modes (and use_kernels=False) take the `torch.matmul`
    pipeline; the answers are the JAX pipeline's."""
    params, jparams, r = mfa_setup
    svc = serving.EstimationService(
        params, MFA_X0, 2, factored=True, mode=mode, use_kernels=use_kernels,
        max_delay_ms=1.0, device="cpu")
    try:
        assert not svc.use_kernels
        got = svc.submit(r[:48], 10.0, timeout=TIMEOUT)
        np.testing.assert_allclose(got, _jax_factored(jparams, r[:48], mode),
                                   atol=1e-4)
        assert not svc._banks[svc._snap(10.0)].lowered   # no kernel layout
    finally:
        svc.close(timeout=TIMEOUT)


def test_factored_service_refusals_and_dense_fallback(mfa_setup,
                                                      monkeypatch):
    """1-bit with factored=True and a pilot other than x0 I are refused at
    construction; `from_mfa` falls back to the dense bank for either;
    use_kernels=True with a selection mode is refused; no card and no
    device raises."""
    params, _, r = mfa_setup
    with pytest.raises(ValueError, match="1-bit"):
        serving.EstimationService(params, MFA_X0, 1, factored=True,
                                  device="cpu")
    with pytest.raises(ValueError, match="x0"):
        serving.EstimationService(params, np.ones((MFA_D, MFA_D)), 2,
                                  factored=True, device="cpu")
    with pytest.raises(ValueError, match="mode='all'"):
        serving.EstimationService(params, MFA_X0, 2, factored=True, mode=1,
                                  use_kernels=True, device="cpu")
    for n_bits, a in ((1, MFA_X0), (2, np.diag(np.arange(1.0, MFA_D + 1)))):
        svc = serving.EstimationService.from_mfa(
            params, a, n_bits, max_delay_ms=1.0, device="cpu")
        try:
            assert not svc.factored
            out = svc.submit(r[:16], 10.0, timeout=TIMEOUT)
            assert out.shape == (16, MFA_D) and np.isfinite(out).all()
        finally:
            svc.close(timeout=TIMEOUT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.EstimationService.from_mfa(params, MFA_X0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.EstimationService.from_mfa(params, MFA_X0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.EstimationService(params, MFA_X0, 2, factored=True)
