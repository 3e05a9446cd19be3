"""The port's VAE (`models.vae`, `ops.observation.observe_random_snr`)
against the JAX package.

The JAX side is trained once for the file (`jax_trained`: D = 16, latent 4,
2 layers, 3 epochs of 5 steps in each mode) or initialised from a key, and
carried across with `vae.params_from_flax` / `vae.state_from_flax`. Held:
- `DnnVae` against flax on the same input and latent noise, every mode,
  `zeromean` on and off, and noisy with 2 and 4 pilots (1 and 2 pilot
  convs), to 1e-5 of the output scale (JAX draws its latent noise in
  float64 under x64, so its decoder runs in float64);
- `elbo_loss` on the same outputs in every mode: uniform 'real' at 1 and 2
  bits, Lloyd 'real' with its tables, unquantized, to rtol 1e-5;
- `fft_stack` / `obs_to_input`;
- `observe_random_snr` on JAX's draws bit for bit, with values exactly on
  thresholds (a 300 dB SNR leaves the channel unperturbed in float32), and
  its own generator's SNR and noise statistics;
- three Adam steps from a shared state on JAX's draws: loss, parameters and
  moments to rtol 1e-5 (atol 1e-5 of each vector's scale), the count; the
  NaN guard keeping parameters, moments and count for a non-finite loss, a
  loss >= 1000 and an infinite gradient at a finite loss;
- `estimate`, dense and structured, at inf / 1 / 2 bits, coherence T = 2
  and 4, genie, degenerate variances (both clips), a non-zero mean and a
  0-d pilot, against JAX's to 1e-4 of the scale (at 1 bit against JAX's
  float64 dense evaluation: JAX's float32 arcsine of arguments near +-1
  moves by ~3e-4);
- the port's own training: the loss falls and the estimate beats the zero
  estimate at 10 dB (as tests/test_vae.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import vae as jv
from quantized_channel_estimation_tpu.ops import cplx as jc
from quantized_channel_estimation_tpu.ops import observation as jobs
from quantized_channel_estimation_tpu.ops import pilots as jp
from quantized_channel_estimation_tpu.ops import quantizer as jq
from quantized_channel_estimation_tpu.ops import scm as jscm
from quantized_channel_estimation_torch.harness import stages as tst
from quantized_channel_estimation_torch.models import vae as tv
from quantized_channel_estimation_torch.ops import observation as tobs
from quantized_channel_estimation_torch.ops import pilots as tp
from quantized_channel_estimation_torch.ops import quantizer as tq
from quantized_channel_estimation_torch.ops import scm as tscm

torch.set_num_threads(2)

N, LAT, LAYERS, B = 16, 4, 2, 64
SNRS = [-10.0, 0.0, 10.0, 20.0]
MODES = ["genie", "noisy", "real"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _cfgs(mode, **kw):
    """The same config in both packages."""
    base = dict(n_antennas=N, latent_dim=LAT, n_layers=LAYERS,
                vae_mode=mode, n_bits=2, lr=1e-3, batch_size=B, epochs=3,
                steps_per_epoch=5)
    base.update(kw)
    return jv.VaeConfig(**base), tv.VaeConfig(**base)


def _quantizers(n_bits=2, qtype="uniform", snrs=SNRS):
    return ([jq.design_quantizer(s, n_bits, qtype) for s in snrs],
            [tq.design_quantizer(s, n_bits, qtype) for s in snrs])


def _carry(jcfg, tcfg, jstate):
    model = tv.DnnVae(tcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return model, tv.state_from_flax(model, to_np(jstate.params),
                                     to_np(jstate.opt_state),
                                     int(jstate.step))


@pytest.fixture(scope="module")
def data():
    h, _ = jscm.generate_channels(jax.random.PRNGKey(20), 1600,
                                  jscm.ScmConfig(N, 1))
    return h[:1200], h[1200:]


@pytest.fixture(scope="module")
def jax_trained(data):
    """mode -> (jax cfg, port cfg, jax model, jax state), trained 3 epochs
    of 5 steps."""
    h_train, _ = data
    a = jp.pilot_matrix(N, 1, 2)
    out = {}
    for i, mode in enumerate(MODES):
        jcfg, tcfg = _cfgs(mode)
        model, state, _ = jv.train(jax.random.PRNGKey(30 + i), jcfg, h_train,
                                   a, SNRS, _quantizers()[0], verbose=False)
        out[mode] = (jcfg, tcfg, model, state)
    return out


# ---------------------------------------------------------------------------
# the network, the loss, the inputs
# ---------------------------------------------------------------------------

NET_CASES = [("genie", {}), ("genie", dict(zeromean=False)),
             ("noisy", {}), ("noisy", dict(zeromean=False)),
             ("real", {}), ("real", dict(zeromean=False)),
             ("noisy", dict(n_pilots=2, n_pilot_convs=1)),
             ("noisy", dict(n_pilots=4, n_pilot_convs=2))]


@pytest.mark.parametrize("mode,kw", NET_CASES)
def test_dnnvae_matches_flax(mode, kw):
    jcfg, tcfg = _cfgs(mode, **kw)
    jmodel, jstate = jv.init_vae(jax.random.PRNGKey(3), jcfg)
    tmodel = tv.DnnVae(tcfg)
    params = tv.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tcfg)
    p = jcfg.n_pilots
    shape = (B, p, 2 * N) if (mode == "noisy" and p > 1) else (B, 2 * N)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, (B, LAT))
    want = jmodel.apply(jstate.params, jnp.asarray(x), key)
    got = tmodel(torch.as_tensor(x), eps=torch.as_tensor(np.array(eps)),
                 params=params)
    assert (got[2] is None) == (want[2] is None) == jcfg.zeromean
    for g, w in zip(got, want):
        if w is not None:
            _close(g, w, 1e-5)
    want_ns = jmodel.apply(jstate.params, jnp.asarray(x),
                           method=jv.DnnVae.forward_nosamp)
    tv.load_params(tmodel, params)   # the module's own parameters
    got_ns = tmodel.forward_nosamp(torch.as_tensor(x))
    for g, w in zip(got_ns, want_ns):
        if w is not None:
            _close(g, w, 1e-5)


def test_params_from_flax_checks_the_layers():
    jcfg, tcfg = _cfgs("noisy")
    _, jstate = jv.init_vae(jax.random.PRNGKey(3), jcfg)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    sd = tv.params_from_flax(params, tcfg)
    assert sd["enc_layers.0.weight"].shape == (
        params["params"]["enc_layers_0"]["kernel"].shape[::-1])
    assert torch.equal(sd["enc_layers.0.weight"].T,
                       torch.as_tensor(np.array(params["params"]["enc_layers_0"]
                                                ["kernel"])))
    with pytest.raises(ValueError, match="do not match"):
        tv.params_from_flax(params, tcfg._replace(n_layers=3))


def test_init_law_zero_biases_and_flat_layout():
    """Weights U(+-1/sqrt(fan_in)) like flax's variance_scaling(1/3,
    'fan_in', 'uniform'), biases zero (nn.Linear's own init is not), and
    the flat vector in `named_parameters` order."""
    _, tcfg = _cfgs("noisy", n_layers=4, latent_dim=16, n_antennas=64)
    model, state = tv.init_vae(torch.Generator().manual_seed(0), tcfg)
    for name, p in tv.unflatten_params(model, state.params).items():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0
        else:
            bound = 1.0 / np.sqrt(p.shape[1])
            assert float(p.abs().max()) <= bound
            assert abs(float(p.std()) - bound / np.sqrt(3)) < 0.1 * bound
    assert torch.equal(tv.flatten_params(model, dict(
        model.named_parameters())), state.params)
    assert int(state.count) == int(state.step) == 0
    assert state.count.dtype == torch.int32


def _outputs(rng, zeromean):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, LAT), 0.3 * f(B, LAT), None if zeromean else f(B, 2 * N),
            f(B, N))


@pytest.mark.parametrize("mode,n_bits,qtype,zeromean", [
    ("genie", 2, "uniform", True), ("noisy", 2, "uniform", True),
    ("noisy", 2, "uniform", False), ("real", 1, "uniform", True),
    ("real", 2, "uniform", True), ("real", 3, "lloyd", True),
    ("real", jq.INF_BITS, "uniform", True), ("real", 2, "uniform", False)])
def test_elbo_loss_matches_jax(mode, n_bits, qtype, zeromean):
    jcfg, tcfg = _cfgs(mode, n_bits=n_bits, quantizer_type=qtype,
                       zeromean=zeromean)
    rng = np.random.default_rng(7)
    outs = _outputs(rng, zeromean)
    data_h = rng.standard_normal((B, 2 * N)).astype(np.float32)
    data_y = rng.standard_normal((B, 2 * N)).astype(np.float32)
    snr = np.asarray(SNRS, np.float32)[rng.integers(0, len(SNRS), B)]
    jtab = ttab = None
    if qtype == "lloyd":
        qs = {s: jq.design_quantizer(s, n_bits, "lloyd") for s in SNRS}
        thr = np.stack([np.asarray(qs[float(s)].thresholds) for s in snr])
        lab = np.stack([np.asarray(qs[float(s)].labels) for s in snr])
        jtab, ttab = (thr, lab), (torch.as_tensor(thr), torch.as_tensor(lab))
    to_j = lambda o: tuple(None if x is None else jnp.asarray(x)  # noqa
                           for x in o)
    to_t = lambda o: tuple(None if x is None else torch.as_tensor(x)  # noqa
                           for x in o)
    want = jv.elbo_loss(jcfg, to_j(outs), jnp.asarray(data_h),
                        jnp.asarray(data_y), snr_list=jnp.asarray(snr),
                        q_tables=jtab)
    got = tv.elbo_loss(tcfg, to_t(outs), torch.as_tensor(data_h),
                       torch.as_tensor(data_y),
                       snr_list=torch.as_tensor(snr), q_tables=ttab)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if qtype == "lloyd":
        with pytest.raises(NotImplementedError, match="tables"):
            tv.elbo_loss(tcfg, to_t(outs), None, torch.as_tensor(data_y),
                         snr_list=torch.as_tensor(snr))


@pytest.mark.parametrize("mode,p,fft_pre", [
    ("noisy", 1, True), ("noisy", 2, True), ("noisy", 2, False),
    ("real", 1, True), ("real", 1, False)])
def test_fft_stack_and_obs_to_input_match_jax(mode, p, fft_pre):
    jcfg, tcfg = _cfgs(mode, n_pilots=p, fft_pre=fft_pre)
    rng = np.random.default_rng(8)
    r = (rng.standard_normal((B, p * N))
         + 1j * rng.standard_normal((B, p * N))).astype(np.complex64)
    _close(tv.obs_to_input(tcfg, torch.as_tensor(r)),
           jv.obs_to_input(jcfg, jnp.asarray(r)), 1e-6)
    _close(tv.fft_stack(torch.as_tensor(r)), jv.fft_stack(jnp.asarray(r)),
           1e-6)


# ---------------------------------------------------------------------------
# observations at a random SNR a sample
# ---------------------------------------------------------------------------

def _jax_snr_draws(key, batch, n_snrs, shape):
    ksel, knoise = jax.random.split(key)
    idx = jax.random.randint(ksel, (batch,), 0, n_snrs)
    return idx, jc.crandn(knoise, shape, dtype=jnp.complex64)


@pytest.mark.parametrize("n_bits,qtype,t_coh", [
    (2, "uniform", None), (3, "lloyd", None), (1, "uniform", None),
    (jq.INF_BITS, "uniform", None), (2, "uniform", 4)])
def test_observe_random_snr_matches_jax_on_its_draws(n_bits, qtype, t_coh):
    """Rows drawn at 300 dB see no noise in float32, and their entries lie
    exactly on that design's non-zero thresholds: right-closed cells in
    both."""
    snrs = [-10.0, 0.0, 10.0, 300.0]
    jqs = _quantizers(n_bits, qtype, snrs)[0]
    # the JAX designs' tables (a float32 Lloyd design differs in its last
    # digits between the packages)
    tqs = [None if q is None else tq.ScalarQuantizer(
        *(torch.as_tensor(np.array(x)) for x in q)) for q in jqs]
    rng = np.random.default_rng(9)
    shape = (B, t_coh, N) if t_coh else (B, N)
    if jqs[-1] is not None and n_bits != 1:
        # the zero threshold would take the sign of the 1e-15 noise
        thr = np.asarray(jqs[-1].thresholds)
        thr = thr[thr != 0]
        pick = rng.integers(0, thr.size, shape + (2,))
        h = (thr[pick[..., 0]] + 1j * thr[pick[..., 1]]).astype(np.complex64)
    else:
        h = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
    a = jp.pilot_matrix(N, 1, 2)
    key = jax.random.PRNGKey(10)
    want = jobs.observe_random_snr(key, jnp.asarray(h), snrs, a, n_bits,
                                   jqs, return_tables=True)
    idx, w = _jax_snr_draws(key, B, len(snrs), shape)
    got = tobs.observe_random_snr_noise(
        torch.as_tensor(h), torch.as_tensor(np.array(idx)),
        torch.as_tensor(np.array(w)), snrs,
        torch.as_tensor(np.array(a)), n_bits, tqs, return_tables=True)
    for g, wnt in zip(got, want):
        assert (g is None) == (wnt is None)
        if wnt is not None:
            np.testing.assert_array_equal(_np(g), np.asarray(wnt))
    if jqs[-1] is not None and n_bits != 1:
        on = np.asarray(idx) == 3
        assert on.any()
        # the unperturbed rows are h itself, quantized right-closed
        labels = tq.quantize(torch.as_tensor(h[on]), n_bits, tqs[-1])
        np.testing.assert_array_equal(_np(got[0])[on], _np(labels))


def test_observe_random_snr_statistics():
    """The port's own draws: SNR indices uniform (or by snr_probs), the
    noise power of each SNR's rows 10^(-snr/10), one amplitude over every
    snapshot of a coherence block."""
    snrs = [-10.0, 0.0, 10.0, 20.0]
    n = 40000
    h = torch.zeros((n, N), dtype=torch.complex64)
    gen = torch.Generator().manual_seed(11)
    r, snr = tobs.observe_random_snr(gen, h, snrs, None, jq.INF_BITS)
    counts = np.bincount(np.searchsorted(snrs, snr.numpy()), minlength=4)
    assert np.all(np.abs(counts - n / 4) < 5 * np.sqrt(n * 3 / 16))
    power = (r.abs() ** 2).mean(-1).numpy()
    for s in snrs:
        np.testing.assert_allclose(power[snr.numpy() == s].mean(),
                                   10 ** (-s / 10), rtol=0.02)
    probs = np.asarray([0.7, 0.1, 0.1, 0.1])
    _, snr_p = tobs.observe_random_snr(gen, h, snrs, None, jq.INF_BITS,
                                       snr_probs=probs)
    freq = np.bincount(np.searchsorted(snrs, snr_p.numpy()), minlength=4) / n
    assert np.all(np.abs(freq - probs) < 5 * np.sqrt(probs * (1 - probs) / n))
    hb = torch.zeros((2000, 4, N), dtype=torch.complex64)
    rb, snr_b = tobs.observe_random_snr(gen, hb, snrs, None, jq.INF_BITS)
    ratio = (rb.abs() ** 2).mean(-1) / 10 ** (-snr_b[:, None] / 10)
    assert abs(float(ratio.mean()) - 1.0) < 0.02
    _, tqs = _quantizers(2, "uniform", snrs)
    r2, snr2, thr, lab = tobs.observe_random_snr(gen, hb, snrs, None, 2, tqs,
                                                 return_tables=True)
    assert r2.shape == hb.shape and thr.shape == (2000, 3)
    for s, q in zip(snrs, tqs):
        assert torch.equal(thr[snr2 == s][0], q.thresholds)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_step_draws(key, n_rows, mode, m):
    """The draws of the JAX train step for `key` (single device)."""
    kidx, kloss = jax.random.split(key)
    idx = jax.random.randint(kidx, (B,), 0, n_rows)
    kobs, ksamp = jax.random.split(kloss)
    eps = jax.random.normal(ksamp, (B, LAT))
    snr_idx = w = None
    if mode != "genie":
        snr_idx, w = _jax_snr_draws(kobs, B, len(SNRS), (B, m))
    t = lambda x: None if x is None else torch.as_tensor(  # noqa: E731
        np.array(x))
    return tv.StepDraws(t(idx), t(snr_idx), t(w), t(eps).float())


def _state_close(got, jstate, model, tol=1e-5):
    flat = lambda tree: tv.flatten_params(  # noqa: E731
        model, tv.params_from_flax(jax.tree_util.tree_map(np.asarray, tree)))
    adam = jstate.opt_state[0]
    for g, w in ((got.params, flat(jstate.params)), (got.mu, flat(adam.mu)),
                 (got.nu, flat(adam.nu))):
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol,
                                   atol=tol * float(w.abs().max()))
    assert int(got.count) == int(adam.count)
    assert int(got.step) == int(jstate.step)


@pytest.mark.parametrize("mode,qtype", [("genie", "uniform"),
                                        ("noisy", "uniform"),
                                        ("real", "uniform"),
                                        ("real", "lloyd")])
def test_adam_steps_match_optax_on_jax_draws(data, mode, qtype):
    h_train, _ = data
    jcfg, tcfg = _cfgs(mode, quantizer_type=qtype)
    jqs, tqs = _quantizers(2, qtype)
    a = jp.pilot_matrix(N, 1, 2)
    jmodel, jstate = jv.init_vae(jax.random.PRNGKey(12), jcfg)
    jstep = jv.make_train_step(jmodel, jcfg, a,
                               jnp.asarray(SNRS, jnp.float32), jqs)
    model, state = _carry(jcfg, tcfg, jstate)
    tstep = tv.make_train_step(model, tcfg, torch.as_tensor(np.array(a)),
                               SNRS, tqs)
    h_t = torch.as_tensor(np.asarray(h_train))
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jstate, jloss = jstep(jstate, h_train, key)
        state, loss = tstep.apply(state, h_t, _jax_step_draws(
            key, h_train.shape[0], mode, N))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _state_close(state, jstate, model)
    assert int(state.count) == 3


class _InfGrad(torch.autograd.Function):
    """Identity forward, infinite backward: a finite loss whose gradient is
    not."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("inf")


@pytest.mark.parametrize("poison", ["nan_batch", "huge_loss", "inf_grad"])
def test_nan_guard_keeps_params_moments_and_count(data, poison,
                                                  monkeypatch):
    h_train, _ = data
    _, tcfg = _cfgs("noisy")
    _, tqs = _quantizers()
    model, state = tv.init_vae(torch.Generator().manual_seed(13), tcfg)
    a = tp.pilot_matrix(N, 1, 2)
    step = tv.make_train_step(model, tcfg, a, SNRS, tqs)
    h = torch.as_tensor(np.asarray(h_train))
    gen = torch.Generator().manual_seed(14)
    state, _ = step(state, h, gen)          # a real update first
    assert int(state.count) == 1
    if poison == "nan_batch":
        h = torch.full_like(h, complex("nan"))
    elif poison == "huge_loss":
        h = h * 1e4
    else:
        orig = tv.elbo_loss
        monkeypatch.setattr(tv, "elbo_loss",
                            lambda *a, **k: _InfGrad.apply(orig(*a, **k)))
    new, loss = step(state, h, gen)
    if poison == "inf_grad":
        assert torch.isfinite(loss) and float(loss) < 1000
    else:
        assert not (torch.isfinite(loss) and float(loss) < 1000)
    for got, want in zip(new[:4], state[:4]):
        assert torch.equal(got, want)
    assert int(new.step) == int(state.step) + 1


# ---------------------------------------------------------------------------
# estimation
# ---------------------------------------------------------------------------

def _estimate_pair(jcfg, tcfg, jmodel, jparams, r, snr, n_bits, a,
                   structured, t_coh=1, h_true=None, zero_d_pilot=False):
    jq_ = jq.design_quantizer(snr, n_bits)
    tq_ = tq.design_quantizer(snr, n_bits)
    # at 1 bit JAX's float32 arcsine sits where arcsin's slope is unbounded
    # (`vae.estimate`'s docstring): hold the port against JAX's float64
    # dense evaluation (its structured path casts the arcsine to complex64)
    dt = jnp.complex128 if n_bits == 1 else jnp.complex64
    want = jv.estimate(jmodel, jparams, jcfg, jnp.asarray(r, dt), snr,
                       jnp.asarray(a, dt), jq_, h_true=h_true,
                       coherence=t_coh, chunk_size=96,
                       structured=structured and n_bits != 1)
    model = tv.DnnVae(tcfg)
    params = tv.params_from_flax(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg)
    ta = torch.as_tensor(np.array(a))
    got = tv.estimate(model, params, tcfg, torch.as_tensor(r), snr,
                      ta[0, 0] if zero_d_pilot else ta, tq_,
                      h_true=None if h_true is None
                      else torch.as_tensor(np.asarray(h_true)),
                      coherence=t_coh, structured=structured, chunk_size=96)
    _close(got, want, 1e-4)
    return got


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("case", ["2bit", "1bit", "inf", "coh2", "coh4",
                                  "genie", "real", "degenerate", "mean"])
def test_estimate_matches_jax(data, jax_trained, case, structured):
    _, h_val = data
    h = np.asarray(h_val[:192])
    mode = {"genie": "genie", "real": "real"}.get(case, "noisy")
    jcfg, tcfg, jmodel, jstate = jax_trained[mode]
    jparams = jstate.params
    n_bits = {"1bit": 1, "inf": jq.INF_BITS}.get(case, 2)
    jcfg, tcfg = jcfg._replace(n_bits=n_bits), tcfg._replace(n_bits=n_bits)
    if case == "degenerate":
        # decoder log-precisions of +-60: variances past both clips
        last = f"dec_layers_{LAYERS - 1}"
        bias = np.where(np.arange(N) % 2, 60.0, -60.0).astype(np.float32)
        jparams = jax.tree_util.tree_map(lambda x: x, jparams)
        jparams["params"][last] = {"kernel": 0.0 * jparams["params"][last][
            "kernel"], "bias": jnp.asarray(bias)}
    if case == "mean":
        jcfg, tcfg = _cfgs("noisy", zeromean=False)
        jmodel, st = jv.init_vae(jax.random.PRNGKey(15), jcfg)
        jparams = st.params
    a = jp.pilot_matrix(N, 1, 2)
    snr = 10.0
    r = np.asarray(jobs.observe(jax.random.PRNGKey(16), jnp.asarray(h), snr,
                                a, n_bits, jq.design_quantizer(snr, n_bits)))
    t_coh = {"coh2": 2, "coh4": 4}.get(case, 1)
    got = _estimate_pair(jcfg, tcfg, jmodel, jparams, r, snr, n_bits, a,
                         structured, t_coh,
                         jnp.asarray(h) if mode == "genie" else None,
                         zero_d_pilot=structured and case == "2bit")
    assert torch.isfinite(got).all()


def test_estimate_refusals(jax_trained):
    _, tcfg, _, _ = jax_trained["genie"]
    model = tv.DnnVae(tcfg)
    r = torch.zeros((8, N), dtype=torch.complex64)
    with pytest.raises(ValueError, match="h_true"):
        tv.estimate(model, None, tcfg, r, 0.0, torch.eye(N))
    ncfg = tcfg._replace(vae_mode="noisy")
    with pytest.raises(ValueError, match="multiple"):
        tv.estimate(tv.DnnVae(ncfg), None, ncfg, r[:6], 0.0, torch.eye(N),
                    tq.design_quantizer(0.0, 2), coherence=4)


# ---------------------------------------------------------------------------
# the port's own training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_data():
    h, _ = tst.generate_channels(torch.Generator().manual_seed(17), 3000,
                                 tscm.ScmConfig(N, 1))
    return h[:2500], h[2500:]


@pytest.mark.parametrize("mode,kw", [("genie", {}), ("noisy", {}),
                                     ("real", {}),
                                     ("noisy", dict(n_pilots=2,
                                                    n_pilot_convs=1))])
def test_training_lowers_the_loss_and_beats_the_zero_estimate(port_data,
                                                              mode, kw):
    h_train, h_val = port_data
    _, tcfg = _cfgs(mode, n_layers=3, batch_size=128, epochs=4,
                    steps_per_epoch=40, **kw)
    p = tcfg.n_pilots
    a = tp.pilot_matrix(N, p, 2)
    _, tqs = _quantizers()
    model, state, losses = tv.train(18, tcfg, h_train, a, SNRS, tqs,
                                    verbose=False)
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert int(state.step) == 160
    snr = 10.0
    q = tq.design_quantizer(snr, 2)
    r = tst.observe(torch.Generator().manual_seed(19), h_val, snr, a, 2, q)
    h_est = tv.estimate(model, state.params, tcfg, r, snr, a, q,
                        h_true=h_val if mode == "genie" else None,
                        structured=p == 1)
    nmse = float(((h_est - h_val).abs() ** 2).mean()
                 / (h_val.abs() ** 2).mean())
    assert np.isfinite(nmse) and nmse < 1.0, (mode, nmse)
    # the module returned holds the final parameters
    h_mod = tv.estimate(model, None, tcfg, r, snr, a, q,
                        h_true=h_val if mode == "genie" else None,
                        structured=p == 1)
    _close(h_mod, h_est, 1e-6)


def test_real_mode_refuses_several_pilots():
    _, tcfg = _cfgs("real", n_pilots=2, n_pilot_convs=1)
    with pytest.raises(NotImplementedError, match="n_pilots=1 only"):
        tv.init_vae(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="vae_mode"):
        tv.init_vae(torch.Generator().manual_seed(0),
                    tcfg._replace(vae_mode="other"))
