"""VAE-based channel estimator: training in three modes and the
Bussgang-LMMSE estimate from the decoder's conditionally-Gaussian prior.

Port of `quantized_channel_estimation_tpu/models/vae.py`: `VaeConfig`,
`DnnVae`, `elbo_loss`, `fft_stack`, `obs_to_input`, `init_vae`, the train
step (`make_train_step`), `train` and `estimate`, plus `params_from_flax`
and `state_from_flax`, which carry a JAX (flax / optax) state across.

Training modes:
  genie: encoder input is the FFT-domain true channel (stacked reals)
  noisy: encoder input is a quantized pilot observation, regenerated every
         step at a per-sample random SNR; the target is the true channel
  real:  encoder input is a quantized pilot observation alone (no CSI); the
         quantization-aware conditionally-Gaussian ELBO supervises

The decoder predicts per-dimension log-precisions in the FFT domain (and
means unless `zeromean`). `estimate` turns them into Ch = F^H diag(var) F,
Cy = A Ch A^H + s2 I, the Bussgang Cr of the quantizer and one batched
Cholesky solve a chunk, or with `structured=True` (A = x0 I) into the same
algebra on per-sample spectra, elementwise in the DFT domain.

Differences from the JAX package:
- Parameters are `nn.Linear` layers with weights (out, in); flax kernels
  are (in, out), which `params_from_flax` transposes. The weights start
  from U(+-1/sqrt(fan_in)) (flax's `variance_scaling(1/3, 'fan_in',
  'uniform')`, the same law) and the biases at zero, as flax's do.
- The train state is flat: one float32 vector of every parameter in
  `named_parameters()` order, Adam's two moments beside it, and Adam's step
  count (int32). The Adam update is optax's (`lr m_hat / (sqrt(v_hat) +
  1e-8)`), written out so that the NaN guard can keep parameters, moments
  and count with `torch.where` and no host read a step.
- Random draws come from `torch.Generator`s: step i of epoch e draws from
  one generator seeded by (seed, e, rank) through numpy's SeedSequence and
  advanced through the epoch's steps, so a resumed run (which restarts at
  an epoch boundary) needs no saved generator state and repeats an
  uninterrupted run bit for bit. Threefry and Philox streams differ, so
  the two packages train alike in law, not draw for draw; a step fed the
  JAX draws (`StepDraws`) is the JAX step.
- On a card a single-device epoch replays a CUDA graph of one step (the
  draws, forward, backward and guarded update over static buffers, its
  generator registered as graph-safe): the same kernels and draws as the
  eager step, bit for bit, at one launch's host cost where the eager step
  issues a few hundred.
- Data-parallel training takes a `torch.distributed` process group
  (`make_train_step(group=)`, `parallel.mesh.make_vae_epochs_runner`) in
  place of `VaeConfig.axis_name`; rank 0 of the group draws the
  single-device stream, so a one-rank group repeats the single-device run.
- `estimate` slices rows into chunks (aligned to whole coherence blocks)
  where JAX pads them; each row is computed alone, so the results agree.
- At 1 bit `estimate` evaluates the arcsine law in float64 (the rest of
  the algebra stays float32). Its arguments sit near +-1 (the unit
  diagonal, and strongly correlated lags), where arcsin's slope is
  unbounded: JAX's float32 evaluation moves by up to ~3e-4 of the
  estimate's scale with summation order. The port is held against JAX's
  float64 evaluation.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from quantized_channel_estimation_torch.ops import linalg, observation
from quantized_channel_estimation_torch.ops.bussgang import (
    bank_gains_and_cov, bussgang_gain_diag)
from quantized_channel_estimation_torch.ops.cplx import cplx2real, real2cplx
from quantized_channel_estimation_torch.ops.precision import pin_fp32
from quantized_channel_estimation_torch.ops.quantizer import (
    ScalarQuantizer, is_inf_bits, uniform_step_tensor)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LOSS_GUARD = 1000.0


class VaeConfig(NamedTuple):
    n_antennas: int
    n_pilots: int = 1
    latent_dim: int = 16           # n_antennas // 4
    n_layers: int = 4
    vae_mode: str = "noisy"        # 'genie' | 'noisy' | 'real'
    zeromean: bool = True
    fft_pre: bool = True
    n_pilot_convs: int = 0         # max(0, n_pilots // 2)
    n_bits: float = 2
    quantizer_type: str = "uniform"
    lr: float = 5e-4
    batch_size: int = 200
    epochs: int = 500
    steps_per_epoch: Optional[int] = None  # default: n_train // batch_size


def _linspace_dims(a: int, b: int, n: int) -> Sequence[int]:
    return tuple(int(v) for v in np.linspace(a, b, n))


def _linears(dims: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))


Params = Dict[str, torch.Tensor]


class DnnVae(nn.Module):
    """Encoder / decoder MLPs with linearly interpolated widths. The latent
    mean and log-std are the two halves of the last encoder layer; the
    reparameterization uses exp(log-std). Every method takes an optional
    `params` dict (name -> tensor, `named_parameters()` names) that stands
    in for the module's own parameters."""

    def __init__(self, cfg: VaeConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.enc_layers = _linears(_linspace_dims(
            2 * c.n_antennas, 2 * c.latent_dim, c.n_layers + 1))
        out_dim = c.n_antennas if c.zeromean else 3 * c.n_antennas
        self.dec_layers = _linears(_linspace_dims(c.latent_dim, out_dim,
                                                  c.n_layers + 1))
        self.pilot_layers = _linears(_linspace_dims(c.n_pilots, 1,
                                                    c.n_pilot_convs + 1))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Weights U(+-1/sqrt(fan_in)) drawn from `gen`, biases zero."""
        for layer in (*self.enc_layers, *self.dec_layers,
                      *self.pilot_layers):
            bound = 1.0 / math.sqrt(layer.in_features)
            w = torch.rand(layer.weight.shape, generator=gen,
                           device=gen.device)
            layer.weight.copy_((2.0 * w - 1.0) * bound)
            layer.bias.zero_()

    @staticmethod
    def _layer(name: str, layer: nn.Linear, x, params: Optional[Params]):
        if params is None:
            return layer(x)
        return F.linear(x, params[name + ".weight"], params[name + ".bias"])

    def _mlp(self, prefix: str, layers: nn.ModuleList, x,
             params: Optional[Params], relu_last: bool):
        for i, layer in enumerate(layers):
            x = self._layer(f"{prefix}.{i}", layer, x, params)
            if relu_last or i < len(layers) - 1:
                x = F.relu(x)
        return x

    def _pre_pilot(self, x, params: Optional[Params] = None):
        """1x1 conv stack collapsing the pilot axis: x (B, P, 2N) ->
        (B, 2N). Empty for n_pilot_convs = 0 (one pilot)."""
        if self.cfg.vae_mode == "genie" or x.dim() == 2:
            return x
        x = self._mlp("pilot_layers", self.pilot_layers, x.transpose(-1, -2),
                      params, relu_last=True)
        return x[..., 0] if x.shape[-1] == 1 else x.transpose(-1, -2).squeeze()

    def encode(self, x, params: Optional[Params] = None):
        x = self._mlp("enc_layers", self.enc_layers,
                      self._pre_pilot(x, params), params, relu_last=False)
        half = x.shape[-1] // 2
        return x[..., :half], x[..., half:]   # (mu, log-std)

    def decode(self, z, params: Optional[Params] = None):
        x = self._mlp("dec_layers", self.dec_layers, z, params,
                      relu_last=False)
        if self.cfg.zeromean:
            return None, x   # log-precisions only
        n = self.cfg.n_antennas
        return x[..., :2 * n], x[..., 2 * n:]

    def forward(self, x, eps: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None,
                params: Optional[Params] = None):
        """(mu_enc, log_std_enc, mu_dec, log_prec_dec) with z = mu_enc +
        exp(log_std_enc) eps; eps given, or drawn N(0, 1) from `gen`."""
        mu_enc, log_std_enc = self.encode(x, params)
        if eps is None:
            eps = torch.randn(mu_enc.shape, generator=gen,
                              device=mu_enc.device, dtype=mu_enc.dtype)
        z = mu_enc + torch.exp(log_std_enc) * eps.to(mu_enc.dtype)
        mu_dec, log_prec_dec = self.decode(z, params)
        return mu_enc, log_std_enc, mu_dec, log_prec_dec

    def forward_nosamp(self, x, params: Optional[Params] = None):
        """Deterministic forward (latent mean, no sampling) for
        estimation: (mu_dec or None, log_prec_dec)."""
        mu_enc, _ = self.encode(x, params)
        return self.decode(mu_enc, params)


# ---------------------------------------------------------------------------
# flat parameters
# ---------------------------------------------------------------------------

def param_layout(model: DnnVae):
    """[(name, shape)] of the model's parameters, the flat vector's order."""
    return [(name, tuple(p.shape)) for name, p in model.named_parameters()]


def flatten_params(model: DnnVae, params: Params) -> torch.Tensor:
    """One float32 vector of a params dict, in `param_layout` order."""
    return torch.cat([params[name].reshape(-1).float()
                      for name, _ in param_layout(model)])


def unflatten_params(model: DnnVae, flat: torch.Tensor) -> Params:
    """Views of the flat vector, shaped and named as the parameters."""
    out, off = {}, 0
    for name, shape in param_layout(model):
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def _as_params(model: DnnVae, params) -> Optional[Params]:
    if params is None or isinstance(params, dict):
        return params
    return unflatten_params(model, params)


def load_params(model: DnnVae, params) -> DnnVae:
    """Copy params (a flat vector or a dict) into the module's own."""
    with torch.no_grad():
        for name, p in _as_params(model, params).items():
            model.get_parameter(name).copy_(p)
    return model


def params_from_flax(params, cfg: Optional[VaeConfig] = None) -> Params:
    """A `DnnVae` params dict of the JAX package's flax params (a nested
    dict of arrays, `{'params': {'enc_layers_0': {'kernel', 'bias'},
    ...}}` or its inner dict): kernels transposed to (out, in), names
    `enc_layers_i` -> `enc_layers.i`."""
    inner = params.get("params", params)
    out = {}
    for layer, leaves in inner.items():
        prefix, idx = layer.rsplit("_", 1)
        name = f"{prefix}.{int(idx)}"
        out[name + ".weight"] = torch.as_tensor(
            np.array(leaves["kernel"])).T.contiguous()
        out[name + ".bias"] = torch.as_tensor(np.array(leaves["bias"]))
    if cfg is not None:
        want = {name for name, _ in param_layout(DnnVae(cfg))}
        if set(out) != want:
            raise ValueError(f"flax params {sorted(out)} do not match the "
                             f"config's layers {sorted(want)}")
    return out


# ---------------------------------------------------------------------------
# loss and inputs
# ---------------------------------------------------------------------------

def elbo_loss(cfg: VaeConfig, outputs, data_h, data_y, snr_list=None,
              q_tables=None) -> torch.Tensor:
    """Conditionally-Gaussian ELBO; returns the negative mean ELBO.

    'real' mode: the observation's per-sample variance is the decoder's
    plus s2 (from each sample's SNR), and at finite bits its off-diagonal
    part is scaled by the clipped squared Bussgang gain of a per-sample
    scalar quantizer: the uniform step's closed form (at 1 bit too), or for
    other designs the threshold / label form of `q_tables` (thresholds
    (B, T), labels (B, L))."""
    mu_enc, log_std_enc, mu_dec, log_prec_dec = outputs
    if cfg.vae_mode == "real":
        sigma2 = 10.0 ** (-snr_list / 10.0)
        cy = torch.exp(-log_prec_dec) + sigma2[:, None]
        if not is_inf_bits(cfg.n_bits):
            cy_diag = cy.mean(1, keepdim=True)
            c = cy_diag[:, 0]
            if cfg.quantizer_type == "uniform":
                n_bits = int(cfg.n_bits)
                delta = uniform_step_tensor(snr_list, n_bits)   # (B,)
                idx = torch.arange(1, 2 ** n_bits, dtype=torch.float32,
                                   device=c.device)
                half = 2.0 ** n_bits / 2.0
                expo = torch.exp(-(delta ** 2)[:, None] * (idx - half) ** 2
                                 / c[:, None])
                gains = (delta / math.sqrt(math.pi) / torch.sqrt(c)
                         * expo.sum(-1))
            else:
                if q_tables is None or q_tables[0] is None:
                    raise NotImplementedError(
                        "vae_mode='real' with a non-uniform quantizer needs "
                        "the per-sample quantizer tables (observe_random_snr"
                        "(return_tables=True))")
                thr, lab = q_tables
                expo = torch.exp(-(thr ** 2) / c[:, None])
                gains = ((torch.diff(lab, dim=-1) * expo).sum(-1)
                         / (math.sqrt(math.pi) * torch.sqrt(c)))
            b2 = torch.clamp(gains ** 2, 0.0, 1.0)[:, None]
            cy = b2 * cy + (1.0 - b2) * cy_diag
        loss = torch.sum(-torch.log(cy), 1)
        w = data_y if cfg.zeromean else data_y - mu_dec
        inv = torch.cat([1.0 / cy, 1.0 / cy], 1)
        loss = loss - (w * inv * w).sum(1)
    else:
        loss = log_prec_dec.sum(1)
        w = data_h if cfg.zeromean else data_h - mu_dec
        lam = torch.exp(torch.cat([log_prec_dec, log_prec_dec], 1))
        loss = loss - (w * lam * w).sum(1)
    loss = loss + log_std_enc.sum(1)
    loss = loss - 0.5 * (mu_enc ** 2).sum(1)
    loss = loss - 0.5 * torch.exp(2.0 * log_std_enc).sum(1)
    return -loss.mean()


def fft_stack(h: torch.Tensor) -> torch.Tensor:
    """FFT-domain stacked-real channels [Re; Im](fft(h) / sqrt(N)), (B, 2N)
    float32."""
    n = h.shape[-1]
    return cplx2real(torch.fft.fft(h, dim=-1) / math.sqrt(n), -1).float()


def obs_to_input(cfg: VaeConfig, r: torch.Tensor) -> torch.Tensor:
    """Quantized observation (B, P*N) -> encoder input.

    noisy: row-major reshape to (B, P, N) (the reference's Fortran reshape
    to (B, N, P) and transpose), per-pilot FFT if fft_pre, stacked reals:
    (B, P, 2N), or (B, 2N) at P = 1. real: FFT over the whole P*N
    observation, stacked reals."""
    n, p = cfg.n_antennas, cfg.n_pilots
    if cfg.vae_mode == "real":
        m = r.shape[-1]
        x = torch.fft.fft(r, dim=-1) / math.sqrt(m) if cfg.fft_pre else r
        return cplx2real(x, -1).float()
    x = r.reshape(-1, p, n)
    if cfg.fft_pre:
        x = torch.fft.fft(x, dim=-1) / math.sqrt(n)
    x = cplx2real(x, -1).float()
    return x[:, 0, :] if p == 1 else x


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class VaeTrainState(NamedTuple):
    """params: the flat parameter vector (`param_layout` order); mu, nu:
    Adam's moments of it; count: Adam's step count (int32, held by the NaN
    guard); step: steps taken (int32, counts every step)."""
    params: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor
    step: torch.Tensor


class StepDraws(NamedTuple):
    """The random draws of one step: batch rows idx (B,) of the training
    set, the SNR indices (B,) and noise (B, M) of the observations (None in
    genie mode), and the latent noise eps (B, latent)."""
    idx: torch.Tensor
    snr_idx: Optional[torch.Tensor]
    w: Optional[torch.Tensor]
    eps: torch.Tensor


def _check_mode(cfg: VaeConfig) -> None:
    if cfg.vae_mode not in ("genie", "noisy", "real"):
        raise ValueError(f"vae_mode must be 'genie', 'noisy' or 'real'; got "
                         f"{cfg.vae_mode!r}")
    if cfg.vae_mode == "real" and cfg.n_pilots > 1:
        # the reference's real mode feeds the whole 2NP-real observation to
        # an encoder built for 2N inputs and scores an N-dimensional
        # likelihood against it: both are single-pilot
        raise NotImplementedError(
            "vae_mode='real' supports n_pilots=1 only (the reference's "
            "real-mode architecture and likelihood are single-pilot)")


def init_vae(gen: torch.Generator, cfg: VaeConfig, device=None):
    """(model, initial VaeTrainState) on `device` (default: the
    generator's), the weights drawn from `gen`."""
    _check_mode(cfg)
    device = torch.device(device) if device is not None else gen.device
    with torch.device(gen.device):   # built where it is drawn: no copies
        model = DnnVae(cfg)
    model.reset_parameters(gen)
    model = model.to(device)
    flat = flatten_params(model, dict(model.named_parameters())).detach()
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return model, VaeTrainState(flat.clone(), torch.zeros_like(flat),
                                torch.zeros_like(flat), zero, zero.clone())


def state_from_flax(model: DnnVae, params, opt_state=None, step=0,
                    device=None) -> VaeTrainState:
    """A `VaeTrainState` of the JAX package's state: flax `params`, and
    optax's Adam state (`opt_state[0]` with `mu`, `nu`, `count`, as numpy
    trees) or fresh moments."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device
    cfg = model.cfg

    def flat(tree):
        return flatten_params(model, params_from_flax(tree, cfg)).to(device)

    p = flat(params)
    if opt_state is None:
        mu, nu, count = torch.zeros_like(p), torch.zeros_like(p), 0
    else:
        adam = opt_state[0]
        mu, nu, count = flat(adam.mu), flat(adam.nu), int(adam.count)
    return VaeTrainState(
        p, mu, nu, torch.tensor(count, dtype=torch.int32, device=device),
        torch.tensor(int(step), dtype=torch.int32, device=device))


def _child(seq: np.random.SeedSequence, *keys: int) -> np.random.SeedSequence:
    """The descendant of `seq` at `keys` (`_child(seq, i)` is its i-th
    spawned child), without spawning: the same seq gives the same children
    at every call."""
    return np.random.SeedSequence(
        seq.entropy, spawn_key=tuple(seq.spawn_key) + tuple(map(int, keys)))


def _seed_of(seq: np.random.SeedSequence) -> int:
    """A `torch.Generator` seed from a SeedSequence."""
    return int(seq.generate_state(1, dtype=np.uint64)[0] >> 1)


def epoch_generator_seed(stream: np.random.SeedSequence, epoch: int,
                         rank: int = 0) -> int:
    """The seed of epoch `epoch`'s generator on data rank `rank`: a pure
    function of (stream, epoch, rank), so any epoch can be redrawn alone."""
    return _seed_of(_child(stream, epoch, rank))


def make_train_step(model: DnnVae, cfg: VaeConfig, a: Optional[torch.Tensor],
                    snrs, quantizers, group: Optional[dist.ProcessGroup] = None,
                    rank: int = 0):
    """One Adam step on a freshly drawn batch: rows drawn with replacement,
    their quantized observations made at a per-sample random SNR, the ELBO,
    and the guarded update. Returns step(state, h_train, gen) -> (state,
    loss), with `step.draw(gen, n_rows)`, `step.apply(state, h_train,
    draws)` (the step on given draws) and `step.run_epochs(state, h_train,
    stream, epoch0, n_steps, n_epochs)` (a block of epochs, their mean
    losses kept on the device; on a card without a group the steps replay
    a CUDA graph of the step).

    With `group` (data parallelism), h_train is this rank's window, each
    rank draws its own batches (its `rank` in the data group keys its
    stream) and the gradient and the loss are averaged over the group every
    step, in one all-reduce; the NaN guard then fires alike on every rank.

    The NaN guard: a step whose loss is non-finite or >= 1000, or whose
    gradient has a non-finite entry, keeps the parameters, both moments
    and the count (the 'real'-mode likelihood's backward can reach inf at
    a finite loss); `step` counts every step."""
    dev = next(model.parameters()).device
    genie = cfg.vae_mode == "genie"
    snrs_t = torch.as_tensor(snrs, dtype=torch.float32, device=dev)
    tables = None
    if not (is_inf_bits(cfg.n_bits) or cfg.n_bits == 1 or genie):
        tables = observation.stack_quantizers(quantizers, dev)
    a_t = None if a is None else torch.as_tensor(a, device=dev).to(
        torch.complex64)
    m = (cfg.n_pilots * cfg.n_antennas if a_t is None or a_t.dim() == 0
         else a_t.shape[0])
    world = 1 if group is None else dist.get_world_size(group)
    layout = param_layout(model)
    bsz = cfg.batch_size

    def loss_fn(params, h_batch, d: StepDraws):
        h_fft = fft_stack(h_batch)
        if genie:
            return elbo_loss(cfg, model(h_fft, eps=d.eps, params=params),
                             h_fft, None)
        r, snr, thr, lab = observation.observe_random_snr_noise(
            h_batch, d.snr_idx, d.w, snrs_t, a_t, cfg.n_bits, tables,
            return_tables=True)
        x = obs_to_input(cfg, r)
        out = model(x, eps=d.eps, params=params)
        if cfg.vae_mode == "noisy":
            return elbo_loss(cfg, out, h_fft, None)
        return elbo_loss(cfg, out, None, x, snr_list=snr,
                         q_tables=(thr, lab))

    def draw(gen: torch.Generator, n_rows: int) -> StepDraws:
        g_dev = gen.device
        idx = torch.randint(0, n_rows, (bsz,), generator=gen, device=g_dev)
        snr_idx = w = None
        if not genie:
            snr_idx, w = observation.draw_random_snr(
                gen, bsz, snrs_t.shape[0], (bsz, m))
        eps = torch.randn((bsz, cfg.latent_dim), generator=gen, device=g_dev)
        return StepDraws(idx, snr_idx, w, eps)

    def apply(state: VaeTrainState, h_train: torch.Tensor, d: StepDraws):
        h_batch = h_train[d.idx]
        leaves, off = {}, 0
        for name, shape in layout:
            n = math.prod(shape)
            leaves[name] = state.params[off:off + n].view(shape).detach() \
                .requires_grad_(True)
            off += n
        with torch.enable_grad():
            loss = loss_fn(leaves, h_batch, d)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grad = torch.cat([g.reshape(-1) for g in grads])
        loss = loss.detach()
        if group is not None:
            buf = torch.cat([grad, loss.reshape(1)])
            dist.all_reduce(buf, group=group)
            buf = buf / world
            grad, loss = buf[:-1], buf[-1]
        ok = torch.isfinite(loss) & (loss < LOSS_GUARD) \
            & torch.isfinite(grad).all()
        count = state.count + 1
        mu = (1.0 - ADAM_B1) * grad + ADAM_B1 * state.mu
        nu = (1.0 - ADAM_B2) * grad ** 2 + ADAM_B2 * state.nu
        c64 = count.double()
        bc1 = (1.0 - ADAM_B1 ** c64).float()
        bc2 = (1.0 - ADAM_B2 ** c64).float()
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        params = state.params + (-cfg.lr) * update
        return VaeTrainState(torch.where(ok, params, state.params),
                             torch.where(ok, mu, state.mu),
                             torch.where(ok, nu, state.nu),
                             torch.where(ok, count, state.count),
                             state.step + 1), loss

    def step(state: VaeTrainState, h_train: torch.Tensor,
             gen: torch.Generator):
        return apply(state, h_train, draw(gen, h_train.shape[0]))

    graphs: dict = {}

    def step_graph(state: VaeTrainState, h_train: torch.Tensor,
                   n_steps: int):
        """One step captured as a CUDA graph over static buffers (the
        state, an epoch's n_steps losses and the write position, a
        generator), built once per training set and epoch length: a replay
        is the eager step (the graph-safe generator hands each replay the
        offsets the eager draws would take) at one launch's host cost."""
        key = (h_train.data_ptr(), tuple(h_train.shape), n_steps)
        if key not in graphs:
            dev_ = h_train.device
            gen = torch.Generator(device=dev_)
            static = VaeTrainState(*(x.clone() for x in state))
            losses = torch.zeros(n_steps, dtype=torch.float32, device=dev_)
            pos = torch.zeros(1, dtype=torch.int64, device=dev_)
            side = torch.cuda.Stream(dev_)
            side.wait_stream(torch.cuda.current_stream(dev_))
            with torch.cuda.stream(side):   # warm-up: autograd and cuBLAS
                gen.manual_seed(0)
                step(static, h_train, gen)
            torch.cuda.current_stream(dev_).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                new, loss = step(static, h_train, gen)
                for dst, src in zip(static, new):
                    dst.copy_(src)
                losses.index_copy_(0, pos, loss.reshape(1))
                pos.add_(1)
            graphs[key] = (graph, gen, static, losses, pos)
        return graphs[key]

    def run_epochs(state: VaeTrainState, h_train: torch.Tensor,
                   stream: np.random.SeedSequence, epoch0: int, n_steps: int,
                   n_epochs: int, cuda_graph: Optional[bool] = None):
        """n_epochs epochs of n_steps steps from epoch `epoch0`: (state,
        per-epoch mean losses (n_epochs,) on the device, NaN for an epoch
        with a non-finite step loss). No host read. On a card and without a
        group every step replays a CUDA graph of the step (`cuda_graph`
        None: where it can; False: eager), bit for bit the eager steps."""
        dev_ = h_train.device
        if cuda_graph is None:
            cuda_graph = dev_.type == "cuda" and group is None
        losses = torch.empty((n_epochs, n_steps), dtype=torch.float32,
                             device=dev_)
        if cuda_graph:
            graph, gen, static, step_losses, pos = step_graph(
                state, h_train, n_steps)
            for dst, src in zip(static, state):
                dst.copy_(src)
        else:
            gen = torch.Generator(device=dev_)
        for e in range(n_epochs):
            gen.manual_seed(epoch_generator_seed(stream, epoch0 + e, rank))
            if cuda_graph:
                pos.zero_()
                for _ in range(n_steps):
                    graph.replay()
                losses[e].copy_(step_losses)
            else:
                for i in range(n_steps):
                    state, losses[e, i] = step(state, h_train, gen)
        if cuda_graph:
            state = VaeTrainState(*(x.clone() for x in static))
        means = torch.where(torch.isfinite(losses), losses,
                            torch.full_like(losses, math.nan)).mean(1)
        return state, means

    step.draw = draw
    step.apply = apply
    step.run_epochs = run_epochs
    return step


def _seed_sequence(seed) -> np.random.SeedSequence:
    return seed if isinstance(seed, np.random.SeedSequence) \
        else np.random.SeedSequence(int(seed))


LOSSES_FILE = "torch_losses.json"


def _write_json_atomic(path: str, obj) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def train(seed, cfg: VaeConfig, h_train: torch.Tensor,
          a: Optional[torch.Tensor], snrs, quantizers,
          h_val: Optional[torch.Tensor] = None, verbose: bool = True,
          checkpoint_path: Optional[str] = None, checkpoint_every: int = 1,
          mesh=None):
    """Full training loop on h_train's device; returns (model, state,
    losses), the model holding the final parameters.

    `seed`: an int or a numpy SeedSequence; its first child seeds the
    initial weights and its second keys every epoch's draws
    (`epoch_generator_seed`). With `checkpoint_path` (a directory) the whole
    train state (parameters, Adam's moments and count, step) is saved every
    `checkpoint_every` epochs (`utils.checkpoint.TrainCheckpointer`:
    atomic, step-numbered, the last 3 kept) with the per-epoch losses
    beside it, and training resumes from the latest checkpoint, repeating
    an uninterrupted run bit for bit.

    `mesh`: a `torch.distributed` (data, component) `DeviceMesh`: training
    runs data-parallel over 'data' (`parallel.mesh.make_vae_epochs_runner`:
    rows sharded, per-rank batch draws, gradients averaged every step;
    effective batch cfg.batch_size x n_data_shards). The state stays
    replicated, so a data-parallel checkpoint resumes on one device and the
    reverse; rank 0 alone writes it. At a fixed lr and epoch count a
    data-parallel run takes n_data_shards-fold fewer steps an epoch.

    Epochs run in blocks of 25 (or `checkpoint_every`); the per-epoch mean
    losses are read once a block, clipped at 1000."""
    seq = _seed_sequence(seed)
    device = h_train.device
    model, state = init_vae(
        torch.Generator(device=device).manual_seed(_seed_of(_child(seq, 0))),
        cfg)
    stream = _child(seq, 1)
    start_epoch = 0
    losses: list = []
    ckpt = None
    writer = mesh is None or dist.get_rank() == 0
    if checkpoint_path:
        from quantized_channel_estimation_torch.utils.checkpoint import (
            TrainCheckpointer)
        ckpt = TrainCheckpointer(checkpoint_path, max_to_keep=3)
        last = ckpt.latest_step()
        if last is not None:
            state = ckpt.restore(last, state)
            with open(os.path.join(checkpoint_path, LOSSES_FILE)) as f:
                losses = json.load(f)[: last + 1]
            start_epoch = last + 1
            if verbose:
                print(f"resumed VAE checkpoint at epoch {start_epoch}")
    n_train = h_train.shape[0]
    if mesh is None:
        step = make_train_step(model, cfg, a, snrs, quantizers)
        steps = cfg.steps_per_epoch or max(1, n_train // cfg.batch_size)

        def run_block(st, ep, nb):
            return step.run_epochs(st, h_train, stream, ep, steps, nb)
    else:
        from quantized_channel_estimation_torch.parallel import mesh as pm
        n_dev = pm.axis_size(mesh, pm.DATA_AXIS)
        if n_train % n_dev:
            raise ValueError(f"n_train={n_train} must divide over "
                             f"{n_dev} data shards")
        # the single-device run's step count on the same data; each step
        # takes cfg.batch_size rows a rank
        steps = cfg.steps_per_epoch or max(1, (n_train // n_dev)
                                           // cfg.batch_size)
        runners: dict = {}

        def run_block(st, ep, nb):
            if nb not in runners:
                runners[nb] = pm.make_vae_epochs_runner(
                    mesh, model, cfg, a, snrs, quantizers, steps, nb)
            return runners[nb](st, h_train, stream, ep)
    block = max(1, min(checkpoint_every if checkpoint_path else 25,
                       cfg.epochs))
    epoch = start_epoch
    while epoch < cfg.epochs:
        n_block = min(block, cfg.epochs - epoch)
        state, mean_losses = run_block(state, epoch, n_block)
        block_losses = np.clip(mean_losses.cpu().numpy(), -np.inf, LOSS_GUARD)
        losses.extend(float(v) for v in block_losses)
        epoch += n_block
        if ckpt is not None and epoch % checkpoint_every == 0 and writer:
            ckpt.save(epoch - 1, state, force=True)
            _write_json_atomic(os.path.join(checkpoint_path, LOSSES_FILE),
                               [float(v) for v in losses])
        if verbose and (epoch // max(1, cfg.epochs // 10)
                        > (epoch - n_block) // max(1, cfg.epochs // 10)):
            print(f"epoch {epoch}/{cfg.epochs} loss={losses[-1]:.2f}")
    if ckpt is not None:
        ckpt.close()
    load_params(model, state.params)
    return model, state, losses


# ---------------------------------------------------------------------------
# estimation
# ---------------------------------------------------------------------------

def estimate(model: DnnVae, params, cfg: VaeConfig, r: torch.Tensor,
             snr_db: float, a: torch.Tensor,
             q: Optional[ScalarQuantizer] = None,
             chunk_size: int = 512, jitter: float = 1e-6,
             h_true: Optional[torch.Tensor] = None,
             var_clip: float = 1e2, coherence: int = 1,
             structured: bool = False) -> torch.Tensor:
    """Bussgang-LMMSE estimates (n, N) of observations r (n, M) from the
    decoder's per-sample conditional covariance Ch = F^H diag(var) F.

    params: the flat parameter vector (`VaeTrainState.params`), a params
    dict, or None for the module's own. a: the (M, N) pilot matrix, or a
    0-d x0 for A = x0 I.

    `structured=True` (A = x0 I; x0 is a[0, 0] of a matrix, which the
    caller vouches for) keeps the algebra circulant: Cy, the Bussgang gain
    (one scalar a sample), Cr under every quantization map and the LMMSE
    filter are elementwise on per-sample spectra, O(D log D) a sample where
    the dense path builds and factors D x D matrices.

    Genie mode is genie-aided: the encoder sees `h_true`; the LMMSE combine
    still uses r. `coherence=T > 1`: r is T-snapshot blocks laid out
    contiguously, and the decoder's predicted variances are averaged over
    each block (the conditional means are not). Decoder variances are
    clipped to [1e-12, var_clip]; Cr gets a jitter relative to its mean
    diagonal, per sample. fp32 throughout (TF32 off), complex64."""
    pin_fp32()
    n = cfg.n_antennas
    dev = r.device
    cdt = torch.complex64
    sigma2 = 10.0 ** (-float(snr_db) / 10.0)
    genie = cfg.vae_mode == "genie"
    if genie and h_true is None:
        raise ValueError("genie-mode estimation needs h_true (the genie "
                         "VAE's encoder sees the true channel)")
    p = _as_params(model, params)
    a = torch.as_tensor(a, device=dev).to(cdt)
    if a.dim() == 0:
        x0 = a
        a = a * torch.eye(n, dtype=cdt, device=dev)
    else:
        x0 = a[0, 0]
    m = a.shape[0]
    f = linalg.unitary_dft(n, cdt, dev)
    r = r.to(cdt)
    eye_m = torch.eye(m, dtype=cdt, device=dev)

    def chunk_fn(rc, hc):
        x = fft_stack(hc) if genie else obs_to_input(cfg, rc)
        mu_dec, log_prec = model.forward_nosamp(x, p)
        # clipped both ways: a degenerate decoder dimension would overflow
        # the Cy / Cr products at high SNR; 1e2 a bin is "no information"
        # for unit-power channels
        var = torch.clamp(torch.exp(-log_prec), 1e-12, var_clip)
        if coherence > 1:
            var = var.reshape(-1, coherence, n).mean(1, keepdim=True) \
                .expand(-1, coherence, n).reshape(var.shape)
        if cfg.zeromean or mu_dec is None:
            mu_h = torch.zeros((rc.shape[0], n), dtype=cdt, device=dev)
        else:
            mu_h = real2cplx(mu_dec.float(), -1).to(cdt) @ f.conj()
        if structured:
            sy = x0.abs() ** 2 * var + sigma2              # (B, D) real
            c0 = sy.mean(-1)                               # diag(Cy)
            if is_inf_bits(cfg.n_bits):
                gains = torch.ones_like(c0)
                spec_cr = sy
            elif cfg.n_bits == 1:
                gains = bussgang_gain_diag(c0, 1)
                # the arcsine law in float64: the normalised row's entries
                # sit near +-1 (its zero lag is 1), where arcsin's slope is
                # unbounded and a float32 ulp moves it by 3.5e-4
                sy64 = sy.double()
                row_y = (torch.fft.fft(sy64, dim=-1) / n) \
                    / sy64.mean(-1, keepdim=True)
                row_r = (2.0 / math.pi) * torch.complex(
                    torch.arcsin(torch.clamp(row_y.real, -1.0, 1.0)),
                    torch.arcsin(torch.clamp(row_y.imag, -1.0, 1.0)))
                spec_cr = torch.clamp(
                    torch.fft.ifft(row_r, dim=-1).real * n, min=0.0).float()
            else:
                gains = bussgang_gain_diag(c0, cfg.n_bits, q)
                b2 = torch.clamp(gains, 0.0, 1.0)[:, None] ** 2
                spec_cr = b2 * sy + (1.0 - b2) * c0[:, None]
            # a circulant Cr's diagonal is its spectrum's mean
            spec_cr = spec_cr + jitter * spec_cr.mean(-1, keepdim=True)
            sqrt_n = math.sqrt(n)
            u = torch.fft.fft(rc, dim=-1) / sqrt_n
            muf = torch.fft.fft(mu_h, dim=-1) / sqrt_n
            gx = gains.to(cdt)[:, None] * x0
            wf = gx.conj() * (var / spec_cr).to(cdt)
            hf = muf + wf * (u - gx * muf)
            return torch.fft.ifft(hf, dim=-1) * sqrt_n
        ch = (f.mH * var.to(cdt)[:, None, :]) @ f          # F^H diag F
        cy = a @ ch @ a.mH + sigma2 * eye_m
        if cfg.n_bits == 1:
            # the arcsine law in float64, as the structured path's
            gains, cr = bank_gains_and_cov(cy.to(torch.complex128), 1)
            gains, cr = gains.float(), cr.to(cdt)
        else:
            gains, cr = bank_gains_and_cov(cy, cfg.n_bits, q)
        a_eff = gains[..., :, None].to(cdt) * a
        mu_y = (a_eff @ mu_h[..., None])[..., 0]
        ch_aeff = ch @ a_eff.mH
        # jitter relative to each sample's Cr scale: an absolute one is
        # nothing against a degenerate sample's large Cr
        scale = torch.diagonal(cr, dim1=-2, dim2=-1).real.mean(-1)
        crj = cr + (jitter * scale)[:, None, None].to(cdt) * eye_m
        x_sol = linalg.cho_solve_hermitian(crj, rc - mu_y)
        return mu_h + (ch_aeff @ x_sol[..., None])[..., 0]

    n_samples = r.shape[0]
    if coherence > 1:
        if n_samples % coherence:
            raise ValueError(f"coherence={coherence} needs row count "
                             f"{n_samples} to be a multiple of it (blocks "
                             f"laid out contiguously)")
        # chunks hold whole blocks, so pooling never mixes blocks
        chunk_size = max(coherence, chunk_size - chunk_size % coherence)
    if genie:
        h_true = torch.as_tensor(h_true, device=dev).to(cdt)
    with torch.no_grad():
        outs = [chunk_fn(r[i0:i0 + chunk_size],
                         h_true[i0:i0 + chunk_size] if genie else None)
                for i0 in range(0, n_samples, chunk_size)]
    return torch.cat(outs) if outs else torch.zeros((0, n), dtype=cdt,
                                                    device=dev)
