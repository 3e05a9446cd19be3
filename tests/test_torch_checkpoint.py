"""The port's training checkpoints (`utils.checkpoint.TrainCheckpointer`)
and the VAE's resume through them (`models.vae.train(checkpoint_path=)`).

Held, as tests/test_vae_checkpoint.py holds the JAX package's: a run of 2
epochs resumed to 3 equals an uninterrupted 3-epoch run bit for bit
(losses, parameters, Adam's moments and count, step) in every mode; and,
where Orbax gave them to the JAX package, the checkpointer's own
guarantees: step-numbered files, `max_to_keep` retention, atomic commits
(a save that fails leaves the previous checkpoint whole and no partial
file under a step's name), the save interval, restore onto the example's
devices with its structure, shapes and dtypes checked, and use as a
context manager. Imports no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.models import vae
from quantized_channel_estimation_torch.ops import pilots, scm
from quantized_channel_estimation_torch.ops import quantizer as Q
from quantized_channel_estimation_torch.utils import checkpoint as ckpt_mod
from quantized_channel_estimation_torch.utils.checkpoint import (
    TrainCheckpointer)

torch.set_num_threads(2)

N_ANT = 8
SNRS = [0.0, 10.0]


@pytest.fixture(scope="module")
def channels():
    h, _ = stages.generate_channels(torch.Generator().manual_seed(50), 1200,
                                    scm.ScmConfig(N_ANT, 1))
    return h


@pytest.mark.parametrize("mode", ["genie", "noisy", "real"])
def test_resume_is_bit_identical(channels, tmp_path, mode):
    cfg = vae.VaeConfig(n_antennas=N_ANT, latent_dim=2, n_layers=2,
                        vae_mode=mode, n_bits=2, batch_size=64, epochs=2,
                        steps_per_epoch=5)
    a = pilots.pilot_matrix(N_ANT, 1, 2)
    qs = [Q.design_quantizer(s, 2) for s in SNRS]
    path = str(tmp_path / "ckpt")
    _, s1, l1 = vae.train(0, cfg, channels, a, SNRS, qs, verbose=False,
                          checkpoint_path=path)
    assert len(l1) == 2
    assert TrainCheckpointer(path).all_steps() == [0, 1]
    cfg3 = cfg._replace(epochs=3)
    _, s2, l2 = vae.train(0, cfg3, channels, a, SNRS, qs, verbose=False,
                          checkpoint_path=path)
    assert l2[:2] == l1 and len(l2) == 3
    _, s3, l3 = vae.train(0, cfg3, channels, a, SNRS, qs, verbose=False)
    assert l2 == l3
    for got, want in zip(s2, s3):
        assert torch.equal(got, want)
    assert int(s3.step) == 15
    with open(os.path.join(path, vae.LOSSES_FILE)) as f:
        assert json.load(f) == l2
    # a finished run resumes to itself without a step
    _, s4, l4 = vae.train(0, cfg3, channels, a, SNRS, qs, verbose=False,
                          checkpoint_path=path)
    assert l4 == l2 and all(torch.equal(x, y) for x, y in zip(s4, s2))


def _state(seed=0, n=6):
    g = torch.Generator().manual_seed(seed)
    return vae.VaeTrainState(torch.randn(n, generator=g),
                             torch.randn(n, generator=g),
                             torch.rand(n, generator=g),
                             torch.tensor(seed, dtype=torch.int32),
                             torch.tensor(2 * seed, dtype=torch.int32))


def test_retention_keeps_the_newest(tmp_path):
    with TrainCheckpointer(str(tmp_path), max_to_keep=2) as ck:
        assert ck.latest_step() is None
        for step in range(5):
            assert ck.save(step, _state(step))
        assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
        assert sorted(os.listdir(tmp_path)) == ["torch_step_3.pt",
                                                "torch_step_4.pt"]
        got = ck.restore(4, _state(0))
        assert all(torch.equal(x, y) for x, y in zip(got, _state(4)))
    unlimited = TrainCheckpointer(str(tmp_path / "all"), max_to_keep=None)
    for step in range(5):
        unlimited.save(step, _state(step))
    assert unlimited.all_steps() == list(range(5))


def test_a_failed_save_leaves_the_last_commit_whole(tmp_path, monkeypatch):
    ck = TrainCheckpointer(str(tmp_path), max_to_keep=3)
    ck.save(0, _state(1))
    real_save = torch.save

    def crash(obj, path):
        with open(path, "wb") as f:        # a partial write, then a fault
            f.write(b"partial")
        raise OSError("disk fault")

    monkeypatch.setattr(ckpt_mod.torch, "save", crash)
    with pytest.raises(OSError, match="disk fault"):
        ck.save(1, _state(2))
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    assert ck.latest_step() == 0            # the stray temporary is ignored
    assert not os.path.exists(ck.path(1))
    got = ck.restore(ck.latest_step(), _state(0))
    assert all(torch.equal(x, y) for x, y in zip(got, _state(1)))
    assert ck.save(1, _state(2))
    assert ck.latest_step() == 1


def test_save_interval_and_force(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), save_interval_steps=2)
    assert ck.save(0, _state(1)) and not ck.save(1, _state(1))
    assert ck.save(1, _state(1), force=True)
    assert not ck.save(1, _state(2))        # committed already
    assert ck.save(1, _state(2), force=True)
    got = ck.restore(1, _state(0))
    assert torch.equal(got.params, _state(2).params)


def test_restore_onto_the_example_devices_and_structure(tmp_path):
    ck = TrainCheckpointer(str(tmp_path))
    tree = {"state": _state(3), "extra": [torch.arange(4),
                                          torch.ones(2, 2)]}
    ck.save(7, tree)
    assert ck.restore(None, tree) is tree
    example = {"extra": [torch.zeros(4, dtype=torch.int64,
                                     device="meta"),
                         torch.zeros(2, 2)],
               "state": vae.VaeTrainState(*(torch.zeros_like(x)
                                            for x in _state(0)))}
    got = ck.restore(7, example)
    assert list(got) == ["extra", "state"]
    assert isinstance(got["state"], vae.VaeTrainState)
    assert got["extra"][0].device.type == "meta"
    assert got["extra"][1].device.type == "cpu"
    assert torch.equal(got["extra"][1], torch.ones(2, 2))
    assert all(torch.equal(x, y) for x, y in zip(got["state"], _state(3)))
    data = torch.load(ck.path(7), weights_only=True)
    assert data["step"] == 7 and len(data["leaves"]) == 7


@pytest.mark.parametrize("example", [
    lambda: vae.VaeTrainState(*(torch.zeros(7) for _ in range(5))),
    lambda: vae.VaeTrainState(*(torch.zeros(6, dtype=torch.float64)
                                for _ in range(5))),
    lambda: [torch.zeros(6)],
])
def test_restore_refuses_another_layout(tmp_path, example):
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(0, _state(1))
    with pytest.raises(ValueError, match="checkpoint step 0"):
        ck.restore(0, example())


def test_states_of_other_types_are_refused(tmp_path):
    with pytest.raises(TypeError, match="tensors"):
        TrainCheckpointer(str(tmp_path)).save(0, {"x": np.zeros(3)})
