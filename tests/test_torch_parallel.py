"""The port's data and tensor parallelism (`parallel.mesh`: the
data-parallel k-means, GMM and MFA fits, the sharded estimators) in a
2-rank Gloo group on the CPU, against the single-device results of the
same inputs; one dense tensor-parallel case against JAX's
`estimate_sharded_kernel` on the virtual CPU mesh. The sharded harness
runs are held in tests/test_torch_harness.py.

One group is spawned for the whole file (`tests/_torch_parallel_worker.py`,
two processes joined through a file store) and its results are read by the
tests below; a hang fails the fixture at its timeout instead of holding the
suite. The arguments of `distributed.initialize` need no group.

Tolerances: the fits' lower bounds per iteration rtol 2e-5 (the EM
statistics summed in another order, as ROADMAP Queue 3 holds the port's EM
against JAX); k-means centres 1e-5 with identical labels; estimates 2e-5
of the output scale (the shard states merged across ranks in another
order).
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_channel_estimation_tpu.models import (
    gmm_estimator as jgmm_estimator)
from quantized_channel_estimation_tpu.parallel import mesh as jmesh
from quantized_channel_estimation_torch.harness import stages
from quantized_channel_estimation_torch.parallel import distributed

torch.set_num_threads(2)

WORKER = pathlib.Path(__file__).parent / "_torch_parallel_worker.py"
sys.path.insert(0, str(WORKER.parent))
import _torch_parallel_worker as worker  # noqa: E402

TIMEOUT = 300


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    """Run the 2-rank group once; the two ranks' saved results."""
    try:
        return worker.spawn_group(tmp_path_factory.mktemp("gloo2"), "mesh",
                                  TIMEOUT)
    except RuntimeError as err:
        pytest.fail(str(err))


def _close(got, want, tol=2e-5):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape
    scale = float(want.abs().max()) or 1.0    # zero means: absolute
    err = float((got - want).abs().max()) / scale
    assert err <= tol, err


def test_dp_kmeans_matches_the_single_device_run(group_results):
    res = group_results
    for rank in range(2):
        (centers, labels), (c1, l1) = res[rank]["kmeans"]
        assert torch.equal(labels, l1)
        np.testing.assert_allclose(centers, c1, atol=1e-5)


@pytest.mark.parametrize("name", sorted(worker.GMM_FITS))
def test_dp_gmm_em_matches_the_single_device_fit(group_results, name):
    res = group_results
    (lb, params), (lb1, params1) = res[0][f"gmm/{name}"]
    assert len(lb) == len(lb1) == worker.GMM_BASE["max_iter"]
    np.testing.assert_allclose(lb, lb1, rtol=2e-5)
    for got, want in zip(params, params1):
        _close(got, want, 1e-4)
    # both ranks run the same M-step
    (lb_r1, params_r1), _ = res[1][f"gmm/{name}"]
    assert lb_r1 == lb
    for a, b in zip(params, params_r1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(worker.MFA_FITS))
def test_dp_mfa_em_matches_the_single_device_fit(group_results, name):
    res = group_results
    (ll, params), (ll1, params1) = res[0][f"mfa/{name}"]
    np.testing.assert_allclose(ll, ll1, rtol=2e-5)
    for got, want in zip(params, params1):
        _close(got, want, 2e-4)
    assert res[1][f"mfa/{name}"][0][0] == ll


PATHS = ["kernel_flat", "kernel_flat_einsum", "kernel_coh_1.0",
         "kernel_coh_0.5", "topk2", "p0.9", "coh_top1", "circ_p1_flat",
         "circ_p1_coh", "circ_p2_flat", "circ_p2_coh", "fact_flat",
         "fact_coh"]


@pytest.mark.parametrize("mesh", ["data2", "comp2"])
@pytest.mark.parametrize("path", PATHS)
def test_sharded_estimators_match_the_single_device_stage(group_results,
                                                          mesh, path):
    res = group_results
    for rank in range(2):
        got, want = res[rank][f"{mesh}/{path}"]
        _close(got, want)


def test_dense_tp_matches_jax_estimate_sharded_kernel(group_results):
    """The port's (1, 2)-mesh K2 merge against JAX's shard_map form (its
    einsum stats path off the TPU) on the same bank and rows."""
    res = group_results
    fields, r, got = res[0]["jax_case"]
    bank = jgmm_estimator.PreparedBank(*(jnp.asarray(x) for x in fields))
    mesh = jmesh.make_mesh(1, 2, jax.devices()[:2])
    want = np.asarray(jmesh.estimate_sharded_kernel(mesh, bank,
                                                    jnp.asarray(r)))
    _close(got, want)


def test_sharded_stages_are_none_on_one_rank():
    assert stages.sharded_stages(1, 1) is None


def test_initialize_takes_all_or_none_of_the_manual_arguments():
    for args in (("localhost:1234", None, None), (None, 2, 0),
                 ("localhost:1234", 2, None)):
        with pytest.raises(ValueError, match="ALL of"):
            distributed.initialize(*args)
