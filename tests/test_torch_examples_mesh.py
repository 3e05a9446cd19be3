"""The multi-rank user examples on the CPU: 03 (the data-parallel EM) and 10
(the mesh sweep) of `quantized_channel_estimation_torch.examples` over one
2-rank Gloo group, spawned once for this file
(tests/_torch_parallel_worker.py, job 'examples').

- 03: on both ranks the tensor-parallel estimate within 1e-5 of scale of
  the one-device one (its `check`); the data-parallel fit the same on both
  ranks and equal to the one-device fit's lower bound per iteration to
  rtol 2e-5 (float32 summation order).
- 10: at `--mesh 1x2` every row of the mesh sweep equals the single-device
  sweep's to rtol 1e-4 (its `check`); a mesh the group does not hold, or
  one without a group, raises with `stages.sharded_stages`' message.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_channel_estimation_torch import examples

torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_parallel_worker as worker  # noqa: E402

TIMEOUT = 300


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    """Run the 2-rank group once; the two ranks' results."""
    try:
        return worker.spawn_group(tmp_path_factory.mktemp("examples2"),
                                  "examples", TIMEOUT)
    except RuntimeError as err:
        pytest.fail(str(err))


def test_multichip_fits_over_two_ranks(group_results):
    ex = examples.load("03")
    for res in group_results:
        out = res["ex03"]
        assert out["ranks"] == 2
        ex.check(out)
    lb = [res["ex03"]["lb_history"] for res in group_results]
    assert lb[0] == lb[1]
    assert len(lb[0]) == worker.EX03["max_iter"]
    np.testing.assert_allclose(lb[0], group_results[0]["ex03_single_lb"],
                               rtol=2e-5)


def test_mesh_harness_rows_over_a_1x2_mesh(group_results):
    ex = examples.load("10")
    for res in group_results:
        out = res["ex10"]
        assert out["mesh"] == [1, 2]
        assert set(out["mesh_rows"]) == {"blmmse_glob", "blmmse_gmm"}
        ex.check(out)
        assert "needs torch.distributed initialised with 4 ranks (it has 2)" \
            in res["ex10_refused"]
    assert group_results[0]["ex10"]["mesh_rows"] == \
        group_results[1]["ex10"]["mesh_rows"]


def test_mesh_harness_needs_a_group_of_the_mesh(capsys):
    """Run alone (a one-rank group), the default 4 x 2 mesh raises before
    any work."""
    with pytest.raises(ValueError, match=r"initialised with 8 ranks "
                       r"\(it has 1\): launch the script under torchrun "
                       r"--nproc-per-node=8"):
        examples.load("10").main(device="cpu")
    assert capsys.readouterr().out == ""
    assert not torch.distributed.is_initialized()
