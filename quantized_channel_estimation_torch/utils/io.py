"""Result CSV writers and dataset/model caches.

Port of `quantized_channel_estimation_tpu/utils/io.py` (its own copy: the
port imports nothing of the JAX package). The CSV schema mirrors the
reference's transposed tables (an 'SNR' header row, one column per
estimator); caches are config-keyed .npz files that both packages read and
write: `load_gmm_arrays` reads the `leaf_0..leaf_3` npz the JAX package's
`save_pytree_npz` writes, and `save_gmm_params` writes one its
`load_gmm_params` accepts.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

import numpy as np


def write_result_csv(path: str, snrs: Sequence[float],
                     columns: Dict[str, Sequence[float]],
                     index_name: str = "SNR") -> None:
    """Write a transposed result table: first column SNR (or `index_name`),
    then one column per estimator."""
    rows: List[list] = [[index_name] + [str(s) for s in snrs]]
    for name, vals in columns.items():
        rows.append([name] + [repr(float(v)) for v in vals])
    rows = [list(r) for r in zip(*rows)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


def dataset_cache_path(root: str, n_antennas: int, model_type: str,
                       n_path: int, n_train: int, n_channels: int) -> str:
    return os.path.join(
        root, f"saved_data_ant={n_antennas}_model={model_type}"
              f"_paths={n_path}_ntrain={n_train}_nchan={n_channels}.npz")


def save_channels(path: str, channels: np.ndarray, toep: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, channels=channels, toep=toep)


def load_channels(path: str):
    data = np.load(path)
    return data["channels"], data["toep"]


def gmm_cache_path(root: str, n_antennas: int, n_components: int,
                   model_type: str, n_path: int, n_train: int,
                   cov_type: str, zero_mean: bool) -> str:
    return os.path.join(
        root, f"trained_gmm_ant={n_antennas}_comp={n_components}"
              f"_model={model_type}_paths={n_path}_ntrain={n_train}"
              f"_covtype={cov_type}_zeromean={zero_mean}.npz")


def save_gmm_params(path: str, params) -> None:
    """Persist GMM parameters (weights, means, covariances, prec_chol; numpy
    arrays or tensors) as the `leaf_i` npz of the JAX package's cache."""
    leaves = [np.asarray(p.detach().cpu() if hasattr(p, "detach") else p)
              for p in params]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, treedef=np.asarray("GmmParams(weights, means, "
                                      "covariances, prec_chol)"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_gmm_arrays(path: str):
    """(weights, means, covariances, prec_chol) numpy arrays of a GMM npz
    written by either package."""
    data = np.load(path, allow_pickle=True)
    return tuple(data[f"leaf_{i}"] for i in range(4))


def load_gmm_params(path: str, device=None):
    """A GMM npz of either package as port `GmmParams` on `device`."""
    from quantized_channel_estimation_torch.models.gmm import (
        params_from_numpy)
    return params_from_numpy(load_gmm_arrays(path), device)
