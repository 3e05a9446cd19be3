"""Miscellaneous utilities: hyperparameter samplers (Bergstra-Bengio random
search) and console / CSV helpers.

Port of `quantized_channel_estimation_tpu/utils/misc.py` (its own copy, all
five functions). `rand_exp` draws with numpy exactly as the JAX package's
copy does, so a random search of either package draws the same trials from
the same seed.
"""
from __future__ import annotations

import csv
from typing import Tuple

import numpy as np


def rand_exp(left: float, right: float, shape: Tuple[int, ...] = (1,),
             seed=None) -> np.ndarray:
    """Log-uniform sampling in [left, right] ("Random Search for
    Hyper-Parameter Optimization", Bergstra & Bengio). `seed` is anything
    `np.random.default_rng` takes, a Generator included."""
    if left <= 0:
        raise ValueError(f"left needs to be positive but is {left}")
    if right <= left:
        raise ValueError(f"right needs to be larger than left: {left}, {right}")
    rng = np.random.default_rng(seed)
    return np.exp(np.log(left) + rng.random(shape)
                  * (np.log(right) - np.log(left)))


def rand_geom(left: float, right: float, shape: Tuple[int, ...] = (1,),
              seed=None) -> np.ndarray:
    """Log-uniform integers."""
    return np.round(rand_exp(left, right, shape, seed)).astype(int)


def sec2hours(seconds: float) -> str:
    """hh:mm:ss."""
    h = seconds // 3600
    r = seconds % 3600
    return "{:.0f}:{:02.0f}:{:02.0f}".format(h, r // 60, r % 60)


def print_dict(d: dict, entries_per_row: int = 1) -> None:
    """Key/value console dump, `entries_per_row` pairs a line."""
    if entries_per_row < 1:
        raise ValueError(
            f"entries per row needs to be >= 1 but is {entries_per_row}")
    for c, (key, value) in enumerate(d.items()):
        if c % entries_per_row == 0 and c > 0:
            print()
        elif c > 0:
            print(" | ", end="")
        print(f"{key}: {value}", end="")
    print()


def dict_to_csv(d: dict, filename: str = "dict.csv") -> None:
    """(key, value) rows; the VAE runs' params CSVs."""
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f)
        for key, val in d.items():
            writer.writerow((key, val))
