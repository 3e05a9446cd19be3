"""The user examples of the port: one module for each script of the JAX
repository's `examples/`, under the same file name, each calling only the
port's entry points.

    python -m quantized_channel_estimation_torch.examples.01_quickstart_estimation
    python -m quantized_channel_estimation_torch.examples.06_coherence_blocks --device cpu
    torchrun --nproc-per-node=2 -m quantized_channel_estimation_torch.examples.03_multichip --device cpu

Each runs on the CUDA card by default and on the CPU with `--device cpu`;
without a card and without `--device` it raises. Each module has
`main(device=None, **sizes) -> dict`, which prints what the JAX script
prints and returns those numbers; the sizes default to the JAX script's.
The names start with a digit, so code loads them with `load`
(`importlib.import_module`). Nothing runs at import.
"""
from __future__ import annotations

import importlib

NAMES = ("01_quickstart_estimation", "02_train_without_csi", "03_multichip",
         "04_vae_estimator", "05_segmented_checkpointed_fit",
         "06_coherence_blocks", "07_serving", "08_structured_banks",
         "09_factored_mfa_banks", "10_mesh_harness")


def load(name: str):
    """The example module `name` (one of `NAMES`, or its number '01' to
    '10')."""
    full = [n for n in NAMES if n == name or n.split("_", 1)[0] == name]
    if len(full) != 1:
        raise ValueError(f"no example named {name!r}; the examples are "
                         f"{', '.join(NAMES)}")
    return importlib.import_module(f"{__name__}.{full[0]}")
