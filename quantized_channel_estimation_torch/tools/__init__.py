"""The kernel-measurement tools (port of the JAX repository's
`tools/kernel_bench.py`, `tools/kernel_split_bench.py`,
`tools/kernel_precision_experiment.py` and `tools/kernel_floor_probe.py`),
each run as a module:

    python -m quantized_channel_estimation_torch.tools.kernel_bench
    python -m quantized_channel_estimation_torch.tools.kernel_split_bench
    python -m quantized_channel_estimation_torch.tools.kernel_floor_probe

and `quant_frontier` (the JAX repository's `tools/quant_frontier.py`),
one CSI-free `run_gmm_quant` at frontier D, measured. On the card by
default; `--device cpu` runs the plain versions (small
sizes via the tools' options). Without a card and without `--device` they
raise."""
