"""PyTorch/CUDA port of `quantized_channel_estimation_tpu` for NVIDIA Hopper.

The JAX package is the reference: every module here names the JAX module it
reproduces, and its tests (`tests/test_torch_*.py`) feed the same numpy
inputs to both. Plain tensor code is PyTorch; the estimation kernel that the
JAX package wrote in Pallas for the TPU is hand-written CUDA C++ for
`sm_90a` under `csrc/`, built with `nvcc` at first use.

Entry points (`harness.run_gmm.run`, the `harness.stages` generators) run on
`cuda` unless the caller passes `device="cpu"`; without a card and without
an explicit device they raise instead of quietly running on the CPU.
"""
