"""fp32 pin for matrix products.

Port of `quantized_channel_estimation_tpu/ops/precision.py`. On the TPU the
default matmul precision multiplies in bfloat16, which NaNs the EM
factorizations at D=64 and corrupts prepared banks at high SNR; the JAX
package wraps covariance-level code in `highest_precision`. The CUDA
counterpart of that hazard is TF32: PyTorch runs float32 matmuls in full
fp32 by default but lets cuDNN use TF32, and either switch can be flipped by
other code in the process. TF32 keeps ~3 decimal digits, the same order as
the TPU's bfloat16 passes, so the port pins both off before any fp32 work.
"""
from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Forbid TF32 in cuBLAS matmuls and cuDNN convolutions (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
