"""The units the tensor-core kernels stream, and the plain walk of their
products.

Shared by the circulant (`circ_kernels`, `mp_circ_kernels`) and factored
(`fact_kernels`) kernels, whose narrow templates and wide forms
(`csrc/wide_gemm.cuh`) read a bank's operands as units: the 64 x 64
transpose of one 64-column piece of an operand over one 64-deep
contraction chunk, in three bf16 planes (`kernels.split_planes3`) and the
128-byte swizzle (`kernels._sw128`), padding zero. `six` is one chunk's
six exact bf16 products into fp32, and `walked` a whole product as the
wide forms run it: a fresh result a chunk, the chunks in a compensated
sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from quantized_channel_estimation_torch.estimators import kernels
from quantized_channel_estimation_torch.estimators.variant_kernels import (
    tc_products)


def chunks(w: int) -> int:
    """64-deep chunks (or 64-wide pieces) of a width w."""
    return -(-w // 64)


class UnitOperands(NamedTuple):
    """A bank as a kernel streams it: the bf16 planes of its operands as
    the sequence of units one tile consumes, in the order the kernel's
    layout function gives (`mp_circ_tc_units`, `circ_wide_tc_units`,
    `fact_wide_tc_units`, ...). The same for every (T, alpha) layout of a
    bank: those differ in `const` only, which the kernel reads from the
    layout.

    hi, lo, lo2: (units, 64, 64) bfloat16
    """
    hi: torch.Tensor
    lo: torch.Tensor
    lo2: torch.Tensor


def blocks(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(R, C) zero-padded to (rows, cols) -> (rows / 64, cols / 64, 64, 64):
    block [c, j] is the transpose of rows [64 c, 64 c + 64) x columns
    [64 j, 64 j + 64)."""
    w = torch.nn.functional.pad(w, (0, cols - w.shape[1],
                                    0, rows - w.shape[0]))
    return w.reshape(rows // 64, 64, cols // 64, 64).permute(0, 2, 3, 1)


def piece_major(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(R, C) -> its units (cols / 64 pieces, rows / 64 chunks, 64, 64),
    unit (j, c) the transpose of rows [64 c, 64 c + 64) x columns [64 j,
    64 j + 64), padding zero."""
    return blocks(w, rows, cols).transpose(0, 1)


def check_units(kernel: str, ops: UnitOperands, units: int, device,
                source: str) -> None:
    """Raise unless ops holds `units` units on `device`, as `source` lays
    them out."""
    shape = (units, 64, 64)
    for name, t in zip(UnitOperands._fields, ops):
        if (t is None or t.device != device or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape or not t.is_contiguous()):
            got = ("None" if t is None
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"{kernel}: operand {name} must be contiguous "
                             f"torch.bfloat16 {shape} on {device} "
                             f"(`{source}`), got {got}")


def six(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The six bf16 products of rows (n, c) and one c-deep chunk w (c,
    cols), both split into hi, lo, lo2, summed in the kernel's order
    (`variant_kernels.tc_products`) into a fresh float32 result."""
    return tc_products(rows, [pl.to(rows.dtype)
                              for pl in kernels.split_planes3(w)], 6)


def kahan(total: torch.Tensor, lost: torch.Tensor, part: torch.Tensor):
    """total += part in a compensated (Kahan) sum: total - lost is the
    running value, lost the rounding error total has taken on."""
    y = part - lost
    nxt = total + y
    return nxt, (nxt - total) - y


def walked(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows @ w as the wide forms' products run: the contraction
    zero-padded to whole 64-deep chunks, each chunk's `six` added in a
    compensated (Kahan) sum; the value total - lost."""
    width = 64 * chunks(rows.shape[1])
    rows = torch.nn.functional.pad(rows, (0, width - rows.shape[1]))
    w = torch.nn.functional.pad(w, (0, 0, 0, width - w.shape[0]))
    total = lost = torch.zeros(rows.shape[0], w.shape[1], dtype=rows.dtype,
                               device=rows.device)
    for c in range(0, width, 64):
        total, lost = kahan(total, lost, six(rows[:, c:c + 64], w[c:c + 64]))
    return total - lost
