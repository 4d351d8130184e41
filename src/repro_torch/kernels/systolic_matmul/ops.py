"""Blocked matmul + im2col conv (VGG conv3).

On a CUDA tensor :func:`matmul_op` launches the hand-written kernel
(:func:`.kernel.matmul`); a CPU tensor takes the plain version.  Any other
device raises — nothing falls back.  :func:`conv_op` builds the im2col
columns in PyTorch and multiplies them through :func:`matmul_op`.
"""
from __future__ import annotations

import torch

from .kernel import matmul
from .ref import conv_im2col_ref, im2col3x3, matmul_ref


def matmul_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] → [M, N] with an fp32 accumulator."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_op: no kernel for device {a.device}")
    return matmul(a, b)


def conv_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 same conv via im2col + the systolic matmul.
    x: [H, W, Cin]; w: [3, 3, Cin, Cout] → [H, W, Cout]."""
    H, W, Cin = x.shape
    Cout = w.shape[-1]
    out = matmul_op(im2col3x3(x), w.reshape(9 * Cin, Cout).contiguous())
    return out.reshape(H, W, Cout)


__all__ = ["matmul_op", "conv_op", "matmul_ref", "conv_im2col_ref"]
