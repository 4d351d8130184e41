"""Multi-iteration Dilate (the paper sweeps 64–512 iterations).

On a CUDA tensor every pass launches the hand-written kernel
(:func:`.kernel.dilate`); a CPU tensor takes the plain version.  Any other
device raises — nothing falls back.
"""
from __future__ import annotations

import torch

from .kernel import DEFAULT_BLOCK_ROWS, dilate
from .ref import dilate_iters_ref, dilate_ref


def dilate_op(img: torch.Tensor, iters: int = 1,
              block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """``iters`` dilation passes over ``img`` [H, W] (``img`` is not
    modified).  ``block_rows`` is the height of the strip each warp of
    the kernel walks down."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if img.device.type == "cpu":
        return dilate_iters_ref(img, iters)
    if img.device.type != "cuda":
        raise ValueError(f"dilate_op: no kernel for device {img.device}")
    if iters == 0:
        return img
    # Ping-pong between two buffers; the input token stays untouched.
    bufs = [torch.empty_like(img), torch.empty_like(img)]
    src = img
    for i in range(iters):
        src = dilate(src, bufs[i % 2], block_rows=block_rows)
    return src


__all__ = ["dilate_op", "dilate_ref", "dilate_iters_ref"]
