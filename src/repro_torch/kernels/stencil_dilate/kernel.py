"""Wrapper around the hand-written CUDA dilate kernel (``csrc/dilate.cu``).

Replaces the TPU kernel ``repro/kernels/stencil_dilate/kernel.py::dilate``.
"""
from __future__ import annotations

import torch

from .. import build

DEFAULT_BLOCK_ROWS = 256
#: Launches of the CUDA kernel (one per dilation pass).
LAUNCHES = build.LaunchCounter("dilate")


def dilate(img: torch.Tensor, out: torch.Tensor,
           block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """One dilation pass ``img`` → ``out`` on ``img``'s CUDA device.

    ``img`` and ``out`` are distinct contiguous fp32 ``[H, W]`` tensors;
    ``block_rows`` is the height of the tile each thread block computes.
    """
    if img.device.type != "cuda" or out.device != img.device:
        raise ValueError("dilate: img and out must be on one CUDA device")
    if img.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"dilate: fp32 only, got {img.dtype}/{out.dtype}")
    if img.dim() != 2 or out.shape != img.shape:
        raise ValueError(f"dilate: [H, W] in and out, got {tuple(img.shape)}"
                         f" -> {tuple(out.shape)}")
    if not (img.is_contiguous() and out.is_contiguous()):
        raise ValueError("dilate: img and out must be contiguous")
    if out.data_ptr() == img.data_ptr():
        raise ValueError("dilate: out must not alias img")
    if not 1 <= block_rows <= 1024:
        raise ValueError(f"dilate: block_rows must be in 1..1024, got "
                         f"{block_rows}")
    H, W = img.shape
    lib = build.library()
    err = lib.repro_dilate_f32(img.data_ptr(), out.data_ptr(), H, W,
                               block_rows, build.stream_handle(img.device))
    build.check(err, "dilate")
    LAUNCHES.count += 1
    return out
