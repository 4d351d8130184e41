"""Wrapper around the hand-written CUDA matmul kernel (``csrc/matmul.cu``).

Replaces the TPU kernel ``repro/kernels/systolic_matmul/kernel.py::matmul``.
"""
from __future__ import annotations

import torch

from .. import build

#: Launches of the CUDA kernel.
LAUNCHES = build.LaunchCounter("matmul")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] → [M, N], fp32 in, fp32 accumulator, fp32 out,
    on ``a``'s CUDA device."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("matmul: a and b must be on one CUDA device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul: fp32 only, got {a.dtype}/{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: [M, K] x [K, N], got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: a and b must be contiguous")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.library()
    err = lib.repro_matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               M, N, K, build.stream_handle(a.device))
    build.check(err, "matmul")
    LAUNCHES.count += 1
    return out
