"""Wrapper around the hand-written CUDA matmul kernels (``csrc/matmul.cu``).

Both replace the TPU kernel ``repro/kernels/systolic_matmul/kernel.py::
matmul``.  :func:`route` picks one per call by a fixed rule: the narrow
kernel (one warp per row of A, B in shared memory) for N <= 16 when B,
transposed and padded, fits its 48 KB of shared memory; the tiled kernel
(64 x 64 output tiles) otherwise.
"""
from __future__ import annotations

import torch

from .. import build

#: Launches of either kernel.
LAUNCHES = build.LaunchCounter("matmul")
NARROW_MAX_N = 16
NARROW_SMEM_BYTES = 48 * 1024


def route(M: int, K: int, N: int) -> str:
    """``"narrow"`` or ``"tiled"``: the kernel that takes [M, K] x [K, N].
    Narrow for N <= 16 when B, transposed with N padded to a power of two
    and K to a multiple of 4, fits 48 KB of shared memory."""
    if N > NARROW_MAX_N:
        return "tiled"
    padded_n = 1 << (N - 1).bit_length()
    padded_k = -(-K // 4) * 4
    fits = padded_n * padded_k * 4 <= NARROW_SMEM_BYTES
    return "narrow" if fits else "tiled"


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] → [M, N], fp32 in, fp32 accumulator, fp32 out,
    on ``a``'s CUDA device, from the kernel that :func:`route` picks."""
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
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=a.device)
    launch = _launch_narrow if route(M, K, N) == "narrow" else _launch_tiled
    return launch(a, b)


def _launch_narrow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The narrow kernel on operands that :func:`matmul` has checked; the
    kernel refuses a product that :func:`route` sends to the tiled one."""
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    vec = int(K % 4 == 0 and a.data_ptr() % 16 == 0)
    err = build.library().repro_matmul_narrow_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, vec,
        build.stream_handle(a.device))
    build.check(err, "matmul (narrow)")
    LAUNCHES.count += 1
    return out


def _launch_tiled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tiled kernel, which takes every product that :func:`matmul`
    accepts."""
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = build.library().repro_matmul_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        build.stream_handle(a.device))
    build.check(err, "matmul")
    LAUNCHES.count += 1
    return out
