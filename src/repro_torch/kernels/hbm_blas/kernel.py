"""Wrappers around the hand-written CUDA BLAS kernels (``csrc/hbm_blas.cu``).

Replace the TPU kernels ``repro/kernels/hbm_blas/kernel.py::axpy``,
``::dot_partials`` and ``::gemv``.  Each wrapper checks its operands,
allocates the output (and ``dot_partials``' chunk partials), launches on
PyTorch's current stream and counts the launch.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import block_count

#: Launches of each CUDA kernel (dot_partials: its two passes together).
AXPY_LAUNCHES = build.LaunchCounter("axpy")
DOT_PARTIALS_LAUNCHES = build.LaunchCounter("dot_partials")
GEMV_LAUNCHES = build.LaunchCounter("gemv")


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name}: fp32 only, got "
                        f"{[str(t.dtype) for t in ts]}")
    if any(t.dim() != 2 for t in ts):
        raise ValueError(f"{name}: 2-D operands, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")


def axpy(a, x: torch.Tensor, y: torch.Tensor,
         block_rows: int = 256) -> torch.Tensor:
    """fmaf(a, x, y) elementwise; x, y: [R, C] fp32, ``a`` a scalar (cast
    to fp32); ``R % min(block_rows, R) == 0``."""
    _check("axpy", x, y)
    if x.shape != y.shape:
        raise ValueError(f"axpy: x {tuple(x.shape)} and y {tuple(y.shape)}")
    block_count(x.shape[0], block_rows)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.library()
    err = lib.repro_axpy_f32(float(a), x.data_ptr(), y.data_ptr(),
                             out.data_ptr(), x.numel(),
                             build.stream_handle(x.device))
    build.check(err, "axpy")
    AXPY_LAUNCHES.count += 1
    return out


def dot_partials(x: torch.Tensor, y: torch.Tensor,
                 block_rows: int = 256) -> torch.Tensor:
    """Per-block sums of x·y: [R, C] fp32 → [R // block_rows, 1]."""
    _check("dot_partials", x, y)
    if x.shape != y.shape:
        raise ValueError(f"dot_partials: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)}")
    R, C = x.shape
    nblk = block_count(R, block_rows)
    out = torch.empty((nblk, 1), dtype=torch.float32, device=x.device)
    if C == 0:
        return out.zero_()
    lib = build.library()
    block_elems = (R // nblk) * C
    chunks = -(-block_elems // lib.repro_dot_chunk())
    part = torch.empty(nblk * chunks, dtype=torch.float32, device=x.device)
    err = lib.repro_dot_partials_f32(x.data_ptr(), y.data_ptr(),
                                     part.data_ptr(), out.data_ptr(), nblk,
                                     block_elems,
                                     build.stream_handle(x.device))
    build.check(err, "dot_partials")
    DOT_PARTIALS_LAUNCHES.count += 1
    return out


def gemv_vector_loads(A: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether the gemv kernel reads A [M, N] and x [1, N] (contiguous fp32)
    in 16-byte loads: N % 4 == 0 and both start 16-byte aligned, so that
    every row does.  Otherwise every row takes the scalar path, which sums
    in the same order.  Reads shapes and pointers only, never M or the
    device."""
    return (A.shape[1] % 4 == 0 and A.data_ptr() % 16 == 0
            and x.data_ptr() % 16 == 0)


def gemv(A: torch.Tensor, x: torch.Tensor,
         block_rows: int = 256) -> torch.Tensor:
    """A @ x by rows: A [M, N], x [1, N] fp32 → [M, 1]."""
    _check("gemv", A, x)
    M, N = A.shape
    if x.shape != (1, N):
        raise ValueError(f"gemv: A {tuple(A.shape)} needs x [1, {N}], got "
                         f"{tuple(x.shape)}")
    block_count(M, block_rows)
    out = torch.empty((M, 1), dtype=torch.float32, device=A.device)
    if N == 0:
        return out.zero_()
    lib = build.library()
    err = lib.repro_gemv_f32(A.data_ptr(), x.data_ptr(), out.data_ptr(), M,
                             N, int(gemv_vector_loads(A, x)),
                             build.stream_handle(A.device))
    build.check(err, "gemv")
    GEMV_LAUNCHES.count += 1
    return out
