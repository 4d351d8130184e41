"""The memory-bound BLAS ops.

On a CUDA tensor each op launches its hand-written kernel (:mod:`.kernel`);
a CPU tensor takes the plain version (:mod:`.ref`).  Any other device
raises — nothing falls back.  :func:`dot_op` and :func:`axpydot_op` fold
the per-block partials with :func:`fold_partials`.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from .kernel import axpy, dot_partials, gemv
from .ref import (axpy_ref, axpydot_ref, dot_partials_ref, dot_ref,
                  gemv_ref)


def _pick(name: str, t: torch.Tensor, kernel: Callable, plain: Callable):
    if t.device.type == "cpu":
        return plain
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return kernel


def axpy_op(a, x: torch.Tensor, y: torch.Tensor,
            block_rows: int = 256) -> torch.Tensor:
    """a*x + y (one rounding).  x, y: [R, C]; R % block_rows == 0."""
    return _pick("axpy_op", x, axpy, axpy_ref)(a, x, y, block_rows)


def dot_partials_op(x: torch.Tensor, y: torch.Tensor,
                    block_rows: int = 256) -> torch.Tensor:
    """Per-block partial sums of x·y: [R, C] → [R // block_rows, 1]."""
    return _pick("dot_partials_op", x, dot_partials, dot_partials_ref)(
        x, y, block_rows)


def gemv_op(A: torch.Tensor, x: torch.Tensor,
            block_rows: int = 256) -> torch.Tensor:
    """A @ x with row-block tiling.  A: [M, N]; x: [1, N] → [M, 1]."""
    return _pick("gemv_op", A, gemv, gemv_ref)(A, x, block_rows)


def fold_partials(partials: Union[torch.Tensor, Sequence[torch.Tensor]]
                  ) -> torch.Tensor:
    """Sequential left fold of per-shard partials, in index order.

    Shared by the ops and the app graphs' reduce tasks: one canonical
    reduction order makes decomposed == monolithic bit for bit.  Takes a
    [nblk, 1] tensor or a list of scalar tensors; the adds run on the
    partials' device, driven from the host.
    """
    if isinstance(partials, torch.Tensor):
        parts = [partials[i, 0] for i in range(partials.shape[0])]
    else:
        parts = list(partials)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def dot_op(x: torch.Tensor, y: torch.Tensor,
           block_rows: int = 256) -> torch.Tensor:
    """x·y via per-block partials folded in block order (bit-fixed)."""
    return fold_partials(dot_partials_op(x, y, block_rows))


def axpydot_op(a, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               block_rows: int = 256) -> torch.Tensor:
    """(a*x + y)·w — the fused two-stage workload."""
    return dot_op(axpy_op(a, x, y, block_rows), w, block_rows)


__all__ = ["axpy_op", "axpydot_op", "axpy_ref", "axpydot_ref", "dot_op",
           "dot_partials_op", "dot_partials_ref", "dot_ref", "fold_partials",
           "gemv_op", "gemv_ref"]
