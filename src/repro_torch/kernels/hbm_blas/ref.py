"""Plain PyTorch versions of the memory-bound BLAS kernels.

Each has its kernel's signature and block semantics: arrays are 2-D
``[rows, lanes]`` cut into ``[block_rows, lanes]`` row blocks, with
``rows % block_rows == 0`` (``block_rows`` capped at ``rows``).

* :func:`axpy_ref` rounds once, as the kernel's ``fmaf`` and the JAX
  package's CPU result do: ``a * x + y`` in float64 (the product of two
  floats is exact there), rounded to float32.  ``a * x + y`` in float32
  would round twice.
* :func:`dot_partials_ref` sums each row block's view separately.
* :func:`gemv_ref` is the row-wise multiply plus a lane sum
  (``sum(dim=1)``), block by block, as the kernel does it — not ``A @ x.T``.
* :func:`dot_ref` and :func:`axpydot_ref` are whole-array oracles with no
  blocks, as the JAX package's.

The sums run in torch's own order, not the kernels': a kernel and its plain
version agree within a stated tolerance, not bit for bit.  Each function
gives a block the same bits whether it is called on the block alone or on
an array that holds it, since both calls sum the same view.
"""
from __future__ import annotations

import torch


def block_count(rows: int, block_rows: int) -> int:
    """Row blocks of ``min(block_rows, rows)`` rows; raises unless they
    tile ``rows`` exactly."""
    br = min(int(block_rows), int(rows))
    if br < 1 or rows % br:
        raise ValueError(f"rows ({rows}) must be a positive multiple of "
                         f"block_rows ({block_rows})")
    return rows // br


def _axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    a32 = float(torch.tensor(float(a), dtype=torch.float32))
    return (a32 * x.double() + y.double()).to(x.dtype)


def axpy_ref(a, x: torch.Tensor, y: torch.Tensor,
             block_rows: int = 256) -> torch.Tensor:
    """fp32 ``a * x + y`` with one rounding; x, y: [R, C]."""
    block_count(x.shape[0], block_rows)
    return _axpy(a, x, y)


def dot_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x·y as one sum over the whole arrays (any shape, no blocks), as the
    JAX package's oracle: a 0-d tensor."""
    return (x * y).sum()


def axpydot_ref(a, x: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """(a*x + y)·w over the whole arrays: :func:`dot_ref` of the
    one-rounding axpy."""
    return dot_ref(_axpy(a, x, y), w)


def dot_partials_ref(x: torch.Tensor, y: torch.Tensor,
                     block_rows: int = 256) -> torch.Tensor:
    """Per-block partial sums of x·y: [R, C] → [R // block_rows, 1]."""
    R = x.shape[0]
    nblk = block_count(R, block_rows)
    br = R // nblk
    return torch.stack([(x[i * br:(i + 1) * br] * y[i * br:(i + 1) * br]
                         ).sum() for i in range(nblk)]).reshape(nblk, 1)


def gemv_ref(A: torch.Tensor, x: torch.Tensor,
             block_rows: int = 256) -> torch.Tensor:
    """A @ x by rows: A [M, N], x [1, N] → [M, 1]."""
    M = A.shape[0]
    nblk = block_count(M, block_rows)
    br = M // nblk
    return torch.cat([(A[i * br:(i + 1) * br] * x).sum(dim=1, keepdim=True)
                      for i in range(nblk)], dim=0)
