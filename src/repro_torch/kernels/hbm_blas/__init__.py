"""Memory-bound BLAS (axpy, dot, gemv, axpydot): plain versions, CUDA
kernels, dispatching ops.

Each op's block decomposition matches the HBM app graphs' shard
decomposition (one row block per shard), so a decomposed dataflow run
reproduces the op over the whole array bit for bit, reduction order
included (:func:`fold_partials`).
"""
from .ops import (axpy_op, axpydot_op, dot_op, dot_partials_op,
                  fold_partials, gemv_op)

__all__ = ["axpy_op", "axpydot_op", "dot_op", "dot_partials_op",
           "fold_partials", "gemv_op"]
