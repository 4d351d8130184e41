"""Hand-written Hopper kernels for the paper's compute hot spots, the
memory-bound HBM workload set and the LM side's attention.

Each kernel directory holds ``ref.py`` (the plain PyTorch version),
``kernel.py`` (the ``ctypes`` wrapper of a CUDA source in
``repro_torch/csrc/``, with its launch counter) and ``ops.py`` (the public
op: the kernel for a CUDA tensor, the plain version for a CPU tensor).
:mod:`.build` compiles the CUDA sources at first use.
"""
from typing import Dict

from .flash_attention import kernel as _flash_kernel
from .flash_attention.ops import flash_attention_op
from .hbm_blas import kernel as _hbm_kernel
from .hbm_blas.ops import (axpy_op, axpydot_op, dot_op, dot_partials_op,
                           fold_partials, gemv_op)
from .knn import kernel as _knn_kernel
from .knn.ops import knn_op
from .stencil_dilate import kernel as _dilate_kernel
from .stencil_dilate.ops import dilate_op
from .systolic_matmul import kernel as _matmul_kernel
from .systolic_matmul.ops import conv_op, matmul_op

#: Every kernel's launch counter, by kernel name.
COUNTERS = {c.name: c for c in (_dilate_kernel.LAUNCHES,
                                _matmul_kernel.LAUNCHES,
                                _matmul_kernel.TILED_LAUNCHES,
                                _knn_kernel.LAUNCHES,
                                _hbm_kernel.AXPY_LAUNCHES,
                                _hbm_kernel.DOT_PARTIALS_LAUNCHES,
                                _hbm_kernel.GEMV_LAUNCHES,
                                _flash_kernel.LAUNCHES,
                                _flash_kernel.TC_LAUNCHES)}


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


__all__ = ["COUNTERS", "axpy_op", "axpydot_op", "conv_op", "dilate_op",
           "dot_op", "dot_partials_op", "flash_attention_op",
           "fold_partials", "gemv_op", "knn_op",
           "launch_counts", "matmul_op", "reset_launch_counts"]
