"""Hand-written Hopper kernels for the paper's compute hot spots.

Each kernel directory holds ``ref.py`` (the plain PyTorch version),
``kernel.py`` (the ``ctypes`` wrapper of a CUDA source in
``repro_torch/csrc/``, with its launch counter) and ``ops.py`` (the public
op: the kernel for a CUDA tensor, the plain version for a CPU tensor).
:mod:`.build` compiles the CUDA sources at first use.
"""
from typing import Dict

from .knn import kernel as _knn_kernel
from .knn.ops import knn_op
from .stencil_dilate import kernel as _dilate_kernel
from .stencil_dilate.ops import dilate_op
from .systolic_matmul import kernel as _matmul_kernel
from .systolic_matmul.ops import conv_op, matmul_op

#: Every kernel's launch counter, by kernel name.
COUNTERS = {c.name: c for c in (_dilate_kernel.LAUNCHES,
                                _matmul_kernel.LAUNCHES,
                                _knn_kernel.LAUNCHES)}


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


__all__ = ["COUNTERS", "conv_op", "dilate_op", "knn_op", "launch_counts",
           "matmul_op", "reset_launch_counts"]
