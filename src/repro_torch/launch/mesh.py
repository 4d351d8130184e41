"""Production mesh construction.

A FUNCTION, not a module-level constant: importing this module touches
no device and no process group.  A mesh is a ``DeviceMesh`` with the JAX
package's axis names over the default process group, which the caller
creates (``torch.distributed.run`` and ``init_process_group``, or the dry
run's fake group).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the product of the shape.  ``device_type``
    defaults to ``cuda`` on an nccl group and ``cpu`` otherwise."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = None) -> DeviceMesh:
    """Single pod: 16×16 ranks ('data','model').  Multi-pod: 2×16×16 with
    a leading 'pod' axis (the slow inter-pod links)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type)
