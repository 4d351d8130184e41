"""Activation-sharding context, and the gather of sharded weights at use.

The JAX package anchors activations with ``with_sharding_constraint`` so
GSPMD keeps the batch sharded and all-gathers the (much smaller) weight
shard instead.  The port runs a mesh step as FSDP over JAX's
placements: the parameters are DTensors laid out as JAX's rules lay
them out, each rank computes on its slice of the batch, and
:func:`gather` hands the model code each weight whole, as a plain
tensor, where it is used.  Under autograd its gradient returns to the
parameter's placements (a reduce-scatter over the batch axes).

JAX's ``shard(x, *spec)``, the activation constraint, has no
counterpart: under gathered compute the activations are the rank's own
rows and nothing constrains them.  Its axis resolution, :func:`_resolve`,
is kept as JAX writes it (the spec tests hold it to JAX's) and has no
caller in the port.  When no mesh is active every function here is the
identity (or a plain sum), so the same model code runs on one device or
on a mesh.
"""
from __future__ import annotations

import math
import types
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .layers import tree_map

# Process-wide, not per thread as JAX's: the autograd engine runs a CUDA
# backward, and with it each super-block's recompute, on a thread of its
# own, which must see the mesh (and the batch axes) the forward saw.
_state = types.SimpleNamespace()


def set_mesh(mesh: Optional[DeviceMesh],
             batch_axes: Tuple[str, ...] = ("data",)):
    _state.mesh = mesh
    _state.batch_axes = batch_axes


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


class use_mesh:
    """Context manager: with shardctx.use_mesh(mesh, ('pod','data')): ..."""

    def __init__(self, mesh: Optional[DeviceMesh],
                 batch_axes: Tuple[str, ...] = ("data",)):
        self.mesh = mesh
        self.batch_axes = batch_axes

    def __enter__(self):
        self.prev = (get_mesh(), getattr(_state, "batch_axes", ("data",)))
        set_mesh(self.mesh, self.batch_axes)
        return self

    def __exit__(self, *exc):
        set_mesh(*self.prev)
        return False


def axis_sizes(mesh) -> dict:
    """The mesh's axis sizes in axis order: a ``DeviceMesh``'s named dims,
    or a mapping of axis name to size as it is."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("a mesh needs named dims")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    raise TypeError(f"not a mesh: {type(mesh).__name__}")


def _resolve(axis, mesh, dim: int):
    """Map symbolic axis → mesh axes (or None), guarded by divisibility.
    Accepts a tuple of mesh axes (e.g. ("model","data") for full-mesh EP).
    ``mesh``: a ``DeviceMesh`` or a mapping of axis name to size.  Used
    by the spec tests only (see the module docstring)."""
    sizes = axis_sizes(mesh)
    if axis is None:
        return None
    if axis == "batch":
        axes = tuple(a for a in getattr(_state, "batch_axes", ("data",))
                     if a in sizes)
        if not axes:
            return None
        size = math.prod(sizes[a] for a in axes)
        return axes if (size > 1 and dim % size == 0) else None
    if isinstance(axis, tuple):
        if not all(a in sizes for a in axis):
            return None
        size = math.prod(sizes[a] for a in axis)
        return axis if (size > 1 and dim % size == 0) else None
    if axis in sizes:
        return axis if dim % sizes[axis] == 0 else None
    return None


def placements(spec, mesh: DeviceMesh) -> list:
    """DTensor placements of a spec (a PartitionSpec-like tuple) over
    ``mesh``: ``Shard(d)`` on each mesh dim that tensor dim d is split
    over, ``Replicate()`` on the others."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


# -- the gather at use, and the batch sums -------------------------------------

def _active_batch_dims(mesh: DeviceMesh) -> list:
    axes = getattr(_state, "batch_axes", ("data",))
    return [i for i, name in enumerate(mesh.mesh_dim_names) if name in axes]


def gather_leaf(t: torch.Tensor) -> torch.Tensor:
    """A DTensor leaf whole, as a plain tensor; its gradient comes back as
    ``Partial`` over the batch axes (each rank's batch slice adds its
    share) and ``Replicate`` over the others.  A plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    batch = set(_active_batch_dims(mesh))
    grad = [Partial() if i in batch else Replicate()
            for i in range(mesh.ndim)]
    whole = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return whole.to_local(grad_placements=grad)


def gather(tree):
    """``tree`` (a layer's parameters, or any subtree) with every DTensor
    leaf gathered whole (:func:`gather_leaf`), as nested dicts and lists;
    ``tree`` itself when no mesh is active."""
    if get_mesh() is None:
        return tree
    return tree_map(gather_leaf, tree)


def batch_split() -> int:
    """The number of batch slices the active mesh computes on (1 without
    a mesh)."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[i] for i in _active_batch_dims(mesh))


def _all_reduce_batch(t: torch.Tensor) -> torch.Tensor:
    mesh = get_mesh()
    for i in _active_batch_dims(mesh):
        if mesh.shape[i] > 1:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, i)))
    return t


class _BatchSum(torch.autograd.Function):
    """All-reduce SUM over the batch axes; its gradient is the all-reduce
    SUM of the gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce_batch(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_batch(g)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks that hold the other slices of the batch
    (differentiable); ``t`` itself without a mesh or with an unsplit
    batch."""
    if batch_split() == 1:
        return t
    return _BatchSum.apply(t)
