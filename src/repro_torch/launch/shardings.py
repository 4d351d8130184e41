"""Sharding rules — the realization of the paper's intra-device floorplan
+ HBM channel binding (§4.5), as the JAX package writes them.

Each parameter leaf name carries its role; the table below assigns mesh
axes ('data' = FSDP shard, 'model' = TP/EP shard).  Every axis is guarded
by divisibility — a dimension that does not divide the mesh axis stays
replicated (the floorplanner's "module spans slots" case).  Cache/input
rules are dynamic in batch size (long_500k has batch 1 → sequence/state
sharding takes over, the SP fallback).

A spec is a tuple with one entry per leading tensor dim, as JAX's
``PartitionSpec``: None (replicated), a mesh axis name, or a tuple of
names (the dim split over all of them); dims past its end are
replicated.  The rules read only the mesh's axis sizes, an ordered
mapping of name to size (:func:`axis_sizes`: a ``DeviceMesh`` or the
mapping itself), so they need no process group.  :func:`placements`
turns a spec into DTensor placements over a ``DeviceMesh``.

The port's parameter tree holds one tree per layer, where JAX stacks a
super-block's layers on a leading axis that ``param_spec`` leaves
unsharded: a layer leaf's spec here is JAX's without that leading entry.
The one place the stack's size matters, the serving layout's guard
against replicating a big leaf, takes it as ``stack``.  Likewise a
decode cache is one dict per layer ([B, ...]; JAX's is [L, B, ...]).

One difference by design: a dim split over ("model", "data") (the
serving MoE override) is split model-major in JAX and in mesh-dim order
(data-major) by DTensor.  Each rank holds a block of the same size, not
the same block; the serving path gathers the leaf before use, so no
result changes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import ModelConfig
from ..models import layers
from ..models.shardctx import axis_sizes, placements

Spec = Tuple[Any, ...]
MeshLike = Union[DeviceMesh, Mapping[str, int]]

# Leaf-name → trailing-dims axis assignment (None = replicated dim).
PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # Embedding tables: vocab over 'model' (Megatron vocab-parallel xent;
    # the lookup pays a masked-gather + [B,S,D] all-reduce over 'model').
    "embed_vd": ("model", None),
    "unembed_dv": (None, "model"),
    # attention (GQA)
    "wq_dhk": ("data", "model", None),
    "wk_dkh": ("data", "model", None),
    "wv_dkh": ("data", "model", None),
    "wo_hkd": ("model", None, "data"),
    # dense FFN
    "wi_df": ("data", "model"),
    "wg_df": ("data", "model"),
    "wo_fd": ("model", "data"),
    # MoE — E over model (EP), D/F over data (weight FSDP).
    "router_de": ("data", None),
    "router_bias_e": (None,),
    "wi_edf": ("model", "data", None),
    "wg_edf": ("model", "data", None),
    "wo_efd": ("model", None, "data"),
    # MLA
    "wq_down_dr": ("data", None),
    "wq_up_rhk": (None, "model", None),
    "wkv_down_dr": ("data", None),
    "wk_up_rhk": (None, "model", None),
    "wv_up_rhk": (None, "model", None),
    # RG-LRU
    "wx_dr": ("data", "model"),
    "wgate_dr": ("data", "model"),
    "conv_wr": (None, "model"),
    "w_input_gate_rr": ("model", None),
    "w_rec_gate_rr": ("model", None),
    "lambda_r": ("model",),
    "wo_rd": ("model", "data"),
    # mLSTM
    "w_up_di": ("data", "model"),
    "w_gate_di": ("data", "model"),
    "wq_ihk": ("model", None, None),
    "wk_ihk": ("model", None, None),
    "wv_ihk": ("model", None, None),
    "w_if_ih": ("model", None),
    "w_down_id": ("model", "data"),
    # sLSTM
    "wz_dd": ("data", "model"),
    "wi_dd": ("data", "model"),
    "wf_dd": ("data", "model"),
    "wo_dd": ("data", "model"),
    "w_out_dd": ("data", "model"),
    # misc
    "mtp_proj_dd": ("data", "model"),
    "scale": (None,),
    "bias": (None,),
}

# Serving layout: decode moves one token through every weight, so FSDP's
# per-layer weight all-gather dominates the step.  For serving, drop
# 'data' from dense weight rules (pure TP) and spread MoE experts over the
# full mesh.
SERVE_OVERRIDES: Dict[str, Tuple] = {
    "wi_edf": (("model", "data"), None, None),
    "wg_edf": (("model", "data"), None, None),
    "wo_efd": (("model", "data"), None, None),
}

def _axis_size(sizes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _axis_in_mesh(sizes: Mapping[str, int], axis) -> bool:
    if isinstance(axis, tuple):
        return all(a in sizes for a in axis)
    return axis in sizes


def _guarded(spec: Tuple, shape: Sequence[int],
             sizes: Mapping[str, int]) -> Tuple:
    out = []
    for axis, dim in zip(spec, shape):
        if axis is not None and _axis_in_mesh(sizes, axis) \
                and dim % _axis_size(sizes, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


def param_spec(keys: Sequence, shape: Sequence[int], mesh: MeshLike,
               tied: bool = False, serve: bool = False,
               stack: int = 1) -> Spec:
    """The spec of one parameter leaf at key path ``keys`` (the last key
    is the leaf's name), of the port's (unstacked) ``shape``.  ``stack``
    is the number of super-blocks JAX stacks the leaf over (1 for a leaf
    outside the stacked blocks).

    tied=True (no separate unembed table): the shared embed_vd must serve
    the vocab-parallel xent → V-sharded.
    serve=True: decode-time layout (no FSDP; full-mesh EP) — see
    SERVE_OVERRIDES.
    """
    sizes = axis_sizes(mesh)
    name = keys[-1]
    rule = PARAM_RULES.get(name)
    shape = tuple(shape)
    if rule is None:
        return ()
    if name == "embed_vd" and tied:
        rule = ("model", None)
    if serve:
        if name in SERVE_OVERRIDES:
            # Full-mesh EP needs E % (model×data) == 0; otherwise keep the
            # training rule (E-model + D/F-data FSDP).
            cand = SERVE_OVERRIDES[name]
            lead_ = len(shape) - len(cand)
            if shape[lead_] % _axis_size(sizes, cand[0]) == 0:
                rule = cand
        else:
            stripped = tuple(None if a == "data" else a for a in rule)
            # Guard against full replication: if stripping 'data' leaves a
            # big leaf unsharded, keep the training rule.  JAX counts the
            # elements of the stacked leaf.
            guard = _guarded(stripped, shape, sizes)
            if not (all(a is None for a in guard)
                    and stack * math.prod(shape) > 4e6):
                rule = stripped
    return _guarded(rule, shape, sizes)


def _stack(cfg: ModelConfig, keys: Sequence) -> int:
    """The super-blocks JAX stacks the leaf at ``keys`` over: the decoder's
    super-block layers (not the extra layers after them) and the
    encoder's layers."""
    if keys and keys[0] == "blocks" and \
            keys[1] < cfg.num_superblocks * len(cfg.pattern):
        return cfg.num_superblocks
    if keys and keys[0] == "enc_blocks":
        return cfg.enc_superblocks
    return 1


def param_specs(params, cfg: ModelConfig, mesh: MeshLike,
                serve: bool = False):
    """The spec of every leaf of a parameter tree (shaped as
    ``layers.tree_map`` gives it)."""
    tied = "unembed_dv" not in params
    return layers.tree_map_with_keys(
        lambda k, leaf: param_spec(k, leaf.shape, mesh, tied=tied,
                                   serve=serve, stack=_stack(cfg, k)),
        params)


def flat_specs(tree, keys: Tuple = ()):
    """(key path, spec) of every spec in a tree of specs (nested dicts and
    lists, as :func:`param_specs` gives it)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_specs(v, keys + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_specs(v, keys + (i,))
    else:
        yield keys, tree


def local_shape(spec: Spec, shape: Sequence[int],
                mesh: MeshLike) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under a
    guarded ``spec`` (every split dim divides)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, axis in enumerate(spec):
        out[d] //= _axis_size(sizes, axis)
    return tuple(out)


# -- inputs -------------------------------------------------------------------

def batch_axes(mesh: Optional[MeshLike]) -> Tuple[str, ...]:
    """Batch dim sharded over (pod, data) when the pod axis exists — the
    DP-over-pod strategy the partitioner selects (graphs.py)."""
    if mesh is None:
        return ("data",)
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_shards(mesh: MeshLike) -> int:
    """The number of slices the batch axes cut a batch into."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def input_spec(shape: Sequence[int], mesh: MeshLike) -> Spec:
    """The spec of one train/prefill input leaf: the leading (batch) dim
    over the batch axes when they divide it, else replicated."""
    if not shape:
        return ()
    ba = batch_axes(mesh)
    bsize = batch_shards(mesh) if ba else 1
    if shape[0] % bsize == 0 and bsize > 1:
        return (ba,) + (None,) * (len(shape) - 1)
    return ()


def input_shardings(specs: Mapping[str, torch.Tensor], mesh: MeshLike
                    ) -> Dict[str, Spec]:
    """Specs for a train/prefill batch dict (tensors, meta ones too)."""
    return {k: input_spec(tuple(v.shape), mesh) for k, v in specs.items()}


def batch_index(mesh: DeviceMesh) -> int:
    """This rank's slice of the batch: its coordinates on the batch axes,
    pod-major (JAX's P(("pod", "data")) order)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    index = 0
    for a in batch_axes(mesh):
        index = index * sizes[a] + coord[a]
    return index


def batch_slice(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a global batch leaf ``x`` where
    :func:`input_spec` splits it, else ``x``."""
    if not input_spec(tuple(x.shape), mesh):
        return x
    n = x.shape[0] // batch_shards(mesh)
    i = batch_index(mesh)
    return x[i * n:(i + 1) * n]


# -- decode caches ------------------------------------------------------------

def _cache_spec_stacked(name: str, shape: Sequence[int],
                        sizes: Mapping[str, int]) -> Spec:
    """JAX's rule on a cache leaf [L, B, ...]: prefer batch over the batch
    axes, then 'data'; if batch is not shardable (long_500k B=1), shard
    the sequence/state dim instead (SP)."""
    ba = batch_axes(sizes)
    bsz = math.prod(sizes[a] for a in ba) if ba else 1
    dsz = sizes.get("data", 1)
    msz = sizes.get("model", 1)
    if len(shape) < 2:
        return ()
    spec: list = [None] * len(shape)
    b_idx = 1                        # [L, B, ...]
    if shape[b_idx] % bsz == 0 and bsz > 1:
        spec[b_idx] = ba
        data_used = True
    elif shape[b_idx] % dsz == 0 and dsz > 1:
        spec[b_idx] = "data"
        data_used = True
    else:
        data_used = False
    if name in ("k", "v", "pos", "c_kv", "k_rope") and len(shape) >= 3:
        s_idx = 2                    # sequence dim
        if not data_used and shape[s_idx] % dsz == 0 and dsz > 1:
            spec[s_idx] = "data"
        elif shape[s_idx] % msz == 0 and msz > 1 and name in ("c_kv",
                                                              "k_rope",
                                                              "pos"):
            # MLA latent cache has no head dim to shard — sequence over
            # 'model' (+ batch over 'data').
            spec[s_idx] = "model"
    if name in ("k", "v") and len(shape) == 5:
        k_idx = 3                    # kv heads
        if shape[k_idx] % msz == 0 and msz > 1:
            spec[k_idx] = "model"
        elif spec[2] is None and shape[2] % msz == 0 and msz > 1:
            spec[2] = "model"        # shard sequence on model instead
    if name in ("C", "n", "m", "h", "conv", "c"):
        last = len(shape) - 1
        if shape[last] % msz == 0 and msz > 1:
            spec[last] = "model"
    return tuple(spec)


def cache_spec(keys: Sequence, shape: Sequence[int], mesh: MeshLike,
               stacked: bool = True) -> Spec:
    """The spec of one decode cache leaf of the port's per-layer
    ``shape`` [B, ...].  ``stacked``: JAX stacks this layer's cache over
    its super-blocks ([L, B, ...]), and the spec is JAX's without the
    leading entry; an extra layer's cache is not stacked in JAX either,
    and takes JAX's rule on its own shape."""
    sizes = axis_sizes(mesh)
    if stacked:
        return _cache_spec_stacked(keys[-1], (1,) + tuple(shape), sizes)[1:]
    return _cache_spec_stacked(keys[-1], tuple(shape), sizes)


def cache_shardings(cache, cfg: ModelConfig, mesh: MeshLike):
    """The spec of every leaf of ``models.init_cache``'s tree."""
    n_sb = cfg.num_superblocks * len(cfg.pattern)
    return layers.tree_map_with_keys(
        lambda k, leaf: cache_spec(k, leaf.shape, mesh,
                                   stacked=k[1] < n_sb),
        cache)


def replicated(mesh: MeshLike) -> Spec:
    return ()


__all__ = ["PARAM_RULES", "SERVE_OVERRIDES", "axis_sizes", "batch_axes",
           "batch_index", "batch_shards", "batch_slice", "cache_shardings",
           "cache_spec", "flat_specs", "input_shardings", "input_spec", "local_shape",
           "param_spec", "param_specs", "placements", "replicated"]
