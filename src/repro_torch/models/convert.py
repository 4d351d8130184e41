"""Carry a JAX parameter tree's weights over to the port.

The JAX package stacks the decoder's super-blocks along a leading axis
(``blocks["p{i}"]`` leaves are ``[num_superblocks, ...]``); the port holds
one tree per layer in order.  Layer ``sb * len(pattern) + i`` is
``blocks[f"p{i}"][sb]``; the unstacked ``extra["e{i}"]`` layers follow
as layer ``num_superblocks * len(pattern) + i``.  Leaves arrive as numpy
arrays (nested dicts, as ``jax.tree.map(np.asarray, params)`` gives
them); numpy has no bfloat16, so a bf16 leaf is handed over as float32 and cast back to
``cfg.param_dtype``, which loses nothing.  The leaves JAX keeps in fp32
whatever the model's dtype (the MoE router, ``moe.FP32_LEAVES``; RG-LRU's
Λ, mLSTM's gate projection and sLSTM's gate weights,
``recurrent.FP32_LEAVES``) stay fp32.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..exec.programs import resolve_device
from . import layers, moe, recurrent
from .transformer import ModelConfig, check_supported


#: The leaves that stay fp32 whatever ``cfg.param_dtype`` is.
FP32_LEAVES = moe.FP32_LEAVES | recurrent.FP32_LEAVES


def _to_torch(tree: Any, dtype, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, torch.float32 if k in FP32_LEAVES else dtype,
                             device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, dtype, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device=device, dtype=dtype)


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def tree_from_numpy(tree: Mapping, dtype=torch.float32,
                    device=None) -> layers.ParamTree:
    """A nested dict of numpy arrays as a :class:`~.layers.ParamTree` of
    ``dtype`` (fp32 for ``FP32_LEAVES``) on ``device`` (``cuda`` unless the
    caller names another)."""
    return layers.ParamTree(_to_torch(tree, dtype, resolve_device(device)))


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device=None) -> layers.ParamTree:
    """The port's parameter tree with the weights of the JAX tree ``tree``
    (``repro.models.init_params``' structure) for the same ``cfg``."""
    check_supported(cfg)
    n = len(cfg.pattern)
    blocks = tree["blocks"]
    out = {k: v for k, v in tree.items() if k not in ("blocks", "extra")}
    out["blocks"] = [_index(blocks[f"p{i}"], sb)
                     for sb in range(cfg.num_superblocks) for i in range(n)]
    out["blocks"] += [tree["extra"][f"e{i}"]
                      for i in range(len(cfg.extra_layers))]
    return tree_from_numpy(out, cfg.param_dtype, device)
