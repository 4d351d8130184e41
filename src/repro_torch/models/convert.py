"""Carry a JAX parameter tree's weights over to the port.

The JAX package stacks the decoder's super-blocks along a leading axis
(``blocks["p{i}"]`` leaves are ``[num_superblocks, ...]``); the port holds
one tree per layer in order.  Layer ``sb * len(pattern) + i`` is
``blocks[f"p{i}"][sb]``; the unstacked ``extra["e{i}"]`` layers follow
as layer ``num_superblocks * len(pattern) + i``.  An enc-dec tree's
encoder (``enc_blocks["p{i}"]``, stacked over ``enc_superblocks``) is
unstacked the same way into the port's ``enc_blocks`` list; the decoder
layers' ``ln_cross`` and ``cross`` leaves and ``enc_final_norm`` carry
over as they are.  Leaves arrive as numpy
arrays (nested dicts, as ``jax.tree.map(np.asarray, params)`` gives
them); numpy has no bfloat16, so a bf16 leaf is handed over as float32 and cast back to
``cfg.param_dtype``, which loses nothing.  The leaves JAX keeps in fp32
whatever the model's dtype (the MoE router, ``moe.FP32_LEAVES``; RG-LRU's
Λ, mLSTM's gate projection and sLSTM's gate weights,
``recurrent.FP32_LEAVES``) stay fp32.

:func:`opt_state_from_jax` carries an optimizer state over the same way:
AdamW's ``mu``/``nu`` and Adafactor's ``vr``/``vc``/``v`` mirror the
parameter tree (fp32, unstacked per super-block), ``count`` is an int32
scalar.
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


def _unstack_tree(tree: Mapping, cfg: ModelConfig) -> dict:
    """A JAX parameter-shaped tree with the port's layout: the stacked
    super-blocks unstacked into a list of layers, the extra layers after
    them, an enc-dec tree's encoder likewise."""
    def unstack(blocks, pattern, superblocks):
        return [_index(blocks[f"p{i}"], sb)
                for sb in range(superblocks) for i in range(len(pattern))]

    out = {k: v for k, v in tree.items()
           if k not in ("blocks", "extra", "enc_blocks")}
    out["blocks"] = unstack(tree["blocks"], cfg.pattern, cfg.num_superblocks)
    out["blocks"] += [tree["extra"][f"e{i}"]
                      for i in range(len(cfg.extra_layers))]
    if cfg.arch == "encdec":
        out["enc_blocks"] = unstack(tree["enc_blocks"], cfg.enc_pattern,
                                    cfg.enc_superblocks)
    return out


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device=None) -> layers.ParamTree:
    """The port's parameter tree with the weights of the JAX tree ``tree``
    (``repro.models.init_params``' structure) for the same ``cfg``."""
    check_supported(cfg)
    return tree_from_numpy(_unstack_tree(tree, cfg), cfg.param_dtype, device)


def _adafactor_leaves(tree: Any, stacked: bool, superblocks: int) -> Any:
    """JAX's Adafactor state of a parameter subtree as the port's: the
    per-leaf dicts become leaves' states.  A stacked vector param [L, D]
    (L > 1) has a state factored across the layers, which the port's
    per-layer leaves cannot hold: that raises."""
    if isinstance(tree, Mapping) and set(tree) in ({"vr", "vc"}, {"v"}):
        if stacked and superblocks > 1 and "vr" in tree and \
                np.asarray(tree["vr"]).ndim == 1:
            raise ValueError(
                "opt_state_from_jax: JAX's Adafactor factors a stacked "
                "vector param across its super-blocks (vr [L]); the "
                "port's per-layer leaves cannot hold that state")
        return tree
    if isinstance(tree, Mapping):
        return {k: _adafactor_leaves(v, stacked, superblocks)
                for k, v in tree.items()}
    return tree


def opt_state_from_jax(state: Mapping, cfg: ModelConfig,
                       device=None) -> dict:
    """The port's optimizer state (nested dicts and lists of fp32 tensors
    on ``device``, ``count`` int32) from a JAX ``adamw_init`` /
    ``adafactor_init`` state (``mu``, ``nu``, ``count``; or ``v``,
    ``count``) over ``repro.models.init_params``' tree for ``cfg``,
    unstacked per super-block as :func:`params_from_jax` unstacks the
    params."""
    check_supported(cfg)
    dev = resolve_device(device)

    def fp32(tree):
        return _to_torch(tree, torch.float32, dev)

    out = {"count": torch.tensor(int(np.asarray(state["count"])),
                                 dtype=torch.int32, device=dev)}
    if "mu" in state:
        for key in ("mu", "nu"):
            out[key] = fp32(_unstack_tree(state[key], cfg))
        return out
    v = dict(state["v"])
    for key, sb in (("blocks", cfg.num_superblocks),
                    ("enc_blocks", cfg.enc_superblocks)):
        if key in v:
            v[key] = _adafactor_leaves(v[key], True, sb)
    out["v"] = fp32(_unstack_tree(v, cfg))
    return out
