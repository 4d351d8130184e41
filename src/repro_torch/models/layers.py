"""Shared layer primitives: norms, rotary embeddings, dense init, softcap.

Functional, as in the JAX package: every layer exposes
``init(gen, ...) -> params`` and ``apply(params, x, ...) -> y``.  Params are
nested dicts of tensors; a whole model's tree is held as a
:class:`ParamTree`, a module tree with the same names (``p["attn"]``), so
the JAX leaf names carry over one to one.
Initialisers draw from an explicit ``torch.Generator`` on the device the
tensors are made on.  :func:`tree_map`, :func:`tree_map_with_keys`,
:func:`tree_leaves` and :func:`tree_paths` walk such trees (a ParamTree,
nested dicts and lists, or a training state holding both) for the
optimizers, the checkpoints and the sharding rules.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ParamTree(nn.Module):
    """A nested mapping of tensors as a module tree.

    Tensor leaves become parameters that take no gradient unless the
    train step asks for one (``launch.steps.build_train_step`` turns
    ``requires_grad`` on), mappings become child trees and lists become
    ``nn.ModuleList``s of trees (the decoder's layers).
    """

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(t)
                                                    for t in value))
            else:
                self.add_module(name, ParamTree(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> List[str]:
        """The names of the leaves, then of the child trees, in the order
        they were given."""
        return list(self._parameters) + list(self._modules)


def _children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) of a tree node in walk order; None for a leaf."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, (ParamTree, Mapping)):
        return [(k, tree[k]) for k in tree.keys()]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return list(enumerate(tree))
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the leaves at the same
    keys of each tree in ``rest``), as nested dicts and lists: a ParamTree
    maps to a dict, a ModuleList to a list."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    out = [(k, tree_map(fn, c, *(r[k] for r in rest))) for k, c in kids]
    if isinstance(tree, (ParamTree, Mapping)):
        return dict(out)
    return [v for _, v in out]


def tree_map_with_keys(fn: Callable, tree, keys: Tuple = ()):
    """``fn(keys, leaf)`` over the tensor leaves of ``tree``, ``keys`` the
    tuple of names and list indices from the root to the leaf; the result
    is shaped as :func:`tree_map`'s."""
    kids = _children(tree)
    if kids is None:
        return fn(keys, tree)
    out = [(k, tree_map_with_keys(fn, c, keys + (k,))) for k, c in kids]
    if isinstance(tree, (ParamTree, Mapping)):
        return dict(out)
    return [v for _, v in out]


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(key path, leaf) of every tensor leaf in walk order, the path
    written as JAX's ``keystr`` writes it (``['blocks'][0]['attn']``)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, c in kids
            for item in tree_paths(c, f"{prefix}[{k!r}]")]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` in walk order."""
    return [leaf for _, leaf in tree_paths(tree)]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn((in_dim, out_dim), generator=gen,
                        device=gen.device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen,
                       device=gen.device).to(dtype)


# -- normalization -----------------------------------------------------------

def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in fp32, cast back; ``zero_centered`` uses (1+scale) — Gemma
    convention."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = params["scale"].float()
    if zero_centered:
        s = 1.0 + s
    return (y * s).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (mean, biased variance, ``rsqrt(var + eps)``),
    then scale and bias, cast back."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


# -- logit soft-capping (Gemma-2) --------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None or cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# -- rotary position embeddings ---------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               fraction: float = 1.0, device=None) -> torch.Tensor:
    """Inverse frequencies over the rotated sub-dimension.

    fraction < 1 rotates only the first ``fraction*head_dim`` dims — the
    ChatGLM "2d RoPE" convention.
    """
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exponents = torch.arange(0, rot, 2, dtype=torch.float32,
                             device=device) / rot
    return 1.0 / (theta ** exponents)  # [rot/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    rot = 2 * inv_freq.shape[0]
    angles = positions[..., :, None].float() * inv_freq   # [..., S, rot/2]
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# -- activations --------------------------------------------------------------

def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "tanh": torch.tanh,
    }[name]


# -- embedding ----------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 scale_by_dim: bool = False) -> torch.Tensor:
    out = F.embedding(ids, table)
    if scale_by_dim:
        # The factor is rounded to the table's dtype first, as in JAX.
        out = out * torch.tensor(math.sqrt(table.shape[1]), dtype=out.dtype,
                                 device=out.device)
    return out


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table.T, in fp32.

    JAX accumulates bf16 operands into fp32 logits; products of bf16 values
    are exact in fp32, so the port takes the product of the fp32 copies.
    """
    return x.float() @ table.float().T
