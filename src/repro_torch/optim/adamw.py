"""AdamW + global-norm clipping + cosine schedule (no external deps).

Optimizer state mirrors the param tree (nested dicts and lists,
:func:`~repro_torch.models.layers.tree_map` of the params): ``mu`` and
``nu`` in fp32 whatever the param dtype (bf16 training keeps fp32 moments
beside bf16 params, the MaxText default), ``count`` an int32 scalar.

Two differences from the JAX package, both for memory, neither for the
arithmetic:

- The update writes the new params into the params' tensors and the new
  moments into the state's (JAX returns new trees).  A functional update
  of qwen3-4b would hold two copies of its 32 GB of moments at once.
- :func:`clip_by_global_norm` returns the factor each leaf's gradient is
  multiplied by, not the scaled tree: JAX's builds an fp32 copy of every
  gradient (16 GB at qwen3-4b).  The norm is summed as JAX sums it, leaf by
  leaf in tree order, each leaf's sum of squares in fp32, and the factor
  is applied to ``g.float()`` inside each leaf's update.

On a mesh (``launch.steps.build_train_step(..., mesh=)``) the params,
gradients and moments are DTensors with the same placements: the update
runs on each rank's shards, and each leaf's sum of squares is summed over
its shards (``full_tensor``) before the leaves are added in tree order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    return {"mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves, in tree order, of each leaf's
    fp32 sum of squares (an fp32 scalar)."""
    total = 0
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        if isinstance(s, DTensor):
            # A sharded leaf's sum is the sum over its shards; a
            # replicated dim is counted once.
            s = s.full_tensor()
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm): ``g.float() * scale`` is JAX's clipped
    gradient of each leaf ``g``.  Both are fp32 scalars."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return scale, gn


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Any, dict]:
    """One AdamW step, in place: each param leaf takes its new value
    (computed in fp32, cast back to its dtype) and ``state``'s ``mu`` and
    ``nu`` leaves their new moments.  Returns ``(params, {"mu", "nu",
    "count", "grad_norm"})``, the first three ``state``'s tensors."""
    scale, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state["count"] + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=c.device), c)
    lr = cfg.lr * lr_scale

    def upd(p, g, mu, nu):
        if isinstance(p, DTensor):
            # The leaves share the param's placements: the update is
            # elementwise, so each rank updates its own shard.
            p, g, mu, nu = (t.to_local() for t in (p, g, mu, nu))
        g = g.float() * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).add_(torch.square(g), alpha=1 - cfg.b2)
        del g
        step = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        p32 = p.float()
        step.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32 - lr * step)

    # Leaves are matched by key, so the trees' orders need not agree.
    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count,
                    "grad_norm": gnorm}


def cosine_schedule(step, total_steps: int, warmup: int = 100,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to 1, then cosine decay to ``min_frac`` (fp32)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                       0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
