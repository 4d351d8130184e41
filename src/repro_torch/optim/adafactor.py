"""Adafactor (Shazeer & Stern, arXiv:1804.04235) — factored second moments,
no first moment: O(n+m) optimizer state per [n,m] matrix instead of Adam's
2·n·m fp32.  Selected by the planner for deepseek-v3-671b, whose AdamW state
(8 bytes/param ≈ 5.4 TB) exceeds a single pod's 4 TB HBM.

The arithmetic is the JAX package's line for line.  Two differences:

- Like :func:`~.adamw.adamw_update`, the update writes the new params
  into the params' tensors (JAX returns a new tree).
- The port's tree holds one leaf per layer, where JAX stacks the layers
  of a super-block pattern along a leading axis.  JAX's Adafactor sees
  that axis as a leaf dim: it factors a stacked vector ([L, D], such as a
  norm scale) across the layers and clips each update by the RMS over
  all L layers.  The port factors and clips per layer, which is what
  JAX's Adafactor does on an unstacked tree; the two agree at
  ``num_superblocks == 1``.

On a mesh the params and gradients are DTensors: the row and column
means and the clipping RMS are DTensor reductions over the shards, and
each new moment and param takes the placements of the one it replaces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8            # beta2 exponent schedule base
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> dict:
    def leaf_state(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    device = tree_leaves(params)[0].device
    return {"v": tree_map(leaf_state, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adafactor_update(params, grads, state: dict, cfg: AdafactorConfig,
                     lr_scale=1.0) -> Tuple[Any, dict]:
    """One Adafactor step: each param leaf takes its new value (in place,
    computed in fp32, cast back); returns ``(params, {"v", "count"})``
    with new moment tensors."""
    count = state["count"] + 1
    c = count.float()
    beta2 = 1.0 - c ** (-cfg.decay)

    def upd(p, g, s):
        if isinstance(p, DTensor):
            with implicit_replication():
                ns = upd_leaf(p, g, s)
            return {k: v.redistribute(s[k].device_mesh, s[k].placements)
                    for k, v in ns.items()}
        return upd_leaf(p, g, s)

    def upd_leaf(p, g, s):
        g = g.float()
        g2 = torch.square(g) + cfg.eps
        if _factored(p.shape):
            vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            v_est = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(denom[..., None], min=cfg.eps))
            u = g * torch.rsqrt(torch.clamp(v_est, min=cfg.eps))
            ns = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=cfg.eps))
            ns = {"v": v}
        # Update clipping (RMS-based).
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p32 = p.float()
        new = (p32 - cfg.lr * lr_scale * u
               - cfg.lr * lr_scale * cfg.weight_decay * p32)
        if isinstance(p, DTensor):
            new = new.redistribute(p.device_mesh, p.placements)
        p.copy_(new)
        return ns

    new_v = tree_map(upd, params, grads, state["v"])
    return params, {"v": new_v, "count": count}
