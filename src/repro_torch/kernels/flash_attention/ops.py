"""Flash attention (online-softmax attention with GQA, causal end-aligned
masking, a sliding window and a logit softcap).

On a CUDA tensor :func:`flash_attention_op` launches the hand-written
kernel (:func:`.kernel.flash_attention`); a CPU tensor takes the plain
version.  Any other device raises — nothing falls back.

The op is differentiable: where autograd records it, a
``torch.autograd.Function`` runs the same forward, saves q, k and v, and
takes its gradient from :func:`.backward.flash_attention_backward`
(PyTorch ops that recompute the softmax; the TPU kernel has no backward).
"""
from __future__ import annotations

from typing import Optional

import torch

from .backward import flash_attention_backward
from .kernel import flash_attention
from .ref import attention_ref


def _forward(q, k, v, **kw) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: no kernel for device "
                         f"{q.device}")
    return flash_attention(q, k, v, **kw)


class FlashAttentionFn(torch.autograd.Function):
    """The forward of :func:`flash_attention_op` with the backward of
    :func:`.backward.flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.options = dict(causal=causal, window=window, softcap=softcap,
                           scale=scale)
        return _forward(q, k, v, **ctx.options)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, do, **ctx.options)
        return dq, dk, dv, None, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,d]; k: [B,K,Sk,d]; v: [B,K,Sk,dv], H % K == 0.  Returns
    [B,H,Sq,dv].

    ``scale`` defaults to 1/sqrt(d); query i sees keys
    ``i + Sk - Sq - window < j <= i + Sk - Sq`` (causal, window).  Under
    autograd, with an operand that requires grad, the call is recorded as
    a :class:`FlashAttentionFn`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      scale)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale)


__all__ = ["FlashAttentionFn", "flash_attention_op", "attention_ref"]
