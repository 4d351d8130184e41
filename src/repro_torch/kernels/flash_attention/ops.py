"""Flash attention (online-softmax attention with GQA, causal end-aligned
masking, a sliding window and a logit softcap).

On a CUDA tensor :func:`flash_attention_op` launches the hand-written
kernel (:func:`.kernel.flash_attention`); a CPU tensor takes the plain
version.  Any other device raises — nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention
from .ref import attention_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,d]; k: [B,K,Sk,d]; v: [B,K,Sk,dv], H % K == 0.  Returns
    [B,H,Sq,dv].

    ``scale`` defaults to 1/sqrt(d); query i sees keys
    ``i + Sk - Sq - window < j <= i + Sk - Sq`` (causal, window)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: no kernel for device "
                         f"{q.device}")
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


__all__ = ["flash_attention_op", "attention_ref"]
