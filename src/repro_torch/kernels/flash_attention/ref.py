"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,d]; k: [B,K,Sk,d]; v: [B,K,Sk,dv] with H a multiple of
    K (GQA); dv may differ from d (MLA).

    Returns [B,H,Sq,dv] (fp32 softmax and products, fp64 for fp64
    inputs, cast to q.dtype).  The causal mask aligns the ends: query i
    sees keys <= i + (Sk - Sq).
    """
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, K, G, Sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.to(acc), k.to(acc)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos + (Sk - Sq)
    if window is not None:
        ok &= kpos > qpos + (Sk - Sq) - window
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(acc))
    return o.reshape(B, H, Sq, v.shape[3]).to(q.dtype)
