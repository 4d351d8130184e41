"""The gradient of flash attention, in PyTorch ops.

No TPU kernel computes it: the JAX flash kernel
(``repro/kernels/flash_attention/kernel.py:99``) is a plain
``pallas_call`` with no ``custom_vjp``, and the JAX model trains through
its ``jnp`` attention (``repro/models/attention.py`` ``attention_core``),
which XLA differentiates.  This function stands where that autodiff
stands, for the port's ``attention_core``, whose forward is the
hand-written kernel on the card: ``ops.flash_attention_op`` pairs the two
in a ``torch.autograd.Function``.  A hand-written backward kernel, with
the forward writing its log-sum-exp so that the softmax need not be
recomputed, is ROADMAP work (Queue 2, where a ``perf_opt`` PR would
start).

The kernel saves no log-sum-exp, so the backward recomputes the softmax
from q and k, a chunk of query rows at a time, so that no [B, H, Sq, Sk]
tensor larger than one chunk exists (``CHUNK_ELEMENTS``).  Per chunk,
over the keys the chunk's rows can see (a causal chunk stops at its last
row's diagonal, a windowed one starts at its first row's window):

    S  = Q Kᵀ · scale, then c · tanh(S / c) with a softcap c;
    P  = softmax(S) under the causal end-aligned mask and the window;
    dV += Pᵀ dO;  dP = dO Vᵀ;
    dS = P ∘ (dP − rowsum(P ∘ dP)), times 1 − tanh²(S / c) with a softcap;
    dQ = dS K · scale;  dK += dSᵀ Q · scale.

``rowsum(P ∘ dP)`` is ``rowsum(dO ∘ O)`` for the exact O = P V; taking it
from the recomputed P needs no O.  The G query heads of a kv head are
rows of one product, so dK and dV sum over each group.  Everything is in
fp32 (fp64 for fp64 inputs), each gradient cast to its input's dtype at
the end.  The products are plain ``torch.matmul``, as the JAX package
leaves its attention's to XLA.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

#: Elements of one chunk's fp32 score tensor [B, H, rows, keys]: 2^26
#: (256 MB); the chunk's P, dP and dS are as large.
CHUNK_ELEMENTS = 1 << 26


def chunk_rows(B: int, H: int, Sq: int, Sk: int) -> int:
    """Query rows a chunk takes: as many as keep [B, H, rows, Sk] within
    ``CHUNK_ELEMENTS``, at least one."""
    return max(1, min(Sq, CHUNK_ELEMENTS // (B * H * Sk)))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of ``o = flash_attention(q, k, v)`` for the output's
    gradient ``do`` [B,H,Sq,dv]: q [B,H,Sq,d], k [B,K,Sk,d], v
    [B,K,Sk,dv], H % K == 0, the forward's ``causal``, ``window``,
    ``softcap`` and ``scale``.

    Raises on causal attention with Sq > Sk: its first Sq − Sk rows see no
    key, which the forward answers with a value that depends on its block
    size (ROADMAP "Keep in mind"), and which has no gradient."""
    B, H, Sq, d = q.shape
    K, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    if causal and Sq > Sk:
        raise ValueError(f"flash attention backward: causal with Sq {Sq} > "
                         f"Sk {Sk} leaves rows that see no key")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    delta = Sk - Sq
    acc = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    k32, v32 = k.to(acc), v.to(acc)
    dq = torch.empty((B, H, Sq, d), dtype=acc, device=dev)
    dk = torch.zeros((B, K, Sk, d), dtype=acc, device=dev)
    dvv = torch.zeros((B, K, Sk, dv), dtype=acc, device=dev)
    rows = chunk_rows(B, H, Sq, Sk)
    for i0 in range(0, Sq, rows):
        i1 = min(Sq, i0 + rows)
        C = i1 - i0
        lo = 0 if window is None else max(0, i0 + delta - window + 1)
        hi = min(Sk, i1 + delta) if causal else Sk
        # [B, H, C, .] -> [B, K, G·C, .]: a kv head's G query heads are
        # rows of one product.
        qc = q[:, :, i0:i1].to(acc).reshape(B, K, G * C, d)
        doc = do[:, :, i0:i1].to(acc).reshape(B, K, G * C, dv)
        kc, vc = k32[:, :, lo:hi], v32[:, :, lo:hi]
        s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        qpos = torch.arange(i0, i1, device=dev)[:, None] + delta
        kpos = torch.arange(lo, hi, device=dev)[None, :]
        ok = torch.ones((C, hi - lo), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s.masked_fill_(~ok.repeat(G, 1), float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        dvv[:, :, lo:hi] += torch.matmul(p.transpose(-1, -2), doc)
        dp = torch.matmul(doc, vc.transpose(-1, -2))
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        del p, dp
        if softcap is not None:
            ds = ds * (1 - t * t)
            del t
        dq[:, :, i0:i1] = (torch.matmul(ds, kc) * scale).view(B, H, C, d)
        dk[:, :, lo:hi] += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)
