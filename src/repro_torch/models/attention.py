"""Attention family, the GQA part: GQA/MQA (+ qk-norm, logit softcap,
sliding window) with a full-sequence path (prefill) and a KV-cached decode
path.

The full-sequence path runs :func:`attention_core` on the flash attention
kernel (``kernels/flash_attention``, the TPU's flash path for the same
function): on the card it launches the hand-written kernel, on the CPU it
takes the kernel's plain version.  Scores are never materialised at
[B,H,S,S] on the card.  Decode uses a ring-buffer cache for windowed
layers and stays plain torch, as in JAX.

Cross attention (enc-dec) and DeepSeek MLA are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..kernels.flash_attention.ops import flash_attention_op
from . import layers


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # ChatGLM 2d-RoPE rotates half the dims
    qk_norm: bool = False            # Qwen3
    attn_softcap: Optional[float] = None   # Gemma-2 (50.0)
    window: Optional[int] = None     # sliding-window (local) attention
    use_bias: bool = False
    query_scale: Optional[float] = None
    causal: bool = True              # False → bidirectional (encoder)


def init_gqa(gen: torch.Generator, cfg: AttnConfig,
             dtype=torch.float32) -> dict:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq_dhk": layers.dense_init(gen, D, H * hd, dtype).reshape(D, H, hd),
        "wk_dkh": layers.dense_init(gen, D, K * hd, dtype).reshape(D, K, hd),
        "wv_dkh": layers.dense_init(gen, D, K * hd, dtype).reshape(D, K, hd),
        "wo_hkd": layers.dense_init(gen, H * hd, D, dtype).reshape(H, hd, D),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = layers.rmsnorm_init(hd, dtype, gen.device)
    return p


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int], causal: bool = True,
               dtype=torch.float32) -> torch.Tensor:
    """[..., Sq, Sk] additive mask: causal plus optional sliding window."""
    if causal:
        ok = k_pos[..., None, :] <= q_pos[..., :, None]
    else:
        ok = torch.ones(q_pos.shape + k_pos.shape[-1:], dtype=torch.bool,
                        device=q_pos.device)
    if window is not None:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: Optional[int], softcap: Optional[float],
                   scale: float, causal: bool = True) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,K,hd] with H = G*K.  Returns [B,Sq,H,hd].

    Query i sits at position Sk - Sq + i and key j at position j (the JAX
    callers pass ``positions = arange(S)`` for both), so ``k_pos <= q_pos``
    is the kernel's ``kpos <= qpos + delta`` with ``delta = Sk - Sq``.  The
    kernel reads the [B,S,H,hd] tensors through strides and writes its
    output in q's layout, so neither permute copies on the card.
    """
    if softcap is not None and softcap <= 0:
        softcap = None                 # layers.softcap's identity
    o = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window,
                           softcap=softcap, scale=scale)
    return o.transpose(1, 2)


def _project_qkv(params, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inv = layers.rope_freqs(hd, cfg.rope_theta, cfg.rope_fraction,
                            device=x.device)
    q = (x @ params["wq_dhk"].flatten(1)).view(B, S, H, hd)
    k = (x @ params["wk_dkh"].flatten(1)).view(B, S, K, hd)
    v = (x @ params["wv_dkh"].flatten(1)).view(B, S, K, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q)
        k = layers.rmsnorm(params["k_norm"], k)
    return (layers.apply_rope(q, positions, inv),
            layers.apply_rope(k, positions, inv), v)


def _out_proj(params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ params["wo_hkd"].flatten(0, 1)


def gqa_forward(params, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (prefill): x [B,S,D], positions [B,S]."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    scale = cfg.query_scale or (1.0 / math.sqrt(cfg.head_dim))
    o = attention_core(q, k, v, window=cfg.window, softcap=cfg.attn_softcap,
                       scale=scale, causal=cfg.causal)
    return _out_proj(params, o)


# -- decode (KV cache) --------------------------------------------------------

def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Ring buffer of size min(window, max_len) for windowed layers."""
    L = min(cfg.window, max_len) if cfg.window else max_len
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, L, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, K, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, L), -1, dtype=torch.int32,
                          device=device),        # absolute positions
    }


def gqa_decode(params, cfg: AttnConfig, cache: dict, x: torch.Tensor,
               pos: int) -> Tuple[dict, torch.Tensor]:
    """One-token decode.  x: [B,1,D]; pos: the absolute position (int).

    Writes this token's K, V and position into ``cache`` in place, at slot
    ``pos % L`` (JAX returns an updated copy; in place saves a copy of the
    cache per layer and step), and returns ``(cache, out)``.
    """
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, posv)
    L = cache["k"].shape[1]
    slot = pos % L
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = pos
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    scale = cfg.query_scale or (1.0 / math.sqrt(cfg.head_dim))
    K_, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // K_
    qg = q.reshape(B, 1, K_, G, hd)
    # fp32 products of the working-dtype values: JAX's
    # preferred_element_type=float32.
    s = torch.einsum("bckgh,bskh->bkgcs", qg.float(),
                     ck.to(q.dtype).float()) * scale
    s = layers.softcap(s, cfg.attn_softcap)
    valid = (cpos >= 0) & (cpos <= pos)
    if cfg.window:
        valid &= cpos > pos - cfg.window
    s = s.masked_fill(~valid[:, None, None, None, :], -1e30)
    p = torch.softmax(s.float(), dim=-1)
    o = torch.einsum("bkgcs,bskh->bckgh", p.to(cv.dtype).float(),
                     cv.to(q.dtype).float())
    o = o.reshape(B, 1, cfg.num_heads, hd).to(x.dtype)
    return cache, _out_proj(params, o)
