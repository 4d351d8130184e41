"""Attention family: GQA/MQA (+ qk-norm, logit softcap, sliding window),
the enc-dec decoder's cross attention, and DeepSeek MLA
(latent-compressed KV), each with a full-sequence path (prefill) and a
cached decode path (cross attention has one path for both).

The full-sequence paths run :func:`attention_core` on the flash attention
kernel (``kernels/flash_attention``, the TPU's flash path for the same
function): on the card it launches the hand-written kernel, on the CPU it
takes the kernel's plain version.  Scores are never materialised at
[B,H,S,S] on the card.  MLA's prefill expands the latents to per-head K
and V (q/k head dim 192, v 128 at full width), which the tensor-core
kernel takes in bf16 and the CUDA-core kernel in fp32.  Decode uses a
ring-buffer cache for windowed layers and MLA's absorbed latent-space
decode; both stay plain torch, as in JAX, and update their cache in place.

Cross attention (:func:`cross_forward`) projects q from the decoder stream
and k, v from the encoder's output and attends with no mask, no RoPE and
scale 1/sqrt(head_dim), as JAX's; it runs the flash op non-causal at
every length, a decode step's single query included (JAX's decode runs
the same function on every step).
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
    """q, k: [B,Sq,H,hd], [B,Sk,K,hd] with H = G*K; v: [B,Sk,K,vd], vd
    may differ from hd (MLA).  Returns [B,Sq,H,vd].

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


# -- cross attention (enc-dec) ------------------------------------------------

def cross_forward(params, cfg: AttnConfig, x: torch.Tensor,
                  enc: torch.Tensor) -> torch.Tensor:
    """Decoder cross attention over encoder outputs: x [B,Sq,D] (the
    decoder stream), enc [B,Sk,D].  No mask, no RoPE, no qk-norm, no
    softcap, no window; the scale is 1/sqrt(head_dim) whatever
    ``cfg.query_scale`` says, as in JAX.  Every query sees every key, so
    the flash op runs with ``causal=False`` (its causal default would hide
    keys past ``Sk - Sq + i`` from query i)."""
    B, Sq, _ = x.shape
    Sk = enc.shape[1]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq_dhk"].flatten(1)).view(B, Sq, H, hd)
    k = (enc @ params["wk_dkh"].flatten(1)).view(B, Sk, K, hd)
    v = (enc @ params["wv_dkh"].flatten(1)).view(B, Sk, K, hd)
    o = attention_core(q, k, v, window=None, softcap=None,
                       scale=1.0 / math.sqrt(hd), causal=False)
    return _out_proj(params, o)


# =============================================================================
# MLA — DeepSeek multi-head latent attention (arXiv:2405.04434 §2.1)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def init_mla(gen: torch.Generator, cfg: MLAConfig,
             dtype=torch.float32) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qrank, kvrank = cfg.q_lora_rank, cfg.kv_lora_rank
    dev = gen.device
    return {
        "wq_down_dr": layers.dense_init(gen, D, qrank, dtype),
        "q_norm": layers.rmsnorm_init(qrank, dtype, dev),
        "wq_up_rhk": layers.dense_init(gen, qrank, H * (qn + qr),
                                       dtype).reshape(qrank, H, qn + qr),
        "wkv_down_dr": layers.dense_init(gen, D, kvrank + qr, dtype),
        "kv_norm": layers.rmsnorm_init(kvrank, dtype, dev),
        "wk_up_rhk": layers.dense_init(gen, kvrank, H * qn,
                                       dtype).reshape(kvrank, H, qn),
        "wv_up_rhk": layers.dense_init(gen, kvrank, H * vd,
                                       dtype).reshape(kvrank, H, vd),
        "wo_hkd": layers.dense_init(gen, H * vd, D, dtype).reshape(H, vd, D),
    }


def mla_param_count(cfg: MLAConfig) -> int:
    """Leaves of :func:`init_mla`'s tree."""
    D, H = cfg.d_model, cfg.num_heads
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qrank, kvrank = cfg.q_lora_rank, cfg.kv_lora_rank
    return (D * qrank + qrank + qrank * H * (qn + qr) + D * (kvrank + qr)
            + kvrank + kvrank * H * (qn + vd) + H * vd * D)


def _mla_qkv(params, cfg: MLAConfig, x: torch.Tensor,
             positions: torch.Tensor):
    B, S, _ = x.shape
    H, qn = cfg.num_heads, cfg.qk_nope_dim
    inv = layers.rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device=x.device)
    qd = layers.rmsnorm(params["q_norm"], x @ params["wq_down_dr"])
    q = (qd @ params["wq_up_rhk"].flatten(1)).view(B, S, H, -1)
    q_nope = q[..., :qn]
    q_rope = layers.apply_rope(q[..., qn:], positions, inv)
    ckv = x @ params["wkv_down_dr"]
    c_kv = layers.rmsnorm(params["kv_norm"], ckv[..., :cfg.kv_lora_rank])
    k_rope = layers.apply_rope(ckv[:, :, None, cfg.kv_lora_rank:],
                               positions, inv)                # [B,S,1,qr]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: MLAConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_forward(params, cfg: MLAConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Prefill MLA: x [B,S,D], positions [B,S].  The latents are expanded
    to per-head K/V (the naive path); the absorbed decode path below never
    expands per-position K/V."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, positions)
    B, S, H, _ = q_nope.shape
    k_nope = (c_kv @ params["wk_up_rhk"].flatten(1)).view(B, S, H, -1)
    v = (c_kv @ params["wv_up_rhk"].flatten(1)).view(B, S, H, -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = attention_core(q, k, v, window=None, softcap=None,
                       scale=_mla_scale(cfg))
    return _out_proj(params, o)


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_decode(params, cfg: MLAConfig, cache: dict, x: torch.Tensor,
               pos: int) -> Tuple[dict, torch.Tensor]:
    """Absorbed-matmul MLA decode: attention runs in the compressed latent
    space, over a cache of [B,S,kv_lora] latents and [B,S,rope] keys.

    q_nope is absorbed through wk_up:  score = (q_nope W_k^T) · c_kv.
    The output absorbs wv_up:          o = (p · c_kv) W_v.

    Writes this token's latent and rope key into ``cache`` in place at
    ``pos`` (JAX returns an updated copy) and returns ``(cache, out)``.
    """
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, cfg, x, posv)
    cache["c_kv"][:, pos] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = k_rope_new[:, 0, 0].to(cache["k_rope"].dtype)
    ck, kr = cache["c_kv"], cache["k_rope"]
    # Absorb: q_lat[b,1,h,r] = q_nope[b,1,h,k] @ wk_up[r,h,k].  fp32
    # products of the working-dtype values: JAX's
    # preferred_element_type=float32.
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_up_rhk"])
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(),
                      ck.to(q_lat.dtype).float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(),
                        kr.to(q_rope.dtype).float()))
    t_pos = torch.arange(ck.shape[1], device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    s = s * _mla_scale(cfg) + torch.where(t_pos <= pos, zero,
                                          torch.full_like(zero, -1e30))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", p.to(ck.dtype).float(),
                         ck.float())
    o = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype),
                     params["wv_up_rhk"])
    return cache, _out_proj(params, o)
