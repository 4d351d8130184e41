"""Analytic FLOP/byte accounting per (arch × shape) — exact formulas used
for the roofline terms.

A copy of the JAX package's module on the port's ``ModelConfig`` and
``configs.base.SHAPES``: every function returns the JAX one's floats for
the same config.  A bf16 config is one whose ``param_dtype`` is
``torch.bfloat16``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..configs.base import SHAPES
from ..models import ModelConfig, LayerSpec
from .graphs import layer_flops, layer_param_bytes, total_param_bytes


def _specs(cfg: ModelConfig):
    return list(cfg.pattern) * cfg.num_superblocks + list(cfg.extra_layers)


def active_param_count(cfg: ModelConfig) -> float:
    """Per-token active parameters (MoE: routed experts scaled by k/E)."""
    bpe = 2 if cfg.param_dtype == torch.bfloat16 else 4
    total = 0.0
    for s in _specs(cfg):
        pb = layer_param_bytes(cfg, s) / bpe
        if s.ffn == "moe":
            mo = cfg.moe
            routed = mo.num_experts * 3 * cfg.d_model * mo.d_ff_expert
            pb = pb - routed + routed * mo.top_k / mo.num_experts
        total += pb
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.arch == "encdec":
        total += sum(layer_param_bytes(cfg, s) / bpe
                     for s in cfg.enc_pattern) * cfg.enc_superblocks
    return total


def train_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Global fwd+bwd FLOPs for one step (6× matmul rule + attn quadratic)."""
    f = sum(6.0 * layer_flops(cfg, s, batch, seq) for s in _specs(cfg))
    f += 6.0 * 2.0 * batch * seq * cfg.d_model * cfg.vocab        # unembed
    if cfg.mtp:
        f += 6.0 * 2.0 * batch * seq * cfg.d_model * cfg.vocab
        f += 6.0 * layer_flops(cfg, LayerSpec("gqa", "dense"), batch, seq)
    if cfg.arch == "encdec":
        f += sum(6.0 * layer_flops(cfg, s, batch, seq // 4)
                 for s in cfg.enc_pattern) * cfg.enc_superblocks
    return f


def prefill_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    # layer_flops returns forward FLOPs (2·tokens·params + attn quadratic).
    f = sum(layer_flops(cfg, s, batch, seq) for s in _specs(cfg))
    f += 2.0 * batch * cfg.d_model * cfg.vocab      # last-position unembed
    if cfg.arch == "encdec":
        f += sum(layer_flops(cfg, s, batch, seq // 4)
                 for s in cfg.enc_pattern) * cfg.enc_superblocks
    return f


def decode_flops(cfg: ModelConfig, batch: int, ctx: int) -> float:
    """One-token decode: active params matmuls + attention over the cache."""
    f = 2.0 * batch * active_param_count(cfg)
    for s in _specs(cfg):
        if s.mixer == "gqa":
            eff = min(s.window or ctx, ctx)
            f += 2.0 * 2.0 * batch * eff * cfg.num_heads * cfg.head_dim
        elif s.mixer == "mla":
            m = cfg.mla
            f += (2.0 * 2.0 * batch * ctx * m.num_heads
                  * (m.kv_lora_rank + m.qk_rope_dim))
    return f


def decode_hbm_bytes(cfg: ModelConfig, batch: int, ctx: int) -> float:
    """Dominant decode memory traffic: full weight read + cache read."""
    bpe = 2
    w = total_param_bytes(cfg)
    cache = 0.0
    for s in _specs(cfg):
        if s.mixer == "gqa":
            eff = min(s.window or ctx, ctx)
            cache += 2 * batch * eff * cfg.num_kv_heads * cfg.head_dim * bpe
        elif s.mixer == "mla":
            cache += batch * ctx * (cfg.mla.kv_lora_rank
                                    + cfg.mla.qk_rope_dim) * bpe
        elif s.mixer == "rglru":
            cache += batch * cfg.rglru.d_rnn * 4 * 2
        elif s.mixer == "mlstm":
            hd = cfg.mlstm.head_dim
            cache += batch * cfg.mlstm.num_heads * hd * hd * 4 * 2
        elif s.mixer == "slstm":
            cache += batch * cfg.d_model * 4 * 2
    return w + cache


def train_hbm_bytes(cfg: ModelConfig, batch: int, seq: int,
                    remat: bool = True) -> float:
    """Per-step global HBM traffic estimate: weights (fwd read + bwd read +
    grad write + opt read/write) + activations (write fwd, read bwd; remat
    recompute reads layer inputs twice)."""
    w = total_param_bytes(cfg)
    weight_traffic = w * (1 + 1 + 1 + 2 + 2)     # fp32 moments dominated
    act_per_layer = batch * seq * cfg.d_model * 2
    n_layers = len(_specs(cfg))
    act_traffic = act_per_layer * n_layers * (3 if remat else 2)
    return weight_traffic + act_traffic


@dataclasses.dataclass
class AnalyticCell:
    flops_global: float
    hbm_bytes_global: float
    model_flops: float          # 6·N_active·D (train) / 2·N_active per tok


def analyze(cfg: ModelConfig, shape: str) -> AnalyticCell:
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    n_active = active_param_count(cfg)
    if cell.kind == "train":
        tokens = B * S
        return AnalyticCell(
            flops_global=train_flops(cfg, B, S),
            hbm_bytes_global=train_hbm_bytes(cfg, B, S),
            model_flops=6.0 * n_active * tokens)
    if cell.kind == "prefill":
        tokens = B * S
        return AnalyticCell(
            flops_global=prefill_flops(cfg, B, S),
            hbm_bytes_global=(total_param_bytes(cfg)
                              + 2 * tokens * cfg.d_model * 2
                              * len(_specs(cfg))),
            model_flops=2.0 * n_active * tokens)
    return AnalyticCell(
        flops_global=decode_flops(cfg, B, S),
        hbm_bytes_global=decode_hbm_bytes(cfg, B, S),
        model_flops=2.0 * n_active * B)
