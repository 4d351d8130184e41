"""LM task-graph construction — the bridge from ModelConfig to the TAPA-CS
partitioner (C1: tasks with resource profiles, channels with widths).

Tasks: embed, one task per layer (attention+FFN fused — the natural
latency-insensitive boundary is the residual stream between layers), head.
Channel width = residual-stream bytes per microbatch.  Resource profile per
task: hbm_bytes = params (+optimizer) resident, flops = per-step compute.
The partitioner then places layers onto pods (Eq. 1–2 with λ(DCN)), and the
schedule decision (DP vs PP on the pod axis) comes from the scale-up advisor
(§7.1) exactly as the paper's §5.7 analysis dictates: chain topologies
across slow links lose to parallel-after-router (≡ DP) unless memory binds.

A copy of the JAX package's module on the port's ``core`` and
``ModelConfig``: every function returns the JAX one's floats for the same
config.  A bf16 config is one whose ``param_dtype`` is ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import ResourceProfile, Task, TaskGraph
from ..models import ModelConfig, LayerSpec


def layer_param_bytes(cfg: ModelConfig, spec: LayerSpec) -> float:
    """Per-layer parameter bytes (dtype-weighted)."""
    d = cfg.d_model
    bpe = 2 if cfg.param_dtype == torch.bfloat16 else 4
    n = 0
    if spec.mixer == "gqa":
        hd, H, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        n += d * H * hd + 2 * d * K * hd + H * hd * d
    elif spec.mixer == "mla":
        m = cfg.mla
        n += (d * m.q_lora_rank
              + m.q_lora_rank * m.num_heads * (m.qk_nope_dim + m.qk_rope_dim)
              + d * (m.kv_lora_rank + m.qk_rope_dim)
              + m.kv_lora_rank * m.num_heads * (m.qk_nope_dim + m.v_head_dim)
              + m.num_heads * m.v_head_dim * d)
    elif spec.mixer == "rglru":
        r = cfg.rglru.d_rnn
        n += 2 * d * r + 2 * r * r + r * d
    elif spec.mixer == "mlstm":
        di = cfg.mlstm.d_inner
        # block-diagonal q/k/v: 3·di²/H
        n += 2 * d * di + 3 * di * di // cfg.mlstm.num_heads + di * d
    elif spec.mixer == "slstm":
        n += 5 * d * d
    if spec.ffn == "dense" and cfg.d_ff:
        n += 3 * d * cfg.d_ff
    elif spec.ffn == "moe":
        mo = cfg.moe
        n += mo.num_experts * 3 * d * mo.d_ff_expert + d * mo.num_experts
        n += 3 * d * mo.d_ff_expert * mo.num_shared
    return n * bpe


def layer_flops(cfg: ModelConfig, spec: LayerSpec, batch: int,
                seq: int) -> float:
    """Per-layer training-forward FLOPs (6× for fwd+bwd applied by caller).

    Dense matmul part = 2 × tokens × active-params/bpe; attention quadratic
    part added for attention mixers.
    """
    tokens = batch * seq
    d = cfg.d_model
    bpe = 2 if cfg.param_dtype == torch.bfloat16 else 4
    active = layer_param_bytes(cfg, spec) / bpe
    if spec.ffn == "moe":
        mo = cfg.moe
        routed = mo.num_experts * 3 * d * mo.d_ff_expert
        active = active - routed + routed * (mo.top_k / mo.num_experts)
    f = 2.0 * tokens * active
    if spec.mixer in ("gqa", "mla"):
        ctx = min(spec.window or seq, seq)
        hd = (cfg.head_dim if spec.mixer == "gqa"
              else cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)
        H = cfg.num_heads if spec.mixer == "gqa" else cfg.mla.num_heads
        f += 2.0 * 2.0 * batch * seq * ctx / 2 * H * hd
    return f


def build_lm_graph(cfg: ModelConfig, batch: int, seq: int,
                   microbatches: int = 8,
                   state_mult: float = 6.0) -> TaskGraph:
    """state_mult: HBM bytes per param byte resident during training
    (AdamW bf16+accum+fp32 moments = 6×; Adafactor ≈ 3×)."""
    g = TaskGraph(f"lm-{cfg.name}")
    bpe = 2
    stream_bytes = batch * seq * cfg.d_model * bpe / microbatches
    embed_bytes = cfg.vocab * cfg.d_model * bpe

    g.add_task(Task("embed", ResourceProfile(
        {"hbm_bytes": embed_bytes * (1 if cfg.tie_embeddings else 1),
         "flops": 0.0}),
        hbm_bytes=embed_bytes,
        meta={"ops": 0.0, "kind": "embed"}))

    specs = list(cfg.pattern) * cfg.num_superblocks + list(cfg.extra_layers)
    prev = "embed"
    for i, spec in enumerate(specs):
        pb = layer_param_bytes(cfg, spec)
        fl = 6.0 * layer_flops(cfg, spec, batch, seq)
        t = Task(f"layer{i}", ResourceProfile(
            {"hbm_bytes": pb * state_mult,  # params+grads+opt moments
             "flops": fl}),
            hbm_bytes=pb,
            meta={"ops": fl, "kind": spec.mixer, "layer": i})
        g.add_task(t)
        g.add_channel(prev, f"layer{i}", width_bits=int(stream_bytes * 8),
                      bytes_per_step=stream_bytes)
        prev = f"layer{i}"

    head_bytes = (cfg.vocab * cfg.d_model * bpe
                  if not cfg.tie_embeddings else 0.0)
    g.add_task(Task("head", ResourceProfile(
        {"hbm_bytes": head_bytes + embed_bytes * 0.0,
         "flops": 6.0 * 2.0 * batch * seq * cfg.d_model * cfg.vocab}),
        hbm_bytes=head_bytes,
        meta={"ops": 6.0 * 2.0 * batch * seq * cfg.d_model * cfg.vocab,
              "kind": "head"}))
    g.add_channel(prev, "head", width_bits=int(stream_bytes * 8),
                  bytes_per_step=stream_bytes)
    if cfg.mtp:
        g.add_task(Task("mtp_head", ResourceProfile(
            {"hbm_bytes": layer_param_bytes(cfg, LayerSpec("gqa", "dense")),
             "flops": 6.0 * 2.0 * batch * seq * cfg.d_model * cfg.vocab}),
            meta={"ops": 0.0, "kind": "mtp"}))
        # Reconvergent branch: exercises cut-set balancing (C5).
        g.add_channel(prev, "mtp_head", width_bits=int(stream_bytes * 8),
                      bytes_per_step=stream_bytes)
        g.add_channel("mtp_head", "head", width_bits=64,
                      bytes_per_step=8.0)
    if cfg.arch == "encdec":
        g.add_task(Task("encoder", ResourceProfile(
            {"hbm_bytes": sum(layer_param_bytes(cfg, s)
                              for s in cfg.enc_pattern)
             * cfg.enc_superblocks * 6.0,
             "flops": sum(6.0 * layer_flops(cfg, s, batch, seq // 4)
                          for s in cfg.enc_pattern) * cfg.enc_superblocks}),
            meta={"ops": 0.0, "kind": "encoder"}))
        # Cross-attention edges: encoder output feeds every decoder layer —
        # reconvergent fan-out, balanced by C5.
        enc_bytes = batch * (seq // 4) * cfg.d_model * bpe / microbatches
        for i in range(len(specs)):
            g.add_channel("encoder", f"layer{i}",
                          width_bits=int(enc_bytes * 8),
                          bytes_per_step=enc_bytes)
    return g


def total_param_bytes(cfg: ModelConfig) -> float:
    specs = list(cfg.pattern) * cfg.num_superblocks + list(cfg.extra_layers)
    bpe = 2 if cfg.param_dtype == torch.bfloat16 else 4
    n = sum(layer_param_bytes(cfg, s) for s in specs)
    n += cfg.vocab * cfg.d_model * bpe
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model * bpe
    if cfg.arch == "encdec":
        n += sum(layer_param_bytes(cfg, s) for s in cfg.enc_pattern
                 ) * cfg.enc_superblocks
    return n
