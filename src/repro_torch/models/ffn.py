"""Dense FFN (GLU family) — LLaMA/Gemma/Qwen style gated MLPs.

The products are plain ``torch.matmul``: JAX computes them outside any
Pallas kernel too.
"""
from __future__ import annotations

import dataclasses

import torch

from . import layers


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"    # silu → SwiGLU; gelu → GeGLU
    gated: bool = True


def init_ffn(gen: torch.Generator, cfg: FFNConfig,
             dtype=torch.float32) -> dict:
    p = {"wi_df": layers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype)}
    if cfg.gated:
        p["wg_df"] = layers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype)
    p["wo_fd"] = layers.dense_init(gen, cfg.d_ff, cfg.d_model, dtype)
    return p


def ffn_forward(params, cfg: FFNConfig, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi_df"]
    if cfg.gated:
        h = layers.act_fn(cfg.activation)(x @ params["wg_df"]) * h
    else:
        h = layers.act_fn(cfg.activation)(h)
    return h @ params["wo_fd"]
