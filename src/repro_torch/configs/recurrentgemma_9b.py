"""recurrentgemma-9b [hybrid] — 38L Griffin: pattern (RG-LRU, RG-LRU,
local-attn window 2048) ×12 + 2 trailing recurrent blocks, d_model=4096,
16H MQA (kv=1, head_dim 256), d_ff=12288 GeGLU, vocab=256000.
[arXiv:2402.19427; unverified]

Sub-quadratic (RG-LRU state + 2048-window ring-buffer KV) → runs long_500k.
"""
import torch

from ..models import LayerSpec, ModelConfig, RGLRUConfig

FAMILY = "hybrid"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        d_model=4096, vocab=256000,
        pattern=(LayerSpec("rglru", "dense"), LayerSpec("rglru", "dense"),
                 LayerSpec("gqa", "dense", window=2048)),
        num_superblocks=12,
        extra_layers=(LayerSpec("rglru", "dense"),
                      LayerSpec("rglru", "dense")),
        num_heads=16, num_kv_heads=1, head_dim=256,
        rglru=RGLRUConfig(d_model=4096, d_rnn=4096),
        d_ff=12288, activation="gelu",
        scale_embed=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("rglru", "dense"), LayerSpec("rglru", "dense"),
                 LayerSpec("gqa", "dense", window=8)),
        num_superblocks=2,
        extra_layers=(LayerSpec("rglru", "dense"),),
        num_heads=4, num_kv_heads=1, head_dim=16,
        rglru=RGLRUConfig(d_model=64, d_rnn=64),
        d_ff=128, activation="gelu",
        scale_embed=True,
        tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
