"""chatglm3-6b [dense] — 28L, d_model=4096, 32H (GQA kv=2), d_ff=13696,
vocab=65024, 2d-RoPE (rotates half the head dims).  [arXiv:2406.12793; hf]"""
import torch

from ..models import LayerSpec, ModelConfig

FAMILY = "dense"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        d_model=4096, vocab=65024,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=28,
        num_heads=32, num_kv_heads=2, head_dim=128,
        rope_fraction=0.5,             # GLM 2d rope: half dims rotated
        d_ff=13696, activation="silu",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        rope_fraction=0.5,
        d_ff=128, activation="silu",
        tie_embeddings=False,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
