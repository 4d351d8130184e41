"""qwen3-4b [dense] — 36L, d_model=2560, 32H (GQA kv=8, head_dim 128),
d_ff=9728 SwiGLU, vocab=151936, per-head qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
import torch

from ..models import LayerSpec, ModelConfig

FAMILY = "dense"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        d_model=2560, vocab=151936,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=36,
        num_heads=32, num_kv_heads=8, head_dim=128,
        qk_norm=True, rope_theta=1e6,
        d_ff=9728, activation="silu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        qk_norm=True, rope_theta=1e6,
        d_ff=128, activation="silu",
        tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
