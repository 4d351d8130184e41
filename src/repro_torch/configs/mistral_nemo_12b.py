"""mistral-nemo-12b [dense] — 40L, d_model=5120, 32H (GQA kv=8, head_dim 128),
d_ff=14336, vocab=131072, 128k ctx (rope theta 1e6).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
import torch

from ..models import LayerSpec, ModelConfig

FAMILY = "dense"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        d_model=5120, vocab=131072,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=40,
        num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1e6,
        d_ff=14336, activation="silu",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=1e6,
        d_ff=128, activation="silu",
        tie_embeddings=False,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
