"""llava-next-34b [vlm] — 60L Yi-34B backbone: d_model=7168, 56H (GQA kv=8,
head_dim 128), d_ff=20480 SwiGLU, vocab=64000; anyres vision tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision tower is a STUB: the prefill step takes 576 precomputed patch
embeddings ``batch["frontend"]`` [B, 576, d_model], prepended to the token
sequence (anyres tiling happens in the frontend, upstream of the backbone
modelled here).
"""
import torch

from ..models import LayerSpec, ModelConfig

FAMILY = "vlm"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        d_model=7168, vocab=64000,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=60,
        num_heads=56, num_kv_heads=8, head_dim=128,
        rope_theta=5e6,
        d_ff=20480, activation="silu",
        frontend="vision", frontend_tokens=576,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=5e6,
        d_ff=128, activation="silu",
        frontend="vision", frontend_tokens=4,
        tie_embeddings=False,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
