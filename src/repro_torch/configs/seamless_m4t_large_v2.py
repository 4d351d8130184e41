"""seamless-m4t-large-v2 [audio] — enc-dec, 24L enc + 24L dec, d_model=1024,
16H (GQA kv=16), d_ff=8192, vocab=256206.  [arXiv:2308.11596; hf]

Modality frontend is a STUB: the prefill step takes precomputed speech-frame
embeddings ``batch["src"]`` [B, seq//4, d_model] (w2v-BERT conformer output
stand-in).  RMSNorm + RoPE stand in for the published LayerNorm +
sinusoidal/relative positions, as in the JAX package's config.
"""
import torch

from ..models import LayerSpec, ModelConfig

FAMILY = "audio-encdec"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        d_model=1024, vocab=256206,
        arch="encdec",
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=24,
        enc_pattern=(LayerSpec("gqa", "dense"),), enc_superblocks=24,
        num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=8192, activation="gelu",
        frontend="audio",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-smoke",
        d_model=64, vocab=128,
        arch="encdec",
        pattern=(LayerSpec("gqa", "dense"),), num_superblocks=2,
        enc_pattern=(LayerSpec("gqa", "dense"),), enc_superblocks=2,
        num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, activation="gelu",
        frontend="audio",
        tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
