"""gemma2-27b [dense] — 46L alternating local(4096)/global attention,
d_model=4608, 32H (GQA kv=16, head_dim 128), d_ff=36864 GeGLU, vocab=256000,
attn softcap 50 / final softcap 30, pre+post RMSNorm (zero-centered),
query scale 1/sqrt(d_model/num_heads)=1/12.  [arXiv:2408.00118; hf]"""
import torch

from ..models import LayerSpec, ModelConfig

FAMILY = "dense"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        d_model=4608, vocab=256000,
        pattern=(LayerSpec("gqa", "dense", window=4096),
                 LayerSpec("gqa", "dense")),
        num_superblocks=23,
        num_heads=32, num_kv_heads=16, head_dim=128,
        attn_softcap=50.0, final_softcap=30.0,
        query_scale=1.0 / (4608 / 32) ** 0.5,
        use_post_norm=True, zero_centered_norm=True, scale_embed=True,
        d_ff=36864, activation="gelu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("gqa", "dense", window=8),
                 LayerSpec("gqa", "dense")),
        num_superblocks=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        attn_softcap=50.0, final_softcap=30.0,
        query_scale=1.0 / 4.0,
        use_post_norm=True, zero_centered_norm=True, scale_embed=True,
        d_ff=128, activation="gelu",
        tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
