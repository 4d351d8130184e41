"""deepseek-v3-671b [moe] — 61L, d_model=7168, 128H MLA, MoE 256 routed
top-8 + 1 shared, d_ff_expert=2048, vocab=129280, aux-loss-free routing +
MTP head.  [arXiv:2412.19437; hf]

Deviation (DESIGN.md): published first 3 layers are dense FFN; kept MoE for
a uniform scan (~1% of FLOPs).
"""
import torch

from ..models import LayerSpec, MLAConfig, ModelConfig, MoEConfig

FAMILY = "moe"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        d_model=7168, vocab=129280,
        pattern=(LayerSpec("mla", "moe"),), num_superblocks=61,
        num_heads=16, num_kv_heads=16, head_dim=128,   # (MTP aux head dims)
        mla=MLAConfig(d_model=7168, num_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(d_model=7168, d_ff_expert=2048, num_experts=256,
                      top_k=8, num_shared=1, capacity_factor=1.25,
                      aux_loss_free=True),
        d_ff=18432,
        mtp=True,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("mla", "moe"),), num_superblocks=2,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mla=MLAConfig(d_model=64, num_heads=4, q_lora_rank=32,
                      kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(d_model=64, d_ff_expert=32, num_experts=8, top_k=2,
                      num_shared=1, aux_loss_free=True),
        d_ff=128,
        mtp=True,
        tie_embeddings=False,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
