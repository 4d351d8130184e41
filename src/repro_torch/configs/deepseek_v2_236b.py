"""deepseek-v2-236b [moe] — 60L, d_model=5120, 128H MLA (kv_lora=512,
q_lora=1536, nope 128 + rope 64, v 128), MoE 160 routed top-6 + 2 shared,
d_ff_expert=1536, vocab=102400.  [arXiv:2405.04434; hf]

Deviation (DESIGN.md): the published model's first layer is a dense FFN; we
keep all 60 layers MoE so the stack scans uniformly — <0.5% of FLOPs.
"""
import torch

from ..models import LayerSpec, MLAConfig, ModelConfig, MoEConfig

FAMILY = "moe"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        d_model=5120, vocab=102400,
        pattern=(LayerSpec("mla", "moe"),), num_superblocks=60,
        num_heads=16, num_kv_heads=16, head_dim=128,   # (MTP aux head dims)
        mla=MLAConfig(d_model=5120, num_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(d_model=5120, d_ff_expert=1536, num_experts=160,
                      top_k=6, num_shared=2, capacity_factor=1.25,
                      aux_loss_free=False),
        d_ff=12288,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("mla", "moe"),), num_superblocks=2,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mla=MLAConfig(d_model=64, num_heads=4, q_lora_rank=32,
                      kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(d_model=64, d_ff_expert=32, num_experts=8, top_k=2,
                      num_shared=2, aux_loss_free=False),
        d_ff=128,
        tie_embeddings=False,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=8,
    )
