"""xlstm-1.3b [ssm] — 48L, d_model=2048, xLSTM[7:1]: 6 super-blocks of
(7 mLSTM + 1 sLSTM), no separate FFN (mLSTM up-projection factor 2 plays the
FFN role), vocab=50304.  [arXiv:2405.04517; unverified]

Sub-quadratic (constant-size recurrent state) → runs long_500k.
"""
import torch

from ..models import LayerSpec, MLSTMConfig, ModelConfig, SLSTMConfig

FAMILY = "ssm"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

_PATTERN = tuple([LayerSpec("mlstm", "none")] * 7
                 + [LayerSpec("slstm", "none")])


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        d_model=2048, vocab=50304,
        pattern=_PATTERN, num_superblocks=6,
        num_heads=4, num_kv_heads=4, head_dim=512,
        # chunk=512: the JAX file's choice for its training memory; the
        # prefill's chunk scan carries (C, n, m) from chunk to chunk.
        mlstm=MLSTMConfig(d_model=2048, num_heads=4, proj_factor=2.0,
                          chunk=512),
        slstm=SLSTMConfig(d_model=2048, num_heads=4),
        d_ff=0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        d_model=64, vocab=128,
        pattern=(LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
        num_superblocks=2,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mlstm=MLSTMConfig(d_model=64, num_heads=4, proj_factor=2.0, chunk=8),
        slstm=SLSTMConfig(d_model=64, num_heads=4),
        d_ff=0,
        tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32,
    )
