"""LM model substrate: attention (GQA, cross attention, MLA), the
recurrent mixers (RG-LRU, mLSTM, sLSTM), dense and MoE FFN layers and
stack assembly (decoder-only and enc-dec, with the audio and vision
frontend stubs), the training loss (``train_loss``), and ``shardctx``,
the mesh context that gathers sharded weights at use."""
from .attention import AttnConfig, MLAConfig
from .convert import opt_state_from_jax, params_from_jax
from .ffn import FFNConfig
from .moe import MoEConfig
from .recurrent import MLSTMConfig, RGLRUConfig, SLSTMConfig
from .transformer import (LayerSpec, ModelConfig, apply_layer, chunked_xent,
                          init_cache, init_params, param_count,
                          prefill_flash_launches, serve_step,
                          train_flash_launches, train_loss)

__all__ = [
    "LayerSpec", "ModelConfig", "init_params", "init_cache", "serve_step",
    "param_count", "apply_layer", "params_from_jax", "opt_state_from_jax",
    "prefill_flash_launches", "train_flash_launches", "train_loss",
    "chunked_xent",
    "AttnConfig", "FFNConfig", "MLAConfig", "MoEConfig",
    "RGLRUConfig", "MLSTMConfig", "SLSTMConfig",
]
