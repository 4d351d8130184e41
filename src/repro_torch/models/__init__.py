"""LM model substrate: attention (GQA, MLA), the recurrent mixers (RG-LRU,
mLSTM, sLSTM), dense and MoE FFN layers and stack assembly.  Enc-dec, the
frontends and training wait (ROADMAP)."""
from .attention import AttnConfig, MLAConfig
from .convert import params_from_jax
from .ffn import FFNConfig
from .moe import MoEConfig
from .recurrent import MLSTMConfig, RGLRUConfig, SLSTMConfig
from .transformer import (LayerSpec, ModelConfig, apply_layer, init_cache,
                          init_params, param_count, serve_step)

__all__ = [
    "LayerSpec", "ModelConfig", "init_params", "init_cache", "serve_step",
    "param_count", "apply_layer", "params_from_jax",
    "AttnConfig", "FFNConfig", "MLAConfig", "MoEConfig",
    "RGLRUConfig", "MLSTMConfig", "SLSTMConfig",
]
