"""LM model substrate: attention (GQA, MLA), dense and MoE FFN layers and
stack assembly.  The recurrent mixers, enc-dec and training wait
(ROADMAP)."""
from .attention import AttnConfig, MLAConfig
from .convert import params_from_jax
from .ffn import FFNConfig
from .moe import MoEConfig
from .transformer import (LayerSpec, ModelConfig, apply_layer, init_cache,
                          init_params, param_count, serve_step)

__all__ = [
    "LayerSpec", "ModelConfig", "init_params", "init_cache", "serve_step",
    "param_count", "apply_layer", "params_from_jax",
    "AttnConfig", "FFNConfig", "MLAConfig", "MoEConfig",
]
