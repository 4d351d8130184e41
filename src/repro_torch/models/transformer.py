"""Model assembly: decoder-only stacks over a repeating layer pattern
("super-block").

Every ported architecture is an instance of ModelConfig:
  * pattern: the repeating tuple of LayerSpecs (e.g. gemma2 = (local,
    global)).
  * The stack runs `num_superblocks` copies of the pattern.

The JAX package scans stacked super-block params; the port holds the
layers in order in an ``nn.ModuleList`` (``params["blocks"][l]`` is layer
``l = sb * len(pattern) + i``, of spec ``pattern[i]``) and loops over them
in Python.  Decode carries one cache per layer in the same order.

Ported: layers of the ``gqa`` and ``mla`` mixers and the ``dense`` and
``moe`` FFNs, the DeepSeek-V3 ``mtp`` head's parameters, and the serving
side (prefill stack, ``serve_step``).  Every other mixer or FFN,
``extra_layers``, architecture style or frontend raises
``NotImplementedError`` naming its ROADMAP item.  Training
(``train_loss``, ``chunked_xent``) waits for the training slice, and with
it the MTP head's forward, which only ``train_loss`` runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..exec.programs import resolve_device
from . import attention as attn
from . import ffn as ffnmod
from . import layers
from . import moe as moemod


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                      # gqa|mla|rglru|mlstm|slstm|none
    ffn: str = "dense"              # dense|moe|none
    window: Optional[int] = None    # sliding window for this layer's attn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    pattern: Tuple[LayerSpec, ...]
    num_superblocks: int
    extra_layers: Tuple[LayerSpec, ...] = ()
    # attention
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    # ffn
    d_ff: int = 0
    activation: str = "silu"
    # gemma-2 style post-norms (norm applied to sublayer output too)
    use_post_norm: bool = False
    zero_centered_norm: bool = False
    # MoE
    moe: Optional[moemod.MoEConfig] = None
    # MLA
    mla: Optional[attn.MLAConfig] = None
    # the recurrent mixers: configs of modules not ported yet
    rglru: Optional[Any] = None
    mlstm: Optional[Any] = None
    slstm: Optional[Any] = None
    # architecture style
    arch: str = "decoder"           # decoder | encdec
    enc_superblocks: int = 0
    enc_pattern: Tuple[LayerSpec, ...] = ()
    frontend: Optional[str] = None  # None | audio | vision
    frontend_tokens: int = 0        # patches/frames prepended (vision)
    mtp: bool = False               # DeepSeek-V3 multi-token-prediction head
    tie_embeddings: bool = True
    scale_embed: bool = False       # gemma convention
    # dtypes
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    # The JAX path's query chunk; the flash kernel needs none.  Kept so the
    # config files map one to one.
    q_chunk: int = 256

    # -- derived -----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return (len(self.pattern) * self.num_superblocks
                + len(self.extra_layers))

    def attn_cfg(self, spec: LayerSpec) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, rope_fraction=self.rope_fraction,
            qk_norm=self.qk_norm, attn_softcap=self.attn_softcap,
            window=spec.window, query_scale=self.query_scale)

    def ffn_cfg(self) -> ffnmod.FFNConfig:
        return ffnmod.FFNConfig(self.d_model, self.d_ff, self.activation)


# What waits, by the ROADMAP item (Queue 1) that ports it.
_NOT_PORTED = {
    "rglru": "item 6c (recurrent)", "mlstm": "item 6c (recurrent)",
    "slstm": "item 6c (recurrent)", "none": "item 6c (recurrent)",
    "extra_layers": "item 6c (recurrent)",
    "encdec": "item 6d (cross_forward / encdec)",
    "audio": "item 6d (cross_forward / encdec)",
    "vision": "item 6e (vision frontend)",
}
MIXERS = ("gqa", "mla")
FFNS = ("dense", "moe")
#: The layer kind of the MTP head's block.
MTP_SPEC = LayerSpec("gqa", "dense")


def _not_ported(what: str, key: str) -> NotImplementedError:
    item = _NOT_PORTED.get(key, "item 6 (the LM side)")
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"{item})")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in MIXERS:
        raise _not_ported(f"mixer {spec.mixer!r}", spec.mixer)
    if spec.ffn not in FFNS:
        raise _not_ported(f"ffn {spec.ffn!r}", spec.ffn)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for any part of ``cfg`` the port lacks."""
    for spec in cfg.pattern:
        _check_spec(spec)
    if cfg.extra_layers:
        raise _not_ported("extra_layers", "extra_layers")
    if cfg.arch != "decoder":
        raise _not_ported(f"arch {cfg.arch!r}", cfg.arch)
    if cfg.frontend is not None:
        raise _not_ported(f"frontend {cfg.frontend!r}", cfg.frontend)


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The decoder stack's specs in layer order (``params["blocks"]``)."""
    return [spec for _ in range(cfg.num_superblocks) for spec in cfg.pattern]


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one device when 0 is the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda" and (a.index is None or b.index is None):
        cur = torch.cuda.current_device()
        return (a.index if a.index is not None else cur) == (
            b.index if b.index is not None else cur)
    return a.index == b.index


def check_on(params: torch.nn.Module, device: torch.device) -> None:
    """Raise unless every parameter lies on ``device`` (nothing is moved)."""
    where = {p.device for p in params.parameters()}
    if not all(same_device(d, device) for d in where):
        raise ValueError(f"params lie on {sorted(map(str, where))}, not "
                         f"{device}; move them or pass that device")


# =============================================================================
# Parameter initialization
# =============================================================================

def _init_layer(gen: torch.Generator, cfg: ModelConfig,
                spec: LayerSpec) -> dict:
    dt, dev = cfg.param_dtype, gen.device
    p: Dict[str, Any] = {
        "ln_mixer": layers.rmsnorm_init(cfg.d_model, dt, dev),
        "attn": (attn.init_mla(gen, cfg.mla, dt) if spec.mixer == "mla"
                 else attn.init_gqa(gen, cfg.attn_cfg(spec), dt)),
        "ln_ffn": layers.rmsnorm_init(cfg.d_model, dt, dev),
        "ffn": (moemod.init_moe(gen, cfg.moe, dt) if spec.ffn == "moe"
                else ffnmod.init_ffn(gen, cfg.ffn_cfg(), dt)),
    }
    if cfg.use_post_norm:
        p["post_mixer"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["post_ffn"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> layers.ParamTree:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dt = cfg.param_dtype
    tree: Dict[str, Any] = {
        "embed_vd": layers.embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "blocks": [_init_layer(gen, cfg, s) for s in layer_specs(cfg)],
        "final_norm": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        tree["unembed_dv"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                               dt)
    if cfg.mtp:
        # The MTP head (DeepSeek-V3 §2.2): one GQA block over
        # [h; embed(next token)].  Its forward belongs to train_loss.
        tree["mtp_block"] = _init_layer(gen, cfg, MTP_SPEC)
        tree["mtp_proj_dd"] = layers.dense_init(gen, 2 * cfg.d_model,
                                                cfg.d_model, dt)
    return layers.ParamTree(tree)


def _layer_count(cfg: ModelConfig, spec: LayerSpec) -> int:
    D, hd = cfg.d_model, cfg.head_dim
    if spec.mixer == "mla":
        mixer = attn.mla_param_count(cfg.mla)
    else:
        mixer = (2 * D * hd * (cfg.num_heads + cfg.num_kv_heads)
                 + (2 * hd if cfg.qk_norm else 0))
    ffn = (moemod.param_count(cfg.moe) if spec.ffn == "moe"
           else 3 * D * cfg.d_ff)
    return mixer + ffn + (4 if cfg.use_post_norm else 2) * D


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count of :func:`init_params`' tree."""
    check_supported(cfg)
    D = cfg.d_model
    embed = cfg.vocab * D * (1 if cfg.tie_embeddings else 2)
    mtp = _layer_count(cfg, MTP_SPEC) + 2 * D * D if cfg.mtp else 0
    return (embed + D + mtp
            + sum(_layer_count(cfg, s) for s in layer_specs(cfg)))


# =============================================================================
# Layer application (shared by prefill / decode)
# =============================================================================

def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return layers.rmsnorm(p, x, zero_centered=cfg.zero_centered_norm)


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict] = None,
                pos: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Union[torch.Tensor, float]]:
    """One residual block: the full sequence, or with ``cache`` one decode
    step at ``pos``.  Returns (x, new_cache, moe_aux); moe_aux is an fp32
    scalar tensor for a MoE FFN and the float 0.0 for a dense one, so a
    dense step allocates nothing for it."""
    _check_spec(spec)
    new_cache: Optional[dict] = None
    h = _norm(cfg, p["ln_mixer"], x)
    if spec.mixer == "mla":
        if cache is not None:
            new_cache, h = attn.mla_decode(p["attn"], cfg.mla, cache, h, pos)
        else:
            h = attn.mla_forward(p["attn"], cfg.mla, h, positions)
    elif cache is not None:
        new_cache, h = attn.gqa_decode(p["attn"], cfg.attn_cfg(spec), cache,
                                       h, pos)
    else:
        h = attn.gqa_forward(p["attn"], cfg.attn_cfg(spec), h, positions)
    if cfg.use_post_norm:
        h = _norm(cfg, p["post_mixer"], h)
    x = x + h
    h = _norm(cfg, p["ln_ffn"], x)
    if spec.ffn == "moe":
        h, aux = moemod.moe_forward(p["ffn"], cfg.moe, h)
    else:
        h = ffnmod.ffn_forward(p["ffn"], cfg.ffn_cfg(), h)
        aux = 0.0
    if cfg.use_post_norm:
        h = _norm(cfg, p["post_ffn"], h)
    return x + h, new_cache, aux


# =============================================================================
# Full-sequence forward (prefill)
# =============================================================================

def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if cfg.frontend is not None:
        raise _not_ported(f"frontend {cfg.frontend!r}", cfg.frontend)
    return layers.embed_lookup(params["embed_vd"], batch["tokens"],
                               scale_by_dim=cfg.scale_embed).to(cfg.dtype)


def _run_stack(params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the decoder stack over a whole sequence: x [B,S,D].  Returns
    (x, the summed MoE aux loss)."""
    check_supported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, p in zip(layer_specs(cfg), params["blocks"]):
        x, _, a = apply_layer(cfg, spec, p, x, positions)
        if spec.ffn == "moe":
            aux = aux + a
    return x, aux


def _unembed_table(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed_vd"]
    return params["unembed_dv"].T


# =============================================================================
# Decode (serve_step)
# =============================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """One cache per layer, in the order of ``params["blocks"]``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def one_layer(spec: LayerSpec) -> dict:
        if spec.mixer == "mla":
            return attn.init_mla_cache(cfg.mla, batch, max_len,
                                       dtype=cfg.dtype, device=dev)
        return attn.init_kv_cache(cfg.attn_cfg(spec), batch, max_len,
                                  dtype=cfg.dtype, device=dev)
    return {"blocks": [one_layer(s) for s in layer_specs(cfg)]}


def serve_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
               pos: int) -> Tuple[dict, torch.Tensor]:
    """One decode step.  tokens: [B,1]; pos: the current absolute position,
    the same for the whole batch.  Updates ``cache`` in place and returns
    (cache, logits [B,V] fp32)."""
    pos = int(pos)
    x = layers.embed_lookup(params["embed_vd"], tokens,
                            scale_by_dim=cfg.scale_embed).to(cfg.dtype)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    for spec, p, c in zip(layer_specs(cfg), params["blocks"],
                          cache["blocks"]):
        x, _, _ = apply_layer(cfg, spec, p, x, positions, cache=c,
                              pos=pos)
    x = layers.rmsnorm(params["final_norm"], x,
                       zero_centered=cfg.zero_centered_norm)
    logits = layers.unembed(_unembed_table(params, cfg), x[:, 0, :])
    return cache, layers.softcap(logits, cfg.final_softcap)
