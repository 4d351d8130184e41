"""Model assembly: decoder-only and encoder-decoder stacks over a repeating
layer pattern ("super-block").

Every assigned architecture is an instance of ModelConfig:
  * pattern: the repeating tuple of LayerSpecs (e.g. gemma2 = (local,
    global)).
  * The stack runs `num_superblocks` copies of the pattern.

The JAX package scans stacked super-block params; the port holds the
layers in order in an ``nn.ModuleList`` (``params["blocks"][l]`` is layer
``l = sb * len(pattern) + i``, of spec ``pattern[i]``) and loops over them
in Python.  Decode carries one cache per layer in the same order.

``extra_layers`` follow the super-blocks in the same list (layer
``num_superblocks * len(pattern) + i`` is ``extra_layers[i]``).  An
enc-dec config's encoder runs ``enc_superblocks`` copies of
``enc_pattern``, held the same way in ``params["enc_blocks"]``; each
decoder layer (the extra ones too) then carries a cross-attention block
(``ln_cross``, ``cross``) that attends to the encoder's output.

Ported: layers of the ``gqa``, ``mla``, ``rglru``, ``mlstm``, ``slstm``
and ``none`` mixers and the ``dense``, ``moe`` and ``none`` FFNs,
``extra_layers``, the encoder and cross attention (``arch="encdec"``,
with the audio frontend stub: precomputed frames ``batch["src"]``), the
vision frontend stub (patch embeddings ``batch["frontend"]`` prepended to
the tokens), the DeepSeek-V3 ``mtp`` head's parameters, and the serving
side (prefill stack, ``serve_step``, the recurrent states in the cache),
and training: ``train_loss`` (with the MTP head's forward, which only it
runs) and ``chunked_xent``, which computes the cross-entropy without a
[B,S,V] logits tensor, for every mixer.  Under autograd each super-block
of the stacks is recomputed in the backward (``torch.utils.checkpoint``,
JAX's ``jax.checkpoint(body)``), and so is each 512-row chunk of the
cross-entropy; a decoder pattern of 4 or more layers (xlstm's 8) also
recomputes each layer inside its super-block's recompute (JAX's second
remat level).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..exec.programs import resolve_device
from . import attention as attn
from . import ffn as ffnmod
from . import layers
from . import moe as moemod
from . import recurrent as rec
from . import shardctx


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
    # recurrent
    rglru: Optional[rec.RGLRUConfig] = None
    mlstm: Optional[rec.MLSTMConfig] = None
    slstm: Optional[rec.SLSTMConfig] = None
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

    def attn_cfg(self, spec: LayerSpec,
                 causal: bool = True) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, rope_fraction=self.rope_fraction,
            qk_norm=self.qk_norm, attn_softcap=self.attn_softcap,
            window=spec.window, query_scale=self.query_scale, causal=causal)

    def ffn_cfg(self) -> ffnmod.FFNConfig:
        return ffnmod.FFNConfig(self.d_model, self.d_ff, self.activation)


MIXERS = ("gqa", "mla", "rglru", "mlstm", "slstm", "none")
FFNS = ("dense", "moe", "none")
#: The mixers that run attention (a flash kernel launch a prefill layer).
ATTENTION_MIXERS = ("gqa", "mla")
#: The layer kind of the MTP head's block.
MTP_SPEC = LayerSpec("gqa", "dense")
#: The MTP loss's weight (DeepSeek-V3 §2.2) and the cross-entropy's chunk.
MTP_WEIGHT = 0.3
XENT_CHUNK = 512
#: A decoder pattern of this many layers or more recomputes each layer in
#: the backward inside its super-block's recompute (JAX's ``inner_remat``).
INNER_REMAT_LAYERS = 4


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in MIXERS:
        raise NotImplementedError(f"mixer {spec.mixer!r} is not a layer "
                                  f"kind of the model ({MIXERS})")
    if spec.ffn not in FFNS:
        raise NotImplementedError(f"ffn {spec.ffn!r} is not a layer kind "
                                  f"of the model ({FFNS})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a layer kind the model does not know
    (an unknown mixer or FFN)."""
    for spec in cfg.pattern + cfg.extra_layers + cfg.enc_pattern:
        _check_spec(spec)


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The decoder stack's specs in layer order (``params["blocks"]``): the
    super-blocks, then ``extra_layers``."""
    return ([spec for _ in range(cfg.num_superblocks) for spec in cfg.pattern]
            + list(cfg.extra_layers))


def enc_layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The encoder's specs in layer order (``params["enc_blocks"]``); none
    for a decoder-only config."""
    if cfg.arch != "encdec":
        return []
    return [spec for _ in range(cfg.enc_superblocks)
            for spec in cfg.enc_pattern]


def prefill_flash_launches(cfg: ModelConfig) -> int:
    """Flash kernel launches of one prefill: one per attention layer of the
    decoder stack; for an enc-dec config also one per encoder layer that
    runs attention, and one per decoder layer (each has a cross-attention
    block)."""
    dec = layer_specs(cfg)
    n = sum(s.mixer in ATTENTION_MIXERS for s in dec)
    if cfg.arch == "encdec":
        n += sum(s.mixer in ATTENTION_MIXERS for s in enc_layer_specs(cfg))
        n += len(dec)
    return n


def train_flash_launches(cfg: ModelConfig) -> int:
    """Flash kernel launches of one ``train_loss`` forward and backward:
    each attention of a super-block (the mixer, and an enc-dec decoder
    layer's cross attention) runs twice, in the forward and in the
    super-block's recompute.  With the per-layer recompute of a pattern of
    ``INNER_REMAT_LAYERS`` or more it runs a third time, in its layer's
    recompute, except in the pattern's last layer: the super-block's
    recompute stops once it holds that layer's input (PyTorch's
    checkpoint early stop), as XLA drops a recompute whose output nothing
    reads.  The ``extra_layers`` and the MTP head's block are not
    recomputed and run once."""
    n_sb = cfg.num_superblocks * len(cfg.pattern)
    dec = layer_specs(cfg)
    cross = cfg.arch == "encdec"
    inner = len(cfg.pattern) >= INNER_REMAT_LAYERS

    def per_layer(s: LayerSpec) -> int:
        return (s.mixer in ATTENTION_MIXERS) + cross

    def runs(i: int) -> int:
        last = i % len(cfg.pattern) == len(cfg.pattern) - 1
        return 3 if inner and not last else 2

    n = (sum(runs(i) * per_layer(s) for i, s in enumerate(dec[:n_sb]))
         + sum(per_layer(s) for s in dec[n_sb:]))
    n += 2 * sum(s.mixer in ATTENTION_MIXERS for s in enc_layer_specs(cfg))
    return n + (1 if cfg.mtp else 0)


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
                spec: LayerSpec, cross: bool = False) -> dict:
    dt, dev = cfg.param_dtype, gen.device
    p: Dict[str, Any] = {"ln_mixer": layers.rmsnorm_init(cfg.d_model, dt,
                                                         dev)}
    if spec.mixer == "gqa":
        p["attn"] = attn.init_gqa(gen, cfg.attn_cfg(spec), dt)
    elif spec.mixer == "mla":
        p["attn"] = attn.init_mla(gen, cfg.mla, dt)
    elif spec.mixer == "rglru":
        p["attn"] = rec.init_rglru(gen, cfg.rglru, dt)
    elif spec.mixer == "mlstm":
        p["attn"] = rec.init_mlstm(gen, cfg.mlstm, dt)
    elif spec.mixer == "slstm":
        p["attn"] = rec.init_slstm(gen, cfg.slstm, dt)
    if cross:
        p["ln_cross"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["cross"] = attn.init_gqa(gen, cfg.attn_cfg(spec), dt)
    if spec.ffn != "none":
        p["ln_ffn"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["ffn"] = (moemod.init_moe(gen, cfg.moe, dt) if spec.ffn == "moe"
                    else ffnmod.init_ffn(gen, cfg.ffn_cfg(), dt))
    if cfg.use_post_norm:
        p["post_mixer"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        if spec.ffn != "none":
            p["post_ffn"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> layers.ParamTree:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dt = cfg.param_dtype
    cross = cfg.arch == "encdec"
    tree: Dict[str, Any] = {
        "embed_vd": layers.embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "blocks": [_init_layer(gen, cfg, s, cross) for s in layer_specs(cfg)],
        "final_norm": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        tree["unembed_dv"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                               dt)
    if cross:
        tree["enc_blocks"] = [_init_layer(gen, cfg, s)
                              for s in enc_layer_specs(cfg)]
        tree["enc_final_norm"] = layers.rmsnorm_init(cfg.d_model, dt,
                                                     gen.device)
    if cfg.mtp:
        # The MTP head (DeepSeek-V3 §2.2): one GQA block over
        # [h; embed(next token)].  Its forward belongs to train_loss.
        tree["mtp_block"] = _init_layer(gen, cfg, MTP_SPEC)
        tree["mtp_proj_dd"] = layers.dense_init(gen, 2 * cfg.d_model,
                                                cfg.d_model, dt)
    return layers.ParamTree(tree)


def _gqa_count(cfg: ModelConfig) -> int:
    D, hd = cfg.d_model, cfg.head_dim
    return (2 * D * hd * (cfg.num_heads + cfg.num_kv_heads)
            + (2 * hd if cfg.qk_norm else 0))


def _layer_count(cfg: ModelConfig, spec: LayerSpec,
                 cross: bool = False) -> int:
    D = cfg.d_model
    mixer = 0
    if spec.mixer == "gqa":
        mixer = _gqa_count(cfg)
    elif spec.mixer == "mla":
        mixer = attn.mla_param_count(cfg.mla)
    elif spec.mixer == "rglru":
        mixer = rec.rglru_param_count(cfg.rglru)
    elif spec.mixer == "mlstm":
        mixer = rec.mlstm_param_count(cfg.mlstm)
    elif spec.mixer == "slstm":
        mixer = rec.slstm_param_count(cfg.slstm)
    ffn = 0
    if spec.ffn == "moe":
        ffn = moemod.param_count(cfg.moe)
    elif spec.ffn == "dense":
        ffn = 3 * D * cfg.d_ff
    norms = (2 if cfg.use_post_norm else 1) * (1 + (spec.ffn != "none"))
    if cross:
        mixer += _gqa_count(cfg) + D          # cross and ln_cross
    return mixer + ffn + norms * D


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count of :func:`init_params`' tree."""
    check_supported(cfg)
    D = cfg.d_model
    embed = cfg.vocab * D * (1 if cfg.tie_embeddings else 2)
    mtp = _layer_count(cfg, MTP_SPEC) + 2 * D * D if cfg.mtp else 0
    cross = cfg.arch == "encdec"
    enc = (sum(_layer_count(cfg, s) for s in enc_layer_specs(cfg)) + D
           if cross else 0)
    return (embed + D + mtp + enc
            + sum(_layer_count(cfg, s, cross) for s in layer_specs(cfg)))


# =============================================================================
# Layer application (shared by prefill / decode)
# =============================================================================

def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return layers.rmsnorm(p, x, zero_centered=cfg.zero_centered_norm)


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict] = None,
                pos: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None,
                causal: bool = True
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Union[torch.Tensor, float]]:
    """One residual block: the full sequence, or with ``cache`` one decode
    step at ``pos``.  On a mesh the layer's sharded weights are gathered
    here (``shardctx.gather``), so under autograd inside the super-block's
    recompute too.  With ``enc_out`` [B,Senc,D], a layer that has a cross
    block attends to it between the mixer and the FFN (no post-norm);
    ``causal=False`` makes GQA bidirectional (the encoder).  Returns (x,
    new_cache, moe_aux); moe_aux is an fp32 scalar tensor for a MoE FFN
    and the float 0.0 for a dense one, so a dense step allocates nothing
    for it."""
    _check_spec(spec)
    p = shardctx.gather(p)
    new_cache: Optional[dict] = None
    h = _norm(cfg, p["ln_mixer"], x)
    if spec.mixer == "gqa":
        acfg = cfg.attn_cfg(spec, causal=causal)
        if cache is not None:
            new_cache, h = attn.gqa_decode(p["attn"], acfg, cache, h, pos)
        else:
            h = attn.gqa_forward(p["attn"], acfg, h, positions)
    elif spec.mixer == "mla":
        if cache is not None:
            new_cache, h = attn.mla_decode(p["attn"], cfg.mla, cache, h, pos)
        else:
            h = attn.mla_forward(p["attn"], cfg.mla, h, positions)
    elif spec.mixer == "rglru":
        h, new_cache = rec.rglru_forward(p["attn"], cfg.rglru, h, cache)
    elif spec.mixer == "mlstm":
        h, new_cache = rec.mlstm_forward(p["attn"], cfg.mlstm, h, cache)
    elif spec.mixer == "slstm":
        h, new_cache = rec.slstm_forward(p["attn"], cfg.slstm, h, cache)
    else:
        h = torch.zeros_like(x)
    if cfg.use_post_norm:
        h = _norm(cfg, p["post_mixer"], h)
    x = x + h
    if enc_out is not None and "cross" in p:
        h = _norm(cfg, p["ln_cross"], x)
        x = x + attn.cross_forward(p["cross"], cfg.attn_cfg(spec), h, enc_out)
    aux = 0.0
    if spec.ffn == "none":
        return x, new_cache, aux
    h = _norm(cfg, p["ln_ffn"], x)
    if spec.ffn == "moe":
        h, aux = moemod.moe_forward(p["ffn"], cfg.moe, h)
    else:
        h = ffnmod.ffn_forward(p["ffn"], cfg.ffn_cfg(), h)
    if cfg.use_post_norm:
        h = _norm(cfg, p["post_ffn"], h)
    return x + h, new_cache, aux


# =============================================================================
# Full-sequence forward (prefill)
# =============================================================================

def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The token embeddings [B,St,D]; for the vision frontend the patch
    embeddings ``batch["frontend"]`` [B,P,D] go first ([B,P+St,D]).  The
    audio frontend's frames feed the encoder, not this sequence."""
    x = layers.embed_lookup(params["embed_vd"], batch["tokens"],
                            scale_by_dim=cfg.scale_embed).to(cfg.dtype)
    if cfg.frontend == "vision":
        # anyres patch embeddings prepended (stub frontend).
        x = torch.cat([batch["frontend"].to(cfg.dtype), x], dim=1)
    return x


def _superblocks(cfg: ModelConfig, specs, blocks, x: torch.Tensor,
                 n_superblocks: int, inner_remat: bool = False,
                 **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``n_superblocks`` copies of a pattern of ``len(specs) //
    n_superblocks`` layers over x; under autograd each copy is recomputed
    in the backward (JAX's ``jax.checkpoint(body)``), so only its input
    is kept.  With ``inner_remat`` each layer is recomputed too, inside
    its super-block's recompute (JAX's per-layer ``jax.checkpoint``), so
    the backward holds one layer's internals at a time.  Returns (x, the
    summed MoE aux loss)."""
    n = len(specs) // n_superblocks if n_superblocks else 0
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()

    def one_layer(spec, p, h):
        h, _, la = apply_layer(cfg, spec, p, h, **kw)
        return h, la

    def body(h, first):
        a = torch.zeros((), dtype=torch.float32, device=h.device)
        for spec, p in zip(specs[first:first + n], blocks[first:first + n]):
            if remat and inner_remat:
                h, la = checkpoint(one_layer, spec, p, h, use_reentrant=False)
            else:
                h, la = one_layer(spec, p, h)
            if spec.ffn == "moe":
                a = a + la
        return h, a

    for sb in range(n_superblocks):
        if remat:
            x, a = checkpoint(body, x, sb * n, use_reentrant=False)
        else:
            x, a = body(x, sb * n)
        aux = aux + a
    return x, aux


def _run_stack(params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the decoder stack over a whole sequence: x [B,S,D], attending to
    ``enc_out`` in each cross block.  Returns (x, the summed MoE aux
    loss).  Under autograd each super-block is recomputed in the
    backward, and so is each of its layers when the pattern has
    ``INNER_REMAT_LAYERS`` or more; the ``extra_layers`` are not (as in
    JAX)."""
    check_supported(cfg)
    specs, blocks = layer_specs(cfg), params["blocks"]
    n_sb = cfg.num_superblocks * len(cfg.pattern)
    x, aux = _superblocks(cfg, specs[:n_sb], blocks[:n_sb], x,
                          cfg.num_superblocks,
                          inner_remat=len(cfg.pattern) >= INNER_REMAT_LAYERS,
                          positions=positions, enc_out=enc_out)
    for spec, p in zip(specs[n_sb:], blocks[n_sb:]):
        x, _, a = apply_layer(cfg, spec, p, x, positions, enc_out=enc_out)
        if spec.ffn == "moe":
            aux = aux + a
    return x, aux


def _run_encoder(params, cfg: ModelConfig, src: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings src [B,Senc,D] at ``positions``
    [B,Senc]: the ``enc_pattern`` layers, bidirectional, then
    ``enc_final_norm`` (a plain RMSNorm, as JAX's).  Under autograd each
    super-block is recomputed in the backward (no layer on its own: JAX's
    encoder has no second remat level)."""
    x, _ = _superblocks(cfg, enc_layer_specs(cfg), params["enc_blocks"],
                        src, cfg.enc_superblocks, positions=positions,
                        causal=False)
    return layers.rmsnorm(params["enc_final_norm"], x)


def _unembed_table(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed_vd"]
    return params["unembed_dv"].T


# =============================================================================
# Training forward + loss
# =============================================================================

def chunked_xent(params, cfg: ModelConfig, x: torch.Tensor,
                 targets: torch.Tensor, weights: torch.Tensor,
                 chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Softmax cross-entropy without a [B,S,V] intermediate: x [B,S,D],
    targets [B,S] (int), weights [B,S].  Each chunk of ``chunk`` positions
    computes its logits [B,C,V] in fp32 (``layers.unembed``), the final
    softcap, logsumexp and the gold logit, and its weighted sum; under
    autograd the chunk is recomputed in the backward (JAX's
    ``@jax.checkpoint``).  Returns Σ(lse − gold)·w / max(Σw, 1); on a
    mesh that splits the batch, Σw is the whole batch's
    (``shardctx.batch_sum``), so the ranks' losses add up to it."""
    B, S, D = x.shape
    table = _unembed_table(params, cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_xent: {S} positions are not a multiple "
                         f"of the {chunk}-position chunk")

    def one(xc, tc, wc):
        logits = layers.unembed(table, xc)                 # [B,C,V] fp32
        logits = layers.softcap(logits, cfg.final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        return torch.sum((lse - gold) * wc)

    total = 0
    for i in range(0, S, chunk):
        args = (x[:, i:i + chunk], targets[:, i:i + chunk],
                weights[:, i:i + chunk])
        total = total + (checkpoint(one, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else one(*args))
    return total / torch.clamp(shardctx.batch_sum(weights.sum()), min=1.0)


def train_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: tokens [B,St], targets [B,S], weights [B,S]; optional
    frontend [B,P,D] (vision) or src [B,Senc,D] (audio enc-dec).  All on
    the params' device.  Returns the fp32 scalar loss: the cross-entropy,
    plus 0.3 × the MTP head's (predicting t+2) and ``aux_loss_weight`` ×
    the MoE aux loss where the config has them."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    enc_out = None
    if cfg.arch == "encdec":
        src = batch["src"].to(cfg.dtype)
        E = src.shape[1]
        enc_out = _run_encoder(params, cfg, src, torch.arange(
            E, device=x.device).expand(B, E))
    x, aux = _run_stack(params, cfg, x, positions, enc_out)
    x = layers.rmsnorm(params["final_norm"], x,
                       zero_centered=cfg.zero_centered_norm)
    targets, weights = batch["targets"], batch["weights"]
    loss = chunked_xent(params, cfg, x, targets, weights)
    if cfg.mtp:
        # MTP head: one extra block over [h; embed(next_token)] predicting
        # t+2 (DeepSeek-V3 §2.2) — sequential variant with depth 1.
        emb_next = layers.embed_lookup(params["embed_vd"],
                                       targets).to(cfg.dtype)
        h2 = torch.cat([x, emb_next], dim=-1) @ params["mtp_proj_dd"]
        h2, _, _ = apply_layer(cfg, MTP_SPEC, params["mtp_block"], h2,
                               positions)
        t2 = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
        w2 = weights * torch.cat([weights[:, 1:],
                                  torch.zeros_like(weights[:, :1])], dim=1)
        loss = loss + MTP_WEIGHT * chunked_xent(params, cfg, h2, t2, w2)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


# =============================================================================
# Decode (serve_step)
# =============================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """One cache per layer, in the order of ``params["blocks"]``: K/V for
    attention, the fp32 recurrent state for RG-LRU, mLSTM and sLSTM, an
    empty dict for mixer ``none``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def one_layer(spec: LayerSpec) -> dict:
        if spec.mixer == "gqa":
            return attn.init_kv_cache(cfg.attn_cfg(spec), batch, max_len,
                                      dtype=cfg.dtype, device=dev)
        if spec.mixer == "mla":
            return attn.init_mla_cache(cfg.mla, batch, max_len,
                                       dtype=cfg.dtype, device=dev)
        if spec.mixer == "rglru":
            return rec.init_rglru_state(cfg.rglru, batch, device=dev)
        if spec.mixer == "mlstm":
            return rec.init_mlstm_state(cfg.mlstm, batch, device=dev)
        if spec.mixer == "slstm":
            return rec.init_slstm_state(cfg.slstm, batch, device=dev)
        return {}
    return {"blocks": [one_layer(s) for s in layer_specs(cfg)]}


def serve_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
               pos: int, enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[dict, torch.Tensor]:
    """One decode step.  tokens: [B,1]; pos: the current absolute position,
    the same for the whole batch; ``enc_out`` [B,Senc,D]: the encoder's
    output, which every layer's cross block attends to (without it, an
    enc-dec config's cross blocks are skipped, as in JAX).  Updates
    ``cache`` in place (attention writes its K/V slots; a recurrent
    layer's new state replaces its entry of ``cache["blocks"]``) and
    returns (cache, logits [B,V] fp32)."""
    pos = int(pos)
    x = layers.embed_lookup(params["embed_vd"], tokens,
                            scale_by_dim=cfg.scale_embed).to(cfg.dtype)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    blocks = cache["blocks"]
    for i, (spec, p) in enumerate(zip(layer_specs(cfg), params["blocks"])):
        x, nc, _ = apply_layer(cfg, spec, p, x, positions, cache=blocks[i],
                               pos=pos, enc_out=enc_out)
        if nc is not None:
            blocks[i] = nc
    x = layers.rmsnorm(params["final_norm"], x,
                       zero_centered=cfg.zero_centered_norm)
    logits = layers.unembed(_unembed_table(params, cfg), x[:, 0, :])
    return cache, layers.softcap(logits, cfg.final_softcap)
