"""The port's LM layers, attention and decoder stack against the JAX
package on the CPU, in fp32, on the same numpy inputs and the same weights
(JAX's ``init_params`` carried over by ``params_from_jax``): within 1e-5
of the output's scale (at least 1).  GQA and MLA (prefill and absorbed
decode), the dense and MoE FFNs, and the stack of every ported arch's
``smoke()`` (the recurrent archs' with their extra layers, the
recurrentgemma ring buffer wrapped, xlstm over two chunks).  Also the port's own prefill-path against decode parity
(``tests/test_models_parity.py``'s contract, its ``mla`` config included)
and its config registry against the JAX configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import LayerSpec as JLayerSpec
from repro.models import MLAConfig as JMLAConfig
from repro.models import ModelConfig as JModelConfig
import repro.models as jmodels
from repro.models import attention as jattn
from repro.models import init_cache as j_init_cache
from repro.launch.steps import build_prefill_step as j_build_prefill_step
from repro.models.transformer import apply_layer as j_apply_layer
from repro.models import init_params as j_init_params
from repro.models import layers as jlayers
from repro.models import param_count as j_param_count
from repro.models import serve_step as j_serve_step
import repro_torch.models as tmodels
from repro_torch import configs
from repro_torch.models import (LayerSpec, MLAConfig, init_cache,
                                init_params, param_count, params_from_jax,
                                serve_step)
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models.convert import FP32_LEAVES, tree_from_numpy

from _torch_parity import np_tree as _np_tree
from _torch_parity import scaled_err
from _torch_parity import torch_model_config as _torch_cfg

TOL = 1e-5
B, S, V = 2, 8, 64
ARCHS = ["qwen3-4b", "gemma2-27b", "mistral-nemo-12b", "chatglm3-6b",
         "deepseek-v2-236b", "deepseek-v3-671b", "recurrentgemma-9b",
         "xlstm-1.3b"]


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _jcfg(**kw):
    base = dict(name="t", d_model=32, vocab=V,
                pattern=(JLayerSpec("gqa", "dense"),), num_superblocks=2,
                num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
                dtype=jnp.float32, param_dtype=jnp.float32, q_chunk=4)
    base.update(kw)
    return JModelConfig(**base)


# tests/test_models_parity.py's MLA config (q/k head dim 12, v 8).
MLA_KW = dict(d_model=32, num_heads=4, q_lora_rank=16, kv_lora_rank=8,
              qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)

# The configs of tests/test_models_parity.py and the ported archs' smoke().
MODEL_CONFIGS = {
    "gqa": _jcfg(),
    "gqa_window": _jcfg(pattern=(JLayerSpec("gqa", "dense", window=4),),
                        num_kv_heads=1),
    **{a: jax_configs.get_arch(a).smoke() for a in ARCHS},
    "mla": _jcfg(pattern=(JLayerSpec("mla", "dense"),),
                 mla=JMLAConfig(**MLA_KW)),
}


# -- configs ------------------------------------------------------------------

def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            v = str(v).replace("torch.", "").split(".")[-1].strip("'>")
        elif f.name in ("pattern", "extra_layers"):
            v = tuple(dataclasses.astuple(s) for s in v)
        elif (f.name in ("mla", "moe", "rglru", "mlstm", "slstm")
              and v is not None):
            # A port MLAConfig never equals a JAX one: compare the fields.
            v = (type(v).__name__, dataclasses.astuple(v))
        out[f.name] = v
    return out


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, size):
    port = getattr(configs.get_arch(arch), size)()
    ref = getattr(jax_configs.get_arch(arch), size)()
    assert _fields(port) == _fields(ref)
    assert configs.supported_shapes(configs.get_arch(arch)) == \
        jax_configs.supported_shapes(jax_configs.get_arch(arch))


def test_registry_and_shapes():
    assert set(configs.ALL_ARCHS) == set(ARCHS)
    assert configs.SHAPES == {k: configs.ShapeCell(**dataclasses.asdict(v))
                              for k, v in jax_configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    port_cfg = configs.get_arch(arch).full()
    assert param_count(port_cfg) == j_param_count(
        jax_configs.get_arch(arch).full())
    smoke = configs.get_arch(arch).smoke()
    params = init_params(torch.Generator().manual_seed(0), smoke)
    assert param_count(smoke) == sum(p.numel() for p in params.parameters())


@pytest.mark.parametrize("kw", [
    {"pattern": (LayerSpec("slstm", "dense"),), "frontend": "vision"},
    {"pattern": (LayerSpec("gqa", "none"),), "arch": "encdec"},
    {"pattern": (LayerSpec("rglru", "dense"),), "frontend": "audio"},
    {"pattern": (LayerSpec("mlstm", "none"),), "arch": "encdec"},
    {"extra_layers": (LayerSpec("gqa", "dense"),), "frontend": "vision"},
    {"arch": "encdec"}, {"frontend": "vision"}, {"frontend": "audio"},
])
def test_unported_parts_raise(kw):
    """The enc-dec stack and the frontends, alone or beside a ported
    layer kind (the recurrent mixers, ffn ``none``, ``extra_layers``):
    the refusal names the ROADMAP item that ports them."""
    cfg = dataclasses.replace(configs.get_arch("qwen3-4b").smoke(), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(torch.Generator().manual_seed(0), cfg)


# The parts that test_unported_parts_raise refused before they were
# ported (MLA, MoE and the MTP head; the recurrent mixers, ffn "none" and
# extra_layers), on qwen3-4b's smoke() (the nested configs at the smoke()
# widths of deepseek, recurrentgemma and xlstm), built from either
# package's classes (``m``: ``repro.models`` or ``repro_torch.models``).
MOE_KW = dict(d_model=64, d_ff_expert=32, num_experts=8, top_k=2,
              num_shared=2, aux_loss_free=False)


def _formerly_unported(name, m):
    spec = m.LayerSpec
    return {"mla": {"pattern": (spec("mla", "dense"),),
                    "mla": m.MLAConfig(**{**MLA_KW, "d_model": 64})},
            "moe": {"pattern": (spec("gqa", "moe"),),
                    "moe": m.MoEConfig(**MOE_KW)},
            "mtp": {"mtp": True},
            "rglru": {"pattern": (spec("rglru", "dense"),),
                      "rglru": m.RGLRUConfig(d_model=64, d_rnn=64)},
            "mlstm": {"pattern": (spec("mlstm", "dense"),),
                      "mlstm": m.MLSTMConfig(d_model=64, num_heads=4,
                                             chunk=8)},
            "slstm": {"pattern": (spec("slstm", "none"),),
                      "slstm": m.SLSTMConfig(d_model=64, num_heads=4)},
            "ffn_none": {"pattern": (spec("gqa", "none"), spec("none"))},
            "extra_layers": {"extra_layers": (spec("gqa", "none"),
                                              spec("gqa", "dense", 4))},
            }[name]


@pytest.mark.parametrize("name", ["mla", "moe", "mtp", "rglru", "mlstm",
                                  "slstm", "ffn_none", "extra_layers"])
def test_formerly_unported_parts_build(name):
    cfg = dataclasses.replace(configs.get_arch("qwen3-4b").smoke(),
                              **_formerly_unported(name, tmodels))
    jcfg = dataclasses.replace(jax_configs.get_arch("qwen3-4b").smoke(),
                               **_formerly_unported(name, jmodels))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    n = sum(p.numel() for p in params.parameters())
    assert n == param_count(cfg) == j_param_count(jcfg)


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_matches_jax(zero_centered):
    x, s = _rand(3, 5, 16), _rand(16, seed=1)
    want = jlayers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x),
                           zero_centered=zero_centered)
    got = layers.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x),
                         zero_centered=zero_centered)
    assert scaled_err(got, want) <= TOL


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    x = _rand(2, 7, 3, 16)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 5, (2, 7))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              jlayers.rope_freqs(16, 1e6, fraction))
    got = layers.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(np.array(pos)),
                            layers.rope_freqs(16, 1e6, fraction))
    assert scaled_err(got, want) <= TOL


@pytest.mark.parametrize("cap", [None, 0.0, 5.0])
def test_softcap_matches_jax(cap):
    x = _rand(4, 9) * 10
    want = jlayers.softcap(jnp.asarray(x), cap)
    got = layers.softcap(torch.from_numpy(x), cap)
    assert scaled_err(got, want) <= TOL


def test_embed_and_unembed_match_jax():
    table, ids = _rand(11, 8), np.array([[1, 4, 10], [0, 0, 3]])
    want = jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(ids), True)
    got = layers.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                              True)
    assert scaled_err(got, want) <= TOL
    x = _rand(2, 3, 8, seed=2)
    assert scaled_err(layers.unembed(torch.from_numpy(table),
                                     torch.from_numpy(x)),
                      jlayers.unembed(jnp.asarray(table),
                                      jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("window,causal", [(None, True), (3, True),
                                           (3, False)])
def test_mask_bias_matches_jax(window, causal):
    qp = np.broadcast_to(np.arange(6), (2, 6))
    want = jattn._mask_bias(jnp.asarray(qp), jnp.asarray(qp), window, causal)
    got = attn._mask_bias(torch.from_numpy(np.array(qp)),
                          torch.from_numpy(np.array(qp)), window, causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"window": None, "softcap": None}, {"window": 4, "softcap": None},
    {"window": None, "softcap": 50.0}, {"window": 4, "softcap": 30.0},
    {"window": None, "softcap": None, "causal": False},
    # recurrentgemma's head dim (256) with one kv head, windows that bite.
    {"window": 4, "softcap": None, "d": 256, "kv": 1},
    {"window": 6, "softcap": 30.0, "d": 256, "kv": 1},
])
def test_attention_core_matches_jax(kw):
    kw = dict(kw)
    d, K = kw.pop("d", 8), kw.pop("kv", 2)
    q, k, v = _rand(2, 16, 4, d), _rand(2, 16, K, d, seed=1), \
        _rand(2, 16, K, d, seed=2)
    scale = 0.3 if d == 8 else d ** -0.5
    pos = jnp.broadcast_to(jnp.arange(16), (2, 16))
    want = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), pos, pos, scale=scale,
                                q_chunk=4, **kw)
    got = attn.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale, **kw)
    assert got.shape == (2, 16, 4, d)
    assert scaled_err(got, want) <= TOL


@pytest.mark.parametrize("kw", [
    {"window": None, "softcap": None}, {"window": 4, "softcap": 30.0},
])
def test_attention_core_v_head_dim_matches_jax(kw):
    """A v head dim other than q's and k's, as MLA gives it (12 and 8)."""
    q, k, v = _rand(2, 16, 4, 12), _rand(2, 16, 2, 12, seed=1), \
        _rand(2, 16, 2, 8, seed=2)
    pos = jnp.broadcast_to(jnp.arange(16), (2, 16))
    want = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), pos, pos, scale=0.3,
                                q_chunk=4, **kw)
    got = attn.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.3, **kw)
    assert got.shape == (2, 16, 4, 8)
    assert scaled_err(got, want) <= TOL


ATTN_CONFIGS = {
    "qk_norm": dict(qk_norm=True, rope_theta=1e6),
    "window_softcap": dict(window=5, attn_softcap=50.0, query_scale=0.25),
    "half_rope_mqa": dict(rope_fraction=0.5, num_kv_heads=1),
}


def _attn_cfgs(name):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8)
    kw.update(ATTN_CONFIGS[name])
    return jattn.AttnConfig(**kw), attn.AttnConfig(**kw)


@pytest.mark.parametrize("name", sorted(ATTN_CONFIGS))
def test_gqa_forward_matches_jax(name):
    jcfg, cfg = _attn_cfgs(name)
    jp = jattn.init_gqa(jax.random.PRNGKey(1), jcfg)
    p = tree_from_numpy(_np_tree(jp), device="cpu")
    x = _rand(2, 12, 32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    want = jattn.gqa_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             q_chunk=4)
    got = attn.gqa_forward(p, cfg, torch.from_numpy(x),
                           torch.from_numpy(np.array(pos)))
    assert scaled_err(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(ATTN_CONFIGS))
def test_gqa_decode_matches_jax(name):
    """Ten decode steps, past the window's ring buffer: outputs and cache
    (K, V, positions) equal to JAX's at every step."""
    jcfg, cfg = _attn_cfgs(name)
    jp = jattn.init_gqa(jax.random.PRNGKey(2), jcfg)
    p = tree_from_numpy(_np_tree(jp), device="cpu")
    jcache = jattn.init_kv_cache(jcfg, 2, 8, dtype=jnp.float32)
    cache = attn.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    xs = _rand(10, 2, 1, 32, seed=3)
    for t in range(10):
        jcache, want = jattn.gqa_decode(jp, jcfg, jcache, jnp.asarray(xs[t]),
                                        jnp.int32(t))
        cache, got = attn.gqa_decode(p, cfg, cache, torch.from_numpy(xs[t]),
                                     t)
        assert scaled_err(got, want) <= TOL
        for key in ("k", "v"):
            assert scaled_err(cache[key], jcache[key]) <= TOL
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


MLA_CONFIGS = {
    "parity": MLA_KW,
    "deepseek_smoke": dict(d_model=64, num_heads=4, q_lora_rank=32,
                           kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                           v_head_dim=16),
}


def _mla(name, seed):
    jcfg, cfg = JMLAConfig(**MLA_CONFIGS[name]), MLAConfig(**MLA_CONFIGS[name])
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, tree_from_numpy(_np_tree(jp), device="cpu")


@pytest.mark.parametrize("name", sorted(MLA_CONFIGS))
def test_mla_forward_matches_jax(name):
    jcfg, cfg, jp, p = _mla(name, 1)
    x = _rand(2, 12, cfg.d_model)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             q_chunk=4)
    got = attn.mla_forward(p, cfg, torch.from_numpy(x),
                           torch.from_numpy(np.array(pos)))
    assert scaled_err(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(MLA_CONFIGS))
def test_mla_decode_matches_jax(name):
    """Ten absorbed decode steps: outputs and the latent cache (c_kv,
    k_rope) equal to JAX's at every step."""
    jcfg, cfg, jp, p = _mla(name, 2)
    jcache = jattn.init_mla_cache(jcfg, 2, 10, dtype=jnp.float32)
    cache = attn.init_mla_cache(cfg, 2, 10, dtype=torch.float32,
                                device="cpu")
    xs = _rand(10, 2, 1, cfg.d_model, seed=3)
    for t in range(10):
        jcache, want = jattn.mla_decode(jp, jcfg, jcache, jnp.asarray(xs[t]),
                                        jnp.int32(t))
        cache, got = attn.mla_decode(p, cfg, cache, torch.from_numpy(xs[t]),
                                     t)
        assert scaled_err(got, want) <= TOL
        for key in ("c_kv", "k_rope"):
            assert scaled_err(cache[key], jcache[key]) <= TOL


# -- the stack ----------------------------------------------------------------

def _params(name, seed=0):
    jcfg = MODEL_CONFIGS[name]
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = _torch_cfg(jcfg)
    return jcfg, jp, cfg, params_from_jax(_np_tree(jp), cfg, device="cpu")


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def test_params_from_jax_unstacks_the_superblocks():
    jcfg, jp, cfg, p = _params("gemma2-27b")
    n = len(cfg.pattern)
    assert len(p["blocks"]) == cfg.num_layers
    for sb in range(cfg.num_superblocks):
        for i in range(n):
            got = p["blocks"][sb * n + i]["attn"]["wq_dhk"]
            want = np.asarray(jp["blocks"][f"p{i}"]["attn"]["wq_dhk"][sb])
            np.testing.assert_array_equal(got.numpy(), want)
    assert param_count(cfg) == j_param_count(jcfg)


def test_params_from_jax_appends_the_extra_layers():
    """recurrentgemma's extra layers follow the super-blocks in
    ``params["blocks"]``; in bf16 the leaves JAX keeps in fp32 (RG-LRU's
    Λ) stay fp32 and the rest are bf16."""
    jcfg = dataclasses.replace(
        jax_configs.get_arch("recurrentgemma-9b").smoke(),
        dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = _torch_cfg(jcfg)
    p = params_from_jax(_np_tree(jp), cfg, device="cpu")
    n, nsb = len(cfg.pattern), cfg.num_superblocks
    assert len(p["blocks"]) == cfg.num_layers == n * nsb + 1
    got = p["blocks"][n * nsb]["attn"]["wx_dr"]
    want = np.asarray(jp["extra"]["e0"]["attn"]["wx_dr"], np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    for name, leaf in p.named_parameters():
        leaf_name = name.split(".")[-1]
        assert leaf.dtype == (torch.float32 if leaf_name in FP32_LEAVES
                              else torch.bfloat16), name
    assert p["blocks"][0]["attn"]["lambda_r"].dtype == torch.float32
    assert param_count(cfg) == j_param_count(jcfg)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_serve_step_matches_jax(name):
    jcfg, jp, cfg, p = _params(name)
    toks = _tokens(cfg)
    jcache = j_init_cache(jcfg, B, S)
    cache = init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        jcache, want = j_serve_step(jp, jcfg, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t))
        cache, got = serve_step(p, cfg, cache,
                                torch.from_numpy(toks[:, t:t + 1]), t)
        assert got.dtype == torch.float32
        assert scaled_err(got, want) <= TOL, (name, t)


@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-v2-236b"])
def test_apply_layer_aux_matches_jax(name):
    """The first block's output and MoE aux loss equal JAX's; a dense FFN's
    aux is the float 0.0, so a decode step allocates no tensor for it."""
    jcfg, jp, cfg, p = _params(name)
    x = _rand(B, S, cfg.d_model, seed=2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    spec = T.layer_specs(cfg)[0]
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"]["p0"])
    jx, _, jaux = j_apply_layer(jcfg, jcfg.pattern[0], jblock,
                                jnp.asarray(x), jnp.asarray(pos))
    got, _, aux = T.apply_layer(cfg, spec, p["blocks"][0],
                                torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    assert scaled_err(got, jx) <= TOL
    if spec.ffn == "moe":
        assert torch.is_tensor(aux) and aux.dtype == torch.float32
        assert abs(float(aux) - float(jaux)) <= 1e-6
    else:
        assert aux == 0.0 and not torch.is_tensor(aux)
        assert float(jaux) == 0.0


def _full_logits(params, cfg, toks):
    toks = torch.from_numpy(toks)
    x = T._embed_inputs(params, cfg, {"tokens": toks})
    pos = torch.arange(toks.shape[1]).expand(toks.shape)
    x, _ = T._run_stack(params, cfg, x, pos)
    x = layers.rmsnorm(params["final_norm"], x,
                       zero_centered=cfg.zero_centered_norm)
    return layers.softcap(layers.unembed(T._unembed_table(params, cfg), x),
                          cfg.final_softcap)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_prefill_path_decode_parity(name):
    """tests/test_models_parity.py's contract, in the port alone: the
    full-sequence path (flash attention op) equals cached decode.  An MoE
    config gets capacity_factor = num_experts / top_k here, so the prefill
    drops no token (decode, one token a group, drops none either)."""
    cfg = _torch_cfg(MODEL_CONFIGS[name])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = _tokens(cfg, seed=1)
    full = _full_logits(params, cfg, toks)
    cache = init_cache(cfg, B, S, device="cpu")
    dec = []
    for t in range(S):
        cache, lg = serve_step(params, cfg, cache,
                               torch.from_numpy(toks[:, t:t + 1]), t)
        dec.append(lg)
    dec = torch.stack(dec, dim=1)
    scale = float(full.abs().max()) + 1e-9
    np.testing.assert_allclose((dec / scale).numpy(),
                               (full / scale).numpy(), atol=2e-5)


# 16 tokens: past recurrentgemma smoke()'s window of 8 (its ring buffer,
# L = 8, wraps), two of xlstm's chunks of 8, and a multiple of the JAX
# prefill's q_chunk.
RECURRENT_ARCHS, RECURRENT_TOKENS = ["recurrentgemma-9b", "xlstm-1.3b"], 16


def _jax_layer_cache(jcache, cfg, layer):
    n = len(cfg.pattern)
    if layer < cfg.num_superblocks * n:
        return jax.tree.map(lambda a: a[layer // n],
                            jcache["blocks"][f"p{layer % n}"])
    return jcache["extra"][f"e{layer - cfg.num_superblocks * n}"]


@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_recurrent_archs_match_jax(name):
    """serve_step's logits at every step and the prefill step's over the
    whole prompt equal JAX's within 1e-5, with equal greedy tokens; every
    layer's cache (recurrent states, K/V and ring positions) equals
    JAX's at the end."""
    jcfg = jax_configs.get_arch(name).smoke()
    jp = j_init_params(jax.random.PRNGKey(3), jcfg)
    cfg = _torch_cfg(jcfg)
    p = params_from_jax(_np_tree(jp), cfg, device="cpu")
    n = RECURRENT_TOKENS
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, n))
    jcache = j_init_cache(jcfg, B, n)
    cache = init_cache(cfg, B, n, device="cpu")
    for t in range(n):
        jcache, want = j_serve_step(jp, jcfg, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t))
        cache, got = serve_step(p, cfg, cache,
                                torch.from_numpy(toks[:, t:t + 1]), t)
        assert scaled_err(got, want) <= TOL, t
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    for layer, spec in enumerate(T.layer_specs(cfg)):
        jc = _jax_layer_cache(jcache, cfg, layer)
        assert set(cache["blocks"][layer]) == set(jc)
        for key, leaf in cache["blocks"][layer].items():
            if key == "pos":
                np.testing.assert_array_equal(leaf.numpy(),
                                              np.asarray(jc[key]))
            else:
                assert scaled_err(leaf, jc[key]) <= TOL, (layer, key)
        if spec.window is not None:
            assert sorted(cache["blocks"][layer]["pos"][0].tolist()) == \
                list(range(n - spec.window, n))
    want = j_build_prefill_step(jcfg, None)(jp, {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(cfg, device="cpu")(p, {"tokens": toks})
    assert scaled_err(got, want) <= TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
